"""Registry of data-parallel workloads (the paper's algorithms `a`), the
port of the JAX package's ``repro/algorithms/__init__.py``.

Every module exposes the uniform entry point ``run(executor, X, y=None,
**kw)`` (unsupervised workloads ignore ``y``).  ``partition_and_run``
additionally accepts a raw tensor plus an externally chosen partitioning
``(p_r, p_c)`` and builds the ``DistArray`` itself, clamping to the
array's shape.
"""
from repro_torch.algorithms import gmm, kmeans, pca, rf, svm
from repro_torch.data.distarray import DistArray

ALGORITHMS = {
    "kmeans": kmeans,
    "pca": pca,
    "gmm": gmm,
    "csvm": svm,
    "rf": rf,
}

SUPERVISED = {"csvm", "rf"}


def run(name: str, executor, X, y=None, **kw):
    return ALGORITHMS[name].run(executor, X, y, **kw)


def partition_and_run(name: str, executor, X, y=None, *,
                      p_r: int, p_c: int, **kw):
    """Partition ``X`` into the externally chosen ``p_r x p_c`` grid and
    run the workload; returns ``(result, DistArray)``.  Partition counts
    are clamped to the array's shape (a 64-way row split of a 32-row array
    degrades to 32)."""
    n, m = X.shape
    Xd = DistArray.from_array(X, max(1, min(int(p_r), n)),
                              max(1, min(int(p_c), m)))
    return run(name, executor, Xd, y, **kw), Xd
