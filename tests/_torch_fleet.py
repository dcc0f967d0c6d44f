"""Shared inputs of the serving-fleet parity tests (test_torch_fleet.py,
test_torch_transport.py, test_torch_registry.py): the reference's
synthetic records (tests/test_fleet.py), built for either package from one
recipe, the slow stub backend, and a per-test wall-clock bound.

A port fleet is only ever given the port's own estimator: its process and
socket workers unpickle the backend by its qualified name, so a reference
object would import ``repro`` into the worker.
"""
import signal
import socket as socketlib
import threading
import time
from contextlib import contextmanager

from repro_torch.core.estimator import BlockSizeEstimator
from repro_torch.core.features import dataset_features
from repro_torch.core.log import ExecutionRecord
from repro_torch.data.executor import Environment

ENV = Environment(name="laptop", n_workers=4, n_nodes=1, mem_limit_mb=2048.0,
                  dispatch_overhead_s=1e-4, ram_gb=16)
SHAPES = ((256, 16), (512, 16), (128, 32), (64, 8), (1024, 64))
# every wait a test makes is bounded on its own; this bounds the test
# itself, so a deadlock fails one test instead of holding the whole run
TEST_LIMIT_S = 120


def _pkg(pkg):
    """(BlockSizeEstimator, dataset_features, ExecutionRecord, Environment)
    of the port (``"torch"``) or the JAX package (``"jax"``)."""
    if pkg == "torch":
        return BlockSizeEstimator, dataset_features, ExecutionRecord, Environment
    from repro.core.estimator import BlockSizeEstimator as JEst
    from repro.core.features import dataset_features as jfeat
    from repro.core.log import ExecutionRecord as JRec
    from repro.data.executor import Environment as JEnv
    return JEst, jfeat, JRec, JEnv


def synth_records(algo, shapes, best_pr, *, best_s=0.1, worse_s=2.0, pkg="torch"):
    _est, feats, Rec, Env = _pkg(pkg)
    env = Env(name="laptop", n_workers=4, n_nodes=1, mem_limit_mb=2048.0,
              dispatch_overhead_s=1e-4, ram_gb=16).features()
    recs = []
    for n, m in shapes:
        for p_r in (1, 2, 4, 8):
            t = best_s if p_r == best_pr else worse_s + p_r
            recs.append(Rec(feats(n, m), algo, env, p_r, 1, t, {}))
    return recs


def fitted(pkg="torch"):
    """The reference test's ``fitted_est``: kmeans best at p_r 4, gmm at 2."""
    est = _pkg(pkg)[0]
    return est("tree").fit(synth_records("kmeans", SHAPES, 4, pkg=pkg)
                           + synth_records("gmm", SHAPES, 2, pkg=pkg))


def q(n, m, algo="kmeans"):
    return (n, m, algo, ENV.features())


def universe(algos=("kmeans", "gmm")):
    return [q(n, m, a) for a in algos for n, m in SHAPES]


class SlowEstimator:
    """Stub backend with a sleeping batched predict — for queue-pressure
    tests (shedding, autoscaler)."""
    is_fit = True
    s = 2

    def __init__(self, delay=0.05):
        self.delay = delay
        self.model_version = 1
        self.calls = 0

    def abstains(self, algo):
        return False

    def predict_partitions_batch(self, queries):
        self.calls += 1
        time.sleep(self.delay)
        return [(2, 1)] * len(queries)


def wait_until(pred, timeout=30.0, poll=0.01, tick=None):
    """Poll ``pred`` (calling ``tick`` first, if given) until it holds or
    ``timeout`` lapses; returns its last value."""
    deadline = time.monotonic() + timeout
    while True:
        if tick is not None:
            tick()
        ok = pred()
        if ok or time.monotonic() >= deadline:
            return ok
        time.sleep(poll)


def attached_worker(serve_socket_worker, **kw):
    """A socket worker on an ephemeral loopback port in a daemon thread —
    the in-test stand-in for ``python -m repro_torch serve-worker``."""
    srv = socketlib.create_server(("127.0.0.1", 0))
    addr = "%s:%d" % srv.getsockname()[:2]
    threading.Thread(target=serve_socket_worker, args=(srv,), kwargs=kw,
                     daemon=True).start()
    return srv, addr


@contextmanager
def bounded(seconds=TEST_LIMIT_S):
    """Raise ``TimeoutError`` in the test if it runs past ``seconds``
    (SIGALRM; a no-op off the main thread, where no signal can land)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def _expire(signum, frame):
        raise TimeoutError(f"test ran past its {seconds}s bound")

    old = signal.signal(signal.SIGALRM, _expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
