"""Elastic scaling: re-mesh planning and checkpoint resharding, as the JAX
package's ``repro/runtime/elastic.py`` writes them.

When ranks fail (or are added), training resumes on the largest feasible
mesh: ``plan_mesh`` picks a (data, model) factorization from the healthy
rank count, ``make_plan_mesh`` builds it as a ``DeviceMesh`` over the
current process group (the survivors', once a failed run has re-formed its
group), and ``reshard_tree`` places restored host tensors onto it.
Checkpoints are full logical arrays (``checkpoint.py``), so resharding is
``distribute_tensor`` with the new placements: no shard surgery.

Invariants (``tests/test_torch_elastic.py``):
  * ``plan_mesh(n).size <= n``, and the model axis divides what it did;
  * the global batch stays divisible by the new data axis (microbatches
    adapt);
  * a train step after a re-mesh gives the loss of an un-failed run
    restored from the same checkpoint onto the same mesh.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime.sharding import distribute_tree


class NoFeasibleMeshError(RuntimeError):
    """No (data, model) mesh factorization exists for the given healthy
    rank count / global batch.  A typed error (not an ``assert``, which
    vanishes under ``python -O``) so elastic recovery can escalate, e.g.
    hold the last feasible mesh or fall back to a full restart."""


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axes: tuple
    microbatches: int

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def _divisors_desc(n: int):
    return [d for d in range(n, 0, -1) if n % d == 0]


def plan_mesh(n_healthy: int, global_batch: int, *, prefer_model: int = 16,
              microbatches: int = 1) -> MeshPlan:
    """Largest usable (data, model) mesh for ``n_healthy`` ranks.

    Keeps the model axis as close to ``prefer_model`` as possible (tensor
    shards must keep dividing weight dims), then maximizes the data axis
    under the constraint that the global batch splits evenly; the microbatch
    count adapts to keep per-rank batch >= 1.

    Raises :class:`NoFeasibleMeshError` when no mesh exists: zero healthy
    ranks (every plan needs at least a 1x1 mesh) or a non-positive global
    batch (nothing divides it).
    """
    if n_healthy < 1:
        raise NoFeasibleMeshError(
            f"no healthy devices (n_healthy={n_healthy}); even a 1x1 mesh "
            "needs one")
    if global_batch < 1:
        raise NoFeasibleMeshError(
            f"global_batch={global_batch} cannot be split across any data "
            "axis")
    best = None
    for model in sorted(_divisors_desc(prefer_model)):
        data = n_healthy // model
        while data > 0:
            if global_batch % data == 0:
                plan = MeshPlan((data, model), ("data", "model"),
                                max(microbatches, 1))
                if best is None or plan.size > best.size or (
                        plan.size == best.size and model > best.shape[1]):
                    best = plan
                break
            data -= 1
    if best is None:       # unreachable for valid inputs (data=1 divides
        raise NoFeasibleMeshError(           # any batch), kept as a guard
            f"no (data, model) factorization for n_healthy={n_healthy}, "
            f"global_batch={global_batch}, prefer_model={prefer_model}")
    return best


def make_plan_mesh(plan: MeshPlan):
    """The plan as a ``DeviceMesh`` over the default process group, which
    must hold exactly ``plan.size`` ranks: on "cuda" under NCCL, else on
    "cpu"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if dist.get_world_size() != plan.size:
        raise ValueError(f"mesh plan {plan.shape} needs {plan.size} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(plan.shape),
                            mesh_dim_names=tuple(plan.axes))


def reshard_tree(host_tree, placements, *, mesh):
    """Place full host tensors onto a (new) mesh by the given placements."""
    return distribute_tree(host_tree, mesh, placements)


def adapt_config(cfg: ModelConfig, plan: MeshPlan,
                 global_batch: int) -> ModelConfig:
    """Adjust microbatching so the per-rank batch stays integral."""
    data = plan.shape[0]
    m = cfg.train_microbatches
    while m > 1 and (global_batch % m or (global_batch // m) % data):
        m -= 1
    while (global_batch // m) % data and m < global_batch:
        m += 1
    return cfg.replace(train_microbatches=m)
