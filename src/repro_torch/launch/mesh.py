"""Mesh construction and the ranks that hold it.

The JAX package's ``repro/launch/mesh.py`` builds a ``jax.make_mesh`` over
the devices one process sees.  Here a mesh is a ``DeviceMesh`` over a
``torch.distributed`` process group, one rank per device: one rank per
visible card under NCCL, or K ranks on the CPU under gloo (``--host-devices
K``, the counterpart of the JAX package's forced host device count).

``init_ranks``, ``leave_ranks`` and ``spawn_ranks`` give the launchers
their process groups: a single rank runs in the calling process over an
in-memory store; several ranks are spawned processes meeting at a file
store.  Every group is made with a timeout and destroyed when its rank is
done, so no later group or test sees it.

    PYTHONPATH=src python -m repro_torch mesh --device cpu --host-devices 4
    PYTHONPATH=src python -m repro_torch mesh                # on the card
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import tempfile

PG_TIMEOUT = datetime.timedelta(seconds=300)


# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------

def init_ranks(device_type: str, rank: int, world: int, store=None, *,
               generation: int = 0):
    """Join the default process group: NCCL for "cuda" (this rank's card
    made current), gloo for "cpu".  ``store`` defaults to an in-memory one,
    which serves a single rank; ``generation`` keeps a re-formed group's
    keys apart from the last one's on the same store."""
    import torch
    import torch.distributed as dist

    if store is None:
        if world != 1:
            raise ValueError("several ranks need a shared store")
        store = dist.HashStore()
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.PrefixStore(f"gen{generation}", store),
                            rank=rank, world_size=world, timeout=PG_TIMEOUT)
    return store


@contextlib.contextmanager
def cpu_rank_threads(device_type: str):
    """One intra-op thread for a CPU rank while it runs (torchrun's default
    for its workers): DTensor's host work between small ops leaves OpenMP
    workers spinning, which takes the cores from every other rank and
    process on the host.  The previous count comes back afterwards."""
    import torch

    if device_type != "cpu":
        yield
        return
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def leave_ranks() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_entry(rank, fn, args, world, store_path, out_path):
    import torch.distributed as dist

    store = dist.FileStore(store_path, world)
    result = fn(rank, world, store, *args)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)


def spawn_ranks(fn, world: int, *args):
    """Run ``fn(rank, world, store, *args)`` in ``world`` spawned
    processes sharing a file store; return rank 0's (JSON-able) result.
    A rank that raises ends them all and re-raises here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        out = os.path.join(tmp, "result.json")
        mp.start_processes(_rank_entry, args=(fn, args, world,
                                              os.path.join(tmp, "store"), out),
                           nprocs=world, join=True, start_method="spawn")
        with open(out) as f:
            return json.load(f)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

def _device_type() -> str:
    """The default group's device: "cuda" under NCCL and under the dry-run's
    fake group (which stands for ranks on cards: DTensor picks collectives
    by the mesh's device, and on a "cpu" mesh moves a split between dims by
    an all-gather and a chunk, gloo having no all-to-all), else "cpu"."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() in ("nccl", "fake") else "cpu"


def make_mesh(shape: tuple, axes: tuple):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of the default group.  Asking for more ranks than
    the group has raises, as ``jax.make_mesh`` does for devices."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks; "
                         f"the process group has {world}")
    return DeviceMesh(_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks ("data", "model"); 2 pods adds a "pod" axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh():
    """Every rank of the group, as a (data, model) mesh with the model axis
    the largest of 4, 2, 1 that divides the rank count."""
    import torch.distributed as dist

    n = dist.get_world_size()
    model = next(c for c in (4, 2, 1) if n % c == 0)
    return make_mesh((n // model, model), ("data", "model"))


def _mesh_rank(rank, world, store, device_type, args):
    init_ranks(device_type, rank, world, store)
    try:
        if args.production:
            mesh = make_production_mesh(multi_pod=args.multi_pod)
        elif args.shape:
            shape = tuple(int(x) for x in args.shape.split(","))
            axes = (tuple(args.axes.split(",")) if args.axes
                    else ("pod", "data", "model")[-len(shape):])
            mesh = make_mesh(shape, axes)
        else:
            mesh = make_host_mesh()
        return (f"mesh shape={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                f"devices={mesh.size()} platform={mesh.device_type}")
    finally:
        leave_ranks()


def main(argv=None):
    """``python -m repro_torch mesh``: build a mesh and describe it -- the
    quickest way to check what geometry these ranks (or ``--shape``) yield
    before committing a training launch to it."""
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description="construct and describe a device mesh")
    ap.add_argument("--shape", default=None, metavar="N,M[,K]",
                    help="explicit mesh shape (default: every rank)")
    ap.add_argument("--axes", default=None, metavar="A,B[,C]",
                    help="axis names for --shape (default data,model[,pod])")
    ap.add_argument("--production", action="store_true",
                    help="the 16x16 production pod mesh (needs 256 ranks)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production: 2 pods (adds a 'pod' axis)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: one rank per visible card) or cpu")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="with --device cpu: the number of CPU ranks (default 1)")
    args = ap.parse_args(argv)

    device_type = resolve_device(args.device).type
    world = rank_count(device_type, args.host_devices)
    if world == 1:
        line = _mesh_rank(0, 1, None, device_type, args)
    else:
        line = spawn_ranks(_mesh_rank, world, device_type, args)
    print(line)
    return line


def rank_count(device_type: str, host_devices: int) -> int:
    """Ranks a launcher runs: one per visible card on "cuda" (the first
    ``host_devices`` cards if given), ``host_devices`` (at least 1) on
    "cpu".  NCCL takes one rank per card, so a card never holds two."""
    if device_type == "cuda":
        import torch

        cards = torch.cuda.device_count()
        if host_devices > cards:
            raise ValueError(f"--host-devices {host_devices}: only {cards} card(s)")
        return host_devices or cards
    return max(1, host_devices)
