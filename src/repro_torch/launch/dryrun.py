"""The multi-pod dry-run: ``python -m repro_torch dryrun``.

    python -m repro_torch dryrun --arch yi-6b --shape train_4k
    python -m repro_torch dryrun --arch mamba2-370m --shape long_500k --multi-pod
    python -m repro_torch dryrun --all --both-meshes --out artifacts/dryrun

The port of the JAX package's ``launch/dryrun.py``.  That one forces 512
host devices, lowers and compiles each (arch x shape) cell's sharded step
(train, prefill or decode) on the production mesh and reads its cost,
collectives and memory from the compiled HLO.  torch has no HLO and no
compiler to ask, so this one runs the step once as a rank would:

* ``main`` starts one fake process group of 512 ranks (``fake_group``: no
  process behind any rank, every collective a no-op) and builds both
  production meshes on it (``launch/mesh.py::make_production_mesh``):
  ``pod16x16`` = 256 ranks, ``pods2x16x16`` = 512.
* Params, optimizer state, batch and cache are DTensors whose local
  tensors are **meta** tensors of the rank's shard shape, placed by
  ``sharding.spec_shardings`` as ``launch/train.py::build`` places them
  (the optimizer state by the ZeRO-1 rules where the config asks).
  Nothing is allocated on any device, so nothing here resolves a device.
* The step runs once under ``shardctx.scope`` inside ``RankTrace``, a
  dispatch mode that sees the rank's local ops (it hands any op on a
  DTensor back to DTensor, whose local ops then come to it) and counts:

  - ``flops``: the rank's operations by ``torch.utils.flop_counter``'s
    formulas (matrix products, convolutions), plus the work flash
    attention's shape rules report (``kernels/flash_attention.py``);
  - ``bytes_accessed``: eager's bytes, each local op's operands plus its
    outputs, with no fusion (views and bare allocations move none;
    collectives are counted apart);
  - ``collectives``: the reference's five kinds, each op's count and output
    bytes (``all_gather_into_tensor`` -> all-gather, ``all_reduce`` and
    ``allreduce_`` -> all-reduce, ``reduce_scatter_tensor`` ->
    reduce-scatter, ``all_to_all_single`` -> all-to-all);
  - ``memory``: ``argument_size_in_bytes`` (the arguments' local bytes),
    ``temp_size_in_bytes`` (the peak of the live non-argument bytes: every
    new storage an op makes counts from its making until
    ``weakref.finalize`` sees it freed), ``output_size_in_bytes`` and
    ``alias_size_in_bytes`` (outputs held in a donated argument's storage:
    the train step updates params and optimizer state in place, the decode
    step writes its cache, as XLA aliases donated buffers).
    ``mem_device_bytes`` is argument plus temp bytes.

  ``trace_s`` stands for the reference's ``lower_s`` and ``compile_s``.
  The reference's f32 re-probe of XLA:CPU's bf16 legalization estimated a
  TPU, and has no counterpart here.

A decode cell binds the cache's ``pos`` to ``seq_len - 1``, a full cache.
``--save-hlo`` writes the counterpart of the HLO text: the rank's op list,
each op with its local shapes and each collective, to
``{arch}__{shape}__{mesh}.ops.txt`` beside the record's JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES, ShapeConfig, cells, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.optim import opt_state_specs
from repro_torch.runtime.steps import input_specs, step_fn_for
from repro_torch.runtime.tree import tree_map

WORLD = 512
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_OPS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
                   "allreduce_": "all-reduce", "reduce_scatter_tensor": "reduce-scatter",
                   "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all"}
# bookkeeping around a functional collective: no data moves
_SKIP_OPS = {"wait_tensor", "_wrap_tensor_autograd"}
# allocations that write nothing
_ALLOC_OPS = {"empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like"}


@contextlib.contextmanager
def fake_group(world: int = WORLD):
    """The default process group as ``world`` fake ranks, this process rank
    0: meshes build on it and collectives return at once, moving nothing.
    Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tensors(tree):
    from torch.utils._pytree import tree_flatten

    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


class RankTrace(TorchDispatchMode):
    """One rank's work and memory while a step runs (module docstring).

    ``args`` are the step's argument tensors (DTensors or plain): their
    storages are the argument bytes and never temp.  With ``keep_ops`` each
    counted op is also listed as a line of text in ``ops``."""

    def __init__(self, args, keep_ops: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
        self.ops = [] if keep_ops else None
        self._args = {}
        for x in args:
            st = _local(x).untyped_storage()
            self._args[st._cdata] = st.nbytes()
        self.argument_bytes = sum(self._args.values())
        self.live = self.peak = 0
        self._held = {}

    def __enter__(self):
        self._hook = fa.shape_rule_hook
        fa.shape_rule_hook = self._shape_rule
        return super().__enter__()

    def __exit__(self, *exc):
        fa.shape_rule_hook = self._hook
        return super().__exit__(*exc)

    def _shape_rule(self, name, flops, moved, inputs, outputs):
        self.flops += flops
        self.bytes_accessed += moved
        if self.ops is not None:
            self.ops.append(f"{name} {_shapes(inputs)} -> {_shapes(outputs)} flops={flops}")

    def _freed(self, key):
        self.live -= self._held.pop(key)

    def _track(self, outs):
        for x in outs:
            st = x.untyped_storage()
            key = st._cdata
            if key in self._args or key in self._held:
                continue
            n = st.nbytes()
            self._held[key] = n
            self.live += n
            weakref.finalize(st, self._freed, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented              # DTensor hands its local ops back
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(x, FakeTensor) for x in (*ins, *outs)):
            return out                         # DTensor's sharding propagation
        name = func._opname
        if name in _SKIP_OPS:
            return out
        if not func.is_view:                   # a view allocates nothing
            self._track(outs)
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            c = self.collectives[kind]
            c["count"] += 1
            c["bytes"] += sum(map(_nbytes, outs))
            if self.ops is not None:
                self.ops.append(f"{kind} {func} {_shapes(ins)} -> {_shapes(outs)}")
            return out
        flops = 0
        rule = self._flops.get(func._overloadpacket)
        if rule is not None:
            flops = rule(*args, **kwargs, out_val=out)
        self.flops += flops
        if not func.is_view and name not in _ALLOC_OPS:
            self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if self.ops is not None:
            self.ops.append(f"{func} {_shapes(ins)} -> {_shapes(outs)}"
                            + (f" flops={flops}" if flops else ""))
        return out


def _shapes(ts) -> str:
    return ", ".join(f"{str(x.dtype)[6:]}{list(x.shape)}" for x in ts)


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def meta_shards(specs, mesh, placements):
    """A ParamSpec tree as DTensors on ``mesh`` whose locals are meta tensors
    of this rank's shard shape (the resolver splits only evenly)."""
    from torch.distributed.tensor import DTensor

    def leaf(s, pl):
        shape = list(s.shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                shape[p.dim] //= mesh.size(i)
        local = torch.empty(shape, dtype=s.torch_dtype, device="meta")
        return DTensor.from_local(local, mesh, list(pl), run_check=False,
                                  shape=torch.Size(s.shape),
                                  stride=torch.empty(s.shape, device="meta").stride())
    return tree_map(leaf, specs, placements)


def _shape(shape_name) -> ShapeConfig:
    return shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]


def _config(arch, cfg_overrides):
    cfg = get_config(arch)
    if cfg_overrides:
        moe_over = {k[4:]: v for k, v in cfg_overrides.items() if k.startswith("moe_")}
        plain = {k: v for k, v in cfg_overrides.items() if not k.startswith("moe_")}
        if moe_over and cfg.moe is not None:
            plain["moe"] = dataclasses.replace(cfg.moe, **moe_over)
        cfg = cfg.replace(**plain)
    return cfg


def build_cell(arch: str, shape_name, mesh, *, microbatches=None, overrides=None,
               use_flash=False, cfg_overrides=None):
    """(config, step, arguments, donated argument indices) of one cell on
    ``mesh``: the arguments meta-local DTensors placed by the cell's rules.
    ``shape_name`` names a shape of ``SHAPES`` or is a ``ShapeConfig``."""
    cfg = _config(arch, cfg_overrides)
    shape = _shape(shape_name)
    rules = shd.make_rules(cfg, mesh, shape, overrides)
    pspecs = tf.param_specs(cfg)
    params = meta_shards(pspecs, mesh, shd.spec_shardings(pspecs, mesh, rules))
    bspecs = input_specs(cfg, shape, microbatches=microbatches)
    batch = meta_shards(bspecs, mesh, shd.spec_shardings(bspecs, mesh, rules))
    fn, donate = step_fn_for(cfg, shape, use_flash=use_flash, microbatches=microbatches,
                             shard_ctx=(mesh, rules))
    if shape.kind == "train":
        ospecs = opt_state_specs(cfg, pspecs)
        opt_rules = rules
        if cfg.opt_sharding == "zero1":
            opt_rules = {**rules, "embed": "data", "embed_out": "data"}
        opt = meta_shards(ospecs, mesh, shd.spec_shardings(ospecs, mesh, opt_rules))
        return cfg, fn, (params, opt, batch, 0), donate
    if shape.kind == "decode":
        batch["cache"]["pos"] = shape.seq_len - 1     # a full cache
    return cfg, fn, (params, batch), donate


def run_cell(arch, shape_name, mesh, mesh_name, *, microbatches=None, overrides=None,
             use_flash=False, save_hlo=False, outdir=None, cfg_overrides=None):
    """Price one cell on ``mesh`` (any ``DeviceMesh``): run its step once as
    this rank under ``RankTrace`` and return the record (module docstring);
    with ``outdir`` write it as ``{arch}__{shape}__{mesh}.json`` (and the op
    list under ``save_hlo``)."""
    t0 = time.time()
    shape = _shape(shape_name)
    cfg, fn, args, donate = build_cell(arch, shape, mesh, microbatches=microbatches,
                                       overrides=overrides, use_flash=use_flash,
                                       cfg_overrides=cfg_overrides)
    with RankTrace(_tensors(args), keep_ops=save_hlo) as trace:
        out = fn(*args)
    trace_s = time.time() - t0
    donated = {_local(x).untyped_storage()._cdata
               for i in donate for x in _tensors(args[i])}
    seen, out_bytes, alias = set(), 0, 0
    for x in _tensors(out):
        st = _local(x).untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        out_bytes += st.nbytes()
        if st._cdata in donated:
            alias += st.nbytes()
    del out
    rec = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name,
        "n_devices": mesh.size(),
        "microbatches": microbatches if microbatches is not None
        else (cfg.train_microbatches if shape.kind == "train" else 0),
        "trace_s": round(trace_s, 2),
        "flops": float(trace.flops),
        "bytes_accessed": float(trace.bytes_accessed),
        "collectives": trace.collectives,
        "memory": {"argument_size_in_bytes": trace.argument_bytes,
                   "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": trace.peak,
                   "alias_size_in_bytes": alias},
        "mem_device_bytes": trace.argument_bytes + trace.peak,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
    }
    if outdir:
        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        name = f"{arch}__{shape.name}__{mesh_name}"
        (outdir / f"{name}.json").write_text(json.dumps(rec, indent=1))
        if save_hlo:
            (outdir / f"{name}.ops.txt").write_text("\n".join(trace.ops) + "\n")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--use-flash", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write the rank's op list ({arch}__{shape}__{mesh}.ops.txt)")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    todo = list(cells()) if args.all else [(args.arch, args.shape)]
    failures = []
    with fake_group(WORLD):
        meshes = []
        if args.both_meshes or not args.multi_pod:
            meshes.append(("pod16x16", make_production_mesh(multi_pod=False)))
        if args.both_meshes or args.multi_pod:
            meshes.append(("pods2x16x16", make_production_mesh(multi_pod=True)))
        for arch, shape_name in todo:
            for mesh_name, mesh in meshes:
                tag = f"{arch} x {shape_name} x {mesh_name}"
                try:
                    rec = run_cell(arch, shape_name, mesh, mesh_name,
                                   microbatches=args.microbatches,
                                   use_flash=args.use_flash, save_hlo=args.save_hlo,
                                   outdir=args.out)
                    print(f"[ok] {tag}: flops={rec['flops']:.3e} "
                          f"bytes={rec['bytes_accessed']:.3e} "
                          f"mem/dev={rec['mem_device_bytes'] / 2**30:.2f}GiB "
                          f"trace={rec['trace_s']}s", flush=True)
                except Exception as e:  # noqa: BLE001 -- report and continue
                    failures.append(tag)
                    traceback.print_exc()
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} cell(s) failed: {failures}")
    print("dry-run complete: all cells compiled.")


if __name__ == "__main__":
    main()
