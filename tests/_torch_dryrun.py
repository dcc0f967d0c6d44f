"""The port's dry-run cases that need a fake process group, run as a script
in a fresh interpreter (``run`` below starts it with a timeout of its own),
so that no pytest worker keeps a default group.  Each case writes what the
test compares as JSON to ``<out>``.

    python tests/_torch_dryrun.py arg_bytes <out>
    python tests/_torch_dryrun.py mini <out>
    python tests/_torch_dryrun.py meta_vs_real <out>
    python tests/_torch_dryrun.py one_rank <out>
    python tests/_torch_dryrun.py set_slot <out>
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240          # seconds, for one case


def run(tmp_path, *argv, timeout=TIMEOUT):
    """Run this script's case in a fresh interpreter; returns stdout."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(Path(__file__)), *map(str, argv)],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def reduced_cells():
    """Make the dry-run build every arch's reduced config (this process
    only): the reference's mini dry-run and the small cases price those."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch import dryrun

    dryrun.get_config = reduced_config


def _arg_bytes(args) -> int:
    from repro_torch.launch.dryrun import RankTrace, _tensors

    return RankTrace(_tensors(args)).argument_bytes


def arg_bytes(out):
    """Per-rank argument bytes of every cell on both production meshes."""
    from repro_torch.configs import cells
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    result = {}
    with dryrun.fake_group(dryrun.WORLD):
        for name, multi in (("pod16x16", False), ("pods2x16x16", True)):
            mesh = make_production_mesh(multi_pod=multi)
            for arch, shape in cells():
                _, _, args, _ = dryrun.build_cell(arch, shape, mesh)
                result[f"{arch}__{shape}__{name}"] = _arg_bytes(args)
    Path(out).write_text(json.dumps(result))


MINI = dict(shape=("t", "train", 32, 8), microbatches=2)


MINI_ARCHS = ("yi-6b", "mixtral-8x7b", "mamba2-370m", "hymba-1.5b")


def mini(out):
    """The reference's 8-device mini dry-run: its four archs' reduced train
    cells on a (2, 4) mesh, each arch's record or error."""
    reduced_cells()
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    result = {}
    with dryrun.fake_group(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        for arch in MINI_ARCHS:
            try:
                result[arch] = dryrun.run_cell(arch, ShapeConfig(*MINI["shape"]), mesh, "2x4",
                                               microbatches=MINI["microbatches"])
            except Exception as e:  # noqa: BLE001 -- the test reports it
                result[arch] = {"error": f"{type(e).__name__}: {e}"}
    Path(out).write_text(json.dumps(result))


def set_slot(out):
    """``shardctx.set_slot_`` on a (2, 4) CPU mesh, rank 0 of 8: a cache
    split along its sequence over "model" (4 slots a rank), or over both
    mesh dims, written at a slot this rank holds and at one it does not."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import dryrun
    from repro_torch.runtime import shardctx

    result = {}
    with dryrun.fake_group(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                          mesh_dim_names=("data", "model"))
        for name, pl, slot in (("model_own", [Shard(0), Shard(1)], 2),
                               ("model_other", [Shard(0), Shard(1)], 5),
                               ("both_own", [Replicate(), Shard(1)], 3),
                               ("two_dims_own", [Shard(1), Shard(1)], 1),
                               ("two_dims_other", [Shard(1), Shard(1)], 2)):
            local = (2, 4, 3) if name.startswith(("model", "both")) else (2, 2, 3)
            cache = DTensor.from_local(torch.zeros(local), mesh, pl, run_check=False)
            new = DTensor.from_local(torch.ones(cache.shape[0], 3), mesh,
                                     [Replicate(), Replicate()], run_check=False)
            with dryrun.RankTrace([cache]) as trace:
                shardctx.set_slot_(cache, 1, slot, new)
            result[name] = {"local": cache.to_local().tolist(),
                            "collectives": trace.collectives}
        # placed_like: tokens split over all 8 ranks, back to the layout of
        # the [B*T, D] merge they came from (B split over "data", a pending
        # sum over "model" taken as replicated)
        from torch.distributed.tensor import Partial

        like = DTensor.from_local(torch.zeros(8, 3), mesh, [Shard(0), Partial()],
                                  run_check=False)
        tokens = DTensor.from_local(torch.zeros(2, 3), mesh, [Shard(0), Shard(0)],
                                    run_check=False)
        back = shardctx.placed_like(tokens, like)
        result["placed_like"] = {"placements": [str(p) for p in back.placements],
                                 "local": list(back.to_local().shape),
                                 "plain": shardctx.placed_like(torch.zeros(2), like).shape[0]}
    Path(out).write_text(json.dumps(result))


def _traced(fn, args):
    from repro_torch.launch.dryrun import RankTrace, _tensors

    with RankTrace(_tensors(args)) as trace:
        fn(*args)
    return {"flops": trace.flops, "collectives": trace.collectives,
            "argument_bytes": trace.argument_bytes}


def meta_vs_real(out):
    """Reduced yi-6b's train step at (2, 4), once on meta locals and once on
    real CPU locals of the same shard shapes, on one CPU mesh."""
    reduced_cells()
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.runtime.tree import tree_map

    def real(x):
        if not isinstance(x, DTensor):
            return x
        return DTensor.from_local(torch.zeros(x.to_local().shape, dtype=x.dtype),
                                  x.device_mesh, x.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())

    torch.set_num_threads(1)
    result = {}
    with dryrun.fake_group(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                          mesh_dim_names=("data", "model"))
        cfg, fn, args, _ = dryrun.build_cell(
            "yi-6b", ShapeConfig(*MINI["shape"]), mesh, microbatches=MINI["microbatches"])
        result["meta"] = _traced(fn, args)
        cfg, fn, args, _ = dryrun.build_cell(
            "yi-6b", ShapeConfig(*MINI["shape"]), mesh, microbatches=MINI["microbatches"])
        result["real"] = _traced(fn, tree_map(real, args))
    Path(out).write_text(json.dumps(result))


def one_rank(out):
    """Reduced yi-6b's cells on a (1, 1) mesh: the record of each kind beside
    ``FlopCounterMode`` on the plain step over meta tensors of the same
    shapes; and a flash prefill and train cell with their op lists."""
    reduced_cells()
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeConfig, reduced_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import map_specs
    from repro_torch.runtime.optim import opt_state_specs
    from repro_torch.runtime.steps import input_specs, step_fn_for

    def meta(specs):
        return map_specs(lambda s: torch.zeros(s.shape, dtype=s.torch_dtype,
                                               device="meta"), specs)

    cfg = reduced_config("yi-6b")
    result = {}
    with dryrun.fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"))
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig("c", kind, 32, 8)
            mb = 2 if kind == "train" else None
            rec = dryrun.run_cell("yi-6b", shape, mesh, "1x1", microbatches=mb)
            fn, _ = step_fn_for(cfg, shape, microbatches=mb)
            pspecs = tf.param_specs(cfg)
            batch = meta(input_specs(cfg, shape, microbatches=mb))
            args = (meta(pspecs), batch)
            if kind == "train":
                args = (meta(pspecs), meta(opt_state_specs(cfg, pspecs)), batch, 0)
            if kind == "decode":
                batch["cache"]["pos"] = shape.seq_len - 1
            with FlopCounterMode(display=False) as counter:
                fn(*args)
            result[kind] = {"record": rec, "plain_flops": counter.get_total_flops()}
        for kind in ("prefill", "train"):
            shape = ShapeConfig("f", kind, 32, 8)
            for flash in (False, True):
                rec = dryrun.run_cell("yi-6b", shape, mesh, "1x1", use_flash=flash,
                                      save_hlo=True, outdir=".",
                                      microbatches=2 if kind == "train" else None)
                ops = Path("yi-6b__f__1x1.ops.txt").read_text()
                result[f"{kind}_flash{int(flash)}"] = {"record": rec, "ops": ops}
    Path(out).write_text(json.dumps(result))


CASES = {"arg_bytes": arg_bytes, "mini": mini, "meta_vs_real": meta_vs_real,
         "one_rank": one_rank, "set_slot": set_slot}


if __name__ == "__main__":
    case, *rest = sys.argv[1:]
    CASES[case](*rest)
