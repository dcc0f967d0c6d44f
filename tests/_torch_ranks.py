"""Multi-rank cases for the port's sharded training, run as a script in
spawned gloo ranks on the CPU (``run`` below starts them with a timeout of
their own).  Rank 0 writes what the test compares into an ``.npz``.

    python tests/_torch_ranks.py sharded_step <out dir> <arch> <variants>

Each variant character is one run: ``0`` plain attention, ``1`` flash,
``k`` plain attention with top-k gradient compression and error feedback.

    python tests/_torch_ranks.py sharded_prefill <out dir> <arch>

writes the plain and the sharded prefill's last logits and caches.
"""
import datetime
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120          # seconds, for a whole multi-rank run


def run(tmp_path, *argv, timeout=TIMEOUT):
    """Run this script's case in a fresh interpreter; returns stdout."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(Path(__file__)), *map(str, argv)],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


SCALE = dict(d_model=128, n_layers=2, vocab=256, heads=4)
HP = dict(peak_lr=1e-3, warmup=2, total_steps=6)


def sharded_step(rank, world, store_path, out, arch, variants):
    """Two steps of the port's sharded train step on a (2, 2) mesh and of its
    plain step from the same fp32 weights and tokens, for each variant (a
    later one reuses the earlier ones' sharding propagation), into
    ``<out>/variant<v>.npz``; each rank also checks that it holds exactly
    the shard ``resolve_pspec`` gives each leaf."""
    from torch.distributed.device_mesh import init_device_mesh

    torch_setup(rank, world, store_path)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        for v in str(variants):
            _sharded_step(rank, mesh, os.path.join(out, f"variant{v}.npz"), arch,
                          flash=v == "1", compress=v == "k")
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def torch_setup(rank, world, store_path):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_path}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))


def _feedback_topk(ratio):
    """A top-k compressor that carries its error feedback between steps."""
    from repro_torch.runtime import compress

    state = {}

    def fn(grads):
        if "r" not in state:
            state["r"] = compress.init_feedback(grads)
        sent, state["r"] = compress.compress_topk(grads, state["r"], ratio)
        return sent
    return fn


def _sharded_step(rank, mesh, out, arch, flash, compress):
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, reduced_config
    from repro_torch.launch.serve import scale_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import init_param_tree
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    from repro_torch.runtime.optim import opt_state_specs
    from repro_torch.runtime.tree import flatten, leaves, tree_map

    cfg = scale_config(reduced_config(arch), **SCALE).replace(
        param_dtype="float32", compute_dtype="float32", train_microbatches=2)
    shape = ShapeConfig("t", "train", 64, 8)
    rules = shd.make_rules(cfg, mesh, shape)
    pspecs = tf.param_specs(cfg)
    ospecs = opt_state_specs(cfg, pspecs)
    bspecs = steps.input_specs(cfg, shape)
    gen = torch.Generator().manual_seed(0)
    params = init_param_tree(pspecs, gen, torch.device("cpu"))
    opt = init_param_tree(ospecs, gen, torch.device("cpu"))
    sp = shd.distribute_tree(tree_map(torch.clone, params), mesh,
                             shd.spec_shardings(pspecs, mesh, rules))
    so = shd.distribute_tree(tree_map(torch.clone, opt), mesh,
                             shd.spec_shardings(ospecs, mesh, rules))
    hp = steps.TrainHParams(**HP)
    kw = {"compress_fn": _feedback_topk(0.1)} if compress else {}
    plain = steps.make_train_step(cfg, hp, use_flash=flash, **kw)
    kw = {"compress_fn": _feedback_topk(0.1)} if compress else {}
    sharded = steps.make_train_step(cfg, hp, use_flash=flash, shard_ctx=(mesh, rules),
                                    **kw)
    rng = np.random.default_rng(1)
    result = {}
    for step in range(2):
        tokens = torch.from_numpy(
            rng.integers(0, SCALE["vocab"], bspecs["tokens"].shape).astype(np.int32))
        batch = shd.distribute_tree({"tokens": tokens}, mesh,
                                    shd.spec_shardings(bspecs, mesh, rules))
        params, opt, pm = plain(params, opt, {"tokens": tokens}, step)
        sp, so, sm = sharded(sp, so, batch, step)
        for key in ("loss", "gnorm"):
            result[f"{key}{step}"] = np.array([float(pm[key]), float(sm[key])])
    # every rank holds only its shard, of the shape the resolver gives
    for (path, x), s in zip(flatten(sp), leaves(pspecs)):
        spec = shd.resolve_pspec(s.axes, s.shape, rules, mesh)
        want = list(s.shape)
        for dim, entry in enumerate(spec):
            for ax in ((entry,) if isinstance(entry, str) else entry or ()):
                want[dim] //= mesh.size(mesh.mesh_dim_names.index(ax))
        assert tuple(x.to_local().shape) == tuple(want), (path, x.to_local().shape, want)
        assert tuple(x.placements) == shd.pspec_placements(spec, mesh), path
    full = {path: x.full_tensor().numpy() for path, x in flatten(sp)}
    if rank == 0:
        for path, x in flatten(params):
            result[f"plain/{path}"] = x.numpy()
            result[f"sharded/{path}"] = full[path]
        result["sharded_leaves"] = np.array(
            sum(1 for _, x in flatten(sp) if any(p.is_shard() for p in x.placements)))
        np.savez(out, **result)


PREFILL = dict(seq=64, batch=8)


def sharded_prefill(rank, world, store_path, out, arch):
    """The port's prefill step on a (2, 2) mesh and its plain prefill from the
    same fp32 weights and prompts: rank 0 writes both last logits and every
    cache leaf into ``<out>/prefill.npz``; each rank checks that it holds
    only the shard of each cache leaf that ``cache_specs`` gives."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeConfig, reduced_config
    from repro_torch.launch.serve import scale_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import init_param_tree
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    from repro_torch.runtime.tree import flatten, leaves, tree_map

    torch_setup(rank, world, store_path)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cfg = scale_config(reduced_config(arch), **SCALE).replace(
            param_dtype="float32", compute_dtype="float32")
        shape = ShapeConfig("p", "prefill", PREFILL["seq"], PREFILL["batch"])
        rules = shd.make_rules(cfg, mesh, shape)
        pspecs = tf.param_specs(cfg)
        params = init_param_tree(pspecs, torch.Generator().manual_seed(0),
                                 torch.device("cpu"))
        sp = shd.distribute_tree(tree_map(torch.clone, params), mesh,
                                 shd.spec_shardings(pspecs, mesh, rules))
        bspecs = steps.input_specs(cfg, shape)
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, SCALE["vocab"], bspecs["tokens"].shape).astype(np.int32))
        batch = shd.distribute_tree({"tokens": tokens}, mesh,
                                    shd.spec_shardings(bspecs, mesh, rules))
        logits, cache = steps.make_prefill_step(cfg)(params, {"tokens": tokens})
        slogits, scache = steps.make_prefill_step(cfg, shard_ctx=(mesh, rules))(sp, batch)
        cspecs = tf.cache_specs(cfg, shape.global_batch, shape.seq_len)["stages"]
        for (path, x), s in zip(flatten(scache["stages"]), leaves(cspecs)):
            want = list(x.shape)
            for i, p in enumerate(shd.pspec_placements(
                    shd.resolve_pspec(s.axes, tuple(x.shape), rules, mesh), mesh)):
                if p.is_shard():
                    want[p.dim] //= mesh.size(i)
            assert list(x.to_local().shape) == want, (path, x.to_local().shape, want)
        full = {path: x.full_tensor().numpy() for path, x in flatten(scache["stages"])}
        last = slogits.full_tensor().numpy()
        if rank == 0:
            result = {"plain/logits": logits.numpy(), "sharded/logits": last,
                      "pos": np.array([cache["pos"], scache["pos"]])}
            for path, x in flatten(cache["stages"]):
                result[f"plain/{path}"] = x.numpy()
                result[f"sharded/{path}"] = full[path]
            np.savez(os.path.join(out, "prefill.npz"), **result)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


CASES = {"sharded_step": (sharded_step, 4), "sharded_prefill": (sharded_prefill, 4)}


def _entry(rank, case, world, store_path, argv):
    fn, _ = CASES[case]
    fn(rank, world, store_path, *argv)


if __name__ == "__main__":
    import torch.multiprocessing as mp

    case, out, *rest = sys.argv[1:]
    world = CASES[case][1]
    # the ranks meet at a file store in the working directory (the test's
    # tmp_path): no TCP port, so concurrent runs cannot collide; a store
    # left by an earlier run would hand out its stale addresses
    store = os.path.abspath("store")
    if os.path.exists(store):
        os.remove(store)
    mp.spawn(_entry, args=(case, world, store, [out, *rest]), nprocs=world)
