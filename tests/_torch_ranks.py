"""Multi-rank cases for the port's sharded training, run as a script in
spawned gloo ranks on the CPU (``run`` below starts them with a timeout of
their own).  Rank 0 writes what the test compares into an ``.npz``.

    python tests/_torch_ranks.py sharded_step <out dir> <arch> <variants> [batch] [heads]

Each variant character is one run: ``0`` plain attention, ``1`` flash,
``k`` plain attention with top-k gradient compression and error feedback.
``batch`` is the global batch of 2 microbatches (default 8), ``heads``
``HxKV`` the query and kv heads (default the scale's).

    python tests/_torch_ranks.py sharded_prefill <out dir> <arch>

writes the plain and the sharded prefill's last logits and caches.

    python tests/_torch_ranks.py sharded_decode <out dir> <arch> [heads]

writes the plain and the sharded decode's logits, step by step, after a
plain prefill, and the caches after the last step.

    python tests/_torch_ranks.py key_shard_attention <out dir>

writes attention over a key axis split on the mesh, its gradients, and the
plain ``_sdpa``'s, for a mask with rows that see no key.
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


def config(arch, heads=""):
    """The arch's reduced config at ``SCALE`` in fp32; ``heads`` "HxKV" sets
    its query and kv heads (hymba-1.5b's full config has 25 and 5, a group
    of 5 that splits no mesh axis here)."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import scale_config

    cfg = scale_config(reduced_config(arch), **SCALE).replace(
        param_dtype="float32", compute_dtype="float32")
    if heads:
        h, kv = map(int, heads.split("x"))
        cfg = cfg.replace(n_heads=h, n_kv_heads=kv)
    return cfg


def sharded_step(rank, world, store_path, out, arch, variants, batch="8", heads=""):
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
            _sharded_step(rank, mesh, os.path.join(out, f"variant{v}.npz"),
                          config(arch, heads), int(batch), flash=v == "1",
                          compress=v == "k")
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


def _sharded_step(rank, mesh, out, cfg, batch, flash, compress):
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import init_param_tree
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    from repro_torch.runtime.optim import opt_state_specs
    from repro_torch.runtime.tree import flatten, leaves, tree_map

    cfg = cfg.replace(train_microbatches=2)
    shape = ShapeConfig("t", "train", 64, batch)
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

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import init_param_tree
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    from repro_torch.runtime.tree import flatten, leaves, tree_map

    torch_setup(rank, world, store_path)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cfg = config(arch)
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


DECODE = dict(seq=64, batch=2, steps=4, capacity=80)


def sharded_decode(rank, world, store_path, out, arch, heads=""):
    """``DECODE["steps"]`` decode steps of the port on a (2, 2) mesh and of
    its plain decode, from one plain prefill of ``DECODE["seq"]`` tokens
    (the global caches grown to ``DECODE["capacity"]``, meta tokens
    counted) placed on the decode rules' cache layout: the cache's kv_seq
    splits over "model", the batch over "data", one sequence a rank.  Both
    take the same random tokens.  Rank 0 writes each step's logits and the
    caches after the last step into ``<out>/decode.npz``."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import init_param_tree
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    from repro_torch.runtime.tree import flatten, leaves, tree_map

    torch_setup(rank, world, store_path)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cfg = config(arch, heads)
        b, cap = DECODE["batch"], DECODE["capacity"]
        shape = ShapeConfig("d", "decode", cap, b)
        rules = shd.make_rules(cfg, mesh, shape)
        pspecs = tf.param_specs(cfg)
        params = init_param_tree(pspecs, torch.Generator().manual_seed(0),
                                 torch.device("cpu"))
        sp = shd.distribute_tree(tree_map(torch.clone, params), mesh,
                                 shd.spec_shardings(pspecs, mesh, rules))
        rng = np.random.default_rng(1)
        prompt = torch.from_numpy(rng.integers(0, SCALE["vocab"], (b, DECODE["seq"])))
        _, cache = steps.make_prefill_step(cfg)(params, {"tokens": prompt})
        cache = tf.grow_cache(cfg, cache, cap)
        cspecs = tf.cache_specs(cfg, b, cap)["stages"]
        scache = {"stages": shd.distribute_tree(
            tree_map(torch.clone, cache["stages"]), mesh,
            shd.spec_shardings(cspecs, mesh, rules)), "pos": cache["pos"]}
        split = [any(p.is_shard(2) for p in x.placements)
                 for x, s in zip(leaves(scache["stages"]), leaves(cspecs))
                 if s.axes[2] == "kv_seq"]
        assert split and all(split), "the cache's kv_seq is not split"
        tspec = steps.input_specs(cfg, shape)["tokens"]
        tpl = shd.pspec_placements(shd.resolve_pspec(tspec.axes, tspec.shape, rules, mesh),
                                   mesh)
        plain = steps.make_decode_step(cfg)
        sharded = steps.make_decode_step(cfg, shard_ctx=(mesh, rules))
        result = {}
        for step in range(DECODE["steps"]):
            tokens = torch.from_numpy(rng.integers(0, SCALE["vocab"], (b, 1)))
            logits, cache = plain(params, {"tokens": tokens, "cache": cache})
            st = shd.distribute_tree(tokens, mesh, tpl)
            slogits, scache = sharded(sp, {"tokens": st, "cache": scache})
            result[f"plain/logits{step}"] = logits.numpy()
            result[f"sharded/logits{step}"] = slogits.full_tensor().numpy()
        full = {path: x.full_tensor().numpy() for path, x in flatten(scache["stages"])}
        if rank == 0:
            for path, x in flatten(cache["stages"]):
                result[f"plain/{path}"] = x.numpy()
                result[f"sharded/{path}"] = full[path]
            result["pos"] = np.array([cache["pos"], scache["pos"]])
            np.savez(os.path.join(out, "decode.npz"), **result)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def key_shard_attention(rank, world, store_path, out):
    """``attention._sdpa_over_keys`` on a (2, 2) mesh, the batch over "data"
    and the keys over "model", against the plain ``_sdpa`` on the whole
    tensors, forward and backward (fp32).  The mask leaves query rows that
    see no key at all, rows whose keys all lie on one shard, and rows that
    see keys on both; a second forward adds a never-evicted prefix of keys
    (a decode step's meta tokens), counted on the first key shard only.
    Rank 0 writes both outputs and gradients into ``<out>/keys.npz``."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import attention
    from repro_torch.runtime import shardctx

    torch_setup(rank, world, store_path)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        rules = {"batch": ("data",), "attn_kv": "model", "kv_seq": "model"}
        rng = np.random.default_rng(3)
        b, t, s, h, kv, d, pre = 2, 6, 8, 3, 1, 16, 3
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                         for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d),
                                       (b, t, h, d)))
        k_pre, v_pre = (torch.from_numpy(rng.standard_normal((b, pre, kv, d))
                                         .astype(np.float32)) for _ in range(2))
        mask = torch.from_numpy(rng.random((1, t, s)) < 0.5)
        mask[0, 0] = False                          # sees no key
        mask[0, 1, :s // 2] = False                 # sees keys on the second shard only
        mask[0, 2, s // 2:] = False                 # ... on the first shard only
        mask[0, 2, 0] = True
        scale = d ** -0.5
        whole = [x.clone().requires_grad_() for x in (q, k, v)]
        want = attention._sdpa(*whole, mask, scale)
        want.backward(dout)
        want_pre = attention._sdpa(q, torch.cat([k_pre, k], 1), torch.cat([v_pre, v], 1),
                                   torch.cat([torch.ones(1, t, pre, dtype=torch.bool), mask],
                                             -1), scale)
        batch, keys = [Shard(0), Replicate()], [Shard(0), Shard(1)]
        dq, dk, dv = (distribute_tensor(x, mesh, pl).requires_grad_()
                      for x, pl in ((q, batch), (k, keys), (v, keys)))
        with shardctx.scope(mesh, rules):
            got = attention._sdpa_over_keys(dq, dk, dv, mask, scale, "attn_kv")
            got.backward(distribute_tensor(dout, mesh, batch))
            got_pre = attention._sdpa_over_keys(
                dq.detach(), dk.detach(), dv.detach(), mask, scale, "kv_seq",
                distribute_tensor(k_pre, mesh, batch), distribute_tensor(v_pre, mesh, batch))
        result = {"plain/out": want.detach().numpy(), "sharded/out": got.full_tensor().detach().numpy(),
                  "plain/prefix": want_pre.numpy(),
                  "sharded/prefix": got_pre.full_tensor().numpy()}
        for name, w, g in zip(("q", "k", "v"), whole, (dq, dk, dv)):
            result[f"plain/grad_{name}"] = w.grad.numpy()
            result[f"sharded/grad_{name}"] = g.grad.full_tensor().numpy()
        if rank == 0:
            np.savez(os.path.join(out, "keys.npz"), **result)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


CASES = {"sharded_step": (sharded_step, 4), "sharded_prefill": (sharded_prefill, 4),
         "sharded_decode": (sharded_decode, 4), "key_shard_attention": (key_shard_attention, 4)}


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
