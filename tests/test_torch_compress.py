"""The port's gradient compression against the JAX package's
``repro/runtime/compress.py``: every case of ``tests/test_compress.py`` on
the same numpy inputs, ``sparse_allreduce`` on one and on two gloo ranks,
and a train step with top-k compression against the JAX package's jitted
no-mesh step given the same compressor.

Top-k is deterministic: on tie-free fp32 inputs ``topk_mask`` and
``compress_topk`` equal JAX's exactly.  The int8 rounding noise comes from a
torch generator, not a JAX key, so the rounding is held by its bound
(``|deq - g| <= scale``) and its mean (unbiased), not bit for bit."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compress as jc
from repro_torch.runtime import compress as tc

ROOT = Path(__file__).resolve().parents[1]
RATIOS = (0.05, 0.1, 0.25, 0.5, 0.75, 1.0)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def test_int8_roundtrip_bound():
    g = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    q, s = tc.quantize_int8(_t(g), torch.Generator().manual_seed(0))
    jq, js = jc.quantize_int8(jnp.asarray(g), jax.random.PRNGKey(0))
    assert q.dtype == torch.int8 and q.shape == g.shape
    # the scale is deterministic: max|g| / 127, as JAX computes it
    assert float(s) == float(js)
    err = (tc.dequantize_int8(q, s) - _t(g)).abs()
    assert float(err.max()) <= float(s) * 1.01            # half-ulp + noise


def test_int8_rounding_is_unbiased():
    """Stochastic rounding: the mean of many draws of one value is the
    value (JAX's rounding has the same mean); 4096 draws of each entry, the
    mean within 4 standard errors (scale / sqrt(12 * 4096) each)."""
    g = np.random.default_rng(7).normal(size=(16,)).astype(np.float32)
    gen = torch.Generator().manual_seed(1)
    rep = _t(g).repeat(4096, 1)
    rep[0] = torch.abs(rep).max() * 1.0                   # pin the scale
    q, s = tc.quantize_int8(rep, gen)
    mean = tc.dequantize_int8(q, s)[1:].mean(dim=0)
    stderr = float(s) / np.sqrt(12 * 4095)
    assert float((mean - _t(g)).abs().max()) < 4 * stderr + 1e-7


@pytest.mark.parametrize("seed", [0, 17, 100])
@pytest.mark.parametrize("ratio", RATIOS)
def test_topk_mask_density(ratio, seed):
    """The reference's property, over a grid of its (ratio, seed) domain,
    and the mask equal to JAX's (the draws are tie-free)."""
    g = np.random.default_rng(seed).normal(size=(40, 25))
    mask = tc.topk_mask(torch.from_numpy(g), ratio)
    k = max(1, int(g.size * ratio))
    assert int(mask.sum()) >= k                           # ties keep extras
    kept = np.abs(g)[mask.numpy()].min()
    dropped = np.abs(np.where(mask.numpy(), 0.0, g)).max()
    assert float(dropped) <= float(kept) + 1e-12
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(jc.topk_mask(jnp.asarray(g, jnp.float32), ratio)))


def test_topk_mask_keeps_ties():
    """The threshold is the k-th largest magnitude, so every entry tied
    with it is kept: 3 of 4 kept for k = 2, as JAX keeps them."""
    g = np.array([1.0, -2.0, 2.0, 0.5], np.float32)
    mask = tc.topk_mask(_t(g), 0.5)
    np.testing.assert_array_equal(mask.numpy(), [False, True, True, False])
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jc.topk_mask(jnp.asarray(g), 0.5)))


def test_error_feedback_preserves_mass():
    g = {"w": np.random.default_rng(1).normal(size=(32, 8)).astype(np.float32)}
    tg = {"w": _t(g["w"])}
    sent, new_state = tc.compress_topk(tg, tc.init_feedback(tg), ratio=0.25)
    # sent + residual == original (nothing lost, only delayed): exact
    assert torch.equal(sent["w"] + new_state["w"], tg["w"])
    jsent, jstate = jc.compress_topk({"w": jnp.asarray(g["w"])},
                                     jc.init_feedback({"w": jnp.asarray(g["w"])}), ratio=0.25)
    np.testing.assert_array_equal(sent["w"].numpy(), np.asarray(jsent["w"]))
    np.testing.assert_array_equal(new_state["w"].numpy(), np.asarray(jstate["w"]))


def test_compressed_sgd_converges_on_quadratic():
    """min 0.5||x - t||^2 with top-10% compressed grads + error feedback;
    the iterates equal JAX's step for step (top-k is deterministic)."""
    t = np.random.default_rng(2).normal(size=(50,)).astype(np.float32)
    x, jx = torch.zeros(50), jnp.zeros(50)
    state = tc.init_feedback({"x": x})
    jstate = jc.init_feedback({"x": jx})
    for _ in range(300):
        sent, state = tc.compress_topk({"x": x - _t(t)}, state, ratio=0.1)
        x = x - 0.15 * sent["x"]
        jsent, jstate = jc.compress_topk({"x": jx - jnp.asarray(t)}, jstate, ratio=0.1)
        jx = jx - 0.15 * jsent["x"]
    assert float((x - _t(t)).abs().max()) < 1e-3
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-6)


def test_int8_error_feedback_converges():
    t = np.random.default_rng(3).normal(size=(20,)).astype(np.float32)
    x = torch.zeros(20)
    state = tc.init_feedback({"x": x})
    gen = torch.Generator().manual_seed(0)
    for _ in range(200):
        sent, state = tc.compress_int8({"x": x - _t(t)}, state, gen)
        x = x - 0.3 * sent["x"]
    assert float((x - _t(t)).abs().max()) < 5e-2


def test_int8_feedback_is_the_exact_fp32_remainder():
    """The new feedback is ``acc - deq`` rounded once in fp32, as JAX
    computes it: given the port's own dequantized values, JAX's expression
    gives the same residual bit for bit."""
    g = np.random.default_rng(5).normal(size=(48, 16)).astype(np.float32)
    r = (np.random.default_rng(6).normal(size=(48, 16)) * 0.01).astype(np.float32)
    sent, state = tc.compress_int8({"w": _t(g)}, {"w": _t(r)}, torch.Generator().manual_seed(2))
    acc = jnp.asarray(g) + jnp.asarray(r)
    np.testing.assert_array_equal(state["w"].numpy(),
                                  np.asarray(acc - jnp.asarray(sent["w"].numpy())))


def test_sparse_allreduce_single_rank():
    """One rank: the sparse all-reduce is the top-k truncation, as the
    reference's single-shard case checks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    g = np.random.default_rng(4).normal(size=(16,)).astype(np.float32)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("x",))
        out = tc.sparse_allreduce(_t(g), "x", 0.5, mesh=mesh)
    finally:
        dist.destroy_process_group()
    mask = np.asarray(jc.topk_mask(jnp.asarray(g), 0.5))
    np.testing.assert_allclose(out.numpy(), np.where(mask, g, 0.0), rtol=1e-6, atol=1e-7)


def test_sparse_allreduce_two_gloo_ranks(tmp_path):
    """Two ranks, each with its own vector: the merge equals the sum of each
    rank's top-k sparsification (exact: at most two terms per entry)."""
    code = textwrap.dedent(f"""
        import numpy as np, torch, torch.distributed as dist
        import torch.multiprocessing as mp
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.runtime.compress import sparse_allreduce

        def run(rank):
            dist.init_process_group("gloo", init_method="file://{tmp_path}/store",
                                    rank=rank, world_size=2,
                                    timeout=__import__("datetime").timedelta(seconds=60))
            try:
                mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("pod",))
                g = torch.from_numpy(np.random.default_rng(rank).normal(size=(8, 6))
                                     .astype(np.float32))
                out = sparse_allreduce(g, "pod", 0.25, mesh=mesh)
                if rank == 0:
                    np.save("{tmp_path}/out.npy", out.numpy())
            finally:
                dist.destroy_process_group()

        if __name__ == "__main__":
            mp.spawn(run, nprocs=2)
    """)
    (tmp_path / "ranks.py").write_text(code)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(tmp_path / "ranks.py")], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.zeros((8, 6), np.float32)
    for rank in range(2):
        g = np.random.default_rng(rank).normal(size=(8, 6)).astype(np.float32)
        want += np.where(np.asarray(jc.topk_mask(jnp.asarray(g), 0.25)), g, 0.0)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)
