"""The port's flash attention (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs; the
wrapper's clamping and tile rule; the kernels on the card where there is
one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import (flash_attention_ref,
                                     flash_attention_ref_chunked, matmul_ref)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(seed, b, t, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, h, d)), rng.normal(size=(b, s, kv, d)),
            rng.normal(size=(b, s, kv, d)))


def _both(arrays, dtype, **kw):
    """Run JAX's ops.flash_attention and the port's on the same arrays."""
    want = jops.flash_attention(*(jnp.asarray(a, JDT[dtype]) for a in arrays), **kw)
    got = tops.flash_attention(*(torch.tensor(a).to(TDT[dtype]) for a in arrays), **kw)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("t,h,kv,d,win,meta", [
    (128, 4, 4, 64, 0, 0),        # MHA causal
    (128, 4, 2, 64, 0, 0),        # GQA
    (128, 8, 2, 32, 32, 0),       # GQA + sliding window
    (96, 4, 2, 32, 32, 8),        # window + always-visible meta prefix
    (64, 2, 1, 128, 16, 0),       # MQA + window
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_jax_sweep(t, h, kv, d, win, meta, dtype):
    arrays = _inputs(t + h + win, 2, t, t, h, kv, d)
    got, want = _both(arrays, dtype, window=win, n_meta=meta, block_q=32,
                      block_k=32)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# phi-3-vision's head dim 96 and h2o-danube's 120, which the bf16 kernel
# runs on d = 128's layout: GQA with a window and a meta prefix, MHA, and a
# ragged T = S that fills no block
@pytest.mark.parametrize("t,h,kv,win,meta,block", [
    (128, 4, 2, 32, 8, 64),       # GQA + window + always-visible meta prefix
    (128, 4, 4, 0, 0, 32),        # MHA causal
    (100, 8, 2, 16, 0, 32),       # ragged T = S, group 4, window
])
@pytest.mark.parametrize("d", [96, 120])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_jax_at_padded_head_dims(t, h, kv, win, meta, block, d, dtype):
    arrays = _inputs(t + h + d, 1, t, t, h, kv, d)
    got, want = _both(arrays, dtype, window=win, n_meta=meta, block_q=block,
                      block_k=block)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("t,s,block", [
    (100, 100, 32),               # causal, T and S not block multiples (padded)
    (64, 192, 64),                # T < S, right-aligned causal mask
])
def test_flash_matches_jax_ragged(t, s, block):
    arrays = _inputs(11, 2, t, s, 4, 2, 32)
    got, want = _both(arrays, "float32", block_q=block, block_k=block)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_t_less_than_s_ragged_follows_oracle():
    """T < S with keys that do not fill the last block: the port keeps the
    oracle's right alignment by S - T.  (The JAX wrapper pads S first and
    aligns by the padded length, which shifts the causal mask here.)"""
    q, k, v = (torch.tensor(a, dtype=torch.float32)
               for a in _inputs(12, 2, 50, 100, 4, 2, 32))
    got = tops.flash_attention(q, k, v, block_q=64, block_k=64)
    kk, vv = (x.repeat_interleave(2, dim=2) for x in (k, v))
    want = flash_attention_ref(q, kk, vv)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_noncausal_pad_raises_as_in_jax():
    arrays = _inputs(13, 1, 64, 100, 2, 2, 32)
    with pytest.raises(AssertionError):
        jops.flash_attention(*(jnp.asarray(a, jnp.float32) for a in arrays),
                             causal=False, block_q=32, block_k=32)
    with pytest.raises(ValueError, match="length mask"):
        tops.flash_attention(*(torch.tensor(a, dtype=torch.float32) for a in arrays),
                             causal=False, block_q=32, block_k=32)


def test_flash_block_size_invariance():
    q, k, v = (torch.tensor(a, dtype=torch.float32)
               for a in _inputs(5, 1, 128, 128, 4, 4, 32))
    outs = [tops.flash_attention(q, k, v, block_q=bq, block_k=bk)
            for bq, bk in [(32, 32), (64, 32), (32, 64), (128, 128)]]
    for o in outs[1:]:
        torch.testing.assert_close(outs[0], o, rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_plain_version_without_a_launch():
    q, k, v = (torch.tensor(a, dtype=torch.float32)
               for a in _inputs(6, 1, 32, 32, 2, 1, 32))
    before = tfa.launches
    tops.flash_attention(q, k, v)
    assert tfa.launches == before


@pytest.mark.parametrize("bad", ["cpu", "dtype", "head_dim", "heads"])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.zeros(s) for s in [(1, 8, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32)])
    if bad == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif bad == "head_dim":
        q, k, v = (torch.zeros(x.shape[:3] + (48,)) for x in (q, k, v))
    elif bad == "heads":
        k, v = torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 3, 32)
    with pytest.raises(ValueError):
        tfa.flash_attention_cuda(q, k, v, scale=1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_refs_match_jax(dtype):
    from repro.kernels.ref import flash_attention_ref as jref
    from repro.kernels.ref import matmul_ref as jmm
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(48, 40)), rng.normal(size=(40, 24))
    got = matmul_ref(torch.tensor(a).to(TDT[dtype]), torch.tensor(b).to(TDT[dtype]))
    want = jmm(jnp.asarray(a, JDT[dtype]), jnp.asarray(b, JDT[dtype]))
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 10)
    q, k, v = _inputs(4, 2, 40, 56, 3, 3, 16)
    got = flash_attention_ref(*(torch.tensor(x).to(TDT[dtype]) for x in (q, k, v)),
                              window=8, n_meta=4)
    want = jref(*(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)), window=8, n_meta=4)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------- the tile rule
# The bf16 kernel's sums, written out: a consumer warpgroup owns 64 query
# rows (one or two of them), S of a key tile is one wgmma (at most 256
# wide), and a consumer thread holds bk/2 accumulators of S and d/2 of O,
# at most 160 with one consumer warpgroup (255 registers a thread) and 128
# with two (168 registers a thread).  Shared memory: 1024 bytes of alignment padding, Q (bq x d
# bf16), two stages of one K and one V tile (bk x d bf16 each), and 8 bytes
# for Q's barrier plus 16 a stage.  d = 96 and 120 are laid out at d = 128
# (TMA zero-fills the columns past d), so every sum counts them as 128.
PADDED = {32: 32, 64: 64, 96: 128, 120: 128, 128: 128}


def _smem_bf16(bq, bk, d):
    d = PADDED[d]
    return 1024 + bq * d * 2 + 2 * (2 * bk * d * 2) + 8 + 2 * 16


def test_compiled_tiles_follow_the_register_and_shared_memory_sums():
    want = [(bq, bk, d) for d in (32, 64, 96, 120, 128) for bq in (64, 128)
            for bk in (64, 128, 256)
            if bk // 2 + PADDED[d] // 2 <= (160 if bq == 64 else 128)]
    assert list(tfa.INSTANTIATED[2]) == want
    assert len(want) == 22 and (64, 256, 64) in want
    assert (64, 256, 128) not in want and (128, 256, 32) not in want
    # 96 and 120 take d = 128's tiles, (64, 256) not among them
    for d in (96, 120):
        assert [t[:2] for t in want if t[2] == d] == [t[:2] for t in want if t[2] == 128]
    for bq, bk, d in want:
        assert tfa.smem_bytes(bq, bk, d) == _smem_bf16(bq, bk, d) <= 232_448
        assert tfa.fits(bq, bk, d)
    assert _smem_bf16(128, 128, 128) == _smem_bf16(128, 128, 96) == 164_904
    # fp32: one CUDA-core tile of 64 x 32 at every head dim, its Q, K, V and
    # P tiles in fp32 with a padding column, at the real d
    assert tfa.INSTANTIATED[4] == tuple((64, 32, d) for d in (32, 64, 96, 120, 128))
    assert tfa.smem_bytes(64, 32, 128, 4) == \
        (64 * 129 + 32 * 129 + 32 * 128 + 64 * 33) * 4
    assert tfa.smem_bytes(64, 32, 120, 4) == \
        (64 * 121 + 32 * 121 + 32 * 120 + 64 * 33) * 4


@pytest.mark.parametrize("blocks,launch", [
    ((1, 1), (64, 64)), ((32, 32), (64, 64)), ((64, 100), (64, 128)),
    ((100, 129), (128, 256)), ((128, 256), (128, 256)),
])
def test_launch_tile_covers_the_blocks(blocks, launch):
    assert tfa.launch_tile(*blocks) == launch
    assert tfa.launch_tile(*blocks, dtype_bytes=4) == (64, 32)
    np.testing.assert_array_equal(
        tfa.launch_tile(np.array([blocks[0]] * 2), np.array([blocks[1]] * 2))[1],
        [launch[1]] * 2)


@pytest.mark.parametrize("bq,bk,d,ok", [
    (128, 128, 128, True), (64, 64, 32, True), (64, 200, 64, True),
    (100, 200, 64, False),        # covered by (128, 256): 160 accumulators at 168 registers
    (256, 64, 128, False),        # a third consumer warpgroup is not compiled
    (64, 256, 128, False),        # 128 + 64 accumulators a thread
    (128, 128, 96, True), (64, 128, 120, True),   # on d = 128's layout
    (64, 256, 96, False),         # padded to 128: 128 + 64 accumulators
    (64, 200, 120, False),
    (128, 256, 32, False),        # 128 + 16 with two consumer warpgroups
    (64, 512, 32, False),         # S wider than one wgmma
    (64, 64, 48, False),          # not a head dim the kernel takes
    (0, 64, 64, False),
])
def test_fits_is_the_compiled_set(bq, bk, d, ok):
    assert tfa.fits(bq, bk, d) is ok
    assert tfa.fits(bq, bk, d, 4) is (d in tfa.HEAD_DIMS and min(bq, bk) >= 1)


@pytest.mark.parametrize("shape,blocks,dtype_bytes,launch", [
    ((512, 512, 128), (128, 128), 2, (128, 128)),          # the serving call
    ((100, 100, 32), (32, 32), 2, (64, 64)),               # covering tile
    ((64, 192, 64), (512, 512), 2, (64, 256)),             # clamped to T and S
    ((4096, 4096, 128), (64, 128), 2, (64, 128)),
    ((4096, 4096, 128), (128, 128), 4, (64, 32)),          # fp32: its one tile
    ((6144, 6144, 120), (128, 128), 2, (128, 128)),        # h2o-danube's prefill
    ((1600, 1600, 96), (100, 64), 2, (128, 64)),           # phi-3-vision's, covering
])
def test_plan_clamps_blocks_and_covers_them(shape, blocks, dtype_bytes, launch):
    t, s, d = shape
    assert tfa.plan(t, s, d, block_q=blocks[0], block_k=blocks[1],
                    dtype_bytes=dtype_bytes) == launch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocks,d", [((256, 64), 128), ((64, 256), 128),
                                      ((0, 64), 64), ((64, 256), 96), ((64, 256), 120)])
def test_a_refused_tile_raises_on_the_cpu_too(dtype, blocks, d):
    q, k, v = (torch.tensor(a).to(TDT[dtype]) for a in _inputs(7, 1, 512, 512, 2, 1, d))
    if dtype == "float32" and min(blocks) >= 1:
        tops.flash_attention(q, k, v, block_q=blocks[0], block_k=blocks[1])
        return                    # fp32 runs its one tile for any block
    with pytest.raises(ValueError, match="not feasible|positive"):
        tops.flash_attention(q, k, v, block_q=blocks[0], block_k=blocks[1])


@pytest.mark.parametrize("t,s,causal,window,n_meta", [
    (50, 100, True, 0, 0),        # ragged T < S: each chunk keeps its alignment
    (75, 203, True, 16, 4),       # window + meta prefix
    (60, 100, False, 8, 2),       # non-causal window
    (120, 90, True, 0, 0),        # T > S: rows that see no key at all
])
def test_chunked_oracle_equals_the_whole_one(t, s, causal, window, n_meta):
    q, k, v = (torch.tensor(a, dtype=torch.float32)
               for a in _inputs(t + s, 2, t, s, 3, 3, 32))
    want = flash_attention_ref(q, k, v, causal=causal, window=window, n_meta=n_meta)
    # 7 rows a chunk: every chunk boundary falls inside the sequence
    got = flash_attention_ref_chunked(q, k, v, causal=causal, window=window,
                                      n_meta=n_meta, max_scores=2 * 3 * s * 7)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash-attention kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window,n_meta", [(True, 0, 0), (True, 32, 8),
                                                  (False, 0, 0)])
def test_kernel_matches_plain_on_the_card(card, causal, window, n_meta):
    for d in tfa.HEAD_DIMS:
        q, k, v = (torch.tensor(a).to(torch.bfloat16).to(card)
                   for a in _inputs(d, 2, 192, 256, 4, 2, d))
        want = tfa.flash_attention_plain(q, k, v, scale=d ** -0.5, causal=causal,
                                         window=window, n_meta=n_meta).float()
        by_bk = {}
        for bq, bk, dd in tfa.INSTANTIATED[2]:
            if dd != d:
                continue
            got = tops.flash_attention(q, k, v, causal=causal, window=window,
                                       n_meta=n_meta, block_q=bq, block_k=bk)
            torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)
            # each row's arithmetic does not depend on block_q
            assert torch.equal(got, by_bk.setdefault(bk, got))
