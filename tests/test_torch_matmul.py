"""The port's blocked matmul (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs; the
wrapper's clamping and feasibility rule; the kernel on the card where
there is one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import matmul_blocked as mm
from repro_torch.kernels import ops as tops

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SHAPES = [(128, 128, 128), (256, 128, 64), (100, 60, 36), (32, 512, 96)]


def _inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, k)), rng.normal(size=(k, n))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_jax(m, k, n, dtype):
    """tests/test_kernels.py's shapes, blocks 64, tolerances 1e-4 / 5e-2."""
    a, b = _inputs(m + k + n, m, k, n)
    want = jops.matmul(jnp.asarray(a, JDT[dtype]), jnp.asarray(b, JDT[dtype]),
                       block_m=64, block_n=64, block_k=64)
    got = tops.matmul(torch.tensor(a).to(TDT[dtype]), torch.tensor(b).to(TDT[dtype]),
                      block_m=64, block_n=64, block_k=64)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == want.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("shape,blocks,launch", [
    ((100, 60, 36), (128, 128, 128), (128, 64, 60)),    # clamped to the dims
    ((100, 60, 36), (64, 64, 64), (64, 64, 60)),
    ((1000, 300, 777), (48, 100, 17), (64, 128, 17)),   # covering compiled tile
    ((4096, 4096, 11008), (128, 128, 128), (128, 128, 128)),
    ((5, 3, 2), (512, 512, 512), (16, 16, 3)),          # smallest compiled tile
])
def test_plan_clamps_blocks_and_covers_them(shape, blocks, launch):
    m, k, n = shape
    bm, bn, bk = blocks
    assert mm.plan(m, k, n, block_m=bm, block_n=bn, block_k=bk) == launch


@pytest.mark.parametrize("tile,dtype_bytes", [
    ((512, 512, 16), 2),       # 262144 accumulators: over the register rule
    ((256, 256, 16), 2),       # 65536 accumulators
    ((1024, 16, 16), 2),       # no compiled tile side over 512
    ((256, 128, 512), 2),      # (256 + 128) * 512 * 2 B = 393216 B of smem
    ((128, 128, 512), 4),      # 256 * 512 * 4 B = 524288 B
])
def test_infeasible_tile_raises(tile, dtype_bytes):
    bm, bn, bk = tile
    assert not mm.fits(bm, bn, bk, dtype_bytes)
    dt = torch.float32 if dtype_bytes == 4 else torch.bfloat16
    a, b = torch.zeros(2048, 2048, dtype=dt), torch.zeros(2048, 2048, dtype=dt)
    with pytest.raises(ValueError, match="not feasible"):
        tops.matmul(a, b, block_m=bm, block_n=bn, block_k=bk)


def test_clamping_makes_a_large_request_feasible():
    a, b = torch.ones(100, 60), torch.ones(60, 36)
    assert not mm.fits(1024, 1024, 1024, 4)
    out = tops.matmul(a, b, block_m=1024, block_n=1024, block_k=1024)
    torch.testing.assert_close(out, torch.full((100, 36), 60.0))


@pytest.mark.parametrize("bm,bn,bk,dtype_bytes,want", [
    (128, 128, 128, 2, 65_536),       # (128 + 128) * 128 * 2
    (256, 128, 256, 2, 196_608),
    (128, 256, 256, 4, 393_216),
    (64, 512, 16, 4, 36_864),
    (16, 16, 1, 2, 64),
])
def test_smem_bytes_by_hand(bm, bn, bk, dtype_bytes, want):
    assert mm.smem_bytes(bm, bn, bk, dtype_bytes) == want
    assert mm.fits(bm, bn, bk, dtype_bytes) == (want <= mm.SMEM_LIMIT_BYTES
                                                and bm * bn <= 32_768)


def test_smem_limit_boundary_is_inclusive():
    # (128 + 128) * bk * 2 == 232448 at bk = 454: the limit itself fits
    assert mm.smem_bytes(128, 128, 454, 2) == mm.SMEM_LIMIT_BYTES
    assert mm.fits(128, 128, 454, 2)
    assert not mm.fits(128, 128, 455, 2)


def test_instantiated_tiles_follow_the_register_rule():
    assert len(mm.INSTANTIATED) == 30
    assert all(bm * bn <= mm.MAX_ACC_ELEMENTS for bm, bn in mm.INSTANTIATED)
    assert (128, 256) in mm.INSTANTIATED and (256, 256) not in mm.INSTANTIATED
    grid = np.array(mm.INSTANTIATED)
    assert np.all(mm.fits(grid[:, 0], grid[:, 1], 1))


def test_cpu_tensor_takes_plain_version_without_a_launch():
    a, b = _inputs(1, 40, 24, 8)
    before = mm.launches
    out = tops.matmul(torch.tensor(a, dtype=torch.float32),
                      torch.tensor(b, dtype=torch.float32), block_m=16)
    assert mm.launches == before
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["cpu", "dtype", "shape", "mixed"])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a, b = torch.zeros(8, 4), torch.zeros(4, 8)
    if bad == "dtype":
        a, b = a.half(), b.half()
    elif bad == "shape":
        b = torch.zeros(5, 8)
    elif bad == "mixed":
        b = b.bfloat16()
    with pytest.raises(ValueError):
        mm.matmul_blocked_cuda(a, b)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the blocked-matmul kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_the_card(card, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = (torch.tensor(x).to(TDT[dtype]).to(card)
            for x in _inputs(7, 1000, 300, 777))
    want = mm.matmul_blocked_plain(a, b).float()
    tol = TOL[dtype]
    first = None
    for bm, bn in mm.INSTANTIATED:
        if not mm.fits(bm, bn, 64, a.element_size()):
            continue
        got = tops.matmul(a, b, block_m=bm, block_n=bn, block_k=64)
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol * 10)
        first = got if first is None else first
        assert torch.equal(got, first)       # same k order in every tile


def test_ptxas_report_reads_registers_and_spills():
    from repro_torch.kernels import _build
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1kIfLi16ELi512EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z1kIfLi16ELi512EEvv
    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1kIfLi64ELi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z1kIfLi64ELi64EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 71 registers, 384 bytes cmem[0]
"""
    assert _build.ptxas_report(log) == {
        "_Z1kIfLi16ELi512EEvv": {"spill_stores": 4, "spill_loads": 8, "registers": 64},
        "_Z1kIfLi64ELi64EEvv": {"spill_stores": 0, "spill_loads": 0, "registers": 71},
    }
