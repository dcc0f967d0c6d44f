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


@pytest.mark.parametrize("shape,blocks,dtype_bytes,launch", [
    # bf16, the wgmma kernel: sides cover from 64, depth in multiples of 64
    ((100, 60, 36), (128, 128, 128), 2, (128, 64, 64)),     # clamped to the dims
    ((100, 60, 36), (64, 64, 64), 2, (64, 64, 64)),
    ((1000, 300, 777), (48, 100, 17), 2, (64, 128, 64)),    # covering compiled tile
    ((4096, 4096, 11008), (128, 128, 128), 2, (128, 128, 128)),
    ((4096, 4096, 11008), (128, 256, 100), 2, (128, 256, 128)),
    ((5, 3, 2), (512, 512, 512), 2, (64, 64, 64)),          # smallest compiled tile
    # fp32, the CUDA-core kernel: sides cover from 16, depth as asked
    ((100, 60, 36), (128, 128, 128), 4, (128, 64, 60)),
    ((1000, 300, 777), (48, 100, 17), 4, (64, 128, 17)),
    ((5, 3, 2), (512, 512, 512), 4, (16, 16, 3)),
])
def test_plan_clamps_blocks_and_covers_them(shape, blocks, dtype_bytes, launch):
    m, k, n = shape
    bm, bn, bk = blocks
    assert mm.plan(m, k, n, block_m=bm, block_n=bn, block_k=bk,
                   dtype_bytes=dtype_bytes) == launch


@pytest.mark.parametrize("tile,dtype_bytes", [
    ((512, 512, 16), 2),       # bn 512: over one wgmma's 256 columns
    ((256, 256, 16), 2),       # 128 accumulators a thread with four consumer warpgroups
    ((512, 128, 64), 2),       # 128 rows a warpgroup x 128 columns: 128 accumulators
    ((1024, 64, 64), 2),       # no compiled side over 512
    ((128, 128, 256), 2),      # one stage of (128 + 128) * 256 * 2 B fits, not two
    ((64, 64, 512), 2),        # one stage of 131072 B
    ((512, 512, 16), 4),       # 262144 accumulators: over the fp32 register rule
    ((256, 128, 512), 4),      # (256 + 128) * 512 * 4 B = 786432 B of smem
    ((128, 128, 512), 4),      # 256 * 512 * 4 B = 524288 B
])
def test_infeasible_tile_raises(tile, dtype_bytes):
    bm, bn, bk = tile
    assert not mm.fits(bm, bn, bk, dtype_bytes)
    dt = torch.float32 if dtype_bytes == 4 else torch.bfloat16
    a, b = torch.zeros(2048, 2048, dtype=dt), torch.zeros(2048, 2048, dtype=dt)
    with pytest.raises(ValueError, match="not feasible"):
        tops.matmul(a, b, block_m=bm, block_n=bn, block_k=bk)


@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_plan_is_worked_out_once_per_request(dtype_bytes):
    """A repeated request reads its launch from the cache, an infeasible
    one raises every time."""
    kw = dict(block_m=48, block_n=128, block_k=100, dtype_bytes=dtype_bytes)
    first = mm.plan(16, 4096, 11008, **kw)
    hits = mm.plan.cache_info().hits
    assert mm.plan(16, 4096, 11008, **kw) == first
    assert mm.plan.cache_info().hits == hits + 1
    for _ in range(2):
        with pytest.raises(ValueError, match="not feasible"):
            mm.plan(4096, 4096, 4096, block_m=512, block_n=512, block_k=512,
                    dtype_bytes=dtype_bytes)


def test_clamping_makes_a_large_request_feasible():
    a, b = torch.ones(100, 60), torch.ones(60, 36)
    assert not mm.fits(1024, 1024, 1024, 4)
    out = tops.matmul(a, b, block_m=1024, block_n=1024, block_k=1024)
    torch.testing.assert_close(out, torch.full((100, 36), 60.0))


@pytest.mark.parametrize("bm,bn,bk,dtype_bytes,want", [
    # bf16: stages x ((bm + bn) * bk * 2 + 16 B of barriers) + 1024 B of padding
    (128, 128, 128, 2, 197_680),      # 3 x (65536 + 16) + 1024
    (128, 256, 64, 2, 197_696),       # 4 x (49152 + 16) + 1024
    (64, 64, 64, 2, 132_224),         # 8 (the cap) x (16384 + 16) + 1024
    (512, 64, 64, 2, 222_256),        # 3 x (73728 + 16) + 1024
    (128, 128, 256, 2, 263_200),      # one stage fits: the two it needs, 2 x 131088 + 1024
    # fp32: one A and one B tile
    (128, 128, 128, 4, 131_072),      # (128 + 128) * 128 * 4
    (128, 256, 256, 4, 393_216),
    (64, 512, 16, 4, 36_864),
    (16, 16, 1, 4, 128),
])
def test_smem_bytes_by_hand(bm, bn, bk, dtype_bytes, want):
    assert mm.smem_bytes(bm, bn, bk, dtype_bytes) == want
    assert mm.fits(bm, bn, bk, dtype_bytes) == (want <= mm.SMEM_LIMIT_BYTES
                                                and (bm, bn) in mm.INSTANTIATED[dtype_bytes])


@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_smem_limit_boundary_is_inclusive(dtype_bytes):
    if dtype_bytes == 4:
        # (128 + 128) * bk * 4 == 232448 at bk = 227: the limit itself fits
        assert mm.smem_bytes(128, 128, 227, 4) == mm.SMEM_LIMIT_BYTES
        assert mm.fits(128, 128, 227, 4)
        assert not mm.fits(128, 128, 228, 4)
    else:
        # two stages of 64 x 448 + 448 x 64 take 2 x 114704 + 1024 = 230432
        # bytes; at bk 512 one stage is 131088 and two do not fit
        assert mm.stages(64, 64, 448) == 2 and mm.stages(64, 64, 512) == 1
        assert mm.smem_bytes(64, 64, 448) == 230_432 <= mm.SMEM_LIMIT_BYTES
        assert mm.fits(64, 64, 448) and mm.fits(64, 64, 400)   # 400 stages as 448
        assert not mm.fits(64, 64, 449)                         # 449 stages as 512


def test_instantiated_tiles_follow_the_register_rule():
    fp32, bf16 = mm.INSTANTIATED[4], mm.INSTANTIATED[2]
    assert len(fp32) == 30
    assert all(bm * bn <= mm.MAX_ACC_ELEMENTS for bm, bn in fp32)
    assert len(bf16) == 9
    assert all(bm % 64 == 0 and bn <= 256 for bm, bn in bf16)
    assert all(mm.acc_per_thread(bm, bn) <= (64 if mm.consumer_warpgroups(bm) == 4 else 128)
               for bm, bn in bf16)
    assert (128, 256) in bf16 and (256, 128) in bf16 and (512, 64) in bf16
    assert (256, 256) not in bf16 and (512, 128) not in bf16
    for dtype_bytes, tiles in mm.INSTANTIATED.items():
        grid = np.array(tiles)
        assert np.all(mm.fits(grid[:, 0], grid[:, 1], 1, dtype_bytes))


def test_compiled_tile_lists_match_the_sources():
    """The rule's tiles are the ones the CUDA sources instantiate."""
    import re
    from repro_torch.kernels import _build

    def listed(source, macro):
        text = (_build.CSRC / source).read_text()
        body = text[text.index(f"#define {macro}(X)"):]
        body = body[:body.index("\n\n")]
        return tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", body))

    assert listed("matmul_blocked.cu", "MM_TILES") == mm.INSTANTIATED[4]
    assert listed("matmul_wgmma.h", "K1_WGMMA_TILES") == mm.INSTANTIATED[2]
    made = set()
    for source in mm.LIBRARY.sources[1:]:
        text = (_build.CSRC / source).read_text()
        made |= {(int(a), int(b)) for a, b in
                 re.findall(r"launch_wgmma<(\d+), (\d+)>", text)}
    assert made == set(mm.INSTANTIATED[2])


@pytest.mark.parametrize("bm,bn,bk,want", [
    (64, 64, 64, 8),          # 14 would fit; the design caps the ring at 8
    (128, 128, 64, 7),
    (128, 256, 64, 4),
    (128, 128, 128, 3),
    (128, 256, 128, 2),
    (512, 64, 64, 3),
    (128, 128, 256, 1),       # infeasible: a ring needs two
])
def test_ring_stages_follow_the_shared_memory(bm, bn, bk, want):
    assert mm.stages(bm, bn, bk) == want
    assert mm.fits(bm, bn, bk) == (want >= 2)


@pytest.mark.parametrize("tile,fp32_launch", [
    ((16, 16, 16), (16, 16, 16)),          # bf16 covers it with (64, 64, 64)
    ((32, 512, 16), (32, 512, 16)),        # bf16 refuses bn 512
    ((128, 256, 100), (128, 256, 100)),    # bf16 stages it 128 deep
])
def test_wrapper_takes_the_rule_of_its_dtype(tile, fp32_launch):
    """bf16 runs the tensor-core rule, fp32 the CUDA-core rule, on the same
    request; the dtype picks the rule, never a fallback."""
    bm, bn, bk = tile
    assert mm.plan(512, 512, 512, block_m=bm, block_n=bn, block_k=bk,
                   dtype_bytes=4) == fp32_launch
    a32, b32 = torch.zeros(512, 512), torch.zeros(512, 512)
    assert mm.launch_args(a32, b32, block_m=bm, block_n=bn, block_k=bk)[2] == fp32_launch
    a16, b16 = a32.bfloat16(), b32.bfloat16()
    if mm.fits(bm, bn, bk, 2):
        want = (max(64, bm), max(64, bn), -(-bk // 64) * 64)
        assert mm.launch_args(a16, b16, block_m=bm, block_n=bn, block_k=bk)[2] == want
    else:
        with pytest.raises(ValueError, match="not feasible"):
            tops.matmul(a16, b16, block_m=bm, block_n=bn, block_k=bk)
        tops.matmul(a32, b32, block_m=bm, block_n=bn, block_k=bk)     # fp32 runs it


@pytest.mark.parametrize("m,k,n", [(100, 60, 36), (100, 36, 60), (37, 13, 5),
                                   (64, 64, 64)])
def test_alignment_padding_keeps_the_plain_result(m, k, n):
    """bf16 K and N are zero-padded to multiples of 8 for TMA, as the CUDA
    wrapper pads them; the plain product of the padded operands, cut to N
    columns, is the product of the originals."""
    a, b = (torch.tensor(x).bfloat16() for x in _inputs(m * n + k, m, k, n))
    pa, pb, tile = mm.launch_args(a, b, block_m=64, block_n=64, block_k=64)
    assert tile == mm.plan(m, k, n, block_m=64, block_n=64, block_k=64)
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    assert tuple(pa.shape) == (m, kp) and tuple(pb.shape) == (kp, np_)
    assert (pa.data_ptr() == a.data_ptr()) == (kp == k)       # no copy when aligned
    assert not pa[:, k:].any() and not pb[k:].any() and not pb[:, n:].any()
    torch.testing.assert_close(pa[:, :k], a, rtol=0, atol=0)
    torch.testing.assert_close(pb[:k, :n], b, rtol=0, atol=0)
    got = mm.matmul_blocked_plain(pa, pb)[:, :n]
    torch.testing.assert_close(got.float(), mm.matmul_blocked_plain(a, b).float(),
                               rtol=1e-2, atol=1e-2)
    fp32 = mm.launch_args(a.float(), b.float(), block_m=64, block_n=64, block_k=64)
    assert fp32[0].shape == a.shape and fp32[1].shape == b.shape    # fp32 pads nothing


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
    for bm, bn in mm.INSTANTIATED[a.element_size()]:
        for bk in (64, 128):
            if not mm.fits(bm, bn, bk, a.element_size()):
                continue
            got = tops.matmul(a, b, block_m=bm, block_n=bn, block_k=bk)
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
