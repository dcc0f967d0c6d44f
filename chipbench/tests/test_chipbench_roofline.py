"""The frozen yardstick against hand counts."""
import json
from pathlib import Path

import pytest

from chipbench import roofline as RF
from chipbench.common import Dims

BENCH = Path(__file__).resolve().parents[1]


def dims(name):
    return Dims.of(json.loads((BENCH / "configs" / f"{name}.json").read_text()))


def test_yi_6b_train_step_hand_count():
    """6 x 5.799 B x 32768 + 3 x 32 layers x 2 x 8 x 32 x 8.39 M live pairs
    x 256 = 1245.7 TFLOP a step."""
    d = dims("yi-6b")
    assert RF.matmul_params(d) == pytest.approx(5.799e9, rel=1e-4)
    live = 4096 * 4097 // 2
    assert RF.live_pairs(4096, 4096) == live == 8_390_656
    hand = 6 * RF.matmul_params(d) * 8 * 4096 + 3 * 32 * 2 * 8 * 32 * live * 256
    assert RF.train_step_flops(d, 4096, 8) == hand
    assert hand / 1e12 == pytest.approx(1245.7, abs=0.05)


def test_k2_bwd_at_train_4k():
    """343.68 GFLOP (2.5 x the forward's) and 151.5 MB at q [1,4096,32,128],
    k/v [1,4096,4,128]: bound by the operations, 0.34750 ms."""
    flops, nbytes = RF.flash_bwd_work(1, 4096, 32, 4, 128)
    assert flops / 1e9 == pytest.approx(343.68, abs=0.01)
    assert nbytes / 1e6 == pytest.approx(151.5, abs=0.1)
    assert RF.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.34750, abs=1e-5)


def test_k2_at_deepseek_prefill():
    """275.01 GFLOP and 536.9 MB at q/k/v [8,2048,32,128] causal."""
    flops, nbytes = RF.flash_fwd_work(8, 2048, 2048, 32, 32, 128)
    assert flops / 1e9 == pytest.approx(275.01, abs=0.01)
    assert nbytes / 1e6 == pytest.approx(536.9, abs=0.1)


def test_prefill_counts_head_once():
    d = dims("deepseek-7b")
    per_layer = RF.layer_matmul_params(d)
    assert per_layer == 4096 * 4096 * 4 + 3 * 4096 * 11008
    t = 1024
    want = (2 * 30 * per_layer * t + 30 * 2 * 32 * (t * (t + 1) // 2) * 256
            + 2 * 4096 * 102400)
    assert RF.prefill_flops(d, t) == want


def test_decode_step_is_bound_by_bytes():
    """Yi-6B, 32 sessions at position 2048: the weights (12.1 GB) and the
    cache (32 layers x k, v x 32 x 2049 x 4 x 128 x 2 B) bound the step."""
    d = dims("yi-6b")
    flops, nbytes = RF.decode_step_work(d, 32, 2048)
    cache = 32 * 2 * 32 * 2049 * 4 * 128 * 2
    assert nbytes == RF.matmul_params(d) * 2 + 32 * 4096 * 2 + cache
    assert nbytes / RF.PEAK_BYTES_PER_S > flops / RF.PEAK_FLOPS_BF16
    assert RF.bound_s(flops, nbytes) * 1e3 == pytest.approx(nbytes / 3.35e9, rel=1e-12)


def reader(name):
    import importlib.util
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_of(dims_name, readings, trace):
    from chipbench.common import Run
    return Run(cell="x", dims=dims(dims_name), window_s=31.8, trace=trace, readings=readings)


def test_readers_against_hand_counts():
    from chipbench.window import Summary
    trace = Summary(busy_s=31.0, window_s=31.8, kernels={
        "void k2bwd::dkdv_wgmma_kernel<128>(...)": [4.0, 1792],
        "void k2bwd::dq_wgmma_kernel<128>(...)": [2.0, 1792],
        "void k2bwd::delta_kernel<bf16, 128>(...)": [0.2, 1792],
        "void k2::flash_wgmma_kernel<128, 128, 128>(...)": [0.6, 1740],
        "nvjet_gemm": [20.0, 9000]}, ranges={"gqa_decode": 28.9})
    train = {"steps": 7, "seq": 4096, "batch": 8, "micro_batch": 1, "k2bwd_launches": 1792,
             "window_peak_bytes": 50_672_304_640}
    r = run_of("yi-6b", train, trace)
    assert reader("mfu.train")(r) == pytest.approx(100 * 7 * 1245.7e12 / 31.8 / 989e12,
                                                  rel=1e-4)
    assert reader("k2bwd_roofline.train")(r) == pytest.approx(
        100 * 1792 * 0.34750e-3 / 6.2, rel=1e-4)
    assert reader("peak_mem_gb.train")(r) == pytest.approx(50.672304640)
    assert reader("idle_share.train")(r) == pytest.approx(100 * 0.8 / 31.8)
    assert reader("k2bwd_roofline.train")(run_of("yi-6b", train, None)) is None

    prefill = {"batches": [(16, 1024), (8, 2048), (4, 4096)] * 19 + [(16, 1024)] * 1,
               "ttfts": [0.5] * 500 + [0.6] * 48, "k2_launches": 30 * 58}
    r = run_of("deepseek-7b", prefill, trace)
    bound = sum(RF.bound_s(*RF.flash_fwd_work(b, t, t, 32, 32, 128))
                for b, t in prefill["batches"]) * 30
    assert reader("k2_roofline.prefill")(r) == pytest.approx(100 * bound / 0.6)
    assert reader("ttft_p95_ms.prefill")(r) == pytest.approx(600.0)
    assert 0 < reader("mfu.prefill")(r) < 100
    miscount = dict(prefill, k2_launches=30 * 58 - 1)
    assert reader("k2_roofline.prefill")(run_of("deepseek-7b", miscount, trace)) is None

    decode = {"sessions": 32, "steps": 135, "positions": list(range(2048, 2048 + 135))}
    r = run_of("yi-6b", decode, trace)
    assert reader("attn_share.decode")(r) == pytest.approx(100 * 28.9 / 31.0)
    want = sum(RF.bound_s(*RF.decode_step_work(dims("yi-6b"), 32, p))
               for p in decode["positions"])
    assert reader("mfu.decode")(r) == pytest.approx(100 * want / 31.8)
    no_range = Summary(busy_s=31.0, window_s=31.8)
    assert reader("attn_share.decode")(run_of("yi-6b", decode, no_range)) is None
