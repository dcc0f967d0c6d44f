"""mfu.prefill: the FLOPs the requests answered in the window need
(``roofline.prefill_flops``: the layers at every prompt position, the
attention over live pairs, the head at the last position only), over the
window's seconds, as a share of the H100's bf16 peak (%)."""
from chipbench import roofline as RF


def read(run):
    batches = run.readings["batches"]
    if not batches:
        return None
    flops = sum(b * RF.prefill_flops(run.dims, t) for b, t in batches)
    return 100 * flops / run.window_s / RF.PEAK_FLOPS_BF16
