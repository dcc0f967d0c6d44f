"""mfu.train: the train step's model FLOPs (``roofline.train_step_flops``:
6 x the matmul parameters a position, 3 x the attention over live pairs)
of every step in the window, over the window's seconds, as a share of the
H100's bf16 peak (%)."""
from chipbench import roofline as RF


def read(run):
    r = run.readings
    if not r["steps"]:
        return None
    flops = RF.train_step_flops(run.dims, r["seq"], r["batch"]) * r["steps"]
    return 100 * flops / run.window_s / RF.PEAK_FLOPS_BF16
