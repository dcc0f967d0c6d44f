"""mfu.decode: the decode step's share of its roofline (%): for every step
in the window the larger of its FLOPs over the bf16 peak and its bytes
over the memory bandwidth (``roofline.decode_step_work``: the weights read
once, the live cache read once, the new keys and values written), summed,
over the window's seconds.  At decode the bytes bound it."""
from chipbench import roofline as RF


def read(run):
    r = run.readings
    if not r["steps"]:
        return None
    bound = sum(RF.bound_s(*RF.decode_step_work(run.dims, r["sessions"], pos))
                for pos in r["positions"])
    return 100 * bound / run.window_s
