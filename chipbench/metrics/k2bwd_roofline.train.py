"""k2bwd_roofline.train: K2 bwd's share of its roofline in the train step
(%): the launches in the window (the program's ``bwd_launches`` counter)
times the bound of one at the step's shape (``roofline.flash_bwd_work``:
one microbatch's sequences, causal), over the device time of the delta,
dK/dV and dQ kernels in the trace."""
from chipbench import roofline as RF

KERNELS = ("delta_kernel", "dkdv_wgmma_kernel", "dq_wgmma_kernel", "dkdv_kernel",
           "dq_kernel")


def read(run):
    if run.trace is None:
        return None
    device_s, _ = run.trace.kernel_s(KERNELS)
    r, d = run.readings, run.dims
    if not device_s or not r["k2bwd_launches"]:
        return None
    one = RF.bound_s(*RF.flash_bwd_work(r["micro_batch"], r["seq"], d.n_heads, d.n_kv_heads,
                                        d.head_dim))
    return 100 * r["k2bwd_launches"] * one / device_s
