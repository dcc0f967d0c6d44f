"""k2_roofline.prefill: K2's share of its roofline in prefill (%): the bound
of each launch at its batch's shape (``roofline.flash_fwd_work``, one a
layer a batch, causal), summed over the window's batches, over K2's device
time in the trace.  None where the program's launch counter disagrees with
a launch a layer a batch."""
from chipbench import roofline as RF

KERNELS = ("flash_wgmma_kernel", "flash_fwd_kernel")


def read(run):
    if run.trace is None:
        return None
    device_s, _ = run.trace.kernel_s(KERNELS)
    r, d = run.readings, run.dims
    if not device_s or r["k2_launches"] != d.n_layers * len(r["batches"]):
        return None
    bound = sum(RF.bound_s(*RF.flash_fwd_work(b, t, t, d.n_heads, d.n_kv_heads, d.head_dim))
                for b, t in r["batches"]) * d.n_layers
    return 100 * bound / device_s
