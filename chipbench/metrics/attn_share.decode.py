"""attn_share.decode: the share of the decode steps' device time spent in
the operations launched inside ``models/attention.py::gqa_decode`` (%), from
a ``record_function`` range the driver puts around that function from
outside, traced; None where the trace links no launch to its range."""


def read(run):
    if run.trace is None or "gqa_decode" not in run.trace.ranges or not run.trace.busy_s:
        return None
    return 100 * run.trace.ranges["gqa_decode"] / run.trace.busy_s
