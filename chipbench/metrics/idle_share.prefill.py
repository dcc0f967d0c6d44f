"""idle_share.prefill: the device's idle share of the traced window (%): 1 -
the union of its operations' intervals over the window's length, both
from the trace."""


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
