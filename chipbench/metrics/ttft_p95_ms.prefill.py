"""ttft_p95_ms.prefill: the 95th percentile of every answered request's
time to first token in the window (host clock, from its batch's call to
the call's return), in ms."""
from chipbench import common


def read(run):
    ttfts = run.readings["ttfts"]
    return 1e3 * common.percentile(ttfts, 95) if ttfts else None
