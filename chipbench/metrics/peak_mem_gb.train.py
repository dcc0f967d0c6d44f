"""peak_mem_gb.train: the most device memory the train step held in the
window (``torch.cuda.max_memory_allocated`` after a reset at its start),
in GB."""


def read(run):
    peak = run.readings.get("window_peak_bytes")
    return peak / 1e9 if peak else None
