"""Shared helpers of the ds-array parity tests (``tests/test_torch_*.py``):
one injected clock for both packages' task graphs, and the conversions
between the reference's numpy values and the port's tensors."""
import types

import numpy as np
import torch

from repro.data import taskgraph as jtg
from repro_torch.data import taskgraph as ttg


class SeededClock:
    """A ``time.perf_counter`` stand-in: each call advances by the next
    draw of a seeded sequence, so the k-th timed body of a run measures
    the same duration in either package."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += float(self.rng.uniform(1e-4, 1e-3))
        return self.t


def inject_clock(monkeypatch, seed: int = 0, modules=(jtg, ttg)):
    """Give each of ``modules`` (by default both packages' task graphs) a
    clock of its own from ``seed``."""
    for mod in modules:
        clock = SeededClock(seed)
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(perf_counter=clock.perf_counter))


def t(x):
    """A reference value as the port holds it (arrays become CPU tensors)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, (list, tuple)):
        return type(x)(t(v) for v in x)
    return x


def n(x):
    """A port value as numpy (tensors to arrays, recursively)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(n(v) for v in x)
    return x
