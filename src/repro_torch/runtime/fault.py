"""What the training launcher uses of the JAX package's failure handling
(``repro/runtime/fault.py``), copied: straggler detection and
deterministic failure injection.

* ``StragglerDetector`` -- per-step timing monitor; consecutive slow steps
  above ``threshold`` x median trigger an action.
* ``FailureEvent`` / ``simulate_failure`` -- the training launcher's
  ``--inject-failure`` schedule, which exercises the
  detect -> checkpoint-restore -> resume path.
"""
from __future__ import annotations

import dataclasses
from collections import deque


@dataclasses.dataclass
class StragglerConfig:
    window: int = 32              # sliding window of step times
    threshold: float = 2.5        # slow if > threshold * median
    patience: int = 3             # consecutive slow steps before action
    warmup: int = 5               # ignore the first steps (compile etc.)


class StragglerDetector:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.times: deque = deque(maxlen=cfg.window)
        self.consecutive_slow = 0
        self.steps_seen = 0

    def record(self, duration_s: float) -> str:
        """Feed one step duration; returns 'ok' | 'slow' | 'act'."""
        self.steps_seen += 1
        if self.steps_seen <= self.cfg.warmup:
            self.times.append(duration_s)
            return "ok"
        med = self.median()
        slow = med > 0 and duration_s > self.cfg.threshold * med
        # slow samples are excluded from the window so one straggler cannot
        # drag the baseline up and mask itself
        if not slow:
            self.times.append(duration_s)
            self.consecutive_slow = 0
            return "ok"
        self.consecutive_slow += 1
        if self.consecutive_slow >= self.cfg.patience:
            self.consecutive_slow = 0
            return "act"
        return "slow"

    def median(self) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    step: int
    kind: str                     # "device_loss" | "straggler" | "io"
    payload: dict


def simulate_failure(step: int, schedule: dict) -> FailureEvent | None:
    """Deterministic failure injection: {step: (kind, payload)}."""
    if step in schedule:
        kind, payload = schedule[step]
        return FailureEvent(step, kind, payload)
    return None
