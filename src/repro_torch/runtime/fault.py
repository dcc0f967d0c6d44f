"""Failure handling policies, copied from the JAX package's
``repro/runtime/fault.py``: straggler detection, retries, failure events,
and the deterministic fault-injection plan the task-graph runtime honors.

* ``StragglerDetector`` -- per-step timing monitor; consecutive slow steps
  above ``threshold`` x median trigger an action.
* ``RetryPolicy`` -- exponential-backoff retry wrapper for transient
  failures; exhaustion raises :class:`RetryExhausted` (attempt count and
  last error attached); optional deterministic jitter.
* ``FaultPlan`` / ``FaultRuntime`` -- seeded chaos schedule (worker loss
  at a virtual time, per-worker slowdown onsets, per-task transient
  failures) plus the cross-epoch worker state that
  ``data/taskgraph.py``'s fault-aware scheduler threads through a run.
* ``FailureEvent`` / ``simulate_failure`` -- the training launcher's
  ``--inject-failure`` schedule, which exercises the
  detect -> checkpoint-restore -> resume path.
"""
from __future__ import annotations

import dataclasses
import random
import time
from collections import deque
from typing import Callable


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


class RetryExhausted(RuntimeError):
    """A retried step failed on every attempt.  Carries the attempt count
    and the last exception so escalation policies (checkpoint-restore,
    re-mesh) can branch on the root cause instead of parsing a message."""

    def __init__(self, attempts: int, last: BaseException | None):
        super().__init__(f"step failed after {attempts} attempts "
                         f"(last error: {last!r})")
        self.attempts = attempts
        self.last = last


@dataclasses.dataclass
class RetryPolicy:
    max_retries: int = 3
    backoff_s: float = 0.5
    backoff_mult: float = 2.0
    jitter: float = 0.0           # each delay *= 1 + jitter*u, u ~ U[0,1)
    seed: int = 0                 # jitter stream seed (deterministic)

    def delays(self) -> list[float]:
        """The full backoff schedule (one delay per retry), jitter
        included -- deterministic for a given policy, so tests and the
        virtual-time scheduler see exactly what ``run`` would sleep."""
        rng = random.Random(self.seed)
        out, delay = [], self.backoff_s
        for _ in range(self.max_retries):
            out.append(delay * (1.0 + self.jitter * rng.random()))
            delay *= self.backoff_mult
        return out

    def run(self, fn: Callable, on_retry: Callable | None = None,
            sleep=time.sleep):
        schedule = self.delays()
        last = None
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - policy layer
                last = e
                if attempt == self.max_retries:
                    break
                if on_retry is not None:
                    on_retry(attempt, e)
                sleep(schedule[attempt])
        raise RetryExhausted(self.max_retries + 1, last) from last


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


# ------------------------------------------------------------- fault plans
class TransientTaskError(RuntimeError):
    """The injected transient failure a planned task raises on its first
    ``fail_times`` attempts (preemption / DMA timeout stand-in)."""


class AllWorkersLostError(RuntimeError):
    """Every worker in the pool is lost or quarantined; the schedule
    cannot make progress (escalate to re-mesh / restart)."""


@dataclasses.dataclass(frozen=True)
class WorkerLoss:
    worker: int
    at: float                     # virtual (modeled) time of the loss


@dataclasses.dataclass(frozen=True)
class Slowdown:
    worker: int
    factor: float                 # task durations multiply by this
    after: float = 0.0            # virtual time the slowdown sets in


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic chaos schedule for one task-graph run.

    ``losses`` kill a worker at a virtual time (its in-flight task is
    re-executed from lineage on a survivor); ``slowdowns`` multiply a
    worker's task durations from a virtual onset time; ``transient`` maps
    a task's submission index to how many attempts fail before success
    (executed through ``retry`` with virtually-injected sleep).  With a
    ``straggler`` config the scheduler runs one detector per worker and
    quarantines a worker whose detector says "act", re-dispatching the
    tasks that would have gone to it onto healthy workers.
    """
    losses: tuple = ()
    slowdowns: tuple = ()
    transient: dict = dataclasses.field(default_factory=dict)
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    straggler: StragglerConfig | None = None

    def factor(self, worker: int, t: float) -> float:
        f = 1.0
        for s in self.slowdowns:
            if s.worker == worker and t >= s.after:
                f *= s.factor
        return f

    def transient_failures(self, tid: int) -> int:
        return int(self.transient.get(tid, 0))

    def retry_delay(self, fail_times: int) -> float:
        """Virtual sleep a task with ``fail_times`` injected failures
        accrues, by running the *real* ``RetryPolicy`` against a counting
        stub with an accumulating (injected) sleep -- the policy code
        path itself is exercised, never re-derived."""
        if fail_times <= 0:
            return 0.0
        state = {"left": fail_times, "slept": 0.0}

        def body():
            if state["left"] > 0:
                state["left"] -= 1
                raise TransientTaskError(
                    f"injected transient failure ({state['left']} left)")
            return None

        def vsleep(s):
            state["slept"] += s

        self.retry.run(body, sleep=vsleep)     # RetryExhausted propagates
        return state["slept"]

    @classmethod
    def seeded(cls, seed: int, n_workers: int, *, n_tasks: int,
               horizon_s: float, p_loss: float = 0.25,
               p_slow: float = 0.25, slow_factor: float = 4.0,
               p_transient: float = 0.05, max_fail: int = 2,
               retry: RetryPolicy | None = None,
               straggler: StragglerConfig | None = None) -> "FaultPlan":
        """Sample a reproducible chaos plan: each worker is independently
        lost (uniform time in ``[0.2, 0.8] * horizon_s``) or slowed with
        the given probabilities (never both; at least one worker always
        survives un-lost), and each task index draws transient failures
        with probability ``p_transient``."""
        rng = random.Random(seed)
        losses, slowdowns = [], []
        lossable = list(range(n_workers))
        rng.shuffle(lossable)
        lossable = lossable[:max(0, n_workers - 1)]   # one worker survives
        for w in range(n_workers):
            r = rng.random()
            if w in lossable and r < p_loss:
                losses.append(WorkerLoss(
                    w, horizon_s * (0.2 + 0.6 * rng.random())))
            elif r < p_loss + p_slow:
                slowdowns.append(Slowdown(
                    w, slow_factor, horizon_s * 0.3 * rng.random()))
        transient = {t: 1 + rng.randrange(max_fail)
                     for t in range(n_tasks) if rng.random() < p_transient}
        return cls(losses=tuple(losses), slowdowns=tuple(slowdowns),
                   transient=transient,
                   retry=retry or RetryPolicy(backoff_s=1e-4, jitter=0.1,
                                              seed=seed),
                   straggler=straggler)


class FaultRuntime:
    """Mutable cross-epoch worker state for one chaos run.

    The fault-aware scheduler (``data/taskgraph.py``) consumes this: which
    workers are lost/quarantined so far, the not-yet-fired loss schedule,
    and the per-worker straggler detectors (fed normalized durations).
    One ``FaultRuntime`` spans every ``collect()`` epoch of a run, so a
    worker lost in epoch 1 stays lost in epoch 2 and detector windows
    carry across iteration boundaries.
    """

    def __init__(self, plan: FaultPlan, n_workers: int):
        self.plan = plan
        self.n_workers = n_workers
        self.lost: set[int] = set()
        self.quarantined: set[int] = set()
        self.pending_losses = sorted(
            (loss for loss in plan.losses if loss.worker < n_workers),
            key=lambda e: e.at)
        self.detectors = (
            {w: StragglerDetector(plan.straggler) for w in range(n_workers)}
            if plan.straggler is not None else {})
        self.events: list[dict] = []
        self.reexecutions = 0
        self.retries = 0
        self.retry_delay_s = 0.0

    def healthy(self) -> list[int]:
        return [w for w in range(self.n_workers)
                if w not in self.lost and w not in self.quarantined]

    def observe(self, worker: int, nominal_s: float, measured_s: float,
                t: float) -> bool:
        """Feed one completed task into the worker's straggler detector
        (normalized duration = measured / nominal); True when the detector
        says "act" and the worker gets quarantined."""
        det = self.detectors.get(worker)
        if det is None or nominal_s <= 0:
            return False
        if det.record(measured_s / nominal_s) == "act":
            self.quarantined.add(worker)
            self.events.append({"kind": "straggler_quarantine",
                                "worker": worker, "t": t})
            return True
        return False
