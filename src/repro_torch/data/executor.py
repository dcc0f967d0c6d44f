"""Eager-looking compatibility facade over the deferred task-graph runtime
(see taskgraph.py and DESIGN.md §5).

``TaskExecutor`` is the historical entry point: ``map`` / ``reduce`` /
``master`` are thin shims over ``submit`` + ``collect``, so every call
behaves as a barrier exactly like the original eager executor did -- same
per-task timing, same memory-budget OOM semantics, same dispatch-overhead
accounting.  Code that wants DAG-level scheduling (every algorithm in
``repro_torch.algorithms`` does) calls ``submit``/``reduce_tree`` and defers the
barrier to one ``collect`` per logical step, letting independent task
chains overlap in the modeled makespan.

``Environment``, ``TaskMemoryError`` and ``lpt_makespan`` are re-exported
from taskgraph.py for backward compatibility.
"""
from __future__ import annotations

from repro_torch.data.taskgraph import (  # noqa: F401  (re-exported API)
    Environment,
    Future,
    MeasurementCache,
    TaskGraph,
    TaskMemoryError,
    lpt_makespan,
)


class TaskExecutor(TaskGraph):
    """TaskGraph plus the eager phase-style API (compatibility shims).

    Each shim call collects the WHOLE pending graph -- any futures
    submitted earlier and not yet collected are flushed into the same
    epoch (and their values become subject to the normal epoch value
    lifetime).  Don't interleave deferred ``submit`` chains with these
    eager entry points unless that barrier is intended.
    """

    # ----------------------------------------------------------------- api
    def map(self, fn, items, name="map", extra_args=(), extra_mb: float = 0.0,
            unpack: bool = False):
        """Run fn over items as independent tasks (one barrier phase)."""
        fs = [self.submit(
            fn, *((tuple(it) if unpack else (it,)) + tuple(extra_args)),
            name=name, extra_mb=extra_mb) for it in items]
        return self.collect(*fs)

    def reduce(self, fn, items, name="reduce"):
        """Pairwise tree reduction, collected immediately (one barrier)."""
        root = self.reduce_tree(fn, items, name=name)
        return self.collect(root)[0]

    def master(self, fn, *args, name="master", **kwargs):
        """Single task on the master (e.g. final eigh); fully serial.  Not
        warmed: master tasks run once, so first-run time is the real cost."""
        f = self.submit(fn, *args, name=name, warm=False, **kwargs)
        return self.collect(f)[0]
