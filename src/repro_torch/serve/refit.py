"""Background refit daemon: tail the LogStore, learn off the request path,
swap atomically (DESIGN.md §10-§11); the port of the JAX package's
``repro/serve/refit.py``.

The closed loop (``eval/autorun.py``) appends every measured execution to
a persistent ``LogStore``; grid sweeps append there too.  The daemon is
the learning half of the serving tier: it ``follow()``s the store on an
interval, folds new records into a **working snapshot** of the serving
backend (never the live object — shards may be mid-predict on it), and
when a fold actually retrains (some group's argmin label moved,
``Tuner.refit`` semantics) it hands the retrained model to
``ShardRouter.swap``.  The §8 ``model_version`` contract makes the swap
memo-safe; the router's staleness contract makes it observable: no
request enqueued after the swap is served by the old model.

The daemon keeps folding into the same working snapshot between swaps, so
no-op records (a slower duplicate of a known cell) still update the
argmin bookkeeping — dropping them could mislead a later "did the label
move?" decision.  After each swap the swapped model is frozen (it is now
the live backend) and the daemon continues on a fresh deep copy.

Crash recovery: with a ``cursor_path`` the daemon persists a *durable*
cursor — the store offset of the last **swap** (not of every fold).  A
replacement daemon constructed with the same path resumes there: records
folded-but-not-swapped by the crashed daemon are re-read and re-folded
into a fresh snapshot of the live backend, which reconstructs exactly the
argmin bookkeeping the crash destroyed (the live backend *is* the
last-swapped model).  Advancing the durable cursor on mere folds would
instead lose that bookkeeping across a restart.

Run one refitter per router: this daemon *or* inline
``ShardRouter.refit``, not both.
"""
from __future__ import annotations

import copy
import json
import os
import threading
from pathlib import Path

from repro_torch.core.tuner import fold_records


class RefitDaemon:
    """Tail ``store`` from ``cursor`` (default: the current end, so only
    future appends are learned from) and refit/swap ``router``'s backend.

    ``source`` optionally restricts learning to records appended under one
    provenance tag (e.g. ``"autorun"`` to learn only from live runs, not
    replayed sweeps).  ``cursor_path`` enables crash/restart recovery: the
    durable cursor is read at construction (an explicit ``cursor`` arg
    wins) and re-persisted at every point where restarting there would
    lose no learning.  ``poll_once()`` is the whole cycle as a plain call
    — what the thread loop runs, and what deterministic tests drive."""

    def __init__(self, router, store, *, interval_s: float = 0.05,
                 cursor: int | None = None, source: str | None = None,
                 cursor_path=None):
        self.router = router
        self.store = store
        self.interval_s = interval_s
        self.source = source
        self.cursor_path = Path(cursor_path) if cursor_path else None
        if cursor is None:
            cursor = self._read_cursor()
        self.cursor = len(store) if cursor is None else cursor
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="refit-daemon", daemon=True)
        self._model = None            # working snapshot; folds every record
        self._unswapped_folds = False  # snapshot ahead of the live backend
        self.polls = 0
        self.records_seen = 0
        self.swaps = 0
        self.last_error: Exception | None = None
        self._persist_cursor()        # durable from the very first moment

    # ------------------------------------------------------ durable cursor
    def _read_cursor(self) -> int | None:
        if self.cursor_path is None or not self.cursor_path.exists():
            return None
        try:
            return int(json.loads(self.cursor_path.read_text())["cursor"])
        except (ValueError, KeyError, TypeError, OSError,
                json.JSONDecodeError):
            return None               # corrupt sidecar: fall back to tail

    def _persist_cursor(self) -> None:
        """Atomically record the durable cursor (write + rename), so a
        crash mid-persist leaves the previous cursor intact."""
        if self.cursor_path is None:
            return
        tmp = self.cursor_path.with_name(self.cursor_path.name + ".tmp")
        tmp.write_text(json.dumps({"cursor": self.cursor}))
        os.replace(tmp, self.cursor_path)

    # ------------------------------------------------------------- cycle
    def poll_once(self) -> bool:
        """One tail-fold-swap cycle; True iff a new model was swapped in.
        The cursor only advances after the fold/swap succeeds, so records
        seen on a cycle that raises are retried on the next poll instead
        of being silently dropped from learning (re-folding an identical
        record is a no-op in the argmin labeler).  The durable cursor
        additionally only advances when nothing folded-but-unswapped is
        pending (see the module docstring's restart argument)."""
        pairs, new_cursor = self.store.follow(self.cursor)
        self.polls += 1
        records = [r for r, src in pairs
                   if self.source is None or src == self.source]
        if not records:
            self.cursor = new_cursor
            if not self._unswapped_folds:
                self._persist_cursor()
            return False
        if self._model is None:
            backend = self.router.backend
            self._model = (backend.snapshot()
                           if hasattr(backend, "snapshot")
                           else copy.deepcopy(backend))
        if not fold_records(self._model, records):
            self.cursor = new_cursor
            self.records_seen += len(records)
            self._unswapped_folds = True
            return False
        new = self._model
        self._model = copy.deepcopy(new)      # keep folding off-path
        self.router.swap(new)
        self.cursor = new_cursor
        self.records_seen += len(records)
        self.swaps += 1
        self._unswapped_folds = False
        self._persist_cursor()                # swap is the durable frontier
        return True

    def _run(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:            # keep the daemon alive
                self.last_error = e
            self._stop.wait(self.interval_s)

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "RefitDaemon":
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    @property
    def running(self) -> bool:
        return self._thread.is_alive()
