"""Persistent execution-log store: append-only, schema-versioned JSONL.

One ``LogStore`` accumulates training data from every sweep family —
``core/gridsearch.py`` ds-array sweeps, ``core/kerneltune.py`` tile
cost-model grids, ``core/meshtune.py`` roofline mesh grids — into a single
file under ``artifacts/`` (all three sweeps take a ``store=`` argument).
Appends are deduplicated by :meth:`ExecutionRecord.record_key` (the
<d, a, e> group plus the partitioning tried), so re-running a sweep is
idempotent and merging overlapping logs never double-counts a cell.
Records for one tuner are pulled back out with ``load(algos=...)``;
``Tuner.refit`` consumes the same record stream incrementally.

Concurrency: a store is safe under concurrent writers — the closed-loop
autorun driver and the serving tier's refit daemon share one store, and
several processes may append to the same path.  Every append holds an
in-process lock plus (where the platform has ``fcntl``) an exclusive lock
on a ``<path>.lock`` sidecar, and first folds any bytes other writers
appended since the last look, so the dedup-by-``record_key`` contract
holds across instances too.  :meth:`follow` is the tail-side of the same
machinery: an offset cursor over the append order that surfaces new
records (whoever wrote them) without re-reading the file from the top.

File layout: a header line ``{"schema": 1, "kind": "logstore", "s": 2}``
followed by one record object per line, each carrying the ``source`` tag
it was appended under.  Legacy headerless ``ExecutionLog.save`` files are
readable (treated as schema 1, ``s=2``).
"""
from __future__ import annotations

import dataclasses
import json
import threading
from contextlib import contextmanager
from pathlib import Path

import torch

from repro_torch.core.log import (SCHEMA_VERSION, ExecutionLog, ExecutionRecord,
                            canon_items, parse_header)

try:
    import fcntl
except ImportError:                                  # non-POSIX platforms
    fcntl = None


def ds_timing(device) -> dict:
    """The ``<e>`` item that tags a ds record with the device that timed it:
    a string, so ``featurize`` skips it, but part of the record key, so a
    CPU run and a card run share one store without one shadowing the
    other's cells."""
    return {"timing": f"wallclock:{torch.device(device).type}"}


def timed_copies(records, device) -> list:
    """Copies of ``records`` tagged with ``ds_timing(device)``: what a
    ds-array sweep or run appends to a store.  The in-memory records stay
    untagged, so fits, holdout splits and reports are the reference's."""
    timing = ds_timing(device)
    return [dataclasses.replace(r, env={**r.env, **timing}) for r in records]


class LogStore:
    def __init__(self, path, s: int = 2):
        self.path = Path(path)
        self.s = s
        self._records: list[ExecutionRecord] = []
        self._sources: list[str | None] = []
        self._keys: set = set()
        self._offset = 0              # bytes of self.path already folded
        self.skipped_lines = 0        # malformed lines seen (crashed writer)
        self._tlock = threading.RLock()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self._locked():
            if not self.path.exists() or self.path.stat().st_size == 0:
                # header written under the lock so two processes racing to
                # create the same store can't both emit one
                with self.path.open("a") as f:
                    f.write(json.dumps(
                        {"schema": SCHEMA_VERSION, "kind": "logstore",
                         "s": self.s}) + "\n")
            self._refresh()

    # -------------------------------------------------------------- locking
    @contextmanager
    def _locked(self):
        """Exclusive section: in-process (thread lock) and, where the
        platform supports it, cross-process (``flock`` on a sidecar, so the
        data file itself stays append-only)."""
        with self._tlock:
            if fcntl is None:
                yield
                return
            with self.path.with_name(self.path.name + ".lock").open("w") as lf:
                fcntl.flock(lf, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(lf, fcntl.LOCK_UN)

    def _refresh(self) -> int:
        """Fold bytes appended since the last look (by this instance or any
        other writer on the same path); returns the number of new records.
        Only complete lines are consumed, so catching another process
        mid-write just defers that record to the next refresh."""
        with self._tlock:
            if not self.path.exists():
                return 0
            with self.path.open("rb") as f:
                f.seek(self._offset)
                chunk = f.read()
            end = chunk.rfind(b"\n")
            if end < 0:
                return 0
            chunk = chunk[:end + 1]
            self._offset += len(chunk)
            new = 0
            for line in chunk.decode().splitlines():
                if not line.strip():
                    continue
                try:
                    o = json.loads(line)
                except json.JSONDecodeError:
                    # a writer died mid-line: skip the broken line rather
                    # than poisoning every reader
                    self.skipped_lines += 1
                    continue
                s = parse_header(o, self.path)   # newer schema still raises
                if s is not None:                        # header line
                    self.s = s
                    continue
                try:
                    rec = ExecutionRecord.from_obj(o)
                except (KeyError, TypeError, ValueError):
                    self.skipped_lines += 1              # garbage record
                    continue
                key = rec.record_key()
                if key in self._keys:                    # duplicate on disk
                    continue
                self._keys.add(key)
                self._records.append(rec)
                self._sources.append(o.get("source"))
                new += 1
            return new

    # ------------------------------------------------------------- append
    def append(self, records, source: str | None = None) -> int:
        """Append records not already present (by ``record_key``); returns
        the number of newly persisted records.  Safe under concurrent
        writers: the whole refresh-dedup-write sequence runs under the
        store lock, so overlapping appends from other threads/processes
        are folded first and never duplicated."""
        if isinstance(records, ExecutionLog):
            records = records.records
        records = list(records)
        with self._locked():
            self._refresh()
            fresh = []
            for rec in records:
                key = rec.record_key()
                if key in self._keys:
                    continue
                self._keys.add(key)
                fresh.append(rec)
            if fresh:
                lines = []
                for rec in fresh:
                    obj = rec.to_obj()
                    if source is not None:
                        obj["source"] = source
                    lines.append(json.dumps(obj) + "\n")
                data = "".join(lines)
                # a crashed (or fcntl-less) writer can leave an
                # unterminated trailing line _refresh() deferred; fusing
                # our first record onto it would corrupt both, so
                # terminate it and skip past the broken bytes
                tail_gap = self.path.stat().st_size - self._offset
                if tail_gap > 0:
                    data = "\n" + data
                    self._offset += tail_gap + 1
                    self.skipped_lines += 1
                with self.path.open("a") as f:
                    f.write(data)
                self._offset += len(data.encode()) - (1 if tail_gap > 0
                                                      else 0)
                self._records.extend(fresh)
                self._sources.extend([source] * len(fresh))
        return len(fresh)

    merge = append                       # merging a log IS a deduped append

    # --------------------------------------------------------------- read
    def load(self, algos=None, source: str | None = None) -> ExecutionLog:
        """Materialize an ``ExecutionLog`` view, optionally filtered to a
        set of algorithm names and/or one append source."""
        if isinstance(algos, str):
            algos = (algos,)
        with self._tlock:
            recs = [r for r, src in zip(self._records, self._sources)
                    if (algos is None or r.algo in algos)
                    and (source is None or src == source)]
        return ExecutionLog(recs, s=self.s)

    def group_cells(self, dataset: dict, algo: str, env: dict,
                    source: str | None = None) -> dict:
        """``{(p_r, p_c): record}`` for one <d, a, e> triple, optionally
        filtered to an append source — the measurement memo behind
        ``core/kerneltune.measure_case``: a cell already present for the
        triple means that tile pair was timed in an earlier sweep (by any
        writer of this path) and is served from the store instead of being
        re-measured."""
        key = (canon_items(dataset), algo, canon_items(env))
        with self._tlock:
            self._refresh()
            out = {}
            for r, src in zip(self._records, self._sources):
                if source is not None and src != source:
                    continue
                if r.triple_key() == key:
                    out[(r.p_r, r.p_c)] = r
        return out

    def follow(self, cursor: int = 0) -> tuple[list, int]:
        """Tail the store: fold anything appended since the last look
        (other instances and processes included) and return
        ``(new_pairs, new_cursor)`` — ``new_pairs`` is the ``(record,
        source)`` list past ``cursor`` in append order.  Start from
        ``cursor=len(store)`` to watch only future appends; feed each
        call's returned cursor back in.  This is the refit daemon's feed
        (``serve/refit.py``)."""
        with self._tlock:
            self._refresh()
            pairs = list(zip(self._records[cursor:], self._sources[cursor:]))
            return pairs, len(self._records)

    def iter_records(self):
        """Yield ``(record, source)`` pairs in append order — the
        run-provenance view: closed-loop runs are tagged ``"autorun"``,
        sweeps ``"grid_search"`` etc., so an audit can tell which training
        rows came from live executions versus offline sweeps."""
        yield from zip(self._records, self._sources)

    def last(self, n: int = 1) -> list:
        """The ``n`` most recently appended ``(record, source)`` pairs."""
        return list(zip(self._records[-n:], self._sources[-n:]))

    def sources(self) -> dict:
        """source tag -> record count (None = untagged appends)."""
        out: dict = {}
        for src in self._sources:
            out[src] = out.get(src, 0) + 1
        return out

    def __len__(self) -> int:
        return len(self._records)
