"""Worker registry: file-backed discovery for the serving fleet
(DESIGN.md §15), the port of the JAX package's ``repro/serve/registry.py``.

Without it, discovery is a hand-typed ``--workers host:port,...`` list.
This module replaces that list with a **lease registry**: every
``serve-worker`` process announces itself ``(host, port, started_at,
caps)`` to a shared JSONL file and keeps the lease alive by refreshing
it; a :class:`~repro_torch.serve.fleet.FleetRouter` (or any planner)
reads the live set back out and attaches — no flag changes when workers
come and go.

The file discipline is ``data/logstore.py``'s: append-only JSONL with a
schema header line, every write under an in-process lock plus (where the
platform has ``fcntl``) an exclusive ``flock`` on a ``<path>.lock``
sidecar, reads folding only *complete* lines from a byte offset — so
many worker processes (or containers sharing a volume) can announce into
one file concurrently, and a writer dying mid-line never poisons the
readers.

Event model (one JSON object per line):

* ``announce`` — a worker is up at ``addr`` with a ``ttl_s`` lease.
* ``refresh`` — the lease keeper re-arming the lease (same record,
  newer timestamp).
* ``withdraw`` — a clean shutdown; the lease ends immediately.

State is the fold: the latest event per address wins.  A lease whose
``ts + ttl_s`` is in the past is **stale** — the worker died without
withdrawing — and :meth:`WorkerRegistry.workers` stops returning it, so
a fleet never attaches to a corpse.  Timestamps are wall-clock
(``time.time()``): leases must be comparable across processes and hosts.
The file is the reference's, line for line, so one lease file serves
workers and fleets of both packages.
"""
from __future__ import annotations

import json
import socket
import threading
import time
from contextlib import contextmanager
from pathlib import Path

try:
    import fcntl
except ImportError:                                  # non-POSIX platforms
    fcntl = None

__all__ = ["WorkerRegistry", "LeaseKeeper", "DEFAULT_TTL_S"]

_SCHEMA = 1
DEFAULT_TTL_S = 10.0


class WorkerRegistry:
    """Shared worker-discovery file: announce/refresh/withdraw leases,
    read back the live worker set.  Safe under concurrent writers on one
    path (threads, processes, or containers sharing a volume)."""

    def __init__(self, path):
        self.path = Path(path)
        self._leases: dict[str, dict] = {}
        self._offset = 0              # bytes of self.path already folded
        self.skipped_lines = 0        # torn/garbage lines seen
        self._tlock = threading.RLock()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self._locked():
            if not self.path.exists() or self.path.stat().st_size == 0:
                with self.path.open("a") as f:
                    f.write(json.dumps({"schema": _SCHEMA,
                                        "kind": "worker-registry"}) + "\n")
            self._refresh()

    # ------------------------------------------------------------ locking
    @contextmanager
    def _locked(self):
        """Exclusive section: thread lock plus cross-process ``flock`` on
        a sidecar (the registry file itself stays append-only)."""
        with self._tlock:
            if fcntl is None:
                yield
                return
            with self.path.with_name(self.path.name + ".lock").open("w") \
                    as lf:
                fcntl.flock(lf, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(lf, fcntl.LOCK_UN)

    def _refresh(self) -> int:
        """Fold events appended since the last look (by this instance or
        any other writer); returns the number of events folded.  Only
        complete lines are consumed — catching another process mid-write
        just defers that event to the next refresh."""
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
            folded = 0
            for line in chunk.decode().splitlines():
                if not line.strip():
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    self.skipped_lines += 1        # writer died mid-line
                    continue
                if not isinstance(ev, dict):
                    self.skipped_lines += 1
                    continue
                if ev.get("kind") == "worker-registry":   # header line
                    continue
                op, addr = ev.get("op"), ev.get("addr")
                if op not in ("announce", "refresh", "withdraw") \
                        or not addr:
                    self.skipped_lines += 1
                    continue
                if op == "withdraw":
                    self._leases.pop(addr, None)
                elif op == "refresh" and addr in self._leases:
                    lease = self._leases[addr]
                    lease["ts"] = float(ev.get("ts", lease["ts"]))
                elif op in ("announce", "refresh"):
                    self._leases[addr] = {
                        "addr": addr,
                        "ts": float(ev.get("ts", 0.0)),
                        "ttl_s": float(ev.get("ttl_s", DEFAULT_TTL_S)),
                        "started_at": ev.get("started_at"),
                        "caps": ev.get("caps") or {},
                    }
                folded += 1
            return folded

    def _append(self, ev: dict) -> None:
        with self._locked():
            self._refresh()
            data = json.dumps(ev, separators=(",", ":")) + "\n"
            # a crashed writer can leave an unterminated trailing line
            # _refresh() deferred; terminate it instead of fusing onto it
            tail_gap = self.path.stat().st_size - self._offset
            if tail_gap > 0:
                data = "\n" + data
                self._offset += tail_gap + 1
                self.skipped_lines += 1
            with self.path.open("a") as f:
                f.write(data)
            self._offset += len(data.encode()) - (1 if tail_gap > 0 else 0)

    # ------------------------------------------------------------- leases
    def announce(self, addr: str, *, ttl_s: float = DEFAULT_TTL_S,
                 started_at: float | None = None,
                 caps: dict | None = None, now: float | None = None) -> dict:
        """Announce a worker at ``addr`` (``"host:port"``) with a lease of
        ``ttl_s`` seconds; returns the lease record.  Re-announcing the
        same address re-arms (and can re-shape) the lease."""
        now = time.time() if now is None else now
        ev = {"op": "announce", "addr": str(addr), "ts": now,
              "ttl_s": float(ttl_s),
              "started_at": now if started_at is None else started_at,
              "caps": dict(caps or {})}
        self._append(ev)
        self._leases[ev["addr"]] = {k: ev[k] for k in
                                    ("addr", "ts", "ttl_s", "started_at",
                                     "caps")}
        return dict(self._leases[ev["addr"]])

    def heartbeat(self, addr: str, now: float | None = None) -> None:
        """Refresh ``addr``'s lease — what a worker's lease keeper calls
        every ``ttl_s / 3`` or so.  Refreshing an address this registry
        has never seen announced is a no-op on the folded state (the
        event is still recorded for late readers)."""
        now = time.time() if now is None else now
        with self._tlock:
            self._append({"op": "refresh", "addr": str(addr), "ts": now})
            # _append advanced the offset past our own event: fold it by
            # hand, exactly as announce() does
            lease = self._leases.get(str(addr))
            if lease is not None:
                lease["ts"] = now

    refresh_lease = heartbeat

    def withdraw(self, addr: str) -> None:
        """End ``addr``'s lease immediately (clean worker shutdown)."""
        self._append({"op": "withdraw", "addr": str(addr)})
        self._leases.pop(str(addr), None)

    # -------------------------------------------------------------- views
    def workers(self, now: float | None = None) -> list[dict]:
        """Live worker records — leases whose ``ts + ttl_s`` has not
        lapsed — sorted oldest-announcement first (stable attach order).
        Folds any events other writers appended before answering."""
        now = time.time() if now is None else now
        with self._tlock:
            self._refresh()
            live = [dict(lease) for lease in self._leases.values()
                    if lease["ts"] + lease["ttl_s"] > now]
        return sorted(live, key=lambda w: (w["started_at"] or 0.0,
                                           w["addr"]))

    def addresses(self, now: float | None = None) -> list[str]:
        return [w["addr"] for w in self.workers(now)]

    def stale(self, now: float | None = None) -> list[dict]:
        """Lapsed-but-unwithdrawn leases: workers that died without
        saying goodbye.  The fleet never attaches to these; operators
        may want to alert on them."""
        now = time.time() if now is None else now
        with self._tlock:
            self._refresh()
            return [dict(lease) for lease in self._leases.values()
                    if lease["ts"] + lease["ttl_s"] <= now]

    def lease(self, addr: str) -> dict | None:
        with self._tlock:
            self._refresh()
            lease = self._leases.get(str(addr))
            return dict(lease) if lease else None

    def __len__(self) -> int:
        return len(self.workers())


class LeaseKeeper:
    """Background lease refresher for one worker: announce on
    :meth:`start`, refresh every ``interval_s`` (default ``ttl_s / 3``),
    withdraw on :meth:`stop` — so a cleanly exiting worker disappears
    from the registry immediately and a killed one lapses after
    ``ttl_s``."""

    def __init__(self, registry: WorkerRegistry, addr: str, *,
                 ttl_s: float = DEFAULT_TTL_S,
                 interval_s: float | None = None, caps: dict | None = None):
        self.registry = registry
        self.addr = str(addr)
        self.ttl_s = float(ttl_s)
        self.interval_s = interval_s if interval_s is not None \
            else max(self.ttl_s / 3.0, 0.05)
        self.caps = dict(caps or {})
        self.refreshes = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.registry.heartbeat(self.addr)
                self.refreshes += 1
            except OSError:                 # registry volume hiccup: retry
                pass

    def start(self) -> "LeaseKeeper":
        self.registry.announce(self.addr, ttl_s=self.ttl_s,
                               caps=self.caps)
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name=f"lease-{self.addr}", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout)
        try:
            self.registry.withdraw(self.addr)
        except OSError:
            pass


def default_caps() -> dict:
    """What a worker announces about itself by default."""
    import os
    return {"pid": os.getpid(), "host": socket.gethostname(),
            "cores": os.cpu_count() or 1}
