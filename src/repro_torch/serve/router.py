"""Sharded online estimation tier (DESIGN.md §10), the port of the JAX
package's ``repro/serve/router.py``.

The serving story the paper implies at deployment time — applications
asking for block-size estimates at call rates where the estimator's own
latency must be negligible — needs more than one ``TunerService`` on one
thread.  This module is that tier:

* :class:`HashRing` — consistent hashing of *canonical* query keys
  (``TunerService._key``, i.e. the power-of-two shape bucket for block
  sizes) to shards, process-stable (blake2b, not Python's salted
  ``hash``), so a hot bucket always lands on the same shard and stays
  memo-local.
* :class:`Shard` — one ``TunerService`` replica with its **own** memo, a
  bounded admission queue, and a worker thread that drains the queue in
  micro-batches through the existing ``submit()``/``flush()``
  aggregation path.  All service access happens under the shard lock;
  there is no shared mutable memo anywhere, which is the whole
  thread-safety argument.
* :class:`ShardRouter` — the front door: admits a request (``"block"``
  waits for queue room, ``"reject"`` raises :class:`RouterRejected`),
  routes it to its shard, and hands back a :class:`ServeResult` tagged
  with the ``model_version`` that served it.  ``swap()`` atomically
  replaces the backend on every shard (under each shard lock), which is
  what the refit daemon (``serve/refit.py``) calls; the §8
  ``model_version`` invalidation makes the swap memo-safe.  **Staleness
  contract:** once ``swap()`` returns, no request enqueued afterwards
  can be served by the old model — the load generator
  (``serve/loadgen.py``) audits exactly this.

Queries the backend *abstains* on (unfit model, or an algorithm with no
labeled training group) are served by the ds-array default square
heuristic inside the shard worker, bypassing the memo — so a later refit
that learns the algorithm is never masked by a cached fallback.

The tier runs on the host: a shard predicts with the CART cascade in
numpy, and nothing on a shard's thread touches a device.
"""
from __future__ import annotations

import hashlib
import queue as queue_mod
import threading
import time
from bisect import bisect_right

from repro_torch.core.estimator import EstimatorService
from repro_torch.core.tuner import fold_records
from repro_torch.data.executor import Environment
from repro_torch.eval.autorun import default_partitioning
from repro_torch.serve.stats import normalize_stats

__all__ = ["DeadlineExceeded", "HashRing", "RouterClosed", "RouterRejected",
           "ServeResult", "Shard", "ShardRouter"]

_STOP = object()


class RouterRejected(RuntimeError):
    """Admission queue full under ``admission="reject"``."""


class RouterClosed(RuntimeError):
    """Request arrived after ``ShardRouter.close()``."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed while it waited in a shard queue; it
    was dropped unserved (freeing its queue slot and serving capacity)
    instead of burning model time on an answer nobody is waiting for."""


def _hash64(text: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(text.encode(), digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring with virtual nodes.  Stable across processes
    and runs (keyed on blake2b of the key's ``repr``), which is what the
    affinity tests and the seeded load generator rely on.  ``weights``
    (per-shard floats, default all-equal) scale each shard's vnode count,
    so a beefier shard — e.g. a replicated group in the fleet — can own
    proportionally more of the key space; unweighted rings keep the
    exact point set prior code observed."""

    def __init__(self, n_shards: int, vnodes: int = 32, weights=None):
        if n_shards < 1:
            raise ValueError("need at least one shard")
        if weights is None:
            counts = [vnodes] * n_shards
        else:
            weights = list(weights)
            if len(weights) != n_shards:
                raise ValueError(f"{len(weights)} weights for "
                                 f"{n_shards} shards")
            counts = [max(1, int(round(vnodes * w))) for w in weights]
        pts = sorted((_hash64(f"shard-{s}-vnode-{v}"), s)
                     for s in range(n_shards) for v in range(counts[s]))
        self._hashes = [h for h, _ in pts]
        self._owners = [s for _, s in pts]

    def shard_for(self, key) -> int:
        i = bisect_right(self._hashes, _hash64(repr(key)))
        return self._owners[i % len(self._owners)]


class ServeResult:
    """One served request: the prediction plus the serving provenance the
    staleness audit needs (shard, model_version, enqueue/done times)."""
    __slots__ = ("value", "shard", "model_version", "chosen_by",
                 "t_enq", "t_done")

    def __init__(self, value, shard, model_version, chosen_by, t_enq,
                 t_done=0.0):
        self.value = value
        self.shard = shard
        self.model_version = model_version
        self.chosen_by = chosen_by        # "model" | "default" (abstained)
        self.t_enq = t_enq
        self.t_done = t_done

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_enq

    def __repr__(self):
        return (f"ServeResult({self.value!r}, shard={self.shard}, "
                f"v{self.model_version}, by={self.chosen_by})")


class _Request:
    __slots__ = ("query", "event", "result", "error", "t_enq", "deadline")

    def __init__(self, query, t_enq, deadline=None):
        self.query = query
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_enq = t_enq
        self.deadline = deadline          # absolute monotonic time or None


def _algo_of(query) -> str:
    """Algorithm name of a query: ``TuneQuery.algo`` or the third element
    of an ``EstimatorService``-style ``(n_rows, n_cols, algo, env)``."""
    return query.algo if hasattr(query, "algo") else query[2]


def _default_for_query(query, s: int = 2):
    """Abstain fallback for estimator-style queries: the ds-array default
    square heuristic under the query's worker count."""
    n_rows, n_cols, _algo, env = query
    env_obj = Environment(n_workers=max(int(env.get("n_workers", 1) or 1), 1))
    return default_partitioning(int(n_rows), int(n_cols), env_obj, s=s)


class Shard:
    """One serving replica: a private ``TunerService`` (own memo), a
    bounded queue, and a worker draining it in micro-batches under the
    shard lock.  Created and owned by :class:`ShardRouter`."""

    def __init__(self, idx: int, service, *, queue_depth: int,
                 batch_max: int, window_s: float, abstain_fallback):
        self.idx = idx
        self.service = service
        self.lock = threading.Lock()
        self.queue: queue_mod.Queue = queue_mod.Queue(maxsize=queue_depth)
        self.batch_max = batch_max
        self.window_s = window_s
        self._abstain_fallback = abstain_fallback
        self.served = 0
        self.abstained = 0
        self.batches = 0
        self.max_batch = 0
        self.queue_high_water = 0
        self.rejected = 0
        self.expired = 0               # deadline-dropped without serving
        self.crashed = False           # worker thread died (injected)
        self._crash_after = None       # crash before serving the Nth batch
        self._on_crash = None          # ShardRouter._handle_crash
        self.thread = threading.Thread(target=self._run,
                                       name=f"serve-shard-{idx}", daemon=True)

    # ------------------------------------------------------------- worker
    def _drain_rest(self) -> list:
        items = []
        while True:
            try:
                item = self.queue.get_nowait()
            except queue_mod.Empty:
                return items
            if item is not _STOP:
                items.append(item)

    def _run(self):
        stop = False
        while not stop:
            item = self.queue.get()
            if item is _STOP:
                # admission is already closed; serve whatever raced in
                batch, stop = self._drain_rest(), True
            else:
                batch = [item]
                deadline = time.monotonic() + self.window_s
                while len(batch) < self.batch_max:
                    try:
                        nxt = self.queue.get(
                            timeout=max(0.0, deadline - time.monotonic()))
                    except queue_mod.Empty:
                        break
                    if nxt is _STOP:
                        batch += self._drain_rest()
                        stop = True
                        break
                    batch.append(nxt)
            if batch and not stop and self._crash_after is not None:
                # injected worker crash: die *holding* an unserved batch
                # (the hard case -- these must be re-routed, not lost).
                # Never crash on the shutdown drain: close() already owns
                # those requests' fate.
                if self._crash_after <= 0:
                    self.crashed = True
                    orphans = batch + self._drain_rest()
                    if self._on_crash is not None:
                        self._on_crash(self, orphans)
                    return
                self._crash_after -= 1
            if batch:
                self._serve(batch)

    def _expire(self, requests: list) -> list:
        """Fail requests whose deadline passed while queued (their slot is
        already freed by the dequeue; this frees the *serving* capacity)
        and return the still-live remainder."""
        now = time.monotonic()
        live = []
        for req in requests:
            if req.deadline is not None and now > req.deadline:
                self.expired += 1
                req.error = DeadlineExceeded(
                    f"deadline passed {now - req.deadline:.4f}s before "
                    f"shard {self.idx} could serve the request")
                req.event.set()
            else:
                live.append(req)
        return live

    def _serve(self, batch: list):
        batch = self._expire(batch)
        if not batch:
            return
        try:
            with self.lock:
                backend = self.service.backend
                version = getattr(backend, "model_version", None)
                pending = []
                for req in batch:
                    if backend.abstains(_algo_of(req.query)):
                        req.result = ServeResult(
                            self._abstain_fallback(req.query), self.idx,
                            version, "default", req.t_enq)
                    else:
                        pending.append((req, self.service.submit(req.query)))
                if pending:
                    try:
                        self.service.flush()
                    except Exception as e:
                        # flush() keeps its queue for retry; a router
                        # request is answered exactly once, so fail these
                        # and reset
                        self.service.discard_pending()
                        for req, _ in pending:
                            req.error = e
                    else:
                        for req, handle in pending:
                            req.result = ServeResult(
                                handle.result(), self.idx, version, "model",
                                req.t_enq)
        except Exception as e:
            # a poisoned query (bad abstain fallback, malformed key) must
            # fail its own batch, not kill the worker and deaden the shard
            self.service.discard_pending()
            for req in batch:
                if req.result is None and req.error is None:
                    req.error = e
        finally:
            t_done = time.monotonic()
            self.served += len(batch)
            self.abstained += sum(1 for r in batch
                                  if r.result is not None
                                  and r.result.chosen_by == "default")
            self.batches += 1
            self.max_batch = max(self.max_batch, len(batch))
            for req in batch:
                if req.result is not None:
                    req.result.t_done = t_done
                req.event.set()


class ShardRouter:
    """N ``TunerService`` replicas behind a consistent-hash router.

    ``backend`` is the shared (read-only on the request path) tuner or
    estimator every shard serves from; ``service_factory(backend,
    maxsize)`` builds the per-shard replica (default
    :class:`EstimatorService`, so queries are ``(n_rows, n_cols, algo,
    env_features)`` tuples).  ``admission`` is ``"block"`` (callers wait
    for queue room — nothing is ever dropped) or ``"reject"`` (a full
    shard queue raises :class:`RouterRejected` immediately — the
    backpressure signal a real front door wants)."""

    def __init__(self, backend, *, n_shards: int = 4,
                 service_factory=EstimatorService, maxsize: int = 4096,
                 queue_depth: int = 256, admission: str = "block",
                 batch_max: int = 32, window_s: float = 0.002,
                 vnodes: int = 32, abstain_fallback=None):
        if admission not in ("block", "reject"):
            raise ValueError(f"admission must be block|reject, "
                             f"got {admission!r}")
        self._backend = backend
        self.admission = admission
        self._ring = HashRing(n_shards, vnodes)
        fallback = abstain_fallback or (
            lambda q: _default_for_query(q, s=getattr(backend, "s", 2)))
        # kept for respawning a crashed shard with an identical replica
        self._service_factory = service_factory
        self._maxsize = maxsize
        self._shard_kw = dict(queue_depth=queue_depth, batch_max=batch_max,
                              window_s=window_s, abstain_fallback=fallback)
        self.shards = [self._make_shard(i) for i in range(n_shards)]
        self._closed = False
        self._swap_lock = threading.RLock()
        self.crashes = 0
        self.respawns = 0
        self.rerouted = 0
        # counters of crashed (replaced) shards, so totals stay monotonic
        self._retired = {"served": 0, "abstained": 0, "rejected": 0,
                         "expired": 0, "hits": 0, "misses": 0,
                         "invalidations": 0}
        # (monotonic time the swap completed, model_version) — seeded with
        # the construction-time version so the staleness audit has epoch 0
        self.swap_log: list[tuple[float, int]] = [
            (time.monotonic(), getattr(backend, "model_version", 0) or 0)]
        for sh in self.shards:
            sh.thread.start()

    def _make_shard(self, idx: int) -> Shard:
        sh = Shard(idx, self._service_factory(self._backend, self._maxsize),
                   **self._shard_kw)
        sh._on_crash = self._handle_crash
        return sh

    # ----------------------------------------------------------- identity
    @property
    def backend(self):
        return self._backend

    @property
    def estimator(self):
        """The current serving backend — named for ``AutoTunedRun``, which
        duck-types its service's ``.estimator`` for abstain checks and
        version tags.  Always the *live* object: after a ``swap`` this is
        the new model."""
        return self._backend

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def shard_for(self, query) -> int:
        """Shard index a query routes to (canonical-key affinity)."""
        return self._ring.shard_for(self.shards[0].service._key(query))

    # ----------------------------------------------------- failure chaos
    def inject_crash(self, shard_idx: int, after_batches: int = 0) -> None:
        """Arm a deterministic worker crash on shard ``shard_idx``: its
        worker thread dies *holding* the batch it assembled, after serving
        ``after_batches`` more batches.  The crash handler respawns the
        shard and ring-re-routes the orphaned requests, so no request is
        lost (asserted by the chaos bench)."""
        self.shards[shard_idx]._crash_after = max(0, int(after_batches))

    def _handle_crash(self, sh: Shard, orphans: list) -> None:
        """Runs on the dying shard's worker thread: respawn a fresh
        replica of the *current* backend (under the swap lock, so it can
        never be older than any completed swap — the staleness contract
        survives the crash) and re-route every orphaned request."""
        with self._swap_lock:
            self.crashes += 1
            self._retired["served"] += sh.served
            self._retired["abstained"] += sh.abstained
            self._retired["rejected"] += sh.rejected
            self._retired["expired"] += sh.expired
            self._retired["hits"] += sh.service.hits
            self._retired["misses"] += sh.service.misses
            self._retired["invalidations"] += sh.service.invalidations
            if not self._closed:
                fresh = self._make_shard(sh.idx)
                self.shards[sh.idx] = fresh
                fresh.thread.start()
                self.respawns += 1
            # anything admitted to the dead queue after the worker's own
            # drain (racing _submit callers) is rescued here or by the
            # submitter's crashed-check; queue gets are exclusive, so no
            # request is handled twice
            orphans = orphans + sh._drain_rest()
        if self._closed:
            for req in orphans:
                req.error = RouterClosed("router closed during crash "
                                         "recovery")
                req.event.set()
            return
        for req in orphans:
            self._reroute(sh.idx, req)

    def _reroute(self, dead_idx: int, req: _Request) -> None:
        """Ring re-route one orphaned request: try each successor shard's
        queue without blocking, ending at ``dead_idx`` itself (by now the
        respawned replica); fall back to a blocking put on the immediate
        successor when every queue is full."""
        n = len(self.shards)
        for k in range(1, n + 1):
            target = self.shards[(dead_idx + k) % n]
            if target.crashed:
                continue
            try:
                target.queue.put_nowait(req)
            except queue_mod.Full:
                continue
            self.rerouted += 1
            return
        self.shards[(dead_idx + 1) % n].queue.put(req)
        self.rerouted += 1

    # ------------------------------------------------------------ serving
    def _submit(self, query, deadline_s: float | None = None) -> _Request:
        """Admit and route one query without waiting for the answer."""
        if self._closed:
            raise RouterClosed("router is closed")
        t_enq = time.monotonic()
        req = _Request(query, t_enq,
                       None if deadline_s is None else t_enq + deadline_s)
        sh = self.shards[self.shard_for(query)]
        try:
            if self.admission == "reject":
                sh.queue.put_nowait(req)
            else:
                sh.queue.put(req)
        except queue_mod.Full:
            sh.rejected += 1
            raise RouterRejected(f"shard {sh.idx} admission queue full "
                                 f"(depth {sh.queue.maxsize})") from None
        if self._closed and not sh.thread.is_alive():
            # raced with close(): the worker may have exited before this
            # enqueue landed, so nobody would ever drain it — fail the
            # stragglers (ours included) instead of hanging the caller
            for straggler in sh._drain_rest():
                straggler.error = RouterClosed("router closed")
                straggler.event.set()
        if sh.crashed:
            # raced with a crash: the worker died before (or while) this
            # enqueue landed and its final drain may have missed it —
            # rescue everything stranded on the dead queue
            for straggler in sh._drain_rest():
                self._reroute(sh.idx, straggler)
        sh.queue_high_water = max(sh.queue_high_water, sh.queue.qsize())
        return req

    @staticmethod
    def _await(req: _Request, timeout: float | None) -> ServeResult:
        if not req.event.wait(timeout):
            raise TimeoutError(f"no answer within {timeout}s")
        if req.error is not None:
            raise req.error
        return req.result

    def request(self, query, timeout: float | None = None,
                deadline_s: float | None = None) -> ServeResult:
        """Admit, route, and wait for one query; returns the
        :class:`ServeResult` (or raises :class:`RouterRejected` /
        :class:`RouterClosed` / :class:`DeadlineExceeded` / the serving
        error).  ``deadline_s`` is a server-side budget: a request still
        queued when it expires is dropped unserved, freeing its slot."""
        return self._await(self._submit(query, deadline_s), timeout)

    def predict(self, query, timeout: float | None = None,
                deadline_s: float | None = None):
        """The bare prediction — drop-in for ``EstimatorService.predict``
        (what ``AutoTunedRun`` calls)."""
        return self.request(query, timeout, deadline_s).value

    def predict_batch(self, queries, timeout: float | None = None,
                      deadline_s: float | None = None) -> list:
        """Enqueue every query first, then await them all — one shared
        micro-batch window instead of N sequential round trips.  The
        first admission rejection or serving error propagates (requests
        already enqueued are still served; their results are dropped)."""
        reqs = [self._submit(q, deadline_s) for q in queries]
        return [self._await(r, timeout).value for r in reqs]

    # ----------------------------------------------------- refit / swap
    def swap(self, new_backend) -> int:
        """Atomically replace the serving backend on every shard (each
        under its shard lock) and log the swap.  After this returns, no
        request enqueued later can be served by the old model: a later
        enqueue is drained by a worker that must re-acquire the shard
        lock this swap just held, and the memo flushes via the §8
        ``model_version`` check.  Returns the new version."""
        with self._swap_lock:
            for sh in self.shards:
                with sh.lock:
                    sh.service.swap_backend(new_backend)
            self._backend = new_backend
            version = getattr(new_backend, "model_version", 0) or 0
            self.swap_log.append((time.monotonic(), version))
            return version

    def refit(self, new_records) -> bool:
        """The safe learning path for a live router: snapshot the backend,
        fold/retrain the snapshot *off* the request path, and swap it in
        only if the model actually changed.  Keeps the live backend
        immutable while shards serve from it.  Returns True iff a new
        model was swapped in.  Run one refitter per router (this inline
        path or a ``serve/refit.py`` daemon, not both)."""
        with self._swap_lock:
            snap = self._backend.snapshot()
            if not fold_records(snap, new_records):
                return False
            self.swap(snap)
            return True

    # -------------------------------------------------------- observability
    def stats(self) -> dict:
        """Structured router counters; the whole snapshot is taken under
        the swap lock so a concurrent crash respawn (which retires the
        dead shard's counters into ``_retired`` and installs a fresh
        replica) can never be observed half-applied — a retired shard
        and its respawn are counted exactly once, and ``close()`` racing
        a ``stats()`` poll sees the same invariant.  Per-shard sections
        are additionally read under each shard lock so hit/miss pairs
        are mutually consistent."""
        with self._swap_lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        per = []
        for sh in self.shards:
            with sh.lock:
                svc = sh.service
                per.append({"shard": sh.idx, "served": sh.served,
                            "abstained": sh.abstained, "hits": svc.hits,
                            "misses": svc.misses, "hit_rate": svc.hit_rate,
                            "invalidations": svc.invalidations,
                            "batches": sh.batches, "max_batch": sh.max_batch,
                            "queue_high_water": sh.queue_high_water,
                            "rejected": sh.rejected,
                            "expired": sh.expired})
        ret = self._retired
        hits = sum(p["hits"] for p in per) + ret["hits"]
        misses = sum(p["misses"] for p in per) + ret["misses"]
        return normalize_stats({"n_shards": len(self.shards),
                "served": sum(p["served"] for p in per) + ret["served"],
                "abstained": (sum(p["abstained"] for p in per)
                              + ret["abstained"]),
                "rejected": (sum(p["rejected"] for p in per)
                             + ret["rejected"]),
                "expired": sum(p["expired"] for p in per) + ret["expired"],
                "hits": hits, "misses": misses,
                "hit_rate": hits / (hits + misses) if hits + misses else 0.0,
                "invalidations": (sum(p["invalidations"] for p in per)
                                  + ret["invalidations"]),
                "model_version": getattr(self._backend, "model_version",
                                         None),
                "swaps": len(self.swap_log) - 1,
                "crashes": self.crashes, "respawns": self.respawns,
                "rerouted": self.rerouted,
                "queued": sum(sh.queue.qsize() for sh in self.shards),
                "per_shard": per})

    @property
    def pending(self) -> int:
        return sum(sh.queue.qsize() for sh in self.shards)

    # ------------------------------------------------------------ shutdown
    def close(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop admission, then either serve everything already queued
        (``drain=True``, the graceful path) or fail queued requests with
        :class:`RouterClosed`, and join the shard workers."""
        if self._closed:
            return
        self._closed = True
        for sh in self.shards:
            if not drain:
                for req in sh._drain_rest():
                    req.error = RouterClosed("router closed before serving")
                    req.event.set()
            sh.queue.put(_STOP)
        for sh in self.shards:
            sh.thread.join(timeout)
        # anything admitted between a worker's final drain and here would
        # otherwise hang its caller forever
        for sh in self.shards:
            for req in sh._drain_rest():
                req.error = RouterClosed("router closed before serving")
                req.event.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
