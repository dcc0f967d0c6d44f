"""Multi-process / multi-node serving fleet: management layer over shard
worker replicas (DESIGN.md §13–§14), the port of the JAX package's
``repro/serve/fleet.py``.

**Contract (read-your-writes across refit swaps).**  Any request
admitted after ``swap(model_v2)`` returns is served by a replica that
acknowledged v2 — never by an older model.  The barrier holds across
every failure mode this module knows: rolling swaps (the read barrier
only advances after the last replica acks), worker crashes racing a
swap (the respawn carries the in-flight swap target, never the stale
model), dropped socket connections (treated exactly as crashes), and
replica migration (a moved replica attaches at the current target).
The load generator audits it (``staleness_violations``) and the tests
gate it at exactly zero.

``serve/router.py``'s ShardRouter proved the serving contracts —
consistent-hash affinity, zero-staleness refit swaps, crash respawn —
inside one process.  This module scales the same contracts out, across
processes and across hosts:

* :class:`FleetRouter` — the management layer.  It owns admission
  (per-class priorities + early deadline drop *before* enqueue), the
  consistent-hash ring (optionally weighted), replica groups, swaps,
  crash respawn, and observability.  It never touches a model: all
  compute lives behind a transport (``serve/transport.py``) in shard
  workers — threads on the deterministic loopback path, real
  ``multiprocessing`` workers in fleet mode.
* **Replica groups** — each logical shard is served by one or more
  replicas (*read-any*: a request picks the least-loaded eligible
  replica; *write-all*: a swap lands on every replica).  Hot shards get
  more replicas, which is what fixes the served-skew bottleneck the
  single-replica router shows under hot-key traffic.
* **Versioned swap barriers** — ``swap()`` rolls the new model across
  replicas one at a time (zero downtime: the rest of the group keeps
  serving).  Only after *every* replica acked does the read barrier
  advance, so a request admitted after ``swap()`` returns can only be
  served by a replica at the new version — read-your-writes across
  refit swaps, the same staleness contract the loadgen audits.
* :class:`Autoscaler` — scale-out on sustained queue pressure,
  scale-in on sustained idle, with hysteresis (consecutive-tick
  streaks + cooldown) so a noisy load can't flap replicas.  With a
  **global replica budget** it also *rebalances*: every
  ``rebalance_every`` ticks it re-plans from the live served histogram
  (:func:`live_demand_plan` — the online replacement for the static
  trace walk) and **migrates** replicas from cold shards to hot ones
  (drain → detach → attach elsewhere) instead of only growing groups.
* **Cross-host transport** — ``transport="socket"`` runs each replica
  behind a TCP connection: spawned locally on ephemeral ports, or
  attached to ``python -m repro_torch serve-worker`` processes on other nodes
  via ``worker_addrs``.  A dropped connection is a worker loss; crash
  recovery reattaches to the same address (the remote worker re-enters
  accept) or spawns a local replacement.
* **Overload shedding** — beyond block/reject: request classes
  (``interactive`` > ``batch`` > ``best_effort``) admit against
  per-class queue fractions, so background traffic sheds first, and a
  request whose deadline cannot be met given the queue's service-time
  EMA is dropped *before* it consumes a queue slot.

The fleet runs on the host, as the in-process tier does: a worker
predicts with the CART cascade in numpy and its backend carries no
tensor, so a worker forked from a process that holds a CUDA context
never calls CUDA.
"""
from __future__ import annotations

import json
import os
import threading
import time
import queue as queue_mod
from pathlib import Path

from repro_torch.core.estimator import EstimatorService
from repro_torch.core.tuner import fold_records
from repro_torch.serve.registry import WorkerRegistry
from repro_torch.serve.router import (DeadlineExceeded, HashRing, RouterClosed,
                                RouterRejected, ServeResult, _Request)
from repro_torch.serve.stats import normalize_stats
from repro_torch.serve.transport import TRANSPORTS, TransportDead, TransportSpec

__all__ = ["AutoscalePolicy", "Autoscaler", "FleetRouter",
           "HealthProber", "HeartbeatPolicy", "Replica",
           "ShardGroup", "ShedRejected", "CLASS_PRIORITY", "demand_plan",
           "trace_histogram", "proportional_plan", "live_demand_plan"]


def trace_histogram(backend, trace, n_shards: int, *, vnodes: int = 32,
                    service_factory=EstimatorService) -> list[int]:
    """Per-shard request counts of ``trace`` walked through the same
    ring/keyer the fleet will use — the offline demand histogram."""
    ring = HashRing(n_shards, vnodes)
    keyer = service_factory(backend, 2)
    counts = [0] * n_shards
    for entry in trace:
        counts[ring.shard_for(keyer._key(entry[1]))] += 1
    return counts


def demand_plan(backend, trace, n_shards: int, *, target_units: int = 8,
                vnodes: int = 32,
                service_factory=EstimatorService) -> dict:
    """Demand-proportional replica plan: walk ``trace`` through the same
    ring/keyer the fleet will use, then hand each shard a share of
    ``target_units`` replicas proportional to its traffic (minimum one).
    This is the capacity-planning step that fixes hot-shard served skew:
    consistent hashing pins hot keys to one shard, so the only lever is
    replicating that shard's serving capacity.  (Static/offline variant;
    :func:`live_demand_plan` re-plans from the live served histogram.)"""
    counts = trace_histogram(backend, trace, n_shards, vnodes=vnodes,
                             service_factory=service_factory)
    total = sum(counts) or 1
    return {s: max(1, round(c / total * target_units))
            for s, c in enumerate(counts)}


def proportional_plan(counts, budget: int) -> dict:
    """Largest-remainder apportionment of exactly ``budget`` replicas
    over shards, proportional to ``counts`` with a floor of one replica
    each — the exact-sum planner the global-budget rebalancer needs
    (``demand_plan``'s rounding may over- or under-shoot its target)."""
    n = len(counts)
    budget = max(int(budget), n)
    total = float(sum(counts)) or 1.0
    free = budget - n                       # replicas beyond the floor
    quotas = [c / total * free for c in counts]
    plan = [1 + int(q) for q in quotas]
    leftover = budget - sum(plan)
    by_remainder = sorted(range(n),
                          key=lambda s: (-(quotas[s] - int(quotas[s])), s))
    for s in by_remainder[:leftover]:
        plan[s] += 1
    return {s: plan[s] for s in range(n)}


def live_demand_plan(stats: dict, budget: int, *,
                     prior: dict | None = None) -> dict:
    """Online demand plan from the fleet's own serving histogram: the
    per-shard ``served`` counters out of :meth:`FleetRouter.stats`
    (minus ``prior``, an earlier snapshot, to plan on a recent window
    instead of all-time traffic), apportioned over ``budget`` replicas.
    This replaces the static trace walk once the fleet is live — traffic
    is whatever actually arrived, not what a trace predicted."""
    def hist(st):
        return {p["shard"]: p["served"] for p in st.get("per_shard", [])}
    now = hist(stats)
    base = hist(prior) if prior else {}
    counts = [max(now[s] - base.get(s, 0), 0) for s in sorted(now)]
    return proportional_plan(counts, budget)

_STOP = object()

# request classes, highest priority first; fractions are the share of a
# replica's queue depth each class may fill before it sheds
CLASS_PRIORITY = {"interactive": 0, "batch": 1, "best_effort": 2}
DEFAULT_CLASS_FRACS = {"interactive": 1.0, "batch": 0.75, "best_effort": 0.5}


class ShedRejected(RouterRejected):
    """Admission control shed this request (class over its queue share);
    carries the class so clients can back off per-class."""

    def __init__(self, msg: str, cls: str):
        super().__init__(msg)
        self.cls = cls


class _FleetRequest(_Request):
    __slots__ = ("cls",)

    def __init__(self, query, t_enq, deadline=None, cls="interactive"):
        super().__init__(query, t_enq, deadline)
        self.cls = cls


class _SwapCmd:
    """In-queue swap marker: requests enqueued before it serve the old
    model, requests after it the new one — per-replica ordering is the
    queue's."""
    __slots__ = ("backend", "version", "event")

    def __init__(self, backend, version):
        self.backend = backend
        self.version = version
        self.event = threading.Event()


class Replica:
    """One serving unit: a transport to a shard worker, a bounded
    admission queue, and a dispatcher thread draining micro-batches."""

    def __init__(self, shard: int, rid: int, transport, *,
                 queue_depth: int, batch_max: int, window_s: float,
                 call_timeout_s: float | None, version,
                 on_crash, on_exit):
        self.shard = shard
        self.rid = rid
        self.transport = transport
        self.queue: queue_mod.Queue = queue_mod.Queue(maxsize=queue_depth)
        self.batch_max = batch_max
        self.window_s = window_s
        self.call_timeout_s = call_timeout_s
        self.version = version               # last acked model version
        self._on_crash = on_crash
        self._on_exit = on_exit
        self.dead = False
        self.draining = False                # scale-in: no new admissions
        self.retired = False                 # counters folded into group
        self._crash_after = None
        # counters (management-side; hits/misses mirror the worker's)
        self.served = 0
        self.abstained = 0
        self.expired = 0
        self.rejected = 0
        self.shed_class: dict[str, int] = {}
        self.shed_deadline = 0
        self.batches = 0
        self.max_batch = 0
        self.queue_high_water = 0
        self.window_hw = 0                   # per-autoscaler-tick window
        self.ema_s = 0.0                     # per-request service time EMA
        self.counters = {"hits": 0, "misses": 0, "invalidations": 0,
                         "hit_rate": 0.0}
        self.thread = threading.Thread(
            target=self._run, name=f"fleet-s{shard}r{rid}", daemon=True)

    # ------------------------------------------------------------- worker
    def note_qsize(self) -> None:
        n = self.queue.qsize()
        self.queue_high_water = max(self.queue_high_water, n)
        self.window_hw = max(self.window_hw, n)

    def take_window_hw(self) -> int:
        hw, self.window_hw = self.window_hw, self.queue.qsize()
        return hw

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
        try:
            self._run_inner()
        except Exception:
            # backstop: a dispatcher must never die leaving its queue
            # stranded — treat any escaped exception as a replica crash
            # so every queued request is re-routed or failed loudly
            if not self.dead:
                self.dead = True
                self._on_crash(self, self._drain_rest())

    def _run_inner(self):
        stop = False
        while not stop:
            item = self.queue.get()
            pending_cmd = None
            if item is _STOP:
                batch, stop = self._drain_rest(), True
            elif isinstance(item, _SwapCmd):
                batch, pending_cmd = [], item
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
                    if isinstance(nxt, _SwapCmd):
                        pending_cmd = nxt     # applied after this batch
                        break
                    batch.append(nxt)
            if batch and not stop and self._crash_after is not None:
                if self._crash_after <= 0:
                    self._crash(batch, pending_cmd)
                    return
                self._crash_after -= 1
            if batch and not self._serve(batch):
                if pending_cmd is not None:
                    batch.append(pending_cmd)   # re-orphan with the rest
                return                          # crashed mid-serve
            if pending_cmd is not None and not self._apply_swap(pending_cmd):
                return
        # graceful exit: hand the queue's leftovers (racing late enqueues
        # and swap cmds) back, close the worker, retire the counters
        leftovers = self._drain_rest()
        self.transport.close()
        self._on_exit(self, leftovers)

    def _crash(self, batch, pending_cmd):
        """Injected crash: kill the worker *holding* an unserved batch."""
        try:
            self.transport.call({"op": "crash"},
                                timeout=self.call_timeout_s)
        except TransportDead:
            pass
        self.dead = True
        orphans = batch + self._drain_rest()
        if pending_cmd is not None:
            orphans.append(pending_cmd)
        self._on_crash(self, orphans)

    def _apply_swap(self, cmd: _SwapCmd) -> bool:
        try:
            reply = self.transport.call(
                {"op": "swap", "backend": cmd.backend},
                timeout=self.call_timeout_s)
        except TransportDead:
            self.dead = True
            self._on_crash(self, [cmd] + self._drain_rest())
            return False
        except Exception:
            # swap payload failed in transit (e.g. unpicklable model):
            # this replica's worker may be at the old version, so it must
            # not serve past the barrier — retire it and let the respawn
            # carry the target model object directly
            self.dead = True
            try:
                self.transport.kill()
            except Exception:
                pass
            self._on_crash(self, [cmd] + self._drain_rest())
            return False
        if reply.get("ok"):
            self.version = reply.get("version", cmd.version)
        self.counters = {k: reply[k] for k in
                         ("hits", "misses", "invalidations", "hit_rate")
                         if k in reply} or self.counters
        cmd.event.set()
        return True

    def _expire(self, batch: list) -> list:
        now = time.monotonic()
        live = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                self.expired += 1
                req.error = DeadlineExceeded(
                    f"deadline passed {now - req.deadline:.4f}s before "
                    f"shard {self.shard} replica {self.rid} served it")
                req.event.set()
            else:
                live.append(req)
        return live

    def _serve(self, batch: list) -> bool:
        """Serve one micro-batch through the worker; False iff the worker
        died mid-call (the batch is handed to the crash path)."""
        batch = self._expire(batch)
        if not batch:
            return True
        t0 = time.monotonic()
        try:
            reply = self.transport.call(
                {"op": "predict", "queries": [r.query for r in batch]},
                timeout=self.call_timeout_s)
        except TransportDead:
            self.dead = True
            self._on_crash(self, batch + self._drain_rest())
            return False
        except Exception as e:
            # the call failed without killing the worker (codec error,
            # malformed query): fail this batch loudly, keep serving
            for req in batch:
                req.error = e
                req.event.set()
            return True
        t_done = time.monotonic()
        if reply.get("ok"):
            version = reply.get("version")
            for req, (value, chosen_by) in zip(batch, reply["results"]):
                if isinstance(value, list):
                    value = tuple(value)
                req.result = ServeResult(value, self.shard, version,
                                         chosen_by, req.t_enq, t_done)
            self.abstained += sum(
                1 for _, by in reply["results"] if by == "default")
            self.counters = {k: reply[k] for k in
                             ("hits", "misses", "invalidations", "hit_rate")
                             if k in reply} or self.counters
        else:
            err = RuntimeError(reply.get("error", "worker error"))
            for req in batch:
                req.error = err
        self.served += len(batch)
        self.batches += 1
        self.max_batch = max(self.max_batch, len(batch))
        per_req = (t_done - t0) / max(len(batch), 1)
        self.ema_s = per_req if self.ema_s == 0.0 else \
            0.8 * self.ema_s + 0.2 * per_req
        for req in batch:
            req.event.set()
        return True


_SUM_KEYS = ("served", "abstained", "expired", "rejected", "shed",
             "shed_deadline", "batches", "hits", "misses", "invalidations")
_MAX_KEYS = ("max_batch", "queue_high_water")


class ShardGroup:
    """Replica group for one logical shard: read-any across members,
    write-all on swaps, retired-counter bookkeeping so totals stay
    monotonic across crashes and scale-ins."""

    def __init__(self, shard: int):
        self.shard = shard
        self.lock = threading.Lock()
        self.replicas: list[Replica] = []
        self._rr = 0
        self.retired = {k: 0 for k in _SUM_KEYS + _MAX_KEYS}

    def add(self, replica: Replica) -> None:
        with self.lock:
            self.replicas.append(replica)

    def remove(self, replica: Replica) -> None:
        with self.lock:
            if replica in self.replicas:
                self.replicas.remove(replica)

    def pick(self, barrier) -> Replica:
        """Read-any selection: least-loaded live replica at or beyond the
        read barrier (ties broken round-robin).  Mid-rolling-swap the
        barrier is still the old version, so both swapped and unswapped
        replicas are eligible — the barrier only advances once all acked.
        """
        with self.lock:
            live = [r for r in self.replicas
                    if not r.dead and not r.draining]
            if not live:
                live = [r for r in self.replicas if not r.dead]
            if not live:
                raise RouterClosed(f"shard {self.shard} has no replicas")
            eligible = [r for r in live
                        if barrier is None or r.version is None
                        or r.version >= barrier]
            if eligible:
                live = eligible
            self._rr += 1
            # snapshot sizes once: dispatchers drain queues without this
            # lock, so a second qsize() pass could match no replica
            sizes = [(r.queue.qsize(), r) for r in live]
            qmin = min(s for s, _ in sizes)
            cands = [r for s, r in sizes if s == qmin]
            return cands[self._rr % len(cands)]

    def retire(self, replica: Replica) -> None:
        """Fold a dead/drained replica's counters into the group totals
        (exactly once), so ``stats()`` never double- or under-counts
        across a respawn."""
        with self.lock:
            if replica.retired:
                return
            replica.retired = True
            r = self.retired
            for k in ("served", "abstained", "expired", "rejected",
                      "batches"):
                r[k] += getattr(replica, k)
            r["shed"] += sum(replica.shed_class.values())
            r["shed_deadline"] += replica.shed_deadline
            for k in ("hits", "misses", "invalidations"):
                r[k] += replica.counters.get(k, 0)
            for k in _MAX_KEYS:
                r[k] = max(r[k], getattr(replica, k))


class FleetRouter:
    """Management layer over a fleet of shard worker replicas.

    Drop-in for :class:`~repro_torch.serve.router.ShardRouter` on the serving
    API (``request`` / ``predict`` / ``predict_batch`` / ``swap`` /
    ``refit`` / ``stats`` / ``swap_log`` / ``close``), plus the fleet
    knobs: ``transport`` (``"loopback"`` threads, ``"process"``
    workers, or ``"socket"`` TCP workers — local or cross-host),
    ``worker_addrs`` (socket mode: ``"host:port"`` workers to attach to
    before spawning locally), ``replicas`` (int, or ``{shard: n}`` to
    replicate hot shards), ``weights`` (ring capacity weighting),
    request classes and deadline shedding, and an optional autoscaler
    (with global-budget rebalancing, see :class:`AutoscalePolicy`).

    Control plane (DESIGN.md §15): ``transport`` may be a
    :class:`~repro_torch.serve.transport.TransportSpec` (kind, addresses, auth
    key, timeouts, registry in one validated object); ``registry`` turns
    on worker discovery (:meth:`poll_registry` adopts newly announced
    workers, no flag changes); ``heartbeat`` arms the
    :class:`HealthProber` so silently-dead workers are replaced before a
    caller notices; :meth:`checkpoint`/:meth:`restore` snapshot and
    resume the management layer over a live fleet.
    """

    supports_classes = True

    def __init__(self, backend, *, n_shards: int = 4, replicas=1,
                 transport: "str | TransportSpec" = "loopback",
                 service_factory=EstimatorService, maxsize: int = 4096,
                 queue_depth: int = 256, admission: str = "block",
                 batch_max: int = 32, window_s: float = 0.002,
                 vnodes: int = 32, weights=None, abstain_fallback=None,
                 class_fracs=None, call_timeout_s: float | None = 60.0,
                 autoscale: "AutoscalePolicy | bool | None" = None,
                 worker_addrs=None, transport_kw=None, registry=None,
                 heartbeat: "HeartbeatPolicy | bool | None" = None):
        if isinstance(transport, TransportSpec):
            # the validated spec is the one source of truth: kind,
            # addresses, auth key, timeouts, and discovery path
            spec = transport
            transport = spec.kind
            if worker_addrs is None:
                worker_addrs = list(spec.worker_addrs)
            kw = spec.transport_kw()
            kw.update(transport_kw or {})
            transport_kw = kw
            if call_timeout_s == 60.0:
                call_timeout_s = spec.call_timeout_s
            if registry is None:
                registry = spec.registry
        if admission not in ("block", "reject"):
            raise ValueError(f"admission must be block|reject, "
                             f"got {admission!r}")
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of "
                             f"{sorted(TRANSPORTS)}, got {transport!r}")
        if worker_addrs and transport != "socket":
            raise ValueError("worker_addrs requires transport='socket'")
        if registry is not None and transport != "socket":
            raise ValueError("registry discovery requires "
                             "transport='socket'")
        self._backend = backend
        self._addr_pool = list(worker_addrs or [])
        self._adopted = set(self._addr_pool)
        self._transport_kw = dict(transport_kw or {})
        if registry is not None and not isinstance(registry,
                                                   WorkerRegistry):
            registry = WorkerRegistry(registry)
        self.registry = registry
        self.admission = admission
        self.transport_kind = transport
        self.queue_depth = queue_depth
        self.class_fracs = dict(DEFAULT_CLASS_FRACS)
        self.class_fracs.update(class_fracs or {})
        self._service_factory = service_factory
        self._maxsize = maxsize
        self._abstain_fallback = abstain_fallback
        self._replica_kw = dict(queue_depth=queue_depth,
                                batch_max=batch_max, window_s=window_s,
                                call_timeout_s=call_timeout_s)
        self._vnodes = vnodes
        self._weights = list(weights) if weights is not None else None
        self._ring = HashRing(n_shards, vnodes, weights=weights)
        # local keyer: canonical memo keys for routing, never predictions
        self._keyer = service_factory(backend, 2)
        self._lock = threading.RLock()         # swap/membership lock
        self._closed = False
        self._next_rid = 0
        self._swap_target = None               # (backend, version) mid-swap
        version = getattr(backend, "model_version", 0) or 0
        self._read_barrier = version
        self.crashes = 0
        self.respawns = 0
        self.rerouted = 0
        self.scale_outs = 0
        self.scale_ins = 0
        self.migrations = 0
        self.heartbeats = 0
        self.heartbeat_replacements = 0
        self.adoptions = 0
        self.swap_log: list[tuple[float, int]] = [(time.monotonic(),
                                                   version)]
        if isinstance(replicas, int):
            plan = {s: replicas for s in range(n_shards)}
        else:
            plan = {s: int(replicas.get(s, 1)) for s in range(n_shards)}
        self.groups = [ShardGroup(s) for s in range(n_shards)]
        for s in range(n_shards):
            for _ in range(max(1, plan[s])):
                self.groups[s].add(self._spawn(s, backend, version))
        self.autoscaler = None
        if autoscale:
            policy = autoscale if isinstance(autoscale, AutoscalePolicy) \
                else AutoscalePolicy()
            self.autoscaler = Autoscaler(self, policy)
        self.prober = None
        if heartbeat:
            hb = heartbeat if isinstance(heartbeat, HeartbeatPolicy) \
                else HeartbeatPolicy()
            self.prober = HealthProber(self, hb)

    # ----------------------------------------------------------- identity
    @property
    def backend(self):
        return self._backend

    @property
    def estimator(self):
        return self._backend

    @property
    def n_shards(self) -> int:
        return len(self.groups)

    @property
    def n_replicas(self) -> int:
        return sum(len(g.replicas) for g in self.groups)

    def shard_for(self, query) -> int:
        return self._ring.shard_for(self._keyer._key(query))

    # ---------------------------------------------------------- replicas
    def _spawn(self, shard: int, backend, version,
               addr: str | None = None) -> Replica:
        kw = dict(self._transport_kw)
        if self.transport_kind == "socket":
            if addr is None and self._addr_pool:
                addr = self._addr_pool.pop(0)
            if addr is not None:
                kw["address"] = addr
        transport = TRANSPORTS[self.transport_kind](
            backend, service_factory=self._service_factory,
            maxsize=self._maxsize,
            abstain_fallback=self._abstain_fallback, **kw)
        self._next_rid += 1
        rep = Replica(shard, self._next_rid, transport, version=version,
                      on_crash=self._handle_crash,
                      on_exit=self._handle_exit, **self._replica_kw)
        rep.addr = addr                     # reattach target on respawn
        rep.thread.start()
        return rep

    def _current_target(self):
        """Backend/version a fresh replica must carry: the in-flight swap
        target when a rolling swap is underway, else the live backend —
        so a crash mid-swap can never respawn a replica older than the
        barrier the swap is about to publish."""
        if self._swap_target is not None:
            return self._swap_target
        return self._backend, self._read_barrier

    def _handle_crash(self, replica: Replica, orphans: list) -> None:
        """Runs on the dying replica's dispatcher thread: retire its
        counters, respawn a fresh replica at the current (or in-flight)
        model, and re-route every orphaned request inside the group —
        zero lost requests.  An attached socket replica respawns against
        the *same* address first (the remote worker re-enters accept
        after a dropped connection, so reattach restores its capacity);
        if the remote host is truly gone the respawn falls back to a
        locally spawned worker.

        The replacement joins the group before the dead replica leaves it:
        a request that finds no live replica meanwhile sees one that is
        dead but not retired, and waits for this respawn (:meth:`_pick`)
        instead of failing, so a one-replica shard loses no caller."""
        group = self.groups[replica.shard]
        with self._lock:
            # idempotent: the heartbeat prober and the dispatcher can both
            # reach this for the same replica — count and respawn once,
            # but always resolve whichever orphans each caller brought
            first = not replica.retired
            if first:
                self.crashes += 1
            if first and not self._closed:
                backend, version = self._current_target()
                addr = getattr(replica, "addr", None)
                try:
                    group.add(self._spawn(replica.shard, backend, version,
                                          addr=addr))
                    self.respawns += 1
                except Exception:
                    try:
                        if addr is not None:   # reattach failed: go local
                            # the address is dead capacity; un-adopt it so
                            # a worker re-announcing there is re-attached
                            self._adopted.discard(addr)
                            group.add(self._spawn(replica.shard, backend,
                                                  version))
                            self.respawns += 1
                    except Exception:
                        # respawn itself failed (e.g. worker init):
                        # survivors absorb the orphans below, or they
                        # fail loudly
                        pass
            group.retire(replica)
            group.remove(replica)
            orphans = orphans + replica._drain_rest()
        for item in orphans:
            if isinstance(item, _SwapCmd):
                # the respawn already carries the target model; remaining
                # replicas get their own cmds from the swap loop
                item.event.set()
            elif self._closed:
                item.error = RouterClosed("fleet closed during crash "
                                          "recovery")
                item.event.set()
            elif not self._try_reroute(group, item):
                item.error = RouterClosed(
                    f"shard {group.shard} lost all replicas during crash "
                    "recovery")
                item.event.set()

    def _handle_exit(self, replica: Replica, leftovers: list) -> None:
        """Graceful dispatcher exit (scale-in or close): retire counters
        and resolve anything that raced into the queue after the stop.
        A drained *attached* replica's worker address returns to the
        pool — the remote worker re-enters accept, so the next scale-out
        (e.g. a migration's attach side) can reuse that capacity."""
        with self._lock:
            group = self.groups[replica.shard]
            group.retire(replica)
            group.remove(replica)
            addr = getattr(replica, "addr", None)
            if addr is not None and not self._closed:
                self._addr_pool.append(addr)
        for item in leftovers:
            if isinstance(item, _SwapCmd):
                item.event.set()
            elif self._closed or not self._try_reroute(group, item):
                item.error = RouterClosed("replica drained before serving")
                item.event.set()

    def _try_reroute(self, group: ShardGroup, req) -> bool:
        try:
            self._reroute(group, req)
            return True
        except RouterClosed:
            return False

    def _pick(self, group: ShardGroup, barrier) -> Replica:
        """:meth:`ShardGroup.pick`, riding out a crash recovery in flight.
        A group whose replicas are all dead, one of them not yet retired,
        is between a worker's death and its respawn, which
        :meth:`_handle_crash` seats under the membership lock: wait for
        that lock and pick again.  ``RouterClosed`` only once the fleet is
        closed, the respawn failed, or the recovery outlasts the call
        timeout."""
        deadline = time.monotonic() + (self._replica_kw["call_timeout_s"] or 60.0)
        while True:
            try:
                return group.pick(barrier)
            except RouterClosed:
                with group.lock:
                    recovering = any(r.dead and not r.retired
                                     for r in group.replicas)
                if self._closed or not recovering \
                        or time.monotonic() > deadline:
                    raise
            with self._lock:
                pass
            time.sleep(0.0005)

    def _reroute(self, group: ShardGroup, req) -> None:
        target = self._pick(group, None)
        target.queue.put(req)
        target.note_qsize()
        self.rerouted += 1

    # ----------------------------------------------------- failure chaos
    def inject_crash(self, shard: int, replica: int = 0,
                     after_batches: int = 0) -> None:
        """Arm a deterministic worker death on one replica of ``shard``:
        the worker dies holding the batch it assembled, after serving
        ``after_batches`` more batches."""
        with self.groups[shard].lock:
            rep = self.groups[shard].replicas[replica]
        rep._crash_after = max(0, int(after_batches))

    def silent_kill(self, shard: int, replica: int = 0) -> None:
        """Chaos for the heartbeat path: the worker behind one replica
        dies with *nothing* in flight — no call errors, no EOF, the
        transport still believes it is alive.  Only a health probe (or
        the next unlucky caller) can notice."""
        with self.groups[shard].lock:
            rep = self.groups[shard].replicas[replica]
        rep.transport.silent_kill()

    def _replace_suspect(self, replica: Replica) -> bool:
        """Heartbeat verdict: ``replica``'s worker stopped answering
        pings — retire and respawn it through the ordinary crash path
        *now*, before any caller's request lands on the corpse and eats
        a :class:`TransportDead`.  Idempotent against the dispatcher
        discovering the same death mid-call."""
        with self._lock:
            if self._closed or replica.retired or replica.dead:
                return False
            replica.dead = True
        try:
            replica.transport.kill()
        except Exception:
            pass
        self._handle_crash(replica, replica._drain_rest())
        # the respawn (reattach or local) is seated; this replica's addr
        # must not go back to the pool when its dispatcher unparks below
        replica.addr = None
        replica.queue.put(_STOP)
        self.heartbeat_replacements += 1
        return True

    # --------------------------------------------------------- discovery
    def poll_registry(self, *, prior: dict | None = None,
                      now: float | None = None) -> list[str]:
        """Discover and adopt newly registered workers: every live lease
        whose address this fleet has not yet attached becomes one new
        replica (seated by :meth:`adopt_worker`).  Safe to call from a
        timer, the autoscaler, or a test — adoption is deduplicated, so
        a flapping worker that re-announces rejoins exactly once.
        Returns the addresses adopted this poll."""
        if self.registry is None:
            return []
        adopted = []
        for addr in self.registry.addresses(now):
            if addr in self._adopted:
                continue
            if self.adopt_worker(addr, prior=prior) is not None:
                adopted.append(addr)
        return adopted

    def adopt_worker(self, addr: str, *,
                     prior: dict | None = None) -> Replica | None:
        """Attach one registered worker at ``addr`` as a new replica on
        the shard the live demand plan says needs capacity most
        (:func:`live_demand_plan` over the served histogram, against a
        budget of one more replica than the fleet currently runs).
        ``prior`` — an earlier :meth:`stats` snapshot — windows the
        histogram.  No flag changes, no restart: discovery is the
        scale-out path."""
        with self._lock:
            if self._closed or addr in self._adopted:
                return None
            stats = self.stats()
            have = {p["shard"]: p["replicas"] for p in stats["per_shard"]}
            plan = live_demand_plan(stats, self.n_replicas + 1,
                                    prior=prior)
            shard = max(have, key=lambda s: (plan.get(s, 1) - have[s], -s))
            backend, version = self._current_target()
            try:
                rep = self._spawn(shard, backend, version, addr=addr)
            except Exception:
                return None          # not reachable (yet): retry next poll
            self.groups[shard].add(rep)
            self._adopted.add(addr)
            self.adoptions += 1
            self.scale_outs += 1
            return rep

    # ------------------------------------------------------------ serving
    def _submit(self, query, deadline_s=None, cls="interactive"):
        if self._closed:
            raise RouterClosed("fleet router is closed")
        if cls not in CLASS_PRIORITY:
            raise ValueError(f"unknown request class {cls!r}; expected "
                             f"one of {sorted(CLASS_PRIORITY)}")
        t_enq = time.monotonic()
        req = _FleetRequest(query, t_enq,
                            None if deadline_s is None
                            else t_enq + deadline_s, cls)
        group = self.groups[self.shard_for(query)]
        rep = self._pick(group, self._read_barrier)
        qsize = rep.queue.qsize()
        # ---- early deadline drop: the queue's service-time EMA says this
        # request would expire before being served — drop it *before* it
        # consumes a queue slot
        if deadline_s is not None and rep.ema_s > 0.0 and \
                qsize * rep.ema_s / max(rep.batch_max, 1) > deadline_s:
            rep.shed_deadline += 1
            raise DeadlineExceeded(
                f"queue wait ≈{qsize * rep.ema_s / rep.batch_max:.4f}s "
                f"exceeds deadline {deadline_s}s; dropped before enqueue")
        # ---- per-class admission: each class may only fill its share of
        # the queue, so background traffic sheds before interactive does
        limit = max(1, int(self.queue_depth
                           * self.class_fracs.get(cls, 1.0)))
        prio = CLASS_PRIORITY[cls]
        if qsize >= limit and (self.admission == "reject" or prio > 0):
            rep.shed_class[cls] = rep.shed_class.get(cls, 0) + 1
            rep.rejected += 1
            raise ShedRejected(
                f"shard {rep.shard} replica {rep.rid} queue at {qsize} "
                f">= class {cls!r} limit {limit}", cls)
        try:
            if self.admission == "reject":
                rep.queue.put_nowait(req)
            else:
                rep.queue.put(req)
        except queue_mod.Full:
            rep.rejected += 1
            rep.shed_class[cls] = rep.shed_class.get(cls, 0) + 1
            raise ShedRejected(
                f"shard {rep.shard} replica {rep.rid} admission queue "
                f"full (depth {rep.queue.maxsize})", cls) from None
        if rep.dead:
            # raced a crash: rescue anything stranded on the dead queue
            for straggler in rep._drain_rest():
                if isinstance(straggler, _SwapCmd):
                    straggler.event.set()
                else:
                    self._reroute(group, straggler)
        if self._closed and not rep.thread.is_alive():
            for straggler in rep._drain_rest():
                straggler.error = RouterClosed("fleet closed")
                straggler.event.set()
        rep.note_qsize()
        return req

    @staticmethod
    def _await(req, timeout):
        if not req.event.wait(timeout):
            raise TimeoutError(f"no answer within {timeout}s")
        if req.error is not None:
            raise req.error
        return req.result

    def request(self, query, timeout: float | None = None,
                deadline_s: float | None = None,
                cls: str = "interactive") -> ServeResult:
        return self._await(self._submit(query, deadline_s, cls), timeout)

    def predict(self, query, timeout: float | None = None,
                deadline_s: float | None = None, cls: str = "interactive"):
        return self.request(query, timeout, deadline_s, cls).value

    def predict_batch(self, queries, timeout: float | None = None,
                      deadline_s: float | None = None,
                      cls: str = "interactive") -> list:
        reqs = [self._submit(q, deadline_s, cls) for q in queries]
        return [self._await(r, timeout).value for r in reqs]

    # ----------------------------------------------------- refit / swap
    def swap(self, new_backend) -> int:
        """Write-all rolling swap: push the new model to every replica,
        one at a time, waiting for each ack while the rest of the group
        keeps serving (zero downtime).  The read barrier advances only
        after the last ack, so any request admitted after this returns
        is routed to — and served by — a replica at the new version."""
        with self._lock:
            version = getattr(new_backend, "model_version", 0) or 0
            self._swap_target = (new_backend, version)
            try:
                for group in self.groups:
                    with group.lock:
                        members = list(group.replicas)
                    for rep in members:
                        if rep.dead or rep.retired:
                            continue
                        cmd = _SwapCmd(new_backend, version)
                        rep.queue.put(cmd)
                        while not cmd.event.wait(0.05):
                            if rep.dead or not rep.thread.is_alive():
                                break           # respawn carries the target
                self._backend = new_backend
                self._read_barrier = version
            finally:
                self._swap_target = None
            self.swap_log.append((time.monotonic(), version))
            return version

    def refit(self, new_records) -> bool:
        """Snapshot → fold off the request path → rolling swap; True iff
        a new model was swapped in (same contract as ShardRouter)."""
        with self._lock:
            snap = self._backend.snapshot()
            if not fold_records(snap, new_records):
                return False
            self.swap(snap)
            return True

    # ---------------------------------------------------------- scaling
    def scale_out(self, shard: int) -> Replica | None:
        """Add one replica to ``shard`` at the current model (read-any
        picks it up immediately)."""
        with self._lock:
            if self._closed:
                return None
            backend, version = self._current_target()
            rep = self._spawn(shard, backend, version)
            self.groups[shard].add(rep)
            self.scale_outs += 1
            return rep

    def scale_in(self, shard: int) -> Replica | None:
        """Gracefully remove one replica from ``shard``: it stops taking
        new requests, drains its queue, then exits (counters retired).
        Never drops below one replica."""
        with self._lock:
            group = self.groups[shard]
            with group.lock:
                live = [r for r in group.replicas
                        if not r.dead and not r.draining]
                if len(live) <= 1:
                    return None
                rep = min(live, key=lambda r: r.queue.qsize())
                rep.draining = True
            rep.queue.put(_STOP)
            self.scale_ins += 1
            return rep

    def migrate(self, from_shard: int, to_shard: int):
        """Move one unit of serving capacity between shards under a
        fixed global budget: drain a replica out of ``from_shard``
        (graceful scale-in — it finishes its queue, then detaches) and
        attach a fresh one to ``to_shard``.  The attach side spawns at
        :meth:`_current_target`, so a migration racing a rolling swap
        can never seat a replica behind the version barrier.  Total
        replica count is conserved (momentarily +1 while the drained
        replica empties its queue).  Returns ``(drained, added)`` or
        ``None`` when nothing moved (same shard, donor at its one-replica
        floor, or the fleet is closing)."""
        with self._lock:
            if self._closed or from_shard == to_shard:
                return None
            drained = self.scale_in(from_shard)
            if drained is None:
                return None
            added = self.scale_out(to_shard)
            if added is None:
                return None
            self.migrations += 1
            return drained, added

    # ------------------------------------------------ failover snapshot
    def checkpoint(self, path) -> dict:
        """Atomically snapshot the control-plane state — ring geometry,
        live replica plan, attached worker addresses, swap-barrier
        version and swap log, counters, autoscaler hysteresis — to
        ``path`` (tmp + ``os.replace``, the RefitDaemon cursor
        discipline, so a crash mid-write leaves the previous checkpoint
        intact).  Workers are *not* in the snapshot: they live behind
        the registry, which is exactly why a replacement router can
        :meth:`restore` onto the same fleet."""
        with self._lock:
            state = {
                "schema": 1, "kind": "fleet-checkpoint",
                "n_shards": self.n_shards,
                "vnodes": self._vnodes,
                "weights": self._weights,
                "transport": self.transport_kind,
                "admission": self.admission,
                "queue_depth": self.queue_depth,
                "batch_max": self._replica_kw["batch_max"],
                "window_s": self._replica_kw["window_s"],
                "call_timeout_s": self._replica_kw["call_timeout_s"],
                "class_fracs": self.class_fracs,
                "read_barrier": self._read_barrier,
                "swap_log": [[t, v] for t, v in self.swap_log],
                "replica_plan": {
                    str(g.shard): max(1, len([r for r in g.replicas
                                              if not r.retired]))
                    for g in self.groups},
                "replica_addrs": {
                    str(g.shard): [r.addr for r in g.replicas
                                   if not r.retired
                                   and getattr(r, "addr", None)]
                    for g in self.groups},
                "addr_pool": list(self._addr_pool),
                "registry": str(self.registry.path)
                if self.registry is not None else None,
                "counters": {k: getattr(self, k) for k in (
                    "crashes", "respawns", "rerouted", "scale_outs",
                    "scale_ins", "migrations", "heartbeats",
                    "heartbeat_replacements", "adoptions")},
                "autoscaler": None if self.autoscaler is None else {
                    "ticks": self.autoscaler.ticks,
                    "hot": {str(k): v for k, v
                            in self.autoscaler._hot.items()},
                    "cold": {str(k): v for k, v
                             in self.autoscaler._cold.items()},
                    "cooldown": {str(k): v for k, v
                                 in self.autoscaler._cooldown.items()},
                    "last_hist": {str(k): v for k, v
                                  in self.autoscaler._last_hist.items()},
                },
            }
        path = Path(path)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps(state, indent=1))
        os.replace(tmp, path)
        return state

    @classmethod
    def restore(cls, path, backend, *, service_factory=EstimatorService,
                maxsize: int = 4096, abstain_fallback=None,
                transport_kw=None, registry=None, autoscale=None,
                heartbeat=None) -> "FleetRouter":
        """Stand up a replacement router from a :meth:`checkpoint`: same
        ring geometry and replica plan, reattached to the checkpointed
        worker addresses (and any live registry leases — pass
        ``registry`` to override the checkpointed path), counters and
        swap log carried over.  ``backend`` must be at or beyond the
        checkpointed read barrier — restoring an older model would break
        the staleness contract every admitted request relies on, so that
        is a ``ValueError``, not a silent downgrade."""
        state = json.loads(Path(path).read_text())
        if state.get("kind") != "fleet-checkpoint":
            raise ValueError(f"{path} is not a fleet checkpoint")
        barrier = state["read_barrier"]
        have_v = getattr(backend, "model_version", 0) or 0
        if barrier is not None and have_v < barrier:
            raise ValueError(
                f"backend model_version {have_v} is behind the "
                f"checkpointed read barrier {barrier}: restoring would "
                "serve answers older than requests already admitted "
                "were promised")
        plan = {int(s): n for s, n in state["replica_plan"].items()}
        addrs = [a for s in sorted(state["replica_addrs"],
                                   key=int)
                 for a in state["replica_addrs"][s]]
        addrs += [a for a in state.get("addr_pool", [])
                  if a not in addrs]
        if registry is None and state.get("registry"):
            registry = state["registry"]
        fleet = cls(backend, n_shards=state["n_shards"],
                    replicas=plan, transport=state["transport"],
                    service_factory=service_factory, maxsize=maxsize,
                    queue_depth=state["queue_depth"],
                    admission=state["admission"],
                    batch_max=state["batch_max"],
                    window_s=state["window_s"],
                    vnodes=state["vnodes"], weights=state["weights"],
                    abstain_fallback=abstain_fallback,
                    class_fracs=state["class_fracs"],
                    call_timeout_s=state["call_timeout_s"],
                    autoscale=autoscale,
                    worker_addrs=addrs or None,
                    transport_kw=transport_kw, registry=registry,
                    heartbeat=heartbeat)
        with fleet._lock:
            # counters and swap history continue, so observability (and
            # the regression gate) sees one fleet, not two
            for k, v in state.get("counters", {}).items():
                if hasattr(fleet, k):
                    setattr(fleet, k, v)
            fleet.swap_log = [tuple(e) for e in state["swap_log"]]
            fleet.swap_log.append((time.monotonic(),
                                   fleet._read_barrier))
            auto = state.get("autoscaler")
            if fleet.autoscaler is not None and auto:
                fleet.autoscaler.ticks = auto.get("ticks", 0)
                for name in ("hot", "cold", "cooldown", "last_hist"):
                    setattr(fleet.autoscaler, "_" + name,
                            {int(k): v
                             for k, v in auto.get(name, {}).items()})
        if fleet.registry is not None:
            fleet.poll_registry()     # leases announced since checkpoint
        return fleet

    # -------------------------------------------------- observability
    def stats(self) -> dict:
        """Consistent fleet snapshot under the membership lock: per
        logical shard (live replicas + retired totals, so counters are
        monotonic across crash respawns and scale-ins), plus the flat
        per-replica view the load-balance audit reads."""
        with self._lock:
            per_shard, per_replica = [], []
            for group in self.groups:
                with group.lock:
                    reps = list(group.replicas)
                    agg = dict(group.retired)
                for rep in reps:
                    if rep.retired:
                        continue
                    row = {"shard": rep.shard, "replica": rep.rid,
                           "served": rep.served,
                           "abstained": rep.abstained,
                           "expired": rep.expired,
                           "rejected": rep.rejected,
                           "shed": sum(rep.shed_class.values()),
                           "shed_deadline": rep.shed_deadline,
                           "batches": rep.batches,
                           "max_batch": rep.max_batch,
                           "queue_high_water": rep.queue_high_water,
                           "hits": rep.counters.get("hits", 0),
                           "misses": rep.counters.get("misses", 0),
                           "invalidations":
                               rep.counters.get("invalidations", 0),
                           "version": rep.version,
                           "alive": rep.thread.is_alive()
                           and not rep.dead}
                    per_replica.append(row)
                    for k in _SUM_KEYS:
                        agg[k] += row.get(k, 0)
                    for k in _MAX_KEYS:
                        agg[k] = max(agg[k], row[k])
                hm = agg["hits"] + agg["misses"]
                per_shard.append({
                    "shard": group.shard, "served": agg["served"],
                    "abstained": agg["abstained"],
                    "hits": agg["hits"], "misses": agg["misses"],
                    "hit_rate": agg["hits"] / hm if hm else 0.0,
                    "invalidations": agg["invalidations"],
                    "batches": agg["batches"],
                    "max_batch": agg["max_batch"],
                    "queue_high_water": agg["queue_high_water"],
                    "rejected": agg["rejected"],
                    "shed": agg["shed"],
                    "shed_deadline": agg["shed_deadline"],
                    "expired": agg["expired"],
                    "replicas": len([r for r in reps if not r.retired])})
            hits = sum(p["hits"] for p in per_shard)
            misses = sum(p["misses"] for p in per_shard)
            served = [p["served"] for p in per_replica] or [0]
            mean = sum(served) / len(served)
            return normalize_stats({
                "n_shards": len(self.groups),
                "n_replicas": sum(p["replicas"] for p in per_shard),
                "transport": self.transport_kind,
                "served": sum(p["served"] for p in per_shard),
                "abstained": sum(p["abstained"] for p in per_shard),
                "rejected": sum(p["rejected"] for p in per_shard),
                "shed": sum(p["shed"] for p in per_shard),
                "shed_deadline": sum(p["shed_deadline"]
                                     for p in per_shard),
                "expired": sum(p["expired"] for p in per_shard),
                "hits": hits, "misses": misses,
                "hit_rate": hits / (hits + misses)
                if hits + misses else 0.0,
                "invalidations": sum(p["invalidations"]
                                     for p in per_shard),
                "model_version": getattr(self._backend, "model_version",
                                         None),
                "read_barrier": self._read_barrier,
                "swaps": len(self.swap_log) - 1,
                "crashes": self.crashes, "respawns": self.respawns,
                "rerouted": self.rerouted,
                "scale_outs": self.scale_outs,
                "scale_ins": self.scale_ins,
                "migrations": self.migrations,
                "heartbeats": self.heartbeats,
                "heartbeat_replacements": self.heartbeat_replacements,
                "adoptions": self.adoptions,
                "queued": sum(r.queue.qsize() for g in self.groups
                              for r in g.replicas),
                "served_skew": (max(served) / mean) if mean else 0.0,
                "per_shard": per_shard,
                "per_replica": per_replica,
            })

    @property
    def pending(self) -> int:
        return sum(r.queue.qsize()
                   for g in self.groups for r in g.replicas)

    # ------------------------------------------------------------ shutdown
    def close(self, drain: bool = True, timeout: float = 10.0) -> None:
        if self._closed:
            return
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.prober is not None:
            self.prober.stop()
        self._closed = True
        with self._lock:
            reps = [r for g in self.groups for r in list(g.replicas)]
        for rep in reps:
            if not drain:
                for item in rep._drain_rest():
                    if isinstance(item, _SwapCmd):
                        item.event.set()
                    else:
                        item.error = RouterClosed("fleet closed before "
                                                  "serving")
                        item.event.set()
            rep.queue.put(_STOP)
        for rep in reps:
            rep.thread.join(timeout)
        for rep in reps:                      # stragglers that raced close
            for item in rep._drain_rest():
                if isinstance(item, _SwapCmd):
                    item.event.set()
                else:
                    item.error = RouterClosed("fleet closed before "
                                              "serving")
                    item.event.set()
            rep.transport.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# --------------------------------------------------------------- heartbeat
class HeartbeatPolicy:
    """Knobs for the router-side health prober.  A replica is *suspect*
    after ``miss_after`` consecutive failed pings (each bounded by
    ``timeout_s``) and is then replaced through the crash path.  Probes
    share the transport's call lock with real traffic, so a ping can
    only run *between* calls — a ping timeout means the worker is
    genuinely hung or dead, not merely busy with our own batch."""

    def __init__(self, *, interval_s: float = 0.25,
                 timeout_s: float = 1.0, miss_after: int = 2):
        if miss_after < 1:
            raise ValueError("miss_after must be >= 1")
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.miss_after = miss_after


class HealthProber:
    """Active liveness for the fleet: ping every replica's worker on a
    cadence and replace the ones that stop answering *before* a caller's
    request lands on them and eats a :class:`TransportDead`.  Passive
    detection only notices a death on the next unlucky call;
    this closes the window for silently-dead workers — OOM-killed
    processes, severed connections, partitioned hosts — that are idle at
    the time they die.

    :meth:`probe_once` is the whole policy as a plain call (what
    deterministic tests and the bench drive); :meth:`start` runs it on a
    thread, mirroring :class:`Autoscaler`."""

    def __init__(self, fleet: FleetRouter,
                 policy: HeartbeatPolicy | None = None):
        self.fleet = fleet
        self.policy = policy or HeartbeatPolicy()
        self.probes = 0
        self.replaced = 0
        self.misses: dict[int, int] = {}     # rid -> consecutive misses
        self._stop = threading.Event()
        self._thread = None

    def probe_once(self) -> list[tuple[int, int]]:
        """One probe pass over every live replica; returns the
        ``(shard, rid)`` pairs replaced this pass."""
        pol = self.policy
        replaced = []
        for group in self.fleet.groups:
            with group.lock:
                reps = [r for r in group.replicas
                        if not r.retired and not r.draining and not r.dead]
            for rep in reps:
                ok = False
                try:
                    reply = rep.transport.call({"op": "ping"},
                                               timeout=pol.timeout_s)
                    ok = bool(reply.get("ok"))
                except Exception:        # TransportDead, auth, timeout…
                    ok = False
                self.probes += 1
                self.fleet.heartbeats += 1
                if ok:
                    self.misses.pop(rep.rid, None)
                    continue
                n = self.misses.get(rep.rid, 0) + 1
                self.misses[rep.rid] = n
                if n >= pol.miss_after:
                    self.misses.pop(rep.rid, None)
                    if self.fleet._replace_suspect(rep):
                        self.replaced += 1
                        replaced.append((rep.shard, rep.rid))
        return replaced

    def _run(self):
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception:                # pragma: no cover - defensive
                pass
            self._stop.wait(self.policy.interval_s)

    def start(self) -> "HealthProber":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="fleet-heartbeat",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout)


# -------------------------------------------------------------- autoscaler
class AutoscalePolicy:
    """Hysteresis knobs for the autoscaler.  Pressure is a group's
    per-tick queue high-water over its depth; a group must stay hot
    (``pressure >= hi``) for ``up_after`` consecutive ticks to gain a
    replica and idle (``pressure <= lo`` with empty queues) for
    ``down_after`` ticks to lose one, with ``cooldown`` ticks of
    quiescence after any action — so noisy load cannot flap replicas.

    The rebalancing knobs turn on global-budget migration: every
    ``rebalance_every`` ticks the autoscaler re-plans replica counts
    from the *live* served histogram (:func:`live_demand_plan` over the
    window since the last re-plan, ignored below
    ``rebalance_min_window`` requests) and moves up to
    ``moves_per_rebalance`` replicas from over-provisioned shards to
    under-provisioned ones — so when the hot spot shifts, capacity
    follows it instead of only growing.  ``budget`` is the global
    replica count the plan apportions (default: the fleet's current
    total, i.e. pure rebalancing, no growth)."""

    def __init__(self, *, hi: float = 0.5, lo: float = 0.05,
                 up_after: int = 2, down_after: int = 4,
                 cooldown: int = 2, min_replicas: int = 1,
                 max_replicas: int = 4, max_total: int | None = None,
                 budget: int | None = None, rebalance_every: int = 0,
                 moves_per_rebalance: int = 1,
                 rebalance_min_window: int = 32):
        self.hi = hi
        self.lo = lo
        self.up_after = up_after
        self.down_after = down_after
        self.cooldown = cooldown
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.max_total = max_total
        self.budget = budget
        self.rebalance_every = rebalance_every
        self.moves_per_rebalance = moves_per_rebalance
        self.rebalance_min_window = rebalance_min_window


class Autoscaler:
    """Drive replica counts from the stats the fleet already keeps:
    sustained queue pressure scales a shard out, sustained idleness
    scales it back in.  ``tick()`` is the whole policy as a plain call
    (what deterministic tests drive); ``start()`` runs it on a thread."""

    def __init__(self, fleet: FleetRouter, policy: AutoscalePolicy
                 | None = None, interval_s: float = 0.05):
        self.fleet = fleet
        self.policy = policy or AutoscalePolicy()
        self.interval_s = interval_s
        self.ticks = 0
        self.events: list[tuple] = []   # (tick, "out"|"in"|"move", ...)
        self._hot = {}
        self._cold = {}
        self._cooldown = {}
        self._last_hist: dict[int, int] = {}
        self._stop = threading.Event()
        self._thread = None

    def tick(self) -> list[tuple]:
        """One observe-decide-act cycle; returns the actions taken."""
        self.ticks += 1
        pol = self.policy
        actions = []
        for group in self.fleet.groups:
            s = group.shard
            with group.lock:
                reps = [r for r in group.replicas
                        if not r.dead and not r.draining]
            if not reps:
                continue
            depth = self.fleet.queue_depth
            pressure = max(r.take_window_hw() / depth for r in reps)
            busy = any(r.queue.qsize() > 0 for r in reps)
            if self._cooldown.get(s, 0) > 0:
                self._cooldown[s] -= 1
                continue
            if pressure >= pol.hi:
                self._hot[s] = self._hot.get(s, 0) + 1
                self._cold[s] = 0
            elif pressure <= pol.lo and not busy:
                self._cold[s] = self._cold.get(s, 0) + 1
                self._hot[s] = 0
            else:
                self._hot[s] = self._cold[s] = 0
            total = self.fleet.n_replicas
            if (self._hot.get(s, 0) >= pol.up_after
                    and len(reps) < pol.max_replicas
                    and (pol.max_total is None or total < pol.max_total)):
                if self.fleet.scale_out(s) is not None:
                    actions.append((self.ticks, "out", s))
                    self._hot[s] = 0
                    self._cooldown[s] = pol.cooldown
            elif (self._cold.get(s, 0) >= pol.down_after
                    and len(reps) > pol.min_replicas):
                if self.fleet.scale_in(s) is not None:
                    actions.append((self.ticks, "in", s))
                    self._cold[s] = 0
                    self._cooldown[s] = pol.cooldown
        if pol.rebalance_every and self.ticks % pol.rebalance_every == 0:
            actions.extend(self.rebalance())
        self.events.extend(actions)
        return actions

    def rebalance(self) -> list[tuple]:
        """Move replicas from over- to under-provisioned shards.

        Re-plans replica counts from the served histogram accumulated
        since the previous rebalance (:func:`live_demand_plan`) against
        the global ``policy.budget`` (default: the fleet's current
        total, i.e. capacity is conserved), then performs up to
        ``policy.moves_per_rebalance`` :meth:`FleetRouter.migrate`
        calls, always from the shard with the largest surplus to the
        shard with the largest deficit.  Windows smaller than
        ``policy.rebalance_min_window`` requests are skipped — no
        evidence, no moves."""
        pol = self.policy
        stats = self.fleet.stats()
        hist = {p["shard"]: p["served"] for p in stats["per_shard"]}
        window = sum(hist.values()) - sum(self._last_hist.values())
        if window < pol.rebalance_min_window:
            return []
        budget = pol.budget if pol.budget is not None else self.fleet.n_replicas
        plan = live_demand_plan(
            stats, budget,
            prior={"per_shard": [{"shard": s, "served": c}
                                 for s, c in self._last_hist.items()]})
        self._last_hist = hist
        have = {p["shard"]: p["replicas"] for p in stats["per_shard"]}
        actions = []
        for _ in range(max(pol.moves_per_rebalance, 0)):
            surplus = {s: have[s] - plan.get(s, 1) for s in have}
            donors = [s for s, d in surplus.items()
                      if d > 0 and have[s] > pol.min_replicas]
            takers = [s for s, d in surplus.items()
                      if d < 0 and have[s] < pol.max_replicas]
            if not donors or not takers:
                break
            donor = max(donors, key=lambda s: (surplus[s], -s))
            taker = min(takers, key=lambda s: (surplus[s], s))
            if self.fleet.migrate(donor, taker) is None:
                break
            have[donor] -= 1
            have[taker] += 1
            actions.append((self.ticks, "move", donor, taker))
        return actions

    def _run(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:                  # pragma: no cover - defensive
                pass
            self._stop.wait(self.interval_s)

    def start(self) -> "Autoscaler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="fleet-autoscaler",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout)
