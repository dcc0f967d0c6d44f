"""Online serving subsystem (DESIGN.md §10, §13–§15), the port of the JAX
package's ``repro/serve``: the sharded estimation router, the
multi-process serving fleet, its control plane (discovery, heartbeats,
authenticated frames, router failover), the background refit daemon, the
closed-loop load generator and the stats schema.

Quickstart (single process)::

    est = BlockSizeEstimator("tree").fit(store.load())
    with ShardRouter(est, n_shards=4) as router:
        daemon = RefitDaemon(router, store).start()
        p_r, p_c = router.predict((n_rows, n_cols, "kmeans", env.features()))
        ...
        daemon.stop()

Fleet (multi-process workers, replicated hot shards, autoscaling)::

    with FleetRouter(est, n_shards=8, replicas={1: 3},
                     transport="process", autoscale=True) as fleet:
        fleet.request(query, deadline_s=0.05, cls="interactive")

Multi-node (workers on other hosts run ``python -m repro_torch
serve-worker --listen host:port --register /shared/registry.jsonl``)::

    spec = TransportSpec(kind="socket", registry="/shared/registry.jsonl",
                         auth_key="s3cret")
    with FleetRouter(est, n_shards=4, transport=spec,
                     heartbeat=True) as fleet:
        fleet.prober.start()
        fleet.request(query, deadline_s=0.05, cls="interactive")

``python -m repro_torch serve-estimator`` fronts the whole tier from a
persistent LogStore.  The tier runs on the host: shards and fleet
workers predict with the CART cascade in numpy.
"""
from repro_torch.serve.fleet import (AutoscalePolicy, Autoscaler, FleetRouter,
                                     HealthProber, HeartbeatPolicy,
                                     ShedRejected, demand_plan,
                                     live_demand_plan, proportional_plan,
                                     trace_histogram)
from repro_torch.serve.loadgen import (make_diurnal_trace, make_trace,
                                       make_universe, run_load, served_skew,
                                       staleness_violations)
from repro_torch.serve.refit import RefitDaemon
from repro_torch.serve.registry import LeaseKeeper, WorkerRegistry
from repro_torch.serve.router import (DeadlineExceeded, HashRing, RouterClosed,
                                      RouterRejected, ServeResult, Shard,
                                      ShardRouter)
from repro_torch.serve.stats import STATS_SCHEMA, StatsView, normalize_stats
from repro_torch.serve.transport import (FrameAuthError, LoopbackTransport,
                                         ProcessTransport, ShardWorker,
                                         SocketTransport, TransportDead,
                                         TransportSpec, make_transport,
                                         serve_socket_worker)

__all__ = ["AutoscalePolicy", "Autoscaler", "DeadlineExceeded",
           "FleetRouter", "FrameAuthError", "HashRing", "HealthProber",
           "HeartbeatPolicy", "LeaseKeeper", "LoopbackTransport",
           "ProcessTransport", "RefitDaemon", "RouterClosed",
           "RouterRejected", "STATS_SCHEMA", "ServeResult", "Shard",
           "ShardRouter", "ShardWorker", "ShedRejected",
           "SocketTransport", "StatsView", "TransportDead",
           "TransportSpec", "WorkerRegistry", "demand_plan",
           "live_demand_plan", "make_diurnal_trace", "make_trace",
           "make_transport", "make_universe", "normalize_stats",
           "proportional_plan", "run_load", "served_skew",
           "serve_socket_worker", "staleness_violations",
           "trace_histogram"]
