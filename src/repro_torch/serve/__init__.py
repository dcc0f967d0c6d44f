"""Online serving subsystem (DESIGN.md §10–§11), the in-process tier of the
JAX package's ``repro/serve``: the sharded estimation router, the
background refit daemon, the closed-loop load generator and the stats
schema.  The multi-process fleet, its transports and its registry are not
ported yet (``ROADMAP.md``: the serving fleet and its launchers).

Quickstart::

    est = BlockSizeEstimator("tree").fit(store.load())
    with ShardRouter(est, n_shards=4) as router:
        daemon = RefitDaemon(router, store).start()
        p_r, p_c = router.predict((n_rows, n_cols, "kmeans", env.features()))
        ...
        daemon.stop()

``python -m repro_torch serve-estimator`` fronts the tier from a
persistent LogStore.  The tier runs on the host: shards predict with the
CART cascade in numpy.
"""
from repro_torch.serve.loadgen import (make_diurnal_trace, make_trace,
                                       make_universe, run_load, served_skew,
                                       staleness_violations)
from repro_torch.serve.refit import RefitDaemon
from repro_torch.serve.router import (DeadlineExceeded, HashRing, RouterClosed,
                                      RouterRejected, ServeResult, Shard,
                                      ShardRouter)
from repro_torch.serve.stats import STATS_SCHEMA, StatsView, normalize_stats

__all__ = ["DeadlineExceeded", "HashRing", "RefitDaemon", "RouterClosed",
           "RouterRejected", "STATS_SCHEMA", "ServeResult", "Shard",
           "ShardRouter", "StatsView", "make_diurnal_trace", "make_trace",
           "make_universe", "normalize_stats", "run_load", "served_skew",
           "staleness_violations"]
