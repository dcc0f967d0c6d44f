"""One stats schema across the serving tier (DESIGN.md §15), the port of
the JAX package's ``repro/serve/stats.py``.

Three layers grew three dialects in the reference: the in-process
``ShardRouter`` predates replicas (no ``n_replicas``/``read_barrier``),
the multi-process fleet router added fleet counters, and its worker-side
shard reports its model version as ``version``.  The port has the
in-process router only (the fleet is queued in ``ROADMAP.md``), but keeps
the whole **canonical schema** and the compat accessor, so a stats dict
reads the same in both packages.

Canonical keys (``STATS_SCHEMA``: name → meaning):

========================  =============================================
``n_shards``              logical shards in the ring
``n_replicas``            live serving replicas across all shards
``served``                requests answered (monotonic across respawns)
``queued``                requests sitting in admission queues right now
``abstained``             answers from the fallback heuristic
``rejected``              admission rejections (queue full / class shed)
``shed``                  per-class admission sheds
``shed_deadline``         dropped pre-enqueue: deadline unmeetable
``expired``               expired in-queue past their deadline
``hits`` / ``misses``     memo cache hits / misses
``hit_rate``              hits / (hits + misses)
``invalidations``         memo entries dropped on model swaps
``model_version``         version the management layer currently holds
``read_barrier``          version a served request is guaranteed ≥
``swaps``                 completed model swaps
``crashes``               replica/worker deaths observed
``respawns``              replacements spawned by crash recovery
``rerouted``              orphaned requests re-homed (zero lost)
``scale_outs``/``scale_ins``  autoscaler replica adds / drains
``migrations``            budget-conserving replica moves
``heartbeats``            health-probe pings sent
``heartbeat_replacements``  silently-dead replicas replaced by probes
``adoptions``             registered workers attached by discovery
``served_skew``           max-over-mean per-replica served counts
========================  =============================================

Layers that never had a counter report its identity default (0, or a
derived value such as ``read_barrier`` ← ``model_version``); nothing is
invented.  The raw layer-specific keys (``per_shard``, ``per_replica``,
``transport``, …) pass through untouched, so existing baselines and the
regression gate read exactly what they always did.
"""
from __future__ import annotations

from collections.abc import Mapping

__all__ = ["STATS_SCHEMA", "LEGACY_ALIASES", "normalize_stats",
           "StatsView"]

# canonical key → (one-line meaning, identity default)
STATS_SCHEMA = {
    "n_shards": ("logical shards in the ring", 0),
    "n_replicas": ("live serving replicas", None),   # ← n_shards
    "served": ("requests answered", 0),
    "queued": ("requests waiting in admission queues", 0),
    "abstained": ("answers from the fallback heuristic", 0),
    "rejected": ("admission rejections", 0),
    "shed": ("per-class admission sheds", 0),
    "shed_deadline": ("dropped pre-enqueue on unmeetable deadline", 0),
    "expired": ("expired in-queue past deadline", 0),
    "hits": ("memo cache hits", 0),
    "misses": ("memo cache misses", 0),
    "hit_rate": ("hits / (hits + misses)", 0.0),
    "invalidations": ("memo entries dropped on swaps", 0),
    "model_version": ("version the management layer holds", None),
    "read_barrier": ("version served requests are guaranteed ≥", None),
    "swaps": ("completed model swaps", 0),
    "crashes": ("replica/worker deaths observed", 0),
    "respawns": ("replacements spawned by crash recovery", 0),
    "rerouted": ("orphaned requests re-homed", 0),
    "scale_outs": ("autoscaler replica adds", 0),
    "scale_ins": ("autoscaler replica drains", 0),
    "migrations": ("budget-conserving replica moves", 0),
    "heartbeats": ("health-probe pings sent", 0),
    "heartbeat_replacements": ("silent deaths replaced by probes", 0),
    "adoptions": ("registered workers attached by discovery", 0),
    "served_skew": ("max/mean per-replica served", 0.0),
}

# legacy spelling → canonical key (the compat accessor reads these)
LEGACY_ALIASES = {
    "version": "model_version",        # ShardWorker counters
    "n_workers": "n_replicas",
    "pending": "queued",
    "heartbeat_respawns": "heartbeat_replacements",
}


def normalize_stats(raw: Mapping) -> dict:
    """Return ``raw`` upgraded to the canonical schema: every
    ``STATS_SCHEMA`` key present (aliases folded in, absent counters at
    their identity default, ``n_replicas``/``read_barrier`` derived when
    a layer predates them), with all original keys preserved untouched —
    so old baselines keep reading while new code reads one schema."""
    out = dict(raw)
    for legacy, canon in LEGACY_ALIASES.items():
        if canon not in out and legacy in raw:
            out[canon] = raw[legacy]
    for key, (_doc, default) in STATS_SCHEMA.items():
        out.setdefault(key, default)
    if out["n_replicas"] is None:        # pre-replica layers: one per shard
        out["n_replicas"] = out["n_shards"]
    if out["read_barrier"] is None:      # pre-barrier layers: the live model
        out["read_barrier"] = out["model_version"]
    return out


class StatsView(Mapping):
    """Read-only mapping over one normalized snapshot that also answers
    the **legacy** spellings (``view["version"]``, ``view["pending"]``),
    so callers written against any pre-schema layer keep working without
    touching the dict the regression gate hashes."""

    def __init__(self, raw: Mapping):
        self._data = normalize_stats(raw)

    def __getitem__(self, key):
        if key in self._data:
            return self._data[key]
        if key in LEGACY_ALIASES:
            return self._data[LEGACY_ALIASES[key]]
        raise KeyError(key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key) -> bool:
        return key in self._data or key in LEGACY_ALIASES

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def to_dict(self) -> dict:
        return dict(self._data)
