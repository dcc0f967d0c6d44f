"""Execution log L and training-set extraction D (paper §III-B).

L is a collection of tuples <d, a, e, p_r, p_c, t>.  Grouping by the triple
<d, a, e> and taking the argmin-time partitioning per group yields the
training set D = {<features(d,a,e), (p_r*, p_c*)>}.

Serialization is schema-versioned JSONL: ``save`` writes a header line
(schema version plus the log's partition base ``s``) followed by one record
per line; ``load`` round-trips the header and still accepts legacy
headerless files.  The persistent multi-source store built on this format
lives in ``data/logstore.py``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

from repro_torch.core.features import featurize

SCHEMA_VERSION = 1


def parse_header(obj: dict, path="<log>"):
    """``None`` if ``obj`` is a record line; otherwise the header's
    partition base ``s`` (after validating the schema version).  Shared by
    ``ExecutionLog.load`` and ``data/logstore.py`` so the two readers can
    never disagree on which files they accept."""
    if "algo" in obj:
        return None
    if obj.get("schema", SCHEMA_VERSION) > SCHEMA_VERSION:
        raise ValueError(f"log schema {obj['schema']} newer than supported "
                         f"{SCHEMA_VERSION}: {path}")
    return int(obj.get("s", 2))


def canon_value(v):
    """Canonical hashable form of a dataset/env feature value: floats unify
    int/float spellings; non-numeric values (e.g. a cluster-name string)
    fall back to ``repr`` instead of raising."""
    try:
        return round(float(v), 9)
    except (TypeError, ValueError):
        return repr(v)


def canon_items(d: dict) -> tuple:
    """Canonical hashable view of a feature dict: sorted
    ``(key, canon_value)`` pairs.  The one grouping identity shared by
    record keys, serving-memo keys, and the eval harness's environment
    matching — so the subsystems can never disagree on what "the same
    group" means."""
    return tuple(sorted((k, canon_value(v)) for k, v in d.items()))


@dataclasses.dataclass(frozen=True)
class ExecutionRecord:
    dataset: dict                 # dataset features (rows, cols, size_mb, ...)
    algo: str
    env: dict                     # environment features
    p_r: int
    p_c: int
    time_s: float                 # inf == failure (paper's OOM convention)
    meta: dict = dataclasses.field(default_factory=dict)

    def triple_key(self):
        return (canon_items(self.dataset), self.algo, canon_items(self.env))

    def record_key(self):
        """Dedup identity of one grid cell: the <d, a, e> group plus the
        partitioning tried there (``LogStore`` keys appends by this)."""
        return (*self.triple_key(), self.p_r, self.p_c)

    def to_obj(self) -> dict:
        return {"dataset": self.dataset, "algo": self.algo, "env": self.env,
                "p_r": self.p_r, "p_c": self.p_c,
                "time_s": ("inf" if math.isinf(self.time_s) else self.time_s),
                "meta": self.meta}

    @classmethod
    def from_obj(cls, o: dict) -> "ExecutionRecord":
        t = float("inf") if o["time_s"] == "inf" else float(o["time_s"])
        return cls(o["dataset"], o["algo"], o["env"],
                   int(o["p_r"]), int(o["p_c"]), t, o.get("meta", {}))


class ExecutionLog:
    def __init__(self, records=None, s: int = 2):
        self.records: list[ExecutionRecord] = list(records or [])
        self.s = s                # partition base: classes are powers of s

    def add(self, rec: ExecutionRecord):
        self.records.append(rec)

    # ------------------------------------------------------------------ io
    def save(self, path):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            f.write(json.dumps({"schema": SCHEMA_VERSION, "s": self.s}) + "\n")
            for r in self.records:
                f.write(json.dumps(r.to_obj()) + "\n")

    @classmethod
    def load(cls, path):
        out = cls()
        for line in Path(path).read_text().splitlines():
            if not line.strip():
                continue
            o = json.loads(line)
            s = parse_header(o, path)
            if s is not None:
                out.s = s
                continue
            out.add(ExecutionRecord.from_obj(o))
        return out

    # --------------------------------------------------------- extraction
    def groups(self) -> dict:
        g: dict = {}
        for r in self.records:
            g.setdefault(r.triple_key(), []).append(r)
        return g

    def best_per_group(self) -> list[ExecutionRecord]:
        out = []
        for recs in self.groups().values():
            finite = [r for r in recs if math.isfinite(r.time_s)]
            if not finite:
                continue
            out.append(min(finite, key=lambda r: r.time_s))
        return out

    def training_set(self, s: int | None = None):
        """-> ``(feature_dicts, y_r, y_c)``: one entry per finite-time
        group, labels as log-base-``s`` exponents of the argmin partition
        counts (``s`` defaults to the log's own base)."""
        s = self.s if s is None else s
        feats, yr, yc = [], [], []
        logs = math.log(s)
        for r in self.best_per_group():
            feats.append(featurize(r.dataset, r.algo, r.env))
            yr.append(int(round(np.log(r.p_r) / logs)))
            yc.append(int(round(np.log(r.p_c) / logs)))
        return feats, np.array(yr), np.array(yc)
