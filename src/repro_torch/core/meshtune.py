"""Beyond-paper: the paper's methodology applied to the LM stack, the port
of the JAX package's ``repro/core/meshtune.py``.

The "dataset" is an (architecture x input-shape) cell, the "environment" is
the accelerator pod, and the partitioning decision (p_r, p_c) becomes
(data-parallel degree, microbatch count) -- with tensor parallelism
tp = chips / dp.  The execution log is a grid of roofline-modeled step
times (OOM cells -> inf exactly like the paper), and the same chained
DT_r -> DT_c cascade predicts the best (dp, mb) for unseen cells.

Every function that prices a cell takes ``hw`` (the hardware constants
of ``core/roofline.py``): the port's default is ``H100``, so its tuner
prices a mesh on the card's constants; ``V5E`` gives the reference's grid.
"""
from __future__ import annotations

import math

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.chained import ChainedClassifier
from repro_torch.core.log import ExecutionLog, ExecutionRecord
from repro_torch.core.roofline import H100, Hardware, cell_roofline
from repro_torch.core.trees import DecisionTreeClassifier
from repro_torch.core.tuner import SearchSpace, Tuner, TuneQuery


def arch_features(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    s = cfg.ssm
    mo = cfg.moe
    return {
        "rows": float(shape.global_batch),          # paper-schema aliases
        "cols": float(shape.seq_len),
        "log_rows": math.log2(max(shape.global_batch, 1)),
        "log_cols": math.log2(max(shape.seq_len, 1)),
        "d_model": float(cfg.d_model),
        "n_layers": float(cfg.n_layers),
        "n_heads": float(cfg.n_heads),
        "n_kv": float(cfg.n_kv_heads),
        "d_ff": float(cfg.d_ff or cfg.dense_d_ff or
                      (mo.d_ff if mo else 0)),
        "vocab": float(cfg.vocab),
        "params_b": cfg.n_params() / 1e9,
        "active_b": cfg.n_active_params() / 1e9,
        "moe_experts": float(mo.n_experts) if mo else 0.0,
        "moe_topk": float(mo.top_k) if mo else 0.0,
        "ssm_state": float(s.d_state) if s else 0.0,
        "is_train": 1.0 if shape.kind == "train" else 0.0,
        "is_decode": 1.0 if shape.kind == "decode" else 0.0,
        "fsdp": 1.0 if cfg.param_sharding == "fsdp" else 0.0,
    }


def mesh_grid(chips: int = 256, s: int = 2):
    """(dp, tp) factorizations and microbatch powers -- the search grid."""
    dps = [s ** i for i in range(int(math.log(chips, s)) + 1)]
    mbs = [s ** i for i in range(0, 7)]
    return dps, mbs


def grid_search_cell(cfg: ModelConfig, shape: ShapeConfig, *,
                     chips: int = 256, log: ExecutionLog | None = None,
                     algo_name: str = "meshtune", store=None,
                     hw: Hardware = H100):
    """Roofline-modeled grid over (dp, mb); infeasible cells score inf.
    ``store`` (a ``data/logstore.py`` LogStore) persists the sweep."""
    log = log or ExecutionLog()
    n0 = len(log.records)
    dps, mbs = mesh_grid(chips)
    d_feat = arch_features(cfg, shape)
    env = {"chips": chips}
    grid = {}
    for dp in dps:
        tp = chips // dp
        if shape.global_batch % dp:
            continue
        for mb in mbs:
            if shape.kind != "train" and mb > 1:
                continue
            if shape.kind == "train" and (shape.global_batch % (dp * mb)
                                          or shape.global_batch // mb < dp):
                continue
            r = cell_roofline(cfg, shape, {"data": dp, "model": tp},
                              microbatches=mb, hw=hw)
            t = r["step_s"] if r["fits"] else float("inf")
            grid[(dp, mb)] = t
            log.add(ExecutionRecord(d_feat, algo_name, env,
                                    dp, max(mb, 1), t,
                                    {"tp": tp, "dominant": r["dominant"]}))
    if store is not None:
        store.append(log.records[n0:], source="mesh_grid")
    return log, grid


class MeshTuner:
    """Chained DT_r(dp) -> DT_c(mb), exactly the paper's cascade -- a thin
    instantiation of the shared ``core/tuner.py`` subsystem (deeper trees
    via a custom model factory); the deployment-side feasibility snap stays
    here, outside the protocol."""

    def __init__(self, chips: int = 256, hw: Hardware = H100):
        self.chips = chips
        self.hw = hw
        self.tuner = Tuner(
            space=SearchSpace(s=2, row="dp", col="microbatch"),
            model_factory=lambda: ChainedClassifier(
                lambda: DecisionTreeClassifier(max_depth=12)))

    def fit(self, log: ExecutionLog):
        self.tuner.fit(log)
        return self

    def refit(self, new_records) -> bool:
        return self.tuner.refit(new_records)

    def predict(self, cfg: ModelConfig, shape: ShapeConfig):
        dp, mb = self.tuner.predict(
            TuneQuery(arch_features(cfg, shape), "meshtune",
                      {"chips": self.chips}, cap_r=self.chips))
        if shape.kind != "train":
            mb = 1
        # snap to the nearest *feasible* cell (batch divisibility + the
        # memory model's HBM-fit check -- never the time oracle).  This is
        # the deployment-side guard the paper's §III caveat calls for when
        # the training log under-covers the feasibility boundary.
        dps, mbs = mesh_grid(self.chips)
        best, best_d = None, None
        for d in dps:
            if shape.global_batch % d:
                continue
            for m in (mbs if shape.kind == "train" else [1]):
                if shape.kind == "train" and (
                        shape.global_batch % (d * m)
                        or shape.global_batch // m < d):
                    continue
                r = cell_roofline(cfg, shape,
                                  {"data": d, "model": self.chips // d},
                                  microbatches=m, hw=self.hw)
                if not r["fits"]:
                    continue
                dist = abs(math.log2(d) - math.log2(dp)) \
                    + 0.5 * abs(math.log2(m) - math.log2(mb))
                if best_d is None or dist < best_d:
                    best, best_d = (d, m), dist
        if best is None:                         # nothing fits: fall back
            best = (dp, mb)
        dp, mb = best
        return dp, self.chips // dp, mb


def tune_all(archs, shapes=("train_4k", "prefill_32k", "decode_32k"),
             chips: int = 256, *, store=None, hw: Hardware = H100):
    """Build the full modeled execution log over the assigned cells."""
    log = ExecutionLog()
    grids = {}
    for arch in archs:
        cfg = get_config(arch)
        for sn in shapes:
            if sn in cfg.skip_shapes:
                continue
            log, grid = grid_search_cell(cfg, SHAPES[sn], chips=chips,
                                         log=log, store=store, hw=hw)
            grids[(arch, sn)] = grid
    return log, grids
