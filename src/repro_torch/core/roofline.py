"""The two-term tile roofline shared by the kernel cost model and the
timing simulator (the tile part of the JAX package's ``core/roofline.py``).

``V5E`` keeps the reference's TPU v5e constants, so that the port's cost
model and simulator can be held against the reference number for number.
``H100`` is the card the port runs on, from NVIDIA's H100 SXM data sheet:
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3, 80 GB,
NVLink 450 GB/s each way.  The per-model roofline of the reference waits
for the mesh tuner.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Hardware:
    peak_flops: float = 197e12
    hbm_bw: float = 819e9
    link_bw: float = 50e9
    hbm_cap: float = 16 * 2**30
    dcn_bw: float = 25e9          # cross-pod per-chip share
    name: str = "v5e"             # names the timing backend's records


V5E = Hardware()
# the H100 has no cross-pod network of its own; dcn_bw stays the
# reference's placeholder and no tile formula reads it
H100 = Hardware(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
                hbm_cap=80e9, name="h100")


def roofline_time(flops, hbm_bytes, *, hw: Hardware = H100,
                  eff=1.0):
    """The two-term tile roofline: max(compute, memory) seconds.  Works on
    scalars or broadcast numpy arrays — ``core/kerneltune.py``'s tile cost
    model and the ``kernels/timing.py`` simulator backend both price their
    steady-state step through this one function, so the analytic prior and
    the simulated "measurement" share a single roofline vocabulary."""
    compute = np.asarray(flops, np.float64) / (hw.peak_flops
                                               * np.maximum(eff, 1e-3))
    memory = np.asarray(hbm_bytes, np.float64) / hw.hbm_bw
    return np.maximum(compute, memory)


def mxu_efficiency(bm, bn, *, mxu: int = 128):
    """Matrix-unit utilization of a (bm, bn) output tile, broadcast over
    arrays: sub-``mxu`` dims waste slots proportionally and non-multiples
    pay a fixed fragmentation penalty.  Shared by the closed-form tile cost
    model and the timing simulator."""
    bm = np.asarray(bm, np.float64)
    bn = np.asarray(bn, np.float64)
    eff = np.minimum(bm, mxu) / mxu * np.minimum(bn, mxu) / mxu
    return np.where((bm % mxu == 0) & (bn % mxu == 0),
                    np.minimum(1.0, eff), 0.6 * eff)
