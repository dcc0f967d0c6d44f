"""Pluggable kernel timing backends, and the rules of which tiles can run.

The measured-autotuning loop ranks candidate tiles by what the hardware
*does*, not what a closed-form cost model says it should do.  One
interface, two implementations:

* :class:`WallClockBackend` — times the hand-written kernels, K1 (blocked
  matmul) through ``kernels/ops.matmul`` and K2 (flash attention) through
  ``kernels/ops.flash_attention``, with CUDA events: warmup, then the
  median of ``reps`` back-to-back calls queued behind a spin kernel (so
  they time the card, not the host), after checking each tile's result
  against the plain oracle, so a mis-tiled kernel can never report a
  fast-but-wrong time (a failed check scores ``inf``).  On a CPU device it
  times the plain versions, for tests.
* :class:`SimulatorBackend` — the JAX package's deterministic seeded tile
  simulator (per-grid-step load / compute / writeback on the shared
  roofline, double buffering gated by the tile rule's budget, an
  efficiency droop on oversized tiles, small-grid occupancy and seeded
  per-tile noise keyed by ``blake2b(seed, case, tile)``), parameterized by
  the hardware and the tile rule.  With ``hw=V5E`` and ``VMEM_RULE`` it
  returns the reference's seconds exactly; the default models the H100.

A :class:`TileRule` says which tiles a kernel can run: the working set a
tile needs against a budget, plus any other limit (the kernels' compiled
tiles and register rules).
``VMEM_RULE`` is the reference's TPU rule (the Pallas kernels'
``vmem_bytes`` against 16 MiB of VMEM); ``SMEM_RULE`` is the H100's, by
dtype: ``matmul_blocked.fits`` (K1's compiled tiles, its register rule and
its shared memory against 227 KB) and ``flash_attention.fits`` (K2's
compiled tiles, its register rule and its shared memory, the same 227 KB).
The rule also names the ``<e>`` slot of the records it governs;
``SMEM_RULE``'s carries ``"k1": "wgmma-tma"`` and ``"k2": "wgmma-tma"``,
the designs of K1 and K2 whose timings it keys (bf16 on the tensor cores
through a TMA ring), so records timed on an earlier kernel never share a
``LogStore`` group with them.

Backend names carry the hardware (``sim:v5e``, ``sim:h100``,
``wallclock:cuda``), so records of the TPU model and of the card never
share a ``LogStore`` group.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from repro_torch.core.roofline import H100, Hardware, mxu_efficiency, roofline_time
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul_blocked as _mm

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One measurement target: which kernel, at which problem shape.

    ``matmul``: ``(m, k, n)`` GEMM, tiles are ``(block_m, block_n,
    block_k)``.  ``flash``: ``m`` = query length, ``n`` = key length,
    ``k`` = head dim, tiles are ``(block_q, block_k)``; ``batch`` and
    ``heads`` multiply the grid.  ``label`` carries provenance (e.g.
    ``"yi-6b/train_4k/ffn_up"``) into record meta — it is *not* part of
    the measurement identity, so zoo configs sharing a shape bucket share
    measurements."""
    kernel: str                   # "matmul" | "flash"
    m: int
    k: int
    n: int
    dtype: str = "bfloat16"
    batch: int = 1                # flash only
    heads: int = 1                # flash only
    causal: bool = True           # flash only
    label: str = ""

    @property
    def dtype_bytes(self) -> int:
        return DTYPE_BYTES[self.dtype]

    def key(self) -> tuple:
        """Measurement identity (label excluded): what LogStore memoized
        timings are keyed by, together with the backend name."""
        return (self.kernel, self.m, self.k, self.n, self.dtype,
                self.batch, self.heads, self.causal)


# ------------------------------------------------------------ tile rules
def _vmem_matmul(bm, bn, bk, dtype_bytes=2):
    """The TPU kernel's VMEM working set of one grid step
    (``repro/kernels/matmul_blocked.py::vmem_bytes``)."""
    return (bm * bk + bk * bn) * dtype_bytes + bm * bn * 4


def _vmem_flash(bq, bk, d, dtype_bytes=2):
    """The TPU flash kernel's VMEM working set
    (``repro/kernels/flash_attention.py::vmem_bytes``)."""
    return (bq * d + 2 * bk * d) * dtype_bytes \
        + (bq * bk + bq * d + 2 * bq) * 4


class TileRule:
    """Which tiles a kernel can run on one device.

    ``matmul_bytes(bm, bn, bk, dtype_bytes)`` and ``flash_bytes(bq, bk, d,
    dtype_bytes)`` give a tile's working set (broadcasting over arrays),
    held against ``budget``; ``matmul_limit(bm, bn, bk, dtype_bytes)`` and
    ``flash_limit(bq, bk, d, dtype_bytes)``, where given, are further masks
    (the kernels' compiled tiles and register rules).  A rule without
    ``flash_bytes`` raises on flash cases.  ``env`` is the ``<e>`` slot of
    every record the rule governs."""

    def __init__(self, name: str, budget: int, env: dict, matmul_bytes,
                 flash_bytes=None, matmul_limit=None, flash_limit=None):
        self.name = name
        self.budget = budget
        self.env = dict(env)
        self.matmul_bytes = matmul_bytes
        self.flash_bytes = flash_bytes
        self.matmul_limit = matmul_limit
        self.flash_limit = flash_limit

    def matmul_ok(self, bm, bn, bk, dtype_bytes: int = 2):
        """Matmul feasibility mask, broadcast over tile arrays."""
        ok = np.asarray(self.matmul_bytes(bm, bn, bk, dtype_bytes)) <= self.budget
        if self.matmul_limit is not None:
            ok = ok & np.asarray(self.matmul_limit(bm, bn, bk, dtype_bytes))
        return ok

    def _flash_bytes(self, bq, bk, d, dtype_bytes):
        if self.flash_bytes is None:
            raise NotImplementedError(f"the {self.name} rule has no flash tiles")
        return self.flash_bytes(bq, bk, d, dtype_bytes)

    def flash_ok(self, bq, bk, d: int, dtype_bytes: int = 2):
        """Flash feasibility mask, broadcast over tile arrays."""
        ok = np.asarray(self._flash_bytes(bq, bk, d, dtype_bytes)) <= self.budget
        if self.flash_limit is not None:
            ok = ok & np.asarray(self.flash_limit(bq, bk, d, dtype_bytes))
        return ok

    def tile_bytes(self, case: KernelCase, bm, bn, bk=None):
        """Working set of one tile of ``case``, broadcast over tile arrays."""
        if case.kernel == "flash":
            return self._flash_bytes(bm, bn, case.k, case.dtype_bytes)
        return self.matmul_bytes(bm, bn, bk, case.dtype_bytes)

    def fits(self, case: KernelCase, bm, bn, bk=None):
        """Feasibility mask for tiles of ``case``."""
        if case.kernel == "flash":
            return self.flash_ok(bm, bn, case.k, case.dtype_bytes)
        return self.matmul_ok(bm, bn, bk, case.dtype_bytes)


def _smem_matmul(bm, bn, bk, dtype_bytes=2):
    return _mm.smem_bytes(_mm.launch_tile(bm, dtype_bytes),
                          _mm.launch_tile(bn, dtype_bytes),
                          _mm.launch_depth(bk, dtype_bytes), dtype_bytes)


def _smem_flash(bq, bk, d, dtype_bytes=2):
    return _fa.smem_bytes(*_fa.launch_tile(bq, bk, dtype_bytes), d, dtype_bytes)


# the reference's rule: ~16 MiB usable VMEM per v5e core
VMEM_RULE = TileRule("vmem", 16 * 2**20, {"vmem_mb": 16},
                     _vmem_matmul, _vmem_flash)
# the H100's: 227 KB of shared memory per block (opt-in), and K1's and
# K2's compiled tiles and register rules
SMEM_RULE = TileRule("smem", _mm.SMEM_LIMIT_BYTES,
                     {"smem_kb": 227, "k1": "wgmma-tma", "k2": "wgmma-tma"},
                     _smem_matmul, _smem_flash, matmul_limit=_mm.fits,
                     flash_limit=_fa.fits)


def _noise(seed: int, case_key: tuple, tile: tuple, amp: float) -> float:
    """Deterministic per-(case, tile) multiplicative jitter in
    ``[1-amp, 1+amp]`` — the reproducible stand-in for run-to-run
    measurement variance."""
    h = hashlib.blake2b(repr((seed, case_key, tile)).encode(),
                        digest_size=8).digest()
    u = int.from_bytes(h, "big") / float(2**64 - 1)      # [0, 1]
    return 1.0 + amp * (2.0 * u - 1.0)


class SimulatorBackend:
    """Deterministic roofline-derived tile pipeline (see module docstring).

    The simulator prices per-*step* tile traffic (not whole-matrix
    refetch), serializes load/compute when the working set is over half
    the rule's budget (no room to double-buffer), applies an efficiency
    droop on tiles past 256x256, charges a per-step launch overhead, and
    perturbs every reading by a seeded +/-``noise_amp``.  Identical seeds
    give identical times.  None of its seconds is a measurement.  Under
    ``SMEM_RULE`` it does not model K1's bf16 ring nor K2's: K1's ring fills
    the shared memory with stages and K2's two stages of K and V take most
    of it at the larger tiles, so the half-budget test calls those tiles
    serial, where the kernels overlap the loads of every tile they run."""

    deterministic = True

    # efficiency droop past a 256x256 output tile (log2(bm*bn) = 16) and
    # past bk = 256 (the reference's calibration, kept for parity)
    DROOP_AREA = 0.45
    DROOP_K = 0.35

    def __init__(self, seed: int = 0, *, hw: Hardware = H100,
                 rule: TileRule = SMEM_RULE, noise_amp: float = 0.02,
                 launch_s: float = 3e-7):
        self.seed = seed
        self.hw = hw
        self.rule = rule
        self.name = f"sim:{hw.name}"
        self.noise_amp = noise_amp
        self.launch_s = launch_s
        self.measured = 0             # tiles timed, across all cases

    # ------------------------------------------------------------- matmul
    def _matmul_time(self, case: KernelCase, bm, bn, bk) -> float:
        db = case.dtype_bytes
        gm = -(-case.m // bm)
        gn = -(-case.n // bn)
        gk = -(-case.k // bk)
        steps = gm * gn * gk
        eff = float(mxu_efficiency(bm, bn))
        droop = 1.0 + self.DROOP_AREA * max(0.0, np.log2(bm * bn) - 16.0) \
            + self.DROOP_K * max(0.0, np.log2(max(bk, 1)) - 8.0)
        load_bytes = (bm * bk + bk * bn) * db
        step = float(roofline_time(2.0 * bm * bn * bk * droop, load_bytes,
                                   hw=self.hw, eff=eff))
        if self.rule.tile_bytes(case, bm, bn, bk) > self.rule.budget / 2:
            # no room to double-buffer: stages serialize instead of overlap
            step = 2.0 * bm * bn * bk * droop / (self.hw.peak_flops
                                                 * max(eff, 1e-3)) \
                + load_bytes / self.hw.hbm_bw
        fill = load_bytes / self.hw.hbm_bw
        writeback = gm * gn * bm * bn * db / self.hw.hbm_bw
        occupancy = 1.25 if steps < 4 else 1.0
        return (fill + steps * step) * occupancy + writeback \
            + steps * self.launch_s

    # -------------------------------------------------------------- flash
    def _flash_time(self, case: KernelCase, bq, bk) -> float:
        db = case.dtype_bytes
        d = case.k
        gq = -(-case.m // bq)
        gk = -(-case.n // bk)
        # causal masking skips ~half the (q, k) tile pairs on average
        live = 0.5 * (gk + 1) if case.causal else float(gk)
        eff = float(mxu_efficiency(bq, bk))
        droop = 1.0 + self.DROOP_AREA * max(0.0, np.log2(bq * bk) - 16.0)
        flops_step = (4.0 * bq * bk * d + 10.0 * bq * bk) * droop
        load_bytes = 2 * bk * d * db                      # K and V tiles
        step = float(roofline_time(flops_step, load_bytes, hw=self.hw,
                                   eff=eff))
        if self.rule.tile_bytes(case, bq, bk) > self.rule.budget / 2:
            step = flops_step / (self.hw.peak_flops * max(eff, 1e-3)) \
                + load_bytes / self.hw.hbm_bw
        q_io = (bq * d * db) * 2 / self.hw.hbm_bw         # load q, store o
        row = q_io + live * step
        grid_rows = case.batch * case.heads * gq
        occupancy = 1.25 if grid_rows * gk < 4 else 1.0
        return grid_rows * row * occupancy \
            + grid_rows * live * self.launch_s

    # ---------------------------------------------------------- interface
    def measure(self, case: KernelCase, tiles) -> list[float]:
        """Seconds per candidate tile (``(bm, bn, bk)`` for matmul,
        ``(bq, bk)`` for flash).  Pure function of (seed, case, tile)."""
        out = []
        for tile in tiles:
            if case.kernel == "flash":
                t = self._flash_time(case, tile[0], tile[1])
            else:
                t = self._matmul_time(case, tile[0], tile[1], tile[2])
            out.append(t * _noise(self.seed, case.key(), tuple(tile),
                                  self.noise_amp))
            self.measured += 1
        return out


class WallClockBackend:
    """Times K1 (matmul cases) and K2 (flash cases) on ``device``: each
    tile's result is first checked against the plain oracle (a mismatch
    scores ``inf`` and counts in ``verify_failures``), then ``warmup``
    untimed calls, then the median of ``reps`` back-to-back calls, each
    between two CUDA events and all queued before the card reaches them
    (see ``_seconds``).  A launch error raises, and so does a tile the
    kernel's rule refuses; neither is scored.  On ``device="cpu"`` the
    wrappers take the plain versions and the host clock times them (for
    tests).

    Flash cases run as the reference's do: MHA ``q, k, v`` of ``[batch, m,
    heads, k]``, the case's causal flag.  Their oracle is the plain version
    over chunks of query rows (``ref.flash_attention_ref_chunked``): at a
    32k prefill the whole score tensor would not fit the card.  It is
    computed once per case and checks every row of every tile.
    ``measured_by`` counts the tiles timed per kernel."""

    deterministic = False
    hw = H100
    rule = SMEM_RULE
    QUEUE_CYCLES = 2_000_000      # the first spin: ~1 ms at the H100's clock

    def __init__(self, *, device="cuda", reps: int = 3, warmup: int = 1,
                 verify: bool = True, atol: float = 2e-2, seed: int = 0):
        self.device = resolve_device(str(device))
        self.name = f"wallclock:{self.device.type}"
        self.reps = reps
        self.warmup = warmup
        self.verify = verify
        self.atol = atol
        self.seed = seed
        self.measured = 0
        self.measured_by = {"matmul": 0, "flash": 0}
        self.verified = 0
        self.verify_failures = 0

    def _arrays(self, case: KernelCase):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        dt = _TORCH_DTYPES[case.dtype]

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=self.device).to(dt)

        if case.kernel == "flash":
            kv = (case.batch, case.n, case.heads, case.k)
            return randn(case.batch, case.m, case.heads, case.k), randn(*kv), randn(*kv)
        return randn(case.m, case.k), randn(case.k, case.n)

    @staticmethod
    def _call(case: KernelCase, arrays, tile):
        from repro_torch.kernels import ops
        if case.kernel == "flash":
            return ops.flash_attention(*arrays, causal=case.causal,
                                       block_q=int(tile[0]), block_k=int(tile[1]))
        a, b = arrays
        return ops.matmul(a, b, block_m=int(tile[0]), block_n=int(tile[1]),
                          block_k=int(tile[2]))

    @staticmethod
    def _reference(case: KernelCase, arrays):
        from repro_torch.kernels.ref import flash_attention_ref_chunked, matmul_ref
        if case.kernel == "flash":
            return flash_attention_ref_chunked(*arrays, causal=case.causal).float()
        return matmul_ref(*arrays).float()

    def _seconds(self, case: KernelCase, arrays, tile) -> list[float]:
        """``reps`` readings of one tile.  On the card the calls go back to
        back with an event after each, so each reading spans one kernel.
        They are queued behind a spin kernel, so the card reaches them only
        once all are queued and the wrapper's host work is not counted (a
        small tile's launch takes longer on the host than on the card).  If
        the spin ended before the host had queued them, the readings are
        taken again behind a spin four times as long."""
        if self.device.type == "cuda":
            cycles = self.QUEUE_CYCLES
            while True:
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(self.reps + 1)]
                torch.cuda._sleep(cycles)
                events[0].record()
                for end in events[1:]:
                    self._call(case, arrays, tile)
                    end.record()
                queued_ahead = not events[0].query()
                events[-1].synchronize()
                if queued_ahead:
                    break
                if cycles >= self.QUEUE_CYCLES << 8:
                    raise RuntimeError(
                        f"the host could not queue {self.reps} launches of "
                        f"{tuple(tile)} within {cycles} cycles of the card")
                cycles *= 4
            return [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
        times = []
        for _ in range(self.reps):
            t0 = time.perf_counter()
            self._call(case, arrays, tile)
            times.append(time.perf_counter() - t0)
        return times

    def measure(self, case: KernelCase, tiles) -> list[float]:
        if case.dtype not in _TORCH_DTYPES:
            raise ValueError(f"the kernels take {sorted(_TORCH_DTYPES)}, "
                             f"not {case.dtype}")
        arrays = self._arrays(case)
        ref = self._reference(case, arrays) if self.verify else None
        out = []
        for tile in tiles:
            got = self._call(case, arrays, tile)
            if ref is not None:
                if torch.allclose(got.float(), ref, atol=self.atol, rtol=self.atol):
                    self.verified += 1
                else:
                    self.verify_failures += 1
                    out.append(float("inf"))
                    continue
            del got
            for _ in range(self.warmup):
                self._call(case, arrays, tile)
            out.append(float(np.median(self._seconds(case, arrays, tile))))
            self.measured += 1
            self.measured_by[case.kernel] += 1
        return out


_BACKENDS = {"sim": SimulatorBackend, "wallclock": WallClockBackend}


def get_backend(name: str, **kw):
    """Timing-backend registry: ``"sim"`` (deterministic, CI-safe) or
    ``"wallclock"`` (the CUDA kernel on the card; plain on the CPU)."""
    if name not in _BACKENDS:
        raise KeyError(f"unknown timing backend {name!r}; "
                       f"known: {sorted(_BACKENDS)}")
    return _BACKENDS[name](**kw)
