#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. probe     card name, power limit and capability; TF32 off for fp32 checks
  2. build     nvcc builds the three libraries from csrc/, one process per
               source, and prints the build time and each kernel's registers
               and spills (a spill, or a setmaxnreg that ptxas ignores,
               fails); the SASS of every bf16 kernel of K1, K2 and K2 bwd
               (dK/dV and dQ) must hold HGMMA (wgmma) and UTMALDG (TMA load)
               instructions, each library's compiled tiles must be its
               rule's, and its shared memory per launch must be the rule's
  3. kernel    flash attention (K2) against its plain torch version on the
               card: every compiled bf16 tile on every case (3e-2), among
               them head dims 96 (MHA; GQA with T = S = 200) and 120 (GQA
               group 4, window 32 and 8 meta keys, T = S = 150), which run
               on d = 128's layout; bit-identical across block_q at a fixed
               block_k, the fp32 kernel (2e-5), refused tiles raise, and a
               window of 1 (one nonzero per row of P) reads back each row's
               own v exactly at every tile (a store past d, or padding that
               is not zero, breaks it)
  4. timing    K2 at every compiled tile of d = 128, its plain version and
               the SDPA yardstick at the serving shape and at Yi-6B's
               train_4k flash case, with the bound and its share; both
               shapes held by the row check (below)
  5. model     Yi-6B widths, 2 layers, fp32: model_forward flash vs plain
  6. serve     Yi-6B at full width and depth, bf16: 8 x 512-token prompts,
               32 generated tokens, through ``repro_torch.launch.serve.main``
               (K2 launches: one an attention-bearing layer, in prefill)
  7. k1        blocked matmul against its plain version on the card: every
               compiled tile of both dtypes at bk 16/64/128/256 on the JAX
               tests' shapes and three ragged ones (bit-identical across the
               tiles of a dtype; refused tiles raise), then Yi-6B's ffn_up
               shape
  8. tune      ``python -m repro_torch tune --skip ds mesh --arch yi-6b
               --backend wallclock`` through its ``main`` (the kernel family): every candidate tile of Yi-6B's 14
               cases (12 GEMM on K1, 2 flash on K2) timed on the card, the
               measured tuners fitted, the evaluation table written (store
               in a temporary directory)
  9. k1-timing blocked matmul at (4096, 4096, 11008) bf16 with the default
               tile and the best tile phase 8 measured, beside its plain
               version, torch.matmul and the bound: TFLOP/s and the share
               of the bound
 10. k2-bwd    the flash-attention gradient (K2 bwd) against its plain
               version (autograd through the plain forward) on phase 3's
               cases (d = 96 and 120 among them), two causal T > S cases
               (rows that see no key) and two at d = 128 (GQA with T = S =
               200; a window and a meta prefix),
               fp32 (1e-4) and bf16 (3e-2), each relative to the
               largest gradient entry; two launches bit-identical; the
               forward with lse bit-identical to the one without; refused
               head dims raise; the autograd Function's gradients are the
               kernel's
 11. k2-bwd-timing  K2 bwd at train_4k as the train run calls it (q
               [1,4096,32,128], k/v [1,4096,4,128] bf16, causal), and at
               phi-3-vision's (d = 96, MHA) and h2o-danube's (d = 120, group
               4, window 4096) train_4k shapes, beside its plain version,
               SDPA's backward and the bound on the real d; dq, dk and dv
               also held by the row check
 12. train     Yi-6B at its published widths, 8 of its 32 layers, bf16
               params, fp32 AdamW moments and gradient accumulation, 8
               microbatches with per-layer remat, seq 4096, global batch 8,
               data from the port's pipeline, flash attention: 1 warm-up and
               3 timed steps (step ms, tokens/s, model-FLOP share, peak
               memory, finite loss and gnorm, K2 and K2 bwd launches equal
               to their formulas); then one step at 2 layers and seq 1024,
               flash against plain attention: loss, gnorm and each
               attention weight's gradient, at Yi-6B's widths (d = 128),
               phi-3-vision's (d = 96, 576 image positions first) and
               h2o-danube's (d = 120, group 4, window cut to 512 so that it
               masks), each with its K2 bwd launches counted
 13. train-launcher  ``python -m repro_torch train --preset small
               --use-flash`` through its ``main``, on a mesh planned by
               ``plan_mesh`` for one NCCL rank (1x1; a one-rank mesh places
               nothing, so the launcher runs the plain step on it): loss
               improves over 14 steps, ``--resume`` continues from the
               checkpoint, ``--inject-failure 6`` re-meshes onto the same
               one rank (``plan_mesh(max(1, 1 - 1))``), restores and reruns
 14. serve-gemma3  K2 at gemma3-27b's local-layer prefill shape (q
               [4,1536,32,128], k/v [4,1536,16,128] bf16, causal, window
               1024) against its plain version (row check), timed beside
               it, SDPA with the window as a mask and the bound; then
               gemma3-27b at full width and depth (62 layers, 52 of them
               sliding-window with ring caches), bf16 random weights drawn
               on the card,
               through ``serve.generate``: 4 x 1536-token prompts, 32 new
               tokens (the rings wrap in prefill and again in decode); 62
               K2 launches, 0 K2 bwd, tokens in [0, vocab), finite logits
 15. decode-vs-forward  prefill T - 1 tokens with flash, then 3 decode
               steps, each step's logits against the plain full forward's
               (max abs err < 2e-3), fp32, batch 2: gemma3 widths with 2
               layers, windows (1024, 0), T = 1100; mixtral widths with 2
               layers, window 512, T = 600, at the no-drop capacity factor;
               hymba widths with 2 hybrid layers, windows (1024, 0), 128
               meta tokens, T = 1100 (the window and four SSD chunk
               boundaries crossed); mamba2 widths with 2 SSD layers,
               T = 600 (not a chunk multiple: the padding runs);
               phi-3-vision widths (d = 96) with its 576 image positions
               before 600 text tokens; musicgen widths with 4 codebooks,
               T = 600; h2o-danube widths (d = 120), window cut to 1024,
               T = 1100; deepseek-v3 widths, its first 2 layers (dense MLA:
               d_model 7168, 128 heads, kv rank 512; the absorbed latent
               decode against the decompressed forward), T = 600, 0 K2
               launches
 16. serve-mixtral  mixtral-8x7b at its published widths, 16 of its 32
               layers (the whole model is 93 GB in bf16, the cut ~47 GB),
               bf16 random weights: 8 x 512-token prompts, 32 new tokens;
               16 K2 launches, 0 K2 bwd, finite logits
 17. serve-hymba  K2 at hymba-1.5b's local-layer prefill shape (q
               [8,1664,25,64], k/v [8,1664,5,64] bf16, causal, window 1024,
               128 meta tokens) against its plain version (row check),
               timed beside it, SDPA with the mask as a boolean and the bound;
               then hymba-1.5b whole (32 hybrid layers, attention and the
               SSD in parallel, 29 of them windowed), bf16 random weights,
               through ``serve.generate``: 8 x 1536-token prompts, 32 new
               tokens (the rings wrap in prefill and in decode); 32 K2
               launches, 0 K2 bwd, tokens in [0, vocab), finite logits
 18. serve-mamba2  mamba2-370m whole (48 SSD layers, attention-free), bf16
               random weights: 8 x 2048-token prompts (8 SSD chunks of
               256), 32 new tokens; 0 K2 launches, finite logits
 19. serve-h2o  K2 at h2o-danube-3-4b's prefill shape (q [2,6144,32,120],
               k/v [2,6144,8,120] bf16, causal, window 4096) against its
               plain version (row check), timed beside it, SDPA with the
               window as a boolean mask and the bound; then h2o-danube-3-4b
               whole (24 windowed layers, head dim 120), bf16 random weights,
               through ``serve.generate``: 2 x 6144-token prompts (the
               window masks and the rings wrap in prefill), 32 new tokens;
               24 K2 launches, 0 K2 bwd, finite logits
 20. serve-phi3  K2 at phi-3-vision-4.2b's prefill shape (q/k/v
               [4,1600,32,96], causal over 576 image and 1024 text
               positions) as in phase 19, SDPA with is_causal; then
               phi-3-vision-4.2b whole (32 layers, head dim 96): 4 x (576
               image embeddings N(0, 0.02) + 1024 text tokens), 32 new; 32
               K2 launches, 0 K2 bwd, finite logits
 21. serve-musicgen  K2 at musicgen-large's prefill shape (q/k/v
               [8,512,32,64], causal) as in phase 20; then musicgen-large
               whole (48 layers, 4 codebooks): 8 x 4 x 512-token prompts,
               32 new steps of 4 codebook tokens; 48 K2 launches, 0 K2 bwd,
               finite logits
 22. serve-deepseek  deepseek-v3-671b at its published widths, 5 of its 61
               layers (3 dense MLA layers, 2 MLA + 256-expert MoE layers;
               the whole model is 1344 GB in bf16, the cut ~55 GB), bf16
               random weights drawn on the card, through
               ``serve.generate``: 8 x 512-token prompts, 32 new tokens
               (MoE drops at capacity factor 1.25; decode routes 8 tokens
               over 256 experts); 0 K2 launches (MLA attends in plain torch,
               as the reference does), 0 K2 bwd, tokens in [0, vocab),
               finite logits, peak memory under 80 GB
 23. train-sharded  phase 12's Yi-6B step (8 of 32 layers, bf16 params,
               fp32 moments, seq 4096, 8 microbatches, flash) through
               ``make_train_step(shard_ctx=...)`` on a 1x1 ("data",
               "model") mesh over one NCCL rank, params, moments and
               batches DTensors placed by the production rules: the first
               step's loss and gnorm within 1e-4 and 1e-3 of phase 12's
               first step (the same weights and batch), K2 and K2 bwd
               launches over its steps equal to phase 12's; step ms (mean of 3
               after 1 warm-up) and peak memory beside phase 12's
 24. train-compress  the same sharded step with top-k (ratio 0.01) and
               with int8 compression, each with error feedback: finite loss
               and gnorm; on a fifth, untimed step, top-k's sent + residual
               equals acc = g + feedback exactly on every leaf, and int8's
               residual is exactly the fp32 acc - sent (fp32 cannot always
               hold the int8 sum back exactly: its deviation is printed);
               step ms and peak memory for each
 25. train-dots  remat "dots" (the unbatched products saved) on phase 12's
               unsharded step: at 2 layers and seq 1024 one step from the
               same weights and batch against "full" (loss, gnorm and each
               attention weight's gradient, phase 12's flash-vs-plain
               limits); at 8 layers step ms and peak memory beside phase
               12's, K2 still launched twice a layer a microbatch (the
               checkpoint recomputes it)
 26. ds-tune   ``python -m repro_torch tune --skip kernel --refit-demo`` through
               its ``main`` with the data on the card: the reference's four
               ds-array sweeps (kmeans 512x32 and 2048x8, rf 1024x16, pca
               256x64, Environment(n_workers=4, mem_limit_mb=64)), the fit,
               two kmeans predictions, the refit demo (retrained, an
               invalidation), the mesh family over 64 chips on the H100's
               constants; every task body ran on the card
               (``taskgraph.BODIES``), K1/K2/K2 bwd launched 0 times, the
               records by source equal the same CLI's with ``--device cpu``,
               a rerun appends nothing, every ds record is tagged as the
               card's (``tune.ds_timing``); then one kmeans sweep whose memory
               limit binds (128x16 at 0.02 MB): measured OOM and pruned
               cells, the pattern as on the CPU
 27. blest     BLEST-ML at the paper's data sizes with the data on the card:
               ``grid_search(..., reuse_measurements=True)`` of kmeans on
               hepmass_like (7,000,000 x 27 float64, 1.51 GB) and pca on
               mnist_like (60,000 x 784, 376 MB) under the MareNostrum 4
               node, Environment(n_workers=48, mem_limit_mb=2048, ram_gb=96)
               (partitions 1..128 a side): each grid, its argmin and
               grid_stats, measured OOM and pruned cells, the sweeps' wall
               seconds and peak memory; the estimator fitted on both sweeps
               (in sample: it reproduces its own labels), and held out: fitted
               on phase 26's card sweeps and the other paper sweep; each
               predicted cell's measured time against the argmin's; a
               4096x64 kmeans on the card against the CPU (centers rtol/atol
               1e-8, labels equal, inertia rtol 1e-8); one ``_center_partial``
               re-executed on the card bit-identical, and a kmeans whose lost
               worker's task re-executes from lineage
 28. evaluate  ``python -m repro_torch evaluate --smoke`` through its
               ``main`` on the card, its report and BENCH_eval.json under a
               temporary directory: the paper's §V protocol over 5 workloads
               x 3 shapes x 3 infrastructure profiles (45 grid-searched
               groups) -- exact-hit rate, exponent distance, speedup over the
               default blocking, leave-one-algorithm-out and
               leave-one-environment-out -- and the closed-loop demo (first
               run by the default, refit, second by the model, the memo
               invalidated); then ``evaluate --skip-loop``, the full cube (4
               shapes up to 4096 x 16, 60 groups); each run: every body on
               the card, 0 kernel launches, both files written, the
               checkout's BENCH_eval.json unchanged
 29. closed-loop  ``AutoTunedRun`` at the paper's sizes with phase 27's
               estimator (in sample): kmeans on the 7,000,000 x 27 HEPMASS
               stand-in and pca on the 60,000 x 784 MNIST stand-in under the
               MareNostrum 4 node, each chosen by the model at phase 27's
               argmin, run, appended to a store; then ``run_elastic`` of
               kmeans on HEPMASS (5 iterations, the node drops to 24 workers
               after 2): partitions, the repartition and its seconds,
               recovery against restart, results close; peak memory
 30. serving   ``python -m repro_torch serve-estimator --demo`` through its
               ``main`` (the demo sweep on the card; 4 shards, 4 clients,
               400 requests, the refit daemon on): every request served, none
               rejected or expired, 0 staleness violations, throughput and
               p50/p95/p99 (host latencies: the router predicts on the host);
               a swap under load: the demo's store and router, 2000 requests
               from 4 clients, a pca sweep made on the card appended after
               500 are served -- the daemon swaps during the load, cold
               queries move to the model, 0 staleness violations;
               ``closed_loop_demo(sharded=True)`` through the router; 0 kernel
               launches over phases 28-30 (``eval_launches``)
serve_model counts one K2 launch per attention-bearing layer of a GQA
model, and none for MLA.
The whole shapes (phases 4, 11, 14, 17, 19-21) are held against the plain
version run in fp32 on the same bf16 inputs by ||got - want|| / ||want||,
since at thousands of keys a row's values are as small as the 3e-2
absolute term of the case checks: over each row (one position and head's
d values) of K2's output within ROW_TOL, and over each batch and head's
[T, d] of dq, dk and dv within HEAD_TOL.  At each of those shapes (but
4's) the check must also reject planted faults: the output with the
columns of its second 64-wide box zeroed past row 1024, with those rows
scaled by 0.9, and, where there is a window, K2 launched without it.
The last three lines are the ``nvidia-smi`` name/power-limit line, the
kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.algorithms import kmeans  # noqa: E402
from repro_torch.algorithms import run as run_algo  # noqa: E402
from repro_torch.configs.workloads import zoo_cases  # noqa: E402
from repro_torch.core.estimator import BlockSizeEstimator  # noqa: E402
from repro_torch.core.gridsearch import grid_powers, grid_search, grid_stats  # noqa: E402
from repro_torch.core.log import ExecutionLog  # noqa: E402
from repro_torch.core.kerneltune import bucket_pow2  # noqa: E402
from repro_torch.data import taskgraph  # noqa: E402
from repro_torch.data.datasets import gaussian_blobs, hepmass_like, mnist_like  # noqa: E402
from repro_torch.data.distarray import DistArray  # noqa: E402
from repro_torch.data.executor import Environment, TaskExecutor, TaskMemoryError  # noqa: E402
from repro_torch.data.logstore import LogStore, timed_copies  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import matmul_blocked as mm  # noqa: E402
from repro_torch.eval.autorun import AutoTunedRun, EnvChange, closed_loop_demo  # noqa: E402
from repro_torch.launch import evaluate as evaluate_launch  # noqa: E402
from repro_torch.launch import serve, serve_estimator, train, tune  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.launch import mesh as mesh_launch  # noqa: E402
from repro_torch.runtime import compress  # noqa: E402
from repro_torch.runtime.elastic import make_plan_mesh, plan_mesh  # noqa: E402
from repro_torch.runtime.fault import FaultPlan, WorkerLoss  # noqa: E402
from repro_torch.runtime.pipeline import DataPipeline, PipelineConfig  # noqa: E402
from repro_torch.runtime.tree import flatten, leaves  # noqa: E402
from repro_torch.runtime.tree import unflatten as tree_unflatten  # noqa: E402
from repro_torch.serve import RefitDaemon, ShardRouter, make_trace, run_load  # noqa: E402
from repro_torch.weights import init_params  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM rate and dense bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# (name, B, T, S, H, KV, d, window, n_meta, causal); blocks 32 as in the
# JAX package's kernel tests
CASES = [
    ("mha", 2, 128, 128, 4, 4, 64, 0, 0, True),
    ("gqa", 2, 128, 128, 4, 2, 64, 0, 0, True),
    ("gqa+window", 2, 128, 128, 8, 2, 32, 32, 0, True),
    ("window+meta", 2, 96, 96, 4, 2, 32, 32, 8, True),
    ("mqa+window", 2, 64, 64, 2, 1, 128, 16, 0, True),
    ("t<s right-aligned", 2, 64, 192, 4, 2, 64, 0, 0, True),
    ("ragged t=s=100", 2, 100, 100, 4, 2, 64, 0, 0, True),
    ("ragged t=75 s=203", 2, 75, 203, 4, 2, 32, 0, 0, True),
    ("d=128", 2, 256, 256, 8, 2, 128, 0, 0, True),
    ("non-causal", 2, 64, 128, 4, 2, 64, 0, 0, False),
    ("window+meta d=64 group 5", 2, 160, 160, 10, 2, 64, 32, 8, True),   # hymba's kinds
    # phi-3-vision's head dim 96 and h2o-danube's 120, on d = 128's layout
    ("d=96 mha", 2, 128, 128, 4, 4, 96, 0, 0, True),
    ("d=96 gqa ragged", 2, 200, 200, 8, 2, 96, 0, 0, True),
    ("d=120 g4 window+meta", 2, 150, 150, 8, 2, 120, 32, 8, True),
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SLICE = dict(B=8, T=512, H=32, KV=4, d=128)      # Yi-6B prefill in the serve run
TRAIN_4K = dict(B=1, T=4096, H=32, KV=32, d=128)  # Yi-6B's train_4k flash case (MHA)
K2_DEFAULT = (128, 128)                          # the serving call's blocks
# tiles the rule refuses, (block_q, block_k, d): a third consumer
# warpgroup, too many accumulators a thread (d = 96 and 120 count as 128),
# S wider than one wgmma
K2_REFUSED = [(256, 64, 128), (64, 256, 128), (128, 256, 64), (512, 512, 32),
              (64, 256, 96), (64, 256, 120)]


# the whole-shape checks (the serving shape, train_4k, each model's prefill
# shape, K2 bwd's timing shapes) hold the error to the size of what it is
# in: a causal row over n keys of N(0, 1) values has |O| near sqrt(e / n),
# ~0.03 at n = 4096, as small as check_close's absolute term, which would
# let a row be wrong by its whole size.  The limits are ||got - want|| /
# ||want|| against the plain version run in fp32 on the same bf16 inputs
# (in bf16 it rounds its scores to bf16 and strays ~1e-2 of a row itself):
# over each row (one position and head's d values) of the forward, and over
# each (batch, head)'s [T, d] of dq, dk and dv, where a row's own norm will
# not do: a row whose true gradient is small (dq of a row that sees one
# key is 0) carries the error of delta = rowsum(dO * O), O in bf16, which
# scales with the row's other terms.  Read on an H100 80GB HBM3 (700 W):
# rows at most 3.653e-03 over every whole shape, heads at most 2.712e-03;
# the limits leave 2.7x and 3.7x
ROW_TOL = 1e-2
HEAD_TOL = 1e-2


def plain_fp32(plain, *tensors, **kw):
    """A plain version run in fp32 on bf16 inputs, its result in fp32."""
    return plain(*(x.float() for x in tensors), **kw)


def excess(got, want, tol):
    """The largest error over assert_allclose(rtol=tol, atol=tol)'s limit."""
    got, want = got.float(), want.float()
    return ((got - want).abs() - (tol + tol * want.abs())).max().item()


def check_close(name, got, want, tol):
    """assert_allclose(rtol=tol, atol=tol), as the JAX package's tests hold it."""
    max_err = (got.float() - want.float()).abs().max().item()
    if not (excess(got, want, tol) <= 0 and torch.isfinite(got).all()):
        raise SystemExit(f"[kernel] {name}: max abs err {max_err:.3e} over tol {tol}")
    return max_err


def rel_error(got, want, dim=-1):
    """The largest ||got - want|| / ||want|| over ``dim``: the last (a row),
    or (1, 3) of [B, T, H, d] (a batch and head's [T, d])."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=dim) / want.norm(dim=dim).clamp_min(1e-30)).max().item()


def check_rel(name, got, want, tol, dim=-1):
    """Every row (or head, by ``dim``) within ``tol`` of its own norm;
    returns (the largest such error, max abs err)."""
    rel = rel_error(got, want, dim)
    max_err = (got.float() - want.float()).abs().max().item()
    if not (rel <= tol and torch.isfinite(got).all()):
        raise SystemExit(f"[kernel] {name}: an error is {rel:.3e} of its "
                         f"{'row' if dim == -1 else 'head'}'s norm, over {tol} (max abs "
                         f"err {max_err:.3e})")
    return rel, max_err


def rand(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def qkv(gen, b, t, s, h, kv, d, dtype, device):
    return (rand(gen, (b, t, h, d), dtype, device),
            rand(gen, (b, s, kv, d), dtype, device),
            rand(gen, (b, s, kv, d), dtype, device))


def time_ms(fn, iters=50, warmup=5):
    """Mean ms per call, by CUDA events around ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_probe():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[probe] {smi}; capability {torch.cuda.get_device_capability(device)}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return device, smi


def _short_name(mangled):
    """'matmul_blocked_kernel<bf16,128,64>' from the mangled template name
    (the wgmma kernels take bf16 only)."""
    ints = re.findall(r"Li(\d+)E", mangled)
    dtype = "bf16" if "bfloat16" in mangled or "wgmma" in mangled else "fp32"
    found = re.search(r"([a-z_]+_kernel)I", mangled)
    base = found.group(1) if found else mangled
    return f"{base}<{','.join([dtype] + ints)}>"


def _cuobjdump():
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(found).exists():
        return found
    import triton
    return str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump")


def sass_counts(library, opcodes=("HGMMA", "UTMALDG")):
    """{kernel: {opcode: count}} from ``cuobjdump -sass`` of a built library."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            current = counts.setdefault(found.group(1), dict.fromkeys(opcodes, 0))
        elif current is not None:
            for op in opcodes:
                current[op] += len(re.findall(rf"\b{op}\b", line))
    return counts


def flash_work(b, t, s, h, kv, d, causal=True, dtype_bytes=2, window=0, n_meta=0):
    """(flops, bytes) the function needs: each live (query, key) pair costs
    a d-long dot product and a d-long update, 2 flops per multiply-add; q
    and k, v read once, o written once.  A window keeps the ``window`` keys
    up to each query's own, and the ``n_meta`` first keys beside them."""
    if causal:
        live = 0
        for r in range(t):
            hi = max(0, r + s - t + 1)             # the row sees keys [0, hi)
            lo = max(0, hi - window) if window else 0
            live += hi - lo + min(n_meta, lo)
    else:
        live = t * s
    return 4 * d * live * b * h, (2 * b * t * h + 2 * b * s * kv) * d * dtype_bytes


def bound(flops, nbytes, dtype=torch.bfloat16):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    return bound_ms, bound_by, t_bytes, t_ops


def phase_build():
    libs = [fa.LIBRARY, mm.LIBRARY, fa.LIBRARY_BWD]
    t0 = time.perf_counter()
    paths = _build.build_many(libs)
    sources = [src for lib in libs for src in lib.sources]
    print(f"[build] {len(sources)} sources of {len(libs)} libraries in parallel: "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    bad = []
    for source in sources:
        log = _build.build_logs.get(source, "")
        if "setmaxnreg ignored" in log:
            bad.append(f"{source}: ptxas ignored setmaxnreg")
        report = _build.ptxas_report(log)
        for name, info in sorted(report.items(), key=lambda kv: _short_name(kv[0])):
            regs = info.get("registers")
            st, ld = info.get("spill_stores", 0), info.get("spill_loads", 0)
            print(f"[build]   {source}: {_short_name(name):<40} "
                  f"registers {regs} spill stores {st} loads {ld}")
            if st or ld:
                bad.append(f"spills in {_short_name(name)}")
    for dtype_bytes, tiles in mm.INSTANTIATED.items():
        if sorted(mm.compiled_tiles(dtype_bytes)) != sorted(tiles):
            bad.append(f"compiled tiles {mm.compiled_tiles(dtype_bytes)} differ from "
                       f"the rule's {tiles}")
    for bm, bn in mm.INSTANTIATED[2]:
        for bk in (64, 128, 256, 448, 512):
            want = int(mm.smem_bytes(bm, bn, bk)) if mm.fits(bm, bn, bk) else -1
            if mm.launch_smem(bm, bn, bk) != want:
                bad.append(f"bf16 {(bm, bn, bk)}: the library asks {mm.launch_smem(bm, bn, bk)} "
                           f"bytes of shared memory, the rule {want}")
    for dtype_bytes, tiles in fa.INSTANTIATED.items():
        if sorted(fa.compiled_tiles(dtype_bytes)) != sorted(tiles):
            bad.append(f"compiled K2 tiles {fa.compiled_tiles(dtype_bytes)} differ "
                       f"from the rule's {tiles}")
        for bq, bk, d in tiles:
            want = int(fa.smem_bytes(bq, bk, d, dtype_bytes))
            if fa.launch_smem(bq, bk, d, dtype_bytes) != want:
                bad.append(f"K2 {(bq, bk, d)} ({dtype_bytes}-byte): the library asks "
                           f"{fa.launch_smem(bq, bk, d, dtype_bytes)} bytes of shared "
                           f"memory, the rule {want}")
    for bq, bk, d in K2_REFUSED:
        if fa.fits(bq, bk, d) or fa.launch_smem(bq, bk, d) != -1:
            bad.append(f"K2 {(bq, bk, d)} is compiled or admitted by the rule")
    for dtype_bytes in (2, 4):
        for d in fa.HEAD_DIMS:
            for kernel in fa.BWD_KERNELS:
                want = int(fa.bwd_smem_bytes(d, kernel, dtype_bytes))
                got = fa.bwd_launch_smem(d, kernel, dtype_bytes)
                if got != want:
                    bad.append(f"K2 bwd {kernel} d={d} ({dtype_bytes}-byte): the library "
                               f"asks {got} bytes of shared memory, the rule {want}")
    for d in BWD_REFUSED_DIMS:
        if fa.bwd_launch_smem(d, "dkdv") != -1:
            bad.append(f"K2 bwd d={d} is compiled")
    for path, kernel, n_tiles in ((paths[1], "matmul_wgmma_kernel", len(mm.INSTANTIATED[2])),
                                  (paths[0], "flash_wgmma_kernel", len(fa.INSTANTIATED[2])),
                                  (paths[2], "dkdv_wgmma_kernel", len(fa.HEAD_DIMS)),
                                  (paths[2], "dq_wgmma_kernel", len(fa.HEAD_DIMS))):
        sass = {name: c for name, c in sass_counts(path).items() if kernel in name}
        for name, c in sorted(sass.items(), key=lambda kv: _short_name(kv[0])):
            print(f"[build]   sass {_short_name(name):<40} HGMMA {c['HGMMA']} "
                  f"UTMALDG {c['UTMALDG']}")
            if not (c["HGMMA"] and c["UTMALDG"]):
                bad.append(f"{_short_name(name)} lacks HGMMA or UTMALDG")
        if len(sass) != n_tiles:
            bad.append(f"{len(sass)} {kernel} kernels in the SASS, {n_tiles} compiled tiles")
    if bad:
        raise SystemExit(f"[build] {bad}")
    print(f"[build] matmul_blocked: {len(mm.INSTANTIATED[4])} fp32 tiles on CUDA cores, "
          f"{len(mm.INSTANTIATED[2])} bf16 tiles on wgmma + TMA; flash_attention: "
          f"{len(fa.INSTANTIATED[4])} fp32 kernels on CUDA cores, "
          f"{len(fa.INSTANTIATED[2])} bf16 tiles on wgmma + TMA; flash_attention_bwd: "
          f"at d {fa.HEAD_DIMS}, bf16 dK/dV and dQ kernels on wgmma + TMA (64-row tiles), "
          "fp32 dK/dV and dQ kernels on CUDA cores, a delta pre-pass for each dtype; "
          "HGMMA and UTMALDG in each bf16 kernel of K1, K2 and K2 bwd; no spills; tiles "
          "and shared memory as the rules say", flush=True)


def phase_kernel(device):
    gen = torch.Generator(device=device).manual_seed(0)
    bf16, fp32 = torch.bfloat16, torch.float32
    n_tiles = worst = 0
    for name, b, t, s, h, kv, d, win, meta, causal in CASES:
        kw = dict(window=win, n_meta=meta, causal=causal)
        q, k, v = qkv(gen, b, t, s, h, kv, d, bf16, device)
        want = fa.flash_attention_plain(q, k, v, scale=d ** -0.5, **kw)
        by_bk, errs = {}, []
        for bq, bk, dd in fa.INSTANTIATED[2]:
            if dd != d:
                continue
            got = ops.flash_attention(q, k, v, block_q=bq, block_k=bk, **kw)
            errs.append(check_close(f"{name} bf16 tile {(bq, bk)}", got, want, TOL[bf16]))
            # each row's arithmetic does not depend on block_q
            if not torch.equal(got, by_bk.setdefault(bk, got)):
                raise SystemExit(f"[kernel] {name} tile {(bq, bk)} differs from "
                                 f"tile {(64, bk)}")
            n_tiles += 1
        first = next(iter(by_bk.values()))
        across_bk = max(check_close(f"{name} across block_k", o, first, TOL[bf16])
                        for o in by_bk.values())
        q, k, v = (x.to(fp32) for x in (q, k, v))
        got = ops.flash_attention(q, k, v, block_q=32, block_k=32, **kw)
        want = fa.flash_attention_plain(q, k, v, scale=d ** -0.5, **kw)
        err32 = check_close(f"{name} fp32", got, want, TOL[fp32])
        worst = max(worst, *errs)
        print(f"[kernel] {name:<18} bf16 {len(errs)} tiles max abs err {max(errs):.3e} "
              f"(tol 3e-2), bit-identical across block_q, {across_bk:.3e} across "
              f"block_k; fp32 {err32:.3e} (tol 2e-5)")
    # P as wgmma's A fragment: with a window of 1 each row of P holds one
    # nonzero (1, at the row's own key), so every row must read back its
    # own v bit for bit at every tile, whatever column its key falls in
    for bq, bk, d in fa.INSTANTIATED[2]:
        q, k, v = qkv(gen, 2, 256, 256, 4, 2, d, bf16, device)
        got = ops.flash_attention(q, k, v, window=1, block_q=bq, block_k=bk)
        if not torch.equal(got, v.repeat_interleave(2, dim=2)):
            raise SystemExit(f"[kernel] one nonzero per row: tile {(bq, bk, d)} does "
                             "not read back each row's own v")
    print(f"[kernel] one nonzero per row of P: all {len(fa.INSTANTIATED[2])} bf16 tiles "
          "read back each row's own v bit for bit")
    for bq, bk, d in K2_REFUSED:
        q, k, v = qkv(gen, 1, 512, 512, 2, 1, d, bf16, device)
        try:
            ops.flash_attention(q, k, v, block_q=bq, block_k=bk)
        except ValueError:
            continue
        raise SystemExit(f"[kernel] refused tile {(bq, bk, d)} did not raise")
    print(f"[kernel] {n_tiles} (case, tile) launches of bf16 within 3e-2 of plain "
          f"(max abs err {worst:.3e}); {len(K2_REFUSED)} refused tiles raised ValueError")
    # the serving shape itself
    dt = torch.bfloat16
    q, k, v = qkv(gen, SLICE["B"], SLICE["T"], SLICE["T"], SLICE["H"],
                  SLICE["KV"], SLICE["d"], dt, device)
    got = ops.flash_attention(q, k, v)
    want = plain_fp32(fa.flash_attention_plain, q, k, v, scale=SLICE["d"] ** -0.5)
    rel, err = check_rel("serving shape", got, want, ROW_TOL)
    print(f"[kernel] serving shape q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 "
          f"default tile {K2_DEFAULT} max row err {rel:.3e} of the row's norm (tol "
          f"{ROW_TOL}), max abs err {err:.3e}", flush=True)
    print("[kernel] kernels checked against their plain versions: flash_attention_fwd "
          "(bf16 wgmma, fp32 CUDA cores)")
    return q, k, v, max(err, worst)


def time_flash(name, q, k, v, iters, plain_iters):
    """K2 at the default tile and at every compiled tile of the head dim,
    its plain version, SDPA and the bound, at one causal shape."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    tile_ms = {}
    for bq, bk, dd in fa.INSTANTIATED[2]:
        if dd == d:
            tile_ms[(bq, bk)] = time_ms(lambda: ops.flash_attention(
                q, k, v, block_q=bq, block_k=bk), iters=iters)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, scale=d ** -0.5),
                       iters=plain_iters, warmup=1)
    # the yardstick takes [B,H,T,d]; the copies are made outside the timing
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=kv != h)
    library_ms = time_ms(sdpa, iters=iters)
    flops, nbytes = flash_work(b, t, s, h, kv, d)
    bound_ms, bound_by, t_bytes, t_ops = bound(flops, nbytes)
    best = min(tile_ms, key=tile_ms.get)
    for tile, ms in tile_ms.items():
        print(f"[timing] {name} tile {tile}: kernel_ms={ms:.4f} "
              f"({flops / ms / 1e9:.2f} TFLOP/s, {bound_ms / ms:.4f} of the bound)"
              f"{' default' if tile == K2_DEFAULT else ''}{' best' if tile == best else ''}")
    print(f"[timing] {name} q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal: "
          f"kernel_ms={tile_ms[K2_DEFAULT]:.4f} at default tile {K2_DEFAULT}, "
          f"{tile_ms[best]:.4f} at best tile {best}; plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (sdpa, {bound_ms / library_ms:.4f} of the bound) "
          f"bound_ms={bound_ms:.5f} by {bound_by} ({nbytes / 1e6:.1f} MB -> "
          f"{t_bytes:.5f} ms, {flops / 1e9:.2f} GFLOP -> {t_ops:.5f} ms)", flush=True)
    return dict(ms=tile_ms[K2_DEFAULT], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, tile=list(K2_DEFAULT),
                best_tile=list(best), best_tile_ms=tile_ms[best],
                share_of_bound=bound_ms / tile_ms[K2_DEFAULT])


def phase_timing(q, k, v, device):
    times = time_flash("serving", q, k, v, iters=50, plain_iters=50)
    gen = torch.Generator(device=device).manual_seed(4)
    c = TRAIN_4K
    q4, k4, v4 = qkv(gen, c["B"], c["T"], c["T"], c["H"], c["KV"], c["d"],
                     torch.bfloat16, device)
    got = ops.flash_attention(q4, k4, v4)
    rel, err = check_rel("train_4k", got, plain_fp32(
        fa.flash_attention_plain, q4, k4, v4, scale=c["d"] ** -0.5), ROW_TOL)
    print(f"[timing] train_4k flash shape max row err {rel:.3e} of the row's norm (tol "
          f"{ROW_TOL}), max abs err {err:.3e}")
    times["train_4k"] = time_flash("train_4k", q4, k4, v4, iters=20, plain_iters=3)
    return times


def phase_model(device):
    cfg = get_config("yi-6b").replace(n_layers=2, param_dtype="float32",
                                      compute_dtype="float32")
    gen = torch.Generator(device=device).manual_seed(1)
    params = init_params(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab, (2, 512), generator=gen, device=device)
    with torch.inference_mode():
        a, *_ = tfm.model_forward(cfg, params, tokens, use_flash=False)
        b, *_ = tfm.model_forward(cfg, params, tokens, use_flash=True)
    err = check_close("model flash vs plain", b, a, 2e-3)
    print(f"[model] yi-6b widths, 2 layers, fp32, 2x512 tokens: logits "
          f"{tuple(b.shape)}, max abs err flash vs plain {err:.3e} (tol 2e-3)",
          flush=True)
    del params, a, b
    torch.cuda.empty_cache()


def phase_serve():
    cfg = get_config("yi-6b")
    argv = ["--arch", "yi-6b", "--preset", "full", "--batch", "8",
            "--prompt-len", "512", "--gen-len", "32"]
    torch.cuda.reset_peak_memory_stats()
    report = {}
    fa.launches = fa.bwd_launches = 0
    out = serve.main(argv, report=report)
    launches = fa.launches
    if fa.bwd_launches:
        raise SystemExit(f"[serve] {fa.bwd_launches} K2 bwd launches in inference")
    # decode never calls the kernel, so every launch of the run is prefill's
    if launches != cfg.n_layers:
        raise SystemExit(f"[serve] {launches} kernel launches, expected {cfg.n_layers}")
    if not (0 <= int(out.min()) and int(out.max()) < cfg.vocab):
        raise SystemExit("[serve] token outside [0, vocab)")
    if not report["logits_finite"]:
        raise SystemExit("[serve] non-finite logits")
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] yi-6b full bf16 batch 8 x 512 prompt, 32 new: "
          f"prefill_ms={report['prefill_ms']:.2f} "
          f"decode_ms_per_step={report['decode_ms_per_step']:.3f} "
          f"tokens_per_s={report['tokens_per_s']:.1f} "
          f"peak_mem_gb={peak / 1e9:.3f} flash_launches={launches}", flush=True)
    return launches


# K1 checks: the JAX package's kernel-test shapes (m, k, n) and three ragged
# ones ((100, 60, 36) also misaligns K and N for TMA; at 1200 rows the bf16
# block order ends in a partial group of M tiles), fp32 at its 1e-4 rtol /
# 1e-3 atol and bf16 at 5e-2
K1_SHAPES = [(128, 128, 128), (256, 128, 64), (100, 60, 36), (32, 512, 96),
             (1000, 300, 777), (1200, 72, 136)]
K1_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (5e-2, 5e-2)}
K1_BKS = (16, 64, 128, 256)
K1_SLICE = (4096, 4096, 11008)         # Yi-6B ffn_up at train_4k, bf16
DEFAULT_TILE = (128, 128, 128)
# bk 64 is outside the tuner's sweep (128, 256, 512); at 64 the bf16 ring of
# (128, 256) holds 4 stages, at 128 only 2.  Phase 9 times it beside the
# tuned tile, to show what the kernel does with a deeper ring.
SHALLOW_TILE = (128, 256, 64)


def check_close_k1(name, got, want, rtol, atol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    excess = (err - (atol + rtol * want.abs())).max().item()
    if not (excess <= 0 and torch.isfinite(got).all()):
        raise SystemExit(f"[k1] {name}: max abs err {err.max().item():.3e} over "
                         f"rtol {rtol} atol {atol}")
    return err.max().item()


def phase_k1(device):
    """Every compiled tile of both dtypes at every bk on every shape: within
    tolerance of plain, and, since every tile sums each output in the same
    k order, bit-identical to the other tiles of its dtype."""
    gen = torch.Generator(device=device).manual_seed(2)
    worst = 0.0
    for dtype, (rtol, atol) in K1_TOL.items():
        size = torch.tensor([], dtype=dtype).element_size()
        for m, k, n in K1_SHAPES:
            a, b = rand(gen, (m, k), dtype, device), rand(gen, (k, n), dtype, device)
            want = mm.matmul_blocked_plain(a, b)
            first, ran, refused, sweep = None, 0, 0, 0.0
            for bm, bn in mm.INSTANTIATED[size]:
                for bk in K1_BKS:
                    # the wrapper clamps each block to its dimension first
                    if not mm.fits(min(bm, m), min(bn, n), min(bk, k), size):
                        try:
                            ops.matmul(a, b, block_m=bm, block_n=bn, block_k=bk)
                        except ValueError:
                            refused += 1
                            continue
                        raise SystemExit(f"[k1] infeasible tile {(bm, bn, bk)} did not raise")
                    got = ops.matmul(a, b, block_m=bm, block_n=bn, block_k=bk)
                    sweep = max(sweep, check_close_k1(f"({m},{k},{n}) tile {(bm, bn, bk)} "
                                                      f"{dtype}", got, want, rtol, atol))
                    if first is None:
                        first = got
                    elif not torch.equal(got, first):
                        raise SystemExit(f"[k1] ({m},{k},{n}) tile {(bm, bn, bk)} {dtype} "
                                         "differs from the first tile's result")
                    ran += 1
            print(f"[k1] ({m},{k},{n}) {str(dtype):<15} {ran} (tile, bk) launches agree "
                  f"with plain and bit for bit with each other; {refused} infeasible "
                  f"ones raised ValueError; max abs err {sweep:.3e} "
                  f"(rtol {rtol} atol {atol})", flush=True)
            worst = max(worst, sweep)
    m, k, n = K1_SLICE
    dt = torch.bfloat16
    a, b = rand(gen, (m, k), dt, device), rand(gen, (k, n), dt, device)
    got = ops.matmul(a, b, block_m=DEFAULT_TILE[0], block_n=DEFAULT_TILE[1],
                     block_k=DEFAULT_TILE[2])
    err = check_close_k1(f"yi-6b ffn_up {K1_SLICE}", got, mm.matmul_blocked_plain(a, b),
                         *K1_TOL[dt])
    print(f"[k1] yi-6b ffn_up (m,k,n)={K1_SLICE} bf16 tile {DEFAULT_TILE} max abs err "
          f"{err:.3e} (rtol/atol 5e-2)", flush=True)
    print("[k1] kernels checked against their plain versions: matmul_blocked "
          "(fp32 CUDA cores, bf16 wgmma)")
    return max(worst, err)


def phase_tune():
    """The tuning loop on the card, through the CLI's ``main``."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--skip", "ds", "mesh", "--arch", "yi-6b", "--backend", "wallclock",
                "--device", "cuda", "--store", str(Path(tmp) / "tune_store.jsonl")]
        mm.launches = fa.launches = 0
        result = tune.main(argv)
        launches = {"matmul": mm.launches, "flash": fa.launches}
    stats, report = result["backend"], result["eval"]
    reps = stats["reps"]
    if stats["verify_failures"] != 0:
        raise SystemExit(f"[tune] {stats['verify_failures']} tiles failed verification")
    for kernel, name in (("matmul", "K1"), ("flash", "K2")):
        measured = stats["measured_by"][kernel]
        if measured == 0 or launches[kernel] < measured * reps:
            raise SystemExit(f"[tune] {launches[kernel]} {name} launches for {measured} "
                             f"measured {kernel} tiles x {reps} reps")
    predicted = result["predicted"]
    flash = {k: t for k, t in predicted.items() if k.endswith("/flash")}
    if (len(predicted) != 14 or len(flash) != 2
            or not all(len(t) == (2 if k in flash else 3) for k, t in predicted.items())):
        raise SystemExit(f"[tune] expected 12 (bm, bn, bk) and 2 (bq, bk) tiles, "
                         f"got {predicted}")
    ov = report["overall"]
    print(f"[tune] eval yi-6b 14 cases (12 GEMM on K1, 2 flash on K2) on the card: "
          f"geomean_speedup_vs_costmodel={ov['geomean_speedup_vs_costmodel']:.4f} "
          f"argmin_hit_rate={ov['argmin_hit_rate']:.4f} "
          f"mean_regret_vs_best={ov['mean_regret_vs_best']:.4f} "
          f"wall_s={result['wall_s']:.1f} measured_tiles={stats['measured']} "
          f"(matmul {stats['measured_by']['matmul']}, flash "
          f"{stats['measured_by']['flash']}) verified={stats['verified']} "
          f"verify_failures={stats['verify_failures']} k1_launches={launches['matmul']} "
          f"k2_launches={launches['flash']}", flush=True)
    cases = {c.label: c for c in zoo_cases(["yi-6b"])}
    for r in report["rows"]:
        m, k, n = (bucket_pow2(x) for x in r["shape"])      # the shape timed
        if r["kernel"] == "flash":
            c = cases[r["label"]]
            m, n = bucket_pow2(c.m), bucket_pow2(c.n)
            flops, nbytes = flash_work(c.batch, m, n, c.heads, c.heads, c.k, c.causal)
            shape = f"(t,d,s)=({m},{k},{n}) heads {c.heads}"
            bound_ms = bound(flops, nbytes)[0]
            extra = f", {bound_ms / (r['t_best'] * 1e3):.4f} of the {bound_ms:.5f} ms bound"
        else:
            flops, shape, extra = 2 * m * k * n, f"(m,k,n)=({m},{k},{n})", ""
        print(f"[tune]   {r['label']:<26} bucket {shape} "
              f"pred={tuple(r['pred'])} {r['t_pred'] * 1e3:.4f} ms, "
              f"cost-model={tuple(r['cost_tile'])} {r['t_cost_model'] * 1e3:.4f} ms, "
              f"best={tuple(r['argmin_tile'])} {r['t_best'] * 1e3:.4f} ms "
              f"({flops / r['t_best'] / 1e12:.2f} TFLOP/s{extra})")
    row = next(r for r in report["rows"] if r["label"] == "yi-6b/train_4k/ffn_up")
    return launches, tuple(row["argmin_tile"])


def phase_k1_timing(device, best_tile):
    m, k, n = K1_SLICE
    gen = torch.Generator(device=device).manual_seed(3)
    a = rand(gen, (m, k), torch.bfloat16, device)
    b = rand(gen, (k, n), torch.bfloat16, device)
    tiles = {"default": DEFAULT_TILE, "best": tuple(best_tile), "shallow": SHALLOW_TILE}
    ms = {}
    for key, (bm, bn, bk) in tiles.items():
        ms[key] = time_ms(lambda: ops.matmul(a, b, block_m=bm, block_n=bn,
                                             block_k=bk), iters=20, warmup=3)
    plain_ms = time_ms(lambda: mm.matmul_blocked_plain(a, b), iters=5, warmup=1)
    library_ms = time_ms(lambda: torch.matmul(a, b), iters=20, warmup=3)
    flops = 2 * m * n * k
    nbytes = (m * k + k * n + m * n) * a.element_size()
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    tflops = flops / ms["best"] / 1e9
    share = bound_ms / ms["best"]
    print(f"[k1-timing] (m,k,n)={K1_SLICE} bf16: kernel_ms={ms['best']:.4f} at best "
          f"tile {tiles['best']} ({tflops:.2f} TFLOP/s, {share:.4f} of the bound), "
          f"{ms['default']:.4f} at default tile {DEFAULT_TILE} "
          f"({flops / ms['default'] / 1e9:.2f} TFLOP/s), {ms['shallow']:.4f} at "
          f"{SHALLOW_TILE} ({flops / ms['shallow'] / 1e9:.2f} TFLOP/s, "
          f"{bound_ms / ms['shallow']:.4f} of the bound); plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (torch.matmul, {flops / library_ms / 1e9:.2f} "
          f"TFLOP/s, {bound_ms / library_ms:.4f} of the bound) bound_ms={bound_ms:.5f} "
          f"by {bound_by} ({nbytes / 1e6:.1f} MB -> {t_bytes:.5f} ms, "
          f"{flops / 1e9:.1f} GFLOP -> {t_ops:.5f} ms)", flush=True)
    return dict(ms=ms["best"], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, tile=list(tiles["best"]),
                default_tile_ms=ms["default"], shallow_tile_ms=ms["shallow"],
                tflops=tflops, share_of_bound=share)


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}   # x max |grad|
# phase 3's cases and causal T > S, where the first T - S rows see no key
# (the forward is not held to the oracle on such rows, the gradient is)
BWD_CASES = CASES + [
    ("t>s causal", 2, 160, 96, 4, 2, 64, 0, 0, True),
    ("t>s ragged window", 2, 100, 70, 4, 2, 128, 16, 4, True),
    # d = 128 with GQA, T = S a multiple of no tile; and with a window and a
    # meta prefix
    ("d=128 ragged t=s=200", 2, 200, 200, 8, 2, 128, 0, 0, True),
    ("d=128 window+meta", 2, 160, 160, 4, 2, 128, 32, 8, True),
]
# head dims K2 bwd does not compile: no config of the zoo has them (every
# config's is in fa.HEAD_DIMS), and each would need a layout of its own
BWD_REFUSED_DIMS = (48, 80)


def check_grads(name, got, want, tol):
    """Each of dq, dk, dv within ``tol`` times the largest entry of its
    plain version; returns (max abs err, max err relative to that entry)."""
    abs_err = rel_err = 0.0
    for g, w, which in zip(got, want, ("dq", "dk", "dv")):
        err = (g.float() - w.float()).abs().max().item()
        top = w.float().abs().max().item()
        if not (err <= tol * top and torch.isfinite(g).all()):
            raise SystemExit(f"[k2-bwd] {name} {which}: max abs err {err:.3e} over "
                             f"{tol} x max |{which}| {top:.3e}")
        abs_err, rel_err = max(abs_err, err), max(rel_err, err / top)
    return abs_err, rel_err


def phase_k2_bwd(device):
    """K2 bwd against its plain version on BWD_CASES, in both dtypes."""
    gen = torch.Generator(device=device).manual_seed(5)
    worst_abs, worst_rel = {}, {}
    for name, b, t, s, h, kv, d, win, meta, causal in BWD_CASES:
        kw = dict(scale=d ** -0.5, window=win, n_meta=meta, causal=causal)
        for dtype, tol in BWD_TOL.items():
            q, k, v = qkv(gen, b, t, s, h, kv, d, dtype, device)
            g = rand(gen, q.shape, dtype, device)
            o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            if not torch.equal(o, fa.flash_attention_cuda(q, k, v, **kw)):
                raise SystemExit(f"[k2-bwd] {name} {dtype}: the forward with lse "
                                 "differs from the forward without")
            got = fa.flash_attention_bwd_cuda(q, k, v, o, g, lse, **kw)
            again = fa.flash_attention_bwd_cuda(q, k, v, o, g, lse, **kw)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise SystemExit(f"[k2-bwd] {name} {dtype}: two launches differ")
            want = fa.flash_attention_bwd_plain(q, k, v, o, g, **kw)
            err = check_grads(f"{name} {dtype}", got, want, tol)
            worst_abs[dtype] = max(worst_abs.get(dtype, 0.0), err[0])
            worst_rel[dtype] = max(worst_rel.get(dtype, 0.0), err[1])
            print(f"[k2-bwd] {name:<18} {str(dtype):<15} max abs err {err[0]:.3e}, "
                  f"{err[1]:.3e} of max |grad| (tol {tol}); bit-identical across two "
                  "launches; forward with lse bit-identical", flush=True)
    # through the autograd Function, as training calls it
    q, k, v = (x.requires_grad_(True) for x in qkv(gen, 2, 128, 128, 4, 2, 64,
                                                    torch.bfloat16, device))
    g = rand(gen, q.shape, torch.bfloat16, device)
    before = fa.bwd_launches
    ops.flash_attention(q, k, v).backward(g)
    o, lse = fa.flash_attention_cuda(q.detach(), k.detach(), v.detach(), scale=64 ** -0.5,
                                     return_lse=True)
    direct = fa.flash_attention_bwd_cuda(q.detach(), k.detach(), v.detach(), o, g, lse,
                                         scale=64 ** -0.5)
    if fa.bwd_launches != before + 2 or not all(
            torch.equal(x.grad, y) for x, y in zip((q, k, v), direct)):
        raise SystemExit("[k2-bwd] the autograd Function's gradients are not the kernel's")
    for d in BWD_REFUSED_DIMS:
        q, k, v = qkv(gen, 1, 64, 64, 2, 1, d, torch.bfloat16, device)
        lse = torch.zeros(1, 2, 64, device=device)
        try:
            fa.flash_attention_bwd_cuda(q, k, v, q, q, lse, scale=1.0)
        except ValueError:
            continue
        raise SystemExit(f"[k2-bwd] head dim {d} did not raise")
    print(f"[k2-bwd] {len(BWD_CASES)} cases x 2 dtypes within tolerance: fp32 max "
          f"{worst_rel[torch.float32]:.3e}, bf16 max {worst_rel[torch.bfloat16]:.3e} of "
          f"max |grad|; the autograd Function's gradients are the kernel's bit for bit; "
          f"head dims {BWD_REFUSED_DIMS} raised ValueError", flush=True)
    print("[k2-bwd] kernels checked against their plain versions: flash_attention_bwd "
          "(bf16 on wgmma + TMA, fp32 on CUDA cores)")
    return worst_abs[torch.bfloat16], worst_rel


# phase 11: K2 bwd at train_4k as the train run calls it (Yi-6B's GQA), and
# at phi-3-vision's (d = 96, MHA) and h2o-danube's (d = 120, group 4, its
# window of 4096, which at T = 4096 masks nothing) train_4k flash shapes:
# (key, B, T, H, KV, d, window)
BWD_TIMING = [("train_4k", 1, 4096, 32, 4, 128, 0),
              ("phi3_train_4k", 1, 4096, 32, 32, 96, 0),
              ("h2o_train_4k", 1, 4096, 32, 8, 120, 4096)]


def time_k2_bwd(name, b, t, h, kvh, d, window, device, seed):
    """K2 bwd at one causal shape beside its plain version, SDPA's backward
    and the bound: 2.5 times the forward's products (S recomputed, dV, dP,
    dK and dQ, each d-long per live pair, on the real d), q, k, v, o, dO and
    lse read once and dq, dk, dv written once."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = qkv(gen, b, t, t, h, kvh, d, torch.bfloat16, device)
    g = rand(gen, q.shape, torch.bfloat16, device)
    kw = dict(scale=d ** -0.5, window=window)
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, g, lse, **kw)
    want = plain_fp32(fa.flash_attention_bwd_plain, q, k, v, o, g, **kw)
    err = check_grads(name, got, want, BWD_TOL[torch.bfloat16])
    heads = max(check_rel(f"{name} {which}", x, y, HEAD_TOL, dim=(1, 3))[0]
                for x, y, which in zip(got, want, ("dq", "dk", "dv")))
    for x, y, which in zip(got, want, ("dq", "dk", "dv")):
        planted_faults(f"k2-bwd-timing {name} {which}", x, y, HEAD_TOL, dim=(1, 3))
    del got, want
    kernel_ms = time_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, o, g, lse, **kw),
                        iters=5, warmup=2)
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, g, **kw),
                       iters=3, warmup=1)
    # the yardstick: SDPA's backward alone, its forward's graph kept (the
    # window masks nothing at these shapes, so it is the causal mask)
    assert window == 0 or window >= t
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=kvh != h)
    gt = g.transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                                     retain_graph=True), iters=20)
    fwd_flops, _ = flash_work(b, t, t, h, kvh, d, window=window)
    flops = 2.5 * fwd_flops
    nbytes = (2 * (3 * b * t * h * d + 2 * b * t * kvh * d)    # q, o, dO; k, v (bf16)
              + 4 * b * h * t                                  # lse (fp32)
              + 2 * (b * t * h * d + 2 * b * t * kvh * d))     # dq; dk, dv (bf16)
    bound_ms, bound_by, t_bytes, t_ops = bound(flops, nbytes)
    print(f"[k2-bwd-timing] {name} q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal"
          f"{f' window {window}' if window else ''}: "
          f"kernel_ms={kernel_ms:.4f} ({flops / kernel_ms / 1e9:.2f} TFLOP/s, "
          f"{bound_ms / kernel_ms:.4f} of the bound) plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (SDPA backward, {bound_ms / library_ms:.4f} of "
          f"the bound) bound_ms={bound_ms:.5f} by {bound_by} ({nbytes / 1e6:.1f} MB -> "
          f"{t_bytes:.5f} ms, {flops / 1e9:.2f} GFLOP -> {t_ops:.5f} ms); max abs err "
          f"{err[0]:.3e}, {err[1]:.3e} of max |grad|, max head err {heads:.3e} of the "
          f"head's norm (tol {HEAD_TOL})", flush=True)
    del q, k, v, g, o, lse, qt, kt, vt, out, gt
    torch.cuda.empty_cache()
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, share_of_bound=bound_ms / kernel_ms)


def phase_k2_bwd_timing(device):
    """K2 bwd at each BWD_TIMING shape; the first's readings are the
    record's own keys, the others' come under ``<key>_*``."""
    times = {}
    for i, (key, b, t, h, kvh, d, window) in enumerate(BWD_TIMING):
        got = time_k2_bwd(key, b, t, h, kvh, d, window, device, seed=6 + i)
        times.update(dict(got, shape=key) if i == 0 else
                      {f"{key}_{k}": v for k, v in got.items()})
    return times


TRAIN = dict(layers=8, seq=4096, batch=8, micro=8, warmup_steps=1, timed_steps=3)
TRAIN_CHECK = dict(layers=2, seq=1024, batch=8, micro=8)
# the flash-vs-plain step at Yi-6B's widths (d = 128), then at phi-3-vision's
# (d = 96; 576 image embeddings and 448 text tokens a sequence) and
# h2o-danube's (d = 120, GQA group 4, the window cut from 4096 to 512 so
# that it masks at seq 1024): (arch, config replacements)
TRAIN_CHECKS = [("yi-6b", {}), ("phi-3-vision-4.2b", {}),
                ("h2o-danube-3-4b", dict(windows=(512, 512)))]
# flash vs plain attention, one step from the same bf16 weights, relative
# differences: the loss (an fp32 mean over 8K tokens) and the gnorm (over
# every parameter) read at most 2.43e-05 and 1.79e-04 over Yi-6B's,
# phi-3-vision's and h2o-danube's widths on an H100 80GB HBM3 (700 W), so
# the limits leave 4x and 5x; each attention weight's gradient (wq, wk, wv,
# wo of both layers, one microbatch) by its norm (read at most 3.43e-04)
# and by its largest entry error over its largest entry (at most
# 1.10e-02, phi-3's: bf16 gradients), where a head or one of dq, dk, dv
# gone wrong would show whole
TRAIN_CHECK_TOL = dict(loss=1e-4, gnorm=1e-3, attn_norm=2e-3, attn_max=2e-2)


def _train_setup(cfg, seq, batch, use_flash, device, seed=0, mesh=None, **step_kw):
    """The train step, its weights and optimizer state drawn from ``seed``,
    and the data pipeline; with ``mesh`` the sharded step on DTensors laid
    out by the production rules (``launch/train.py::build``).  ``step_kw``
    (``compress_fn``) goes to ``make_train_step``."""
    # the default schedule (100 warm-up steps): a few steps at the peak rate
    # from random weights would drive the loss up, which says nothing here
    shape = ShapeConfig("train_4k", "train", seq, batch)
    step_fn, specs, placements = train.build(cfg, shape, mesh, train.TrainHParams(),
                                             use_flash=use_flash, **step_kw)
    params, opt = train.init_state(specs, device, seed, mesh=mesh, placements=placements)
    pipe = DataPipeline(cfg, shape, PipelineConfig(seed=seed), device=device, mesh=mesh,
                        placements=None if placements is None else placements[2])
    return step_fn, params, opt, pipe


def _attention_grads(cfg, params, batch, use_flash):
    """{path: fp32 gradient} of the first microbatch's loss for the
    attention weights."""
    named = [(path, x) for path, x in flatten(params) if "/attn/" in path]
    for _, x in named:
        x.requires_grad_(True)
    try:
        loss, _ = tfm.train_loss(cfg, params, {k: v[0] for k, v in batch.items()},
                                 use_flash=use_flash)
        grads = torch.autograd.grad(loss, [x for _, x in named])
    finally:
        for _, x in named:
            x.requires_grad_(False)
    return {path: g.float() for (path, _), g in zip(named, grads)}


def matmul_params(cfg) -> int:
    """Parameters that enter a matrix product: all but the embedding table."""
    return cfg.n_params() - cfg.vocab * cfg.d_model


def _timed_steps(tag, cfg, device, *, mesh=None, after=0, **step_kw):
    """Phase 12's step (``TRAIN``'s shape, flash, seed 0) from fresh weights,
    with ``mesh`` the sharded one and ``step_kw`` for ``make_train_step``:
    1 warm-up and 3 timed steps, then ``after`` untimed ones (for checks
    that would slow a timed step), peak memory from before the weights are
    drawn, K2 and K2 bwd launches over the run's ``n_steps`` steps (the
    counts as measured), finite loss and gnorm."""
    c = TRAIN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_fn, params, opt, pipe = _train_setup(cfg, c["seq"], c["batch"], True, device,
                                              mesh=mesh, **step_kw)
    n_steps = c["warmup_steps"] + c["timed_steps"] + after
    fa.launches = fa.bwd_launches = 0
    seconds, losses, gnorms = [], [], []
    try:
        for step in range(n_steps):
            params, opt, metrics, dt = train.run_step(step_fn, params, opt, next(pipe),
                                                      step, device)
            seconds.append(dt)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["gnorm"]))
            print(f"[{tag}]   step {step} {dt * 1e3:.1f} ms loss {losses[-1]:.4f} "
                  f"gnorm {gnorms[-1]:.4f}", flush=True)
    finally:
        pipe.stop()
    if mesh is not None and not all(hasattr(x, "placements") for x in leaves(params)):
        raise SystemExit(f"[{tag}] the step returned plain tensors: not the sharded step")
    del params, opt, step_fn
    torch.cuda.empty_cache()
    if not all(map(torch.isfinite, torch.tensor(losses + gnorms))):
        raise SystemExit(f"[{tag}] non-finite loss or gnorm: {losses} {gnorms}")
    step_s = sum(seconds[c["warmup_steps"]:][:c["timed_steps"]]) / c["timed_steps"]
    return dict(step_ms=step_s * 1e3, warmup_ms=seconds[0] * 1e3,
                tokens_per_s=c["seq"] * c["batch"] / step_s,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, losses=losses,
                gnorms=gnorms, n_steps=n_steps,
                launches={"fwd": fa.launches, "bwd": fa.bwd_launches})


def train_launches(n_steps: int) -> dict:
    """K2 and K2 bwd launches of ``n_steps`` of phase 12's step: one each a
    layer a microbatch, and K2 once more where remat recomputes the layer."""
    per_step = TRAIN["layers"] * TRAIN["micro"]
    return {"fwd": 2 * per_step * n_steps, "bwd": per_step * n_steps}


def _yi_train_cfg(**replace):
    c = TRAIN
    return get_config("yi-6b").replace(n_layers=c["layers"], train_microbatches=c["micro"],
                                       **replace)


def phase_train(device, smi):
    c = TRAIN
    cfg = _yi_train_cfg()
    assert (cfg.param_dtype, cfg.opt_dtype, cfg.grad_accum_dtype, cfg.remat) == \
        ("bfloat16", "float32", "float32", True), cfg
    r = _timed_steps("train", cfg, device)
    n_steps, launches = r["n_steps"], r["launches"]
    want = train_launches(n_steps)
    if launches != want:
        raise SystemExit(f"[train] K2 launches over {n_steps} steps {launches}, "
                         f"expected {want}")
    losses, gnorms, peak = r["losses"], r["gnorms"], r["peak_mem_gb"] * 1e9
    step_s = r["step_ms"] / 1e3
    tokens = c["seq"] * c["batch"]
    attn_fwd, _ = flash_work(1, c["seq"], c["seq"], cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim)
    model_flops = 6 * matmul_params(cfg) * tokens \
        + 3 * attn_fwd * c["layers"] * c["batch"]
    mfu = model_flops / step_s / PEAK_FLOPS[torch.bfloat16]
    report = dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s, mfu=mfu,
                  peak_mem_gb=peak / 1e9, losses=losses, gnorms=gnorms,
                  launches=launches, params=cfg.n_params(), card=smi)
    print(f"[train] yi-6b widths, {c['layers']} of 32 layers ({cfg.n_params() / 1e9:.3f} B "
          f"params), bf16 params, fp32 moments and accumulation, {c['micro']} microbatches "
          f"x {c['batch'] // c['micro']} x {c['seq']} tokens, remat, flash: "
          f"step_ms={step_s * 1e3:.1f} (mean of {c['timed_steps']} after "
          f"{c['warmup_steps']} warm-up; warm-up {r['warmup_ms']:.1f}) "
          f"tokens_per_s={tokens / step_s:.1f} model_flop_share={mfu:.4f} "
          f"({model_flops / 1e12:.1f} TFLOP a step: 6 x {matmul_params(cfg) / 1e9:.3f} B "
          f"matmul params x {tokens} tokens + attention) peak_mem_gb={peak / 1e9:.3f} "
          f"k2_launches={launches['fwd']} (= {c['layers']} layers x {c['micro']} micro x "
          f"{n_steps} steps x 2) k2_bwd_launches={launches['bwd']} (= {c['layers']} x "
          f"{c['micro']} x {n_steps})", flush=True)
    for arch, replace in TRAIN_CHECKS:
        train_check(arch, replace, device)
    torch.cuda.empty_cache()
    return report


def train_check(arch, replace, device):
    """Flash against plain attention, one step from the same weights at an
    arch's published widths, cut to 2 layers and seq 1024."""
    c = TRAIN_CHECK
    cfg = get_config(arch).replace(n_layers=c["layers"], train_microbatches=c["micro"],
                                   **replace)
    out, grads = {}, {}
    fa.bwd_launches = 0
    for use_flash in (True, False):
        step_fn, params, opt, pipe = _train_setup(cfg, c["seq"], c["batch"], use_flash,
                                                  device, seed=7)
        batch = next(pipe)
        grads[use_flash] = _attention_grads(cfg, params, batch, use_flash)
        params, opt, metrics, _ = train.run_step(step_fn, params, opt, batch, 2, device)
        out[use_flash] = {k: float(metrics[k]) for k in ("loss", "gnorm")}
        del params, opt
        pipe.stop()
    # one microbatch's gradients, then a step of c["micro"]: K2 bwd each layer
    want_bwd = c["layers"] * (1 + c["micro"])
    if fa.bwd_launches != want_bwd:
        raise SystemExit(f"[train] {arch}: {fa.bwd_launches} K2 bwd launches, expected "
                         f"{want_bwd}")
    errs = {k: abs(out[True][k] - out[False][k]) / abs(out[False][k]) for k in out[True]}
    if not all(errs[k] <= TRAIN_CHECK_TOL[k] for k in errs):
        raise SystemExit(f"[train] {arch} flash {out[True]} vs plain {out[False]}: "
                         f"relative differences {errs} over {TRAIN_CHECK_TOL}")
    for path, want in grads[False].items():
        got = grads[True][path]
        norm = abs(got.norm().item() - want.norm().item()) / want.norm().item()
        top = (got - want).abs().max().item() / want.abs().max().item()
        print(f"[train]   {arch} d {path:<20} norm {want.norm().item():.4e} rel err "
              f"{norm:.2e} (tol {TRAIN_CHECK_TOL['attn_norm']}), max abs err {top:.2e} of "
              f"max |grad| (tol {TRAIN_CHECK_TOL['attn_max']})", flush=True)
        if not (norm <= TRAIN_CHECK_TOL["attn_norm"] and top <= TRAIN_CHECK_TOL["attn_max"]):
            raise SystemExit(f"[train] {arch} flash vs plain: the gradient of {path} differs")
    del grads
    print(f"[train] {arch} widths (d = {cfg.head_dim}, windows {cfg.layer_windows}, "
          f"{cfg.image_tokens if cfg.frontend == 'vision' else 0} image positions), "
          f"{c['layers']} layers, seq {c['seq']}, one step flash vs plain: loss "
          f"{out[True]['loss']:.5f} vs {out[False]['loss']:.5f} (rel {errs['loss']:.2e}, "
          f"tol {TRAIN_CHECK_TOL['loss']}), gnorm {out[True]['gnorm']:.5f} vs "
          f"{out[False]['gnorm']:.5f} (rel {errs['gnorm']:.2e}, tol "
          f"{TRAIN_CHECK_TOL['gnorm']}); K2 bwd launches {want_bwd}", flush=True)
    torch.cuda.empty_cache()


def phase_train_launcher():
    """The launcher's paths on the card, as the JAX package's system tests
    run them, with attention on K2 and K2 bwd (d = 64)."""
    args = ["--preset", "small", "--use-flash", "--device", "cuda", "--quiet",
            "--global-batch", "8", "--seq", "64"]
    with tempfile.TemporaryDirectory() as tmp:
        fa.launches = fa.bwd_launches = 0
        losses = train.main(["--steps", "14", "--ckpt-every", "7",
                             "--ckpt-dir", f"{tmp}/a", *args])
        if not (len(losses) == 14 and sum(losses[-4:]) < sum(losses[:4])):
            raise SystemExit(f"[train-launcher] loss did not improve: {losses}")
        if not (fa.launches and fa.bwd_launches):
            raise SystemExit("[train-launcher] the run did not launch K2 and K2 bwd")
        train.main(["--steps", "8", "--ckpt-every", "4", "--ckpt-dir", f"{tmp}/b", *args])
        resumed = train.main(["--steps", "12", "--ckpt-every", "4", "--resume",
                              "--ckpt-dir", f"{tmp}/b", *args])
        if len(resumed) != 4:
            raise SystemExit(f"[train-launcher] resume ran {len(resumed)} steps, not 4")
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            failed = train.main(["--steps", "12", "--ckpt-every", "4", "--inject-failure",
                                 "6", "--ckpt-dir", f"{tmp}/c", *args])
        print(log.getvalue(), end="", flush=True)
        if not (len(failed) == 14 and sum(failed[-4:]) < sum(failed[:4])):
            raise SystemExit(f"[train-launcher] failure injection: {failed}")
        # one rank: plan_mesh(max(1, 1 - 1)) re-meshes onto the same 1x1 mesh,
        # which places nothing: the launcher runs the plain step on it
        remesh = "resumed at step 4 on 1 device(s), mesh={'data': 1, 'model': 1}"
        if remesh not in log.getvalue() or "mesh={'data': 1, 'model': 1} step=plain " \
                "(one rank)" not in log.getvalue().splitlines()[0]:
            raise SystemExit(f"[train-launcher] no re-mesh onto one rank: {log.getvalue()}")
    print(f"[train-launcher] preset small (d=64), flash: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} over 14 steps on a 1x1 mesh (one NCCL rank, the plain step); "
          f"--resume ran "
          f"steps 9-12; --inject-failure 6 re-meshed onto one rank, restored step 4 and "
          f"ran {len(failed)} steps; K2 launches {fa.launches}, "
          f"K2 bwd {fa.bwd_launches}", flush=True)


def _one_rank_mesh():
    """A (1, 1) ("data", "model") mesh over one NCCL rank on the card, as the
    train launcher plans it for one rank."""
    mesh_launch.init_ranks("cuda", 0, 1)
    return make_plan_mesh(plan_mesh(1, TRAIN["batch"], prefer_model=1))


def _print_steps(tag, what, r, full):
    print(f"[{tag}] {what}: step_ms={r['step_ms']:.1f} (mean of {TRAIN['timed_steps']} "
          f"after {TRAIN['warmup_steps']} warm-up; warm-up {r['warmup_ms']:.1f}) "
          f"tokens_per_s={r['tokens_per_s']:.1f} peak_mem_gb={r['peak_mem_gb']:.3f}; phase "
          f"12 in this call: {full['step_ms']:.1f} ms, {full['peak_mem_gb']:.3f} GB; K2 "
          f"launches over {r['n_steps']} steps {r['launches']['fwd']}, K2 bwd "
          f"{r['launches']['bwd']}", flush=True)


def _same_launches(tag, r):
    """The measured totals equal phase 12's count (which phase 12 held
    exactly) for the run's number of steps."""
    want = train_launches(r["n_steps"])
    if r["launches"] != want:
        raise SystemExit(f"[{tag}] K2 launches over {r['n_steps']} steps {r['launches']}, "
                         f"the unsharded full-remat step's {want}")


def phase_train_sharded(device, full):
    """Phase 12's step through ``make_train_step(shard_ctx=...)`` on a 1x1
    mesh: the first step's loss and gnorm against phase 12's first step
    (the same weights and batch, unsharded), launch totals equal to phase
    12's count."""
    tag = "train-sharded"
    mesh = _one_rank_mesh()
    try:
        # the launcher runs phase 12's plain step on this mesh, which places
        # nothing; the sharded step is measured beside it here
        if train.step_mesh(mesh) is not None:
            raise SystemExit(f"[{tag}] the launcher would shard a one-rank mesh")
        r = _timed_steps(tag, _yi_train_cfg(), device, mesh=mesh)
    finally:
        mesh_launch.leave_ranks()
    _same_launches(tag, r)
    errs = {"loss": abs(r["losses"][0] - full["losses"][0]) / abs(full["losses"][0]),
            "gnorm": abs(r["gnorms"][0] - full["gnorms"][0]) / abs(full["gnorms"][0])}
    if not all(errs[k] <= TRAIN_CHECK_TOL[k] for k in errs):
        raise SystemExit(f"[{tag}] first step loss {r['losses'][0]} gnorm {r['gnorms'][0]} "
                         f"vs unsharded {full['losses'][0]} {full['gnorms'][0]}: relative "
                         f"{errs} over {TRAIN_CHECK_TOL}")
    _print_steps(tag, f"yi-6b, {TRAIN['layers']} layers, 1x1 (data, model) mesh over "
                 "one NCCL rank, DTensor params and moments", r, full)
    print(f"[{tag}] the launcher's step on this one-rank mesh is phase 12's plain step "
          f"({full['step_ms']:.1f} ms); the sharded step {r['step_ms']:.1f} ms "
          f"({r['step_ms'] / full['step_ms']:.3f}x)", flush=True)
    print(f"[{tag}] first step vs unsharded: loss {r['losses'][0]:.6f} vs "
          f"{full['losses'][0]:.6f} (rel {errs['loss']:.2e}, tol {TRAIN_CHECK_TOL['loss']}), "
          f"gnorm {r['gnorms'][0]:.6f} vs {full['gnorms'][0]:.6f} (rel {errs['gnorm']:.2e}, "
          f"tol {TRAIN_CHECK_TOL['gnorm']})", flush=True)
    return r


# the mass check runs on the step after the timed ones (the feedback is
# then three steps old), untimed: it copies and compares every leaf
COMPRESS = dict(topk_ratio=0.01, check_call=TRAIN["warmup_steps"] + TRAIN["timed_steps"])


class _FeedbackCompressor:
    """Gradient compression with error feedback, leaf by leaf through
    ``runtime/compress.py``, the feedback kept between steps.  On call
    ``check_call`` it holds each leaf's mass: top-k's ``sent + residual``
    equals ``acc = g + feedback`` exactly; int8's residual is exactly the
    fp32 ``acc - sent`` (whose sum with ``sent`` fp32 cannot always hold
    exactly), and the largest ``|sent + residual - acc|`` over ``|acc|``'s
    largest is reported."""

    def __init__(self, kind, device):
        self.kind, self.state, self.calls = kind, None, 0
        self.gen = torch.Generator(device=device).manual_seed(11)
        self.checked = None

    def __call__(self, grads):
        if self.state is None:
            self.state = leaves(compress.init_feedback(grads))
        check = self.calls == COMPRESS["check_call"]
        sent, bad, dev, n = [], 0, 0.0, 0
        for i, g in enumerate(leaves(grads)):
            r = self.state[i]
            if self.kind == "topk":
                s, nr = compress.compress_topk({"x": g}, {"x": r}, COMPRESS["topk_ratio"])
            else:
                s, nr = compress.compress_int8({"x": g}, {"x": r}, self.gen)
            s, nr = s["x"], nr["x"]
            if check:                 # on the whole leaves, as plain tensors
                g_, r_, s_, nr_ = (_full(x) for x in (g, r, s, nr))
                acc, total = g_.float() + r_, s_.float() + nr_
                if self.kind == "topk":
                    bad += int((total != acc).sum())
                else:
                    bad += int((nr_ != acc - s_.float()).sum())
                    dev = max(dev, float((total - acc).abs().max()
                                         / acc.abs().max().clamp_min(1e-30)))
                del g_, r_, s_, nr_, acc, total
                n += 1
            self.state[i] = nr
            sent.append(s)
        if check:
            self.checked = dict(leaves=n, mismatched=bad, max_rel_dev=dev)
        self.calls += 1
        return tree_unflatten(grads, sent)


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def phase_train_compress(device, full):
    """The sharded step with top-k (ratio 0.01) and int8 compression, each
    with error feedback."""
    tag = "train-compress"
    out = {}
    for kind in ("topk", "int8"):
        comp = _FeedbackCompressor(kind, device)
        mesh = _one_rank_mesh()
        try:
            r = _timed_steps(tag, _yi_train_cfg(), device, mesh=mesh, after=1,
                             compress_fn=comp)
        finally:
            del comp.state
            mesh_launch.leave_ranks()
        c = comp.checked
        if c is None or c["mismatched"]:
            raise SystemExit(f"[{tag}] {kind}: mass check {c}")
        _same_launches(tag, r)
        _print_steps(tag, f"{kind} with error feedback"
                     + (f" (ratio {COMPRESS['topk_ratio']})" if kind == "topk" else ""),
                     r, full)
        print(f"[{tag}] {kind}: call {COMPRESS['check_call']} held on {c['leaves']} leaves: "
              + ("sent + residual == acc exactly" if kind == "topk" else
                 f"residual == acc - sent exactly; |sent + residual - acc| at most "
                 f"{c['max_rel_dev']:.3e} of max |acc|"), flush=True)
        out[kind] = r
    return out


def phase_train_dots(device, full):
    """Remat "dots" on phase 12's (unsharded) step: at 2 layers one step from
    the same weights and batch against "full" (loss, gnorm and each attention
    weight's gradient, phase 12's flash-vs-plain limits); at 8 layers timed
    beside phase 12, K2 still launched twice a layer (the checkpoint
    recomputes it)."""
    tag = "train-dots"
    c = TRAIN_CHECK
    out, grads = {}, {}
    for policy in ("dots", "full"):
        cfg = get_config("yi-6b").replace(n_layers=c["layers"],
                                          train_microbatches=c["micro"],
                                          remat_policy=policy)
        step_fn, params, opt, pipe = _train_setup(cfg, c["seq"], c["batch"], True, device,
                                                  seed=7)
        batch = next(pipe)
        grads[policy] = _attention_grads(cfg, params, batch, True)
        params, opt, metrics, _ = train.run_step(step_fn, params, opt, batch, 2, device)
        out[policy] = {k: float(metrics[k]) for k in ("loss", "gnorm")}
        del params, opt
        pipe.stop()
    errs = {k: abs(out["dots"][k] - out["full"][k]) / abs(out["full"][k]) for k in out["dots"]}
    if not all(errs[k] <= TRAIN_CHECK_TOL[k] for k in errs):
        raise SystemExit(f"[{tag}] dots {out['dots']} vs full {out['full']}: {errs}")
    worst = {"norm": 0.0, "max": 0.0}
    for path, want in grads["full"].items():
        got = grads["dots"][path]
        worst["norm"] = max(worst["norm"], abs(got.norm().item() - want.norm().item())
                            / want.norm().item())
        worst["max"] = max(worst["max"], (got - want).abs().max().item()
                           / want.abs().max().item())
    if not (worst["norm"] <= TRAIN_CHECK_TOL["attn_norm"]
            and worst["max"] <= TRAIN_CHECK_TOL["attn_max"]):
        raise SystemExit(f"[{tag}] attention gradients under dots differ: {worst}")
    del grads
    print(f"[{tag}] 2 layers, seq {c['seq']}: loss {out['dots']['loss']:.6f} vs full "
          f"{out['full']['loss']:.6f} (rel {errs['loss']:.2e}), gnorm "
          f"{out['dots']['gnorm']:.6f} vs {out['full']['gnorm']:.6f} (rel "
          f"{errs['gnorm']:.2e}); attention gradients: norm rel {worst['norm']:.2e}, max "
          f"abs err {worst['max']:.2e} of max |grad|", flush=True)
    r = _timed_steps(tag, _yi_train_cfg(remat_policy="dots"), device)
    _same_launches(tag, r)
    _print_steps(tag, f"yi-6b, {TRAIN['layers']} layers, remat \"dots\" (unbatched "
                 "products saved)", r, full)
    return r


# phase 26: the reference's tune CLI sweeps (launch/tune.py::DS_SWEEPS under
# Environment(n_workers=4, mem_limit_mb=64)) never exhaust their budget, so
# the measured-OOM and pruned cells are held on one more sweep whose memory
# limit binds: tests/test_taskgraph.py's kmeans 128 x 16 at 0.02 MB
DS_OOM_SWEEP = dict(rows=128, cols=16, seed=0, mem_limit_mb=0.02)


def _ds_kernel_launches() -> dict:
    return {"matmul": mm.launches, "flash": fa.launches, "flash_bwd": fa.bwd_launches}


def _reset_counts():
    """Zero the executed-body counts and the three kernels' launch counts."""
    taskgraph.reset_body_counts()
    mm.launches = fa.launches = fa.bwd_launches = 0


def _on_card_without_kernels(tag) -> dict:
    """The kernel launches since ``_reset_counts``; raises unless some task
    body ran, every one on the card, and no kernel launched."""
    bodies, launches = dict(taskgraph.BODIES), _ds_kernel_launches()
    if not bodies or any(not k.startswith("cuda") for k in bodies) \
            or any(launches.values()):
        raise SystemExit(f"[{tag}] bodies by device {bodies}, kernel launches {launches}")
    return launches



def _store_lines(path) -> int:
    return len(Path(path).read_text().splitlines())


def _inf_pattern(log) -> list:
    return [(r.p_r, r.p_c, math.isinf(r.time_s), bool(r.meta.get("oom")),
             bool(r.meta.get("pruned"))) for r in log.records]


def _oom_cells(X, y, env, backend) -> list:
    cells = []
    for p_r in grid_powers(env.n_workers, mult=1):
        for p_c in grid_powers(env.n_workers, mult=1):
            ex = TaskExecutor(env, backend=backend)
            try:
                run_algo("kmeans", ex, DistArray.from_array(X, p_r, p_c), y)
            except TaskMemoryError:
                cells.append((p_r, p_c))
            finally:
                ex.shutdown()
    return cells


def phase_ds_tune(device) -> dict:
    """``tune``'s ds-array and mesh families through the CLI's ``main``, the
    ds task bodies on the card; the same CLI on the CPU for the record
    counts; a rerun appends nothing."""
    tag = "ds-tune"
    with tempfile.TemporaryDirectory() as tmp:
        card_store, cpu_store = Path(tmp) / "card.jsonl", Path(tmp) / "cpu.jsonl"
        argv = ["--skip", "kernel", "--refit-demo", "--store"]
        _reset_counts()
        t0 = time.perf_counter()
        out = tune.main(argv + [str(card_store), "--device", "cuda"])
        wall = time.perf_counter() - t0
        bodies = dict(taskgraph.BODIES)
        launches = _on_card_without_kernels(tag)
        lines = _store_lines(card_store)
        ds_records = LogStore(card_store).load(source="grid_search").records
        if {r.env.get("timing") for r in ds_records} != {tune.ds_timing("cuda")["timing"]}:
            raise SystemExit(f"[{tag}] ds records not all tagged as the card's")
        tune.main(argv + [str(card_store), "--device", "cuda"])
        if _store_lines(card_store) != lines:
            raise SystemExit(f"[{tag}] the rerun appended to the store")
        cpu = tune.main(argv + [str(cpu_store), "--device", "cpu"])
        if out["sources"] != cpu["sources"]:
            raise SystemExit(f"[{tag}] records by source {out['sources']} on the card, "
                             f"{cpu['sources']} on the CPU")
    refit = out["ds"]["refit"]
    if not refit["retrained"] or refit["invalidations"] < 1:
        raise SystemExit(f"[{tag}] refit demo: {refit}")
    # the memory model on tensors: a measured OOM and a pruned cell, the
    # inf/pruned pattern as on the CPU
    s = DS_OOM_SWEEP
    env = Environment(n_workers=4, mem_limit_mb=s["mem_limit_mb"])
    pats = {}
    for dev in ("cuda", "cpu"):
        X, y = gaussian_blobs(s["rows"], s["cols"], seed=s["seed"], device=dev)
        log, _ = grid_search(X, y, "kmeans", env, mult=1)
        pats[dev] = _inf_pattern(log)
    if pats["cuda"] != pats["cpu"] or not any(p[3] for p in pats["cuda"]) \
            or not any(p[4] for p in pats["cuda"]):
        raise SystemExit(f"[{tag}] OOM/pruned pattern on the card {pats['cuda']}, "
                         f"on the CPU {pats['cpu']}")
    n_oom = sum(p[3] for p in pats["cuda"])
    n_pruned = sum(p[4] for p in pats["cuda"])
    # the threadpool backend (a CUDA stream a pool thread) runs out of
    # memory on the cells where the inline one does, pruning off
    X, y = gaussian_blobs(s["rows"], s["cols"], seed=s["seed"], device="cuda")
    oom = {b: _oom_cells(X, y, env, b) for b in ("inline", "threadpool")}
    if oom["inline"] != oom["threadpool"] or not oom["inline"]:
        raise SystemExit(f"[{tag}] OOM cells inline {oom['inline']}, threadpool "
                         f"{oom['threadpool']}")
    dp, tp, mb = out["mesh"]["predictions"]["deepseek-7b"]
    preds = {f"{r}x{c}": p for (r, c), p in out["ds"]["predictions"].items()}
    print(f"[{tag}] bodies {bodies}; records by source {out['sources']} (= the CPU "
          f"run's); kmeans predictions {preds}; refit retrained={refit['retrained']} "
          f"invalidations={refit['invalidations']} before={refit['before']} "
          f"after={refit['after']}; deepseek-7b train_4k on 64 H100s: dp={dp} tp={tp} "
          f"microbatches={mb}; wall_s={wall:.3f} (ds {out['ds']['wall_s']:.3f}, mesh "
          f"{out['mesh']['wall_s']:.3f}); kmeans {s['rows']}x{s['cols']} at "
          f"{s['mem_limit_mb']} MB: {n_oom} measured OOM, {n_pruned} pruned, as on the "
          f"CPU; OOM cells without pruning {oom['inline']} inline and threadpool; kernel "
          f"launches {launches}", flush=True)
    return {"bodies": bodies, "launches": launches, "wall_s": wall,
            "records": ds_records}


# phase 27: BLEST-ML at the paper's data sizes, under the paper's MareNostrum
# 4 node (48 cores, 96 GB, 2 GB a core); grid_powers(48) is 1..128
MN4 = dict(name="mn4-node", n_workers=48, mem_limit_mb=2048.0, ram_gb=96.0)
BLEST_SWEEPS = [("hepmass", "kmeans"), ("mnist", "pca")]
# the card against the CPU: a kmeans both run through the port
KMEANS_CHECK = dict(rows=4096, cols=64, parts=(8, 4), k=8, iters=5, seed=3)


def _print_grid(tag, name, grid, records):
    """One line a p_r: the cell's seconds, or why it is inf (a measured
    OOM, pruned as coarser than one, or a split finer than the data)."""
    why = {(r.p_r, r.p_c): ("oom" if r.meta.get("oom") else "pruned"
                            if r.meta.get("pruned") else "-") for r in records}
    rows = sorted({r for r, _ in grid})
    cols = sorted({c for _, c in grid})
    print(f"[{tag}] {name} grid, seconds by (p_r, p_c); p_c = {cols}", flush=True)
    for r in rows:
        cells = [why[(r, c)] if math.isinf(grid[(r, c)]) else f"{grid[(r, c)]:.6f}"
                 for c in cols]
        print(f"[{tag}]   p_r={r:<4} {' '.join(f'{v:>10}' for v in cells)}", flush=True)


def _card_vs_cpu(tag):
    c = KMEANS_CHECK
    outs = {}
    for dev in ("cuda", "cpu"):
        X, _ = gaussian_blobs(c["rows"], c["cols"], seed=c["seed"], device=dev)
        ex = TaskExecutor(Environment(n_workers=4))
        outs[dev] = kmeans.fit(ex, DistArray.from_array(X, *c["parts"]), k=c["k"],
                               iters=c["iters"], seed=c["seed"])
    card, cpu = outs["cuda"], outs["cpu"]
    torch.testing.assert_close(card["centers"].cpu(), cpu["centers"], rtol=1e-8, atol=1e-8)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(card["labels"], cpu["labels"])):
        raise SystemExit(f"[{tag}] kmeans labels differ between the card and the CPU")
    if not math.isclose(card["inertia"], cpu["inertia"], rel_tol=1e-8):
        raise SystemExit(f"[{tag}] inertia {card['inertia']} on the card, "
                         f"{cpu['inertia']} on the CPU")
    err = (card["centers"].cpu() - cpu["centers"]).abs().max().item()
    # the threadpool backend, each pool thread on a stream of its own,
    # gives the inline backend's values
    X, _ = gaussian_blobs(c["rows"], c["cols"], seed=c["seed"], device="cuda")
    ex = TaskExecutor(Environment(n_workers=4), backend="threadpool")
    pool = kmeans.fit(ex, DistArray.from_array(X, *c["parts"]), k=c["k"],
                      iters=c["iters"], seed=c["seed"])
    ex.shutdown()
    if not (torch.equal(pool["centers"], card["centers"])
            and pool["inertia"] == card["inertia"]
            and all(torch.equal(a, b) for a, b in zip(pool["labels"], card["labels"]))):
        raise SystemExit(f"[{tag}] the threadpool backend's kmeans differs from the "
                         "inline one's on the card")
    return err, card["inertia"], cpu["inertia"]


def _lineage_on_card(tag, X):
    """One ``_center_partial`` body re-executed on the card (the lineage
    contract), then a kmeans whose lost worker's task re-executes from
    lineage under the task graph's own bit-identity check."""
    rows = X[: X.shape[0] // 4]
    lab = torch.randint(0, 8, (rows.shape[0],), device=rows.device,
                        generator=torch.Generator(rows.device).manual_seed(0))
    first = kmeans._center_partial(rows, (lab, 0.0), 8)
    again = kmeans._center_partial(rows, (lab, 0.0), 8)
    if not taskgraph._bit_identical(first, again):
        raise SystemExit(f"[{tag}] _center_partial re-executed on the card is not "
                         "bit-identical")
    c = KMEANS_CHECK
    Xs, _ = gaussian_blobs(c["rows"], c["cols"], seed=c["seed"], device="cuda")
    free = TaskExecutor(Environment(n_workers=4))
    ref = kmeans.fit(free, DistArray.from_array(Xs, *c["parts"]), k=c["k"], iters=2)
    for frac in (0.5, 0.35, 0.65, 0.2, 0.8, 0.1, 0.9):
        plan = FaultPlan(losses=(WorkerLoss(1, frac * free.sim_time),))
        ex = TaskExecutor(Environment(n_workers=4), fault_plan=plan)
        got = kmeans.fit(ex, DistArray.from_array(Xs, *c["parts"]), k=c["k"], iters=2)
        if ex.fault_stats()["reexecuted_tasks"]:
            break
    else:
        raise SystemExit(f"[{tag}] no planned loss caught a task in flight")
    if not torch.equal(got["centers"], ref["centers"]):
        raise SystemExit(f"[{tag}] the recovered kmeans differs from the fault-free one")
    return rows.shape[0], ex.fault_stats()["reexecuted_tasks"]


def _estimate(tag, est, how, name, shape, algo, env, grid):
    n, m = shape
    pr, pc = est.predict_partitions(n, m, algo, env.features())
    br, bc = est.predict_block_size(n, m, algo, env.features())
    st = grid_stats(grid)
    t_pred = grid.get((pr, pc), math.inf)
    print(f"[{tag}] estimator {how}, {name}: predicted (p_r, p_c)=({pr},{pc}), block "
          f"{br}x{bc}; measured {t_pred:.6f} s there against the argmin "
          f"{st['best_part']} {st['best']:.6f} s (ratio {t_pred / st['best']:.4f})",
          flush=True)


def phase_blest(device, smi, cli_records) -> dict:
    """``grid_search(..., reuse_measurements=True)`` on the paper's two data
    sizes with the data on the card, the estimator fitted on both sweeps
    (in sample) and on ``cli_records`` (phase 26's card sweeps) with one
    sweep held out, and the card held against the CPU."""
    tag = "blest"
    env = Environment(**MN4)
    data = {"hepmass": hepmass_like, "mnist": mnist_like}
    log, grids, walls = ExecutionLog(), {}, {}
    _reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    shapes, flags = {}, {"oom": 0, "pruned": 0}
    for name, algo in BLEST_SWEEPS:
        t0 = time.perf_counter()
        X, y = data[name](scale=1.0, device="cuda")
        gen_s = time.perf_counter() - t0
        shapes[name] = tuple(X.shape)
        t0 = time.perf_counter()
        log, grid = grid_search(X, y, algo, env, reuse_measurements=True, log=log)
        walls[name] = time.perf_counter() - t0
        grids[name] = grid
        st = grid_stats(grid)
        records = [r for r in log.records if r.algo == algo]
        n_pruned = sum(1 for r in records if r.meta.get("pruned"))
        n_oom = sum(1 for r in records if r.meta.get("oom"))
        flags["oom"] += n_oom
        flags["pruned"] += n_pruned
        print(f"[{tag}] {name} {X.shape[0]}x{X.shape[1]} float64 "
              f"({X.numel() * 8 / 1e9:.3f} GB, made in {gen_s:.1f} s) {algo} under "
              f"{MN4}: sweep wall_s={walls[name]:.3f}", flush=True)
        _print_grid(tag, name, grid, records)
        print(f"[{tag}] {name} argmin {st['best_part']} {st['best']:.6f} s; best "
              f"{st['best']:.6f}, avg {st['avg']:.6f}, worst {st['worst']:.6f} s at "
              f"{st['worst_part']}; {st['n_finite']} finite, {st['n_oom']} inf "
              f"({n_oom} measured OOM, {n_pruned} pruned)", flush=True)
        if name == "hepmass":
            lineage_rows, reexec = _lineage_on_card(tag, X)
        del X, y
    if not flags["oom"] or not flags["pruned"]:
        raise SystemExit(f"[{tag}] expected measured OOM and pruned cells: {flags}")
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    bodies = dict(taskgraph.BODIES)
    launches = _on_card_without_kernels(tag)
    # in sample: the tree reproduces the argmin labels it was fitted on
    est = BlockSizeEstimator("tree").fit(log)
    for name, algo in BLEST_SWEEPS:
        _estimate(tag, est, "in sample", name, shapes[name], algo, env, grids[name])
    # held out: fitted on phase 26's card sweeps and the other paper sweep
    for name, algo in BLEST_SWEEPS:
        train_recs = list(cli_records) + [r for r in log.records if r.algo != algo]
        held = BlockSizeEstimator("tree").fit(ExecutionLog(train_recs))
        _estimate(tag, held, "held out", name, shapes[name], algo, env, grids[name])
    err, inertia_card, inertia_cpu = _card_vs_cpu(tag)
    c = KMEANS_CHECK
    print(f"[{tag}] sweeps wall_s {sum(walls.values()):.3f}; peak "
          f"{peak:.3f} GB (max_memory_allocated) on {smi}; bodies {bodies}; kernel "
          f"launches {launches}; kmeans {c['rows']}x{c['cols']} card vs CPU: centers "
          f"max abs err {err:.3e}, inertia {inertia_card!r} vs {inertia_cpu!r}, labels "
          f"equal, threadpool backend bit-identical to inline; _center_partial over {lineage_rows} rows re-executed bit-identical; "
          f"lineage recovery re-executed {reexec} task(s), centers bit-identical",
          flush=True)
    return {"walls": walls, "peak_gb": peak, "launches": launches, "log": log,
            "grids": grids}


def _closed_loop_trail(tag, trail):
    """The closed loop's audit: the first run abstains to the default, its
    record refits the model, the second run is the model's, the memo is
    flushed between."""
    if not (trail["first_chosen_by"] == "default" and trail["second_chosen_by"] == "model"
            and trail["first_retrained"] is True and trail["invalidations"] >= 1):
        raise SystemExit(f"[{tag}] closed-loop trail {trail}")
    print(f"[{tag}] closed loop{' (sharded)' if trail['sharded'] else ''}: run 1 by "
          f"{trail['first_chosen_by']} {trail['partitions'][0]} {trail['times_s'][0]:.6f} s, "
          f"refit v{trail['versions'][0]} -> v{trail['versions'][1]}, run 2 by "
          f"{trail['second_chosen_by']} {trail['partitions'][1]} {trail['times_s'][1]:.6f} s; "
          f"invalidations {trail['invalidations']}", flush=True)


def _eval_row(m) -> str:
    if not m.get("groups"):
        return "no groups"
    row = (f"{m['groups']} groups, hit {m['exact_hit_rate']:.4f}, exp distance "
           f"{m['mean_exp_distance']:.4f}, within one {m['within_one_exp']:.4f}")
    if "mean_speedup_vs_default" in m:
        row += (f", speedup vs default {m['mean_speedup_vs_default']:.4f} (geomean "
                f"{m['geomean_speedup_vs_default']:.4f})")
    if "mean_regret_vs_best" in m:
        row += f", regret {m['mean_regret_vs_best']:.4f}"
    return row


def _bench_eval_bytes():
    path = ROOT / "BENCH_eval.json"
    return path.read_bytes() if path.exists() else None


# phase 28: the paper's protocol, the smoke cube (with the closed-loop demo)
# then the full cube (harness only); 5 algorithms x 3 profiles x the shapes
EVAL_RUNS = (("smoke", ["--smoke"], 5 * 3 * 3), ("full", ["--skip-loop"], 5 * 4 * 3))


def _evaluate_once(tag, smi, argv, groups) -> dict:
    """``evaluate`` through the launcher's ``main`` on the card, its files
    under a temporary directory."""
    checkout = _bench_eval_bytes()
    _reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        bench = Path(tmp) / "bench" / "BENCH_eval.json"
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            report = evaluate_launch.main(argv + ["--artifacts", tmp,
                                                  "--bench-out", str(bench)])
        wall = time.perf_counter() - t0
        written = sorted(str(p.relative_to(tmp)) for p in Path(tmp).rglob("*")
                         if p.is_file())
    launches = _on_card_without_kernels(tag)
    if written != ["bench/BENCH_eval.json", "eval_report.json"]:
        raise SystemExit(f"[{tag}] files written {written}")
    if _bench_eval_bytes() != checkout:
        raise SystemExit(f"[{tag}] the checkout's BENCH_eval.json changed")
    n = report["config"]["n_groups"]
    if n != groups:
        raise SystemExit(f"[{tag}] {n} groups, expected {groups}")
    print(f"[{tag}] {' '.join(argv)}: {n} groups, {report['config']['n_records']} records "
          f"on {smi}; wall_s {wall:.3f} (harness {report['wall_s']:.3f})", flush=True)
    print(f"[{tag}] overall: {_eval_row(report['overall'])}", flush=True)
    for kind in ("per_algo", "per_env", "holdout_algo", "holdout_env"):
        for name, m in report[kind].items():
            print(f"[{tag}] {kind} {name}: {_eval_row(m)}", flush=True)
    if "closed_loop" in report:
        _closed_loop_trail(tag, report["closed_loop"])
    print(f"[{tag}] bodies {dict(taskgraph.BODIES)}; kernel launches {launches}; wrote "
          f"{written} under a temporary directory; the checkout's BENCH_eval.json "
          "unchanged", flush=True)
    return launches


def phase_evaluate(smi) -> dict:
    """The smoke cube with the closed-loop demo, then the full cube."""
    launches = {}
    for name, argv, groups in EVAL_RUNS:
        got = _evaluate_once(f"evaluate {name}", smi, argv, groups)
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    return {"launches": launches}


# phase 29: the node after losing half its workers
MN4_LOSS = dict(MN4, name="mn4-node-24", n_workers=24)
ELASTIC_ITERS, ELASTIC_AFTER = 5, 2


def phase_closed_loop(device, smi, blest) -> dict:
    """``AutoTunedRun`` at the paper's sizes on the card with phase 27's
    estimator, then an elastic kmeans through a worker loss."""
    tag = "closed-loop"
    env = Environment(**MN4)
    est = BlockSizeEstimator("tree").fit(blest["log"])
    data = {"hepmass": hepmass_like, "mnist": mnist_like}
    _reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    with tempfile.TemporaryDirectory() as tmp:
        store = LogStore(Path(tmp) / "closed_loop.jsonl")
        loop = AutoTunedRun(est, store)
        kept = {}
        for name, algo in BLEST_SWEEPS:
            X, y = data[name](scale=1.0, device="cuda")
            finite = {k: v for k, v in blest["grids"][name].items() if math.isfinite(v)}
            argmin = min(finite, key=finite.get)
            t0 = time.perf_counter()
            r = loop.run(X, y, algo, env)
            wall = time.perf_counter() - t0
            if not (r.chosen_by == "model" and (r.p_r, r.p_c) == argmin
                    and math.isfinite(r.time_s) and r.appended):
                raise SystemExit(f"[{tag}] {name} {algo}: chosen by {r.chosen_by} at "
                                 f"({r.p_r},{r.p_c}) (phase 27's argmin {argmin}), "
                                 f"{r.time_s} s, appended {r.appended}")
            print(f"[{tag}] {name} {tuple(X.shape)} {algo}: chosen by {r.chosen_by} at "
                  f"({r.p_r},{r.p_c}) = phase 27's argmin; modeled {r.time_s:.6f} s "
                  f"(phase 27: {finite[argmin]:.6f} s), {r.record.meta['tasks']} tasks, "
                  f"wall_s {wall:.3f}; appended {r.appended}, retrained {r.retrained}",
                  flush=True)
            if name == "hepmass":
                kept = {"X": X, "y": y}
            del X, y
        change = EnvChange(after_iter=ELASTIC_AFTER, env=Environment(**MN4_LOSS),
                           reason="worker loss")
        t0 = time.perf_counter()
        e = loop.run_elastic(kept["X"], kept["y"], "kmeans", env, change,
                             iters=ELASTIC_ITERS)
        wall = time.perf_counter() - t0
        del kept
        sources = store.sources()
    if not (e.results_close and math.isfinite(e.recovery_time_s)
            and math.isfinite(e.restart_time_s)):
        raise SystemExit(f"[{tag}] elastic kmeans: results_close {e.results_close}, "
                         f"recovery {e.recovery_time_s} s, restart {e.restart_time_s} s")
    launches = _on_card_without_kernels(tag)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"[{tag}] elastic kmeans on hepmass, {ELASTIC_ITERS} iterations, "
          f"{MN4['n_workers']} -> {MN4_LOSS['n_workers']} workers after {ELASTIC_AFTER}: "
          f"partitions {e.partitions} chosen by {e.chosen_by}; repartition {e.repartition} "
          f"in {e.repartition_s:.6f} s; recovery {e.recovery_time_s:.6f} s against restart "
          f"{e.restart_time_s:.6f} s (speedup {e.speedup:.4f}); results close "
          f"{e.results_close}; appended {e.appended}, retrained {e.retrained}; wall_s "
          f"{wall:.3f}", flush=True)
    print(f"[{tag}] store by source {sources}; peak {peak:.3f} GB (max_memory_allocated) "
          f"on {smi}; bodies {dict(taskgraph.BODIES)}; kernel launches {launches}",
          flush=True)
    return {"launches": launches, "peak_gb": peak}


# phase 30: serve-estimator --demo as its reference CLI defaults; then a
# swap under load: the demo's store and router, the refit daemon on, and a
# pca sweep made on the card appended once land_after requests are served
SERVE_DEMO = dict(shards=4, clients=4, requests=400)
SWAP_LOAD = dict(shards=4, clients=4, requests=2000, land_after=500)
SERVE_ENV = dict(name="laptop", n_workers=4, n_nodes=1, mem_limit_mb=2048.0,
                 dispatch_overhead_s=1e-4, ram_gb=16)


def _swap_under_load(tag, smi) -> dict:
    """The refit daemon swaps the router's model while four clients run:
    the swap lands between the append and the trace's end, cold (pca)
    queries move from the default to the model, and no request enqueued
    after the swap is served by the older model."""
    c = SWAP_LOAD
    with tempfile.TemporaryDirectory() as tmp:
        store = serve_estimator._demo_store(tmp, "cuda")
        est = BlockSizeEstimator("tree").fit(store.load())
        universe = serve_estimator._universe_from_store(store, set(est.known_algos))
        n0, m0, _algo, env0 = universe[0]
        X, y = gaussian_blobs(n0, m0, seed=9, device="cuda")
        pca, _ = grid_search(X, y, "pca", Environment(**SERVE_ENV), mult=1,
                             reuse_measurements=True)
        trace = make_trace(c["requests"], universe, seed=0,
                           cold_queries=[(n0, m0, "pca", env0)])
        router = ShardRouter(est, n_shards=c["shards"], window_s=0.002)
        daemon = RefitDaemon(router, store, interval_s=0.05).start()
        done, landed = threading.Event(), {}

        def writer():
            while router.stats()["served"] < c["land_after"] and not done.is_set():
                time.sleep(0.005)
            if not done.is_set():
                store.append(timed_copies(pca.records, X.device), source="grid_search")
                landed["t"] = time.monotonic()

        w = threading.Thread(target=writer, name="smoke-writer", daemon=True)
        try:
            w.start()
            report = run_load(router, trace, n_clients=c["clients"])
            t_end = time.monotonic()
        finally:
            done.set()
            w.join(timeout=30)
            daemon.stop()
            router.close()
        swaps = [(t, v) for t, v in router.swap_log[1:]
                 if "t" in landed and landed["t"] <= t < t_end]
    dropped = report["rejected"] + report["expired"] + report["errors"]
    cold = report["by_kind"].get("cold", {}).get("default_frac", 1.0)
    if report["served"] != c["requests"] or dropped or report["staleness_violations"] \
            or daemon.swaps < 1 or not swaps or not cold < 1.0:
        raise SystemExit(f"[{tag}] swap under load: served {report['served']}/"
                         f"{c['requests']}, dropped {dropped}, staleness violations "
                         f"{report['staleness_violations']}, daemon swaps {daemon.swaps} "
                         f"({len(swaps)} during the load; {daemon.last_error!r}), cold "
                         f"default share {cold}")
    print(f"[{tag}] swap under load: {report['served']}/{c['requests']} served from "
          f"{c['clients']} clients, 0 dropped; pca sweep ({len(pca.records)} records, "
          f"on the card) appended after {c['land_after']} served, {daemon.swaps} daemon "
          f"swap(s), {len(swaps)} during the load (versions {[v for _, v in swaps]}); "
          f"{report['staleness_violations']} staleness violations; cold queries by the "
          f"default {cold:.4f}; {report['throughput_rps']:.1f} req/s, host p50 "
          f"{report['p50_ms']:.4f} ms, p99 {report['p99_ms']:.4f} ms on {smi}", flush=True)
    return {"swaps": daemon.swaps}


def phase_serving(smi) -> dict:
    """``serve-estimator --demo`` through its ``main`` (the sweep on the
    card), a swap under load, then the closed loop through the sharded
    router."""
    tag = "serving"
    c = SERVE_DEMO
    _reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        report = serve_estimator.main([
            "--demo", "--shards", str(c["shards"]), "--clients", str(c["clients"]),
            "--requests", str(c["requests"])])
    wall = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        print(f"[{tag}] {line}", flush=True)
    dropped = report["rejected"] + report["expired"] + report["errors"]
    if report["served"] != report["requests"] or report["requests"] != c["requests"] \
            or dropped or report["staleness_violations"]:
        raise SystemExit(f"[{tag}] served {report['served']}/{report['requests']}, dropped "
                         f"{dropped}, staleness violations {report['staleness_violations']}")
    st = report["router"]
    print(f"[{tag}] {report['served']}/{report['requests']} served over {st['n_shards']} "
          f"shards from {report['n_clients']} clients, 0 dropped, "
          f"{report['staleness_violations']} staleness violations across {st['swaps']} "
          f"swaps (the demo's store gets no record while it serves); "
          f"{report['throughput_rps']:.1f} req/s; host latencies p50 "
          f"{report['p50_ms']:.4f} ms, p95 {report['p95_ms']:.4f} ms, p99 "
          f"{report['p99_ms']:.4f} ms; wall_s {wall:.3f} on {smi}", flush=True)
    _swap_under_load(tag, smi)
    with tempfile.TemporaryDirectory() as tmp:
        trail = closed_loop_demo(LogStore(Path(tmp) / "s.jsonl"), sharded=True,
                                 device="cuda")
    _closed_loop_trail(tag, trail)
    launches = _on_card_without_kernels(tag)
    print(f"[{tag}] bodies {dict(taskgraph.BODIES)}; kernel launches {launches}", flush=True)
    return {"launches": launches, "report": report}


# phase 14: gemma3-27b served whole, and the prefill shape of its local layers
GEMMA3_SERVE = dict(batch=4, prompt=1536, gen=32)
GEMMA3_LOCAL = dict(B=4, T=1536, H=32, KV=16, d=128, window=1024, meta=0)
# phase 15: (name, arch, layers, windows, T); fp32, batch 2, the reference
# test's tolerance on the largest logit difference
DECODE_CASES = [("gemma3 widths", "gemma3-27b", 2, (1024, 0), 1100),
                ("mixtral widths", "mixtral-8x7b", 2, (512, 512), 600),
                ("hymba widths", "hymba-1.5b", 2, (1024, 0), 1100),
                ("mamba2 widths", "mamba2-370m", 2, (0, 0), 600),
                # d = 96 after the 576-position image prefix; 4 codebooks;
                # d = 120 with the window cut to 1024 and T past it
                ("phi-3-vision widths", "phi-3-vision-4.2b", 2, (0, 0), 600),
                ("musicgen widths", "musicgen-large", 2, (0, 0), 600),
                ("h2o-danube widths", "h2o-danube-3-4b", 2, (1024, 1024), 1100),
                # dense MLA layers: the absorbed decode over the latent cache
                ("deepseek-v3 widths", "deepseek-v3-671b", 2, (0, 0), 600)]
DECODE_TOL = 2e-3
DECODE_STEPS = 3
# phase 16: mixtral-8x7b at 16 of its 32 layers
MIXTRAL_SERVE = dict(batch=8, prompt=512, gen=32, layers=16)
# phase 17: hymba-1.5b served whole, and the prefill shape of its local
# layers (1536 prompt tokens after 128 meta tokens)
HYMBA_SERVE = dict(batch=8, prompt=1536, gen=32)
HYMBA_LOCAL = dict(B=8, T=1664, H=25, KV=5, d=64, window=1024, meta=128)
# phase 18: mamba2-370m served whole
MAMBA2_SERVE = dict(batch=8, prompt=2048, gen=32)
# phases 19-21: h2o-danube-3-4b, phi-3-vision-4.2b and musicgen-large served
# whole, and K2 alone at each one's prefill shape first (phi-3's T counts
# its 576 image positions before 1024 text tokens; musicgen's 512 frames
# carry 4 codebooks each)
H2O_SERVE = dict(batch=2, prompt=6144, gen=32)
H2O_LOCAL = dict(B=2, T=6144, H=32, KV=8, d=120, window=4096, meta=0)
PHI3_SERVE = dict(batch=4, prompt=1024, gen=32)
PHI3_LOCAL = dict(B=4, T=1600, H=32, KV=32, d=96, window=0, meta=0)
MUSICGEN_SERVE = dict(batch=8, prompt=512, gen=32)
MUSICGEN_LOCAL = dict(B=8, T=512, H=32, KV=32, d=64, window=0, meta=0)
# phase 22: deepseek-v3-671b at 5 of its 61 layers (its 3 dense and 2 of its
# MoE layers: both stages repeat, so both stacked latent caches are written
# in place at every step)
DEEPSEEK_SERVE = dict(batch=8, prompt=512, gen=32, layers=5)
MEMORY_GB = 80


def attention_layers(cfg) -> int:
    """Layers with GQA attention (``attn`` and ``hybrid``): one K2 launch
    each in prefill.  MLA takes none: the reference's MLA attends in plain
    jnp, and so does the port's."""
    if cfg.mla is not None:
        return 0
    return sum(kind != "ssm" for kind in cfg.kinds)


def attention_desc(cfg) -> str:
    if cfg.mla is None:
        return f"head dim {cfg.head_dim}"
    m = cfg.mla
    return (f"MLA (q rank {m.q_lora_rank}, kv rank {m.kv_lora_rank}, qk head dim "
            f"{m.qk_nope_dim + m.qk_rope_dim}, v head dim {m.v_head_dim})")


def planted_faults(tag, got, want, tol, dim=-1, **more):
    """The relative check over ``dim`` must reject ``got`` [B, T, H, d]
    with the columns of its second 64-wide box zeroed past row 1024 (half
    the columns at d = 64, past half the rows at T < 2048), with those rows
    scaled by 0.9 (10 % low), and each of ``more`` (name: a faulty
    output).  Prints each fault's error and whether check_close at
    TOL[bf16] passes it (against the same fp32 plain output)."""
    t, d = got.shape[1], got.shape[-1]
    row, col = min(1024, t // 2), 64 if d > 64 else d // 2
    zeroed, scaled = got.clone(), got.clone()
    zeroed[:, row:, :, col:] = 0
    scaled[:, row:] *= 0.9
    faults = {f"columns {col}..{d - 1} zeroed past row {row}": zeroed,
              f"rows past {row} scaled by 0.9": scaled, **more}
    for fault, out in faults.items():
        rel = rel_error(out, want, dim)
        if not rel > tol:
            raise SystemExit(f"[{tag}] planted fault ({fault}) passed the check: "
                             f"{rel:.3e} of the norm")
        print(f"[{tag}] planted fault ({fault}): error {rel:.3e} of the "
              f"{'row' if dim == -1 else 'head'}'s norm, rejected; check_close at "
              f"{TOL[torch.bfloat16]} would "
              f"{'pass' if excess(out, want, TOL[torch.bfloat16]) <= 0 else 'reject'} it",
              flush=True)


def phase_local_k2(tag, c, device, seed):
    """K2 at a model's prefill shape (with a window that masks and the meta
    prefix, where the model has them): against its plain version, timed
    beside it, beside SDPA (given a window's mask as a boolean, kv heads
    expanded outside the timing; causal alone, ``is_causal``) and beside
    the bound, which counts only the live pairs."""
    b, t, h, kvh, d, win, meta = (c[x] for x in ("B", "T", "H", "KV", "d", "window",
                                                 "meta"))
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = qkv(gen, b, t, t, h, kvh, d, torch.bfloat16, device)
    kw = dict(window=win, n_meta=meta)
    got = ops.flash_attention(q, k, v, **kw)
    want = plain_fp32(fa.flash_attention_plain, q, k, v, scale=d ** -0.5, **kw)
    rel, err = check_rel(f"{tag} local shape", got, want, ROW_TOL)
    planted_faults(tag, got, want, ROW_TOL,
                   **({"window dropped": ops.flash_attention(q, k, v)} if win else {}))
    del want
    kernel_ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw), iters=20)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, scale=d ** -0.5, **kw),
                       iters=3, warmup=1)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()
              for x in (k, v))
    if win:
        pos = torch.arange(t, device=device)
        mask = (pos[:, None] >= pos[None]) & ((pos[:, None] - pos[None] < win)
                                             | (pos[None] < meta))
        sdpa = dict(attn_mask=mask)
    else:
        sdpa = dict(is_causal=True)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa),
                         iters=20)
    flops, nbytes = flash_work(b, t, t, h, kvh, d, window=win, n_meta=meta)
    bound_ms, bound_by, t_bytes, t_ops = bound(flops, nbytes)
    print(f"[{tag}] K2 at the prefill shape q {tuple(q.shape)} k/v "
          f"{tuple(k.shape)} bf16 causal window {win}, {meta} meta keys: max row err "
          f"{rel:.3e} of the row's norm (tol {ROW_TOL}), max abs err {err:.3e}; "
          f"kernel_ms={kernel_ms:.4f} ({flops / kernel_ms / 1e9:.2f} "
          f"TFLOP/s, {bound_ms / kernel_ms:.4f} of the bound) plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (SDPA, {'the mask as a boolean' if win else 'is_causal'}) "
          f"bound_ms={bound_ms:.5f} "
          f"by {bound_by} ({nbytes / 1e6:.1f} MB -> {t_bytes:.5f} ms, "
          f"{flops / 1e9:.2f} GFLOP -> {t_ops:.5f} ms)", flush=True)
    del q, k, v, qt, kt, vt, got
    torch.cuda.empty_cache()
    return dict(local_ms=kernel_ms, local_plain_ms=plain_ms, local_library_ms=library_ms,
                local_bound_ms=bound_ms, local_bound_by=bound_by, local_max_abs_err=err,
                local_max_row_err=rel)


def serve_model(tag, cfg, batch, prompt_len, gen_len, device, seed):
    """``serve.generate`` on random bf16 weights drawn on the card: K2
    launches (counted over the generate call alone), tokens and logits
    checked, times and peak memory printed; the weights are freed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(x.numel() * x.element_size() for x in leaves(params)) / 1e9
    prompts, image = serve.draw_inputs(cfg, batch, prompt_len, np.random.default_rng(seed),
                                       device)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.bwd_launches = 0
    out = serve.generate(cfg, params, prompts, gen_len=gen_len, temperature=0.0,
                         generator=gen, image_embeds=image)
    launches = {"fwd": fa.launches, "bwd": fa.bwd_launches}
    peak = torch.cuda.max_memory_allocated()
    want = attention_layers(cfg)
    if launches != {"fwd": want, "bwd": 0}:
        raise SystemExit(f"[{tag}] K2 launches {launches}, expected {want} forward "
                         "(one an attention-bearing layer, in prefill) and 0 backward")
    tokens = out.tokens
    want_shape = prompts.shape[:-1] + (gen_len,)
    if tokens.shape != want_shape:
        raise SystemExit(f"[{tag}] generated {tuple(tokens.shape)}, expected "
                         f"{tuple(want_shape)}")
    if not (0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab):
        raise SystemExit(f"[{tag}] token outside [0, vocab)")
    if not all(bool(torch.isfinite(lg).all()) for lg in out.logits):
        raise SystemExit(f"[{tag}] non-finite logits")
    decode_ms = out.decode_s / (gen_len - 1) * 1e3
    out_ms = (out.prefill_s * 1e3, decode_ms)
    tok_s = batch * gen_len / out.decode_s          # a step's K codebooks count once
    prefix = (f" after {image.shape[1]} image positions" if image is not None else
              f" x {cfg.n_codebooks} codebooks" if cfg.n_codebooks > 1 else "")
    print(f"[{tag}] {cfg.name} d_model {cfg.d_model}, {cfg.n_layers} layers, "
          f"{attention_desc(cfg)} ({cfg.n_params() / 1e9:.3f} B params, {weight_gb:.3f} GB of bf16 "
          f"weights drawn in {init_s:.1f} s), batch {batch} x {prompt_len} prompt{prefix}, "
          f"{gen_len} new, greedy: "
          f"prefill_ms={out.prefill_s * 1e3:.2f} decode_ms_per_step={decode_ms:.3f} "
          f"tokens_per_s={tok_s:.1f} peak_mem_gb={peak / 1e9:.3f} "
          f"k2_launches={launches['fwd']} k2_bwd_launches={launches['bwd']}; "
          f"row 0 starts {tokens[0, ..., :8].tolist()}", flush=True)
    del params, out, prompts, image
    torch.cuda.empty_cache()
    return dict(launches=launches["fwd"], peak_mem_gb=peak / 1e9,
                prefill_ms=out_ms[0], decode_ms_per_step=out_ms[1], tokens_per_s=tok_s)


def phase_serve_gemma3(device):
    local = phase_local_k2("serve-gemma3", GEMMA3_LOCAL, device, seed=8)
    c = GEMMA3_SERVE
    report = serve_model("serve-gemma3", get_config("gemma3-27b"), c["batch"],
                         c["prompt"], c["gen"], device, seed=9)
    return local, report


def phase_decode_vs_forward(device):
    """The port's decode against its own plain full forward, across the
    window, at two models' published widths (fp32, TF32 off)."""
    for name, arch, layers, windows, t in DECODE_CASES:
        cfg = get_config(arch)
        cfg = cfg.replace(n_layers=layers, windows=windows, layer_kinds=cfg.kinds[:layers],
                          param_dtype="float32", compute_dtype="float32")
        if cfg.moe is not None:        # drops depend on the batch: admit every token
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        gen = torch.Generator(device=device).manual_seed(10)
        params = init_params(cfg, gen, device)
        tokens, image = serve.draw_inputs(cfg, 2, t + DECODE_STEPS - 1,
                                          np.random.default_rng(10), device)
        n_prefix = cfg.meta_tokens + (0 if image is None else image.shape[1])
        with torch.inference_mode():
            full, *_ = tfm.model_forward(cfg, params, tokens, image)
            fa.launches = 0
            last, cache = tfm.prefill(cfg, params, tokens[..., :t - 1], image, use_flash=True)
            if fa.launches != attention_layers(cfg):
                raise SystemExit(f"[decode-vs-forward] {name}: {fa.launches} K2 launches "
                                 f"in prefill, expected {attention_layers(cfg)}")
            cache = tfm.grow_cache(cfg, cache, tokens.shape[-1] + n_prefix + 1)
            errs = [(last[:, 0] - full[:, t - 2]).abs().max().item()]
            for pos in range(t - 1, tokens.shape[-1]):
                logits, cache = tfm.decode_step(cfg, params, cache, tokens[..., pos:pos + 1])
                errs.append((logits[:, 0] - full[:, pos]).abs().max().item())
        if not max(errs) < DECODE_TOL:
            raise SystemExit(f"[decode-vs-forward] {name}: max abs errs {errs} over "
                             f"{DECODE_TOL}")
        print(f"[decode-vs-forward] {name} ({cfg.name}, {layers} {cfg.kinds[0]} layers, "
              f"{attention_desc(cfg)}, windows {windows}, {n_prefix} prefix positions, "
              f"{cfg.n_codebooks} codebooks, fp32, batch 2): prefill "
              f"{t - 1} tokens with flash, then "
              f"{DECODE_STEPS} decode steps vs the plain forward at T = "
              f"{tokens.shape[-1]}: max abs err prefill {errs[0]:.3e}, steps "
              f"{', '.join(f'{e:.3e}' for e in errs[1:])} (tol {DECODE_TOL})", flush=True)
        del params, full, last, cache, logits, tokens, image
        torch.cuda.empty_cache()


def phase_serve_mixtral(device):
    c = MIXTRAL_SERVE
    whole = get_config("mixtral-8x7b")
    cfg = whole.replace(n_layers=c["layers"], windows=(4096,) * c["layers"])
    print(f"[serve-mixtral] depth cut: {c['layers']} of {whole.n_layers} layers, "
          f"{cfg.n_params() * 2 / 1e9:.1f} of {whole.n_params() * 2 / 1e9:.1f} GB in bf16",
          flush=True)
    return serve_model("serve-mixtral", cfg, c["batch"], c["prompt"], c["gen"], device,
                       seed=11)


def phase_serve_deepseek(device):
    c = DEEPSEEK_SERVE
    whole = get_config("deepseek-v3-671b")
    cfg = whole.replace(n_layers=c["layers"])
    moe = sum(cfg.layer_moe[:c["layers"]])
    print(f"[serve-deepseek] depth cut: {c['layers']} of {whole.n_layers} layers "
          f"({c['layers'] - moe} dense, {moe} MoE), {cfg.n_params() * 2 / 1e9:.1f} of "
          f"{whole.n_params() * 2 / 1e9:.1f} GB in bf16", flush=True)
    report = serve_model("serve-deepseek", cfg, c["batch"], c["prompt"], c["gen"], device,
                         seed=21)
    if not report["peak_mem_gb"] < MEMORY_GB:
        raise SystemExit(f"[serve-deepseek] peak memory {report['peak_mem_gb']:.3f} GB, "
                         f"over {MEMORY_GB}")
    return report


def phase_serve_mamba2(device):
    c = MAMBA2_SERVE
    return serve_model("serve-mamba2", get_config("mamba2-370m"), c["batch"], c["prompt"],
                       c["gen"], device, seed=14)


def phase_serve_whole(tag, arch, serve_c, local_c, device, seed):
    """K2 alone at the arch's prefill shape, then the arch served whole;
    the local readings come back under ``<key>_local_*``."""
    key = tag.removeprefix("serve-")
    local = phase_local_k2(tag, local_c, device, seed=seed)
    report = serve_model(tag, get_config(arch), serve_c["batch"], serve_c["prompt"],
                         serve_c["gen"], device, seed=seed + 1)
    return {f"{key}_{k}": v for k, v in local.items()}, report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    device, smi = phase_probe()
    phase_build()
    q, k, v, err = phase_kernel(device)
    times = phase_timing(q, k, v, device)
    del q, k, v
    torch.cuda.empty_cache()
    phase_model(device)
    launches = phase_serve()
    k1_err = phase_k1(device)
    tune_launches, best_tile = phase_tune()
    k1_times = phase_k1_timing(device, best_tile)
    bwd_err, _ = phase_k2_bwd(device)
    bwd_times = phase_k2_bwd_timing(device)
    train_report = phase_train(device, smi)
    phase_train_launcher()
    gemma3_local, gemma3 = phase_serve_gemma3(device)
    phase_decode_vs_forward(device)
    mixtral = phase_serve_mixtral(device)
    hymba_local, hymba = phase_serve_whole("serve-hymba", "hymba-1.5b", HYMBA_SERVE,
                                           HYMBA_LOCAL, device, seed=12)
    phase_serve_mamba2(device)
    h2o_local, h2o = phase_serve_whole("serve-h2o", "h2o-danube-3-4b", H2O_SERVE, H2O_LOCAL,
                                       device, seed=15)
    phi3_local, phi3 = phase_serve_whole("serve-phi3", "phi-3-vision-4.2b", PHI3_SERVE,
                                         PHI3_LOCAL, device, seed=17)
    musicgen_local, musicgen = phase_serve_whole("serve-musicgen", "musicgen-large",
                                                 MUSICGEN_SERVE, MUSICGEN_LOCAL, device,
                                                 seed=19)
    deepseek = phase_serve_deepseek(device)
    sharded = phase_train_sharded(device, train_report)
    phase_train_compress(device, train_report)
    dots = phase_train_dots(device, train_report)
    ds = phase_ds_tune(device)
    blest = phase_blest(device, smi, ds["records"])
    evaluation = phase_evaluate(smi)
    closed = phase_closed_loop(device, smi, blest)
    serving = phase_serving(smi)
    # ds_launches: phases 26 and 27 (the ds-array and mesh paths launch none)
    ds_launches = {k: ds["launches"][k] + blest["launches"][k] for k in ds["launches"]}
    # eval_launches: phases 28-30 (evaluation, closed loop, serving: none)
    eval_launches = {k: evaluation["launches"][k] + closed["launches"][k]
                     + serving["launches"][k] for k in ds["launches"]}
    record = {"kernels": [
        # the times are the bf16 kernel's at the serving shape (train_4k
        # beside them, and gemma3-27b's local-layer shape as local_*); the
        # fp32 kernel and the C entry point that picks between them are in
        # flash_attention.cu (phase 3).  launches: the serve run's (phase
        # 6); tune_launches: the tune run's (phase 8); gemma3_launches,
        # mixtral_launches and hymba_launches: phases 14, 16 and 17, and
        # hymba-1.5b's local-layer shape as hymba_local_*; h2o_, phi3_ and
        # musicgen_launches and _local_*: phases 19-21 (d = 120, 96, 64);
        # deepseek_launches: phase 22 (MLA: 0); sharded_launches and
        # dots_launches: phases 23 and 25 over their 4 steps (phase 12's
        # count, train_launches, is the same); eval_launches: phases 28-30
        # (0: the evaluation, closed-loop and serving paths launch no kernel)
        dict(name="flash_attention_fwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_wgmma.cuh",
             fp32_source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:32",
             launches=launches, tune_launches=tune_launches["flash"],
             train_launches=train_report["launches"]["fwd"],
             gemma3_launches=gemma3["launches"], mixtral_launches=mixtral["launches"],
             hymba_launches=hymba["launches"], h2o_launches=h2o["launches"],
             phi3_launches=phi3["launches"], musicgen_launches=musicgen["launches"],
             deepseek_launches=deepseek["launches"],
             sharded_launches=sharded["launches"]["fwd"],
             dots_launches=dots["launches"]["fwd"], ds_launches=ds_launches["flash"],
             eval_launches=eval_launches["flash"], max_abs_err=err, **times,
             **gemma3_local, **hymba_local, **h2o_local, **phi3_local, **musicgen_local),
        # the times are the bf16 kernels' at train_4k (phase 11), and at
        # phi-3-vision's and h2o-danube's train_4k shapes as phi3_train_4k_*
        # and h2o_train_4k_*; the fp32 kernels and the C entry point that
        # picks between them are in flash_attention_bwd.cu (phase 10).
        # launches: the full-width train run's (phase 12); sharded_ and
        # dots_launches: phases 23 and 25
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_bwd_wgmma.cuh",
             fp32_source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:149",
             launches=train_report["launches"]["bwd"],
             sharded_launches=sharded["launches"]["bwd"],
             dots_launches=dots["launches"]["bwd"], ds_launches=ds_launches["flash_bwd"],
             eval_launches=eval_launches["flash_bwd"], max_abs_err=bwd_err,
             **bwd_times),
        # the times are the bf16 kernel's; the fp32 kernel and the C entry
        # point that picks between them are in matmul_blocked.cu (phase 7)
        dict(name="matmul_blocked", route="cuda",
             source="src/repro_torch/kernels/csrc/matmul_wgmma.cuh",
             fp32_source="src/repro_torch/kernels/csrc/matmul_blocked.cu",
             replaces="src/repro/kernels/matmul_blocked.py:20",
             launches=tune_launches["matmul"], ds_launches=ds_launches["matmul"],
             eval_launches=eval_launches["matmul"], max_abs_err=k1_err, **k1_times)]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
