"""The port's dry-run (``launch/dryrun.py``): each cell's sharded step run
once as one rank on a fake process group, with meta locals.  The reference
compiles on a forced host mesh and reads XLA's HLO, whose run fails here
(``tests/test_sharding.py::test_subprocess_8dev_mini_dryrun``), so the port
is held to what can be checked exactly:

* the reference's mini dry-run, its four archs reduced on a (2, 4) mesh
  (mixtral-8x7b's kv heads and mamba2-370m's SSD chunks meet a model axis
  of 4 they do not divide): each prices with ``flops > 0`` and collectives;
* meta and real CPU locals on one fake (2, 4) group give the same
  collectives, per-rank flops and argument bytes;
* at (1, 1), per-rank flops equal ``FlopCounterMode`` on the plain step,
  for a train, a prefill and a decode cell;
* flash attention's shape rules: the plain version's shapes and dtypes, the
  operation counts of the bound, and no ``[B, H, T, S]`` score tensor in a
  ``--use-flash`` cell;
* ``shardctx.set_slot_``, the decode write into a sequence-split cache;
* the CLI on a full-width decode cell.

Every case that starts a fake group runs in a subprocess
(``tests/_torch_dryrun.py``), so no pytest worker keeps a default group.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dryrun
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref

ROOT = Path(__file__).resolve().parents[1]


def _case(tmp_path_factory, case):
    tmp = tmp_path_factory.mktemp(case)
    _torch_dryrun.run(tmp, case, tmp / "out.json")
    return json.loads((tmp / "out.json").read_text())


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return _case(tmp_path_factory, "mini")


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return _case(tmp_path_factory, "one_rank")


@pytest.mark.parametrize("arch", _torch_dryrun.MINI_ARCHS)
def test_mini_dryrun_on_a_2x4_mesh(mini, arch):
    rec = mini[arch]
    assert "error" not in rec, rec.get("error")
    assert rec["n_devices"] == 8 and rec["microbatches"] == 2
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert sum(c["count"] for c in rec["collectives"].values()) > 0
    assert all(c["bytes"] > 0 for c in rec["collectives"].values() if c["count"])
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    # the train step updates params and optimizer state in place
    assert 0 < mem["alias_size_in_bytes"] <= mem["output_size_in_bytes"]
    assert rec["mem_device_bytes"] == mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]


def test_meta_and_real_locals_price_alike(tmp_path_factory):
    out = _case(tmp_path_factory, "meta_vs_real")
    assert out["meta"] == out["real"]
    assert out["meta"]["flops"] > 0
    assert sum(c["count"] for c in out["meta"]["collectives"].values()) > 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_rank_flops_equal_flop_counter_on_the_plain_step(one_rank, kind):
    got = one_rank[kind]
    assert got["record"]["flops"] == got["plain_flops"] > 0


@pytest.mark.parametrize("kind,scores", [("prefill", "[8, 4, 32, 32]"),
                                         ("train", "[4, 4, 32, 32]")])
def test_flash_cell_holds_no_score_tensor(one_rank, kind, scores):
    """Reduced yi-6b (4 heads), T = S = 32: the plain cell makes the fp32
    ``[B, H, T, S]`` scores (B = 8, or 4 a microbatch), the flash cell goes
    through the shape rules and makes none, and counts their work."""
    plain, flash = one_rank[f"{kind}_flash0"], one_rank[f"{kind}_flash1"]
    assert f"float32{scores}" in plain["ops"]
    assert scores not in flash["ops"]
    assert "flash_attention_fwd" in flash["ops"] and "flash_attention_fwd" not in plain["ops"]
    assert ("flash_attention_bwd" in flash["ops"]) == (kind == "train")
    assert flash["record"]["flops"] > 0
    assert flash["record"]["memory"]["temp_size_in_bytes"] <= \
        plain["record"]["memory"]["temp_size_in_bytes"]


def test_set_slot_writes_only_the_owning_shard(tmp_path_factory):
    out = _case(tmp_path_factory, "set_slot")
    for name, slot in (("model_own", 2), ("both_own", 3), ("two_dims_own", 1)):
        local = np.array(out[name]["local"])
        assert (local[:, slot] == 1).all() and local.sum() == local[:, slot].size, name
    for name in ("model_other", "two_dims_other"):
        assert not np.array(out[name]["local"]).any(), name
    for name, rec in out.items():
        if name != "placed_like":
            assert all(c["count"] == 0 for c in rec["collectives"].values())
    # shardctx.placed_like: the merge's layout, its pending sum as replicated
    assert out["placed_like"] == {"placements": ["S(0)", "R"], "local": [8, 3], "plain": 2}


def test_set_slot_on_a_plain_tensor():
    from repro_torch.runtime.shardctx import set_slot_

    x = torch.zeros(2, 5, 3)
    set_slot_(x, 1, 4, torch.ones(2, 3))
    assert x[:, 4].eq(1).all() and x.sum() == 6


# (b, t, s, h, kv, d, window, n_meta, causal, dtype)
SHAPE_CASES = [(2, 64, 64, 4, 2, 32, 0, 0, True, torch.float32),
               (1, 48, 80, 4, 1, 64, 16, 4, True, torch.bfloat16),
               (2, 40, 40, 4, 4, 32, 0, 0, False, torch.float32)]


@pytest.mark.parametrize("case", SHAPE_CASES, ids=lambda c: f"t{c[1]}s{c[2]}w{c[6]}")
def test_flash_shape_rules_match_the_plain_version(case):
    b, t, s, h, kv, d, window, n_meta, causal, dtype = case
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype)
               for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d)))
    kw = dict(scale=d ** -0.5, window=window, n_meta=n_meta, causal=causal)
    want = fa.flash_attention_plain(q, k, v, **kw)
    work = []
    fa.shape_rule_hook = lambda *a: work.append(a[:3])
    try:
        meta = [x.to("meta") for x in (q, k, v)]
        o, lse = fa.flash_attention_shape(*meta, return_lse=True, **kw)
        assert (o.shape, o.dtype, o.device.type) == (want.shape, want.dtype, "meta")
        assert (lse.shape, lse.dtype) == ((b, h, t), torch.float32)
        assert ops.flash_attention(*meta, **kw).shape == want.shape
        # the gradient through the autograd Function: the shape rules both ways
        leaves = [x.requires_grad_(True) for x in meta]
        grads = torch.autograd.grad(ops.flash_attention(*leaves, **kw), leaves,
                                    torch.empty(want.shape, dtype=dtype, device="meta"))
    finally:
        fa.shape_rule_hook = None
    for g, x in zip(grads, (q, k, v)):
        assert (g.shape, g.dtype, g.device.type) == (x.shape, x.dtype, "meta")
    assert fa.launches == 0 and fa.bwd_launches == 0
    # live pairs: the unmasked entries of the oracle's mask
    qpos = torch.arange(t)[:, None] + (s - t)
    kpos = torch.arange(s)[None, :]
    mask = torch.ones(t, s, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
        if window:
            mask &= ((qpos - kpos) < window) | (kpos < n_meta)
    live = int(mask.sum())
    assert fa.live_pairs(t, s, window=window, n_meta=n_meta, causal=causal) == live
    fwd = 4 * d * b * h * live
    names = [w[0] for w in work]
    assert names == ["flash_attention_fwd"] * 3 + ["flash_attention_bwd"]
    assert [w[1] for w in work] == [fwd, fwd, fwd, fwd * 5 // 2]
    # the oracle agrees with the plain version on this case, as a check of
    # the mask the count was held to
    ref = flash_attention_ref(q.float(), k.float().repeat_interleave(h // kv, 2),
                              v.float().repeat_interleave(h // kv, 2), **kw)
    np.testing.assert_allclose(want.float().numpy(), ref.numpy(), atol=3e-2)


def test_importing_the_dryrun_starts_no_group():
    import torch.distributed as dist

    import repro_torch.launch.dryrun  # noqa: F401

    assert not dist.is_initialized()


def test_cli_prices_a_full_width_decode_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "dryrun", "--arch", "mamba2-370m",
         "--shape", "long_500k", "--out", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "dry-run complete: all cells compiled."
    assert lines[-2].startswith("[ok] mamba2-370m x long_500k x pod16x16: flops=")
    rec = json.loads((tmp_path / "mamba2-370m__long_500k__pod16x16.json").read_text())
    assert rec["n_devices"] == 256 and rec["flops"] > 0
    assert set(rec["collectives"]) == {"all-gather", "all-reduce", "reduce-scatter",
                                       "all-to-all", "collective-permute"}
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                  "temp_size_in_bytes", "alias_size_in_bytes"}
    # decode donates its cache: the cache comes back in the same storage
    assert rec["memory"]["alias_size_in_bytes"] > 0


def test_cli_reports_a_failing_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "dryrun", "--arch", "no-such-arch",
         "--shape", "train_4k", "--out", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0
    assert "[FAIL] no-such-arch x train_4k x pod16x16: " in proc.stdout
    assert "1 cell(s) failed" in proc.stderr
