"""The sharded step's layouts on a fake (2, 4) group: no rank builds a tensor
larger than the shard the reference's layout keeps, at the places where
DTensor's own choice of layout would build it whole.

The reference writes a ``constrain`` (``with_sharding_constraint``) at each
of these places, and under GSPMD the constraint picks the layout of the op
that makes the tensor.  The port makes each of them rank by rank instead
(``shardctx.local``, ``shardctx.grad_placed``), so each rank's local op
makes only its shard.  For the reduced configs of yi-6b, mixtral-8x7b,
gemma3-27b (FSDP, tied head) and deepseek-v3-671b (FSDP, MLA, expert
parallel MoE, MTP), a train cell (2 microbatches), a prefill and a decode
cell are run once as rank 0 of 8 under ``RankTrace``, and:

* the LM head's products make no more than the logits' shard
  ``("batch", None, "vocab")``, and the head returns that shard;
* the MoE dispatch gathers no more than its ``("experts", "moe_cap",
  None)`` shard of slots, and scatter-adds no more rows back (prefill
  dispatches its tokens in two groups, as a production prefill does above
  ``MAX_DISPATCH_TOKENS``);
* no collective runs inside a query chunk's attention (the chunks are cut
  small so that 40 tokens walk 5 of them): k and v are placed once;
* each layer's weight gradient leaves ``grad_placed`` in its leaf's
  placements, and each gradient accumulator is at its leaf's shard shape;
* the backward places a layer's weight gradients before it recomputes the
  layer below (per-layer remat), so no layer's gradient waits at the whole
  shape for the rest of the backward;
* no op of the rank's op list outputs a tensor of the global shape of a
  stacked leaf that the layout splits (what a ``select`` backward per
  layer, or a whole-shape accumulator, makes);
* no op, forward or backward, outputs attention scores or probabilities
  (a tensor ending in a query chunk's and the keys' lengths) with more
  than the rank's batch and heads shard of the scores' ``("batch",
  "heads", None, "attn_kv")``, in a train and a prefill cell whose
  (micro)batch gives each rank one sequence;
* where the rules split D of the MLP's weights (FSDP), no op outputs a
  tensor with the whole ffn dim (DTensor's product of the split D made
  whole-ffn pending sums);
* the prefill's ring cache is made at the shard of the cache's
  ``("batch", "kv_seq", "kv", None)``, and nothing inside its packing
  outputs more than the rank's batch and kv shard;
* where the scores split the key axis instead of the heads (hymba-1.5b,
  given the full config's group of 5 query heads to 1 kv head: 5 heads on
  a model axis of 4), no op, forward or backward, outputs scores or
  probabilities with the whole key axis;
* a decode step over a cache whose kv_seq splits makes scores only for the
  rank's shard of the cache;
* the SSD's ``[.., cl, cl]`` chunk blocks (mamba2-370m and hymba-1.5b) are
  made, forward and backward, at no more than the rank's shard of the
  reference's ``("batch", "ssm_chunks", None, None, None)``;
* under FSDP (gemma3-27b) each product of a GQA projection makes no more
  than the rank's batch and heads shard of its ``[B, T, H, dh]`` result, and
  each product of the output projection no more than the rank's batch
  shard of ``[B, T, D]``.

The cells of the last four run at one sequence a rank, where torch 2.13's
DTensor refused (and torch 2.11's refuses) to flatten the split batch and
heads of decode's scores and the split batch and chunks of the SSD's block.

Each cell runs in a subprocess of its own (this file as a script), so that
no pytest worker keeps a default process group.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240          # seconds, for one cell's subprocess
ARCHS = ("yi-6b", "mixtral-8x7b", "gemma3-27b", "deepseek-v3-671b")
MOE_ARCHS = ("mixtral-8x7b", "deepseek-v3-671b")
KINDS = ("train", "prefill", "decode")
MICROBATCHES = 2
SEQ = 40               # no dim of a reduced stacked leaf is 40: no shape coincides
BATCH = 8
DATA = 2               # the mesh's "data" dim, which the batch splits
SSD_CHUNK = 8
SSD_TOKENS = 64        # 8 chunks of the SSD, 2 a rank on the model dim of 4


# ----------------------------------------------------------- the subprocess

def _local_shape(shape, mesh, placements):
    shape = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            shape[p.dim] //= mesh.size(i)
    return shape


def config(arch):
    """The arch's reduced config; deepseek-v3's with a second MoE layer, so
    that its MoE stage stacks two layers (the full config stacks 58), and
    hymba's with 5 query heads to 1 kv head, which split no mesh axis of 4
    (its full config's 25 split none of 16)."""
    import dataclasses

    from repro_torch.configs import reduced_config

    cfg = reduced_config(arch)
    if arch == "hymba-1.5b":
        # the full config's group: 25 query heads to 5 kv heads
        cfg = cfg.replace(n_heads=5, n_kv_heads=1)
    if cfg.ssm is not None:
        # chunks of 8: no other dim of the SSD (16 heads of 16, a state of
        # 16) has a chunk's length, so its [.., cl, cl] blocks can be told
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=SSD_CHUNK))
    if arch == "deepseek-v3-671b":
        cfg = cfg.replace(n_layers=4, layer_kinds=cfg.kinds + cfg.kinds[-1:],
                          windows=cfg.layer_windows + cfg.layer_windows[-1:],
                          moe_layers=cfg.layer_moe + (True,))
    return cfg


def trace_cell(arch, kind, out, batch=BATCH, seq=SEQ):
    """Run the arch's cell of ``kind`` (global batch ``batch``, ``seq``
    tokens) on a fake (2, 4) group and write what each site made, and the
    op lines that made a split stacked leaf whole, attention scores past the
    rank's heads or keys, an FSDP MLP's whole ffn dim or an SSD chunk block
    past the rank's shard."""
    import contextlib
    import contextvars

    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention, moe, ssm
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import shardctx, steps
    from repro_torch.runtime.tree import leaves

    dryrun.get_config = config
    moe.MAX_DISPATCH_TOKENS = 160                 # prefill: 2 groups of 160
    attention._CHUNK_THRESHOLD, attention._CHUNK_Q = 512, 8   # 5 query chunks
    region = contextvars.ContextVar("region", default=None)
    sites = {}

    def record(name, **kw):
        sites.setdefault(name, []).append(kw)

    @contextlib.contextmanager
    def inside(name):
        tok = region.set(name)
        try:
            yield
        finally:
            region.reset(tok)

    class SiteTrace(dryrun.RankTrace):
        """``RankTrace`` that also notes the products made inside the head,
        the gathers and scatter-adds inside the MoE dispatch, and any
        collective inside a chunk's attention."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            n = len(self.ops)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            where = region.get()
            if where is None or len(self.ops) == n:
                return out
            line = self.ops[-1]
            outs = [list(x.shape) for x in dryrun._tensors(out)]
            if where == "head" and " flops=" in line:
                record("head_products", shapes=outs, line=line)
            elif where == "moe" and func is torch.ops.aten.index.Tensor:
                record("moe_gathers", shapes=outs, line=line)
            elif where == "moe" and func is torch.ops.aten.index_add.default:
                record("moe_combines", source=list(args[3].shape), line=line)
            elif where == "sdpa" and line.split(" ")[0] in dryrun.COLLECTIVES:
                record("sdpa_collectives", line=line)
            elif where == "ring":
                record("ring_ops", shapes=outs, line=line)
            elif where == "decode":
                record("decode_ops", shapes=[s for s, x in zip(outs, dryrun._tensors(out))
                                             if x.is_floating_point()], line=line)
            elif where in ("project", "out_project") and " flops=" in line:
                sites[where][-1]["products"].append({"shapes": outs, "line": line})
            return out

    head, dispatch, sdpa = tf.lm_head, moe._moe_dispatch, attention._sdpa
    attend, mlp, ring_pack = attention._attend, tf.mlp, tf._ring_pack
    layer = tf.layer_forward
    decode, project, ssd = attention.gqa_decode, attention._project, ssm.ssd_forward
    out_project = getattr(attention, "_out_project", None)

    def layer_forward(*a, **kw):
        # the backward's recompute of a layer (per-layer remat)
        if torch._C._current_autograd_node() is not None:
            record("backward", event="recompute")
        return layer(*a, **kw)

    def local_shape(shape, axes, mesh):
        return _local_shape(shape, mesh, shardctx.placements(shape, axes))

    def attend_rows(q, k, v, *a):
        # the query lengths of the chunks, and the rank's batch x heads rows
        # of the scores [B, H, T, S]
        b, t, h = q.shape[:3]
        s = k.shape[1]
        step = attention._CHUNK_Q if t * s >= attention._CHUNK_THRESHOLD else t
        rows = local_shape((b, h, t, s), ("batch", "heads", None, "attn_kv"), q.device_mesh)
        record("attend", s=s, chunks=sorted({min(step, t - c) for c in range(0, t, step)}),
               rows=rows[0] * rows[1], heads=h, local_heads=rows[1], local_keys=rows[3])
        return attend(q, k, v, *a)

    def mlp_ffn(params, x, act):
        shape = x.shape[:2] + params["wi"].shape[-1:]
        record("mlp", ffn=shape[-1], d=x.shape[-1],
               local_ffn=local_shape(shape, ("batch", None, "ffn"), x.device_mesh)[-1],
               fsdp=local_shape(params["wi"].shape, ("embed", "ffn"),
                                x.device_mesh)[0] < params["wi"].shape[0])
        return mlp(params, x, act)

    def ring(k, window, n_meta):
        with inside("ring"):
            r = ring_pack(k, window, n_meta)
        shape = (k.shape[0], window) + k.shape[2:]
        mesh = k.device_mesh
        record("ring", local=list(r.to_local().shape),
               want=local_shape(shape, ("batch", "kv_seq", "kv", None), mesh),
               batch_shard=local_shape(shape, ("batch", None, "kv", None), mesh))
        return r

    def lm_head(cfg, params, x):
        with inside("head"):
            y = head(cfg, params, x)
        axes = ("batch",) + (None,) * (y.ndim - 2) + ("vocab",)
        want = _local_shape(y.shape, y.device_mesh, shardctx.placements(y.shape, axes))
        record("head", local=list(y.to_local().shape), want=want)
        return y

    def moe_dispatch(cfg, p, x, router_mode):
        with inside("moe"):
            y = dispatch(cfg, p, x, router_mode)
        shape = (cfg.moe.n_experts, moe.capacity(x.shape[0] * x.shape[1], cfg.moe),
                 x.shape[2])
        pl = shardctx.placements(shape, ("experts", "moe_cap", None))
        record("moe", want=_local_shape(shape, x.device_mesh, pl))
        return y

    def ssd_forward(cfg, p, x, **kw):
        # the [B, nc, nh, cl, cl] blocks, T padded to whole chunks
        b, t0 = x.shape[:2]
        cl = min(cfg.ssm.chunk, t0)
        shape = (b, -(-t0 // cl), ssm._dims(cfg)[2], cl, cl)
        record("ssd", cl=cl, shard=_numel(local_shape(
            shape, ("batch", "ssm_chunks", None, None, None), x.device_mesh)))
        return ssd(cfg, p, x, **kw)

    def gqa_decode(p, x, cache, pos, **kw):
        k = cache["k"]
        record("decode_cache", s=k.shape[1], local_s=k.to_local().shape[1])
        with inside("decode"):
            return decode(p, x, cache, pos, **kw)

    def projected(x, w, heads):
        shape = x.shape[:2] + w.shape[1:]
        record("project", heads=heads, products=[], want=_numel(local_shape(
            shape, ("batch", None, heads, None), x.device_mesh)))
        with inside("project"):
            return project(x, w, heads)

    def out_projected(y, wo):
        record("out_project", products=[], want=_numel(local_shape(
            y.shape[:2] + wo.shape[-1:], ("batch", None, None), y.device_mesh)))
        with inside("out_project"):
            return out_project(y, wo)

    def chunk_sdpa(*a):
        with inside("sdpa"):
            return sdpa(*a)

    grad_placed_bwd = shardctx._GradPlaced.backward

    def placed_bwd(ctx, grad):
        record("backward", event="place")
        g = grad_placed_bwd(ctx, grad)
        mesh, want = ctx.spec
        record("grad_placed", local=list(g.to_local().shape),
               want=_local_shape(g.shape, mesh, want))
        return g

    accumulate = getattr(steps, "_accumulate", None)   # None: nothing to see

    def accumulated(acc, grads, dtype):
        acc = accumulate(acc, grads, dtype)
        record("accumulators", local=[list(a.to_local().shape) for a in acc])
        return acc

    tf.lm_head, moe._moe_dispatch, attention._sdpa = lm_head, moe_dispatch, chunk_sdpa
    attention._attend, tf.mlp, tf._ring_pack = attend_rows, mlp_ffn, ring
    tf.layer_forward = layer_forward
    attention.gqa_decode, attention._project = gqa_decode, projected
    ssm.ssd_forward = ssd_forward
    if out_project is not None:
        attention._out_project = out_projected
    shardctx._GradPlaced.backward = staticmethod(placed_bwd)
    if accumulate is not None:
        steps._accumulate = accumulated

    with dryrun.fake_group(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        shape = ShapeConfig("c", kind, int(seq), int(batch))
        cfg, fn, args, _ = dryrun.build_cell(
            arch, shape, mesh, microbatches=MICROBATCHES if kind == "train" else None)
        stages = args[0]["stages"]
        # stacks of two layers or more: a stack of one has a layer's size
        split = {tuple(x.shape) for st in stages for x in leaves(st)
                 if x.shape[0] > 1 and tuple(x.to_local().shape) != tuple(x.shape)}
        with SiteTrace(dryrun._tensors(args), keep_ops=True) as trace:
            fn(*args)
    # scores [.., tq, S] of a query chunk: at most the rank's rows of them
    scores = {}
    for a in sites.get("attend", []):
        for tq in a["chunks"]:
            scores[tq, a["s"]] = max(scores.get((tq, a["s"]), 0), a["rows"])
    # an FSDP MLP's [.., ffn] activations and sums, its [D, ffn] and [ffn, D]
    # weights and their gradients
    whole_ffn = {(m["ffn"], m["d"]) for m in sites.get("mlp", []) if m["fsdp"]}
    # scores [.., H, tq, S] of a query chunk over a split key axis: none whole
    whole_keys = {(tq, a["s"]): a["heads"] for a in sites.get("attend", [])
                  if a["local_keys"] < a["s"] for tq in a["chunks"]}
    # the SSD's [B, nc, nh, cl, cl] blocks: at most the rank's shard of them
    block = max(((s["cl"], s["shard"]) for s in sites.get("ssd", [])), default=None)
    whole, over_heads, ffn_lines, key_lines, block_lines = [], [], [], [], []
    blocks = 0
    for line in trace.ops:
        outs = line.split(" -> ", 1)[1] if " -> " in line else ""
        for m in re.finditer(r"(\w+)\[([\d, ]*)\]", outs):
            dims = tuple(int(v) for v in m.group(2).split(",") if v.strip())
            if dims in split:
                whole.append(line)
            ends = dims[-2:] if dims[-2:] in scores else dims[:-3:-1]   # [.., S, tq] too
            if len(dims) >= 3 and ends in scores and \
                    _numel(dims) > scores[ends] * ends[0] * ends[1]:
                over_heads.append(line)
            if len(dims) >= 2 and any(f == dims[-1] or (f, d) == dims[-2:]
                                      for f, d in whole_ffn):
                ffn_lines.append(line)
            floating = m.group(1).startswith(("float", "bfloat"))
            ends = dims[-2:] if dims[-2:] in whole_keys else dims[:-3:-1]
            if floating and len(dims) >= 3 and ends in whole_keys and \
                    _numel(dims) % (whole_keys[ends] * ends[0] * ends[1]) == 0:
                key_lines.append(line)
            if block and dims[-2:] == (block[0],) * 2:
                blocks += 1
                if _numel(dims) > block[1]:
                    block_lines.append(line)
    Path(out).write_text(json.dumps({
        "sites": sites,
        "leaves": [list(x.to_local().shape) for x in leaves(args[0])],
        "split_stacked": sorted(map(list, split)),
        "layer_leaves": sum(x.shape[0] for st in stages for x in leaves(st)),
        "whole": whole, "over_heads": over_heads, "whole_ffn": ffn_lines,
        "whole_keys": key_lines, "block": block, "blocks": blocks,
        "over_block": block_lines}))


# ------------------------------------------------------------------- tests

_TRACES = {}


def _trace(tmp_path_factory, arch, kind, batch=BATCH, seq=SEQ):
    if (arch, kind, batch, seq) not in _TRACES:
        tmp = tmp_path_factory.mktemp(f"{arch}-{kind}-{batch}-{seq}")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run([sys.executable, str(Path(__file__)), arch, kind,
                               str(tmp / "out.json"), str(batch), str(seq)],
                              cwd=tmp, env=env, capture_output=True, text=True,
                              timeout=TIMEOUT)
        assert proc.returncode == 0, proc.stderr[-4000:]
        _TRACES[arch, kind, batch, seq] = json.loads((tmp / "out.json").read_text())
    return _TRACES[arch, kind, batch, seq]


def _one_sequence_a_rank(kind):
    """The global batch that gives each data rank one sequence of each
    (micro)batch."""
    return DATA * (MICROBATCHES if kind == "train" else 1)


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_no_op_makes_a_split_stacked_leaf_whole(tmp_path_factory, arch, kind):
    cell = _trace(tmp_path_factory, arch, kind)
    assert cell["split_stacked"], "the layout splits no stacked leaf: nothing to hold"
    assert cell["whole"] == [], cell["whole"][:8]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_head_makes_only_its_shard_of_the_logits(tmp_path_factory, arch, kind):
    sites = _trace(tmp_path_factory, arch, kind)["sites"]
    heads = sites["head"]
    # the MTP module runs the head a second time in deepseek-v3's train cell
    assert len(heads) >= 1
    for h in heads:
        assert h["local"] == h["want"]
    want = max(_numel(h["want"]) for h in heads)
    assert sites.get("head_products"), "the head made no product"
    for p in sites["head_products"]:
        assert all(_numel(s) <= want for s in p["shapes"]), p["line"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_the_moe_dispatch_moves_only_its_experts_slots(tmp_path_factory, arch, kind):
    """The gather makes no more than the rank's ``xe`` shard, and the
    scatter-add back takes no more rows than the rank's slots."""
    sites = _trace(tmp_path_factory, arch, kind)["sites"]
    want = max(_numel(m["want"]) for m in sites["moe"])
    slots = max(m["want"][0] * m["want"][1] for m in sites["moe"])
    assert sites.get("moe_gathers"), "the dispatch gathered nothing"
    for g in sites["moe_gathers"]:
        assert all(_numel(s) <= want for s in g["shapes"]), g["line"]
    assert sites.get("moe_combines"), "the dispatch scattered nothing back"
    for c in sites["moe_combines"]:
        assert c["source"][0] <= slots, c["line"]


@pytest.mark.parametrize("kind", ("train", "prefill"))
@pytest.mark.parametrize("arch", ARCHS)
def test_no_query_chunk_resolves_k_or_v(tmp_path_factory, arch, kind):
    sites = _trace(tmp_path_factory, arch, kind)["sites"]
    assert sites.get("sdpa_collectives", []) == []


@pytest.mark.parametrize("kind", ("train", "prefill"))
@pytest.mark.parametrize("arch", ARCHS)
def test_full_sequence_attention_makes_only_its_heads_scores(tmp_path_factory, arch, kind):
    """Forward and backward (under per-layer remat in the train cell), each
    rank makes only its heads' scores and probabilities.  Each rank holds
    one sequence of each (micro)batch, as a rank of the production train_4k
    cells does: there DTensor's backward of the score einsums all-gathered
    the probabilities over heads, and here (torch 2.13) its view back from
    the flattened batch x heads dim, split twice, raises."""
    cell = _trace(tmp_path_factory, arch, kind, _one_sequence_a_rank(kind))
    attends = cell["sites"].get("attend", [])
    assert attends, "no full-sequence attention ran"
    for a in attends:
        assert a["local_heads"] < a["heads"], "the heads are not split"
        assert a["rows"] == a["local_heads"], "a rank holds more than one sequence"
    assert cell["over_heads"] == [], cell["over_heads"][:8]


@pytest.mark.parametrize("kind", ("train", "prefill"))
def test_the_fsdp_mlp_makes_no_whole_ffn_sum(tmp_path_factory, kind):
    cell = _trace(tmp_path_factory, "gemma3-27b", kind)
    mlps = cell["sites"].get("mlp", [])
    assert mlps and all(m["fsdp"] and m["local_ffn"] < m["ffn"] for m in mlps), mlps[:2]
    assert cell["whole_ffn"] == [], cell["whole_ffn"][:8]


@pytest.mark.parametrize("arch", ("mixtral-8x7b", "gemma3-27b"))
def test_the_ring_cache_is_made_at_its_shard(tmp_path_factory, arch):
    sites = _trace(tmp_path_factory, arch, "prefill")["sites"]
    rings = sites.get("ring", [])
    assert rings, "no windowed layer packed a ring"
    bound = max(_numel(r["batch_shard"]) for r in rings)
    for r in rings:
        assert r["want"] != r["batch_shard"], "the cache's kv_seq is not split"
        assert r["local"] == r["want"]
    assert sites.get("ring_ops"), "the packing made nothing"
    for op in sites["ring_ops"]:
        assert all(_numel(s) <= bound for s in op["shapes"]), op["line"]


@pytest.mark.parametrize("arch", ARCHS)
def test_each_layers_gradients_are_placed_before_the_next_recompute(tmp_path_factory, arch):
    """The backward places a layer's weight gradients as soon as the layer's
    backward has made them, before it recomputes the layer below.  A
    placement made for every layer before the forward's loop ran last in the
    backward (autograd runs the ready node made latest first), so every
    layer's gradient waited as a pending sum at the whole shape (deepseek-v3
    train_4k's expert gradients on pod16x16)."""
    events = [e["event"] for e in _trace(tmp_path_factory, arch, "train")["sites"]["backward"]]
    recomputes = [i for i, e in enumerate(events) if e == "recompute"]
    assert len(recomputes) >= 2 * MICROBATCHES, events[:40]
    for a, b in zip(recomputes, recomputes[1:]):
        assert "place" in events[a:b], events[max(0, a - 4):b + 4]


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_gradients_and_accumulators_are_at_the_shard_shape(tmp_path_factory, arch):
    cell = _trace(tmp_path_factory, arch, "train")
    placed = cell["sites"].get("grad_placed", [])
    # every layer's view of every stacked leaf, in each microbatch
    assert len(placed) >= MICROBATCHES * cell["layer_leaves"]
    for g in placed:
        assert g["local"] == g["want"]
    # each leaf's gradient is added as it is made, one leaf a call
    acc = cell["sites"].get("accumulators", [])
    assert len(acc) == MICROBATCHES * len(cell["leaves"])
    assert sorted(s for shapes in acc for s in shapes["local"]) == \
        sorted(cell["leaves"] * MICROBATCHES)


@pytest.mark.parametrize("kind", ("train", "prefill"))
def test_attention_over_a_split_key_axis_makes_only_its_keys_scores(tmp_path_factory, kind):
    """hymba-1.5b's heads split no mesh axis, so its scores split the key
    axis: forward and backward (per-layer remat in the train cell), no op
    outputs scores or probabilities of a query chunk with every key.
    DTensor's own einsums gathered every key's scores (``[4, 25, 4224,
    4224]`` fp32 a rank in the production train_4k cell)."""
    cell = _trace(tmp_path_factory, "hymba-1.5b", kind, _one_sequence_a_rank(kind))
    attends = cell["sites"].get("attend", [])
    assert attends, "no full-sequence attention ran"
    for a in attends:
        assert a["local_heads"] == a["heads"], "the heads split"
        assert a["local_keys"] < a["s"], "the key axis is not split"
        assert a["rows"] == a["local_heads"], "a rank holds more than one sequence"
    assert cell["whole_keys"] == [], cell["whole_keys"][:8]


@pytest.mark.parametrize("arch", ("yi-6b", "gemma3-27b"))
def test_decode_attention_runs_on_its_key_shard(tmp_path_factory, arch):
    """A decode step over a cache whose kv_seq splits over "model": no op
    of the step's attention outputs a floating tensor with the whole cache
    length (a cache of 24 slots, a length no other dim of the reduced
    configs has), and the scores are made on the rank's 6 slots.  At one
    sequence a rank DTensor's score einsum flattened q's split batch and
    heads and refused the view back."""
    cell = _trace(tmp_path_factory, arch, "decode", _one_sequence_a_rank("decode"), 24)
    caches = cell["sites"].get("decode_cache", [])
    assert caches, "no GQA decode ran"
    assert all(c["local_s"] < c["s"] for c in caches), caches[:2]
    s = {c["s"] for c in caches}
    local = {c["local_s"] for c in caches}
    ops = cell["sites"].get("decode_ops", [])
    whole = [o["line"] for o in ops if any(sh and sh[-1] in s for sh in o["shapes"])]
    assert whole == [], whole[:8]
    assert any(sh and sh[-1] in local for o in ops for sh in o["shapes"]), \
        "no scores were made on the key shard"


@pytest.mark.parametrize("kind", ("train", "prefill"))
@pytest.mark.parametrize("arch", ("mamba2-370m", "hymba-1.5b"))
def test_the_ssd_chunk_block_runs_on_its_chunk_shard(tmp_path_factory, arch, kind):
    """Forward and backward, no op outputs a ``[.., cl, cl]`` chunk block
    larger than the rank's shard of the reference's ``("batch",
    "ssm_chunks", None, None, None)``: 8 chunks of 8 tokens, 2 a rank on the
    model dim, one sequence a rank on the data dim.  DTensor's batched
    product flattened the split batch and chunk dims, all-gathered the
    blocks over the chunks, and at one sequence a rank its backward refused
    the view back."""
    # a train cell's tokens follow the reduced config's 8 meta tokens; a
    # prefill cell's prompt counts them
    meta = 8 if arch == "hymba-1.5b" and kind == "train" else 0
    cell = _trace(tmp_path_factory, arch, kind, _one_sequence_a_rank(kind),
                  SSD_TOKENS - meta)
    cl, shard = cell["block"]
    assert shard < _numel((1, SSD_TOKENS // cl, 16, cl, cl)), "the chunks are not split"
    assert cell["blocks"], "no chunk block was made"
    assert cell["over_block"] == [], cell["over_block"][:8]


@pytest.mark.parametrize("kind", ("train", "prefill"))
def test_the_fsdp_gqa_projections_make_only_their_heads(tmp_path_factory, kind):
    """gemma3-27b (FSDP): each product of a q, k or v projection makes no
    more than the rank's batch and heads shard of ``[B, T, H, dh]``, and
    each product of the output projection no more than the rank's batch
    shard of ``[B, T, D]``.  DTensor's einsum contracted the split D and
    made pending sums of every head (``[1, 65536, 4096]`` a rank in the
    production train_4k cell)."""
    sites = _trace(tmp_path_factory, "gemma3-27b", kind, _one_sequence_a_rank(kind))["sites"]
    projections = sites.get("project", [])
    assert any(p["heads"] == "heads" for p in projections), "no q projection ran"
    for p in projections:
        assert p["products"], "a projection made no product"
        for op in p["products"]:
            assert all(_numel(sh) <= p["want"] for sh in op["shapes"]), op["line"]
    out_projections = sites.get("out_project", [])
    assert out_projections, "no output projection ran"
    for p in out_projections:
        assert p["products"], "an output projection made no product"
        for op in p["products"]:
            assert all(_numel(sh) <= p["want"] for sh in op["shapes"]), op["line"]


if __name__ == "__main__":
    trace_cell(*sys.argv[1:])
