"""The program's spans (``runtime/trace.py``) and its count of repeated k and
v bytes (``models/attention.py::kv_repeat_bytes``), on the CPU: which spans
a train step, a serve call and each family's layers record, that nothing is
recorded with tracing off, that ``NAMES`` is every name the program uses,
and how ``tools/profile_torch_serve.py::by_path`` attributes device and
idle time to span paths across threads (a hand-made event list)."""
import ast
import collections
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import reduced_config
from repro_torch.launch import serve
from repro_torch.launch.serve import scale_config
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_param_tree
from repro_torch.runtime import steps, trace
from repro_torch.runtime.optim import opt_state_specs
from repro_torch.runtime.tree import leaves
from repro_torch.weights import init_params

ROOT = Path(__file__).resolve().parents[1]
LAYERS, MICRO = 2, 2


def _tool():
    spec = importlib.util.spec_from_file_location(
        "profile_torch_serve", ROOT / "tools" / "profile_torch_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(arch="yi-6b", **replace):
    return scale_config(reduced_config(arch), d_model=128, n_layers=LAYERS, vocab=128,
                        heads=4).replace(**replace)


def _params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))


def _spans(prof):
    """(name, thread, start, end) of every span event of a profile."""
    return [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events() if e.name() in trace.NAMES]


def _traced(fn):
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
    finally:
        trace.disable()
    return prof


def _train_step(cfg):
    params = _params(cfg)
    opt = init_param_tree(opt_state_specs(cfg, tfm.param_specs(cfg)), None,
                          torch.device("cpu"))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (MICRO, 2, 16)))}
    return len(leaves(params)), lambda: steps.make_train_step(cfg)(params, opt, batch, 3)


@pytest.fixture(scope="module")
def train_trace():
    """A two-layer GQA train step, remat on, two microbatches, traced:
    (leaves, its span events, ``span_paths``' counts by path)."""
    cfg = _cfg(train_microbatches=MICRO, remat=True)
    assert cfg.n_kv_heads < cfg.n_heads
    n_leaves, step = _train_step(cfg)
    prof = _traced(step)
    return n_leaves, _spans(prof), _tool().span_paths(prof)[2]


@pytest.mark.parametrize("name,count", [
    ("train.step", lambda n: 1), ("train.microbatch", lambda n: MICRO),
    ("train.forward", lambda n: MICRO), ("train.backward", lambda n: MICRO),
    ("train.accumulate", lambda n: n * MICRO), ("train.optimizer", lambda n: 1),
    ("model.layer", lambda n: LAYERS * MICRO), ("model.recompute", lambda n: LAYERS * MICRO),
    ("model.head", lambda n: MICRO), ("attention.forward", lambda n: 2 * LAYERS * MICRO)])
def test_train_step_records_each_span(train_trace, name, count):
    n_leaves, spans, _ = train_trace
    assert sum(s[0] == name for s in spans) == count(n_leaves)


def test_train_step_spans_are_on_the_callers_thread(train_trace):
    """On the CPU autograd runs the backward on the caller's thread, so the
    hooks' and the recompute's spans nest under ``train.backward`` there."""
    _, spans, paths = train_trace
    assert len({tid for _, tid, _, _ in spans}) == 1
    back = "train.step/train.microbatch/train.backward"
    assert paths[f"{back}/model.recompute/attention.forward"] == LAYERS * MICRO
    assert paths[f"{back}/train.accumulate"] == sum(s[0] == "train.accumulate" for s in spans)
    assert paths["train.step/train.microbatch/train.forward/model.layer/attention.forward"] \
        == LAYERS * MICRO
    assert paths["train.step/train.optimizer"] == 1


def test_remat_off_names_no_recompute():
    _, step = _train_step(_cfg(train_microbatches=1, remat=False))
    names = collections.Counter(s[0] for s in _spans(_traced(step)))
    assert names["model.recompute"] == 0 and names["model.layer"] == LAYERS
    assert names["train.microbatch"] == 1


def test_off_records_nothing_and_makes_no_record_function(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(*a, **k):
        made.append(a)
        return real(*a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _, step = _train_step(_cfg(train_microbatches=MICRO, remat=True))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    assert _spans(prof) == [] and made == []
    assert trace.span("train.step") is trace.span("model.head")


def test_serve_generate_records_its_phases():
    cfg = _cfg()
    params, gen = _params(cfg), 4
    prompts = torch.randint(0, cfg.vocab, (2, 8))
    prof = _traced(lambda: serve.generate(cfg, params, prompts, gen_len=gen, temperature=0.0,
                                          generator=torch.Generator().manual_seed(0)))
    names = collections.Counter(s[0] for s in _spans(prof))
    assert names == {"serve.prefill": 1, "serve.grow_cache": 1, "serve.sample": gen,
                     "decode.step": gen - 1, "model.layer": LAYERS,
                     "attention.forward": LAYERS, "attention.decode": LAYERS * (gen - 1),
                     "model.head": gen}


@pytest.mark.parametrize("arch,names", [
    ("mixtral-8x7b", {"moe.apply"}), ("mamba2-370m", {"ssd.forward", "ssd.decode"}),
    ("hymba-1.5b", {"ssd.forward", "ssd.decode", "attention.forward", "attention.decode"}),
    ("deepseek-v3-671b", {"attention.forward", "attention.decode"})])
def test_each_family_records_its_blocks(arch, names):
    """A prefill and one decode step: each block's span once a layer that
    has it, a step."""
    cfg = _cfg(arch)
    params = _params(cfg)
    prompts = torch.randint(0, cfg.vocab, (2, 8))

    def run():
        with torch.no_grad():
            last, cache = tfm.prefill(cfg, params, prompts)
            cache = tfm.grow_cache(cfg, cache, cache["pos"] + 2)
            tfm.decode_step(cfg, params, cache, last[:, -1].argmax(-1)[:, None])
    got = collections.Counter(s[0] for s in _spans(_traced(run)))
    for name in names:
        assert got[name] >= 1, (name, got)
    if "moe.apply" in names:
        assert got["moe.apply"] == 2 * sum(cfg.layer_moe)


def _span_names_in(path: Path) -> set:
    """The string constants in the first argument of each ``trace.span``
    call of a source file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "span" and getattr(node.func.value, "id", "") == "trace"):
            out |= {c.value for c in ast.walk(node.args[0])
                    if isinstance(c, ast.Constant) and isinstance(c.value, str)}
    return out


def test_names_are_the_names_the_program_uses():
    used = set().union(*(_span_names_in(p)
                         for p in (ROOT / "src" / "repro_torch").rglob("*.py")))
    assert used == trace.NAMES


@pytest.mark.parametrize("kv,group", [(2, 2), (4, 1)], ids=["gqa", "mha"])
def test_kv_repeat_bytes_of_a_decode_step(kv, group):
    """One decode step repeats every layer's whole cache (k and v, capacity
    slots) ``group`` times; MHA repeats nothing."""
    cfg = _cfg(n_kv_heads=kv)
    params = _params(cfg)
    with torch.no_grad():
        last, cache = tfm.prefill(cfg, params, torch.randint(0, cfg.vocab, (2, 8)))
        cache = tfm.grow_cache(cfg, cache, 13)
        before = attn.kv_repeat_bytes
        tfm.decode_step(cfg, params, cache, last[:, -1].argmax(-1)[:, None])
    k = cache["stages"][0]["u0"]["k"]                  # [L, B, cap, kv, dh]
    assert k.shape[2] == 13
    want = 0 if group == 1 else LAYERS * 2 * k[0].numel() * group * k.element_size()
    assert attn.kv_repeat_bytes - before == want


# by_path on hand-made events (ns).  Thread 1 (the caller): a (0-100) holds
# b (10-40), then d (110-116); thread 2: c (50-70), as a backward's hook on
# autograd's thread.
SPANS = [(0, 100, 1, "a"), (10, 40, 1, "b"), (50, 70, 2, "c"), (110, 116, 1, "d")]
OPS = [(5, 15, (4, 1)),        # launched in a: a
       (15, 30, (12, 1)),      # in a/b
       (45, 55, (44, 2)),      # thread 2 has none open: the caller's a
       (60, 80, (55, 2)),      # in c on its own thread
       (85, 90, None),         # not linked
       (112, 118, (111, 1))]   # in d
# the device is busy over [5, 30], [45, 55], [60, 80], [85, 90], [112, 118]
# of [0, 130]: the gaps begin at 0 (a), 30 (a/b), 55 (a and c, by their
# starts), 80 and 90 (a) and 118 (outside)


@pytest.mark.parametrize("table,want", [
    (0, {"a": 20e-9, "a/b": 15e-9, "c": 20e-9, "outside the program": 5e-9, "d": 6e-9}),
    (1, {"a": 32e-9, "a/b": 15e-9, "a/c": 5e-9, "outside the program": 12e-9}),
    (2, {"a": 1, "a/b": 1, "c": 1, "d": 1})], ids=["device", "idle", "count"])
def test_by_path_on_two_threads(table, want):
    got = _tool().by_path(SPANS, OPS, 1, 0, 130)[table]
    assert got == pytest.approx(want)


def test_holding_sums_the_paths_that_hold_a_name():
    tool = _tool()
    table = {"a": 1.0, "a/b": 2.0, "x/ab": 4.0, "b/c": 8.0}
    assert tool.holding(table, "b") == 10.0
    assert tool.holding(table, "a") == 3.0
