"""The port's ``tune`` CLI on the CPU, mirroring ``tests/test_launch_tune.py``:
the ds-array and mesh families against a tmp store (record counts by
source equal to the reference CLI's), all three families into one store,
idempotent re-runs, the ``--refit-demo`` invalidation walkthrough, and the
default store under ``$REPRO_ARTIFACTS``."""
import json

import pytest

from repro.data.logstore import LogStore as JStore
from repro.launch import tune as jtune
from repro_torch.data.logstore import LogStore as TStore
from repro_torch.data import logstore as tlogstore
from repro_torch.data import taskgraph as ttg
from repro_torch.launch import tune as ttune


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    return tmp_path_factory.mktemp("ttune") / "store.jsonl"


@pytest.fixture(scope="module")
def first_run(store_path):
    """One CLI run of the ds-array and mesh families against the tmp store."""
    ttg.reset_body_counts()
    out = ttune.main(["--device", "cpu", "--skip", "kernel", "--chips", "16",
                      "--store", str(store_path)])
    return out, dict(ttg.BODIES), store_path.read_text()


def test_cli_drives_the_ds_and_mesh_families(first_run, store_path, tmp_path):
    out, bodies, text = first_run
    srcs = TStore(store_path).sources()
    assert set(srcs) == {"grid_search", "mesh_grid"}
    # the reference CLI writes as many records by source
    jtune.main(["--skip", "kernel", "--chips", "16",
                "--store", str(tmp_path / "ref.jsonl")])
    assert srcs == JStore(tmp_path / "ref.jsonl").sources()
    lines = text.strip().splitlines()
    assert json.loads(lines[0])["kind"] == "logstore"
    assert all("source" in json.loads(ln) for ln in lines[1:])
    # every ds task body ran, and on the device asked for
    assert set(bodies) == {"cpu"} and bodies["cpu"] > 0
    assert set(out["ds"]["predictions"]) == {(1024, 32), (4096, 8)}
    dp, tp, mb = out["mesh"]["predictions"]["deepseek-7b"]
    assert dp * tp == 16 and mb >= 1
    assert out["sources"] == srcs


def test_cli_rerun_is_idempotent(first_run, store_path, capsys):
    n_before = len(store_path.read_text().splitlines())
    ttune.main(["--device", "cpu", "--skip", "kernel", "--chips", "16",
                "--store", str(store_path)])
    out = capsys.readouterr().out
    assert len(store_path.read_text().splitlines()) == n_before
    # the rerun still fits and predicts from the deduped store
    assert "kmeans 1024x32" in out and "deepseek-7b train_4k" in out


def test_cli_refit_demo_invalidates_service(first_run, store_path, capsys):
    out = ttune.main(["--device", "cpu", "--store", str(store_path), "--skip",
                      "kernel", "mesh", "--refit-demo"])
    text = capsys.readouterr().out
    assert "refit demo" in text and "retrained=True" in text
    assert "invalidations=1" in text
    assert "prediction before=" in text and "after=" in text
    refit = out["ds"]["refit"]
    assert refit["retrained"] is True and refit["invalidations"] == 1
    assert "mesh" not in out


def test_cli_runs_all_three_families_into_one_store(tmp_path):
    out = ttune.main(["--device", "cpu", "--backend", "sim", "--arch", "yi-6b",
                      "--chips", "16", "--store", str(tmp_path / "s.jsonl")])
    assert set(TStore(tmp_path / "s.jsonl").sources()) == {
        "grid_search", "kernel_grid", "kernel_measured", "mesh_grid"}
    assert len(out["predicted"]) == 14 and "ds" in out and "mesh" in out


def test_cli_keeps_each_devices_ds_records_apart(tmp_path, monkeypatch,
                                                 capsys):
    """A CPU run, then a card run (faked by a relabelled CPU run), into one
    store: the card's sweeps are appended beside the CPU's, not shadowed by
    them, and each run fits on its own device's records alone."""
    path = tmp_path / "s.jsonl"
    argv = ["--device", "cpu", "--skip", "kernel", "mesh", "--store", str(path)]
    cpu = ttune.main(argv)
    n = TStore(path).sources()["grid_search"]
    # the sweep tags the store's copies (logstore), the fit picks its own
    # device's records by the same tag (tune)
    for module in (tlogstore, ttune):
        monkeypatch.setattr(module, "ds_timing",
                            lambda device: {"timing": "wallclock:cuda"})
    card = ttune.main(argv)
    capsys.readouterr()
    store = TStore(path)
    assert store.sources()["grid_search"] == 2 * n
    assert card["ds"]["records"] == cpu["ds"]["records"] == n
    timing = [r.env["timing"] for r in store.load(source="grid_search").records]
    assert timing.count("wallclock:cpu") == timing.count("wallclock:cuda") == n


def test_cli_store_defaults_to_repro_artifacts(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    ttune.main(["--device", "cpu", "--skip", "kernel", "mesh"])
    capsys.readouterr()
    assert (tmp_path / "torch" / "tune_store.jsonl").exists()


def test_cli_refuses_the_card_it_does_not_have(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttune.main(["--skip", "kernel", "mesh",
                    "--store", str(tmp_path / "s.jsonl")])
    assert not (tmp_path / "s.jsonl").exists()
