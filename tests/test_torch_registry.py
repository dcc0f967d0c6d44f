"""The fleet's lease registry in the port (src/repro_torch/serve/
registry.py): the counterparts of tests/test_fleet.py's registry, lease
keeper and adoption tests, each wait bounded on its own, and parity with
the JAX package -- one lease file, written by either package's
``WorkerRegistry``, lists the same live workers in the other's."""
import json
import time

import pytest

from repro.serve import registry as jregistry
from repro_torch.serve import (FleetRouter, HeartbeatPolicy, LeaseKeeper,
                               TransportSpec, WorkerRegistry, serve_socket_worker)
from repro_torch.serve import registry as tregistry

from _torch_fleet import attached_worker, bounded, fitted, q, wait_until


@pytest.fixture(autouse=True)
def _bounded():
    with bounded():
        yield


@pytest.fixture
def fitted_est():
    return fitted()


def test_registry_lease_lifecycle(tmp_path):
    reg = WorkerRegistry(tmp_path / "reg.jsonl")
    reg.announce("h:1", ttl_s=10.0, now=100.0, caps={"cores": 8})
    reg.announce("h:2", ttl_s=10.0, now=101.0)
    assert reg.addresses(now=105.0) == ["h:1", "h:2"]
    assert reg.lease("h:1")["caps"] == {"cores": 8}
    # h:1 lapses at 110; a heartbeat extends it
    reg.heartbeat("h:1", now=108.0)
    assert reg.addresses(now=112.0) == ["h:1"]         # h:2 expired
    assert [s["addr"] for s in reg.stale(now=112.0)] == ["h:2"]
    reg.withdraw("h:1")
    assert reg.addresses(now=112.0) == []


def test_registry_stale_lease_expires_for_second_reader(tmp_path):
    """Leases are a property of the *file*, not the instance."""
    path = tmp_path / "reg.jsonl"
    WorkerRegistry(path).announce("w:7", ttl_s=5.0, now=50.0)
    reader = WorkerRegistry(path)
    assert reader.addresses(now=54.0) == ["w:7"]
    assert reader.addresses(now=55.0) == []            # ts + ttl <= now
    WorkerRegistry(path).heartbeat("w:7", now=54.0)
    assert reader.addresses(now=58.0) == ["w:7"]


def test_lease_keeper_heartbeats_and_withdraws(tmp_path):
    reg = WorkerRegistry(tmp_path / "reg.jsonl")
    keeper = LeaseKeeper(reg, "k:1", ttl_s=0.5).start()
    try:
        first = reg.lease("k:1")["ts"]
        assert wait_until(lambda: reg.lease("k:1")["ts"] > first, timeout=10)
    finally:
        keeper.stop()
    assert reg.addresses() == []                       # withdrawn on stop
    assert keeper.refreshes >= 1


def test_registry_skips_torn_and_garbage_lines(tmp_path):
    """A writer that died mid-line never poisons a reader, and the next
    append terminates the torn line instead of fusing onto it."""
    path = tmp_path / "reg.jsonl"
    reg = WorkerRegistry(path)
    reg.announce("a:1", ttl_s=100.0, now=10.0)
    with path.open("a") as f:
        f.write('"just a string"\n{"op": "bogus", "addr": "x:1"}\n{"op": "announ')
    reader = WorkerRegistry(path)
    assert reader.addresses(now=20.0) == ["a:1"]
    assert reader.skipped_lines == 2
    reader.announce("b:2", ttl_s=100.0, now=11.0)
    again = WorkerRegistry(path)
    assert again.addresses(now=20.0) == ["a:1", "b:2"]
    assert again.skipped_lines == 3


# ----------------------------------------------- parity with the JAX package
def _script(reg, now):
    reg.announce("h:1", ttl_s=10.0, now=now, caps={"cores": 8, "pid": 1})
    reg.announce("h:2", ttl_s=4.0, now=now + 1, started_at=now - 5)
    reg.announce("h:3", ttl_s=10.0, now=now + 2)
    reg.heartbeat("h:2", now=now + 4)
    reg.withdraw("h:3")
    reg.heartbeat("ghost:9", now=now + 4)


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_lease_file_reads_alike_across_packages(tmp_path, writer, reader):
    mods = {"torch": tregistry, "jax": jregistry}
    path = tmp_path / "reg.jsonl"
    _script(mods[writer].WorkerRegistry(path), 100.0)
    theirs = mods[reader].WorkerRegistry(path)
    ours = mods[writer].WorkerRegistry(path)
    for now in (100.5, 103.0, 107.0, 108.5, 111.0, 120.0):
        assert theirs.workers(now=now) == ours.workers(now=now), now
        assert theirs.stale(now=now) == ours.stale(now=now), now
    # oldest start first; a refresh of an address never announced reads
    # as a lease with no start, for late readers in both packages
    assert theirs.addresses(now=107.0) == ["ghost:9", "h:2", "h:1"]
    # the reader appends too, and the writer folds what it wrote
    theirs.announce("h:4", ttl_s=10.0, now=109.0)
    assert ours.addresses(now=109.5) == theirs.addresses(now=109.5) == \
        ["ghost:9", "h:1", "h:4"]
    assert ours.addresses(now=110.0) == theirs.addresses(now=110.0) == ["ghost:9", "h:4"]


def test_lease_files_are_byte_identical(tmp_path):
    paths = {}
    for name, mod in (("torch", tregistry), ("jax", jregistry)):
        paths[name] = tmp_path / f"{name}.jsonl"
        _script(mod.WorkerRegistry(paths[name]), 100.0)
    assert paths["torch"].read_bytes() == paths["jax"].read_bytes()
    first = json.loads(paths["torch"].read_text().splitlines()[0])
    assert first == {"schema": 1, "kind": "worker-registry"}


def test_default_caps_keys_match_reference():
    assert set(tregistry.default_caps()) == set(jregistry.default_caps())
    assert tregistry.DEFAULT_TTL_S == jregistry.DEFAULT_TTL_S


def test_port_worker_lease_seen_by_reference_reader(tmp_path):
    """A port worker's lease keeper announces into a file that the
    reference's registry reads live, and its withdrawal shows there too."""
    path = tmp_path / "reg.jsonl"
    keeper = LeaseKeeper(WorkerRegistry(path), "127.0.0.1:7071", ttl_s=5.0,
                         caps=tregistry.default_caps()).start()
    try:
        ref = jregistry.WorkerRegistry(path)
        assert ref.addresses() == ["127.0.0.1:7071"]
        assert ref.lease("127.0.0.1:7071")["caps"]["cores"] >= 1
    finally:
        keeper.stop()
    assert ref.addresses() == []


# ------------------------------------------------------- fleet adoption
def test_registry_adoption_and_flapping_rejoin(fitted_est, tmp_path):
    """A registered worker is adopted without any --workers flag; when it
    dies and later re-announces, one poll re-adopts it -- and a poll with
    nothing new never double-attaches."""
    regpath = tmp_path / "reg.jsonl"
    reg = WorkerRegistry(regpath)
    spec = TransportSpec(kind="socket", registry=regpath)
    # the fleet forks its local worker before the in-test worker binds: a
    # worker forked after would hold the listening socket open past
    # srv.close(), and the reattach below would wait out its connect
    # timeout on a backlog nobody accepts (ROADMAP §3)
    fleet = FleetRouter(fitted_est, n_shards=1, transport=spec,
                        window_s=0.001, call_timeout_s=30.0,
                        heartbeat=HeartbeatPolicy(interval_s=0.05, timeout_s=5.0,
                                                  miss_after=2))
    srv, addr = attached_worker(serve_socket_worker)
    reg.announce(addr, ttl_s=600.0)
    srv2 = None
    try:
        assert fleet.poll_registry() == [addr]
        assert fleet.n_replicas == 2                   # local + adopted
        assert fleet.poll_registry() == []             # no double-attach
        # the worker flaps: server gone, established conn torn silently
        srv.close()
        fleet.silent_kill(0, replica=1)
        assert wait_until(lambda: fleet.stats()["heartbeat_replacements"] >= 1,
                          timeout=60, tick=fleet.prober.probe_once)
        assert fleet.stats()["heartbeat_replacements"] == 1
        assert fleet.request(q(256, 16), timeout=60).value
        # it comes back (new bind, new announce; the dead lease lingers
        # un-servable) and one poll re-adopts exactly once
        srv2, addr2 = attached_worker(serve_socket_worker)
        reg.announce(addr2, ttl_s=600.0)
        assert fleet.poll_registry() == [addr2]
        assert fleet.poll_registry() == []
        assert fleet.stats()["adoptions"] == 2
        assert fleet.request(q(512, 16), timeout=60).value
    finally:
        fleet.close()
        srv.close()
        if srv2 is not None:
            srv2.close()


def test_adoption_follows_live_demand(fitted_est, tmp_path):
    """An adopted worker joins the shard the live served histogram says
    needs capacity most, and a stale lease is never attached."""
    regpath = tmp_path / "reg.jsonl"
    reg = WorkerRegistry(regpath)
    servers = []
    try:
        fleet = FleetRouter(fitted_est, n_shards=2, transport=TransportSpec(
            kind="socket", registry=regpath), window_s=0.001, call_timeout_s=30.0)
        try:
            hot = next(query for query in (q(n, m) for n, m in
                                           ((256, 16), (512, 16), (128, 32), (64, 8),
                                            (1024, 64)))
                       if fleet.shard_for(query) == 1)
            for _ in range(20):
                fleet.request(hot, timeout=30)
            reg.announce("127.0.0.1:9", ttl_s=1.0, now=time.time() - 60)   # lapsed
            srv, addr = attached_worker(serve_socket_worker)
            servers.append(srv)
            reg.announce(addr, ttl_s=600.0)
            assert fleet.poll_registry() == [addr]
            reps = {p["shard"]: p["replicas"] for p in fleet.stats()["per_shard"]}
            assert reps == {0: 1, 1: 2}
        finally:
            fleet.close()
    finally:
        for srv in servers:
            srv.close()
