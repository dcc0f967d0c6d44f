"""The fleet's wire and transports in the port (src/repro_torch/serve/
transport.py, launch/serve_worker.py): the frame codec with HMAC, the
loopback, process and socket transports, the transport spec and the
worker CLI -- the counterparts of tests/test_fleet.py's codec, transport
and CLI tests, each wait bounded on its own -- and parity with the JAX
package: byte-identical JSON frames that each package decodes from the
other, the same errors on torn, tampered and unsigned frames, and the
same answers over loopback and process workers started by fork and by
spawn."""
import os
import socket as socketlib
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from repro.serve import transport as jtransport
from repro_torch.serve import (FleetRouter, FrameAuthError, SocketTransport,
                               TransportDead, TransportSpec, make_diurnal_trace,
                               make_transport, serve_socket_worker)
from repro_torch.serve import transport as ttransport
from repro_torch.serve.transport import (LoopbackTransport, ProcessTransport,
                                         decode_frame, encode_frame, read_frame,
                                         write_frame)

from _torch_fleet import attached_worker, bounded, fitted, q, universe, wait_until

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _bounded():
    with bounded():
        yield


@pytest.fixture
def fitted_est():
    return fitted()


# ------------------------------------------------------------- frame codec
def test_frame_codec_json_and_pickle_roundtrip(fitted_est):
    plain = {"op": "predict", "queries": [[256, 16, "kmeans", {"w": 4}]]}
    frame = encode_frame(plain)
    assert frame[:1] == b"J"
    assert decode_frame(frame) == plain
    rich = {"op": "swap", "backend": fitted_est}
    frame = encode_frame(rich)
    assert frame[:1] == b"P"                  # model blob needs pickle
    back = decode_frame(frame)
    assert back["backend"].predict_partitions(*q(256, 16)) == \
        fitted_est.predict_partitions(*q(256, 16))
    assert type(back["backend"]).__module__ == "repro_torch.core.estimator"


def test_frame_codec_rejects_torn_frames():
    frame = encode_frame({"op": "ping"})
    with pytest.raises(ValueError):
        decode_frame(frame[:-2])              # truncated payload
    with pytest.raises(ValueError):
        decode_frame(b"X")                    # short/unknown


def test_frame_auth_roundtrip_tamper_and_missing_key():
    msg = {"op": "predict", "queries": [[256, 16, "kmeans", {"w": 4}]]}
    frame = encode_frame(msg, auth_key="s3cret")
    assert frame[:1] == b"j"                           # signed json tag
    assert decode_frame(frame, auth_key="s3cret") == msg
    bad = frame[:-1] + bytes([frame[-1] ^ 0xFF])
    with pytest.raises(FrameAuthError, match="mismatch|tampered"):
        decode_frame(bad, auth_key="s3cret")
    with pytest.raises(FrameAuthError, match="wrong shared key|mismatch"):
        decode_frame(frame, auth_key="other")
    with pytest.raises(FrameAuthError, match="no auth key"):
        decode_frame(frame)
    with pytest.raises(FrameAuthError, match="unauthenticated"):
        decode_frame(encode_frame(msg), auth_key="s3cret")
    # auth errors must never look like codec or transport failures
    assert not issubclass(FrameAuthError, (ValueError, TransportDead))


def test_frame_auth_covers_pickle_frames(fitted_est):
    frame = encode_frame({"backend": fitted_est}, auth_key="k")
    assert frame[:1] == b"p"
    back = decode_frame(frame, auth_key="k")
    assert back["backend"].predict_partitions(*q(256, 16)) == \
        fitted_est.predict_partitions(*q(256, 16))
    with pytest.raises(FrameAuthError):
        decode_frame(frame, auth_key="wrong")


# --------------------------------------- wire parity with the JAX package
MESSAGES = [
    {"op": "ping"},
    {"op": "predict", "queries": [[256, 16, "kmeans", {"n_workers": 4, "ram_gb": 16}],
                                  [1024, 64, "gmm", {"mem_limit_mb": 2048.0}]]},
    {"ok": True, "version": 3, "results": [[[4, 1], "model"], [[2, 2], "default"]],
     "hits": 7, "misses": 2, "invalidations": 0, "hit_rate": 0.7777777777777778},
    {"ok": False, "auth": False, "error": "frame rejected: naïve ✓ peer"},
    {"op": "stats", "nested": {"a": [1, 2.5, None, True], "b": {"c": "d"}}},
]
KEYS = [None, "s3cret", b"bytes-key", ""]


@pytest.mark.parametrize("key", KEYS, ids=repr)
@pytest.mark.parametrize("msg", MESSAGES, ids=lambda m: m.get("op", "reply"))
def test_json_frames_byte_identical_and_cross_decode(msg, key):
    mine, ref = ttransport.encode_frame(msg, key), jtransport.encode_frame(msg, key)
    assert mine == ref
    assert mine[:1] == (b"j" if key else b"J")
    assert ttransport.decode_frame(ref, key) == msg
    assert jtransport.decode_frame(mine, key) == msg


def _errors(mod, frame, key):
    try:
        mod.decode_frame(frame, key)
    except Exception as e:           # noqa: BLE001 - the type is the result
        return type(e).__name__, str(e)
    return None


def _bad_frames():
    msg = {"op": "predict", "queries": [[256, 16, "kmeans", {"w": 4}]]}
    plain = jtransport.encode_frame(msg)
    signed = jtransport.encode_frame(msg, "k")
    flipped = signed[:-1] + bytes([signed[-1] ^ 0x01])
    return [("torn plain", plain[:-2], None), ("torn signed", signed[:-3], "k"),
            ("short", b"J\x00", None), ("unknown tag", b"X" + plain[1:], None),
            ("unknown tag keyed", b"X" + plain[1:], "k"),
            ("tampered", flipped, "k"), ("wrong key", signed, "other"),
            ("signed to keyless", signed, None), ("unsigned to keyed", plain, "k"),
            ("header lies", plain[:1] + (999).to_bytes(4, "big") + plain[5:], None),
            ("mac cut", signed[:5 + 10], "k")]


@pytest.mark.parametrize("name,frame,key", _bad_frames(), ids=lambda v: v
                         if isinstance(v, str) else None)
def test_bad_frames_fail_alike_in_both_packages(name, frame, key):
    mine, ref = _errors(ttransport, frame, key), _errors(jtransport, frame, key)
    assert mine is not None and mine == ref, name
    assert mine[0] in ("ValueError", "FrameAuthError")


def test_wire_constants_are_the_reference_contract():
    assert ttransport.AUTH_KEY_ENV == jtransport.AUTH_KEY_ENV == "REPRO_AUTH_KEY"
    for name in ("_TAG_JSON", "_TAG_PICKLE", "_TAG_JSON_MAC", "_TAG_PICKLE_MAC",
                 "_MAC_LEN"):
        assert getattr(ttransport, name) == getattr(jtransport, name), name
    assert sorted(ttransport.__all__) == sorted(jtransport.__all__)


def test_socket_stream_frames_cross_packages():
    """A frame written by one package's ``write_frame`` reads back through
    the other's ``read_frame`` on a real socket pair, signed or not."""
    a, b = socketlib.socketpair()
    try:
        for key in (None, "k"):
            for msg in MESSAGES:
                jtransport.write_frame(a, msg, key)
                assert ttransport.read_frame(b, key) == msg
                ttransport.write_frame(b, msg, key)
                assert jtransport.read_frame(a, key) == msg
    finally:
        a.close()
        b.close()


# ------------------------------------------------------------- transports
def test_transport_dead_surfaces_on_kill(fitted_est):
    tp = ProcessTransport(fitted_est)
    try:
        assert tp.call({"op": "ping"}, timeout=30)["ok"]
        tp.kill()
        with pytest.raises(TransportDead):
            tp.call({"op": "ping"}, timeout=5)
    finally:
        tp.kill()
    lb = LoopbackTransport(fitted_est)
    lb.kill()
    with pytest.raises(TransportDead):
        lb.call({"op": "ping"})


def _answers(fitted_est, kind, trace, **kw):
    with FleetRouter(fitted_est, n_shards=2, replicas=1, transport=kind,
                     window_s=0.001, call_timeout_s=30.0, **kw) as fleet:
        return [fleet.request(query, timeout=60).value for (_k, query, _c) in trace]


def test_loopback_process_parity(fitted_est):
    """The same trace answered over both transports must be identical --
    the loopback path is a faithful stand-in for real processes."""
    trace = make_diurnal_trace(60, universe(), seed=5, pattern="spike")
    assert _answers(fitted_est, "loopback", trace) == \
        _answers(fitted_est, "process", trace)


@pytest.mark.parametrize("method", ["fork", "spawn"])
def test_loopback_process_parity_by_start_method(fitted_est, method):
    """Process workers started by ``fork`` and by ``spawn`` (the spawned
    one imports the port afresh and unpickles the backend by name) answer
    as the loopback path does."""
    trace = make_diurnal_trace(40, universe(), seed=6, pattern="spike")
    spec = TransportSpec(kind="process", mp_context=method)
    with FleetRouter(fitted_est, n_shards=2, replicas=1, transport=spec,
                     window_s=0.001, call_timeout_s=60.0) as fleet:
        got = [fleet.request(query, timeout=60).value for (_k, query, _c) in trace]
        pids = {r.transport.proc.pid for g in fleet.groups for r in g.replicas}
        ctx = {r.transport.proc._start_method for g in fleet.groups for r in g.replicas}
    assert got == _answers(fitted_est, "loopback", trace)
    assert len(pids) == 2 and ctx == {method}


def test_socket_transport_local_spawn_roundtrip(fitted_est):
    tp = SocketTransport(fitted_est)
    try:
        assert tp.alive and tp.worker_pid
        r = tp.call({"op": "predict", "queries": [list(q(256, 16))]}, timeout=30)
        assert r["ok"]
        assert tuple(r["results"][0][0]) == fitted_est.predict_partitions(*q(256, 16))
    finally:
        tp.close()
    assert not tp.alive


def test_loopback_socket_parity(fitted_est):
    """Answers over real TCP sockets must be identical to the in-process
    path."""
    trace = make_diurnal_trace(60, universe(), seed=5, pattern="spike")
    assert _answers(fitted_est, "loopback", trace) == \
        _answers(fitted_est, "socket", trace)


def test_socket_connect_refused_is_transport_dead(fitted_est):
    srv = socketlib.create_server(("127.0.0.1", 0))
    addr = "%s:%d" % srv.getsockname()[:2]
    srv.close()                              # nobody listening anymore
    with pytest.raises(TransportDead, match="serve-worker"):
        SocketTransport(fitted_est, address=addr, connect_timeout_s=2.0)


def test_socket_torn_frame_marks_transport_dead(fitted_est):
    """A peer that dies mid-frame poisons the stream: the call raises
    TransportDead and the transport stays dead."""
    srv = socketlib.create_server(("127.0.0.1", 0))
    addr = "%s:%d" % srv.getsockname()[:2]

    def misbehave():
        conn, _ = srv.accept()
        with conn:
            conn.settimeout(30)
            read_frame(conn)                 # the init frame
            write_frame(conn, {"ok": True, "pid": 0})
            read_frame(conn)                 # the predict...
            conn.sendall(b"J\x00\x00\x00\x10par")   # ...torn mid-payload

    th = threading.Thread(target=misbehave, daemon=True)
    th.start()
    try:
        tp = SocketTransport(fitted_est, address=addr)
        with pytest.raises(TransportDead, match="dropped mid-call"):
            tp.call({"op": "predict", "queries": [list(q(256, 16))]}, timeout=10)
        assert not tp.alive
        with pytest.raises(TransportDead):
            tp.call({"op": "ping"})              # dead stays dead
    finally:
        th.join(10)
        srv.close()


def test_socket_read_timeout_is_transport_dead(fitted_est):
    """A silent worker (connection up, no reply) is a dead worker once the
    call timeout lapses."""
    srv = socketlib.create_server(("127.0.0.1", 0))
    addr = "%s:%d" % srv.getsockname()[:2]
    release = threading.Event()

    def silent():
        conn, _ = srv.accept()
        with conn:
            conn.settimeout(30)
            read_frame(conn)
            write_frame(conn, {"ok": True, "pid": 0})
            read_frame(conn)                 # swallow the ping, say nothing
            release.wait(30)

    th = threading.Thread(target=silent, daemon=True)
    th.start()
    try:
        tp = SocketTransport(fitted_est, address=addr)
        with pytest.raises(TransportDead, match="silent"):
            tp.call({"op": "ping"}, timeout=0.2)
    finally:
        release.set()
        th.join(10)
        srv.close()


def test_socket_rejects_forged_and_unauthenticated_peers(fitted_est):
    srv, addr = attached_worker(serve_socket_worker, auth_key="fleet-secret")
    try:
        for bad_key in ("wrong-secret", None):
            with pytest.raises(FrameAuthError):
                SocketTransport(fitted_est, address=addr, auth_key=bad_key,
                                connect_timeout_s=10.0)
        # the right key serves normally on the same worker afterwards
        tp = SocketTransport(fitted_est, address=addr, auth_key="fleet-secret",
                             connect_timeout_s=10.0)
        try:
            r = tp.call({"op": "predict", "queries": [list(q(256, 16))]}, timeout=30)
            assert r["ok"]
        finally:
            tp.close()
    finally:
        srv.close()


# ------------------------------------------------------ spec and factory
def test_transport_spec_validation_and_factory(fitted_est, monkeypatch):
    with pytest.raises(ValueError, match="unknown transport"):
        TransportSpec(kind="bogus")
    with pytest.raises(ValueError):
        TransportSpec(kind="loopback", worker_addrs=("h:1",))
    with pytest.raises(ValueError):
        TransportSpec(kind="process", registry="reg.jsonl")
    with pytest.raises(ValueError):
        TransportSpec(kind="socket", worker_addrs=("no-port",))
    spec = TransportSpec(kind="socket", worker_addrs="a:1, b:2")
    assert spec.worker_addrs == ("a:1", "b:2")

    monkeypatch.setenv("REPRO_AUTH_KEY", "env-key")
    assert TransportSpec(kind="socket").resolved_auth_key() == b"env-key"
    assert TransportSpec(kind="socket", auth_key="").resolved_auth_key() is None
    assert TransportSpec(kind="socket", auth_key="mine").resolved_auth_key() == b"mine"

    tp = make_transport(TransportSpec(kind="loopback"), fitted_est)
    try:
        r = tp.call({"op": "predict", "queries": [list(q(256, 16))]}, timeout=30)
        assert r["ok"]
    finally:
        tp.close()


def test_transport_spec_matches_reference(tmp_path):
    for kw in ({"kind": "loopback"}, {"kind": "process", "mp_context": "spawn"},
               {"kind": "socket", "worker_addrs": "a:1, b:2", "auth_key": "x",
                "registry": str(tmp_path / "r.jsonl")}):
        mine, ref = ttransport.TransportSpec(**kw), jtransport.TransportSpec(**kw)
        assert mine.worker_addrs == ref.worker_addrs
        assert mine.transport_kw() == ref.transport_kw()
        assert mine.registry == ref.registry
    assert sorted(ttransport.TRANSPORTS) == sorted(jtransport.TRANSPORTS)


# ------------------------------------------------------------------- CLI
def _free_port():
    srv = socketlib.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    srv.close()
    return port


def test_serve_worker_cli_once(fitted_est):
    """``serve-worker``: binds the requested port, serves one attachment,
    exits on --once."""
    from repro_torch.launch.serve_worker import main as worker_main
    port = _free_port()
    th = threading.Thread(target=lambda: worker_main(["--listen", f"127.0.0.1:{port}",
                                                      "--once"]), daemon=True)
    th.start()
    box = {}

    def connect():
        try:
            box["tp"] = SocketTransport(fitted_est, address=f"127.0.0.1:{port}",
                                        connect_timeout_s=1.0)
        except TransportDead:
            return False
        return True

    assert wait_until(connect, timeout=10, poll=0.05), "never connected to the CLI worker"
    tp = box["tp"]
    assert tp.call({"op": "ping"}, timeout=10)["ok"]
    tp.close()
    th.join(10)
    assert not th.is_alive()                 # --once: exits after detach


def test_serve_worker_subprocess_prints_address_and_registers(fitted_est, tmp_path):
    """``python -m repro_torch serve-worker --listen 127.0.0.1:0`` prints the
    address it bound, announces it in the registry, serves a fleet and
    withdraws its lease when stopped."""
    from repro_torch.serve import WorkerRegistry
    reg = tmp_path / "reg.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch", "serve-worker",
                             "--listen", "127.0.0.1:0", "--register", str(reg),
                             "--auth-key", "k"],
                            stdout=subprocess.PIPE, text=True, env=env, cwd=tmp_path)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serve_worker listening on 127.0.0.1:"), line
        addr = line.split()[-1]
        assert wait_until(lambda: addr in WorkerRegistry(reg).addresses(), timeout=30)
        tp = SocketTransport(fitted_est, address=addr, auth_key="k", connect_timeout_s=10)
        assert tp.call({"op": "predict", "queries": [list(q(256, 16))]},
                       timeout=30)["ok"]
        tp.call({"op": "stop"}, timeout=10)        # ends the worker process
        tp.close()
        assert proc.wait(timeout=30) == 0
        assert WorkerRegistry(reg).addresses() == []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()


def test_unified_cli_dispatch():
    from repro_torch.launch.__main__ import COMMANDS, main
    assert {"tune", "evaluate", "serve-estimator", "serve-worker", "mesh",
            "train", "serve"} <= set(COMMANDS)
    assert COMMANDS["serve-worker"][0] == "repro_torch.launch.serve_worker"
    assert main([]) == 0                               # usage, not a crash
    assert main(["definitely-not-a-command"]) == 2


@pytest.mark.parametrize("name", ["serve_worker", "serve-worker",
                                  "serve_estimator", "serve-estimator"])
def test_unified_cli_takes_the_references_underscore_spellings(name, monkeypatch, capsys):
    """Both spellings of a hyphenated subcommand reach its launcher, as the
    reference's ``_ALIASES`` map them; an unknown name still exits 2."""
    from repro_torch.launch.__main__ import main
    monkeypatch.setattr(sys, "argv", list(sys.argv))   # main rewrites it
    with pytest.raises(SystemExit) as done:
        main([name, "--help"])
    assert done.value.code == 0
    assert f"python -m repro_torch {name.replace('_', '-')}" in capsys.readouterr().out
    assert main([name + "_nope"]) == 2


def test_unified_cli_entrypoint_subprocess():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch", "--help"],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0
    assert "serve-worker" in out.stdout
    bad = subprocess.run([sys.executable, "-m", "repro_torch", "nope"],
                         capture_output=True, text=True, timeout=120, env=env)
    assert bad.returncode == 2
    assert "unknown subcommand" in bad.stderr
