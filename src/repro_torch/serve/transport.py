"""Wire framing and transports for the serving fleet (DESIGN.md §13), the
port of the JAX package's ``repro/serve/transport.py``.

The fleet splits the serving tier into a *management layer*
(``serve/fleet.py``'s :class:`FleetRouter`: admission, routing, replica
groups, autoscaling) and *shard workers* (the compute side: one
``TunerService`` replica each).  This module is the boundary between
them:

* **Frames** — every message crosses the boundary as a length-prefixed
  frame: 1 codec tag byte (``J`` = compact JSON for plain requests and
  replies, ``P`` = pickle for payloads JSON cannot carry, e.g. a model
  blob in a swap) + 4-byte big-endian payload length + payload.  One
  codec for both transports, so the loopback path exercises the exact
  bytes the process path ships.  A JSON frame is the reference's byte
  for byte (tags, HMAC, ``$REPRO_AUTH_KEY``: the wire contract), so the
  two packages read each other's; a pickle frame carries this package's
  own classes.
* :class:`ShardWorker` — the worker-side request handler: predict
  batches through the replica's ``submit()``/``flush()`` path with the
  abstain fallback applied *inside* the worker (memo-bypassing, same as
  ``serve/router.py``'s in-process shard), plus swap/stats/ping/crash
  ops.
* :class:`LoopbackTransport` — the worker in a thread of the caller's
  process, but every message still round-trips through the frame codec.
  This is the deterministic path; its parity with the process transport
  is asserted in tests/test_torch_transport.py.
* :class:`ProcessTransport` — the worker in a real
  ``multiprocessing.Process``, frames shipped over a duplex pipe.  A
  dead worker (crash injection, OOM-kill) surfaces as
  :class:`TransportDead` on the in-flight call, which is what the
  fleet's crash-respawn path keys on.
* :class:`SocketTransport` — the worker behind a TCP connection, the
  same frames length-prefix-streamed over the socket.  With no
  ``address`` it spawns a local worker process on an ephemeral
  loopback port (a drop-in for ProcessTransport); with
  ``address="host:port"`` it *attaches* to a worker someone else
  started — ``python -m repro_torch serve-worker --listen host:port``
  on another node.  The first frame on every connection is an ``init``
  op carrying the model, so the management layer always decides what
  an attached worker serves.  Connect failures, read timeouts, torn
  frames, and peer resets all surface as :class:`TransportDead` —
  to the fleet a dropped connection *is* a worker loss, and its crash
  recovery (retire → respawn/reattach → re-route orphans) applies
  unchanged.
* **Authenticated frames** — with a shared secret (``auth_key=``,
  ``--auth-key``, or ``$REPRO_AUTH_KEY``) every frame carries an
  HMAC-SHA256 tag over the header and payload.  A tampered,
  unauthenticated, or wrong-key frame raises :class:`FrameAuthError` —
  a *typed* rejection distinct from :class:`TransportDead`, because an
  untrusted peer is not a dead worker and must not trigger the crash
  respawn path as if it were one.
* :class:`TransportSpec` — the one validated description of "how do I
  reach my workers" (kind, addresses, auth key, timeouts, registry
  path) shared by the CLI, :class:`~repro_torch.serve.fleet.FleetRouter`,
  the examples, and the benchmarks; :func:`make_transport` builds a
  live transport from it.
"""
from __future__ import annotations

import hmac
import json
import multiprocessing as mp
import os
import pickle
import socket
import threading
from dataclasses import dataclass
from pathlib import Path

from repro_torch.core.estimator import EstimatorService
from repro_torch.data.executor import Environment
from repro_torch.eval.autorun import default_partitioning

__all__ = ["TransportDead", "FrameAuthError", "ShardWorker",
           "LoopbackTransport", "ProcessTransport", "SocketTransport",
           "TransportSpec", "make_transport", "encode_frame",
           "decode_frame", "read_frame", "write_frame",
           "serve_socket_worker", "default_abstain_fallback",
           "AUTH_KEY_ENV"]

_TAG_JSON = b"J"
_TAG_PICKLE = b"P"
_TAG_JSON_MAC = b"j"          # authenticated variants: lowercase tag,
_TAG_PICKLE_MAC = b"p"        # 32-byte HMAC-SHA256 between header+payload
_MAC_LEN = 32
AUTH_KEY_ENV = "REPRO_AUTH_KEY"


class TransportDead(RuntimeError):
    """The worker behind this transport is gone (killed, crashed, or
    closed); the in-flight call — if any — was never answered."""


class FrameAuthError(RuntimeError):
    """A frame failed authentication: unauthenticated where a key is
    configured, authenticated where none is, or an HMAC mismatch
    (tampered bytes or a wrong shared secret).  Deliberately *not* a
    :class:`TransportDead` and not a ``ValueError``: an untrusted peer
    is a policy rejection, not a worker loss, so the fleet's
    crash-respawn machinery must not treat it as one."""


def _key_bytes(auth_key) -> bytes | None:
    """Normalize an auth key (str/bytes/None); empty means disabled."""
    if auth_key is None or auth_key == "" or auth_key == b"":
        return None
    return auth_key.encode() if isinstance(auth_key, str) else bytes(auth_key)


def auth_key_from_env() -> str | None:
    """The ambient shared secret (``$REPRO_AUTH_KEY``), if any."""
    return os.environ.get(AUTH_KEY_ENV) or None


# --------------------------------------------------------------- framing
def encode_frame(obj, auth_key=None) -> bytes:
    """Serialize one message: codec tag + 4-byte length + payload.
    JSON (compact separators, deterministic on the wire) whenever the
    message is pure data; pickle when it carries objects (model blobs,
    service factories).  With ``auth_key`` the tag is lowercased and a
    32-byte HMAC-SHA256 over header+payload is inserted before the
    payload, so any bit flipped in transit fails verification."""
    key = _key_bytes(auth_key)
    try:
        payload = json.dumps(obj, separators=(",", ":")).encode()
        tag = _TAG_JSON_MAC if key else _TAG_JSON
    except (TypeError, ValueError):
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        tag = _TAG_PICKLE_MAC if key else _TAG_PICKLE
    head = tag + len(payload).to_bytes(4, "big")
    if key is None:
        return head + payload
    mac = hmac.new(key, head + payload, "sha256").digest()
    return head + mac + payload


def decode_frame(frame: bytes, auth_key=None):
    """Inverse of :func:`encode_frame`; validates the declared length so
    a torn frame fails loudly instead of decoding garbage, and — when an
    ``auth_key`` is configured — verifies the HMAC before a single
    payload byte is parsed.  Auth failures raise :class:`FrameAuthError`
    (typed, distinct from the ``ValueError`` a torn frame raises)."""
    key = _key_bytes(auth_key)
    if len(frame) < 5:
        raise ValueError(f"short frame: {len(frame)} bytes")
    tag, length = frame[:1], int.from_bytes(frame[1:5], "big")
    signed = tag in (_TAG_JSON_MAC, _TAG_PICKLE_MAC)
    if signed and key is None:
        raise FrameAuthError(
            "peer sent an authenticated frame but no auth key is "
            f"configured here (set --auth-key or ${AUTH_KEY_ENV})")
    if key is not None and not signed:
        if tag in (_TAG_JSON, _TAG_PICKLE):
            raise FrameAuthError(
                "unauthenticated frame rejected: this endpoint requires "
                "HMAC-signed frames (peer is missing the shared key)")
        raise ValueError(f"unknown frame tag {tag!r}")
    if signed:
        mac, payload = frame[5:5 + _MAC_LEN], frame[5 + _MAC_LEN:]
        if len(mac) < _MAC_LEN or len(payload) != length:
            raise ValueError(f"frame length mismatch: declared {length}, "
                             f"got {len(payload)}")
        want = hmac.new(key, frame[:5] + payload, "sha256").digest()
        if not hmac.compare_digest(mac, want):
            raise FrameAuthError("frame HMAC mismatch: tampered bytes or "
                                 "wrong shared key")
    else:
        payload = frame[5:]
        if len(payload) != length:
            raise ValueError(f"frame length mismatch: declared {length}, "
                             f"got {len(payload)}")
    if tag in (_TAG_JSON, _TAG_JSON_MAC):
        return json.loads(payload.decode())
    if tag in (_TAG_PICKLE, _TAG_PICKLE_MAC):
        return pickle.loads(payload)
    raise ValueError(f"unknown frame tag {tag!r}")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes from a stream socket; EOFError on a peer
    that closed mid-frame (the torn-frame failure mode)."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise EOFError(f"peer closed mid-frame ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def write_frame(sock: socket.socket, obj, auth_key=None) -> None:
    """Stream one encoded frame over a socket."""
    sock.sendall(encode_frame(obj, auth_key))


def read_frame(sock: socket.socket, auth_key=None):
    """Read one frame off a stream socket: 5-byte header (tag + declared
    length), a 32-byte HMAC when the tag marks an authenticated frame,
    then exactly the declared payload bytes — decoded (and verified)
    through the same :func:`decode_frame` the pipe transport uses."""
    head = _recv_exact(sock, 5)
    length = int.from_bytes(head[1:5], "big")
    if head[:1] in (_TAG_JSON_MAC, _TAG_PICKLE_MAC):
        length += _MAC_LEN
    return decode_frame(head + _recv_exact(sock, length), auth_key)


def default_abstain_fallback(query, s: int = 2):
    """The ds-array default square heuristic for estimator-style queries
    ``(n_rows, n_cols, algo, env)`` — module-level so it pickles into
    worker processes."""
    n_rows, n_cols, _algo, env = query
    env_obj = Environment(n_workers=max(int(env.get("n_workers", 1) or 1), 1))
    return default_partitioning(int(n_rows), int(n_cols), env_obj, s=s)


def _algo_of(query) -> str:
    return query.algo if hasattr(query, "algo") else query[2]


# ----------------------------------------------------------- worker side
class ShardWorker:
    """Worker-side handler: one ``TunerService`` replica plus the op
    dispatch.  Both transports drive exactly this object, so loopback
    and process modes serve byte-identical answers for the same model.
    """

    def __init__(self, backend, *, service_factory=EstimatorService,
                 maxsize: int = 4096, abstain_fallback=None):
        self.service = service_factory(backend, maxsize)
        self._fallback = abstain_fallback or (
            lambda q: default_abstain_fallback(
                q, s=getattr(backend, "s", 2)))
        self._crashed = False

    # one op per message; unknown ops answer an error instead of dying
    def handle(self, msg: dict) -> dict:
        op = msg.get("op")
        try:
            if op == "predict":
                return self._predict(msg["queries"])
            if op == "swap":
                self.service.swap_backend(msg["backend"])
                return {"ok": True, "version": self._version()}
            if op == "stats":
                return {"ok": True, **self._counters()}
            if op == "ping":
                return {"ok": True, "pid": os.getpid()}
            if op == "crash":
                # chaos: die abruptly, leaving the caller's in-flight
                # batch unanswered (the hard case the fleet must re-route)
                self._crashed = True
                return {"ok": True}
            if op == "stop":
                return {"ok": True}
            return {"ok": False, "error": f"unknown op {op!r}"}
        except Exception as e:               # keep the worker alive
            self.service.discard_pending()
            return {"ok": False, "error": repr(e)}

    def _version(self):
        return getattr(self.service.backend, "model_version", None)

    def _counters(self) -> dict:
        svc = self.service
        # "version" is the legacy spelling; "model_version" the canonical
        # one (serve/stats.py) — both ship so either side can be older
        return {"hits": svc.hits, "misses": svc.misses,
                "invalidations": svc.invalidations,
                "hit_rate": svc.hit_rate, "version": self._version(),
                "model_version": self._version()}

    def _predict(self, queries: list) -> dict:
        """Serve one batch exactly like the in-process shard: abstained
        queries answer from the fallback without touching the memo, the
        rest go through one ``submit()``/``flush()`` pass."""
        backend = self.service.backend
        queries = [tuple(q) if isinstance(q, list) else q for q in queries]
        out: list = [None] * len(queries)
        pending = []
        for i, q in enumerate(queries):
            if backend.abstains(_algo_of(q)):
                out[i] = [self._fallback(q), "default"]
            else:
                pending.append((i, self.service.submit(q)))
        if pending:
            try:
                self.service.flush()
            except Exception as e:
                self.service.discard_pending()
                return {"ok": False, "error": repr(e)}
            for i, handle in pending:
                out[i] = [handle.result(), "model"]
        return {"ok": True, "version": self._version(),
                "results": out, **self._counters()}


def _roundtrip(msg: dict, auth_key=None) -> dict:
    return decode_frame(encode_frame(msg, auth_key), auth_key)


# -------------------------------------------------------------- loopback
class LoopbackTransport:
    """The worker in-process: deterministic, thread-scheduled, no pickled
    process boundary — but every message still round-trips through the
    frame codec (HMAC included when an ``auth_key`` is set), so the wire
    format itself is exercised on every call.
    """

    kind = "loopback"

    def __init__(self, backend, *, service_factory=EstimatorService,
                 maxsize: int = 4096, abstain_fallback=None,
                 auth_key=None):
        self.worker = ShardWorker(backend, service_factory=service_factory,
                                  maxsize=maxsize,
                                  abstain_fallback=abstain_fallback)
        self._auth_key = _key_bytes(auth_key)
        self._lock = threading.Lock()
        self._dead = False

    @property
    def alive(self) -> bool:
        return not self._dead

    def call(self, msg: dict, timeout: float | None = None) -> dict:
        with self._lock:
            if self._dead:
                raise TransportDead("loopback worker is dead")
            key = self._auth_key
            reply = _roundtrip(self.worker.handle(_roundtrip(msg, key)),
                               key)
            if self.worker._crashed:
                # mimic a process dying mid-call: the caller never sees
                # a reply for this message
                self._dead = True
                raise TransportDead("loopback worker crashed")
            return reply

    def silent_kill(self) -> None:
        """Chaos: the worker dies without anyone noticing — no in-flight
        call, no error.  Only a later call (or a heartbeat probe) can
        discover it."""
        self._dead = True

    def kill(self) -> None:
        self._dead = True

    def close(self) -> None:
        self._dead = True


# --------------------------------------------------------------- process
def _worker_entry(conn, init_frame: bytes, auth_key=None) -> None:
    """Worker process main: build the :class:`ShardWorker` from the init
    frame, then serve frames until ``stop``/EOF.  A ``crash`` op exits
    hard without replying — exactly how an OOM-killed worker looks to
    the parent."""
    init = decode_frame(init_frame, auth_key)
    worker = ShardWorker(init["backend"],
                         service_factory=init["service_factory"],
                         maxsize=init["maxsize"],
                         abstain_fallback=init["abstain_fallback"])
    while True:
        try:
            frame = conn.recv_bytes()
        except (EOFError, OSError):
            return
        msg = decode_frame(frame, auth_key)
        if msg.get("op") == "crash":
            os._exit(17)                       # no reply: caller sees EOF
        reply = worker.handle(msg)
        try:
            conn.send_bytes(encode_frame(reply, auth_key))
        except (BrokenPipeError, OSError):
            return
        if msg.get("op") == "stop":
            conn.close()
            return


class ProcessTransport:
    """The worker in its own OS process, frames over a duplex
    ``multiprocessing`` pipe.  One outstanding call at a time (the fleet
    gives each replica a single dispatcher thread; the internal lock
    covers stats polls racing a predict).  A worker death surfaces as
    :class:`TransportDead` on the call that hit it."""

    kind = "process"

    def __init__(self, backend, *, service_factory=EstimatorService,
                 maxsize: int = 4096, abstain_fallback=None,
                 mp_context: str | None = None, auth_key=None):
        ctx = mp.get_context(mp_context) if mp_context else mp.get_context()
        self._auth_key = _key_bytes(auth_key)
        self._conn, child = ctx.Pipe(duplex=True)
        init = encode_frame({"backend": backend,
                             "service_factory": service_factory,
                             "maxsize": maxsize,
                             "abstain_fallback": abstain_fallback},
                            self._auth_key)
        self.proc = ctx.Process(target=_worker_entry,
                                args=(child, init, self._auth_key),
                                daemon=True, name="serve-fleet-worker")
        self.proc.start()
        child.close()
        self._lock = threading.Lock()
        self._dead = False

    @property
    def alive(self) -> bool:
        return not self._dead and self.proc.is_alive()

    def call(self, msg: dict, timeout: float | None = None) -> dict:
        with self._lock:
            if self._dead:
                raise TransportDead("worker process is dead")
            try:
                self._conn.send_bytes(encode_frame(msg, self._auth_key))
                if timeout is not None and not self._conn.poll(timeout):
                    self._dead = True
                    raise TransportDead(
                        f"worker pid {self.proc.pid} silent for {timeout}s")
                reply = decode_frame(self._conn.recv_bytes(),
                                     self._auth_key)
            except (EOFError, BrokenPipeError, OSError) as e:
                self._dead = True
                raise TransportDead(
                    f"worker pid {self.proc.pid} died mid-call: "
                    f"{e!r}") from e
            return reply

    def silent_kill(self) -> None:
        """Chaos: SIGKILL the worker without marking the transport dead —
        nobody notices until the next call (or a heartbeat probe) fails,
        exactly like an OOM-kill on an idle worker."""
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(timeout=5)

    def kill(self) -> None:
        """Abrupt death (chaos injection / shutdown of a hung worker)."""
        self._dead = True
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(timeout=5)

    def close(self) -> None:
        """Graceful stop: ask the worker to exit, then reap it."""
        if self._dead:
            self.kill()
            return
        try:
            self.call({"op": "stop"}, timeout=5)
        except TransportDead:
            pass
        self._dead = True
        self.proc.join(timeout=5)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=5)


# ---------------------------------------------------------------- socket
def _serve_socket_conn(conn: socket.socket, auth_key=None) -> bool:
    """Serve one attached fleet connection until it drops; True iff the
    peer asked the whole worker process to stop.

    The connection protocol: the first frame must be an ``init`` op
    carrying the backend (the management layer ships the model, so an
    attached worker always serves exactly what the fleet decided); every
    later frame is a normal :class:`ShardWorker` op.  A ``crash`` op
    drops the connection without replying — to the caller it is
    indistinguishable from the worker host dying mid-call.  With an
    ``auth_key``, a frame that fails HMAC verification gets a one-line
    rejection reply (signed with *our* key, so a trusted peer can read
    it) and the connection is dropped — an unauthenticated peer never
    reaches the op dispatch."""
    worker = None
    with conn:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                msg = read_frame(conn, auth_key)
            except FrameAuthError as e:
                try:                      # best-effort typed rejection
                    write_frame(conn, {"ok": False, "auth": False,
                                       "error": f"frame rejected: {e}"},
                                auth_key)
                except OSError:
                    pass
                return False              # untrusted peer: drop the conn
            except (EOFError, OSError, ValueError):
                return False              # peer detached: back to accept
            op = msg.get("op")
            if op == "init":
                worker = ShardWorker(
                    msg["backend"],
                    service_factory=msg.get("service_factory")
                    or EstimatorService,
                    maxsize=msg.get("maxsize", 4096),
                    abstain_fallback=msg.get("abstain_fallback"))
                reply = {"ok": True, "pid": os.getpid()}
            elif op == "crash":
                return False              # no reply: caller sees EOF
            elif worker is None:
                reply = {"ok": op == "stop",
                         "error": "no init frame yet"}
            else:
                reply = worker.handle(msg)
            try:
                write_frame(conn, reply, auth_key)
            except OSError:
                return False
            if op == "stop":
                return True


def serve_socket_worker(srv: socket.socket, *, once: bool = False,
                        auth_key=None) -> None:
    """Accept loop of a socket shard worker: serve one fleet attachment
    at a time; when the connection drops (fleet detached, crash op, or a
    network partition) go back to ``accept`` so a respawning fleet can
    *reattach* — unless ``once``, the mode locally spawned workers use
    so a crashed worker's process actually exits.  A ``stop`` op ends
    the loop (and the hosting process).  ``auth_key`` arms HMAC frame
    verification on every connection."""
    key = _key_bytes(auth_key)
    with srv:
        while True:
            try:
                conn, _addr = srv.accept()
            except OSError:
                return
            stopped = _serve_socket_conn(conn, key)
            if once or stopped:
                return


def _socket_worker_entry(pipe, host: str, port: int, auth_key=None) -> None:
    """Local-spawn worker main: bind an ephemeral port, report it back
    through ``pipe``, then serve exactly one attachment (the parent)."""
    srv = socket.create_server((host, port))
    pipe.send(srv.getsockname()[:2])
    pipe.close()
    serve_socket_worker(srv, once=True, auth_key=auth_key)


class SocketTransport:
    """The worker across a TCP connection — the fleet's cross-host
    transport.  Without ``address`` a local worker process is spawned on
    an ephemeral loopback port (process-transport semantics, socket
    wire); with ``address`` the transport attaches to a running
    ``python -m repro_torch serve-worker`` anywhere, ships the model in the init
    frame, and serves through it.  Every failure on the wire — connect
    refused/timeout, read timeout, torn frame, peer reset — marks the
    transport dead and raises :class:`TransportDead`, so the fleet's
    crash-recovery path treats a dropped connection exactly like a
    worker loss."""

    kind = "socket"

    def __init__(self, backend, *, service_factory=EstimatorService,
                 maxsize: int = 4096, abstain_fallback=None,
                 address: str | None = None,
                 connect_timeout_s: float = 10.0,
                 mp_context: str | None = None, auth_key=None):
        self.proc = None
        self.attached = address is not None
        self._auth_key = _key_bytes(auth_key)
        self._lock = threading.Lock()
        self._dead = False
        self._sock = None
        if address is None:
            ctx = mp.get_context(mp_context) if mp_context \
                else mp.get_context()
            parent, child = ctx.Pipe()
            self.proc = ctx.Process(target=_socket_worker_entry,
                                    args=(child, "127.0.0.1", 0,
                                          self._auth_key),
                                    daemon=True,
                                    name="serve-fleet-socket-worker")
            self.proc.start()
            child.close()
            try:
                if not parent.poll(connect_timeout_s):
                    raise TransportDead(
                        f"spawned socket worker never reported its port "
                        f"within {connect_timeout_s}s")
                host, port = parent.recv()
                address = f"{host}:{port}"
            except (EOFError, OSError) as e:
                self._dead = True
                self._reap()
                raise TransportDead(
                    f"socket worker died during bootstrap: {e!r}") from e
            except TransportDead:
                self._dead = True
                self._reap()
                raise
            finally:
                parent.close()
        self.address = address
        host, _, port = address.rpartition(":")
        try:
            self._sock = socket.create_connection(
                (host or "127.0.0.1", int(port)),
                timeout=connect_timeout_s)
        except OSError as e:
            self._dead = True
            self._reap()
            raise TransportDead(
                f"connect to worker at {address} failed ({e!r}) — is "
                f"`python -m repro_torch serve-worker --listen "
                f"{address}` running?") from e
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # handshake: the management layer decides the model this worker
        # serves, whether it was spawned here or attached across hosts
        try:
            reply = self.call({"op": "init", "backend": backend,
                               "service_factory": service_factory,
                               "maxsize": maxsize,
                               "abstain_fallback": abstain_fallback},
                              timeout=connect_timeout_s)
        except FrameAuthError:
            self.kill()
            raise
        if not reply.get("ok"):
            self.kill()
            if reply.get("auth") is False:
                raise FrameAuthError(
                    f"worker at {address} rejected our frames: "
                    f"{reply.get('error')}")
            raise TransportDead(
                f"worker at {address} rejected init: {reply}")
        self.worker_pid = reply.get("pid")

    @property
    def alive(self) -> bool:
        return not self._dead and (self.proc is None
                                   or self.proc.is_alive())

    def call(self, msg: dict, timeout: float | None = None) -> dict:
        with self._lock:
            if self._dead:
                raise TransportDead(
                    f"socket worker at {self.address} is gone")
            try:
                self._sock.settimeout(timeout)
                write_frame(self._sock, msg, self._auth_key)
                reply = read_frame(self._sock, self._auth_key)
                if reply.get("auth") is False and not reply.get("ok"):
                    # the worker refused our frames (key mismatch on its
                    # side): typed rejection, and the peer has dropped us
                    self._mark_dead()
                    raise FrameAuthError(
                        f"worker at {self.address} rejected frame: "
                        f"{reply.get('error')}")
                return reply
            except FrameAuthError:
                # untrusted bytes on the stream: unusable, but NOT a
                # worker loss — the caller gets the typed auth error
                self._mark_dead()
                raise
            except TimeoutError as e:          # socket.timeout alias
                self._mark_dead()
                raise TransportDead(
                    f"worker at {self.address} silent for "
                    f"{timeout}s") from e
            except (EOFError, OSError, ValueError) as e:
                # EOF/reset: the peer dropped mid-call; ValueError: a
                # torn or garbled frame — the stream is desynced and the
                # connection unusable either way
                self._mark_dead()
                raise TransportDead(
                    f"connection to worker at {self.address} dropped "
                    f"mid-call: {e!r}") from e

    def _mark_dead(self) -> None:
        self._dead = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def _reap(self) -> None:
        if self.proc is None:
            return
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(timeout=5)

    def silent_kill(self) -> None:
        """Chaos: the worker dies without the transport noticing — a
        locally spawned worker process is SIGKILLed; an attached one has
        its connection severed at the OS level.  ``_dead`` stays False:
        only a later call (or a heartbeat probe) can discover it."""
        if self.proc is not None:
            if self.proc.is_alive():
                self.proc.kill()
            self.proc.join(timeout=5)
        elif self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def kill(self) -> None:
        """Abrupt death: drop the connection (an attached remote worker
        survives and re-enters accept — reattachable), kill a locally
        spawned worker process outright."""
        self._mark_dead()
        self._reap()

    def close(self) -> None:
        """Graceful stop.  A locally spawned worker is asked to exit and
        reaped; an attached worker is only *detached* — the remote
        process goes back to accepting, because the operator who started
        it owns its lifetime."""
        if self._dead:
            self.kill()
            return
        if self.proc is not None:
            try:
                self.call({"op": "stop"}, timeout=5)
            except TransportDead:
                pass
        self._mark_dead()
        self._reap()


TRANSPORTS = {"loopback": LoopbackTransport, "process": ProcessTransport,
              "socket": SocketTransport}


# ------------------------------------------------------------------ spec
@dataclass(frozen=True)
class TransportSpec:
    """One validated description of how the management layer reaches its
    workers — built once (from CLI flags, a config file, or a test) and
    shared verbatim by :class:`~repro_torch.serve.fleet.FleetRouter`, the
    examples, and the benchmarks, so "which transport, which addresses,
    which key" is parsed and checked in exactly one place instead of
    re-implemented per entrypoint.

    * ``kind`` — ``loopback`` / ``process`` / ``socket``.
    * ``worker_addrs`` — explicit ``host:port`` workers to attach to
      (socket only); the hand-typed ``--workers`` list.  A comma
      string is accepted and normalized to a tuple.
    * ``registry`` — path of a
      :class:`~repro_torch.serve.registry.WorkerRegistry` file to *discover*
      workers from (socket only).  Composes with ``worker_addrs``:
      explicit addresses first, then live registered leases.
    * ``auth_key`` — shared frame-HMAC secret.  ``None`` defers to
      ``$REPRO_AUTH_KEY`` at resolve time; ``""`` forces auth off even
      when the env var is set.
    * ``connect_timeout_s`` / ``call_timeout_s`` — bootstrap handshake
      and per-call deadlines.
    """

    kind: str = "loopback"
    worker_addrs: tuple = ()
    auth_key: str | bytes | None = None
    connect_timeout_s: float = 10.0
    call_timeout_s: float = 60.0
    registry: str | Path | None = None
    mp_context: str | None = None

    def __post_init__(self):
        if self.kind not in TRANSPORTS:
            raise ValueError(f"unknown transport kind {self.kind!r}; "
                             f"choose from {sorted(TRANSPORTS)}")
        addrs = self.worker_addrs
        if isinstance(addrs, str):
            addrs = tuple(a.strip() for a in addrs.split(",") if a.strip())
        else:
            addrs = tuple(addrs)
        for addr in addrs:
            host, _, port = addr.rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(
                    f"bad worker address {addr!r}: want host:port")
        object.__setattr__(self, "worker_addrs", addrs)
        if self.kind != "socket" and (addrs or self.registry is not None):
            raise ValueError(
                "worker_addrs/registry only apply to the socket "
                f"transport, not {self.kind!r}")
        if self.connect_timeout_s <= 0 or self.call_timeout_s <= 0:
            raise ValueError("transport timeouts must be positive")
        if self.registry is not None:
            object.__setattr__(self, "registry", Path(self.registry))

    # ------------------------------------------------------------ helpers
    def resolved_auth_key(self) -> bytes | None:
        """The effective HMAC key: the explicit one when set, else the
        ambient ``$REPRO_AUTH_KEY``; empty means auth disabled."""
        key = self.auth_key if self.auth_key is not None \
            else auth_key_from_env()
        return _key_bytes(key)

    def open_registry(self):
        """The :class:`~repro_torch.serve.registry.WorkerRegistry` behind
        ``registry``, or ``None`` when discovery is not configured."""
        if self.registry is None:
            return None
        from repro_torch.serve.registry import WorkerRegistry
        return WorkerRegistry(self.registry)

    def discover(self, now: float | None = None) -> tuple:
        """All known worker addresses: explicit ``worker_addrs`` first,
        then live registry leases (deduped, stable order)."""
        addrs = list(self.worker_addrs)
        reg = self.open_registry()
        if reg is not None:
            for a in reg.addresses(now):
                if a not in addrs:
                    addrs.append(a)
        return tuple(addrs)

    def transport_kw(self) -> dict:
        """Per-kind constructor kwargs — what the fleet threads through
        to every transport it builds."""
        kw = {"auth_key": self.resolved_auth_key()}
        if self.kind == "process":
            kw["mp_context"] = self.mp_context
        elif self.kind == "socket":
            kw["mp_context"] = self.mp_context
            kw["connect_timeout_s"] = self.connect_timeout_s
        return kw


def make_transport(spec: TransportSpec, backend, *,
                   address: str | None = None,
                   service_factory=EstimatorService, maxsize: int = 4096,
                   abstain_fallback=None):
    """Build one live transport from a validated :class:`TransportSpec`
    — the single constructor path the CLI, the fleet, the examples, and
    the benchmarks share.  ``address`` attaches to a specific worker
    (socket only); without it the kind's default spawn/loopback behavior
    applies."""
    kw = dict(spec.transport_kw())
    if address is not None:
        if spec.kind != "socket":
            raise ValueError("address= only applies to the socket "
                             f"transport, not {spec.kind!r}")
        kw["address"] = address
    return TRANSPORTS[spec.kind](backend, service_factory=service_factory,
                                 maxsize=maxsize,
                                 abstain_fallback=abstain_fallback, **kw)
