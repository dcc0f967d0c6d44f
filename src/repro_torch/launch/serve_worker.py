"""Standalone socket shard worker for the serving fleet (DESIGN.md
§14–§15), the port of the JAX package's ``launch/serve_worker.py``.

    python -m repro_torch serve-worker --listen 0.0.0.0:7071
    python -m repro_torch serve-worker --listen 127.0.0.1:0 --once
    python -m repro_torch serve-worker --listen 0.0.0.0:0 \\
        --register /shared/registry.jsonl --auth-key s3cret

Run one of these per core on every serving host.  With ``--register``
the worker announces its bound address into a shared
:class:`~repro_torch.serve.registry.WorkerRegistry` file and keeps the lease
alive — any :class:`~repro_torch.serve.fleet.FleetRouter` pointed at the same
registry discovers and attaches it, no ``--workers`` flag needed::

    spec = TransportSpec(kind="socket", registry="/shared/registry.jsonl")
    FleetRouter(est, transport=spec).poll_registry()

Hand-typed attachment still works::

    python -m repro_torch serve-estimator --demo --transport socket \\
        --workers hostA:7071,hostB:7071

The worker is *inert* until a fleet attaches: it holds no model of its
own — the first frame on every connection is an ``init`` op shipping the
backend, so the management layer always decides what gets served (the
backend arrives pickled, so attach fleets of this package: their
classes are the ones it imports).  The worker runs on the host and
touches no device.  When
the connection drops (fleet detached, crashed, or the network
partitioned) the worker returns to ``accept``, so a recovering fleet can
reattach and keep the same capacity; ``--once`` serves a single
attachment and exits (the mode locally spawned workers use).  A ``stop``
op from the peer shuts the worker down, withdrawing the lease.

``--auth-key`` (or ``$REPRO_AUTH_KEY``) arms HMAC frame verification:
unauthenticated or tampered frames are rejected before the op dispatch,
so an untrusted peer can never reach the model.

Port ``0`` binds an ephemeral port; the bound address is printed on
stdout either way (``serve_worker listening on H:P``), which is what
scripts parse.
"""
from __future__ import annotations

import argparse
import socket


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="socket shard worker: listen for a serving fleet to "
                    "attach, serve predict/swap/stats frames until told "
                    "to stop")
    ap.add_argument("--listen", required=True, metavar="HOST:PORT",
                    help="bind address; port 0 picks an ephemeral port "
                         "(the bound address is printed)")
    ap.add_argument("--once", action="store_true",
                    help="serve one fleet attachment then exit instead "
                         "of re-accepting (what locally spawned workers "
                         "do)")
    ap.add_argument("--register", default=None, metavar="PATH",
                    help="announce into this worker-registry file and "
                         "keep the lease alive (fleets with the same "
                         "registry discover this worker)")
    ap.add_argument("--ttl", type=float, default=10.0,
                    help="registry lease seconds; a killed worker lapses "
                         "after this (default 10)")
    ap.add_argument("--advertise", default=None, metavar="HOST:PORT",
                    help="address to register instead of the bound one "
                         "(NAT / container port mappings)")
    ap.add_argument("--auth-key", default=None,
                    help="shared frame-HMAC secret (default: "
                         "$REPRO_AUTH_KEY; unset disables auth)")
    args = ap.parse_args(argv)

    from repro_torch.serve.registry import (LeaseKeeper, WorkerRegistry,
                                      default_caps)
    from repro_torch.serve.transport import auth_key_from_env, serve_socket_worker

    host, _, port = args.listen.rpartition(":")
    srv = socket.create_server((host or "127.0.0.1", int(port)))
    bound = "%s:%d" % srv.getsockname()[:2]
    print(f"serve_worker listening on {bound}", flush=True)
    auth_key = args.auth_key if args.auth_key is not None \
        else auth_key_from_env()
    keeper = None
    if args.register:
        addr = args.advertise or bound
        keeper = LeaseKeeper(WorkerRegistry(args.register), addr,
                             ttl_s=args.ttl, caps=default_caps()).start()
        print(f"serve_worker registered {addr} in {args.register} "
              f"(ttl {args.ttl:g}s)", flush=True)
    try:
        serve_socket_worker(srv, once=args.once, auth_key=auth_key)
    except KeyboardInterrupt:
        pass
    finally:
        if keeper is not None:
            keeper.stop()
    print("serve_worker exiting", flush=True)
    return bound


if __name__ == "__main__":
    main()
