"""`meta-server` — serve the bundled Redis-protocol meta transport (a copy
of juicefs_tpu/cmd/meta_server.py).

Runs the wire-compatible Redis-subset server (meta/redis_server.py) so
multiple hosts can share one volume via `redis://host:port/db` meta URLs
without an external Redis deployment (reference: the Redis/TiKV server
the Go engines dial; pkg/meta/redis.go:54-76).
"""

from __future__ import annotations


def add_parser(sub):
    p = sub.add_parser(
        "meta-server",
        help="serve the bundled Redis-protocol metadata transport",
    )
    p.add_argument("--host", default="0.0.0.0", help="bind address")
    p.add_argument("--port", type=int, default=6389, help="bind port")
    p.add_argument("--data", default="",
                   help="append-only file for durability (replayed on "
                        "start, compacted to a snapshot; empty = memory only)")
    p.add_argument("--fsync", default="everysec", choices=["always", "everysec"],
                   help="AOF durability: per-mutation or batched (Redis-style)")
    p.add_argument("--replica-of", default="",
                   help="host:port of a primary meta-server to replicate "
                        "from: this instance SYNCs a snapshot, applies the "
                        "live mutation stream, and serves read-only point "
                        "reads for clients mounted with --meta-replica")
    p.set_defaults(func=run)


def run(args) -> int:
    from ..meta.redis_server import RedisServer

    srv = RedisServer(args.host, args.port, data_path=args.data or None,
                      fsync=args.fsync,
                      replica_of=getattr(args, "replica_of", "") or None)
    port = srv.start()
    durable = f" (aof={args.data}, fsync={args.fsync})" if args.data else ""
    role = f" replicating {args.replica_of}" if getattr(args, "replica_of", "") else ""
    print(f"meta-server listening on {args.host}:{port}{durable}{role}",
          flush=True)
    srv.wait()
    return 0
