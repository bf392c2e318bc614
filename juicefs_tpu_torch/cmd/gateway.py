"""`gateway` / `webdav`: serve the volume over S3 / WebDAV (a copy of
juicefs_tpu/cmd/gateway.py; reference cmd/gateway.go, cmd/webdav.go).

Every PUT goes through the volume's chunk store: on a volume formatted
with a device hash backend its blocks are fingerprinted on the card by the
store's `BlockIndexer`, and without a card the command fails at start.
`--compress-backend` picks where the compress plane runs (default cuda),
as for `gc` and `fsck`; `webdav` also takes the gateway's `--metrics`.

In-process drives (tests, `chip_smoke.py`) call `start_gateway(args)` or
`start_webdav(args)` and stop what it returns themselves:
`_serve_forever` installs signal handlers, which works only in the main
thread.
"""

from __future__ import annotations

import os
import signal
import threading

from ..utils import get_logger

logger = get_logger("cmd.gateway")


def add_parser(sub):
    g = sub.add_parser("gateway", help="serve the volume over the S3 API")
    g.add_argument("meta_url")
    g.add_argument("--address", default="127.0.0.1")
    g.add_argument("--port", type=int, default=9000)
    g.add_argument("--metrics", default="",
                   help="host:port for the /metrics endpoint (empty disables)")
    g.add_argument("--cache-dir", default="")
    g.add_argument("--cache-size", type=int, default=0)
    g.add_argument("--writeback", action="store_true")
    g.add_argument("--compress-backend", default="cuda", choices=["cpu", "cuda"],
                   help="where the compress plane of the volume's store runs")
    g.add_argument("--access-key", default="", help="SigV4 access key "
                   "(or MINIO_ROOT_USER); auth disabled when empty")
    g.add_argument("--secret-key", default="", help="SigV4 secret key "
                   "(or MINIO_ROOT_PASSWORD)")
    g.add_argument("--tenant-key", action="append", default=[],
                   metavar="ACCESS:SECRET",
                   help="additional SigV4 key pair mapped to its own "
                        "tenant (repeatable; each key gets its own DRR "
                        "fair-queue identity)")
    g.add_argument("--max-inflight", type=int, default=64,
                   help="admission-gate bound: requests past it shed as "
                        "503 SlowDown instead of queueing")
    g.set_defaults(func=run_gateway)

    w = sub.add_parser("webdav", help="serve the volume over WebDAV")
    w.add_argument("meta_url")
    w.add_argument("--address", default="127.0.0.1")
    w.add_argument("--port", type=int, default=9007)
    w.add_argument("--metrics", default="",
                   help="host:port for the /metrics endpoint (empty disables)")
    w.add_argument("--cache-dir", default="")
    w.add_argument("--cache-size", type=int, default=0)
    w.add_argument("--writeback", action="store_true")
    w.add_argument("--compress-backend", default="cuda", choices=["cpu", "cuda"],
                   help="where the compress plane of the volume's store runs")
    w.set_defaults(func=run_webdav)


def _build_fs(args):
    from ..fs import FileSystem
    from ..vfs import VFS
    from . import build_store, open_meta

    m, fmt = open_meta(args.meta_url)
    m.new_session(heartbeat=12.0)
    try:
        vfs = VFS(m, build_store(fmt, args, meta=m), fmt=fmt)
    except BaseException:
        m.close_session()
        raise
    return FileSystem(vfs), vfs, m


def _serve_forever(vfs, m, server, what: str, port: int, metrics: str = ""):
    stop = threading.Event()

    def _stop(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    metrics_srv = None
    if metrics:
        from ..metric import MetricsServer

        metrics_srv = MetricsServer.from_addr(metrics)
        print(f"metrics on http://{metrics_srv.host}:{metrics_srv.port}/metrics",
              flush=True)
    print(f"{what} listening on port {port}", flush=True)
    stop.wait()
    if metrics_srv is not None:
        metrics_srv.stop()
    server.stop()
    vfs.close()
    vfs.store.close()  # drains the indexer, releases the cache dir
    m.close_session()
    return 0


def _start(args, make):
    """Build the volume's FileSystem and start `make(fs)` on it; on
    failure, close what _build_fs opened."""
    fs, vfs, m = _build_fs(args)
    try:
        server = make(fs)
        server.start()
    except BaseException:
        vfs.close()
        vfs.store.close()
        m.close_session()
        raise
    return server, vfs, m


def start_gateway(args):
    """Build the volume's FileSystem and start an S3Gateway on it, as
    `run_gateway` does. Returns (gateway, vfs, meta); the caller stops the
    gateway, closes the vfs and its store, and closes the meta session."""
    from ..gateway import S3Gateway

    # credentials: flags, else the MinIO-convention env vars the reference
    # gateway reads (cmd/gateway.go MINIO_ROOT_USER/PASSWORD)
    ak = args.access_key or os.environ.get("MINIO_ROOT_USER", "")
    sk = args.secret_key or os.environ.get("MINIO_ROOT_PASSWORD", "")
    tenant_keys = {}
    for pair in getattr(args, "tenant_key", []):
        tak, _, tsk = pair.partition(":")
        if not tak or not tsk:
            raise SystemExit(f"--tenant-key needs ACCESS:SECRET, got {pair!r}")
        tenant_keys[tak] = tsk
    return _start(args, lambda fs: S3Gateway(
        fs, args.address, args.port, access_key=ak, secret_key=sk,
        tenant_keys=tenant_keys,
        max_inflight=getattr(args, "max_inflight", 64),
    ))


def start_webdav(args):
    """Build the volume's FileSystem and start a WebDAVServer on it, as
    `run_webdav` does. Returns (server, vfs, meta), as `start_gateway`."""
    from ..gateway.webdav import WebDAVServer

    return _start(args, lambda fs: WebDAVServer(fs, args.address, args.port))


def run_gateway(args) -> int:
    gw, vfs, m = start_gateway(args)
    return _serve_forever(vfs, m, gw, "S3 gateway", gw.port,
                          getattr(args, "metrics", ""))


def run_webdav(args) -> int:
    srv, vfs, m = start_webdav(args)
    return _serve_forever(vfs, m, srv, "WebDAV", srv.port,
                          getattr(args, "metrics", ""))
