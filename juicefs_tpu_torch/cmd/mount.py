"""`mount` / `umount`: serve a volume through the kernel (a copy of
juicefs_tpu/cmd/mount.py; reference cmd/mount.go:541, cmd/mount_unix.go).

Foreground by default; -d daemonizes with a supervisor that restarts the
serving child on crash (reference launchMount restart loop
cmd/mount_unix.go:691-757).

With --inline-dedup every outgoing block is hashed by the store's
`IngestPipeline` before its PUT; on a volume formatted with a device hash
backend (or none) that happens on the card, and the command fails before
anything is mounted on a host without one. `--compress-backend` picks
where the compress plane runs (default cuda), as for `gc`, `fsck` and
`gateway`. Nothing on the way to `os.fork()` touches the card: it is
first used in the serving worker, inside `build_store`.

`--buffer-size` (MiB, upstream's default 300) bounds the bytes of blocks
handed to the upload and not yet durable: a writer waits in
`WSlice._upload_block` while they would pass it, so one streaming writer
can neither outrun the inline-dedup stage's queue nor its memory. 0 turns
the bound off.

In-process drives (tests, `chip_smoke.py`) call `start_mount(args)`, run
`Mounted.srv.serve()` on a thread of their own and call `Mounted.close()`
after it returns: `serve` installs signal handlers, which works only in
the main thread.

`--cache-group` joins a peer cache group: the mount serves its block
cache on `--group-listen` (cache/server.py), publishes that address and
`--group-weight` in its meta session, and reads ring owners' caches
before the object store (cache/group.py). `--metrics-push` and
`--graphite` push the port's registry every `--push-interval` seconds.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time

from ..utils import get_logger

logger = get_logger("cmd.mount")


def add_parser(sub):
    p = sub.add_parser("mount", help="mount a volume")
    p.add_argument("meta_url")
    p.add_argument("mountpoint")
    p.add_argument("-d", "--background", action="store_true")
    p.add_argument("--readonly", action="store_true")
    p.add_argument("--allow-other", action="store_true")
    p.add_argument("--cache-dir", default="", help="colon-separated dirs or 'memory'")
    p.add_argument("--cache-size", default=0, type=int, help="cache size MiB")
    p.add_argument("--writeback", action="store_true")
    p.add_argument("--buffer-size", type=int, default=300,
                   help="total write buffer in MiB: writers wait while the "
                        "blocks handed to the upload and not yet durable "
                        "would pass it (0 = no bound)")
    p.add_argument("--op-deadline", type=float, default=0,
                   help="object op wall budget in seconds (0 = default 60; "
                        "hung backend calls are abandoned, never pin a "
                        "worker)")
    p.add_argument("--attempt-timeout", type=float, default=0,
                   help="per-attempt object op bound in seconds (default: "
                        "the remaining op deadline)")
    p.add_argument("--no-hedge", action="store_true",
                   help="disable hedged GETs (tail-latency duplicate "
                        "requests after the live p95)")
    p.add_argument("--upload-limit", type=float, default=0,
                   help="bandwidth limit for uploads in Mbps (0 = "
                        "unlimited); charged at the object boundary, so "
                        "retries and hedges count against it")
    p.add_argument("--download-limit", type=float, default=0,
                   help="bandwidth limit for downloads in Mbps (0 = "
                        "unlimited)")
    p.add_argument("--inline-dedup", action="store_true",
                   help="hash outgoing blocks (volume hash_backend; a "
                        "volume with none hashes on the card) and skip "
                        "compress+PUT for content the store already holds; "
                        "overload degrades to plain uploads, never blocks "
                        "writes")
    p.add_argument("--ingest-flush-ms", type=float, default=5.0,
                   help="max time a partial ingest hash batch waits for "
                        "more blocks before flushing (single-block write "
                        "latency bound; 0 flushes at once)")
    p.add_argument("--compress-backend", default="cuda", choices=["cpu", "cuda"],
                   help="batched compression plane backend: cpu fans "
                        "liblz4 out across the qos slice lane; cuda adds "
                        "the compressibility estimator on the card, riding "
                        "the hash plane's packed upload (fails without a "
                        "card)")
    p.add_argument("--compress-lanes", type=int, default=0,
                   help="parallel encode lanes for batched compression "
                        "(0 = host cores)")
    p.add_argument("--no-dedup-bypass", action="store_true",
                   help="disable the adaptive elision bypass: always "
                        "hash+lookup every block even when the sampled "
                        "duplicate density is ~zero")
    p.add_argument("--cache-group", default="",
                   help="join this named peer cache group: serve the local "
                        "block cache to peers and read peers' caches before "
                        "the object store (membership via meta sessions)")
    p.add_argument("--group-weight", type=int, default=1,
                   help="ring weight of this member (bigger cache => "
                        "proportionally more of the keyspace)")
    p.add_argument("--group-listen", default="127.0.0.1:0",
                   help="host:port the peer block server binds (port 0 "
                        "auto-picks; the bound address is published in the "
                        "session info)")
    p.add_argument("--max-readahead", type=int, default=8, help="MiB")
    p.add_argument("--no-streaming-read", action="store_true",
                   help="disable the epoch-streaming read path: handles "
                        "then keep the block-granularity window doubler "
                        "capped at --max-readahead instead of escalating "
                        "to file-granularity readahead")
    p.add_argument("--streaming-after", type=int, default=16,
                   help="MiB of sustained sequential reads before a "
                        "handle escalates to streaming readahead")
    p.add_argument("--max-streaming", type=int, default=64,
                   help="MiB cap on a streaming handle's readahead window "
                        "(also bounded by the prefetch queue depth)")
    p.add_argument("--attr-cache", type=float, default=1.0,
                   help="attr cache TTL seconds (reference --attr-cache)")
    p.add_argument("--entry-cache", type=float, default=1.0,
                   help="dentry cache TTL seconds (reference --entry-cache)")
    p.add_argument("--dir-entry-cache", type=float, default=1.0,
                   help="readdir snapshot TTL seconds")
    p.add_argument("--attr-cache-ttl", type=float, default=0.0,
                   help="META-layer attr lease TTL seconds: cached "
                        "getattr/lookup serve with zero meta round trips; "
                        "remote staleness is bounded by the TTL and "
                        "usually far lower (the heartbeat change feed "
                        "invalidates mid-lease). 0 = passthrough, byte-"
                        "identical to an uncached client")
    p.add_argument("--entry-cache-ttl", type=float, default=0.0,
                   help="META-layer dentry lease TTL seconds (positive + "
                        "bounded negative lookups); 0 disables")
    p.add_argument("--meta-replica", default="",
                   help="host:port of a meta-server read replica (started "
                        "with meta-server --replica-of): read-only point "
                        "reads route there, WATCH transactions stay on the "
                        "primary, and replica lag is guarded by the volume "
                        "change-epoch")
    p.add_argument("--write-batch", action="store_true",
                   help="checkpoint write plane: coalesce create/slice-"
                        "commit/setattr bursts into group-commit engine "
                        "transactions with a local overlay for read-your-"
                        "own-creates; fsync/close/rename are barriers "
                        "(acked fsync = durably committed, deferred errors "
                        "surface there). Default off = byte-identical "
                        "per-op writes")
    p.add_argument("--wbatch-flush-ms", type=float, default=3.0,
                   help="max time a batched mutation waits for the group "
                        "commit timer (barriers drain immediately)")
    p.add_argument("--wbatch-prealloc", type=int, default=1024,
                   help="inode ids preallocated per client allocation txn "
                        "while write batching is on (create storms stop "
                        "round-tripping for ids)")
    p.add_argument("--meta-retries", type=int, default=0,
                   help="meta-plane fault contract: max attempts per "
                        "engine op. Transient connection resets/timeouts "
                        "and BUSY responses retry with jittered deadline-"
                        "aware backoff; POSIX errnos pass through "
                        "untouched; a failing engine trips a circuit "
                        "breaker with probe-driven recovery (heal revives "
                        "the session and replays the write batch). "
                        "0 (default) = off, byte-identical engine calls")
    p.add_argument("--meta-deadline", type=float, default=15.0,
                   help="wall-clock budget per meta engine op including "
                        "retries (with --meta-retries)")
    p.add_argument("--meta-degraded-max-stale", type=float, default=0,
                   help="while the meta breaker is OPEN, serve EXPIRED "
                        "lease entries up to this many seconds past "
                        "their lease (marked stale-served); 0 = never "
                        "serve stale, degraded reads fail fast EIO. "
                        "Requires --meta-retries > 0 (the breaker lives "
                        "in the fault contract)")
    p.add_argument("--meta-op-limit", type=float, default=0,
                   help="per-tenant meta ops/s (0 = unlimited): token-"
                        "bucket throttling at the meta boundary — graceful "
                        "queuing, never an error")
    p.add_argument("--heartbeat", type=float, default=12.0,
                   help="session heartbeat interval seconds (also the push-"
                        "invalidation exchange cadence)")
    p.add_argument("--metrics", default="",
                   help="host:port for the /metrics endpoint (reference "
                        "exposeMetrics; empty disables, port 0 auto-picks)")
    p.add_argument("--metrics-push", default="",
                   help="Pushgateway URL to PUT metrics to every "
                        "--push-interval seconds (reference metrics push)")
    p.add_argument("--graphite", default="",
                   help="host:port to stream Graphite plaintext metrics to")
    p.add_argument("--push-interval", type=float, default=10.0)
    p.add_argument("--usage-report-url", default="",
                   help="opt in to a daily anonymous usage ping POSTed to "
                        "this operator-owned URL (reference "
                        "pkg/usage/usage.go reports by default; this build "
                        "sends NOTHING unless a URL is given)")
    p.add_argument("--no-usage-report", action="store_true",
                   help="kept for fstab compatibility; reporting is "
                        "already off unless --usage-report-url is set")
    p.add_argument("--takeover", action="store_true",
                   help="seamless upgrade: adopt a running mount's fuse fd, "
                        "open handles, and session (reference passfd.go)")
    p.add_argument("--no-watchdog", action="store_true")
    p.add_argument("--no-kernel-writeback", action="store_true",
                   help="disable the kernel writeback cache (buffered "
                        "writes then pay one FUSE round trip per syscall)")
    p.add_argument("--no-bgjobs", action="store_true",
                   help="disable background maintenance on this mount")
    p.set_defaults(func=run)

    u = sub.add_parser("umount", help="unmount a volume")
    u.add_argument("mountpoint")
    u.add_argument("-f", "--force", action="store_true")
    u.set_defaults(func=run_umount)


class Mounted:
    """What `start_mount` built for one mountpoint. The caller serves
    `srv` (`srv.serve()` blocks until unmount or handover) and then calls
    `close()`, which stops the background services and closes the vfs,
    the store and the meta session."""

    def __init__(self, meta, store, vfs, srv, bg=None, metrics_srv=None,
                 usage=None, watchdog_stop=None, peer_srv=None, pusher=None):
        self.meta = meta
        self.store = store
        self.vfs = vfs
        self.srv = srv
        self.bg = bg
        self.metrics_srv = metrics_srv
        self.usage = usage
        self.watchdog_stop = watchdog_stop
        self.peer_srv = peer_srv
        self.pusher = pusher

    def close(self) -> None:
        if self.watchdog_stop is not None:
            self.watchdog_stop.set()
        if self.metrics_srv is not None:
            self.metrics_srv.stop()
        if self.pusher is not None:
            self.pusher.stop()
        if self.usage is not None:
            self.usage.stop()
        if self.bg is not None:
            self.bg.stop()
        if self.srv is not None and self.srv.handed_over:
            # the successor owns the fd AND the session now: flush local
            # state but leave the mount and session untouched
            logger.info("handover complete; exiting without unmount")
            self.meta.sid = 0  # close_session must not clean the live session
        if self.vfs is not None:
            self.vfs.close()
        if self.peer_srv is not None:
            self.peer_srv.stop()  # stop serving peers before the cache closes
        if self.store is not None:
            try:
                self.store.close()  # drains the ingest stage and the indexer
            except Exception as e:
                logger.warning("store shutdown: %s", e)
        self.meta.close_session()


def start_mount(args, fuse_fd: int = -1) -> Mounted:
    """Open the volume, build its store, vfs and FUSE `Server`, and mount
    it at `args.mountpoint` (or adopt a predecessor's connection with
    --takeover). With `fuse_fd` >= 0 the server speaks the FUSE protocol
    over that descriptor instead of mounting (one end of a SOCK_SEQPACKET
    socketpair whose other end sends raw requests, for a drive that needs
    no /dev/fuse). Installs no signal handler, so any thread may call it.
    A store that cannot be built (a device backend on a host with no card)
    raises before anything is mounted."""
    from ..fuse import Server
    from ..meta import interface as meta_interface
    from ..vfs import VFS, VFSConfig
    from ..vfs.backup import BackgroundJobs
    from ..vfs.compact import compact_chunk
    from . import build_store, open_meta, storage_for

    # Validate meta + storage config FIRST: once the predecessor hands
    # over its fd it exits, so a successor that dies during startup would
    # leave the mount with no server at all. The store itself is built
    # only AFTER the handover — CachedStore.__init__ runs writeback
    # staging recovery, which must not race the predecessor's live
    # staging writes in the shared cache directory.
    m, fmt = open_meta(args.meta_url)
    storage_for(fmt)  # raises on a broken storage configuration
    # replica routing is configured AFTER open_meta so the format load
    # itself always reads the primary (a replica still syncing must not
    # fail the mount)
    replica = getattr(args, "meta_replica", "")
    if replica:
        cfg = getattr(getattr(m, "client", None), "configure_replica", None)
        if cfg is not None:
            cfg(replica)
            logger.info("meta read replica: %s", replica)
        else:
            logger.warning("--meta-replica ignored: engine %s has no "
                           "replica routing", m.name())

    m.configure_meta_cache(
        attr_ttl=getattr(args, "attr_cache_ttl", 0.0),
        entry_ttl=getattr(args, "entry_cache_ttl", 0.0),
    )
    if getattr(args, "meta_op_limit", 0):
        m.configure_op_limit(args.meta_op_limit)
    if getattr(args, "meta_retries", 0):
        # configured AFTER the lease cache so degraded mode sees the real
        # LeaseCache instance
        m.configure_meta_retries(
            max_attempts=args.meta_retries,
            deadline=getattr(args, "meta_deadline", 15.0),
            degraded_max_stale=getattr(args, "meta_degraded_max_stale", 0.0))
    elif getattr(args, "meta_degraded_max_stale", 0):
        logger.warning("--meta-degraded-max-stale ignored: the degraded "
                       "ladder lives in the fault contract, which needs "
                       "--meta-retries > 0")
    if getattr(args, "write_batch", False):
        # group-commit write batching; engines without nesting
        # transactions force it back off inside
        m.configure_write_batch(
            flush_ms=getattr(args, "wbatch_flush_ms", 3.0),
            inode_prealloc=getattr(args, "wbatch_prealloc", 1024))

    if args.heartbeat <= 0:
        logger.warning("--heartbeat %.1f invalid; using 1s", args.heartbeat)
        args.heartbeat = 1.0
    elif args.heartbeat >= 300:
        # stale-session GC reaps sessions whose beat is older than 300s
        logger.warning("--heartbeat %.1f >= the 300s staleness age; "
                       "capping at 60s so the session is never reaped live",
                       args.heartbeat)
        args.heartbeat = 60.0

    # seamless upgrade (reference cmd/passfd.go): ask the predecessor for
    # its live fuse fd + open-handle state
    takeover = None
    if getattr(args, "takeover", False):
        from ..fuse.passfd import request_takeover

        takeover = request_takeover(args.mountpoint)
        if takeover is None:
            logger.info("no predecessor at %s; fresh mount", args.mountpoint)
    mounted = Mounted(m, None, None, None)
    try:
        mounted.store = store = build_store(fmt, args, meta=m)
        # cache group: start the peer block server BEFORE the session
        # registers, so the published session info already carries the
        # dialable peer_addr; discovery then rides the heartbeat cadence
        if getattr(args, "cache_group", ""):
            from ..cache import CacheGroup, PeerBlockServer

            mounted.peer_srv = PeerBlockServer(store, group=args.cache_group)
            peer_addr = mounted.peer_srv.start(
                getattr(args, "group_listen", "127.0.0.1:0"))
            m.session_extras.update(
                cache_group=args.cache_group, peer_addr=peer_addr,
                group_weight=max(1, getattr(args, "group_weight", 1)),
            )
            store.cache_group = CacheGroup(
                args.cache_group, self_addr=peer_addr, meta=m,
                weight=max(1, getattr(args, "group_weight", 1)),
                refresh_interval=args.heartbeat,
            )
            logger.info("cache group %r: serving on %s",
                        args.cache_group, peer_addr)
        if takeover is not None and takeover[1].get("sid"):
            # inherit the predecessor's session: locks and sustained inodes
            # keyed by sid remain valid across the swap; the session INFO
            # must be ours (the predecessor's record names its dead pid
            # and its dead cache-group peer_addr)
            m.sid = int(takeover[1]["sid"])
            m.update_session_info()
            m.start_heartbeat(args.heartbeat)
        else:
            m.new_session(heartbeat=args.heartbeat)
        mounted.vfs = vfs = VFS(
            m,
            store,
            VFSConfig(readonly=args.readonly, max_readahead=args.max_readahead << 20,
                      streaming_read=not args.no_streaming_read,
                      streaming_after=args.streaming_after << 20,
                      max_streaming=args.max_streaming << 20,
                      attr_timeout=args.attr_cache, entry_timeout=args.entry_cache,
                      dir_entry_timeout=args.dir_entry_cache),
            fmt,
        )
        # message handlers (reference registerMetaMsg cmd/mount.go:271):
        # zero-ref slices delete their blocks; hot chunks compact in background
        m.on_msg(meta_interface.DELETE_SLICE, lambda sid, size: store.remove(sid, size))
        m.on_msg(
            meta_interface.COMPACT_CHUNK,
            lambda ino, indx: compact_chunk(m, store, ino, indx),
        )
        if not args.no_bgjobs and not args.readonly:
            mounted.bg = BackgroundJobs(m, store)
            mounted.bg.start()
        if getattr(args, "metrics", ""):
            from ..metric import MetricsServer

            mounted.metrics_srv = MetricsServer.from_addr(args.metrics)
            logger.info("metrics on http://%s:%d/metrics",
                        mounted.metrics_srv.host, mounted.metrics_srv.port)
        if getattr(args, "metrics_push", "") or getattr(args, "graphite", ""):
            from ..metric import MetricsPusher, global_registry

            mounted.pusher = MetricsPusher(
                global_registry(), interval=args.push_interval,
                pushgateway=args.metrics_push, graphite=args.graphite,
                job=fmt.name,
            )
        report_url = getattr(args, "usage_report_url", "")
        if report_url and not getattr(args, "no_usage_report", False):
            from ..metric.usage import UsageReporter

            mounted.usage = UsageReporter(m, fmt, url=report_url)
        mounted.srv = srv = Server(
            vfs, args.mountpoint, fsname=f"juicefs-tpu-torch:{fmt.name}",
            allow_other=args.allow_other,
            writeback_cache=not getattr(args, "no_kernel_writeback", False))
        if takeover is not None:
            srv.adopt(takeover[0], takeover[1])
            logger.info("volume %s taken over at %s (%d handles restored)",
                        fmt.name, args.mountpoint,
                        len(takeover[1].get("handles", [])))
        elif fuse_fd >= 0:
            srv.attach(fuse_fd)
        else:
            _clear_stale_mount(args.mountpoint)
            srv.mount()
            logger.info("volume %s mounted at %s", fmt.name, args.mountpoint)
    except BaseException:
        mounted.close()
        raise
    srv.enable_takeover()  # we may be a future predecessor ourselves
    if not getattr(args, "no_watchdog", False):
        mounted.watchdog_stop = _start_watchdog(args.mountpoint, srv)
    return mounted


def serve(args) -> int:
    mounted = start_mount(args)
    srv = mounted.srv

    def _stop(signum, frame):
        srv.unmount()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        srv.serve()
    finally:
        mounted.close()
    return 0


def _clear_stale_mount(mountpoint: str) -> None:
    """A predecessor that died without unmounting leaves the mountpoint in
    'transport endpoint is not connected' state; lazy-unmount it so the
    fresh mount can proceed (reference mount_unix.go stale-mount check)."""
    import errno as _errno

    from ..fuse.mount import umount

    try:
        os.stat(mountpoint)
    except OSError as e:
        if e.errno in (_errno.ENOTCONN, _errno.EIO):
            logger.warning("clearing stale mount at %s", mountpoint)
            umount(mountpoint, lazy=True)


def _start_watchdog(mountpoint: str, srv) -> threading.Event:
    """Force-exit a wedged mount so the supervisor can restart it
    (reference watchdog cmd/mount_unix.go:126). A probe thread statfs-es
    the mountpoint; the watchdog only requires that SOME probe completed
    recently — a hung FUSE loop stops all probes and trips it."""
    stop = threading.Event()
    last_ok = [time.time()]

    def probe():
        while not stop.is_set():
            try:
                os.statvfs(mountpoint)
                last_ok[0] = time.time()
            except OSError:
                pass  # transient; staleness is judged by the watcher
            stop.wait(5.0)

    def watch():
        from ..fuse.mount import umount

        while not stop.wait(10.0):
            if srv.handed_over or srv._stop.is_set():
                return
            if srv._paused.is_set():
                # takeover in progress: the loop is intentionally not
                # answering probes; don't shoot it mid-flush
                last_ok[0] = time.time()
                continue
            if time.time() - last_ok[0] > 120.0:
                logger.error("mount unresponsive for 120s; aborting for restart")
                # lazy-unmount first, else the dead connection leaves the
                # mountpoint in ENOTCONN state and the supervisor's fresh
                # worker can never remount over it
                umount(mountpoint, lazy=True)
                os._exit(17)

    threading.Thread(target=probe, daemon=True, name="watchdog-probe").start()
    threading.Thread(target=watch, daemon=True, name="watchdog").start()
    return stop


def run(args) -> int:
    if not args.background:
        return serve(args)
    # Supervisor daemonization (reference 3-stage mount + restart loop).
    # Nothing before these forks has touched the card: the serving worker
    # is the first process to initialise CUDA, inside build_store.
    pid = os.fork()
    if pid > 0:
        # parent: wait for the mount to appear, then return
        for _ in range(100):
            if _is_mountpoint(args.mountpoint):
                print(f"mounted at {args.mountpoint} (supervisor pid {pid})")
                return 0
            time.sleep(0.1)
        logger.error("mount did not come up")
        return 1
    # supervisor child
    os.setsid()
    restarts = 0
    while True:
        worker = os.fork()
        if worker == 0:
            sys.exit(serve(args))
        _, status = os.waitpid(worker, 0)
        code = os.waitstatus_to_exitcode(status)
        if code == 0 or restarts > 10:
            os._exit(0)
        restarts += 1
        logger.warning("mount worker died (%s), restart #%d", code, restarts)
        time.sleep(min(restarts, 10))


def _is_mountpoint(path: str) -> bool:
    try:
        return os.stat(path).st_dev != os.stat(os.path.dirname(os.path.abspath(path))).st_dev
    except OSError:
        return False


def run_umount(args) -> int:
    from ..fuse.mount import umount
    from ..fuse.passfd import notify_unmounted

    if not umount(args.mountpoint, lazy=args.force):
        return 1
    if not args.force and notify_unmounted(args.mountpoint):
        # a FUSE device that does not report the unmount to the serving
        # process (gVisor's) would leave it running; a lazy unmount keeps
        # serving the files still open, so only a plain one tells it
        logger.info("told the process serving %s to stop", args.mountpoint)
    return 0
