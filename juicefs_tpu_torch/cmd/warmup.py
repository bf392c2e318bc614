"""`warmup`: pre-fill the local cache for paths (a copy of
juicefs_tpu/cmd/warmup.py; reference cmd/warmup.go + pkg/vfs/fill.go:57-145
— walk the tree, FillCache every slice).

Warmup moves blocks and hashes none: its store is built on the host
(`compress_backend="cpu"`, no indexer, no ingest stage), so it touches no
device whatever the volume's hash backend. `--cache-dir` and
`--cache-size` name the cache it fills, as for `mount`: a member's cache
dir can be warmed while that member is down (a live mount holds the
directory's lock), and the member serves the blocks when it starts.

With `--cache-group` the fill is DISTRIBUTED: each invocation
warms only the blocks this member owns on the group's consistent-hash
ring, so a fleet-wide warmup moves each block from the object store
exactly once instead of once per client — everyone else reads it from
the owner's peer server. A PUT-elided block belongs to the owner of its
canonical object, so on an inline-dedup volume each stored object leaves
the object store once per fleet-wide warmup (the reference's ring goes
by the block's own key, and fetches a shared object once per owner)."""

from __future__ import annotations

from ..meta.context import BACKGROUND
from ..meta.types import TYPE_DIRECTORY, TYPE_FILE
from ..utils import get_logger

logger = get_logger("cmd.warmup")


def add_parser(sub):
    p = sub.add_parser("warmup", help="prefill block cache for paths")
    p.add_argument("meta_url")
    p.add_argument("paths", nargs="+", help="volume-absolute paths, e.g. /data")
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--cache-group", default="",
                   help="distribute the fill across this cache group's "
                        "ring: warm only the blocks THIS member owns")
    p.add_argument("--group-self", default="",
                   help="peer address identifying this member on the ring "
                        "(default: the group session on this hostname)")
    p.add_argument("--cache-dir", default="",
                   help="colon-separated cache dirs to fill, or 'memory' "
                        "(default: an in-process cache, gone at exit)")
    p.add_argument("--cache-size", default=0, type=int, help="cache size MiB")
    p.set_defaults(func=run)


def fill_paths(m, store, paths: list[str], threads: int = 8,
               group=None) -> tuple[int, int]:
    """Warm every slice under the given paths; returns (files, slices).
    With `group` (a cache.CacheGroup) only ring-owned blocks are fetched.

    Per-slice fills fan out at BACKGROUND class on the scheduler's bulk
    lane: warmup is maintenance, and its block loads (nested on
    the download lane) inherit background priority via the ambient-class
    demotion rule — a concurrent foreground reader keeps its p99."""
    from ..qos import IOClass

    files = []

    def walk(ino: int, typ: int) -> None:
        if typ == TYPE_FILE:
            files.append(ino)
            return
        if typ != TYPE_DIRECTORY:
            return
        st, entries = m.readdir(BACKGROUND, ino, want_attr=True)
        if st:
            return
        for e in entries:
            if e.name in (b".", b".."):
                continue
            walk(e.inode, e.attr.typ if e.attr else 0)

    for path in paths:
        st, ino, attr = m.resolve(BACKGROUND, path)
        if st:
            logger.error("resolve %s: errno %d", path, st)
            continue
        walk(ino, attr.typ)

    tasks = []
    for ino in files:
        st, attr = m.getattr(BACKGROUND, ino)
        if st:
            continue
        from ..meta.types import CHUNK_SIZE

        for indx in range((attr.length + CHUNK_SIZE - 1) // CHUNK_SIZE):
            st, slices = m.read_chunk(ino, indx)
            if st:
                continue
            tasks.extend((s.id, s.size) for s in slices if s.id)

    only = group.owns if group is not None else None
    with store.scheduler.executor(
        "bulk", IOClass.BACKGROUND, width=threads
    ) as pool:
        list(pool.map(lambda t: store.fill_cache(*t, only=only), tasks))
    return len(files), len(tasks)


def _group_for(m, name: str, self_addr: str):
    """Build a discovery-backed CacheGroup for a warmup run.  The warmup
    process is not the mount, so its ring identity is the LOCAL mount's
    published peer address — given explicitly or found by hostname."""
    import socket

    from ..cache import CacheGroup

    if not self_addr:
        import time

        host = socket.gethostname()
        now = time.time()
        for s in m.do_list_sessions():
            expire = getattr(s, "expire", 0.0) or 0.0
            if (getattr(s, "cache_group", "") == name
                    and getattr(s, "peer_addr", "")
                    and s.hostname == host
                    and not 0 < expire < now):  # skip stale leftovers —
                # a dead predecessor's record must not become our identity
                self_addr = s.peer_addr
                break
    if not self_addr:
        # without a ring identity, owns() would reject EVERY key (all
        # owners are real peers) and the warmup would silently fetch
        # nothing — degrade to an undistributed fill-all instead
        logger.warning(
            "cache group %r: no member on this host (and no --group-self); "
            "warming every block locally", name)
        return None
    return CacheGroup(name, self_addr=self_addr, meta=m)


def run(args) -> int:
    from . import build_store, open_meta

    m, fmt = open_meta(args.meta_url)
    # meta-attached store: warming PUT-elided blocks needs alias
    # resolution through the content-ref plane. No indexer: warmup only
    # reads, and its store never compresses, so it stays on the host.
    args.compress_backend = "cpu"
    store = build_store(fmt, args, meta=m, with_indexer=False)
    group = None
    if args.cache_group:
        group = _group_for(m, args.cache_group, args.group_self)
    try:
        nfiles, nslices = fill_paths(m, store, args.paths, args.threads,
                                     group=group)
    finally:
        if group is not None:
            group.close()
        store.close()  # flushes the filled cache and frees its dir lock
    shard = f" (ring shard of group {args.cache_group!r})" \
        if group is not None else ""
    print(f"warmed {nfiles} files / {nslices} slices{shard}")
    return 0
