"""`gc`: garbage-collect leaked objects; content dedup scan on the card (a
copy of juicefs_tpu/cmd/gc.py).

Reference cmd/gc.go:76-330: scan all slices from meta, list `chunks/`
objects from the store, diff -> leaked/pending, optionally delete.
`--dedup` streams every live block the content index lacks through the
batched JTH-256 pipeline on the card and reports duplicate content groups
and reclaimable bytes, then reconciles the content-ref plane.

`dedup_scan`'s `meta` and `store` are duck-typed: `meta` needs
scan_block_digests, set_block_digests and delete_block_digests (the
content index of the meta engine); `store` needs `_load_block(key, bsize,
cache_after=)` and `_bulk_pool` (an executor). A volume written by the JAX
package is read as it stands: same block keys, same uint32-LE digest rows.

`--compact` first merges every fragmented chunk into one slice
(vfs/compact.py); the merged slice's blocks are new to the content index,
so a `--dedup` in the same run reads them back and hashes them.

Changes from the reference: `--compress-backend` (default cuda) picks
where the compress plane of the command's store runs, as it does for
`mount`; a volume formatted with no hash backend is hashed on the card,
not on the host.
"""

from __future__ import annotations

import json
import time

from ..chunk.cached_store import block_key, parse_block_key
from ..chunk.parallel import FetchStats, fetch_ordered
from ..gpu.dedup import dedup_digests
from ..gpu.jth256 import LANE_BYTES, digest_hex
from ..gpu.pipeline import HashPipeline, PipelineConfig
from ..object.resilient import resilience_snapshot
from ..qos import IOClass
from ..utils import get_logger

logger = get_logger("cmd.gc")


def add_parser(sub):
    p = sub.add_parser("gc", help="collect leaked objects / dedup scan")
    p.add_argument("meta_url")
    p.add_argument("--delete", action="store_true", help="delete leaked objects")
    p.add_argument("--compact", action="store_true", help="compact fragmented chunks")
    p.add_argument("--dedup", action="store_true", help="content-addressed dedup scan")
    p.add_argument("--hash-backend", default=None,
                   help="cpu|cuda (tpu|xla|pallas map to cuda; default: "
                        "volume format hash_backend, cuda where it has none)")
    p.add_argument("--compress-backend", default="cuda", choices=["cpu", "cuda"],
                   help="where the compress plane of the command's store runs")
    p.add_argument("--threads", type=int, default=10)
    p.add_argument("--age", type=float, default=3600.0,
                   help="only treat objects older than this (seconds) as leaked")
    p.add_argument("--dedup-index", default="", help="write content index JSON here")
    p.set_defaults(func=run)


def run(args) -> int:
    from . import build_store, open_meta

    m, fmt = open_meta(args.meta_url)
    # meta-attached store: dedup-scan reads of PUT-elided blocks resolve
    # through the content-ref plane. No indexer: gc backfills digest rows
    # itself through dedup_scan's own pipeline.
    store = build_store(fmt, args, meta=m, with_indexer=False)
    try:
        return _run(args, m, fmt, store)
    finally:
        store.close()


def _run(args, m, fmt, store) -> int:
    bs = fmt.block_size * 1024

    if args.compact:
        from ..vfs.compact import compact_all

        n = compact_all(m, store)
        print(f"compacted {n} chunks")

    # live slice -> expected blocks
    slices = m.list_slices()
    live: dict[str, int] = {}
    for ino, slcs in slices.items():
        for s in slcs:
            if s.id == 0 or s.size == 0:
                continue
            n_blocks = (s.size + bs - 1) // bs
            for i in range(n_blocks):
                bsize = min(bs, s.size - i * bs)
                live[block_key(s.id, i, bsize)] = bsize

    # stored objects under chunks/
    cutoff = time.time() - args.age
    stored = {}
    recent = set()
    for obj in store.storage.list_all("chunks/"):
        parsed = parse_block_key(obj.key)
        if parsed is not None:
            stored[obj.key] = obj.size
            if obj.mtime > cutoff:
                recent.add(obj.key)

    # Inline dedup: an elided block has no object of its own — its bytes
    # live under the canonical block of its content ref. The name diff
    # must translate through the alias plane: aliased live blocks are not
    # "missing", and a canonical object is not "leaked" while any live
    # alias still references it.
    try:
        from ..chunk.ingest import alias_map

        aliases = alias_map(m)
        protected = set(aliases.values())
    except Exception as e:
        logger.warning("content-ref scan unavailable: %s", e)
        aliases, protected = {}, set()

    # An object can be uploaded before its slice commits to meta (the write
    # pipeline is async), so fresh objects are never "leaked" (reference gc
    # skips recent blocks for the same reason).
    leaked = [k for k in stored
              if k not in live and k not in recent and k not in protected]
    missing = [k for k in live
               if k not in stored and aliases.get(k, k) not in stored]
    print(
        f"scanned: {len(stored)} objects, {len(live)} live blocks "
        f"({sum(1 for k in live if k in aliases)} deduped), "
        f"{len(leaked)} leaked, {len(missing)} missing"
    )
    if missing:
        for k in missing[:10]:
            logger.warning("missing block: %s", k)

    if leaked and args.delete:
        # BACKGROUND class on the scheduler's bulk lane: a gc sweep
        # sharing a process with a mount must not displace reads
        with store.scheduler.executor(
            "bulk", IOClass.BACKGROUND, width=args.threads
        ) as pool:
            list(pool.map(store.storage.delete, leaked))
        print(f"deleted {len(leaked)} leaked objects")

    if args.dedup:
        from ..chunk.indexer import pipeline_backend

        # a volume formatted without a hash backend is scanned on the
        # card too: only an explicit cpu hashes on the host
        backend = pipeline_backend(args.hash_backend or fmt.hash_backend or "cuda")
        stats = dedup_scan(m, store, live, backend, args.dedup_index, bs,
                           threads=args.threads)
        # offline complement of the inline ingest stage: repair refcounts
        # left by crash windows, register existing content so future
        # writes elide, and (with --delete) collapse duplicate objects
        # already in the store into aliases
        stats["content_refs"] = reconcile_content_refs(
            m, store, live, stored, collapse=args.delete, age=args.age
        )
        print(json.dumps(stats))
    return 0


def dedup_scan(meta, store, live: dict[str, int], backend: str,
               index_path: str, block_size: int, threads: int = 8,
               device=None, batch_blocks: int = 32) -> dict:
    """Content-dedup scan over all live blocks.

    Incremental: digests already in the meta content index are trusted;
    only blocks missing from it are read back (up to `threads` GETs in
    flight, in input order) and hashed, and their rows are backfilled.
    Index rows of dead slices are pruned. `backend` is a pipeline backend
    (cpu | cuda); `device` is where the cuda backend runs (None: the card,
    which must exist).

    Returns the reference's keys, `resilience` (the object plane's retry,
    breaker and hedge counters) included.
    """
    t0 = time.perf_counter()
    # 1. load the persistent index; prune rows for dead slices
    digest_by_key: dict[str, bytes] = {}
    stale: list[tuple[int, int]] = []
    for sid, indx, bsize, digest in meta.scan_block_digests():
        key = block_key(sid, indx, bsize)
        if key in live:
            digest_by_key[key] = digest
        else:
            stale.append((sid, indx))
    if stale:
        meta.delete_block_digests(stale)
    indexed = len(digest_by_key)
    t_index = time.perf_counter() - t0

    # 2. hash only blocks the index lacks; backfill their rows
    missing = [k for k in live if k not in digest_by_key]
    pipe = HashPipeline(
        PipelineConfig(backend=backend, batch_blocks=batch_blocks,
                       pad_lanes=max(1, block_size // LANE_BYTES)),
        device=device,
    )
    window = max(1, threads)
    fstats = FetchStats()

    def blocks():
        # a bad block is skipped (and logged by the stage), never aborts
        yield from fetch_ordered(
            missing,
            lambda key: store._load_block(key, live[key], cache_after=False),
            store._bulk_pool, window, on_error="skip", stats=fstats,
        )

    t1 = time.perf_counter()
    backfill = []
    for key, digest in pipe.hash_stream(blocks()):
        digest_by_key[key] = digest
        sid, indx, bsize = parse_block_key(key)
        backfill.append((sid, indx, bsize, digest))
    t_readhash = time.perf_counter() - t1
    t2 = time.perf_counter()
    if backfill:
        meta.set_block_digests(backfill)
    t_meta = time.perf_counter() - t2

    # 3. duplicate grouping over the full digest set
    t3 = time.perf_counter()
    keys = list(digest_by_key)
    digests = [digest_by_key[k] for k in keys]
    dup_mask, first_idx = dedup_digests(digests)
    dup_bytes = sum(live[keys[i]] for i, d in enumerate(dup_mask) if d)
    groups: dict[str, list[str]] = {}
    for i, d in enumerate(dup_mask):
        if d:
            groups.setdefault(keys[first_idx[i]], []).append(keys[i])
    t_group = time.perf_counter() - t3
    if index_path:
        with open(index_path, "w") as f:
            json.dump(
                {keys[i]: digest_hex(digests[i]) for i in range(len(keys))},
                f,
                indent=1,
            )
    total = time.perf_counter() - t0
    nbytes = sum(live.values())
    return {
        "blocks": len(keys),
        "bytes": nbytes,
        "from_index": indexed,
        "hashed_now": len(backfill),
        "stale_index_rows_removed": len(stale),
        "duplicate_blocks": int(dup_mask.sum()),
        "duplicate_bytes": int(dup_bytes),
        "dedup_groups": len(groups),
        "backend": backend,
        "fetch_window": window,
        # `get` is wall time with GETs in flight, `get_threads` aggregate
        # per-thread GET seconds; `hash` is the read+hash wall not hidden
        # behind the fetch window
        "seconds": round(total, 3),
        "gibs": round(nbytes / (1 << 30) / total, 3) if total > 0 else 0.0,
        "blocks_per_s": round(len(keys) / total, 1) if total > 0 else 0.0,
        "stage_seconds": {
            "index_load": round(t_index, 3),
            "get": round(fstats.wall, 3),
            "get_threads": round(fstats.seconds, 3),
            "hash": round(max(t_readhash - fstats.wall, 0.0), 3),
            "meta_backfill": round(t_meta, 3),
            "dup_group": round(t_group, 3),
        },
        "shard": pipe.shard_snapshot(),
        "resilience": resilience_snapshot(),
    }


def reconcile_content_refs(meta, store, live: dict[str, int],
                           stored: dict[str, int],
                           collapse: bool = False,
                           age: float = 3600.0) -> dict:
    """Offline repair + backfill for the content-ref plane —
    the recovery half of the inline ingest dedup contract:

      1. aliases of dead blocks (elide committed, slice never did — the
         crash window between elision and meta commit) are decref'd;
      2. refcounts are pinned to the observed alias count;
      3. dangling aliases (no ref row) self-heal when the block still has
         its own object, and are REPORTED as data loss otherwise;
      4. content already in the store is registered so future writes
         elide against it; with collapse=True duplicate objects are
         rewritten into aliases and deleted (the Venti-style offline
         reclaim the inline stage cannot do retroactively).

    Invariant after this runs: every alias row maps a live block to a
    ref row whose refcount equals its alias count — zero orphaned, zero
    dangling."""
    stats = {"orphaned_aliases_repaired": 0, "refcounts_fixed": 0,
             "dangling_content_refs": 0, "self_healed_aliases": 0,
             "registered": 0, "collapsed": 0, "collapsed_bytes": 0}

    # 1. orphaned aliases: the block is gone but its ref survived. The
    # age cutoff mirrors the leaked-object diff's `recent` guard: a
    # writer elides (alias committed) BEFORE its slice commits to meta,
    # so a fresh alias absent from `live` is an in-flight acked write,
    # not a crash orphan — repairing it would delete data mid-commit.
    cutoff = time.time() - age
    aliases = list(meta.scan_content_aliases())
    orphaned = [
        (sid, indx) for (sid, indx), _d, bsize, ts in aliases
        if block_key(sid, indx, bsize) not in live and ts < cutoff
    ]
    if orphaned:
        for disp, canonical in meta.content_decref(orphaned):
            if disp == "last" and canonical is not None:
                ck = block_key(*canonical)
                if ck not in live:
                    try:
                        store.storage.delete(ck)
                    except Exception:
                        pass
        stats["orphaned_aliases_repaired"] = len(orphaned)
        aliases = list(meta.scan_content_aliases())

    # 2/3. refcount vs alias count; dangling aliases
    ref_rows = {d: (canonical, refs)
                for d, canonical, refs in meta.scan_content_refs()}
    alias_count: dict[bytes, int] = {}
    dangling: list[tuple[int, int]] = []
    for (sid, indx), digest, bsize, _ts in aliases:
        if digest in ref_rows:
            alias_count[digest] = alias_count.get(digest, 0) + 1
        elif block_key(sid, indx, bsize) in stored:
            # the block still has its own object: drop the stray alias
            meta.content_delete_aliases([(sid, indx)])
            stats["self_healed_aliases"] += 1
        else:
            dangling.append((sid, indx))
            logger.error("dangling content ref: block %s has no object "
                         "and no canonical", block_key(sid, indx, bsize))
    stats["dangling_content_refs"] = len(dangling)
    for digest, (canonical, refs) in list(ref_rows.items()):
        observed = alias_count.get(digest, 0)
        if observed != refs:
            meta.content_set_refs(digest, observed)
            stats["refcounts_fixed"] += 1
            if observed == 0:
                ck = block_key(*canonical)
                del ref_rows[digest]  # treated as absent below
                if ck not in live:
                    try:
                        store.storage.delete(ck)
                    except Exception:
                        pass

    # 4. backfill: register live content the inline stage never saw, so
    # future duplicate writes elide against it; collapse rewrites
    # already-duplicated objects into aliases and reclaims their bytes
    aliased = {(sid, indx) for (sid, indx), _d, _b, _ts in
               list(meta.scan_content_aliases())}
    groups: dict[bytes, list[tuple[int, int, int]]] = {}
    for sid, indx, bsize, digest in meta.scan_block_digests():
        key = block_key(sid, indx, bsize)
        if key in live and (sid, indx) not in aliased and key in stored:
            groups.setdefault(digest, []).append((sid, indx, bsize))
    register = []
    collapsible: list[tuple[bytes, int, int, int]] = []
    for digest, members in groups.items():
        start = 0
        if digest not in ref_rows:
            sid, indx, bsize = members[0]
            register.append((digest, sid, indx, bsize))
            start = 1
        else:
            # a canonical whose self-alias row went missing shows up here
            # as an unaliased member: it must NEVER be collapsed (deleting
            # it would orphan every alias of the digest)
            canonical = ref_rows[digest][0]
            members = [m for m in members if m != canonical]
            start = 0
        collapsible.extend((digest, *m) for m in members[start:])
    if register:
        meta.content_register(register)
        stats["registered"] = len(register)
    if collapse and collapsible:
        results = meta.content_incref(
            [(d, sid, indx, bsize) for d, sid, indx, bsize in collapsible]
        )
        for (digest, sid, indx, bsize), got in zip(collapsible, results):
            if got is None:
                continue  # ref vanished mid-flight: leave the object alone
            if got == (sid, indx, bsize):
                continue  # we ARE the canonical: never delete its object
            try:
                store.storage.delete(block_key(sid, indx, bsize))
            except Exception:
                pass
            store.cache.remove(block_key(sid, indx, bsize))
            stats["collapsed"] += 1
            stats["collapsed_bytes"] += bsize
    return stats
