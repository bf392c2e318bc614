"""`gc --dedup` scan leg of the port: the counterpart of
juicefs_tpu/cmd/gc.py dedup_scan (gc.py:135-259).

Streams every live block through the batched JTH-256 pipeline on the card
and reports duplicate content groups and reclaimable bytes. `meta` and
`store` are duck-typed: `meta` needs scan_block_digests,
set_block_digests and delete_block_digests (the content index of the meta
engines); `store` needs `_load_block(key, bsize, cache_after=)` and
`_bulk_pool` (an executor). A volume written by the JAX package is read as
it stands: same block keys, same uint32-LE digest rows.
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
