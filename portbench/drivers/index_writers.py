"""A closed loop of file writers on a plain mount of a volume formatted
with a hash backend: every block the writers upload goes to the content
indexer (`BlockIndexer`), which hashes it on the card off the write path
and records its row in the meta content index.

The writers are `slice_writers`' own (`Writer`, the same thread helpers
and window): each of `writers` threads writes files of `file_mib` in
`write_kib` writes through `CachedStore.new_writer`, `write_at` and
`flush_to`, closes each with every slice's `finish()`, and removes its
oldest files past its share of the live bytes. Each writer's blocks follow
its stream (`data.WriterStream`, as `reference/index_write.py` plans it);
the pool blocks are written once at set-up as a file that stays. There is
no inline-dedup stage: each block is uploaded whole, and the upload hands
it to the indexer (`ChunkConfig.fingerprint`, inside `chunk.upload.put`),
which drops it, counted, when its queue is full; the index is advisory.

Set-up writes the pool file, then one chunk-sized file from every writer
at once, then waits for the indexer to drain, which loads the kernel at
the window's 32-block shape. The window and its metrics are
`slice_writers.window`'s. The window record also carries the window's
deltas of the indexer's counters `juicefs_index_blocks`, `_bytes`,
`_dropped` and `_errors` (as `index_blocks`, ...), each left out where
the program has no such counter.

`check` drains the uploads and then the indexer (each wait bounded, so a
stalled indexer ends the run with an error), and holds the indexer's own
counts (`BlockIndexer.stats()`) to the blocks uploaded: every block
indexed, dropped or in a failed batch, no batch failed, and at most
`DROPPED_LIMIT_PCT` dropped. A seeded sample of the live blocks (the pool
file's and the writers') is held to the reference: each read back
through a cold `CachedStore` byte for byte, and its index row to the
frozen reference's digest (a missing row is an error beyond the blocks
dropped).
"""

from __future__ import annotations

import itertools
import json

import numpy as np

from .. import data
from ..reference import index_write as plan
from ..volume import open_volume
from .slice_writers import POOL_SID, SAMPLE, Writer, _run_writers, close
from .slice_writers import window as writers_window

# the most blocks, in % of those uploaded, that the indexer may drop under
# overload before a run is not correct: the overload contract the
# inline-dedup cells hold as passthrough_pct
DROPPED_LIMIT_PCT = 1.0
COUNTERS = ("juicefs_index_blocks", "juicefs_index_bytes", "juicefs_index_dropped",
            "juicefs_index_errors")


class IndexWriter(Writer):
    """A writer that records where each of its slices lies in its stream."""

    def __init__(self, st, w: int, ctx):
        super().__init__(st, w, ctx)
        self.w = w
        self.pos = 0  # blocks drawn from the stream so far

    def write_file(self, n_blocks: int) -> float:
        first = self.pos
        self.pos += n_blocks
        dt = super().write_file(n_blocks)
        per_slice = self.st["chunk"] // self.st["bs"]
        for i, (sid, _cids) in enumerate(self.live[-1]):
            self.st["placed"][sid] = (self.w, first + i * per_slice)
        return dt


def index_counters() -> dict:
    """The indexer's cumulative counters under their short names, those
    the program has."""
    from juicefs_tpu_torch.metric import global_registry

    have = {m.name: m for m in global_registry().walk() if m.kind == "counter"}
    return {name[len("juicefs_"):]: have[name].value for name in COUNTERS if name in have}


def setup(ctx) -> dict:
    cfg, tr = ctx.config, ctx.traffic
    bs = cfg["block_size_kib"] * 1024
    chunk = cfg["chunk_mib"] << 20
    file_bytes = tr["file_mib"] << 20
    piece = tr["write_kib"] * 1024
    if file_bytes % bs or chunk % bs or bs % piece:
        raise ValueError("file_mib and chunk_mib must be whole blocks, and "
                         "write_kib a divisor of the block size")
    meta, fmt, store, _args = open_volume(cfg, ctx.workdir, with_indexer=True)
    st = {"meta": meta, "fmt": fmt, "store": store}
    if store.indexer is None:
        close(st)
        raise ValueError(f"configuration {cfg['name']!r}: the store has no content "
                         "indexer (a volume formatted with no hash backend)")
    contents = data.Contents(ctx.buffer, bs, tr["dup_pool"], tr["stride_bytes"])
    st.update({
        "contents": contents, "bs": bs, "chunk": chunk, "write": piece,
        "file_blocks": file_bytes // bs, "writers": tr["writers"],
        "dup_every": tr["dup_every"], "dup_pool": tr["dup_pool"],
        "stride": tr["stride_bytes"],
        "keep_bytes": int(cfg["live_gib"] * (1 << 30)) // tr["writers"],
        "sids": itertools.count(POOL_SID + 1), "placed": {},
    })
    w = store.new_writer(POOL_SID)
    for j, b in enumerate(contents.pool):
        w.write_at(b, j * bs)
    w.finish(len(contents.pool) * bs)
    st["ws"] = [IndexWriter(st, i, ctx) for i in range(st["writers"])]
    warm = min(st["file_blocks"], chunk // bs)
    _run_writers(st, lambda wr: wr.write_file(warm))  # warm-up: one chunk each
    for wr in st["ws"]:
        if wr.error:
            raise RuntimeError(f"warm-up write failed: {wr.error}")
    store.flush_all()
    store.indexer.flush(60.0)
    return st


def window(st, ctx, trace) -> dict:
    c0 = index_counters()
    win = writers_window(st, ctx, trace)
    c1 = index_counters()
    win.update({name: c1[name] - c0[name] for name in c1 if name in c0})
    return win


def check(st, ctx) -> list[tuple[str, float, float]]:
    from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig

    store, bs = st["store"], st["bs"]
    store.flush_all()
    store.indexer.flush(60.0)
    stats = store.indexer.stats()
    print("indexer stats " + json.dumps(stats), file=ctx.err)
    uploaded = (sum(w.dups + w.uniques for w in st["ws"]) + len(st["contents"].pool))
    indexed, dropped, failed_blocks = stats["blocks"], stats["dropped"], stats["errors"]
    index_count_errors = abs(indexed + dropped + failed_blocks - uploaded) + failed_blocks
    # the pool file's blocks, the first the indexer ever hashes, and every
    # live block of the writers' files
    live = [(POOL_SID, j) for j in range(len(st["contents"].pool))]
    live += [(sid, i) for w in st["ws"] for f in w.live for sid, cids in f
             for i in range(len(cids))]
    rng = np.random.default_rng(data.seed_key(ctx.seed, 7))
    n = min(len(live), ctx.sample or SAMPLE)
    picked = [live[int(i)] for i in sorted(rng.choice(len(live), n, replace=False))]
    want = plan.rows(ctx.buffer, ctx.seed, st["placed"], picked, writers=st["writers"],
                     dup_every=st["dup_every"], pool=st["dup_pool"], block_size=bs,
                     stride=st["stride"], pool_sid=POOL_SID)
    rows = {(sid, indx): d for sid, indx, _b, d in st["meta"].scan_block_digests()}
    cold = CachedStore(store.storage, ChunkConfig(
        block_size=bs, compress=st["fmt"].compression, compress_backend="cpu",
        cache_dirs=("memory",), cache_size=1 << 20, prefetch=0))
    readback_errors = digest_errors = missing = 0
    try:
        for sid, i in picked:
            block, digest = want[(sid, i)]
            try:
                got = bytes(cold.new_reader(sid, (i + 1) * bs).read(i * bs, bs))
            except Exception as e:  # a block that cannot be read is wrong
                print(f"read-back of slice {sid} block {i}: {e!r}", file=ctx.err)
                got = None
            readback_errors += got != block
            row = rows.get((sid, i))
            if row is None:
                missing += 1
            else:
                digest_errors += row != digest
    finally:
        cold.close()
    # a dropped block has no row: no more blocks without one than were dropped
    digest_errors += max(0, missing - dropped)
    failed = sum(w.failed for w in st["ws"])
    return [("readback_errors", readback_errors, 0), ("digest_errors", digest_errors, 0),
            ("index_count_errors", index_count_errors, 0),
            ("dropped_pct", 100.0 * dropped / uploaded, DROPPED_LIMIT_PCT),
            ("failed_commits", failed, 0)]
