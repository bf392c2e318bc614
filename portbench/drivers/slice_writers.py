"""A closed loop of file writers on an inline-dedup volume.

Each of `writers` threads writes files of `file_mib`, one after another,
in `write_kib` writes, and closes each. It drives the chunk store as the
port's mount does (`vfs/writer.py`): a file is split at the configured
chunk size into one slice a chunk (`CachedStore.new_writer`), each write
is handed over as a view of the writer's buffer (`write_at`, which copies
it into the block's buffer) and every block it completes is flushed to
the upload at once (`flush_to`); the close is the commit barrier, every
slice's `finish()` in turn. A file is committed when its close returns,
and its latency runs from its first write to then. Each writer's blocks
follow `data.WriterStream`: one block in every `dup_every` is drawn from
a pool of `dup_pool` blocks, the rest are unique. The pool's blocks are
written once at set-up as a file of their own that stays, so every pool
block written later is a duplicate of live content, and with the elision
bypass off each must be elided. After each close a writer removes its
oldest files through `CachedStore.remove` while it holds more than its
share of the configured live bytes, as a job that keeps its last few
outputs does.

Set-up writes the pool file and then one chunk-sized file from every
writer at once, which builds and loads the kernels. In the window,
writers start new files until the time is up; the window closes when the
last close returns. `write_gibs` is the bytes of every file committed in
the window over its seconds, removals included, and `write_p95_ms` the
95th percentile of every such file's latency; `write_card_ms_per_gib`
and `write_kernel_ms_per_gib` divide the card's busy time and its
kernels' time in the window by the bytes committed.

`check` holds the ingest stage's counts to the plan (every block elided,
uploaded or passed through, no unique block elided, no error or race),
the share of blocks passed through to its limit, and a seeded sample of
the live blocks to the reference: each read back through a cold
`CachedStore` byte for byte (an elided block through its canonical), its
index row to the frozen reference's digest, and its content-ref verdict
(alias of the pool block's canonical, or none) to the plan.
"""

from __future__ import annotations

import collections
import json
import threading
import time

import numpy as np

from .. import data
from ..devtrace import span
from ..reference import jth256 as ref
from ..stats import p95
from ..volume import close_meta, open_volume

SAMPLE = 128  # live blocks read back and compared with the reference
POOL_SID = 1
# the most blocks, in % of those written, that the ingest stage may pass
# through unhashed under overload (dedup never blocks a write) before a
# run is not correct: sound runs on an H100 read 0-0.073 %, a stage that
# refuses a third of the blocks 20-40 %, one that refuses all 100 %, and
# a writer that outruns the stage 65-68 % (PERF.md, section 4)
PASSTHROUGH_LIMIT_PCT = 1.0


class Writer:
    def __init__(self, st, w: int, ctx):
        self.st = st
        self.stream = data.WriterStream(ctx.seed, w, st["writers"], st["dup_every"],
                                        st["dup_pool"])
        self.live: collections.deque = collections.deque()  # files: [(sid, cids)]
        self.live_bytes = 0
        self.latencies: list[float] = []
        self.bytes = 0
        self.dups = 0
        self.uniques = 0
        self.failed = 0
        self.error = None

    def write_file(self, n_blocks: int) -> float:
        """Write, flush and close one file of `n_blocks` blocks; returns
        its latency in seconds."""
        st = self.st
        store, bs, contents, piece = st["store"], st["bs"], st["contents"], st["write"]
        cids = [self.stream.next() for _ in range(n_blocks)]
        per_slice = st["chunk"] // bs
        slices = [(next(st["sids"]), cids[i:i + per_slice])
                  for i in range(0, n_blocks, per_slice)]
        t0 = time.perf_counter()
        with span("portbench.ingest.file"):
            ws = []
            for sid, part in slices:
                w = store.new_writer(sid)
                ws.append(w)
                off = 0
                for cid in part:
                    view = memoryview(contents.block(cid))
                    for i in range(0, bs, piece):
                        off += w.write_at(view[i:i + piece], off)
                        w.flush_to(off)
            for w, (_sid, part) in zip(ws, slices):
                w.finish(len(part) * bs)
        dt = time.perf_counter() - t0
        self.dups += sum(c < 0 for c in cids)
        self.uniques += sum(c >= 0 for c in cids)
        self.live.append(slices)
        self.live_bytes += n_blocks * bs
        while self.live_bytes > st["keep_bytes"] and len(self.live) > 1:
            old = self.live.popleft()
            with span("portbench.ingest.remove"):
                for sid, part in old:
                    store.remove(sid, len(part) * bs)
            self.live_bytes -= sum(len(part) for _sid, part in old) * bs
        return dt

    def run(self, deadline: float) -> None:
        n = self.st["file_blocks"]
        while time.perf_counter() < deadline:
            try:
                dt = self.write_file(n)
            except Exception as e:  # a failed commit is counted and reported
                self.failed += 1
                self.error = repr(e)
                return
            self.latencies.append(dt)
            self.bytes += n * self.st["bs"]


def setup(ctx) -> dict:
    import itertools

    cfg, tr = ctx.config, ctx.traffic
    bs = cfg["block_size_kib"] * 1024
    chunk = cfg["chunk_mib"] << 20
    file_bytes = tr["file_mib"] << 20
    piece = tr["write_kib"] * 1024
    if file_bytes % bs or chunk % bs or bs % piece:
        raise ValueError("file_mib and chunk_mib must be whole blocks, and "
                         "write_kib a divisor of the block size")
    meta, fmt, store, _args = open_volume(cfg, ctx.workdir, with_indexer=True)
    contents = data.Contents(ctx.buffer, bs, tr["dup_pool"], tr["stride_bytes"])
    st = {
        "meta": meta, "fmt": fmt, "store": store, "contents": contents, "bs": bs,
        "chunk": chunk, "write": piece, "file_blocks": file_bytes // bs,
        "writers": tr["writers"], "dup_every": tr["dup_every"], "dup_pool": tr["dup_pool"],
        "keep_bytes": int(cfg["live_gib"] * (1 << 30)) // tr["writers"],
        "sids": itertools.count(POOL_SID + 1),
    }
    # the pool, written once and kept: later pool blocks duplicate live content
    w = store.new_writer(POOL_SID)
    for j, b in enumerate(contents.pool):
        w.write_at(b, j * bs)
    w.finish(len(contents.pool) * bs)
    st["ws"] = [Writer(st, i, ctx) for i in range(st["writers"])]
    warm = min(st["file_blocks"], chunk // bs)
    _run_writers(st, lambda wr: wr.write_file(warm))  # warm-up: one chunk each
    for wr in st["ws"]:
        if wr.error:
            raise RuntimeError(f"warm-up write failed: {wr.error}")
    store.ingest.flush()
    return st


def _start_writers(st, fn) -> list:
    def body(wr):
        try:
            fn(wr)
        except BaseException as e:
            wr.error = repr(e)

    threads = [threading.Thread(target=body, args=(wr,), name=f"portbench-writer-{i}")
               for i, wr in enumerate(st["ws"])]
    for t in threads:
        t.start()
    return threads


def _run_writers(st, fn) -> None:
    for t in _start_writers(st, fn):
        t.join()


def window(st, ctx, trace) -> dict:
    before = [(len(w.latencies), w.bytes) for w in st["ws"]]
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    threads = _start_writers(st, lambda wr: wr.run(deadline))
    if trace.enabled:
        # the traced sub-window: the middle half of the window, started and
        # stopped from this thread while the writers run
        time.sleep(max(0.0, t0 + ctx.seconds / 4 - time.perf_counter()))
        trace.start()
        time.sleep(max(0.0, t0 + 3 * ctx.seconds / 4 - time.perf_counter()))
        trace.stop()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    lat = [x for w, (n, _b) in zip(st["ws"], before) for x in w.latencies[n:]]
    nbytes = sum(w.bytes - b for w, (_n, b) in zip(st["ws"], before))
    failed = sum(w.failed for w in st["ws"])
    for w in st["ws"]:
        if w.error:
            print(f"writer failed: {w.error}", file=ctx.err)
    metrics = {"write_gibs": {"value": nbytes / (1 << 30) / elapsed, "unit": "GiB/s"}}
    if lat:
        metrics["write_p95_ms"] = {"value": p95(lat) * 1e3, "unit": "ms"}
    card = {"write_card_ms_per_gib": ("busy", nbytes),
            "write_kernel_ms_per_gib": ("kernels", nbytes)}
    return {"metrics": metrics, "card_work": card,
            "attempted": len(lat) + failed, "failed": failed,
            "window_s": elapsed, "files": len(lat), "bytes": nbytes}


def check(st, ctx) -> list[tuple[str, float, float]]:
    from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig
    from juicefs_tpu_torch.chunk.cached_store import block_key
    from juicefs_tpu_torch.chunk.ingest import ContentRefs

    store, bs, contents = st["store"], st["bs"], st["contents"]
    store.flush_all()
    stats = store.ingest.stats()
    print("ingest stats " + json.dumps({k: v for k, v in stats.items()
                                        if not isinstance(v, dict)}), file=ctx.err)
    dups = sum(w.dups for w in st["ws"])
    written = dups + sum(w.uniques for w in st["ws"]) + len(contents.pool)
    # every block has one fate: elided, uploaded as new content, or passed
    # through to a plain upload when the ingest queue was full (the port's
    # overload contract: dedup never blocks a write, and says so in
    # `passthrough`); every duplicate not passed through is elided and no
    # unique block is
    elided, passed = stats["put_elided"], stats["passthrough"]
    elide_errors = (abs(elided + stats["uploaded"] + passed - written)
                    + max(0, elided - dups) + max(0, dups - passed - elided)
                    + stats["errors"] + stats["race_collapsed"])
    live = [(sid, i, cid) for w in st["ws"] for f in w.live for sid, cids in f
            for i, cid in enumerate(cids)]
    rng = np.random.default_rng(data.seed_key(ctx.seed, 5))
    n = min(len(live), ctx.sample or SAMPLE)
    picked = [live[int(i)] for i in sorted(rng.choice(len(live), n, replace=False))]
    rows = {(sid, indx): d for sid, indx, _b, d in st["meta"].scan_block_digests()}
    want_d = ref.digests([contents.block(cid) for _s, _i, cid in picked])
    cold = CachedStore(store.storage, ChunkConfig(
        block_size=bs, compress=st["fmt"].compression, compress_backend="cpu",
        cache_dirs=("memory",), cache_size=1 << 20, prefetch=0))
    refs = ContentRefs(st["meta"])
    cold.content_refs = refs
    readback_errors = verdict_errors = digest_errors = 0
    unhashed = unelided = 0  # blocks that look passed through
    try:
        for (sid, i, cid), digest in zip(picked, want_d):
            try:
                got = bytes(cold.new_reader(sid, (i + 1) * bs).read(i * bs, bs))
            except Exception as e:  # a block that cannot be read is wrong
                print(f"read-back of slice {sid} block {i}: {e!r}", file=ctx.err)
                got = None
            readback_errors += got != contents.block(cid)
            row = rows.get((sid, i))
            if row is None:
                unhashed += 1
            else:
                digest_errors += row != digest
            canonical = refs.resolve(block_key(sid, i, bs))
            if canonical is None:
                unelided += cid < 0
            else:  # an alias: only ever of the pool block with its content
                verdict_errors += cid >= 0 or canonical != block_key(POOL_SID, -cid - 1, bs)
    finally:
        cold.close()
    # a block passed through has no index row and, if a duplicate, no
    # alias: no more of either than the stage counted
    digest_errors += max(0, unhashed - passed)
    verdict_errors += max(0, unelided - passed)
    failed = sum(w.failed for w in st["ws"])
    passthrough_pct = 100.0 * passed / written
    return [("elide_errors", elide_errors, 0), ("readback_errors", readback_errors, 0),
            ("passthrough_pct", passthrough_pct, PASSTHROUGH_LIMIT_PCT),
            ("digest_errors", digest_errors, 0), ("verdict_errors", verdict_errors, 0),
            ("failed_commits", failed, 0)]


def close(st) -> None:
    st["store"].close()
    close_meta(st["meta"])
