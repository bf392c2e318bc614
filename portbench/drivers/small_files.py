"""One writer of small files through the port's VFS on an inline-dedup
volume: `juicefs bench`'s small-file phase, again and again.

The volume is the configuration's mount (`open_volume`), with the port's
VFS over it as its SDK builds one. Each file is one write of
`small_file_kib` into a new file of one directory: `create`, `write`,
`flush` and `release` in turn, the open, write and close(2) of a FUSE
mount, so a file's close is its commit barrier: the flush waits for the
file's one block (hash, lookup, elision or lz4 + PUT) and writes its
slice into meta. A file is committed when `release` returns, and its
latency runs from `create` to then. What each file holds follows the
plan of `reference/small_files.py`: one file in every `dup_every` is a
copy of one of `dup_pool` pool files, written at set-up and kept, so its
block must be elided. Files are written in rounds of `small_file_count`;
after each round has committed, the round before it is unlinked through
the VFS, so at most two rounds are live.

Set-up writes the pool files and one round of `warm_files`, which loads
the kernels at the shape the window uses. In the window the writer starts
new files until the time is up. `write_gibs` is the bytes committed over
the window's seconds, `small_files_s` the files committed a second
(bench's own number), `write_p95_ms` the 95th percentile of the files'
latencies; `write_card_ms_per_gib` and `write_kernel_ms_per_gib` divide
the card's busy and kernel time in the window by the bytes committed. The
window record also carries the window's deltas of the port's counters
`juicefs_torch_h2d_bytes` and `juicefs_torch_hash_bytes`.

`check` holds the ingest stage's counts to the plan (every block elided,
uploaded or passed through, no unique block elided, no error or race), the
share passed through to its limit, every live file's length and slices in
meta (one slice of the file's size), and a seeded sample of the live files
to the reference: each read back byte for byte through a cold
`CachedStore` by the slices meta gives, its index row against the frozen
reference's digest, and its content-ref verdict (alias of its pool file's
block, or none) against the plan's.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

from .. import data
from ..devtrace import span
from ..reference import jth256 as ref
from ..reference import small_files as plan
from ..stats import p95
from ..volume import close_meta, open_volume

SAMPLE = 128  # live files read back and compared with the reference
DIR = b"bench-small"
# the most blocks, in % of those written, that the ingest stage may pass
# through unhashed under overload: as the other ingest cells
PASSTHROUGH_LIMIT_PCT = 1.0


def _counter(name: str) -> float:
    from juicefs_tpu_torch.metric import global_registry

    m = global_registry()._metrics.get(name)
    return m.value if m is not None else 0


class Writer:
    """The one writer: its plan, its live rounds and what it committed."""

    def __init__(self, st, ctx):
        self.st = st
        self.plan = plan.Plan(ctx.seed, st["dup_every"], st["dup_pool"])
        self.rounds: list[list] = []  # live rounds: [(name, ino, cid)]
        self.round_no = 0
        self.latencies: list[float] = []
        self.bytes = 0
        self.dups = 0
        self.uniques = 0
        self.failed = 0
        self.error = None

    def write_file(self, name: bytes, cid: int) -> tuple[int, float]:
        """Create, write, flush and release one file; returns (inode,
        latency in seconds)."""
        st = self.st
        vfs, vctx, size, piece = st["vfs"], st["ctx"], st["size"], st["write"]
        body = st["content"](cid)
        t0 = time.perf_counter()
        with span("portbench.small.file"):
            err, ino, _attr, fh = vfs.create(vctx, st["dir"], name, 0o644, 0,
                                             os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
            if err:
                raise OSError(err, f"create {name!r}")
            try:
                view = memoryview(body)
                for off in range(0, size, piece):
                    err = vfs.write(vctx, ino, fh, off, view[off:off + piece])
                    if err:
                        raise OSError(err, f"write {name!r}")
                err = vfs.flush(vctx, ino, fh)
                if err:
                    raise OSError(err, f"flush {name!r}")
            finally:
                err = vfs.release(vctx, ino, fh)
            if err:
                raise OSError(err, f"release {name!r}")
        return ino, time.perf_counter() - t0

    def write_round(self, n: int, deadline: float | None = None) -> None:
        """Up to `n` files of a new round (fewer once `deadline` passes),
        then the round before it unlinked."""
        live: list = []
        self.rounds.append(live)
        r = self.round_no
        self.round_no += 1
        for i in range(n):
            if deadline is not None and time.perf_counter() >= deadline:
                break
            cid = self.plan.next()
            name = b"r%d-f%d" % (r, i)
            ino, dt = self.write_file(name, cid)
            live.append((name, ino, cid))
            self.latencies.append(dt)
            self.bytes += self.st["size"]
            self.dups += cid < 0
            self.uniques += cid >= 0
        if len(live) == n and len(self.rounds) > 1:
            old = self.rounds.pop(0)
            vfs, vctx = self.st["vfs"], self.st["ctx"]
            with span("portbench.small.unlink"):
                for name, _ino, _cid in old:
                    err = vfs.unlink(vctx, self.st["dir"], name)
                    if err:
                        raise OSError(err, f"unlink {name!r}")

    def run(self, deadline: float) -> None:
        while time.perf_counter() < deadline:
            try:
                self.write_round(self.st["round_files"], deadline)
            except Exception as e:  # a failed commit is counted and reported
                self.failed += 1
                self.error = repr(e)
                return


def setup(ctx) -> dict:
    from juicefs_tpu_torch.meta.context import Context
    from juicefs_tpu_torch.meta.types import ROOT_INODE
    from juicefs_tpu_torch.vfs import VFS

    cfg, tr = ctx.config, ctx.traffic
    size = cfg["small_file_kib"] * 1024
    bs = cfg["block_size_kib"] * 1024
    if size > bs:
        raise ValueError("small_file_kib must fit one block: each file is one block")
    if tr["writers"] != 1:
        raise ValueError("the small-file driver has one writer, as bench --threads 1")
    meta, fmt, store, _args = open_volume(cfg, ctx.workdir, with_indexer=True)
    meta.new_session()
    vfs = VFS(meta, store, fmt=fmt)
    vctx = Context(uid=0, gid=0, gids=(0,), pid=os.getpid())
    err, dir_ino, _attr = vfs.mkdir(vctx, ROOT_INODE, DIR, 0o755)
    if err:
        raise OSError(err, "mkdir")
    pool, stride = tr["dup_pool"], tr["stride_bytes"]
    # a pool copy is the same bytes object each time, as bench writes one
    # buffer again and again
    pool_bytes = [plan.content(ctx.buffer, -(j + 1), size, pool, stride)
                  for j in range(pool)]

    def content(cid: int) -> bytes:
        if cid < 0:
            return pool_bytes[-cid - 1]
        return plan.content(ctx.buffer, cid, size, pool, stride)

    st = {"meta": meta, "fmt": fmt, "store": store, "vfs": vfs, "ctx": vctx,
          "dir": dir_ino, "size": size, "write": min(size, tr["write_kib"] * 1024),
          "round_files": cfg["small_file_count"], "dup_every": tr["dup_every"],
          "dup_pool": pool, "content": content, "pool_inos": []}
    # the pool, written once and kept: every later copy duplicates live content
    w = Writer(st, ctx)
    for j in range(pool):
        ino, _dt = w.write_file(b"pool-%d" % j, -(j + 1))
        st["pool_inos"].append(ino)
    w.write_round(tr["warm_files"])  # warm-up: the kernels at the window's shape
    store.ingest.flush()
    st["w"] = w
    return st


def window(st, ctx, trace) -> dict:
    w = st["w"]
    n0, b0, f0 = len(w.latencies), w.bytes, w.failed
    h2d0 = _counter("juicefs_torch_h2d_bytes")
    hashed0 = _counter("juicefs_torch_hash_bytes")
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds

    def body():
        try:
            w.run(deadline)
        except BaseException as e:
            w.error = repr(e)

    thread = threading.Thread(target=body, name="portbench-small-writer")
    thread.start()
    if trace.enabled:
        # the traced sub-window: the middle half of the window, started and
        # stopped from this thread while the writer runs
        time.sleep(max(0.0, t0 + ctx.seconds / 4 - time.perf_counter()))
        trace.start()
        time.sleep(max(0.0, t0 + 3 * ctx.seconds / 4 - time.perf_counter()))
        trace.stop()
    thread.join()
    elapsed = time.perf_counter() - t0
    lat = w.latencies[n0:]
    nbytes = w.bytes - b0
    failed = w.failed - f0
    if w.error:
        print(f"writer failed: {w.error}", file=ctx.err)
    metrics = {"write_gibs": {"value": nbytes / (1 << 30) / elapsed, "unit": "GiB/s"},
               "small_files_s": {"value": len(lat) / elapsed, "unit": "files/s"}}
    if lat:
        metrics["write_p95_ms"] = {"value": p95(lat) * 1e3, "unit": "ms"}
    card = {"write_card_ms_per_gib": ("busy", nbytes),
            "write_kernel_ms_per_gib": ("kernels", nbytes)}
    return {"metrics": metrics, "card_work": card,
            "attempted": len(lat) + failed, "failed": failed,
            "window_s": elapsed, "files": len(lat), "bytes": nbytes,
            "h2d_bytes": int(_counter("juicefs_torch_h2d_bytes") - h2d0),
            "hash_bytes": int(_counter("juicefs_torch_hash_bytes") - hashed0)}


def check(st, ctx) -> list[tuple[str, float, float]]:
    from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig
    from juicefs_tpu_torch.chunk.cached_store import block_key
    from juicefs_tpu_torch.chunk.ingest import ContentRefs

    meta, store, w, size = st["meta"], st["store"], st["w"], st["size"]
    vctx, pool = st["ctx"], st["dup_pool"]
    store.flush_all()
    stats = store.ingest.stats()
    print("ingest stats " + json.dumps({k: v for k, v in stats.items()
                                        if not isinstance(v, dict)}), file=ctx.err)
    written = w.dups + w.uniques + pool
    elided, passed = stats["put_elided"], stats["passthrough"]
    elide_errors = (abs(elided + stats["uploaded"] + passed - written)
                    + max(0, elided - w.dups) + max(0, w.dups - passed - elided)
                    + stats["errors"] + stats["race_collapsed"])

    def slices_of(ino: int):
        """(length in meta, slices of chunk 0), or None for a file meta lost."""
        err, attr = meta.getattr(vctx, ino)
        if err:
            return None
        err, slices = meta.read_chunk(ino, 0)
        return None if err else (attr.length, [s for s in slices if s.id])

    def one_slice(got) -> bool:
        return (got is not None and got[0] == size and len(got[1]) == 1
                and got[1][0].pos == 0 and got[1][0].off == 0 and got[1][0].len == size)

    pool_slices = [slices_of(ino) for ino in st["pool_inos"]]
    live = [(ino, cid) for rnd in w.rounds for _name, ino, cid in rnd]
    meta_errors = sum(not one_slice(g) for g in pool_slices)
    found = {}
    for ino, cid in live:
        got = found[ino] = slices_of(ino)
        meta_errors += not one_slice(got)
    want_alias = dict(zip((ino for ino, _c in live),
                          plan.aliases([cid for _i, cid in live], pool)))
    pool_keys = [block_key(g[1][0].id, 0, size) if one_slice(g) else None
                 for g in pool_slices]
    rng = np.random.default_rng(data.seed_key(ctx.seed, 7))
    n = min(len(live), ctx.sample or SAMPLE)
    picked = [live[int(i)] for i in sorted(rng.choice(len(live), n, replace=False))]
    bodies = [st["content"](cid) for _ino, cid in picked]
    want_d = ref.digests(bodies)
    rows = {(sid, indx): d for sid, indx, _b, d in meta.scan_block_digests()}
    cold = CachedStore(store.storage, ChunkConfig(
        block_size=store.conf.block_size, compress=st["fmt"].compression,
        compress_backend="cpu", cache_dirs=("memory",), cache_size=1 << 20, prefetch=0))
    refs = ContentRefs(meta)
    cold.content_refs = refs
    readback_errors = verdict_errors = digest_errors = 0
    unhashed = unelided = 0  # files whose block looks passed through
    try:
        for (ino, cid), body, digest in zip(picked, bodies, want_d):
            got = found[ino]
            if got is None or not got[1]:
                readback_errors += 1
                digest_errors += 1
                verdict_errors += 1
                continue
            buf = bytearray(got[0])
            try:
                for s in got[1]:
                    buf[s.pos:s.pos + s.len] = cold.new_reader(s.id, s.size).read(s.off, s.len)
            except Exception as e:  # a file that cannot be read is wrong
                print(f"read-back of inode {ino}: {e!r}", file=ctx.err)
                buf = None
            readback_errors += buf is None or bytes(buf) != body
            s0 = got[1][0]
            row = rows.get((s0.id, 0))
            if row is None:
                unhashed += 1
            else:
                digest_errors += row != digest
            canonical = refs.resolve(block_key(s0.id, 0, s0.size))
            alias = want_alias[ino]
            if canonical is None:
                unelided += alias is not None
            else:  # an alias: only ever of its own pool file's block
                verdict_errors += alias is None or canonical != pool_keys[alias]
    finally:
        cold.close()
    # a block passed through has no index row and, if a copy, no alias:
    # no more of either than the stage counted
    digest_errors += max(0, unhashed - passed)
    verdict_errors += max(0, unelided - passed)
    passthrough_pct = 100.0 * passed / written
    return [("elide_errors", elide_errors, 0), ("readback_errors", readback_errors, 0),
            ("passthrough_pct", passthrough_pct, PASSTHROUGH_LIMIT_PCT),
            ("digest_errors", digest_errors, 0), ("verdict_errors", verdict_errors, 0),
            ("meta_errors", meta_errors, 0), ("failed_commits", w.failed, 0)]


def close(st) -> None:
    try:
        st["vfs"].close()
    finally:
        st["store"].close()
        st["meta"].close_session()
        close_meta(st["meta"])
