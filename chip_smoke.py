#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (juicefs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--volume-gib G]

Phases, in order; any mismatch raises and the script exits non-zero:

  1. device   require CUDA; print the card's name and power limit; load
              liblz4 (the ingest phase compresses with it)
  2. build    compile the row-chain kernel from the repo's sources (sm_90a)
  3. kernel   row_chain (CUDA) == row_chain_ref (plain torch) bit for bit,
              on the main path's batch shapes and on ragged lane counts
  4. digests  verify_backend() on the card == numpy spec; scan_step on a
              packed batch == numpy spec + dedup_digests
  5. scan     the main path: `gc --dedup` scan (cmd/gc.py dedup_scan, cuda
              backend) over a 1 GiB file:// volume of 4 MiB blocks with a
              ragged tail and ~25% planted duplicates; gates: every block
              hashed, sampled rows == numpy spec, duplicates == planted
  6. timing   row_chain on a resident 1 GiB batch (16384 lanes), CUDA
              events, median of 10 with the tweak varied per run, beside
              the plain version and the memory/ALU bound
  7. batch    one main-path batch (32 x 4 MiB) split into host packing,
              upload, kernel and torch fold time
  8. ingest   the write leg of the main path: 256 x 4 MiB blocks (1 GiB)
              plus a 1 MiB + 7 B tail, ~25% from a 4-block duplicate pool,
              each its own slice, written through the port's CachedStore
              (lz4, cuda compress estimator) with an inline-dedup
              IngestPipeline on the cuda backend; gates: elided == planted
              duplicates with zero passthrough/errors, one stored object per
              unique block, every hashed block estimated with no compress
              degrade, one upload per hash batch, cold read-back byte for
              byte, then a cold `gc --dedup` scan that reproduces the
              ingest-time digests; the estimator on the card == the same
              torch ops on the CPU (histograms exact, predictions 1e-5).
              The ingest gates also hold the kernel to one launch per hash
              batch. A second drive of the same leg has 4 writers of 8-block
              slices, so hash batches hold many blocks

It prints a `{"kernels": [...]}` line and, as its last line,
`{"ok": true, "device": {...}}`. It imports nothing of JAX or juicefs_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from juicefs_tpu_torch import native
from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig, ContentRefs, IngestPipeline
from juicefs_tpu_torch.chunk.cached_store import block_key
from juicefs_tpu_torch.cmd.gc import dedup_scan
from juicefs_tpu_torch.compress import new_compressor
from juicefs_tpu_torch.gpu import compress_batch, hash_torch, kernels
from juicefs_tpu_torch.gpu.dedup import dedup_digests, scan_step
from juicefs_tpu_torch.gpu.jth256 import (
    BLOCK_BYTES,
    COLS,
    LANE_BYTES,
    ROWS,
    hash_packed_np,
    jth256,
    pack_blocks,
    pack_into,
)
from juicefs_tpu_torch.gpu.pipeline import HashPipeline, PipelineConfig
from juicefs_tpu_torch.metric import global_registry
from juicefs_tpu_torch.metric.trace import stage_metrics_snapshot
from juicefs_tpu_torch.object.file import FileStorage

MASK = 0xFFFFFFFF
TIMING_LANES = 16384  # 1 GiB of words
# Integer ALU rate for the operations bound: Hopper runs 64 INT32
# operations per SM per clock, half its FP32 lanes, so the H100 SXM's
# 67 TFLOP/s FP32 (an FMA counts 2) gives 67e12 / 4 integer ops per second.
INT32_OPS_PER_S = 67e12 / 4
OPS_PER_WORD = 9  # xor tweak, xor, mul, shl, shr, or, mul, shr, xor


def hbm_bytes_per_s(name: str) -> float:
    """Published device-memory rate for the card nvidia-smi names."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM (HBM3)


class DictMeta:
    """Stand-in for the meta engine that a later slice ports: the digest
    index, the content-ref plane and the hot-fingerprint snapshot, in dicts
    under one lock, with the semantics of the JAX package's kv engine
    (meta/kv.py content_* and *_block_digests).

    refs:    digest -> [sid, indx, bsize, refcount]  (canonical block)
    aliases: (sid, indx) -> (digest, bsize, created_ts)
    rows:    (sid, indx) -> (bsize, digest)          (digest index)
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.refs: dict[bytes, list] = {}
        self.aliases: dict[tuple[int, int], tuple[bytes, int, float]] = {}
        self.rows: dict[tuple[int, int], tuple[int, bytes]] = {}
        self.hot: list[tuple[bytes, bytes]] = []

    # -- digest index ------------------------------------------------------
    def scan_block_digests(self):
        with self._lock:
            return [(sid, indx, bsize, d)
                    for (sid, indx), (bsize, d) in self.rows.items()]

    def set_block_digests(self, rows):
        with self._lock:
            for sid, indx, bsize, d in rows:
                self.rows[(sid, indx)] = (bsize, d)

    def delete_block_digests(self, pairs):
        with self._lock:
            for sid, indx in pairs:
                self.rows.pop((sid, indx), None)

    # -- content-ref plane -------------------------------------------------
    def _add_ref(self, digest, sid, indx, bsize):
        ref = self.refs[digest]
        ref[3] += 1
        self.aliases[(sid, indx)] = (digest, bsize, time.time())
        return tuple(ref[:3])

    def content_incref(self, entries):
        with self._lock:
            return [self._add_ref(d, sid, indx, bsize) if d in self.refs else None
                    for d, sid, indx, bsize in entries]

    def content_register(self, entries):
        out = []
        with self._lock:
            for d, sid, indx, bsize in entries:
                if d in self.refs:
                    out.append(self._add_ref(d, sid, indx, bsize))
                else:
                    self.refs[d] = [sid, indx, bsize, 1]
                    self.aliases[(sid, indx)] = (d, bsize, time.time())
                    out.append(None)
        return out

    def content_decref(self, pairs):
        out = []
        with self._lock:
            for sid, indx in pairs:
                alias = self.aliases.pop((sid, indx), None)
                if alias is None:
                    out.append(("untracked", None))
                    continue
                ref = self.refs.get(alias[0])
                if ref is None:
                    out.append(("dangling", None))
                elif ref[3] <= 1:
                    del self.refs[alias[0]]
                    out.append(("last", tuple(ref[:3])))
                else:
                    ref[3] -= 1
                    out.append(("released", tuple(ref[:3])))
        return out

    def content_resolve(self, sid, indx):
        with self._lock:
            alias = self.aliases.get((sid, indx))
            ref = self.refs.get(alias[0]) if alias is not None else None
            return tuple(ref[:3]) if ref is not None else None

    def scan_content_refs(self):
        with self._lock:
            return [(d, tuple(r[:3]), r[3]) for d, r in self.refs.items()]

    def scan_content_aliases(self):
        with self._lock:
            return [(k, d, bsize, ts) for k, (d, bsize, ts) in self.aliases.items()]

    # -- hot-content fingerprint snapshot ----------------------------------
    def set_hot_fingerprints(self, rows):
        with self._lock:
            self.hot = list(rows)

    def load_hot_fingerprints(self):
        with self._lock:
            return list(self.hot)


class FileBlockStore:
    """Stand-in for CachedStore's bulk read path: GET the block object."""

    def __init__(self, storage: FileStorage, threads: int):
        self.storage = storage
        self._bulk_pool = ThreadPoolExecutor(threads, thread_name_prefix="smoke-get")

    def _load_block(self, key: str, bsize: int, cache_after: bool = True) -> bytes:
        data = self.storage.get(key)
        if len(data) != bsize:
            raise IOError(f"{key}: {len(data)} bytes, want {bsize}")
        return data

    def close(self):
        self._bulk_pool.shutdown(wait=True)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def device_phase() -> tuple[str, str]:
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    # the ingest phase compresses with the system liblz4; without it the
    # run stops here (switching to no compression would also switch the
    # compress estimator off)
    lz4 = new_compressor("lz4")
    probe = b"chip smoke " * 100
    if lz4.decompress(lz4.compress(probe), len(probe)) != probe:
        raise AssertionError("liblz4 round trip failed")
    print(f"liblz4 ok; native (host C++ JTH-256) available: {native.available()}")
    return smi, torch.cuda.get_device_name(0)


def build_phase() -> float:
    phase("build")
    t0 = time.perf_counter()
    kernels.load_library("jth256_row_chain")
    dt = time.perf_counter() - t0
    print(f"built jth256_row_chain for sm_90a in {dt:.3f} s "
          f"(nvcc {kernels.BUILD_SECONDS.get('jth256_row_chain', 0.0):.3f} s)")
    return dt


def random_words(gen: torch.Generator, n_lanes: int) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, (n_lanes, ROWS, COLS),
                         dtype=torch.int32, device="cuda", generator=gen)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int(((a.to(torch.int64) & MASK) - (b.to(torch.int64) & MASK)).abs().max())


def kernel_phase(gen: torch.Generator) -> int:
    phase("kernel vs plain")
    worst = 0
    # (lanes, m): the main path's full batch (32 blocks x 64 lanes) and its
    # one-block tail batch, then lane counts that are not multiples of 16
    for n_lanes, m in ((2048, 64), (64, 64), (37, 1), (150, 2), (201, 64)):
        words = random_words(gen, n_lanes)
        for tweak in (0, 0x5BD1E995):
            got = hash_torch.row_chain(words, m, tweak)
            torch.cuda.synchronize()
            if hash_torch.last_kernel_mode() != "cuda":
                raise AssertionError("row_chain on a CUDA tensor did not run the kernel")
            want = hash_torch.row_chain_ref(words, m, tweak)
            err = max_abs_err(got, want)
            print(f"row_chain L={n_lanes} m={m} tweak={tweak:#x}: max_abs_err {err}")
            if err != 0:
                raise AssertionError(f"row_chain != row_chain_ref at L={n_lanes} m={m}")
            worst = max(worst, err)
    return worst


def digests_phase(rng: np.random.Generator) -> None:
    phase("digests vs spec")
    sizes = hash_torch.VERIFY_SIZES + (BLOCK_BYTES,)
    if not hash_torch.verify_backend(sizes=sizes):
        raise AssertionError("verify_backend: card digests != numpy spec")
    print(f"verify_backend ok at sizes {list(sizes)}")
    uniq = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            for n in (100, LANE_BYTES + 7, BLOCK_BYTES)]
    blocks = [uniq[0], uniq[1], uniq[0], uniq[2], uniq[1], uniq[2], b""]
    words, counts, lengths = pack_blocks(blocks)
    digests, dup, first = scan_step(words, counts, lengths)
    if not np.array_equal(digests, hash_packed_np(words, counts, lengths)):
        raise AssertionError("scan_step digests != numpy spec")
    hdup, hfirst = dedup_digests([jth256(b) for b in blocks])
    if not (np.array_equal(dup, hdup) and np.array_equal(first, hfirst)):
        raise AssertionError(f"scan_step verdicts {dup} {first} != {hdup} {hfirst}")
    print(f"scan_step ok: dup {dup.tolist()} first {first.tolist()}")


def plan_blocks(rng: np.random.Generator, n_full: int, bs: int, tail: int,
                dup_ratio: float = 0.25):
    """n_full blocks of bs bytes, ~dup_ratio of them drawn from a 4-block
    pool, plus one ragged tail block of `tail` bytes. The expected
    duplicate count comes from the plan (pool entries are reused bytes
    objects), as in __graft_entry__.py."""
    pool = [rng.bytes(bs) for _ in range(4)]
    blocks = [pool[int(rng.integers(0, len(pool)))] if rng.random() < dup_ratio
              else rng.bytes(bs) for _ in range(n_full)]
    blocks.append(rng.bytes(tail))
    seen: set[int] = set()
    expect_dups = 0
    for b in blocks:
        expect_dups += id(b) in seen
        seen.add(id(b))
    return blocks, expect_dups


def write_volume(root: str, rng: np.random.Generator, n_full: int, bs: int):
    """Write the planned blocks (ragged tail of 3 lanes + 777 B) under
    block_key names. Returns (storage, live, keys in write order, planted
    duplicate count)."""
    storage = FileStorage(root)
    storage.create()
    blocks, dups = plan_blocks(rng, n_full, bs, 3 * LANE_BYTES + 777)
    live: dict[str, int] = {}
    order: list[str] = []
    for i, data in enumerate(blocks):
        key = block_key(1000 + i, 0, len(data))
        storage.put(key, data)
        live[key] = len(data)
        order.append(key)
    return storage, live, order, dups


def scan_phase(rng: np.random.Generator, volume_gib: float) -> dict:
    phase("main path: gc --dedup scan")
    bs = BLOCK_BYTES
    n_full = max(1, int(volume_gib * (1 << 30)) // bs)
    base = tempfile.mkdtemp(prefix="jfs-torch-smoke-")
    store = None
    try:
        t0 = time.perf_counter()
        storage, live, order, planted = write_volume(
            os.path.join(base, "blob"), rng, n_full, bs)
        print(f"wrote {len(live)} blocks ({sum(live.values()) / (1 << 30):.4f} GiB, "
              f"{planted} planted duplicates) in {time.perf_counter() - t0:.3f} s")
        meta = DictMeta()
        store = FileBlockStore(storage, threads=16)
        kernels.reset_launches()
        scan = dedup_scan(meta, store, live, "cuda", "", bs, threads=16,
                          batch_blocks=32)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        print("scan " + json.dumps(scan))
        print(f"scan launches {launches}")
        if launches["jth256_row_chain"] == 0:
            raise AssertionError("main path launched no jth256_row_chain kernel")
        if scan["hashed_now"] != len(live):
            raise AssertionError(f"hashed_now {scan['hashed_now']} != {len(live)} blocks")
        rows = {block_key(sid, indx, bsize): d
                for sid, indx, bsize, d in meta.scan_block_digests()}
        for key in order[:: max(1, len(order) // 8)] + [order[-1]]:
            if rows[key] != jth256(storage.get(key)):
                raise AssertionError(f"{key}: digest row != numpy spec")
        if scan["duplicate_blocks"] != planted:
            raise AssertionError(
                f"duplicate_blocks {scan['duplicate_blocks']} != planted {planted}")
        print(f"gates ok: {len(live)} blocks hashed, sampled rows == spec, "
              f"{planted} duplicates found; scan {scan['gibs']} GiB/s, "
              f"stage_seconds {json.dumps(scan['stage_seconds'])}")
        scan["launches"] = launches
        return scan
    finally:
        if store is not None:
            store.close()
        shutil.rmtree(base, ignore_errors=True)


def time_cuda(fn, runs: int) -> float:
    """Median milliseconds of fn(i) over `runs` runs, by CUDA events."""
    times = []
    for i in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timing_phase(gen: torch.Generator, smi: str) -> dict:
    phase("kernel time")
    m = BLOCK_BYTES // LANE_BYTES
    words = random_words(gen, TIMING_LANES)
    hash_torch.row_chain(words, m, 1)  # warm-up
    torch.cuda.synchronize()
    ms = time_cuda(lambda i: hash_torch.row_chain(words, m, 0x1000 + i), 10)
    hash_torch.row_chain_ref(words, m, 1)  # warm-up
    plain_ms = time_cuda(lambda i: hash_torch.row_chain_ref(words, m, 0x2000 + i), 3)
    in_bytes = TIMING_LANES * LANE_BYTES
    out_bytes = TIMING_LANES * COLS * 4
    rate = hbm_bytes_per_s(smi)
    bytes_ms = (in_bytes + out_bytes) / rate * 1e3
    ops_ms = in_bytes // 4 * OPS_PER_WORD / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    out = {
        "lanes": TIMING_LANES,
        "ms": ms,
        "gibs": in_bytes / (1 << 30) / (ms / 1e3),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "hbm_bytes_per_s": rate,
    }
    print(f"row_chain 1 GiB ({TIMING_LANES} lanes): {ms:.4f} ms = "
          f"{out['gibs']:.2f} GiB/s; plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms ({out['bound_by']}, {rate / 1e12} TB/s) "
          f"= {bound_ms / ms:.3f} of bound; card {smi}")
    return out


def batch_breakdown_phase(rng: np.random.Generator) -> dict:
    """Where one main-path hash batch (32 x 4 MiB blocks) spends its time:
    host packing into the pinned slot, the upload, the row-chain kernel and
    the torch fold ops, each timed alone (median of 5)."""
    phase("batch breakdown")
    n, m = 32, BLOCK_BYTES // LANE_BYTES
    blocks = [rng.bytes(BLOCK_BYTES) for _ in range(n)]
    host = torch.empty((n, m, ROWS, COLS), dtype=torch.int32, pin_memory=True)
    counts = lengths = None

    def pack(_i):
        nonlocal counts, lengths
        counts, lengths = pack_into(host.numpy(), blocks)

    pack_ms = []
    for i in range(5):
        t0 = time.perf_counter()
        pack(i)
        pack_ms.append((time.perf_counter() - t0) * 1e3)
    dev = host.to("cuda", non_blocking=True)
    h2d_ms = time_cuda(lambda i: dev.copy_(host, non_blocking=True), 5)
    flat = dev.reshape(n * m, ROWS, COLS)
    hash_torch.row_chain(flat, m, 0)
    kernel_ms = time_cuda(lambda i: hash_torch.row_chain(flat, m, i), 5)
    states = hash_torch.row_chain(flat, m, 0).reshape(n, m, COLS)
    dcounts = torch.from_numpy(counts.astype(np.int64)).cuda()
    dlengths = torch.from_numpy(lengths.astype(np.int64)).cuda()
    fold = lambda i: hash_torch.combine_accs(hash_torch.lane_accs(states), dcounts, dlengths)
    fold(0)
    fold_ms = time_cuda(fold, 5)
    t0 = time.perf_counter()
    fold(0)
    enqueue_ms = (time.perf_counter() - t0) * 1e3  # host time to queue the fold
    torch.cuda.synchronize()
    out = {"blocks": n, "pack_ms": statistics.median(pack_ms), "h2d_ms": h2d_ms,
           "kernel_ms": kernel_ms, "fold_ms": fold_ms, "fold_enqueue_ms": enqueue_ms}
    print("batch_breakdown " + json.dumps(out))
    return out


INGEST_STAGES = ("chunk.ingest.pack", "chunk.ingest.hash", "chunk.ingest.lookup",
                 "chunk.ingest.register", "chunk.upload.compress", "chunk.upload.put")


def counter_value(name: str) -> float:
    return global_registry()._metrics[name].value


def stage_delta(before: dict, after: dict) -> dict:
    """{stage: {count, seconds}} moved between two stage snapshots."""
    out = {}
    for name in INGEST_STAGES:
        a = after.get(name, {"count": 0, "sum_seconds": 0.0})
        b = before.get(name, {"count": 0, "sum_seconds": 0.0})
        out[name] = {"count": a["count"] - b["count"],
                     "seconds": a["sum_seconds"] - b["sum_seconds"]}
    return out


def drive_ingest(root: str, blocks: list, expect_dups: int, slice_blocks: int,
                 writers: int) -> dict:
    """Write the planned blocks through the port's CachedStore with an
    inline-dedup IngestPipeline on the card, `slice_blocks` consecutive
    blocks to a slice, `writers` slices in flight at once, then check
    gates 1-4: elided == planted duplicates with no degrade and one hash
    kernel launch per hash batch; one stored object per unique block; every
    hashed block estimated with no compress degrade; one upload per hash
    batch. Returns the open store, its meta and the run's numbers; the
    caller closes the store."""
    bs = BLOCK_BYTES
    slices = [(1 + k, blocks[i:i + slice_blocks])
              for k, i in enumerate(range(0, len(blocks), slice_blocks))]
    nbytes = sum(len(b) for b in blocks)
    storage = FileStorage(root)
    storage.create()
    meta = DictMeta()
    refs = ContentRefs(meta)
    store = CachedStore(storage, ChunkConfig(
        block_size=bs, compress="lz4", compress_backend="cuda",
        cache_dirs=("memory",), cache_size=1, max_upload=8))
    try:
        store.content_refs = refs
        store.ingest = IngestPipeline(store, refs, backend="cuda", batch_blocks=32,
                                      bypass=False)

        def write(item):
            sid, chunk = item
            w = store.new_writer(sid)
            w.write_at(b"".join(chunk), 0)
            w.finish(sum(len(b) for b in chunk))

        hashed0 = counter_value("juicefs_torch_blocks_hashed")
        h2d0 = counter_value("juicefs_torch_h2d_bytes")
        stages0 = stage_metrics_snapshot()
        kernels.reset_launches()
        t0 = time.perf_counter()
        if writers == 1:
            for item in slices:
                write(item)
        else:
            with ThreadPoolExecutor(writers, thread_name_prefix="smoke-writer") as ex:
                list(ex.map(write, slices))
        store.ingest.flush()
        store.flush_all()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        stages = stage_delta(stages0, stage_metrics_snapshot())
        hashed = int(counter_value("juicefs_torch_blocks_hashed") - hashed0)
        h2d = int(counter_value("juicefs_torch_h2d_bytes") - h2d0)
        st = store.ingest.stats()
        comp = st["compress"]
        n_blocks = len(blocks)
        n_batches = stages["chunk.ingest.hash"]["count"]
        gibs = nbytes / (1 << 30) / seconds
        print(f"ingest {n_blocks} blocks ({nbytes / (1 << 30):.4f} GiB, {expect_dups} "
              f"planted duplicates; {len(slices)} slices of {slice_blocks} blocks, "
              f"{writers} writers) in {seconds:.3f} s = {gibs:.4f} GiB/s")
        print("ingest_stats " + json.dumps(st))
        print("ingest_stage_seconds " + json.dumps(stages))
        print(f"ingest launches {launches}; blocks hashed {hashed} in {n_batches} "
              f"hash batches ({hashed / max(1, n_batches):.3f} blocks per batch); "
              f"h2d bytes {h2d}; native available {native.available()}")

        # gate 1: elision count, no degrade, the kernel launched once per batch
        if st["put_elided"] != expect_dups:
            raise AssertionError(f"put_elided {st['put_elided']} != planted {expect_dups}")
        if st["uploaded"] != n_blocks - expect_dups:
            raise AssertionError(f"uploaded {st['uploaded']} != {n_blocks - expect_dups}")
        for k in ("passthrough", "errors", "race_collapsed"):
            if st[k] != 0:
                raise AssertionError(f"ingest {k} = {st[k]}, want 0")
        if n_batches == 0 or launches["jth256_row_chain"] != n_batches:
            raise AssertionError(f"{launches['jth256_row_chain']} jth256_row_chain launches "
                                 f"for {n_batches} ingest hash batches")
        # gate 2: one stored object per unique block
        n_objects = sum(1 for _ in storage.list_all("chunks/"))
        if n_objects != n_blocks - expect_dups:
            raise AssertionError(f"{n_objects} objects stored, want {n_blocks - expect_dups}")
        # gate 3: every hashed block estimated on the card, no degrade
        if comp["degraded"] != 0 or comp["estimated"] != hashed:
            raise AssertionError(f"compress plane {comp}: want degraded 0, "
                                 f"estimated == {hashed} hashed blocks")
        # gate 4: one upload per hash batch (each block padded to 64 lanes)
        pad = bs // LANE_BYTES * LANE_BYTES
        if h2d != hashed * pad:
            raise AssertionError(f"h2d bytes {h2d} != {hashed} hashed blocks x {pad}")
        return {"store": store, "storage": storage, "meta": meta, "refs": refs,
                "slices": slices, "blocks": n_blocks, "bytes": nbytes,
                "seconds": seconds, "gibs": gibs, "stats": st, "stage_seconds": stages,
                "launches": launches, "blocks_hashed": hashed, "hash_batches": n_batches,
                "h2d_bytes": h2d, "objects": n_objects}
    except BaseException:
        store.close()
        raise


def ingest_phase(rng: np.random.Generator, volume_gib: float) -> dict:
    phase("main path: inline ingest, read-back, cold scan")
    bs = BLOCK_BYTES
    blocks, expect_dups = plan_blocks(rng, max(1, int(volume_gib * (1 << 30)) // bs), bs,
                                      (1 << 20) + 7)
    n_blocks = len(blocks)
    base = tempfile.mkdtemp(prefix="jfs-torch-ingest-")
    run = cold = None
    try:
        # one sequential writer, each block its own slice: every finish()
        # waits for its block, so each hash batch holds one block
        run = drive_ingest(os.path.join(base, "blob"), blocks, expect_dups,
                           slice_blocks=1, writers=1)
        storage, meta, refs = run["storage"], run["meta"], run["refs"]
        ingest_rows = {block_key(sid, indx, bsize): d
                       for sid, indx, bsize, d in meta.scan_block_digests()}

        # gate 5: cold read-back, elided blocks through their aliases
        cold = CachedStore(storage, ChunkConfig(
            block_size=bs, compress="lz4", cache_dirs=("memory",), cache_size=1,
            max_download=16))
        cold.content_refs = refs
        t1 = time.perf_counter()
        for i, data in enumerate(blocks):
            got = cold.new_reader(1 + i, len(data)).read(0, len(data))
            if bytes(got) != data:
                raise AssertionError(f"slice {1 + i}: read-back differs")
        readback_s = time.perf_counter() - t1
        print(f"cold read-back of {n_blocks} slices ok in {readback_s:.3f} s")

        # gate 6: cold gc --dedup scan reproduces the ingest-time digests
        live = {block_key(1 + i, 0, len(b)): len(b) for i, b in enumerate(blocks)}
        meta.delete_block_digests([(sid, indx) for sid, indx, _b, _d
                                   in meta.scan_block_digests()])
        kernels.reset_launches()
        scan = dedup_scan(meta, cold, live, "cuda", "", bs, threads=16)
        torch.cuda.synchronize()
        scan_launches = dict(kernels.LAUNCHES)
        scan_rows = {block_key(sid, indx, bsize): d
                     for sid, indx, bsize, d in meta.scan_block_digests()}
        if scan["hashed_now"] != n_blocks:
            raise AssertionError(f"cold scan hashed_now {scan['hashed_now']} != {n_blocks}")
        if scan_rows != ingest_rows:
            raise AssertionError("cold-scan digests diverge from ingest-time digests")
        for i in list(range(0, n_blocks, max(1, n_blocks // 8))) + [n_blocks - 1]:
            if scan_rows[block_key(1 + i, 0, len(blocks[i]))] != jth256(blocks[i]):
                raise AssertionError(f"block {i}: digest row != numpy spec")
        if scan["duplicate_blocks"] != expect_dups:
            raise AssertionError(f"duplicate_blocks {scan['duplicate_blocks']} != {expect_dups}")
        if scan_launches["jth256_row_chain"] == 0:
            raise AssertionError("cold scan launched no jth256_row_chain kernel")
        print(f"gates ok: {expect_dups} elided, {run['objects']} objects, "
              f"{run['blocks_hashed']} blocks estimated, one upload and one kernel launch "
              f"per batch, read-back exact, cold scan {scan['gibs']} GiB/s reproduces "
              f"{len(scan_rows)} ingest rows; scan launches {scan_launches}")
        run.update(readback_s=readback_s, cold_scan=scan, cold_scan_launches=scan_launches)
        return run
    finally:
        for s in (run["store"] if run else None, cold):
            if s is not None:
                s.close()
        shutil.rmtree(base, ignore_errors=True)


def concurrent_ingest_phase(rng: np.random.Generator, volume_gib: float) -> dict:
    """The same write leg with 4 writers of 8-block (32 MiB) slices: blocks
    of a slice reach the hash batcher back to back, so hash batches hold
    many blocks and the shared pack and the estimator run on multi-block
    batches. Gates 1-4, and some batch must hold more than one block."""
    phase("main path: inline ingest, concurrent writers")
    bs = BLOCK_BYTES
    blocks, expect_dups = plan_blocks(rng, max(1, int(volume_gib * (1 << 30)) // bs), bs,
                                      (1 << 20) + 7)
    base = tempfile.mkdtemp(prefix="jfs-torch-ingest-conc-")
    run = None
    try:
        run = drive_ingest(os.path.join(base, "blob"), blocks, expect_dups,
                           slice_blocks=8, writers=4)
        if run["blocks_hashed"] <= run["hash_batches"]:
            raise AssertionError(f"{run['blocks_hashed']} blocks in {run['hash_batches']} "
                                 "batches: no hash batch held more than one block")
        print(f"gates ok: {expect_dups} elided, {run['objects']} objects, "
              f"{run['blocks_hashed']} blocks in {run['hash_batches']} batches, each "
              "estimated and uploaded once, one kernel launch per batch")
        return run
    finally:
        if run is not None:
            run["store"].close()
        shutil.rmtree(base, ignore_errors=True)


def estimator_phase(rng: np.random.Generator) -> dict:
    """Gate 7: the compress estimator on one packed main-path batch
    (32 x 4 MiB) on the card == the same torch ops on the CPU; an all-zero
    and a text block predict below 0.5, random blocks above 0.95. Times the
    estimator and the shared pack's (pageable) upload per batch."""
    phase("compress estimator vs plain")
    n = 32
    text = b"hello world "
    blocks = [bytes(BLOCK_BYTES), (text * (BLOCK_BYTES // len(text) + 1))[:BLOCK_BYTES],
              rng.bytes((1 << 20) + 7)] + [rng.bytes(BLOCK_BYTES) for _ in range(n - 3)]
    packed = pack_blocks(blocks, pad_lanes=BLOCK_BYTES // LANE_BYTES)
    pipe = HashPipeline(PipelineConfig(backend="cuda", batch_blocks=n))
    upload_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        words, counts, _lengths = pipe.shard_packed(packed)
        torch.cuda.synchronize()
        upload_ms.append((time.perf_counter() - t0) * 1e3)
    hist = compress_batch.byte_histogram(words, counts)
    pred = compress_batch.estimate(words, counts)
    torch.cuda.synchronize()
    cwords = torch.from_numpy(packed[0].view(np.int32))
    ccounts = torch.from_numpy(packed[1].astype(np.int64))
    chist = compress_batch.byte_histogram(cwords, ccounts)
    cpred = compress_batch.estimate(cwords, ccounts)
    if not torch.equal(hist.cpu(), chist):
        raise AssertionError("estimator histograms on the card != CPU")
    err = float((pred.cpu() - cpred).abs().max())
    if err > 1e-5:
        raise AssertionError(f"estimator predictions differ by {err} > 1e-5")
    p = pred.cpu().tolist()
    if not (p[0] < 0.5 and p[1] < 0.5 and min(p[2:]) > 0.95):
        raise AssertionError(f"estimator predictions out of range: zero {p[0]}, "
                             f"text {p[1]}, random min {min(p[2:])}")
    compress_batch.estimate(words, counts)  # warm-up
    ms = time_cuda(lambda i: compress_batch.estimate(words, counts), 10)
    t0 = time.perf_counter()
    compress_batch.estimate(words, counts)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    out = {"blocks": n, "estimate_ms": ms, "estimate_enqueue_ms": enqueue_ms,
           "upload_ms": statistics.median(upload_ms), "max_abs_err": err,
           "zero": p[0], "text": p[1], "random_min": min(p[2:])}
    print("estimator " + json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--volume-gib", type=float, default=1.0)
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    smi, kind = device_phase()
    build_phase()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    err = kernel_phase(gen)
    digests_phase(rng)
    scan = scan_phase(rng, args.volume_gib)
    timing = timing_phase(gen, smi)
    batch_breakdown_phase(rng)
    ingest = ingest_phase(rng, args.volume_gib)
    conc = concurrent_ingest_phase(rng, args.volume_gib)
    estimator_phase(rng)
    by_path = {"scan": scan["launches"]["jth256_row_chain"],
               "ingest": ingest["launches"]["jth256_row_chain"],
               "ingest_cold_scan": ingest["cold_scan_launches"]["jth256_row_chain"],
               "ingest_concurrent": conc["launches"]["jth256_row_chain"]}
    print(f"launches of jth256_row_chain: {by_path} ({args.volume_gib} GiB each: scan, "
          "ingest, its cold scan, concurrent ingest)")
    print(f"card {smi}: ingest {ingest['gibs']:.4f} GiB/s (1 writer), "
          f"{conc['gibs']:.4f} GiB/s (4 writers); scan {scan['gibs']} GiB/s")
    print(f"total {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": [{
        "name": "jth256_row_chain",
        "route": "cuda",
        "source": "juicefs_tpu_torch/gpu/kernels/jth256_row_chain.cu",
        "replaces": "juicefs_tpu/tpu/hash_jax.py:174",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
