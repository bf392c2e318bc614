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
              ingest-time digests.
              The ingest gates also hold the kernel to one launch per hash
              batch.
  9. ingest   a second drive of the same leg with 4 writers of 8-block
              slices, so hash batches hold many blocks. Phases 5, 8 and 9
              keep their meta in the port's sqlite3:// kv engine
  10. estimator the compress estimator on one packed batch on the card ==
              the same torch ops on the CPU (histograms exact, predictions
              1e-5)
  11. main    the admin path through the port's CLI on a sqlite3:// volume
              of the same plan: `format --hash-backend pallas` (probes the
              card), a write of every block as its own slice through
              `build_store` with its BlockIndexer on the card, `gc --dedup`,
              `fsck --verify-data`; gates: no indexer errors, indexed +
              dropped == written, one launch per index batch; gc trusts the
              index, backfills exactly the dropped blocks, finds the planted
              duplicates and writes an index that matches the numpy spec;
              with every fifth index row deleted, a second gc reads back and
              hashes exactly those blocks (one launch per 32) and restores
              the same index;
              fsck verifies every block in one launch per 32 blocks with 0
              mismatches, then exactly one after one object is overwritten;
              a reopened meta client reads the same digest rows
  12. serve   the port's S3 gateway on a `format --hash-backend pallas
              --compress lz4` sqlite3:// volume, built as the `gateway`
              subcommand builds it (BlockIndexer on the card, SigV4, one
              tenant key): 4 signed clients PUT 32 objects of 32 MiB from
              the same plan (1 GiB), a multipart upload whose part 3
              repeats part 1, a 1 MiB + 7 B object and a copy; gates: every
              PUT 200, ETags == StreamingEtag from the numpy spec, full and
              Range GETs exact, a paginated listing (max-keys 7) == the key
              set, unsigned 403, a lying payload hash 400 with no object
              left, no indexer errors, indexed + dropped == written, one
              launch per index batch. Then the SDK (`jfs_init` on the same
              volume) reads every object back and writes a file as 64
              flushed 1 MiB pieces; `gc --compact --dedup` compacts the
              fragmented chunks, hashes exactly the blocks the index lacks
              (one launch per 32), finds the planted duplicates and writes
              the spec's index; `fsck --verify-data` finds 0 mismatches;
              last, `python -m juicefs_tpu_torch.cmd gateway` runs as a
              process: a signed PUT and GET, /metrics, exit 0 on SIGTERM

It prints a `{"kernels": [...]}` line and, as its last line,
`{"ok": true, "device": {...}}`. It imports nothing of JAX or juicefs_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import http.client
import io
import json
import logging
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.parse
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from juicefs_tpu_torch import cmd, native, sdk
from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig, ContentRefs, IngestPipeline
from juicefs_tpu_torch.chunk.cached_store import block_key, parse_block_key
from juicefs_tpu_torch.cmd import gateway as gateway_cmd
from juicefs_tpu_torch.cmd.gc import dedup_scan
from juicefs_tpu_torch.compress import new_compressor
from juicefs_tpu_torch.gpu import compress_batch, hash_torch, kernels
from juicefs_tpu_torch.gpu.dedup import dedup_digests, scan_step
from juicefs_tpu_torch.gpu.jth256 import (
    BLOCK_BYTES,
    COLS,
    LANE_BYTES,
    ROWS,
    digest_hex,
    hash_blocks_np,
    hash_packed_np,
    jth256,
    pack_blocks,
    pack_into,
)
from juicefs_tpu_torch.gpu.pipeline import HashPipeline, PipelineConfig
from juicefs_tpu_torch.meta import CHUNK_SIZE, Format, Slice, new_client
from juicefs_tpu_torch.meta.context import Context
from juicefs_tpu_torch.meta.slice import build_slice
from juicefs_tpu_torch.metric import global_registry
from juicefs_tpu_torch.metric.trace import stage_metrics_snapshot
from juicefs_tpu_torch.object.file import FileStorage
from juicefs_tpu_torch.object.s3 import SigV4

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


def row_chain_bound_ms(n_lanes: int, smi: str) -> tuple[float, str]:
    """Least time the card could take for row_chain over n_lanes: each
    input word read once and each lane state written once at the memory
    rate, or the integer operations at the ALU rate, whichever is larger."""
    in_bytes, out_bytes = n_lanes * LANE_BYTES, n_lanes * COLS * 4
    bytes_ms = (in_bytes + out_bytes) / hbm_bytes_per_s(smi) * 1e3
    ops_ms = in_bytes // 4 * OPS_PER_WORD / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def open_kv_meta(base: str, name: str):
    """The port's own kv meta engine on a sqlite3:// file under `base`,
    formatted with a fresh volume of `name`."""
    m = new_client(f"sqlite3://{base}/meta.db")
    if m.init(Format(name=name, trash_days=0), force=True) != 0:
        raise AssertionError("meta init failed")
    m.load()
    return m


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
        meta = open_kv_meta(base, "smoke-scan")
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
    rate = hbm_bytes_per_s(smi)
    bound_ms, bound_by = row_chain_bound_ms(TIMING_LANES, smi)
    out = {
        "lanes": TIMING_LANES,
        "ms": ms,
        "gibs": in_bytes / (1 << 30) / (ms / 1e3),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
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


def stage_delta(before: dict, after: dict, names=INGEST_STAGES) -> dict:
    """{stage: {count, seconds}} moved between two stage snapshots."""
    out = {}
    for name in names:
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
    meta = open_kv_meta(os.path.dirname(root), "smoke-ingest")
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
        lk, rg = stages["chunk.ingest.lookup"], stages["chunk.ingest.register"]
        print(f"meta (sqlite3:// kv engine): ingest/lookup {lk['seconds']:.6f} s over "
              f"{lk['count']} calls, ingest/register {rg['seconds']:.6f} s over "
              f"{rg['count']} calls")
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


class _Records(logging.Handler):
    """Collects the messages a logger emits while attached."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def cli(argv: list[str]) -> tuple[int, str, list[str]]:
    """Run one port CLI command as a user would; echo and return its rc,
    stdout and the ERROR records of its loggers. cmd.main logs and returns
    1 on an exception, so every caller checks the rc."""
    buf, rec = io.StringIO(), _Records()
    log = logging.getLogger("cmd")
    log.addHandler(rec)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cmd.main(argv)
    finally:
        log.removeHandler(rec)
    out = buf.getvalue()
    print(f"$ {' '.join(argv[:1] + ['META'] + argv[2:])}\n{out.rstrip()}\n(rc {rc})")
    for msg in rec.messages:
        print(f"  log: {msg}")
    return rc, out, rec.messages


def launches() -> int:
    torch.cuda.synchronize()
    return kernels.LAUNCHES["jth256_row_chain"]


def stage_count(name: str) -> int:
    return stage_metrics_snapshot().get(name, {"count": 0})["count"]


def main_path_phase(rng: np.random.Generator, volume_gib: float, kind: str) -> dict:
    """format -> indexed write through build_store -> gc --dedup -> fsck
    --verify-data, all through the port's CLI and kv engine on a sqlite3://
    volume, then planted bitrot and a cross-open of the meta file."""
    phase("main path: format, indexed write, gc, fsck")
    bs = BLOCK_BYTES
    blocks, planted = plan_blocks(rng, max(1, int(volume_gib * (1 << 30)) // bs), bs,
                                  (1 << 20) + 7)
    n_blocks, nbytes = len(blocks), sum(len(b) for b in blocks)
    base = tempfile.mkdtemp(prefix="jfs-torch-main-")
    meta_url = f"sqlite3://{base}/meta.db"
    store = None
    try:
        # 1. format: a device hash backend probes the card (or fails)
        rc, out, _ = cli(["format", meta_url, "smoke", "--storage", "file", "--bucket",
                          os.path.join(base, "blob"), "--compress", "none",
                          "--hash-backend", "pallas", "--trash-days", "0"])
        if rc != 0 or kind not in out:
            raise AssertionError(f"format rc {rc}; probe line must name {kind}")

        # 2. indexed write: one file, each block its own slice
        m, fmt = cmd.open_meta(meta_url)
        store = cmd.build_store(fmt, None, meta=m)
        if store.indexer is None or store.indexer.backend != "cuda":
            raise AssertionError("build_store attached no cuda BlockIndexer")
        ctx = Context(uid=0, gid=0)
        st, ino, _ = m.create(ctx, 1, b"smoke.bin", 0o644)
        if st != 0:
            raise AssertionError(f"create: errno {st}")
        per_chunk = CHUNK_SIZE // bs
        batches0 = stage_count("gpu.index.batch")
        kernels.reset_launches()
        t0 = time.perf_counter()
        for i, data in enumerate(blocks):
            sid = m.new_slice()
            w = store.new_writer(sid)
            w.write_at(data, 0)
            w.finish(len(data))
            indx, pos = divmod(i, per_chunk)
            st = m.write_chunk(ino, indx, pos * bs, Slice(pos=pos * bs, id=sid,
                                                         size=len(data), off=0,
                                                         len=len(data)))
            if st != 0:
                raise AssertionError(f"write_chunk: errno {st}")
        store.flush_all()
        store.indexer.flush()
        write_s = time.perf_counter() - t0
        index_launches = launches()
        index_batches = stage_count("gpu.index.batch") - batches0
        ix = store.indexer.stats()
        write_gibs = nbytes / (1 << 30) / write_s
        print(f"indexed write of {n_blocks} blocks ({nbytes / (1 << 30):.4f} GiB, {planted} "
              f"planted duplicates) in {write_s:.3f} s = {write_gibs:.4f} GiB/s; indexer "
              f"{json.dumps(ix)}; {index_batches} index batches, {index_launches} launches")
        if ix["errors"] != 0:
            raise AssertionError(f"indexer errors {ix['errors']}")
        if ix["blocks"] + ix["dropped"] != n_blocks:
            raise AssertionError(f"indexer blocks {ix['blocks']} + dropped {ix['dropped']} "
                                 f"!= {n_blocks} uploaded")
        if index_batches == 0 or index_launches != index_batches:
            raise AssertionError(f"{index_launches} launches for {index_batches} index batches")
        indexed_rows = {block_key(sid, indx, bsize): d
                        for sid, indx, bsize, d in m.scan_block_digests()}
        order = [block_key(s.id, 0, s.size) for s in
                 sorted((s for sl in m.list_slices().values() for s in sl),
                        key=lambda s: s.id)]
        store.close()
        store = None
        m.client.close()

        # 3. gc --dedup: trusts the index, backfills what the indexer dropped
        index_path = os.path.join(base, "dedup-index.json")
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc, out, _ = cli(["gc", meta_url, "--dedup", "--threads", "16",
                          "--compress-backend", "cuda", "--dedup-index", index_path])
        gc_s = time.perf_counter() - t0
        gc_launches = launches()
        lines = out.strip().splitlines()
        if rc != 0 or not lines[0].endswith("0 leaked, 0 missing"):
            raise AssertionError(f"gc rc {rc}: {lines[:1]}")
        gc = json.loads(lines[-1])
        want = {"from_index": ix["blocks"], "hashed_now": ix["dropped"],
                "duplicate_blocks": planted, "blocks": n_blocks}
        got = {k: gc[k] for k in want}
        if got != want:
            raise AssertionError(f"gc {got} != {want}")
        index = json.load(open(index_path))
        for key in order[:: max(1, n_blocks // 8)][:8]:
            i = order.index(key)
            if index[key] != jth256(blocks[i]).hex():
                raise AssertionError(f"{key}: dedup index digest != numpy spec")
        # backfill on the card: rows lost as a client without an indexer
        # loses them are read back, hashed in 32-block batches and restored
        lost = sorted(indexed_rows)[::5]
        m = new_client(meta_url)
        m.delete_block_digests([parse_block_key(k)[:2] for k in lost])
        m.client.close()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc, out, _ = cli(["gc", meta_url, "--dedup", "--threads", "16",
                          "--compress-backend", "cuda", "--dedup-index", index_path])
        backfill_s = time.perf_counter() - t0
        gc_launches += launches()
        backfill = json.loads(out.strip().splitlines()[-1])
        if rc != 0 or backfill["hashed_now"] != len(lost) \
                or launches() != -(-len(lost) // 32) \
                or json.load(open(index_path)) != index:
            raise AssertionError(f"gc backfill: rc {rc}, hashed_now "
                                 f"{backfill['hashed_now']} of {len(lost)} lost rows, "
                                 f"{launches()} launches; or the index changed")

        # 4. fsck --verify-data: re-hash every block on the card
        hash_path = os.path.join(base, "hash-index.json")
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc, out, _ = cli(["fsck", meta_url, "--verify-data", "--hash-index", hash_path])
        fsck_s = time.perf_counter() - t0
        fsck_launches = launches()
        want_batches = -(-n_blocks // 32)
        if rc != 0 or f"verified {n_blocks} blocks (cuda)" not in out \
                or "0 digest mismatches" not in out:
            raise AssertionError(f"fsck rc {rc}")
        if fsck_launches != want_batches:
            raise AssertionError(f"fsck: {fsck_launches} launches, want {want_batches}")
        if json.load(open(hash_path)) != index:
            raise AssertionError("fsck hash index != gc dedup index")
        fsck_gibs = nbytes / (1 << 30) / fsck_s
        # planted bitrot: other bytes of the same size under one block key
        victim = order[n_blocks // 2]
        objects = cmd.storage_for(fmt)
        objects.put(victim, rng.bytes(len(objects.get(victim))))
        rc, out, errors = cli(["fsck", meta_url, "--verify-data"])
        mismatched = [e for e in errors if "digest mismatch" in e]
        if rc != 1 or "1 digest mismatches" not in out or len(mismatched) != 1 \
                or victim not in mismatched[0]:
            raise AssertionError(f"bitrot: rc {rc}, mismatch records {mismatched}, "
                                 f"want 1 naming {victim}")

        # 5. cross-open: a fresh client reads the rows the indexer wrote
        # (and gc's backfill of what it dropped)
        fresh = new_client(meta_url)
        fresh.load()
        rows = {block_key(sid, indx, bsize): d
                for sid, indx, bsize, d in fresh.scan_block_digests()}
        fresh.client.close()
        if {k: rows.get(k) for k in indexed_rows} != indexed_rows:
            raise AssertionError("reopened meta: indexer rows differ")
        if {k: d.hex() for k, d in rows.items()} != index:
            raise AssertionError("reopened meta: rows != gc dedup index")
        print(f"gates ok: format probed {kind}; {ix['blocks']} blocks indexed in "
              f"{index_batches} batches ({ix['dropped']} dropped, {ix['errors']} errors), "
              f"one launch per batch; gc from_index {gc['from_index']}, hashed_now "
              f"{gc['hashed_now']}, {planted} duplicates, sampled index == spec, "
              f"{len(lost)} lost rows backfilled on the card; fsck "
              f"verified {n_blocks} blocks in {fsck_launches} launches, 0 mismatches, then "
              f"exactly {victim}; reopened meta rows == indexer rows")
        print(f"main path: write {write_gibs:.4f} GiB/s; gc --dedup {gc_s:.3f} s "
              f"({gc['from_index']} blocks from the index, {gc['hashed_now']} read and "
              f"hashed), {backfill_s:.3f} s to backfill {len(lost)} lost rows "
              f"({backfill['gibs']} GiB/s over the volume); fsck --verify-data {fsck_gibs:.4f} GiB/s ({fsck_s:.3f} s); "
              f"indexer busy {ix['busy_seconds']} s = {ix['hash_mib_s']} MiB/s")
        return {"blocks": n_blocks, "write_gibs": write_gibs, "gc_seconds": gc_s,
                "backfill_seconds": backfill_s, "backfilled": len(lost),
                "fsck_gibs": fsck_gibs, "indexer": ix, "index_batches": index_batches,
                "launches": {"index": index_launches, "gc": gc_launches,
                             "fsck": fsck_launches},
                "gc": gc}
    finally:
        if store is not None:
            store.close()
        shutil.rmtree(base, ignore_errors=True)


SERVE_STAGES = ("chunk.upload.compress", "chunk.upload.put", "gpu.index.batch")
SERVE_AK, SERVE_SK = "AKSMOKE", "smoke-secret"
TENANT_AK, TENANT_SK = "AKTENANT", "tenant-secret"
S3_NS = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}


class S3Client:
    """One signed S3 client on its own http.client connection."""

    def __init__(self, port: int, ak: str, sk: str):
        self.host = f"127.0.0.1:{port}"
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        self.signer = SigV4(ak, sk)

    def call(self, method: str, path: str, body: bytes = b"", query=None, headers=None,
             sign: bool = True, payload_hash: str | None = None):
        query, headers = query or {}, dict(headers or {})
        if sign:
            ph = payload_hash or hashlib.sha256(body).hexdigest()
            headers.update(self.signer.sign(method, self.host, path, query, ph,
                                            extra_headers=headers))
        url = path + ("?" + urllib.parse.urlencode(query) if query else "")
        self.conn.request(method, url, body=body or None, headers=headers)
        r = self.conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()

    def close(self):
        self.conn.close()


def span_digests(data: bytes, span: int) -> list[bytes]:
    """The numpy spec's digests of `data` cut into `span`-byte spans,
    hashed 16 at a time."""
    spans = [data[i:i + span] for i in range(0, len(data), span)] or [b""]
    out: list[bytes] = []
    for i in range(0, len(spans), 16):
        out += hash_blocks_np(spans[i:i + 16])
    return out


def streaming_etag(data: bytes, span: int) -> str:
    """The gateway's ETag (gateway/serve.py StreamingEtag) recomputed from
    the numpy spec: one span hashes as jth256(body); more fold their span
    digests through sha256 and hash the fold."""
    digests = span_digests(data, span)
    if len(digests) == 1:
        return digest_hex(digests[0])[:32]
    return digest_hex(jth256(hashlib.sha256(b"".join(digests)).digest()))[:32]


def put_count() -> int:
    """Object PUTs so far, every backend (the metered layer's histogram)."""
    h = global_registry()._metrics["juicefs_object_request_durations_histogram_seconds"]
    return sum(c.total for labels, c in list(h._children.items()) if labels[0] == "PUT")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gateway_cli_run(meta_url: str, rng: np.random.Generator) -> dict:
    """`python -m juicefs_tpu_torch.cmd gateway` as a process on the volume:
    one signed 4 MiB PUT and GET, the juicefs_gateway_* counters on
    /metrics, then SIGTERM and exit code 0."""
    port, mport = free_port(), free_port()
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "juicefs_tpu_torch.cmd", "gateway", meta_url, "--port",
         str(port), "--access-key", SERVE_AK, "--secret-key", SERVE_SK, "--metrics",
         f"127.0.0.1:{mport}"],
        cwd=repo, stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 180
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(f"gateway process exited with {proc.wait()}")
            if "listening on port" in line:
                break
        else:
            raise AssertionError("gateway process did not start listening")
        ready_s = time.perf_counter() - t0
        client = S3Client(port, SERVE_AK, SERVE_SK)
        body = rng.bytes(BLOCK_BYTES)
        st, hdrs, _ = client.call("PUT", "/bkt/cli.bin", body=body)
        if st != 200 or hdrs["ETag"].strip('"') != streaming_etag(body, BLOCK_BYTES):
            raise AssertionError(f"gateway process PUT: {st} {hdrs.get('ETag')}")
        st, _, got = client.call("GET", "/bkt/cli.bin")
        client.close()
        if st != 200 or got != body:
            raise AssertionError(f"gateway process GET: {st}, {len(got)} bytes")
        mconn = http.client.HTTPConnection("127.0.0.1", mport, timeout=60)
        mconn.request("GET", "/metrics")
        text = mconn.getresponse().read().decode()
        mconn.close()
        moved = {op: float(m[1]) for op, m in (
            (op, re.search(r'juicefs_gateway_requests\{op="%s"\} (\S+)' % op, text))
            for op in ("put", "get")) if m}
        if moved.get("put", 0) < 1 or moved.get("get", 0) < 1:
            raise AssertionError(f"/metrics juicefs_gateway_requests: {moved}")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
    if rc != 0:
        raise AssertionError(f"gateway process exited with {rc} on SIGTERM")
    return {"ready_seconds": ready_s, "metrics_requests": moved, "rc": rc}


def serve_phase(rng: np.random.Generator, volume_gib: float, smi: str) -> dict:
    """Phase 12: the S3 gateway serving a volume, then the SDK, then the
    admin path, all through the port's entry points on one `sqlite3://` +
    file:// volume formatted `--hash-backend pallas --compress lz4`."""
    phase("serve: S3 gateway, SDK, gc --compact --dedup, fsck")
    t_phase = time.perf_counter()
    bs = BLOCK_BYTES
    per_object = 8  # 32 MiB objects
    blocks, planted = plan_blocks(rng, max(per_object, int(volume_gib * (1 << 30)) // bs
                                           // per_object * per_object), bs, (1 << 20) + 7)
    ragged = blocks.pop()
    objects = {f"bkt/c{j % 4}/obj{j:03d}.bin": blocks[per_object * j:per_object * (j + 1)]
               for j in range(len(blocks) // per_object)}
    nbytes = sum(len(b) for b in blocks)
    base = tempfile.mkdtemp(prefix="jfs-torch-serve-")
    meta_url = f"sqlite3://{base}/meta.db"
    gw = vfs = m = None
    try:
        rc, _out, _ = cli(["format", meta_url, "serve", "--storage", "file", "--bucket",
                           os.path.join(base, "blob"), "--compress", "lz4",
                           "--hash-backend", "pallas", "--trash-days", "0"])
        if rc != 0:
            raise AssertionError(f"format rc {rc}")

        # 1. the gateway, built in-process as `gateway` builds it
        parser = argparse.ArgumentParser()
        gateway_cmd.add_parser(parser.add_subparsers())
        args = parser.parse_args(["gateway", meta_url, "--port", "0", "--access-key",
                                  SERVE_AK, "--secret-key", SERVE_SK, "--tenant-key",
                                  f"{TENANT_AK}:{TENANT_SK}"])
        gw, vfs, m = gateway_cmd.start_gateway(args)
        store = vfs.store
        if store.indexer is None or store.indexer.backend != "cuda" \
                or store.compress_plane.config.backend != "cuda":
            raise AssertionError("the gateway's store has no cuda BlockIndexer or plane")
        span = gw.plane.span
        keys = list(objects)
        shas = {}
        for key in keys:
            h = hashlib.sha256()
            for b in objects[key]:
                h.update(b)
            shas[key] = h.hexdigest()
        creds = [(SERVE_AK, SERVE_SK), (SERVE_AK, SERVE_SK), (TENANT_AK, TENANT_SK),
                 (TENANT_AK, TENANT_SK)]
        clients = [S3Client(gw.port, ak, sk) for ak, sk in creds]
        if clients[0].call("PUT", "/bkt")[0] != 200:
            raise AssertionError("PUT bucket")
        statuses, etags = {}, {}

        def put_all(c):
            for key in keys[c::len(clients)]:
                st, hdrs, _ = clients[c].call("PUT", "/" + key, body=b"".join(objects[key]),
                                              payload_hash=shas[key])
                statuses[key], etags[key] = st, hdrs.get("ETag", "").strip('"')

        batches0 = stage_count("gpu.index.batch")
        puts0 = put_count()
        stages0 = stage_metrics_snapshot()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(clients), thread_name_prefix="smoke-s3") as ex:
            list(ex.map(put_all, range(len(clients))))
        put_s = time.perf_counter() - t0
        put_stages = stage_delta(stages0, stage_metrics_snapshot(), SERVE_STAGES)

        # multipart (part 3 repeats part 1), a ragged object, a copy
        c0 = clients[0]
        st, _, body = c0.call("POST", "/bkt/mp.bin", query={"uploads": ""})
        upload = ET.fromstring(body).findtext(".//s3:UploadId", namespaces=S3_NS)
        parts = [rng.bytes(2 * bs), rng.bytes(2 * bs)]
        parts.append(parts[0])
        part_etags = []
        for num, part in enumerate(parts, 1):
            st, hdrs, _ = c0.call("PUT", "/bkt/mp.bin", body=part,
                                  query={"partNumber": str(num), "uploadId": upload})
            statuses[f"part {num}"] = st
            part_etags.append(hdrs.get("ETag", "").strip('"'))
        st, _, body = c0.call("POST", "/bkt/mp.bin", body=b"<CompleteMultipartUpload/>",
                              query={"uploadId": upload})
        statuses["complete"] = st
        mp_etag = ET.fromstring(body).findtext(".//s3:ETag", namespaces=S3_NS).strip('"')
        st, hdrs, _ = clients[2].call("PUT", "/bkt/ragged.bin", body=ragged)
        statuses["bkt/ragged.bin"], etags["bkt/ragged.bin"] = st, hdrs["ETag"].strip('"')
        src = keys[1]
        st, _, body = c0.call("PUT", "/bkt/copy/of.bin",
                              headers={"x-amz-copy-source": "/" + src})
        statuses["copy"] = st
        copy_etag = ET.fromstring(body).findtext(".//s3:ETag", namespaces=S3_NS).strip('"')
        bad = [k for k, st in statuses.items() if st != 200]
        if bad:
            raise AssertionError(f"PUTs not 200: {[(k, statuses[k]) for k in bad]}")

        # ETags == StreamingEtag recomputed from the numpy spec
        want_etags = {k: streaming_etag(b"".join(objects[k]), span) for k in keys}
        want_etags["bkt/ragged.bin"] = streaming_etag(ragged, span)
        if etags != want_etags:
            wrong = [k for k in want_etags if etags.get(k) != want_etags[k]]
            raise AssertionError(f"ETags differ from the spec for {wrong[:5]}")
        if part_etags != [streaming_etag(p, span) for p in parts]:
            raise AssertionError(f"part ETags {part_etags} differ from the spec")
        if mp_etag != digest_hex(jth256("".join(part_etags).encode()))[:32] + "-3":
            raise AssertionError(f"multipart ETag {mp_etag}")
        if copy_etag != etags[src]:
            raise AssertionError("copy ETag != its source's")

        # reads: full GETs (timed), then 3 Range GETs per object
        everything = {k: b"".join(v) for k, v in objects.items()}
        everything.update({"bkt/mp.bin": b"".join(parts), "bkt/ragged.bin": ragged,
                           "bkt/copy/of.bin": b"".join(objects[src])})
        wrong = []

        def get_all(c):
            for key in keys[c::len(clients)]:
                st, _, got = clients[c].call("GET", "/" + key)
                if st != 200 or got != everything[key]:
                    wrong.append((key, st))

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(clients), thread_name_prefix="smoke-s3") as ex:
            list(ex.map(get_all, range(len(clients))))
        get_s = time.perf_counter() - t0
        for key, data in everything.items():
            if key in objects:
                continue
            st, _, got = c0.call("GET", "/" + key)
            if st != 200 or got != data:
                wrong.append((key, st))
        for key, data in everything.items():
            for _ in range(3):
                a = int(rng.integers(0, len(data)))
                b = int(rng.integers(a, min(len(data), a + 3 * bs)))
                st, _, got = c0.call("GET", "/" + key, headers={"Range": f"bytes={a}-{b}"})
                if st != 206 or got != data[a:b + 1]:
                    wrong.append((f"{key} {a}-{b}", st))
        if wrong:
            raise AssertionError(f"reads differ: {wrong[:5]}")

        # paginated ListObjectsV2
        listed, token, pages = [], None, 0
        while True:
            q = {"list-type": "2", "max-keys": "7"}
            if token:
                q["continuation-token"] = token
            st, _, body = clients[3].call("GET", "/bkt", query=q)
            root = ET.fromstring(body)
            listed += [el.text for el in root.findall(".//s3:Contents/s3:Key", S3_NS)]
            token = root.findtext(".//s3:NextContinuationToken", namespaces=S3_NS)
            pages += 1
            if root.findtext(".//s3:IsTruncated", namespaces=S3_NS) != "true":
                break
        if sorted(listed) != sorted(k[len("bkt/"):] for k in everything) \
                or len(listed) != len(set(listed)):
            raise AssertionError(f"listing: {len(listed)} keys in {pages} pages")
        # refused: unsigned, and a lying payload hash (its object must not exist)
        if c0.call("GET", "/" + keys[0], sign=False)[0] != 403:
            raise AssertionError("an unsigned GET was not refused")
        st, _, _ = c0.call("PUT", "/bkt/liar.bin", body=rng.bytes(1000),
                           payload_hash=hashlib.sha256(b"other").hexdigest())
        if st != 400 or c0.call("HEAD", "/bkt/liar.bin")[0] != 404:
            raise AssertionError(f"lying payload hash: {st}, or its object exists")
        for c in clients:
            c.close()
        tenants = gw.plane.stats()["tenants"]

        # stop the gateway, close its vfs, store (the indexer drains) and session
        gw.stop()
        ix = store.indexer.stats()
        vfs.close()
        store.close()
        m.close_session()
        m.client.close()
        gw = vfs = m = None
        serve_launches = launches()
        index_batches = stage_count("gpu.index.batch") - batches0
        written = put_count() - puts0
        print(f"gateway: {len(keys)} PUTs of {per_object * bs >> 20} MiB from {len(clients)} "
              f"clients in {put_s:.3f} s = {nbytes / (1 << 30) / put_s:.4f} GiB/s, "
              f"{len(keys) / put_s:.2f} ops/s; GET {nbytes / (1 << 30) / get_s:.4f} GiB/s; "
              f"listing {len(listed)} keys in {pages} pages; tenants {tenants}; card {smi}")
        print(f"gateway indexer {json.dumps(ix)}; {written} blocks written, "
              f"{index_batches} index batches, {serve_launches} launches; card {smi}")
        print(f"gateway PUT stage seconds {json.dumps(put_stages)}; card {smi}")
        if ix["errors"] != 0:
            raise AssertionError(f"indexer errors {ix['errors']}")
        if ix["blocks"] + ix["dropped"] != written or written < len(blocks) + 7:
            raise AssertionError(f"indexer blocks {ix['blocks']} + dropped {ix['dropped']} "
                                 f"!= {written} written")
        if index_batches == 0 or serve_launches != index_batches:
            raise AssertionError(f"{serve_launches} launches for {index_batches} index batches")

        # 2. the SDK on the same volume: read every object back, then write
        # one file as 64 flushed 1 MiB pieces (one slice each)
        kernels.reset_launches()
        batches0 = stage_count("gpu.index.batch")
        puts0 = put_count()
        mid = sdk.jfs_init(meta_url)
        if mid <= 0:
            raise AssertionError(f"jfs_init: {mid}")
        t0 = time.perf_counter()
        sdk_bytes = 0
        for key, data in everything.items():
            fd = sdk.jfs_open(mid, "/" + key, os.O_RDONLY, 0)
            got = sdk.jfs_pread(mid, fd, 0, len(data) + 1)
            sdk.jfs_close(mid, fd)
            st = sdk.jfs_stat(mid, "/" + key)
            if fd <= 0 or got != data or st[0] != len(data):
                raise AssertionError(f"SDK read of {key} differs")
            sdk_bytes += len(data)
        sdk_read_s = time.perf_counter() - t0
        pieces = rng.bytes(64 << 20)
        if sdk.jfs_mkdir(mid, "/bkt/sdk", 0o755) != 0:
            raise AssertionError("jfs_mkdir")
        fd = sdk.jfs_open(mid, "/bkt/sdk/pieces.bin", os.O_CREAT | os.O_RDWR, 0o644)
        if fd <= 0:
            raise AssertionError(f"jfs_open: {fd}")
        t0 = time.perf_counter()
        for i in range(64):
            if sdk.jfs_pwrite(mid, fd, i << 20, pieces[i << 20:(i + 1) << 20]) != 1 << 20 \
                    or sdk.jfs_flush(mid, fd) != 0:
                raise AssertionError(f"SDK write of piece {i}")
        sdk_write_s = time.perf_counter() - t0
        sdk.jfs_close(mid, fd)
        sdk_ix = sdk._mounts[mid][1].store.indexer
        if sdk.jfs_term(mid) != 0:
            raise AssertionError("jfs_term")
        sdk_ix = sdk_ix.stats()
        sdk_launches = launches()
        sdk_batches = stage_count("gpu.index.batch") - batches0
        sdk_written = put_count() - puts0
        print(f"SDK: read {sdk_bytes / (1 << 30):.4f} GiB in {sdk_read_s:.3f} s = "
              f"{sdk_bytes / (1 << 30) / sdk_read_s:.4f} GiB/s; 64 flushed 1 MiB pieces in "
              f"{sdk_write_s:.3f} s; indexer {json.dumps(sdk_ix)}, {sdk_batches} batches, "
              f"{sdk_launches} launches; card {smi}")
        if sdk_ix["errors"] or sdk_ix["blocks"] + sdk_ix["dropped"] != sdk_written \
                or sdk_written != 64 or sdk_launches != sdk_batches:
            raise AssertionError(f"SDK indexer {sdk_ix}: {sdk_written} written, "
                                 f"{sdk_launches} launches for {sdk_batches} batches")
        everything["bkt/sdk/pieces.bin"] = pieces

        # 3. what gc --compact --dedup must do, read from the meta first:
        # fragmented chunks merge into new slices the index lacks; the other
        # live blocks the index lacks are the ones the indexers dropped.
        # Files the gateway removed (multipart parts, the lying PUT's temp)
        # keep their slices until the session's cleanup runs: run it now,
        # so that gc sees only what the volume's files hold
        meta = new_client(meta_url)
        meta.cleanup_deleted_files()
        indexed = {(sid, indx) for sid, indx, _b, _d in meta.scan_block_digests()}
        fragmented, missing = 0, set()
        merged_blocks = 0
        for _key, slcs in meta.list_chunks():
            if len(slcs) >= 2:
                view = build_slice(slcs)
                fragmented += 1
                merged_blocks += -(-(view[-1].pos + view[-1].len) // bs)
                continue
            for s in slcs:
                for i in range(-(-s.size // bs) if s.id else 0):
                    if (s.id, i) not in indexed:
                        missing.add((s.id, i))
        meta.client.close()
        want_hashed = merged_blocks + len(missing)
        index_path = os.path.join(base, "dedup-index.json")
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc, out, _ = cli(["gc", meta_url, "--compact", "--dedup", "--threads", "16",
                          "--dedup-index", index_path])
        gc_s = time.perf_counter() - t0
        gc_launches = launches()
        lines = out.strip().splitlines()
        if rc != 0 or lines[0] != f"compacted {fragmented} chunks" or fragmented < 1 \
                or not lines[1].endswith(" 0 missing"):
            raise AssertionError(f"gc rc {rc}: {lines[:2]}; {fragmented} fragmented chunks")
        gc = json.loads(lines[-1])
        if gc["hashed_now"] != want_hashed or gc_launches != -(-want_hashed // 32):
            raise AssertionError(f"gc hashed {gc['hashed_now']} in {gc_launches} launches; want "
                                 f"{merged_blocks} merged + {len(missing)} dropped blocks, "
                                 f"one launch per 32")
        if gc["duplicate_blocks"] != planted + 2:  # part 3 repeats part 1's 2 blocks
            raise AssertionError(f"gc found {gc['duplicate_blocks']} duplicates, planted "
                                 f"{planted} + 2")

        # the index == the numpy spec for every live block; every file is
        # now one slice per chunk, so a block's bytes are the file's
        meta = new_client(meta_url)
        live_bytes = {}
        ctx = Context(uid=0, gid=0)
        for key, data in everything.items():
            ino = 1
            for part in key.split("/"):
                st, ino, _ = meta.lookup(ctx, ino, part.encode())
                if st:
                    raise AssertionError(f"lookup {key}: errno {st}")
            for indx in range(-(-len(data) // CHUNK_SIZE)):
                st, slcs = meta.read_chunk(ino, indx)
                if st or len(slcs) != 1 or slcs[0].pos or slcs[0].off:
                    raise AssertionError(f"{key} chunk {indx}: {len(slcs)} slices after gc")
                s = slcs[0]
                for i in range(-(-s.size // bs)):
                    chunk = data[indx * CHUNK_SIZE + i * bs:indx * CHUNK_SIZE + (i + 1) * bs]
                    live_bytes[block_key(s.id, i, len(chunk))] = chunk
        meta.client.close()
        index = json.load(open(index_path))
        keys_sorted = sorted(live_bytes)
        spec = {}
        for i in range(0, len(keys_sorted), 16):
            group = keys_sorted[i:i + 16]
            for k, d in zip(group, hash_blocks_np([live_bytes[k] for k in group])):
                spec[k] = d.hex()
        if index != spec:
            raise AssertionError(f"dedup index ({len(index)} rows) != numpy spec "
                                 f"({len(spec)} live blocks)")
        # the compacted file reads back the same bytes
        mid = sdk.jfs_init(meta_url)
        fd = sdk.jfs_open(mid, "/bkt/sdk/pieces.bin", os.O_RDONLY, 0)
        same = sdk.jfs_pread(mid, fd, 0, len(pieces) + 1) == pieces
        sdk.jfs_close(mid, fd)
        sdk.jfs_term(mid)
        if not same:
            raise AssertionError("the compacted file reads back other bytes")

        # 4. fsck --verify-data
        hash_path = os.path.join(base, "hash-index.json")
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc, out, _ = cli(["fsck", meta_url, "--verify-data", "--hash-index", hash_path])
        fsck_s = time.perf_counter() - t0
        fsck_launches = launches()
        n_live = len(live_bytes)
        if rc != 0 or f"verified {n_live} blocks (cuda)" not in out \
                or "0 digest mismatches" not in out or fsck_launches != -(-n_live // 32) \
                or json.load(open(hash_path)) != index:
            raise AssertionError(f"fsck rc {rc}, {fsck_launches} launches for {n_live} blocks")

        # 5. the gateway subcommand as a process
        proc = gateway_cli_run(meta_url, rng)

        # the kernel at the gateway's mean index batch, resident, timed alone
        m_lanes = bs // LANE_BYTES
        batch_blocks = max(1, round(ix["blocks"] / max(1, index_batches)))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(int(rng.integers(1 << 31)))
        words = random_words(gen, batch_blocks * m_lanes)
        hash_torch.row_chain(words, m_lanes, 1)  # warm-up
        batch_ms = time_cuda(lambda i: hash_torch.row_chain(words, m_lanes, 0x3000 + i), 10)
        batch_bound_ms, batch_bound_by = row_chain_bound_ms(batch_blocks * m_lanes, smi)
        del words
        print(f"gates ok: every PUT 200, ETags == spec, GET/Range/SDK reads exact, "
              f"{len(listed)} keys listed, 403 unsigned, 400 + absent on a lying hash; "
              f"indexed + dropped == written, one launch per index batch; compacted "
              f"{fragmented} chunks, gc hashed {want_hashed} ({merged_blocks} merged + "
              f"{len(missing)} dropped) in {gc_launches} launches, {gc['duplicate_blocks']} "
              f"duplicates, index == spec; fsck {n_live} blocks, 0 mismatches; gateway "
              f"process ready in {proc['ready_seconds']:.3f} s, exit 0 on SIGTERM")
        print(f"serve: gc --compact --dedup {gc_s:.3f} s (dedup_scan {gc['seconds']} s, so "
              f"compaction and listing {gc_s - gc['seconds']:.3f} s), fsck --verify-data "
              f"{fsck_s:.3f} s ({n_live} blocks); indexer busy {ix['busy_seconds']} s, "
              f"{ix['dropped']} dropped; row_chain on a resident {batch_blocks}-block "
              f"batch {batch_ms:.4f} ms, bound {batch_bound_ms:.4f} ms ({batch_bound_by}) = "
              f"{batch_bound_ms / batch_ms:.3f} of bound; phase "
              f"{time.perf_counter() - t_phase:.3f} s; card {smi}")
        return {"put_gibs": nbytes / (1 << 30) / put_s, "put_ops": len(keys) / put_s,
                "get_gibs": nbytes / (1 << 30) / get_s,
                "sdk_read_gibs": sdk_bytes / (1 << 30) / sdk_read_s,
                "indexer": ix, "index_batches": index_batches, "gc_seconds": gc_s,
                "fsck_seconds": fsck_s, "gc": gc, "batch_kernel_ms": batch_ms,
                "launches": {"serve_index": serve_launches, "serve_sdk": sdk_launches,
                             "serve_gc": gc_launches, "serve_fsck": fsck_launches}}
    finally:
        if gw is not None:
            gw.stop()
        if vfs is not None:
            vfs.close()
            vfs.store.close()
        if m is not None:
            m.close_session()
        shutil.rmtree(base, ignore_errors=True)


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
    main_path = main_path_phase(rng, args.volume_gib, kind)
    serve = serve_phase(rng, args.volume_gib, smi)
    by_path = {"scan": scan["launches"]["jth256_row_chain"],
               "ingest": ingest["launches"]["jth256_row_chain"],
               "ingest_cold_scan": ingest["cold_scan_launches"]["jth256_row_chain"],
               "ingest_concurrent": conc["launches"]["jth256_row_chain"],
               **main_path["launches"], **serve["launches"]}
    print(f"launches of jth256_row_chain: {by_path} ({args.volume_gib} GiB each: scan, "
          "ingest, its cold scan, concurrent ingest, indexed write, gc, fsck; then the "
          "gateway's index batches, the SDK's, gc --compact --dedup, fsck); card " + smi)
    if by_path["index"] == 0 or by_path["fsck"] == 0 or by_path["serve_index"] == 0:
        raise AssertionError("the indexed write, fsck or the gateway launched no row-chain "
                             "kernel")
    print(f"card {smi}: ingest {ingest['gibs']:.4f} GiB/s (1 writer), "
          f"{conc['gibs']:.4f} GiB/s (4 writers); scan {scan['gibs']} GiB/s; indexed "
          f"write {main_path['write_gibs']:.4f} GiB/s, gc --dedup {main_path['gc_seconds']:.3f} "
          f"s, fsck --verify-data {main_path['fsck_gibs']:.4f} GiB/s; gateway PUT "
          f"{serve['put_gibs']:.4f} GiB/s ({serve['put_ops']:.2f} ops/s), GET "
          f"{serve['get_gibs']:.4f} GiB/s, SDK read {serve['sdk_read_gibs']:.4f} GiB/s")
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
