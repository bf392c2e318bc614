#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (juicefs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--volume-gib G]

Phases, in order; any mismatch raises and the script exits non-zero:

  1. device   require CUDA; print the card's name and power limit
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
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from juicefs_tpu_torch.chunk.cached_store import block_key
from juicefs_tpu_torch.cmd.gc import dedup_scan
from juicefs_tpu_torch.gpu import hash_torch, kernels
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
    """Stand-in for a meta engine's content index (the port has no meta
    engine yet): {(sid, indx): (bsize, digest)}."""

    def __init__(self):
        self.rows: dict[tuple[int, int], tuple[int, bytes]] = {}

    def scan_block_digests(self):
        return [(sid, indx, bsize, d)
                for (sid, indx), (bsize, d) in list(self.rows.items())]

    def set_block_digests(self, rows):
        for sid, indx, bsize, d in rows:
            self.rows[(sid, indx)] = (bsize, d)

    def delete_block_digests(self, pairs):
        for sid, indx in pairs:
            self.rows.pop((sid, indx), None)


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


def write_volume(root: str, rng: np.random.Generator, n_full: int, bs: int,
                 dup_ratio: float = 0.25):
    """Write n_full blocks of bs bytes plus one ragged tail block under
    block_key names; ~dup_ratio of the full blocks come from a 4-block
    pool. Returns (live, keys in write order, planted duplicate count)."""
    storage = FileStorage(root)
    storage.create()
    pool = [rng.bytes(bs) for _ in range(4)]
    live: dict[str, int] = {}
    order: list[str] = []
    seen: set[int] = set()
    dups = 0
    for i in range(n_full + 1):
        if i == n_full:
            data = rng.bytes(3 * LANE_BYTES + 777)  # ragged tail block
        elif rng.random() < dup_ratio:
            p = int(rng.integers(0, len(pool)))
            dups += p in seen
            seen.add(p)
            data = pool[p]
        else:
            data = rng.bytes(bs)
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
    print(f"launches of jth256_row_chain per {args.volume_gib} GiB scan: "
          f"{scan['launches']['jth256_row_chain']} (one per hash batch)")
    print(f"total {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": [{
        "name": "jth256_row_chain",
        "route": "cuda",
        "source": "juicefs_tpu_torch/gpu/kernels/jth256_row_chain.cu",
        "replaces": "juicefs_tpu/tpu/hash_jax.py:174",
        "launches": scan["launches"]["jth256_row_chain"],
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
