#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (juicefs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--volume-gib G]
    python3 chip_smoke.py --compare-row-chain DIR   # DIR: another checkout
    python3 chip_smoke.py --compare-row-chain . --compare-define JTH256_STAGES=8

With --compare-row-chain it only builds DIR's row-chain kernel beside this
checkout's and times the two at the timing phase's sizes, in turns;
--compare-define passes a macro to DIR's build (the second form times
another ring size of this checkout's kernel against its 4 stages).

Phases, in order; any mismatch raises and the script exits non-zero:

  1. device   require CUDA; print the card's name and power limit; load
              liblz4 (the ingest phase compresses with it)
  2. build    compile the two kernel sources from the repo's sources
              (sm_90a), one nvcc each, in parallel: jth256_row_chain.cu
              (the row chain, with a states and a lane-digests epilogue)
              and jth256_combine.cu; the process-wide sharding plane
              (gpu/sharding.py get_plane) must be the one-card rung:
              devices 1, no mesh, no degrade counted. Phases 5-13 run
              through it (gc, ingest, the estimator, the indexer, fsck, the
              gateway and the mount all take device=None), and their
              one-launch-per-batch gates hold on that rung. Every such gate
              also holds the fold to the kernels: each row-chain launch
              ran the lane-digests epilogue, each hash batch launched one
              combine (one per data row on a phase-14 mesh), and the fold
              last ran in the kernels (hash_torch.last_fold_mode)
  3. kernel   each kernel == its plain torch version bit for bit, on the
              main path's batch shapes and on ragged lane counts: row_chain
              == row_chain_ref and chain_digests == chain_digests_ref at
              tweaks 0 / 0x5bd1e995 and lane offsets 0, 32 and 1000;
              combine == combine_accs over each shape's whole blocks with
              dead lanes and lengths 0, 1 and 4 MiB - 1
  4. digests  verify_backend() on the card == numpy spec; scan_step on a
              packed batch == numpy spec + dedup_digests
  5. scan     the main path: `gc --dedup` scan (cmd/gc.py dedup_scan, cuda
              backend) over a 1 GiB file:// volume of 4 MiB blocks with a
              ragged tail and ~25% planted duplicates; gates: every block
              hashed, sampled rows == numpy spec, duplicates == planted
  6. timing   both row-chain epilogues and the combine at 1, 8, 27, 32
              blocks and 1 GiB (16384 lanes): device ms of calls queued
              behind a spin of the card, on inputs cycling through 128 MiB
              (L2 cold), median of 5, each beside its bound and its plain
              version, and one whole hash call's ms
  7. batch    one main-path batch (32 x 4 MiB) split into host packing,
              upload, the hash as the main path runs it (lane digests,
              combine) and, beside it, the states epilogue with the plain
              torch fold
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
  13. mount   `mount --inline-dedup --no-dedup-bypass` of a `format
              --hash-backend pallas --compress lz4` sqlite3:// volume,
              started in-process with `cmd.mount.start_mount` and served on
              a thread: 4 writers write 8 files of 32 MiB (256 MiB: MOUNT_GIB)
              of the same plan plus a 1 MiB + 7 B file in 1 MiB pieces, each
              fsynced and
              closed; gates: elided == planted with no passthrough, errors
              or compress degrade, every hashed block estimated, stored
              objects == unique blocks, launches == ingest hash batches +
              index batches, sampled index rows and the tail file's == the
              numpy spec; a fresh mount reads every file back byte for byte;
              `fsck --verify-data` finds 0 mismatches in one launch per 32
              blocks; last, `python -m juicefs_tpu_torch.cmd mount` as a
              process moves `juicefs_ingest_put_elided` in `MP/.stats`, and
              `umount` and the process exit 0. Every request reaches the
              server through the kernel: /dev/fuse, mounted by fusermount
              where it exists, else by mount(2) as root; the run prints which.
  14. shard   the sharding plane's programs on meshes that list the one
              card several times, on phase 5's plan (257 x 4 MiB, ragged
              tail, ~25% duplicates) packed once: hash, scan (digests, dup,
              first) and estimator on ShardPlane([cuda:0] * k), k = 2, 4, 8
              (2x1, 2x2, 4x2 meshes), each equal bit for bit to the
              one-card plane, one placement per batch, one launch per
              mesh device per batch and one combine per data row; k = 3 degrades (counted) and still
              agrees; sharded_scan_many (10 iterations, tweak in the
              kernel) on 1x1 and 2x2 meshes of the first 256 blocks gives
              one checksum; then multichip.dryrun_multichip on the 2x2 mesh
              at the same size: inline ingest into an lz4 volume and a cold
              gc --dedup scan with its three gates (scan rows == ingest
              rows, sampled rows == numpy spec, duplicates == planted),
              every hashed block estimated from the pack split over the
              mesh with no compress degrade, and 4 launches per hash batch
  15. objbench `objbench file://... --block-size 4 --big-object-size 1024
              --compress lz4 --hash-backend pallas --threads 4` (BASELINE #5
              at 1 GiB); gates: rc 0, "functional: all checks passed",
              indexed + dropped == 256 with 0 errors, sampled in-memory
              digests == numpy spec, launches == index batches; then the
              functional suite and a 64 MiB objbench over s3:// into the
              port's gateway on a `--hash-backend pallas` volume (multipart
              and abort included): rc 0, every check passed, one launch per
              index batch of the gateway's indexer
  16. bench   `bench MP --big-file-size 1024 --json` (BASELINE #1) on an
              ordinary `mount` (through the kernel) of a `--hash-backend
              pallas --compress lz4` sqlite3:// + file:// volume; gates:
              rc 0, all five numbers > 0, no indexer errors, indexed +
              dropped == blocks uploaded, launches == index batches,
              `umount` rc 0
  17. sync    `sync file://SRC s3://AK:SK@127.0.0.1:P/bkt --check-new
              --threads 16` of 64 x 4 MiB objects (256 MiB, duplicates
              included) into the port's gateway on a `--hash-backend pallas`
              volume (BASELINE #4); gates: copied 64, 0 mismatches; a second
              run copies 0; --check-all checks 64 with 0 mismatches; after a
              same-size overwrite of one destination object --check-all
              finds exactly it and returns 1; cluster mode (a manager and 2
              worker processes of juicefs_tpu_torch.cmd) copies all 64; then
              the gateway into the `webdav` subcommand run as a process,
              --check-new with 0 mismatches, the process exits 0 on SIGTERM;
              each server launches once per index batch
  18. config  a `--hash-backend cpu` volume of phase 5's plan, written by a
              client with no indexer: `config --hash-backend pallas` (probes
              the card), then `gc --dedup` hashes every block on the card in
              one launch per 32 blocks and finds the planted duplicates
  19. meta    BASELINE #3 on phase 5's plan: `python -m juicefs_tpu_torch.cmd
              meta-server --data X.aof --fsync always` and a second process
              with `--replica-of` it; the port's gateway on a file:// volume
              as the S3 store; `format redis://... --storage minio
              --hash-backend pallas --compress lz4`, 1 GiB written through
              `build_store` (the indexer's gates as in phase 11); `fsck
              --verify-data` on `redis://...?replica=` verifies every block
              in one launch per 32 with 0 mismatches (its sweeps read the
              primary, as the reference's do), then finds exactly one
              planted (lz4-valid) bitrot behind the gateway; `info` and
              `summary` on the same URL read the replica (point reads);
              the primary SIGKILLed and restarted on its AOF keeps every
              digest row, and `gc --dedup`, with a fifth of the rows
              deleted, trusts the rest, hashes exactly the missing blocks
              on the card in one launch per 32, finds the planted
              duplicates, writes the spec's index and puts the deleted rows
              back; `status`, `info`, `summary`, `quota set/check`, `clone`
              (no object added), `rmr`, `restore` and `mdtest --dirs 10
              --files 100` exit 0 with their JSON checked. Then the same
              write, gc (a fifth of the rows deleted), fsck and planted
              bitrot on `format sql://... --hash-backend pallas --compress
              lz4`, `dump` -> `load` into sqlite3:// with equal digest
              rows, and `destroy`, which leaves the bucket empty
  20. group   a peer-served, card-hashed inline-dedup volume on phase 5's
              plan: `format sqlite3://... --storage file --hash-backend
              pallas --compress lz4`, every object stack of the phase
              wrapped in a FaultyStore (rate 0 until the blackout); the plan
              written by 4 writers of 8-block slices through a store built
              as `mount --inline-dedup` builds it (elided == planted, 0
              passthrough or errors, one launch per hash batch); members A
              and B started with `start_mount --cache-group g --group-listen`
              and their own --cache-dir, each `.status` ring both members,
              found through the meta sessions; `warmup META / --cache-group g
              --group-self <member>` through `cmd.main` into each member's
              cache dir while that member is down, then the member restarts
              on the same address: the two cached key sets are disjoint and
              cover every block, PUT-elided ones included, each block moved
              from the object store once (an elided one as its canonical
              object; a hedged GET may add one twin each), and warmup
              launched nothing; then a total backend
              blackout: B reads the whole file through its vfs byte-equal,
              with 0 backend calls and peer hits == the blocks A owns;
              member A pushes the registry (`--metrics-push`, `--graphite`,
              `--push-interval 0.5`) to a stdlib HTTP sink and a TCP sink:
              the latest push's juicefs_cache_group_* values == the
              registry's; healed, `fsck --verify-data` 0 mismatches in one
              launch per 32 blocks, and `gc --dedup` with a fifth of the
              digest rows deleted hashes exactly those in one launch per 32
              and writes rows == the numpy spec
  21. stores  three legs of 256 MiB of the plan (64 blocks + the tail), each
              the phase-11 gates (indexed write through `build_store`, gc
              --dedup with a fifth of the rows deleted, fsck --verify-data,
              exactly one planted bitrot): `--storage sqlite3` (a sqlite
              file), `--storage redis` (a `meta-server` process, db 2), and
              `--encrypt-rsa-key` on file:// (no raw object holds a 4 KiB
              window of its plaintext; under `--encrypt-algo aes256ctr-rsa`
              a flipped byte is refused by the checksum wrapper). Without
              the `cryptography` package the encrypted leg prints that it
              did not run; the other legs still gate

  22. sdk_c   the port's libjfs C shim (juicefs_tpu_torch/sdk_c) built with g++
              against this interpreter, and two C programs built against it:
              the reference's sdk/c/example.c, run on a `format --hash-backend
              pallas --compress lz4` sqlite3:// volume (exit 0, ALL OK), and
              jfs_copy, which writes phase 5's plan (1 GiB + the tail) from a
              host file into a fresh volume of that format in 1 MiB
              jfs_pwrites, flushes, reopens, reads it back and compares, then
              jfs_term drains the indexer. The programs are child processes
              whose kernel launches this process cannot count: the digest
              rows they leave are the proof, as such a volume hashes only on
              the card. The child's stderr gives its indexer's account: no
              "index batch of N failed" line may appear, and `sdk.jfs_term`'s
              warning gives the blocks hashed and skipped under load (no
              warning: none skipped). Gates: rc 0 and 0 mismatched pieces;
              the volume lists exactly the file, with no session left; no
              failed batch, rows == blocks hashed > 0, rows + skipped ==
              written (no row missing otherwise), no stray row, sampled rows
              and the tail's == the numpy spec; `gc --dedup` with a fifth of the rows deleted
              hashes exactly the dropped and deleted blocks in one launch per
              32 (counted here) and finds the planted duplicates; `fsck
              --verify-data` 0 mismatches in one launch per 32; the port's
              FileSystem reads the file back byte for byte. It prints the C
              side's write and read GiB/s

Each phase prints its seconds. It prints a `{"kernels": [...]}` line and,
as its last line, `{"ok": true, "device": {...}}`. It imports nothing of
JAX or juicefs_tpu.
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
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from juicefs_tpu_torch import cmd, native, sdk, sdk_c
from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig, ContentRefs, IngestPipeline
from juicefs_tpu_torch.chunk import indexer as indexer_mod
from juicefs_tpu_torch.chunk.cached_store import block_key, parse_block_key
from juicefs_tpu_torch.cmd import gateway as gateway_cmd
from juicefs_tpu_torch.cmd import mount as mount_cmd
from juicefs_tpu_torch.cmd.gc import dedup_scan
from juicefs_tpu_torch.compress import new_compressor
from juicefs_tpu_torch.fuse.mount import umount as fuse_umount
from juicefs_tpu_torch.gpu import compress_batch, hash_torch, kernels, sharding
from juicefs_tpu_torch.gpu.dedup import dedup_digests, scan_step
from juicefs_tpu_torch.gpu.jth256 import (
    BLOCK_BYTES,
    COLS,
    LANE_BYTES,
    ROWS,
    digest_hex,
    digests_to_bytes,
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
from juicefs_tpu_torch.multichip import dryrun_multichip
from juicefs_tpu_torch.object.fault import FaultyStore
from juicefs_tpu_torch.object.file import FileStorage
from juicefs_tpu_torch.object.resilient import resilient
from juicefs_tpu_torch.object.s3 import SigV4

REPO = os.path.dirname(os.path.abspath(__file__))
MASK = 0xFFFFFFFF
# phase 13 writes 256 MiB (8 of the 32-MiB files) where it wrote 1 GiB:
# the machine's FUSE device splits each write(2) into 4 KiB WRITEs, and the
# time saved pays for phase 16's 1 GiB `bench` big file through the kernel
MOUNT_GIB = 0.25
TIMING_LANES = 16384  # 1 GiB of words
# Integer ALU rate for the operations bound: Hopper runs 64 INT32
# operations per SM per clock, half its FP32 lanes, so the H100 SXM's
# 67 TFLOP/s FP32 (an FMA counts 2) gives 67e12 / 4 integer ops per second.
INT32_OPS_PER_S = 67e12 / 4
OPS_PER_WORD = 9  # xor tweak, xor, mul, shl, shr, or, mul, shr, xor
FOLD_OPS_PER_STEP = 5  # fold or combine step: xor, mul, shl, shr, or, add (~5)
DIGEST_BYTES = 32  # a lane's 8 digest words
# the timing phase's sizes: a one-block batch (the one-writer ingest leg),
# 8 blocks, the gateway's 27-block index batch, a full 32-block batch and
# 1 GiB
TIMING_BLOCKS = (1, 8, 27, 32, 256)
COLD_BYTES = 128 << 20  # inputs a timed size cycles through: above the 50 MB L2
SPIN_CYCLES = 10_000_000  # torch.cuda._sleep ahead of queued calls (ms on an H100)
QUEUED = 10  # calls queued behind one spin


def hbm_bytes_per_s(name: str) -> float:
    """Published device-memory rate for the card nvidia-smi names."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM (HBM3)


def row_chain_bound_ms(n_lanes: int, smi: str,
                       out_bytes_per_lane: int = COLS * 4) -> tuple[float, str]:
    """Least time the card could take for the row chain over n_lanes: each
    input word read once and each lane's output written once (512 B of
    states, or 32 B of digests for the lane-digests epilogue) at the memory
    rate, or the integer operations at the ALU rate, whichever is larger."""
    in_bytes, out_bytes = n_lanes * LANE_BYTES, n_lanes * out_bytes_per_lane
    bytes_ms = (in_bytes + out_bytes) / hbm_bytes_per_s(smi) * 1e3
    ops = in_bytes // 4 * OPS_PER_WORD
    if out_bytes_per_lane == DIGEST_BYTES:
        ops += n_lanes * 8 * 16 * FOLD_OPS_PER_STEP
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def combine_bound_ms(lane_counts: torch.Tensor, m: int, smi: str) -> tuple[float, str]:
    """Least time for the combine: the live lanes' digests (32 B each), the
    counts and lengths (16 B a block) read once and the (B, 8) int64
    digests written once, or its integer operations (a combine step per
    live lane and word, then the length mix and fmix)."""
    live = int(lane_counts.clamp(0, m).sum())
    n_blocks = int(lane_counts.numel())
    bytes_ms = (live * DIGEST_BYTES + n_blocks * (16 + 64)) / hbm_bytes_per_s(smi) * 1e3
    ops_ms = (live * 8 * FOLD_OPS_PER_STEP + n_blocks * 8 * 12) / INT32_OPS_PER_S * 1e3
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


_PHASE = {"name": None, "t0": 0.0}


def phase(name: str) -> None:
    """Start a phase, printing the seconds the one before took."""
    end_phase()
    print(f"== {name}", flush=True)
    _PHASE.update(name=name, t0=time.perf_counter())


def end_phase() -> None:
    if _PHASE["name"] is not None:
        print(f"== {_PHASE['name']}: {time.perf_counter() - _PHASE['t0']:.3f} s", flush=True)
        _PHASE["name"] = None


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
    nvcc = kernels.build_all()  # one nvcc per source, all at once
    dt = time.perf_counter() - t0
    print(f"built {', '.join(sorted(set(kernels.ENTRY_SOURCES.values())))} for sm_90a in "
          f"{dt:.3f} s (nvcc, in parallel: "
          f"{', '.join(f'{k} {v:.3f} s' for k, v in sorted(nvcc.items()))})")
    return dt


def random_words(gen: torch.Generator, n_lanes: int) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, (n_lanes, ROWS, COLS),
                         dtype=torch.int32, device="cuda", generator=gen)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int(((a.to(torch.int64) & MASK) - (b.to(torch.int64) & MASK)).abs().max())


def kernel_phase(gen: torch.Generator) -> dict:
    """Each kernel == its plain torch version on the same inputs, exactly:
    the row chain's states and lane-digests epilogues at every tweak and
    lane offset, and the combine over the shape's whole blocks with dead lanes. Returns each kernel's
    largest error."""
    phase("kernel vs plain")
    worst = {"jth256_row_chain": 0, "jth256_lane_digests": 0, "jth256_combine": 0}

    def check(name, got, want, what):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name} != its plain version at {what}")
        worst[name] = max(worst[name], err)

    # (lanes, m): the main path's full batch (32 blocks x 64 lanes) and its
    # one-block tail batch, then lane counts that are not multiples of 16;
    # each with lane offsets as the lane-split meshes of phase 14 pass them
    for n_lanes, m in ((2048, 64), (64, 64), (37, 1), (150, 2), (201, 64)):
        words = random_words(gen, n_lanes)
        for tweak in (0, 0x5BD1E995):
            for loff in (0, 32, 1000):
                what = f"L={n_lanes} m={m} tweak={tweak:#x} lane_offset={loff}"
                got = hash_torch.row_chain(words, m, tweak, loff)
                if hash_torch.last_kernel_mode() != "cuda":
                    raise AssertionError("row_chain on a CUDA tensor did not run the kernel")
                check("jth256_row_chain", got, hash_torch.row_chain_ref(words, m, tweak, loff),
                      what)
                got = hash_torch.chain_digests(words, m, tweak, loff)
                if hash_torch.last_kernel_mode() != "cuda" \
                        or hash_torch.last_fold_mode() != "cuda":
                    raise AssertionError("chain_digests on a CUDA tensor did not run the kernel")
                check("jth256_lane_digests", got,
                      hash_torch.chain_digests_ref(words, m, tweak, loff), what)
        # the combine over the shape's whole blocks: a full block, dead
        # lanes past random counts, a one-lane block; lengths 0, 1, 4 MiB - 1
        b = n_lanes // m
        acc = hash_torch.chain_digests(words[:b * m], m).reshape(b, m, 8)
        counts = torch.randint(1, m + 1, (b,), generator=gen, device="cuda",
                               dtype=torch.int64)
        counts[0] = m
        counts[-1] = 1 if b > 1 else m
        lengths = torch.tensor([(0, 1, BLOCK_BYTES - 1)[i % 3] for i in range(b)],
                               dtype=torch.int64, device="cuda")
        got = hash_torch.combine(acc, counts, lengths)
        if hash_torch.last_fold_mode() != "cuda":
            raise AssertionError("combine on a CUDA tensor did not run the kernel")
        check("jth256_combine", got, hash_torch.combine_accs(acc, counts, lengths),
              f"B={b} M={m}")
        print(f"L={n_lanes} m={m}: row_chain and chain_digests, tweak 0 / 0x5bd1e995 x "
              f"lane_offset 0 / 32 / 1000; "
              f"combine over {b} blocks, lane counts {counts.min().item()}-"
              f"{counts.max().item()}: max_abs_err 0")
    print(f"max_abs_err {json.dumps(worst)}")
    return worst


def plane_phase() -> dict:
    """The process-wide sharding plane that phases 5-13 run through must be
    the one-card rung: one device, no mesh, nothing degraded."""
    plane = sharding.get_plane()
    snap = plane.snapshot()
    print(f"shard plane over {[str(d) for d in plane.devices]}: {json.dumps(snap)}")
    if snap != {"devices": 1, "mesh": None, "degraded": True, "reason": "single device"} \
            or counter_value("juicefs_torch_shard_degraded") != 0:
        raise AssertionError(f"the process plane is not the one-card rung: {snap} "
                             "(phases 5-13 gate one launch per hash batch on it)")
    return snap


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
        launches = launch_counts()
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
        if scan["shard"] != sharding.get_plane().snapshot():
            raise AssertionError(f"gc --dedup ran off the process plane: {scan['shard']}")
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


def time_queued(fn, runs: int = 5) -> tuple[float, float]:
    """Median device ms of one fn(i), and the longest host time to queue
    one run's calls: each run queues QUEUED calls behind a spin of the card
    (torch.cuda._sleep), so the events bracket the device's work back to
    back, not the host's launches."""
    times, enqueue = [], []
    for r in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for i in range(QUEUED):
            fn(r * QUEUED + i)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / QUEUED)
    return statistics.median(times), max(enqueue)


def timing_phase(gen: torch.Generator, smi: str) -> dict:
    """Both row-chain epilogues and the combine at TIMING_BLOCKS, each
    beside its bound and its plain version. Device ms
    come from `time_queued` on inputs cycling through COLD_BYTES (L2 cold,
    as a batch just uploaded over PCIe would be at 32 blocks and up); the
    plain versions, one states-epilogue call (`row_chain_call_ms`, its
    host launch included) and one whole hash call (`call_ms`: lane digests
    + combine, as a batch runs them) from `time_cuda` around single calls."""
    phase("kernel time")
    m = BLOCK_BYTES // LANE_BYTES
    spin_ms = time_cuda(lambda i: torch.cuda._sleep(SPIN_CYCLES), 3)
    sizes, worst_enqueue = {}, 0.0
    for blocks in TIMING_BLOCKS:
        n = blocks * m
        copies = max(1, -(-COLD_BYTES // (n * LANE_BYTES)))
        pool = random_words(gen, n * copies).reshape(copies, n, ROWS, COLS)
        counts = torch.full((blocks,), m, dtype=torch.int64, device="cuda")
        lengths = torch.full((blocks,), BLOCK_BYTES, dtype=torch.int64, device="cuda")
        acc = hash_torch.chain_digests(pool[0], m).reshape(blocks, m, 8)
        hash_torch.row_chain(pool[0], m, 1)  # warm-up
        torch.cuda.synchronize()
        row = {"lanes": n}
        for name, fn in (
                ("row_chain", lambda i: hash_torch.row_chain(pool[i % copies], m, 0x1000 + i)),
                ("lane_digests",
                 lambda i: hash_torch.chain_digests(pool[i % copies], m, 0x1000 + i)),
                ("combine", lambda i: hash_torch.combine(acc, counts, lengths))):
            row[f"{name}_ms"], enq = time_queued(fn)
            worst_enqueue = max(worst_enqueue, enq)
        # one states-epilogue call bracketed from the host (launch included)
        row["row_chain_call_ms"] = time_cuda(
            lambda i: hash_torch.row_chain(pool[i % copies], m, 0x4000 + i), 10)
        row["call_ms"] = time_cuda(lambda i: hash_torch.combine(hash_torch.lane_digests(
            pool[i % copies].view(blocks, m, ROWS, COLS), i), counts, lengths), 5)
        row["row_chain_plain_ms"] = time_cuda(
            lambda i: hash_torch.row_chain_ref(pool[0], m, 0x2000 + i), 3)
        row["lane_digests_plain_ms"] = time_cuda(
            lambda i: hash_torch.chain_digests_ref(pool[0], m, 0x2000 + i), 3)
        row["combine_plain_ms"] = time_cuda(
            lambda i: hash_torch.combine_accs(acc, counts, lengths), 3)
        row["row_chain_bound_ms"], row["row_chain_bound_by"] = row_chain_bound_ms(n, smi)
        row["lane_digests_bound_ms"], row["lane_digests_bound_by"] = row_chain_bound_ms(
            n, smi, DIGEST_BYTES)
        row["combine_bound_ms"], row["combine_bound_by"] = combine_bound_ms(counts, m, smi)
        sizes[blocks] = row
        print(f"{blocks} blocks ({n} lanes): row_chain {row['row_chain_ms']:.4f} ms (bound "
              f"{row['row_chain_bound_ms']:.4f}, {row['row_chain_bound_ms'] / row['row_chain_ms']:.3f}"
              f" of it; plain {row['row_chain_plain_ms']:.3f}); lane_digests "
              f"{row['lane_digests_ms']:.4f} ms (bound {row['lane_digests_bound_ms']:.4f}, "
              f"{row['lane_digests_bound_ms'] / row['lane_digests_ms']:.3f} of it; plain "
              f"{row['lane_digests_plain_ms']:.3f}); combine {row['combine_ms']:.4f} ms (bound "
              f"{row['combine_bound_ms']:.6f}, {row['combine_bound_by']}; plain "
              f"{row['combine_plain_ms']:.3f}); one hash call {row['call_ms']:.4f} ms")
        del pool, acc
    big = sizes[TIMING_BLOCKS[-1]]
    out = {
        "sizes": sizes, "spin_ms": spin_ms, "enqueue_ms": worst_enqueue,
        "lanes": TIMING_LANES,
        "ms": big["row_chain_ms"],
        "gibs": TIMING_LANES * LANE_BYTES / (1 << 30) / (big["row_chain_ms"] / 1e3),
        "plain_ms": big["row_chain_plain_ms"],
        "bound_ms": big["row_chain_bound_ms"],
        "bound_by": big["row_chain_bound_by"],
        "hbm_bytes_per_s": hbm_bytes_per_s(smi),
    }
    if worst_enqueue >= spin_ms:
        raise AssertionError(f"queueing {QUEUED} calls took {worst_enqueue:.3f} ms, longer "
                             f"than the {spin_ms:.3f} ms spin: the device times hold host gaps")
    print(f"row_chain 1 GiB ({TIMING_LANES} lanes): {out['ms']:.4f} ms = "
          f"{out['gibs']:.2f} GiB/s; plain {out['plain_ms']:.3f} ms; bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}, {out['hbm_bytes_per_s'] / 1e12} TB/s) "
          f"= {out['bound_ms'] / out['ms']:.3f} of bound; {QUEUED} calls queued in at most "
          f"{worst_enqueue:.3f} ms behind a {spin_ms:.3f} ms spin; card {smi}")
    print("kernel_times " + json.dumps(out))
    return out


def compare_phase(gen: torch.Generator, smi: str, other: str, define: str | None) -> dict:
    """`--compare-row-chain DIR`: DIR's jth256_row_chain.cu (another
    checkout's row chain with the same C entry, e.g. an earlier commit
    unpacked with `git archive`, or this one built with the macro
    `define`, NAME=VALUE) built beside this one and timed against
    this checkout's states epilogue at TIMING_BLOCKS, in turns (other,
    this, this, other) by `time_queued` and by one host call (`time_cuda`,
    launch included); both must give the same states."""
    import ctypes

    phase(f"row chain vs {other}" + (f" built with {define}" if define else ""))
    kdir = os.path.join(other, "juicefs_tpu_torch", "gpu", "kernels")
    out_dir = os.path.join(kernels.BUILD_DIR, "compare")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"libjth256_row_chain_other{os.getpid()}.so")
    macro = [f"-D{define}"] if define else []
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, *macro, "-I", kdir, "-o", so,
                           os.path.join(kdir, "jth256_row_chain.cu")],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise AssertionError(f"nvcc failed on {kdir}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(so).jth256_row_chain
    fn.argtypes = kernels._SIGNATURES["jth256_row_chain"]
    fn.restype = ctypes.c_int
    m = BLOCK_BYTES // LANE_BYTES

    def run_other(words, tweak):
        out = torch.empty((words.shape[0], COLS), dtype=torch.int32, device="cuda")
        rc = fn(words.data_ptr(), out.data_ptr(), words.shape[0], m, 0, tweak & MASK,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise AssertionError(f"the other row chain's launch failed: CUDA error {rc}")
        return out

    rows = {}
    for blocks in TIMING_BLOCKS:
        n = blocks * m
        copies = max(1, -(-COLD_BYTES // (n * LANE_BYTES)))
        pool = random_words(gen, n * copies).reshape(copies, n, ROWS, COLS)
        if max_abs_err(run_other(pool[0], 7), hash_torch.row_chain(pool[0], m, 7)) != 0:
            raise AssertionError(f"{blocks} blocks: the two row chains disagree")
        fns = {"other": lambda i: run_other(pool[i % copies], 0x5000 + i),
               "this": lambda i: hash_torch.row_chain(pool[i % copies], m, 0x5000 + i)}
        row = {k: [] for k in ("other_ms", "this_ms", "other_call_ms", "this_call_ms")}
        for who in ("other", "this", "this", "other"):
            row[f"{who}_ms"].append(time_queued(fns[who])[0])
            row[f"{who}_call_ms"].append(time_cuda(fns[who], 10))
        bound, _ = row_chain_bound_ms(n, smi)
        rows[blocks] = {**row, "bound_ms": bound}
        print(f"{blocks} blocks: other {row['other_ms'][0]:.4f} / {row['other_ms'][1]:.4f} ms, "
              f"this {row['this_ms'][0]:.4f} / {row['this_ms'][1]:.4f} ms (queued); one call: "
              f"other {row['other_call_ms'][0]:.4f} / {row['other_call_ms'][1]:.4f}, this "
              f"{row['this_call_ms'][0]:.4f} / {row['this_call_ms'][1]:.4f}; bound {bound:.4f} ms; "
              f"card {smi}")
        del pool
    print("row_chain_compare " + json.dumps(rows))
    return rows


def batch_breakdown_phase(rng: np.random.Generator) -> dict:
    """Where one main-path hash batch (32 x 4 MiB blocks) spends its time:
    host packing into the pinned slot, the upload, then the hash as the
    main path runs it (the lane-digests launch and the combine launch) and,
    beside it, the states epilogue with the plain torch fold, each timed
    alone (median of 5)."""
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
    dcounts = torch.from_numpy(counts.astype(np.int64)).cuda()
    dlengths = torch.from_numpy(lengths.astype(np.int64)).cuda()
    hash_torch.hash_device(dev, dcounts, dlengths)
    lane_digests_ms = time_cuda(lambda i: hash_torch.lane_digests(dev, i), 5)
    acc = hash_torch.lane_digests(dev)
    combine_ms = time_cuda(lambda i: hash_torch.combine(acc, dcounts, dlengths), 5)
    hash_ms = time_cuda(lambda i: hash_torch.hash_device(dev, dcounts, dlengths, i), 5)
    t0 = time.perf_counter()
    got = hash_torch.hash_device(dev, dcounts, dlengths)
    hash_enqueue_ms = (time.perf_counter() - t0) * 1e3  # host time to queue both launches
    torch.cuda.synchronize()
    flat = dev.reshape(n * m, ROWS, COLS)
    hash_torch.row_chain(flat, m, 0)
    kernel_ms = time_cuda(lambda i: hash_torch.row_chain(flat, m, i), 5)
    states = hash_torch.row_chain(flat, m, 0).reshape(n, m, COLS)
    fold = lambda i: hash_torch.combine_accs(hash_torch.lane_accs(states), dcounts, dlengths)
    want = fold(0)
    fold_ms = time_cuda(fold, 5)
    t0 = time.perf_counter()
    fold(0)
    enqueue_ms = (time.perf_counter() - t0) * 1e3  # host time to queue the plain fold
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("hash_device != row_chain + the plain fold on the batch")
    out = {"blocks": n, "pack_ms": statistics.median(pack_ms), "h2d_ms": h2d_ms,
           "lane_digests_ms": lane_digests_ms, "combine_ms": combine_ms, "hash_ms": hash_ms,
           "hash_enqueue_ms": hash_enqueue_ms, "kernel_ms": kernel_ms, "fold_ms": fold_ms,
           "fold_enqueue_ms": enqueue_ms}
    print("batch_breakdown " + json.dumps(out))
    return out


INGEST_STAGES = ("chunk.ingest.pack", "chunk.ingest.hash", "chunk.ingest.lookup",
                 "chunk.ingest.register", "chunk.upload.compress", "chunk.upload.put")


def counter_value(name: str) -> float:
    return global_registry()._metrics[name].value


def counter_total(name: str) -> float:
    """A counter's value summed over its labelled series."""
    return sum(s.value for s in global_registry()._metrics[name]._series())


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
        if store.ingest._batcher.pipe.plane is not sharding.get_plane():
            raise AssertionError("inline ingest does not hash on the process plane")

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
        launches = launch_counts()
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
        scan_launches = launch_counts()
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


def cli(argv: list[str], echo_lines: int = 0) -> tuple[int, str, list[str]]:
    """Run one port CLI command as a user would; echo (its first
    `echo_lines` lines of output, 0 = all) and return its rc, stdout and
    the ERROR records of its loggers. cmd.main logs and returns 1 on an
    exception, so every caller checks the rc."""
    buf, rec = io.StringIO(), _Records()
    log = logging.getLogger("cmd")
    log.addHandler(rec)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cmd.main(argv)
    finally:
        log.removeHandler(rec)
    out = buf.getvalue()
    shown = [a if "://" not in a else a.split("://", 1)[0] + "://..." for a in argv]
    shown_out = out.rstrip()
    if echo_lines and shown_out.count("\n") >= echo_lines:
        shown_out = "\n".join(shown_out.splitlines()[:echo_lines] + ["..."])
    print(f"$ {' '.join(shown)}\n{shown_out}\n(rc {rc})")
    for msg in rec.messages:
        print(f"  log: {msg}")
    return rc, out, rec.messages


def format_device_volume(meta_url: str, base: str, name: str) -> None:
    """`format --compress lz4 --hash-backend pallas` of a sqlite3:// +
    file:// volume under `base`."""
    rc, _out, _ = cli(["format", meta_url, name, "--storage", "file", "--bucket",
                       os.path.join(base, "blob"), "--compress", "lz4",
                       "--hash-backend", "pallas", "--trash-days", "0"])
    if rc != 0:
        raise AssertionError(f"format rc {rc}")


def launches(lanes: int = 1) -> int:
    """Row-chain launches since the last reset, checked against the fold's.
    Every one of them ran the lane-digests epilogue, and every hash batch
    ran one combine per data row: on one card one combine per row chain,
    on a mesh of `lanes` lane shards one per `lanes` row chains. The fold
    last ran in the kernels, never as the plain torch fold."""
    torch.cuda.synchronize()
    n = kernels.LAUNCHES["jth256_row_chain"]
    digests = kernels.LAUNCHES["jth256_lane_digests"]
    combines = kernels.LAUNCHES["jth256_combine"]
    if digests != n or combines * lanes != n:
        raise AssertionError(f"{n} row-chain launches, {digests} with the lane-digests "
                             f"epilogue, {combines} combines: want every row chain to fold "
                             f"its lanes and one combine per {lanes} of them")
    if n and hash_torch.last_fold_mode() != "cuda":
        raise AssertionError(f"the fold last ran as {hash_torch.last_fold_mode()!r}, "
                             "not in the kernels")
    return n


def launch_counts() -> dict:
    """kernels.LAUNCHES since the last reset, after `launches()` checked them."""
    launches()
    return dict(kernels.LAUNCHES)


def gauge_launches(text: str) -> dict:
    """Each kernel's `juicefs_torch_kernel_launches` in another process's
    metrics text."""
    return {k: int(stats_value(text, f'juicefs_torch_kernel_launches{{kernel="{k}"}}'))
            for k in kernels.LAUNCHES}


def stage_count(name: str) -> int:
    return stage_metrics_snapshot().get(name, {"count": 0})["count"]


def close_meta(m) -> None:
    """Close a meta client's database handle: the kv engine's client, or
    the sql engine's connection on this thread."""
    if hasattr(m, "client"):
        m.client.close()
    elif getattr(m._tlocal, "conn", None) is not None:
        m._tlocal.conn.close()
        m._tlocal.conn = None


def indexed_write(meta_url: str, blocks: list, name: bytes) -> dict:
    """Every block its own slice of one file `name`, written through
    `build_store` with its BlockIndexer on the card; gates: no indexer
    errors, indexed + dropped == written, one launch per index batch.
    Returns the indexer stats, the write's seconds, batches and launches,
    the digest rows by block key and the block keys in write order."""
    bs = BLOCK_BYTES
    m, fmt = cmd.open_meta(meta_url)
    store = cmd.build_store(fmt, None, meta=m)
    try:
        if store.indexer is None or store.indexer.backend != "cuda":
            raise AssertionError("build_store attached no cuda BlockIndexer")
        ctx = Context(uid=0, gid=0)
        st, ino, _ = m.create(ctx, 1, name, 0o644)
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
        if m.close(ctx, ino) != 0:
            raise AssertionError("close of the written file failed")
        nbytes = sum(len(b) for b in blocks)
        print(f"indexed write of {len(blocks)} blocks ({nbytes / (1 << 30):.4f} GiB) in "
              f"{write_s:.3f} s = {nbytes / (1 << 30) / write_s:.4f} GiB/s; indexer "
              f"{json.dumps(ix)}; {index_batches} index batches, {index_launches} launches")
        if ix["errors"] != 0:
            raise AssertionError(f"indexer errors {ix['errors']}")
        if ix["blocks"] + ix["dropped"] != len(blocks):
            raise AssertionError(f"indexer blocks {ix['blocks']} + dropped {ix['dropped']} "
                                 f"!= {len(blocks)} uploaded")
        if index_batches == 0 or index_launches != index_batches:
            raise AssertionError(f"{index_launches} launches for {index_batches} index batches")
        rows = {block_key(sid, indx, bsize): d
                for sid, indx, bsize, d in m.scan_block_digests()}
        order = [block_key(s.id, 0, s.size) for s in
                 sorted((s for sl in m.list_slices().values() for s in sl),
                        key=lambda s: s.id)]
    finally:
        store.close()
        close_meta(m)
    return {"indexer": ix, "seconds": write_s, "gibs": nbytes / (1 << 30) / write_s,
            "index_batches": index_batches, "launches": index_launches, "rows": rows,
            "order": order}


def dedup_gc(meta_url: str, written: dict, blocks: list, planted: int,
             index_path: str, lost: int = 0) -> tuple[dict, float, int]:
    """`gc --dedup` after an indexed write, with every `lost`-th of the
    indexer's digest rows deleted first (0: none), as a client without an
    indexer loses them; gates: no leak, the index trusted (from_index ==
    the rows left), exactly the dropped and deleted blocks hashed, in one
    launch per 32, the planted duplicates found, sampled index entries ==
    the numpy spec, and the deleted rows written back equal. Returns gc's
    counts, its seconds and launches."""
    ix, order = written["indexer"], written["order"]
    gone = sorted(written["rows"])[::lost] if lost else []
    if gone:
        m = new_client(meta_url)
        m.delete_block_digests([parse_block_key(k)[:2] for k in gone])
        close_meta(m)
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
    missing = ix["dropped"] + len(gone)
    want = {"from_index": ix["blocks"] - len(gone), "hashed_now": missing,
            "duplicate_blocks": planted, "blocks": len(blocks)}
    got = {k: gc[k] for k in want}
    if got != want or gc_launches != -(-missing // 32):
        raise AssertionError(f"gc {got} != {want}, or {gc_launches} launches for "
                             f"{missing} blocks missing from the index")
    index = json.load(open(index_path))
    for key in order[:: max(1, len(blocks) // 8)][:8]:
        if index[key] != jth256(blocks[order.index(key)]).hex():
            raise AssertionError(f"{key}: dedup index digest != numpy spec")
    if gone:
        m = new_client(meta_url)
        rows = {block_key(sid, indx, bsize): d
                for sid, indx, bsize, d in m.scan_block_digests()}
        close_meta(m)
        if {k: rows.get(k) for k in written["rows"]} != written["rows"]:
            raise AssertionError(f"gc's backfill of {len(gone)} deleted rows != the "
                                 "indexer's rows")
    return gc, gc_s, gc_launches


def verified_fsck(meta_url: str, n_blocks: int, hash_path: str = "") -> tuple[float, int]:
    """`fsck --verify-data`; gates: every block verified on the card in one
    launch per 32 blocks with 0 mismatches. Returns its seconds and
    launches."""
    argv = ["fsck", meta_url, "--verify-data"] + (["--hash-index", hash_path]
                                                  if hash_path else [])
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc, out, _ = cli(argv)
    fsck_s = time.perf_counter() - t0
    fsck_launches = launches()
    if rc != 0 or f"verified {n_blocks} blocks (cuda)" not in out \
            or "0 digest mismatches" not in out:
        raise AssertionError(f"fsck rc {rc}")
    if fsck_launches != -(-n_blocks // 32):
        raise AssertionError(f"fsck: {fsck_launches} launches, want {-(-n_blocks // 32)}")
    return fsck_s, fsck_launches


def planted_bitrot(meta_url: str, objects, victim: str, rng: np.random.Generator,
                   compress: str = "none") -> bytes:
    """Overwrite one block object with other bytes of its size, stored as
    the volume stores blocks (`compress`); the next `fsck --verify-data`
    must report exactly that block. Returns the original object."""
    original = bytes(objects.get(victim))
    objects.put(victim, new_compressor(compress).compress(
        rng.bytes(parse_block_key(victim)[2])))
    rc, out, errors = cli(["fsck", meta_url, "--verify-data"])
    mismatched = [e for e in errors if "digest mismatch" in e]
    if rc != 1 or "1 digest mismatches" not in out or len(mismatched) != 1 \
            or victim not in mismatched[0]:
        raise AssertionError(f"bitrot: rc {rc}, mismatch records {mismatched}, "
                             f"want 1 naming {victim}")
    return original


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
    try:
        # 1. format: a device hash backend probes the card (or fails)
        rc, out, _ = cli(["format", meta_url, "smoke", "--storage", "file", "--bucket",
                          os.path.join(base, "blob"), "--compress", "none",
                          "--hash-backend", "pallas", "--trash-days", "0"])
        if rc != 0 or kind not in out:
            raise AssertionError(f"format rc {rc}; probe line must name {kind}")

        # 2. indexed write: one file, each block its own slice
        written = indexed_write(meta_url, blocks, b"smoke.bin")
        ix, indexed_rows, order = written["indexer"], written["rows"], written["order"]

        # 3. gc --dedup: trusts the index, backfills what the indexer dropped
        index_path = os.path.join(base, "dedup-index.json")
        gc, gc_s, gc_launches = dedup_gc(meta_url, written, blocks, planted, index_path)
        index = json.load(open(index_path))
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
        fsck_s, fsck_launches = verified_fsck(meta_url, n_blocks, hash_path)
        if json.load(open(hash_path)) != index:
            raise AssertionError("fsck hash index != gc dedup index")
        fsck_gibs = nbytes / (1 << 30) / fsck_s
        # planted bitrot: other bytes of the same size under one block key
        victim = order[n_blocks // 2]
        _m, fmt = cmd.open_meta(meta_url)
        _m.client.close()
        planted_bitrot(meta_url, cmd.storage_for(fmt), victim, rng)

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
              f"{written['index_batches']} batches ({ix['dropped']} dropped, {ix['errors']} "
              f"errors), one launch per batch; gc from_index {gc['from_index']}, hashed_now "
              f"{gc['hashed_now']}, {planted} duplicates, sampled index == spec, "
              f"{len(lost)} lost rows backfilled on the card; fsck "
              f"verified {n_blocks} blocks in {fsck_launches} launches, 0 mismatches, then "
              f"exactly {victim}; reopened meta rows == indexer rows")
        print(f"main path: write {written['gibs']:.4f} GiB/s; gc --dedup {gc_s:.3f} s "
              f"({gc['from_index']} blocks from the index, {gc['hashed_now']} read and "
              f"hashed), {backfill_s:.3f} s to backfill {len(lost)} lost rows "
              f"({backfill['gibs']} GiB/s over the volume); fsck --verify-data {fsck_gibs:.4f} GiB/s ({fsck_s:.3f} s); "
              f"indexer busy {ix['busy_seconds']} s = {ix['hash_mib_s']} MiB/s")
        return {"blocks": n_blocks, "write_gibs": written["gibs"], "gc_seconds": gc_s,
                "backfill_seconds": backfill_s, "backfilled": len(lost),
                "fsck_gibs": fsck_gibs, "indexer": ix,
                "index_batches": written["index_batches"],
                "launches": {"index": written["launches"], "gc": gc_launches,
                             "fsck": fsck_launches},
                "gc": gc}
    finally:
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
        format_device_volume(meta_url, base, "serve")

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

        # stop the gateway, close its vfs, store (the indexer drains) and
        # session; the indexer's counts are read after the drain, so blocks
        # still queued at the stop are counted
        gw.stop()
        vfs.close()
        store.close()
        ix = store.indexer.stats()
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


def fuse_mounter() -> str:
    """How the port's `fuse.mount` mounts on this host: the setuid
    fusermount handshake where it exists, else mount(2) as root. A host
    with neither cannot run phase 13."""
    if not os.path.exists("/dev/fuse"):
        raise AssertionError("no /dev/fuse: this host cannot mount FUSE")
    if shutil.which("fusermount"):
        return "fusermount"
    if os.geteuid() != 0:
        raise AssertionError("no fusermount, and not root: this host cannot mount FUSE")
    return "mount(2)"


class MountDrive:
    """One in-process mount of a volume through `cmd.mount.start_mount`,
    served on a thread; files are written and read with plain
    open/write/read through the kernel."""

    def __init__(self, argv: list[str]):
        parser = argparse.ArgumentParser()
        mount_cmd.add_parser(parser.add_subparsers())
        self.args = parser.parse_args(["mount", *argv])
        self.mp = self.args.mountpoint
        self.mounted = mount_cmd.start_mount(self.args)
        self._thread = threading.Thread(target=self.mounted.srv.serve, daemon=True,
                                        name="smoke-fuse-serve")
        self._thread.start()
        deadline = time.time() + 60
        while not os.path.ismount(self.mp):
            if time.time() > deadline:
                raise AssertionError(f"{self.mp} did not come up as a mount")
            time.sleep(0.05)

    def write_file(self, name: str, pieces: list) -> None:
        """Write the pieces in order, fsync, close."""
        fd = os.open(os.path.join(self.mp, name), os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            for piece in pieces:
                view = memoryview(piece)
                while view:
                    view = view[os.write(fd, view):]
            os.fsync(fd)
        finally:
            os.close(fd)

    def read_file(self, name: str, size: int) -> bytes:
        """The file's bytes, read in 1 MiB pieces after a size check."""
        path = os.path.join(self.mp, name)
        if os.stat(path).st_size != size:
            raise AssertionError(f"{name}: size {os.stat(path).st_size}, want {size}")
        out = bytearray()
        with open(path, "rb", buffering=0) as f:
            while True:
                got = f.read(1 << 20)
                if not got:
                    return bytes(out)
                out += got

    def umount(self, via_cli: bool = False) -> int:
        """Unmount (through the `umount` subcommand with `via_cli`), wait
        for the request loops, then close the vfs, the store and the
        session. Returns umount's rc (0 for the in-process unmount)."""
        rc = 0
        if via_cli:
            rc = cli(["umount", self.mp])[0]
        else:
            self.mounted.srv.unmount()
        self._thread.join(120)
        if self._thread.is_alive():
            raise AssertionError("the FUSE server did not stop")
        self.mounted.close()
        self.mounted.meta.client.close()
        return rc


def fuse_ops(method: str) -> int:
    """vfs operations of one kind so far: one per FUSE request of it."""
    return global_registry()._metrics["juicefs_fuse_ops_durations_histogram_seconds"] \
        .labels(method).total


def stats_value(text: str, name: str) -> float:
    m = re.search(r"^%s (\S+)$" % re.escape(name), text, re.M)
    return float(m[1]) if m else 0.0


def mount_cli_run(meta_url: str, mp: str, block: bytes) -> dict:
    """`python -m juicefs_tpu_torch.cmd mount META MP --inline-dedup` as a
    process: two files holding one 4 MiB block must move the mount's
    `juicefs_ingest_put_elided` by at least 1 (read from `MP/.stats`);
    `umount` returns 0 and so does the process."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "juicefs_tpu_torch.cmd", "mount", meta_url, mp,
         "--inline-dedup", "--no-dedup-bypass", "--no-kernel-writeback", "--no-watchdog"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    rc_umount = None
    try:
        deadline = time.time() + 180
        while not os.path.ismount(mp):
            if proc.poll() is not None or time.time() > deadline:
                raise AssertionError(f"mount process did not come up: {proc.poll()}\n"
                                     + (proc.stdout.read()[-2000:] if proc.poll() is not None
                                        else ""))
            time.sleep(0.1)
        ready_s = time.perf_counter() - t0
        before = open(os.path.join(mp, ".stats")).read()
        for name in ("cli-a.bin", "cli-b.bin"):
            with open(os.path.join(mp, name), "wb") as f:
                f.write(block)
                f.flush()
                os.fsync(f.fileno())
        after = open(os.path.join(mp, ".stats")).read()
        for name in ("cli-a.bin", "cli-b.bin"):
            if open(os.path.join(mp, name), "rb").read() != block:
                raise AssertionError(f"mount process: {name} reads back other bytes")
        elided = (stats_value(after, "juicefs_ingest_put_elided")
                  - stats_value(before, "juicefs_ingest_put_elided"))
        gauge = gauge_launches(after)
        process_launches = gauge["jth256_row_chain"]
        if not gauge["jth256_lane_digests"] == gauge["jth256_combine"] == process_launches:
            raise AssertionError(f"mount process: kernel launches {gauge}; want one "
                                 "lane-digests epilogue and one combine per row chain")
        umount_run = subprocess.run([sys.executable, "-m", "juicefs_tpu_torch.cmd", "umount", mp],
                                    cwd=repo, capture_output=True, text=True, timeout=120)
        rc_umount = umount_run.returncode
        umount_log = (umount_run.stdout + umount_run.stderr).strip().splitlines()
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=60)
            raise AssertionError(f"mount process still up 60 s after umount (rc {rc_umount}: "
                                 f"{umount_log}); SIGTERM ended it with {proc.returncode}\n"
                                 f"{out[-3000:]}")
    finally:
        if proc.poll() is None:
            fuse_umount(mp, lazy=True)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    if elided < 1 or rc_umount != 0 or proc.returncode != 0:
        raise AssertionError(f"mount process: put_elided moved {elided}, umount rc "
                             f"{rc_umount}, exit {proc.returncode}\n{out[-2000:]}")
    return {"ready_seconds": ready_s, "put_elided": elided, "launches": process_launches,
            "umount_log": umount_log}


def mount_phase(rng: np.random.Generator, volume_gib: float, smi: str) -> dict:
    """Phase 13: `mount --inline-dedup` of a `format --hash-backend pallas
    --compress lz4` sqlite3:// volume, written through FUSE by 4 writers,
    read back cold through a fresh mount, verified by `fsck`, then the
    subcommand as a process."""
    phase("mount: FUSE with --inline-dedup, cold read, fsck")
    t_phase = time.perf_counter()
    mounter = fuse_mounter()
    print("fuse transport: kernel")
    print(f"fuse mounted by: {mounter}")
    bs = BLOCK_BYTES
    per_file = 8  # 32 MiB files
    blocks, planted = plan_blocks(rng, max(per_file, int(volume_gib * (1 << 30)) // bs
                                           // per_file * per_file), bs, (1 << 20) + 7)
    files = {f"f{j:03d}.bin": blocks[per_file * j:per_file * (j + 1)]
             for j in range(len(blocks) // per_file)}
    files["tail.bin"] = blocks[-1:]
    n_blocks, nbytes = len(blocks), sum(len(b) for b in blocks)
    base = tempfile.mkdtemp(prefix="jfs-torch-mount-")
    meta_url = f"sqlite3://{base}/meta.db"
    mp = os.path.join(base, "mnt")
    os.makedirs(mp)
    # the takeover socket lives under XDG_RUNTIME_DIR: keep it in the run's
    # own temporary directory
    old_runtime = os.environ.get("XDG_RUNTIME_DIR")
    os.environ["XDG_RUNTIME_DIR"] = os.path.join(base, "run")
    argv = [meta_url, mp, "--inline-dedup", "--no-dedup-bypass", "--compress-backend",
            "cuda", "--cache-size", "1024", "--metrics", "127.0.0.1:0",
            "--no-watchdog", "--no-kernel-writeback"]
    drive = None
    try:
        format_device_volume(meta_url, base, "mount")

        # 1. writes: 4 writers, 1 MiB pieces, fsync and close per file
        drive = MountDrive(argv)
        store = drive.mounted.store
        if store.ingest is None or store.ingest.backend != "cuda" \
                or store.compress_plane.config.backend != "cuda" \
                or store.indexer is None or store.indexer.backend != "cuda":
            raise AssertionError("the mount's store has no cuda ingest stage, indexer or "
                                 "compress plane")
        names = list(files)
        batches0 = stage_count("gpu.index.batch")
        hashed0 = counter_value("juicefs_torch_blocks_hashed")
        stages0 = stage_metrics_snapshot()
        writes0 = fuse_ops("write")
        kernels.reset_launches()
        t0 = time.perf_counter()

        def writer(c: int) -> None:
            for name in names[c::4]:
                data = b"".join(files[name])
                drive.write_file(name, [data[i:i + (1 << 20)]
                                        for i in range(0, len(data), 1 << 20)])

        with ThreadPoolExecutor(4, thread_name_prefix="smoke-mount") as ex:
            list(ex.map(writer, range(4)))
        write_s = time.perf_counter() - t0
        store.ingest.flush()
        write_launches = launches()
        stages = stage_delta(stages0, stage_metrics_snapshot())
        ingest_batches = stages["chunk.ingest.hash"]["count"]
        index_batches = stage_count("gpu.index.batch") - batches0
        hashed = int(counter_value("juicefs_torch_blocks_hashed") - hashed0)
        st = store.ingest.stats()
        comp = st["compress"]
        ix = store.indexer.stats()
        metrics_port = drive.mounted.metrics_srv.port
        write_gibs = nbytes / (1 << 30) / write_s
        write_reqs = fuse_ops("write") - writes0
        print(f"mount write: {len(files)} files ({n_blocks} blocks, "
              f"{nbytes / (1 << 30):.4f} GiB, {planted} planted duplicates) from 4 writers "
              f"in {write_s:.3f} s = {write_gibs:.4f} GiB/s in {write_reqs} FUSE WRITEs "
              f"({nbytes / max(1, write_reqs):.0f} B each); {ingest_batches} ingest hash "
              f"batches ({hashed} blocks), {index_batches} index batches, {write_launches} "
              f"launches; metrics on port {metrics_port}; card {smi}")
        print("mount_ingest_stats " + json.dumps(st))
        print("mount_ingest_stage_seconds " + json.dumps(stages))
        drive.umount()
        drive = None

        if st["put_elided"] != planted or st["uploaded"] != n_blocks - planted:
            raise AssertionError(f"put_elided {st['put_elided']}, uploaded {st['uploaded']}; "
                                 f"planted {planted} of {n_blocks}")
        for k in ("passthrough", "errors", "race_collapsed"):
            if st[k] != 0:
                raise AssertionError(f"ingest {k} = {st[k]}, want 0")
        if comp["degraded"] != 0 or comp["estimated"] != hashed:
            raise AssertionError(f"compress plane {comp}: want degraded 0, estimated == "
                                 f"{hashed} hashed blocks")
        if ix["errors"] != 0:
            raise AssertionError(f"indexer errors {ix['errors']}")
        if ingest_batches == 0 or write_launches != ingest_batches + index_batches:
            raise AssertionError(f"{write_launches} launches for {ingest_batches} ingest + "
                                 f"{index_batches} index batches")
        m, fmt = cmd.open_meta(meta_url)
        n_objects = sum(1 for _ in cmd.storage_for(fmt).list_all("chunks/"))
        if n_objects != n_blocks - planted:
            raise AssertionError(f"{n_objects} objects stored, want {n_blocks - planted}")
        # index rows == numpy spec: a sample of 16 rows and every row of the
        # tail file; each file is one slice, so block i of it is its bytes
        rows = {(sid, indx): d for sid, indx, _b, d in m.scan_block_digests()}
        ctx = Context(uid=0, gid=0)
        checked = 0
        sample = set(int(i) for i in rng.choice(len(files) - 1, size=16))
        for j, (name, file_blocks) in enumerate(files.items()):
            if j not in sample and name != "tail.bin":
                continue
            st_, ino, _ = m.lookup(ctx, 1, name.encode())
            st_, slcs = m.read_chunk(ino, 0)
            if st_ or len(slcs) != 1:
                raise AssertionError(f"{name}: {len(slcs)} slices, want 1")
            for i, data in enumerate(file_blocks):
                if rows.get((slcs[0].id, i)) != jth256(data):
                    raise AssertionError(f"{name} block {i}: index row != numpy spec")
                checked += 1
        m.client.close()

        # 2. cold read through a fresh mount (new Server, vfs and store)
        drive = MountDrive(argv)
        reads0 = fuse_ops("read")
        kernels.reset_launches()
        t0 = time.perf_counter()
        wrong = []

        def reader(c: int) -> None:
            for name in names[c::4]:
                data = b"".join(files[name])
                if drive.read_file(name, len(data)) != data:
                    wrong.append(name)

        with ThreadPoolExecutor(4, thread_name_prefix="smoke-mount") as ex:
            list(ex.map(reader, range(4)))
        read_s = time.perf_counter() - t0
        read_launches = launches()
        drive.umount()
        drive = None
        if wrong:
            raise AssertionError(f"cold read differs for {wrong[:5]}")
        read_gibs = nbytes / (1 << 30) / read_s
        read_reqs = fuse_ops("read") - reads0
        print(f"mount cold read: {len(files)} files from 4 readers in {read_s:.3f} s = "
              f"{read_gibs:.4f} GiB/s in {read_reqs} FUSE READs, {read_launches} launches; "
              f"card {smi}")

        # 3. fsck --verify-data on the unmounted volume
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc, out, _ = cli(["fsck", meta_url, "--verify-data", "--compress-backend", "cuda"])
        fsck_s = time.perf_counter() - t0
        fsck_launches = launches()
        m_ = re.search(r"verified (\d+) blocks \((\w+)\)", out)
        verified = int(m_[1]) if m_ else 0
        if rc != 0 or "0 digest mismatches" not in out or verified == 0 \
                or fsck_launches != -(-verified // 32):
            raise AssertionError(f"fsck rc {rc}: {verified} blocks, {fsck_launches} launches")

        # 4. the subcommand as a process
        mp_cli = os.path.join(base, "mnt-cli")
        os.makedirs(mp_cli)
        proc = mount_cli_run(meta_url, mp_cli, rng.bytes(bs))
        print(f"mount process: ready in {proc['ready_seconds']:.3f} s, put_elided "
              f"+{proc['put_elided']:.0f}, {proc['launches']} launches; umount rc 0, exit 0; "
              f"umount said {proc['umount_log']}")
        print(f"gates ok: {planted} elided == planted, 0 passthrough/errors/degrade, "
              f"{hashed} of {hashed} hashed blocks estimated, {n_objects} objects == "
              f"unique blocks, "
              f"{write_launches} launches == {ingest_batches} ingest + {index_batches} index "
              f"batches, {checked} index rows == spec; cold read exact ({read_launches} "
              f"launches); fsck {verified} blocks, 0 mismatches, {fsck_launches} launches")
        print(f"mount (kernel, mounted by {mounter}): write {write_gibs:.4f} GiB/s, cold read "
              f"{read_gibs:.4f} GiB/s, fsck --verify-data {fsck_s:.3f} s; phase "
              f"{time.perf_counter() - t_phase:.3f} s; card {smi}")
        return {"mounter": mounter, "write_gibs": write_gibs, "read_gibs": read_gibs,
                "write_requests": write_reqs, "read_requests": read_reqs,
                "fsck_seconds": fsck_s, "ingest_batches": ingest_batches,
                "index_batches": index_batches, "stats": st,
                "launches": {"mount_ingest": write_launches, "mount_fsck": fsck_launches,
                             "mount_process": proc["launches"]}}
    finally:
        if drive is not None:
            try:
                drive.umount()
            except Exception as e:  # the phase already failed; report, go on
                print(f"mount phase teardown: {e}", file=sys.stderr)
        if old_runtime is None:
            os.environ.pop("XDG_RUNTIME_DIR", None)
        else:
            os.environ["XDG_RUNTIME_DIR"] = old_runtime
        shutil.rmtree(base, ignore_errors=True)


def shard_phase(rng: np.random.Generator, volume_gib: float, timing: dict,
                smi: str) -> dict:
    """Phase 14: the plane's programs on meshes that list the one card
    several times, held bit for bit against the one-card plane on one
    packed batch of phase 5's plan; sharded_scan_many at 1x1 and 2x2; the
    multichip run on the 2x2 mesh. Returns launches by path and times."""
    phase("shard: meshes over the card")
    t_phase = time.perf_counter()
    bs = BLOCK_BYTES
    blocks, planted = plan_blocks(rng, max(1, int(volume_gib * (1 << 30)) // bs), bs,
                                  3 * LANE_BYTES + 777)
    n = len(blocks)
    t0 = time.perf_counter()
    packed = pack_blocks(blocks, pad_lanes=bs // LANE_BYTES)
    print(f"packed {n} blocks ({packed[0].nbytes / (1 << 30):.4f} GiB of words, {planted} "
          f"planted duplicates) in {time.perf_counter() - t0:.3f} s")

    # the one-card plane's outputs, the reference of every mesh below
    one = sharding.get_plane()
    sp1 = one.put_packed(*packed)
    want_h = one.hash_packed(*sp1, n=n)
    want_d, want_dup, want_first = one.scan_packed(*sp1, n=n)
    want_est = one.make_estimator()(sp1[0], sp1[1])[:n]
    torch.cuda.synchronize()
    del sp1
    want_bytes = digests_to_bytes(want_h)
    for i in list(range(0, n, max(1, n // 8))) + [n - 1]:
        if want_bytes[i] != jth256(blocks[i]):
            raise AssertionError(f"block {i}: one-card digest != numpy spec")
    hdup, hfirst = dedup_digests(want_bytes)
    if int(want_dup.sum()) != planted or not (np.array_equal(want_dup, hdup)
                                               and np.array_equal(want_first, hfirst)):
        raise AssertionError(f"one-card scan: {int(want_dup.sum())} duplicates, "
                             f"planted {planted}")

    card = torch.device("cuda", 0)
    by_path = {"shard_hash": 0, "shard_scan": 0}
    # combines: one per data row per batch, on the row's lead device
    combine_by_path = {"shard_hash": 0, "shard_scan": 0}
    meshes = {}
    deg0 = counter_value("juicefs_torch_shard_degraded")
    for k in (2, 4, 8, 3):
        plane = sharding.ShardPlane([card] * k)
        snap = plane.snapshot()
        want_mesh = {2: {"data": 2, "lane": 1}, 4: {"data": 2, "lane": 2},
                     8: {"data": 4, "lane": 2}, 3: None}[k]
        if snap["mesh"] != want_mesh:
            raise AssertionError(f"[cuda:0] * {k}: mesh {snap['mesh']}, want {want_mesh}")
        ndev = k if plane.mesh is not None else 1
        lanes = snap["mesh"]["lane"] if snap["mesh"] else 1
        h2d0 = counter_value("juicefs_torch_shard_h2d_batches")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp = plane.put_packed(*packed)
        torch.cuda.synchronize()
        put_ms = (time.perf_counter() - t0) * 1e3
        if counter_value("juicefs_torch_shard_h2d_batches") != h2d0 + 1 or sp.batch != n:
            raise AssertionError(f"[cuda:0] * {k}: not one placement of {n} blocks")
        kernels.reset_launches()
        t0 = time.perf_counter()
        got_h = plane.hash_packed(*sp, n=n)
        hash_ms = (time.perf_counter() - t0) * 1e3
        hash_launches = launches(lanes)
        hash_combines = kernels.LAUNCHES["jth256_combine"]
        kernels.reset_launches()
        t0 = time.perf_counter()
        got_d, got_dup, got_first = plane.scan_packed(*sp, n=n)
        scan_ms = (time.perf_counter() - t0) * 1e3
        scan_launches = launches(lanes)
        scan_combines = kernels.LAUNCHES["jth256_combine"]
        t0 = time.perf_counter()
        got_est = plane.make_estimator()(sp[0], sp[1])[:n]
        torch.cuda.synchronize()
        est_ms = (time.perf_counter() - t0) * 1e3
        if hash_launches != ndev or scan_launches != ndev:
            raise AssertionError(f"[cuda:0] * {k}: {hash_launches} / {scan_launches} launches "
                                 f"for one hash / scan batch on {ndev} mesh devices")
        if not (np.array_equal(got_h, want_h) and np.array_equal(got_d, want_d)
                and np.array_equal(got_dup, want_dup)
                and np.array_equal(got_first, want_first)):
            raise AssertionError(f"[cuda:0] * {k}: digests or verdicts != the one-card plane")
        if not torch.equal(got_est, want_est):
            raise AssertionError(f"[cuda:0] * {k}: estimator != the one-card plane")
        by_path["shard_hash"] += hash_launches
        by_path["shard_scan"] += scan_launches
        combine_by_path["shard_hash"] += hash_combines
        combine_by_path["shard_scan"] += scan_combines
        meshes[k] = {"snapshot": snap, "put_ms": put_ms, "hash_ms": hash_ms,
                     "scan_ms": scan_ms, "estimate_ms": est_ms,
                     "launches": hash_launches + scan_launches}
        print(f"[cuda:0] * {k}: {json.dumps(snap)}; place {put_ms:.3f} ms, hash "
              f"{hash_ms:.3f} ms, scan {scan_ms:.3f} ms, estimate {est_ms:.3f} ms; "
              f"{hash_launches} + {scan_launches} launches ({hash_combines} + "
              f"{scan_combines} combines); == one-card plane")
        del sp
    if counter_value("juicefs_torch_shard_degraded") != deg0 + 1:
        raise AssertionError("the odd count must be the one counted degrade")

    # sharded_scan_many: the benchmark form, tweak k inside the kernel;
    # 256 blocks (1 GiB) split evenly over both meshes, so no pad row
    # enters the checksum
    n_even = n - n % 4
    sub = tuple(a[:n_even] for a in packed)
    many = {}
    for d, lane in ((1, 1), (2, 2)):
        mesh = sharding.make_mesh(d, lane, [card] * (d * lane))
        placed = sharding.shard_batch(mesh, *sub)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        chk = sharding.sharded_scan_many(mesh)(*placed, 10)
        ms = (time.perf_counter() - t0) * 1e3 / 10
        nl = launches(lane)
        combines = kernels.LAUNCHES["jth256_combine"]
        if nl != 10 * d * lane:
            raise AssertionError(f"scan_many {d}x{lane}: {nl} launches, want {10 * d * lane}")
        many[f"{d}x{lane}"] = {"checksum": chk, "ms_per_iter": ms, "launches": nl,
                               "combines": combines}
        del placed
    if many["1x1"]["checksum"] != many["2x2"]["checksum"]:
        raise AssertionError(f"sharded_scan_many checksums differ: {many}")
    by_path["shard_many"] = sum(v["launches"] for v in many.values())
    combine_by_path["shard_many"] = sum(v["combines"] for v in many.values())
    print(f"sharded_scan_many over {n_even} blocks, 10 iterations: checksum "
          f"{many['1x1']['checksum']:#010x} at 1x1 and 2x2; "
          f"{many['1x1']['ms_per_iter']:.3f} ms / iteration at 1x1, "
          f"{many['2x2']['ms_per_iter']:.3f} at 2x2 (phase 6 kernel alone: "
          f"{timing['sizes'][TIMING_BLOCKS[-1]]['lane_digests_ms']:.4f} ms per 1 GiB); "
          f"card {smi}")

    # the multichip run on the 2x2 mesh over the card, at the same size
    kernels.reset_launches()
    mc = dryrun_multichip([card] * 4, gib=volume_gib, block_mib=bs >> 20)
    total = launches(2)
    total_combines = kernels.LAUNCHES["jth256_combine"]
    scan_batches = -(-mc["blocks"] // 32)
    ingest_batches = mc["h2d_batches"] - scan_batches
    if mc["mesh"] != {"data": 2, "lane": 2} or mc["degraded"] or not mc["identity_ok"]:
        raise AssertionError(f"multichip: {mc}")
    ing = mc["ingest"]
    if ing["estimated"] != ing["hashed"] or ing["compress_degraded"] != 0:
        raise AssertionError(f"multichip estimator: {ing}")
    if mc["ingest"]["launches"] + mc["scan"]["launches"] != total \
            or mc["scan"]["launches"] != 4 * scan_batches \
            or mc["ingest"]["launches"] != 4 * ingest_batches or ingest_batches <= 0:
        raise AssertionError(f"multichip launches {mc['ingest']['launches']} + "
                             f"{mc['scan']['launches']} (of {total}) for {ingest_batches} "
                             f"ingest and {scan_batches} scan batches on 4 mesh devices")
    # each leg's combines, read at the leg's own ends by dryrun_multichip
    if mc["ingest"]["combines"] + mc["scan"]["combines"] != total_combines \
            or mc["scan"]["combines"] != 2 * scan_batches \
            or mc["ingest"]["combines"] != 2 * ingest_batches:
        raise AssertionError(f"multichip combines {mc['ingest']['combines']} + "
                             f"{mc['scan']['combines']} (of {total_combines}) for "
                             f"{ingest_batches} ingest and {scan_batches} scan batches "
                             "on 2 data rows")
    by_path["multichip_ingest"] = mc["ingest"]["launches"]
    by_path["multichip_scan"] = mc["scan"]["launches"]
    combine_by_path["multichip_ingest"] = mc["ingest"]["combines"]
    combine_by_path["multichip_scan"] = mc["scan"]["combines"]
    print(f"gates ok: meshes 2x1, 2x2, 4x2 == one-card plane bit for bit, odd count "
          f"degraded and counted, scan_many checksums equal; multichip 2x2: ingest "
          f"{mc['ingest']['gibs']} GiB/s in {ingest_batches} batches ({ing['estimated']} "
          f"of {ing['hashed']} hashed blocks estimated on the mesh), cold scan "
          f"{mc['scan']['gibs']} GiB/s, {mc['duplicate_blocks']} duplicates; phase "
          f"{time.perf_counter() - t_phase:.3f} s; card {smi}")
    return {"launches": by_path, "combine_launches": combine_by_path, "meshes": meshes,
            "scan_many": many, "multichip": mc}


def recording_indexer(sample_every: int):
    """A BlockIndexer subclass that keeps every indexer it builds and the
    raw bytes of each `sample_every`-th block submitted to it, so that the
    digests an indexer with no meta keeps in memory can be held against the
    numpy spec. Returns (the class, the list of indexers built)."""
    built = []

    class Recording(indexer_mod.BlockIndexer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.raw = {}
            built.append(self)

        def submit_raw(self, sid, indx, bsize, raw):
            if indx % sample_every == 0:
                self.raw[(sid, indx)] = bytes(raw)
            super().submit_raw(sid, indx, bsize, raw)

    return Recording, built


def start_gateway_on(meta_url: str):
    """The `gateway` subcommand's S3 gateway on a volume, in-process."""
    parser = argparse.ArgumentParser()
    gateway_cmd.add_parser(parser.add_subparsers())
    args = parser.parse_args(["gateway", meta_url, "--port", "0", "--access-key", SERVE_AK,
                              "--secret-key", SERVE_SK])
    return gateway_cmd.start_gateway(args)


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def objbench_phase(volume_gib: float, smi: str) -> dict:
    """Phase 15: `objbench` with the hash on the card over file://
    (BASELINE #5 at 1 GiB), then objbench over s3:// into the port's
    gateway on a `--hash-backend pallas` volume."""
    phase("objbench: file:// with --hash-backend pallas, then s3:// into the gateway")
    t_phase = time.perf_counter()
    mib = max(4, int(volume_gib * 1024) // 4 * 4)
    n = mib // 4
    base = tempfile.mkdtemp(prefix="jfs-torch-objbench-")
    gw = vfs = m = None
    real = indexer_mod.BlockIndexer
    recording, built = recording_indexer(sample_every=16)
    try:
        indexer_mod.BlockIndexer = recording
        batches0 = stage_count("gpu.index.batch")
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc, out, _ = cli(["objbench", f"file://{base}/ob", "--block-size", "4",
                          "--big-object-size", str(mib), "--compress", "lz4",
                          "--hash-backend", "pallas", "--threads", "4"])
        ob_s = time.perf_counter() - t0
        ob_launches = launches()
        index_batches = stage_count("gpu.index.batch") - batches0
        indexer_mod.BlockIndexer = real
        if rc != 0 or "functional: all checks passed" not in out:
            raise AssertionError(f"objbench rc {rc}")
        res = last_json(out)
        ix = res["hash"]
        if len(built) != 1 or ix["backend"] != "cuda" or ix["errors"] != 0 \
                or ix["blocks"] + ix["dropped"] != n:
            raise AssertionError(f"objbench hash {ix}: want cuda, 0 errors, indexed + "
                                 f"dropped == {n}")
        indexer = built[0]
        sampled = sorted(k for k in indexer.raw if k in indexer.digests)
        if len(indexer.digests) != ix["blocks"] or not sampled:
            raise AssertionError(f"{len(indexer.digests)} digests kept for {ix['blocks']} "
                                 f"blocks, {len(sampled)} sampled")
        for k in sampled:
            if indexer.digests[k] != jth256(indexer.raw[k]):
                raise AssertionError(f"objbench block {k}: digest != numpy spec")
        if index_batches == 0 or ob_launches != index_batches:
            raise AssertionError(f"{ob_launches} launches for {index_batches} index batches")
        del built[:], indexer

        # the functional suite and a 64 MiB objbench over s3:// (multipart and
        # abort included) into the gateway of a --hash-backend pallas volume
        meta_url = f"sqlite3://{base}/meta.db"
        format_device_volume(meta_url, base, "objbench")
        gw, vfs, m = start_gateway_on(meta_url)
        batches0 = stage_count("gpu.index.batch")
        kernels.reset_launches()
        rc, out, _ = cli(["objbench", f"s3://{SERVE_AK}:{SERVE_SK}@127.0.0.1:{gw.port}/bkt",
                          "--block-size", "4", "--big-object-size", "64", "--threads", "4"])
        gw.stop()
        vfs.close()
        vfs.store.close()  # drains the indexer
        s3_launches = launches()
        s3_batches = stage_count("gpu.index.batch") - batches0
        s3_ix = vfs.store.indexer.stats()
        gw = vfs = None
        m.close_session()
        m.client.close()
        m = None
        if rc != 0 or "functional: all checks passed" not in out \
                or last_json(out)["functional_failures"] != []:
            raise AssertionError(f"objbench over s3:// rc {rc}")
        s3 = last_json(out)
        if s3_ix["errors"] != 0 or s3_batches == 0 or s3_launches != s3_batches:
            raise AssertionError(f"gateway indexer {s3_ix}: {s3_launches} launches for "
                                 f"{s3_batches} index batches")
        print(f"gates ok: objbench functional passed over file:// and s3://; {ix['blocks']} "
              f"+ {ix['dropped']} dropped == {n} blocks hashed on the card with 0 errors, "
              f"{len(sampled)} sampled in-memory digests == spec, {ob_launches} launches == "
              f"index batches; the gateway indexed {s3_ix['blocks']} blocks "
              f"({s3_ix['dropped']} dropped) in {s3_launches} launches")
        print(f"objbench file:// {mib} MiB lz4: put {res['put_MiB_s']} MiB/s, get "
              f"{res['get_MiB_s']} MiB/s, small put {res['small_put_objs_s']} objects/s, hash "
              f"{ix['hash_mib_s']} MiB/s ({ix['busy_seconds']} s busy); s3:// 64 MiB: put "
              f"{s3['put_MiB_s']} MiB/s, get {s3['get_MiB_s']} MiB/s, small put "
              f"{s3['small_put_objs_s']} objects/s; command {ob_s:.3f} s, phase "
              f"{time.perf_counter() - t_phase:.3f} s; card {smi}")
        return {"file": res, "s3": s3, "s3_indexer": s3_ix,
                "launches": {"objbench_index": ob_launches,
                             "objbench_s3_gateway": s3_launches}}
    finally:
        indexer_mod.BlockIndexer = real
        if gw is not None:
            gw.stop()
        if vfs is not None:
            vfs.close()
            vfs.store.close()
        if m is not None:
            m.close_session()
        shutil.rmtree(base, ignore_errors=True)


def bench_phase(volume_gib: float, smi: str) -> dict:
    """Phase 16: `bench` (BASELINE #1) on an ordinary `mount` of a
    `--hash-backend pallas --compress lz4` sqlite3:// + file:// volume,
    through the kernel; every uploaded block goes to the mount's indexer."""
    phase("bench: `bench` on a mount of a --hash-backend pallas volume")
    t_phase = time.perf_counter()
    big_mib = max(4, int(volume_gib * 1024))
    base = tempfile.mkdtemp(prefix="jfs-torch-bench-")
    meta_url = f"sqlite3://{base}/meta.db"
    mp = os.path.join(base, "mnt")
    os.makedirs(mp)
    old_runtime = os.environ.get("XDG_RUNTIME_DIR")
    os.environ["XDG_RUNTIME_DIR"] = os.path.join(base, "run")
    drive = None
    try:
        format_device_volume(meta_url, base, "bench")
        drive = MountDrive([meta_url, mp, "--compress-backend", "cuda", "--no-watchdog"])
        store = drive.mounted.store
        if store.indexer is None or store.indexer.backend != "cuda" or store.ingest is not None:
            raise AssertionError("the mount's store has no cuda indexer, or an ingest stage")
        batches0 = stage_count("gpu.index.batch")
        uploads0 = stage_count("chunk.upload.put")
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc, out, _ = cli(["bench", mp, "--big-file-size", str(big_mib), "--json"])
        bench_s = time.perf_counter() - t0
        ix_store = store
        rc_umount = drive.umount(via_cli=True)
        drive = None
        bench_launches = launches()
        index_batches = stage_count("gpu.index.batch") - batches0
        written = stage_count("chunk.upload.put") - uploads0
        ix = ix_store.indexer.stats()
        if rc != 0:
            raise AssertionError(f"bench rc {rc}")
        res = last_json(out)
        if sorted(res) != ["big_read_MiB_s", "big_write_MiB_s", "small_read_files_s",
                           "small_write_files_s", "stat_files_s"] \
                or not all(v > 0 for v in res.values()):
            raise AssertionError(f"bench numbers {res}")
        if ix["errors"] != 0 or ix["blocks"] + ix["dropped"] != written or written == 0:
            raise AssertionError(f"indexer {ix}: want 0 errors, indexed + dropped == "
                                 f"{written} blocks written")
        if index_batches == 0 or bench_launches != index_batches:
            raise AssertionError(f"{bench_launches} launches for {index_batches} index "
                                 "batches")
        if rc_umount != 0:
            raise AssertionError(f"umount rc {rc_umount}")
        print(f"gates ok: bench rc 0, five numbers > 0; {ix['blocks']} + {ix['dropped']} "
              f"dropped == {written} blocks written, 0 errors; {bench_launches} launches == "
              f"index batches; umount rc 0")
        print(f"bench ({big_mib} MiB big file, through the kernel): {json.dumps(res)}; "
              f"indexer busy {ix['busy_seconds']} s = {ix['hash_mib_s']} MiB/s; command "
              f"{bench_s:.3f} s, phase {time.perf_counter() - t_phase:.3f} s; card {smi}")
        return {"bench": res, "indexer": ix, "blocks_written": written,
                "launches": {"bench_index": bench_launches}}
    finally:
        if drive is not None:
            try:
                drive.umount()
            except Exception as e:  # the phase already failed; report, go on
                print(f"bench phase teardown: {e}", file=sys.stderr)
        if old_runtime is None:
            os.environ.pop("XDG_RUNTIME_DIR", None)
        else:
            os.environ["XDG_RUNTIME_DIR"] = old_runtime
        shutil.rmtree(base, ignore_errors=True)


def webdav_process(meta_url: str):
    """`python -m juicefs_tpu_torch.cmd webdav` as a process with /metrics;
    returns (process, port, metrics port) once it listens."""
    port, mport = free_port(), free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "juicefs_tpu_torch.cmd", "webdav", meta_url, "--port",
         str(port), "--metrics", f"127.0.0.1:{mport}"],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    deadline = time.time() + 180
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"webdav process exited with {proc.wait()}")
        if "WebDAV listening on port" in line:
            return proc, port, mport
    proc.kill()
    raise AssertionError("webdav process did not start listening")


def settled_index_metrics(mport: int) -> tuple[int, int]:
    """(launches, index batches) of a serving process once its index queue
    is empty and the two counts agree (the indexer hashes asynchronously);
    fails after 120 s."""
    deadline = time.time() + 120
    last = None
    while time.time() < deadline:
        conn = http.client.HTTPConnection("127.0.0.1", mport, timeout=60)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
        gauge = gauge_launches(text)
        now = (gauge["jth256_row_chain"],
               int(stats_value(text, 'juicefs_torch_stage_seconds_count{layer="gpu",'
                                     'op="index",stage="batch"}')),
               int(stats_value(text, "juicefs_index_queue_blocks")),
               gauge["jth256_lane_digests"], gauge["jth256_combine"])
        # settled: one index batch per launch, one lane-digests epilogue
        # and one combine per row chain, and nothing queued
        if now == last and now[0] == now[1] == now[3] == now[4] and now[2] == 0:
            return now[0], now[1]
        last = now
        time.sleep(0.5)
    raise AssertionError(f"webdav process: launches, index batches, queue, lane-digests "
                         f"and combine launches {last}")


def sync_phase(rng: np.random.Generator, smi: str) -> dict:
    """Phase 17: `sync` (BASELINE #4) of 64 x 4 MiB objects from phase 5's
    plan (duplicates included) from file:// into the port's S3 gateway on a
    `--hash-backend pallas` volume, re-run, --check-all, a planted
    same-size overwrite; cluster mode with 2 worker processes; then from
    the gateway into the `webdav` subcommand run as a process."""
    phase("sync: file:// -> S3 gateway, cluster mode, S3 gateway -> webdav process")
    t_phase = time.perf_counter()
    bs = BLOCK_BYTES
    blocks, planted = plan_blocks(rng, 64, bs, 1)
    blocks.pop()
    n = len(blocks)
    nbytes = n * bs
    base = tempfile.mkdtemp(prefix="jfs-torch-sync-")
    src = os.path.join(base, "src")
    for i, data in enumerate(blocks):
        path = os.path.join(src, f"d{i % 4}", f"obj{i:03d}.bin")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
    keys = sorted(f"d{i % 4}/obj{i:03d}.bin" for i in range(n))
    gw = vfs = m = proc = None
    old_path = os.environ.get("PYTHONPATH")
    # bootstrapped workers run `python -m juicefs_tpu_torch.cmd`: wherever
    # the smoke was started from, they import this checkout
    os.environ["PYTHONPATH"] = REPO + (os.pathsep + old_path if old_path else "")
    try:
        meta_url = f"sqlite3://{base}/s3.db"
        format_device_volume(meta_url, base, "sync")
        gw, vfs, m = start_gateway_on(meta_url)
        s3 = f"s3://{SERVE_AK}:{SERVE_SK}@127.0.0.1:{gw.port}"
        batches0 = stage_count("gpu.index.batch")
        kernels.reset_launches()
        argv = ["sync", f"file://{src}", s3 + "/bkt", "--threads", "16"]
        t0 = time.perf_counter()
        rc, out, _ = cli(argv + ["--check-new"])
        sync_s = time.perf_counter() - t0
        first = last_json(out)
        if rc != 0 or first["copied"] != n or first["mismatch"] != 0:
            raise AssertionError(f"sync rc {rc}: {first}")
        rc, out, _ = cli(argv)
        if rc != 0 or last_json(out)["copied"] != 0:
            raise AssertionError(f"second sync rc {rc} copied {last_json(out)['copied']}")
        t0 = time.perf_counter()
        rc, out, _ = cli(argv + ["--check-all"])
        check_s = time.perf_counter() - t0
        checked = last_json(out)
        if rc != 0 or checked["checked"] != n or checked["mismatch"] != 0:
            raise AssertionError(f"--check-all rc {rc}: {checked}")
        victim = keys[n // 2]
        client = S3Client(gw.port, SERVE_AK, SERVE_SK)
        st, _, _ = client.call("PUT", f"/bkt/{victim}", body=rng.bytes(bs))
        client.close()
        rc, out, errors = cli(argv + ["--check-all"])
        bad = last_json(out)
        if st != 200 or rc != 1 or bad["mismatch"] != 1 or bad["checked"] != n \
                or not any(victim in e for e in errors):
            raise AssertionError(f"planted overwrite of {victim}: PUT {st}, rc {rc}, {bad}")

        # cluster mode: the manager launches 2 worker processes of the port
        t0 = time.perf_counter()
        rc, out, _ = cli(["sync", f"file://{src}", s3 + "/bkt2", "--manager-listen",
                          "127.0.0.1:0", "--worker-hosts", "localhost,localhost",
                          "--threads", "8"])
        cluster_s = time.perf_counter() - t0
        totals = last_json(out)
        if rc != 0 or totals["copied"] != n or totals["tasks_done"] != n \
                or totals["dispatched"] != n or totals["mismatch"] != 0:
            raise AssertionError(f"cluster sync rc {rc}: {totals}")

        # the gateway into the `webdav` subcommand, run as a process
        dav_url = f"sqlite3://{base}/dav.db"
        format_device_volume(dav_url, os.path.join(base, "dav"), "davsync")
        proc, port, mport = webdav_process(dav_url)
        t0 = time.perf_counter()
        rc, out, _ = cli(["sync", s3 + "/bkt", f"webdav://127.0.0.1:{port}/vol",
                          "--check-new", "--threads", "16"])
        dav_s = time.perf_counter() - t0
        dav = last_json(out)
        if rc != 0 or dav["copied"] != n or dav["mismatch"] != 0:
            raise AssertionError(f"sync into webdav rc {rc}: {dav}")
        dav_launches, dav_batches = settled_index_metrics(mport)
        proc.send_signal(signal.SIGTERM)
        dav_rc = proc.wait(timeout=120)
        proc.stdout.close()
        proc = None
        if dav_rc != 0 or dav_launches == 0:
            raise AssertionError(f"webdav process exit {dav_rc}, {dav_launches} launches")

        gw.stop()
        vfs.close()
        vfs.store.close()  # drains the indexer
        gw_launches = launches()
        gw_batches = stage_count("gpu.index.batch") - batches0
        ix = vfs.store.indexer.stats()
        gw = vfs = None
        m.close_session()
        m.client.close()
        m = None
        if ix["errors"] != 0 or gw_batches == 0 or gw_launches != gw_batches:
            raise AssertionError(f"gateway indexer {ix}: {gw_launches} launches for "
                                 f"{gw_batches} index batches")
        print(f"gates ok: {n} copied with --check-new, 0 mismatches; a second run copied 0; "
              f"--check-all checked {n}, 0 mismatches, then exactly {victim} (rc 1); "
              f"cluster of 2 worker processes copied {totals['copied']} of "
              f"{totals['dispatched']}; the webdav process took {dav['copied']} with 0 "
              f"mismatches and exited 0; gateway {gw_launches} launches == index batches "
              f"({ix['blocks']} indexed, {ix['dropped']} dropped), webdav process "
              f"{dav_launches} launches == {dav_batches} index batches")
        mib = nbytes / (1 << 20)
        print(f"sync {mib:.0f} MiB ({n} objects, {planted} planted duplicates) file:// -> "
              f"S3 gateway {mib / sync_s:.2f} MiB/s with --check-new ({sync_s:.3f} s); "
              f"--check-all {mib / check_s:.2f} MiB/s; cluster of 2 workers "
              f"{mib / cluster_s:.2f} MiB/s ({cluster_s:.3f} s); S3 gateway -> webdav process "
              f"{mib / dav_s:.2f} MiB/s with --check-new; phase "
              f"{time.perf_counter() - t_phase:.3f} s; card {smi}")
        return {"mib_s": mib / sync_s, "check_all_mib_s": mib / check_s,
                "cluster_mib_s": mib / cluster_s, "webdav_mib_s": mib / dav_s,
                "indexer": ix,
                "launches": {"sync_gateway": gw_launches, "sync_webdav": dav_launches}}
    finally:
        if old_path is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old_path
        if proc is not None:
            proc.kill()
            proc.wait()
            proc.stdout.close()
        if gw is not None:
            gw.stop()
        if vfs is not None:
            vfs.close()
            vfs.store.close()
        if m is not None:
            m.close_session()
        shutil.rmtree(base, ignore_errors=True)


def config_phase(rng: np.random.Generator, volume_gib: float, kind: str) -> dict:
    """Phase 18: a `--hash-backend cpu` volume whose blocks no indexer saw
    is switched by `config --hash-backend pallas` (which probes the card),
    and the next `gc --dedup` hashes every block on the card."""
    phase("config: --hash-backend cpu -> pallas, then gc --dedup on the card")
    t_phase = time.perf_counter()
    bs = BLOCK_BYTES
    blocks, planted = plan_blocks(rng, max(1, int(volume_gib * (1 << 30)) // bs), bs,
                                  (1 << 20) + 7)
    n_blocks = len(blocks)
    base = tempfile.mkdtemp(prefix="jfs-torch-config-")
    meta_url = f"sqlite3://{base}/meta.db"
    store = None
    try:
        rc, _out, _ = cli(["format", meta_url, "cfg", "--storage", "file", "--bucket",
                           os.path.join(base, "blob"), "--compress", "none",
                           "--hash-backend", "cpu", "--trash-days", "0"])
        if rc != 0:
            raise AssertionError(f"format rc {rc}")
        # every block its own slice of one file, from a client with no indexer
        m, fmt = cmd.open_meta(meta_url)
        store = cmd.build_store(fmt, None, meta=m, with_indexer=False)
        ctx = Context(uid=0, gid=0)
        st, ino, _ = m.create(ctx, 1, b"cfg.bin", 0o644)
        per_chunk = CHUNK_SIZE // bs
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
        store.close()
        store = None
        rows = len(list(m.scan_block_digests()))
        m.client.close()
        rc, out, _ = cli(["config", meta_url, "--hash-backend", "pallas"])
        if rc != 0 or kind not in out or last_json(out) != {"updated": ["hash_backend"]} \
                or rows != 0:
            raise AssertionError(f"config rc {rc}; probe line must name {kind}; {rows} "
                                 "index rows before gc")
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc, out, _ = cli(["gc", meta_url, "--dedup", "--threads", "16"])
        gc_s = time.perf_counter() - t0
        gc_launches = launches()
        gc = last_json(out)
        want = {"backend": "cuda", "blocks": n_blocks, "hashed_now": n_blocks,
                "duplicate_blocks": planted}
        if rc != 0 or {k: gc[k] for k in want} != want \
                or gc_launches != -(-n_blocks // 32):
            raise AssertionError(f"gc rc {rc}: {({k: gc[k] for k in want})} != {want}, "
                                 f"{gc_launches} launches for {n_blocks} blocks")
        print(f"gates ok: config probed {kind} and set hash_backend pallas; gc --dedup hashed "
              f"{n_blocks} blocks on the card in {gc_launches} launches (one per 32), "
              f"{planted} duplicates == planted")
        print(f"config: gc --dedup {gc_s:.3f} s ({gc['gibs']} GiB/s); phase "
              f"{time.perf_counter() - t_phase:.3f} s")
        return {"gc": gc, "gc_seconds": gc_s, "launches": {"config_gc": gc_launches}}
    finally:
        if store is not None:
            store.close()
        shutil.rmtree(base, ignore_errors=True)


def meta_server_process(port: int, *extra: str):
    """`python -m juicefs_tpu_torch.cmd meta-server` as a process on
    `port`; returns it once it listens."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "juicefs_tpu_torch.cmd", "meta-server", "--host", "127.0.0.1",
         "--port", str(port), *extra],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if "meta-server listening on" not in line:
        raise AssertionError(f"meta-server exited with {proc.wait()}: {line!r}")
    return proc


def stop_process(proc, what: str, sig: int = signal.SIGTERM) -> None:
    """Send `sig` to a meta-server process this script started; it must
    die of it, as the reference's does (no handler: SIGKILL is a crash)."""
    proc.send_signal(sig)
    try:
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if proc.stdout is not None:
            proc.stdout.close()
    if rc != -sig:
        raise AssertionError(f"{what} exited with {rc} on signal {sig}")


def redis_epoch(port: int, db: int) -> int:
    from juicefs_tpu_torch.meta.redis_kv import RedisKV, RespConnection

    conn = RespConnection("127.0.0.1", port, db=db)
    try:
        return int(conn.execute(b"GET", RedisKV.EPOCH_KEY) or 0)
    finally:
        conn.close()


def wait_replica(pport: int, rport: int, db: int) -> None:
    """Wait until the replica has applied everything the primary committed
    (its change epoch caught up); fails after 120 s."""
    target = redis_epoch(pport, db)
    deadline = time.time() + 120
    while redis_epoch(rport, db) < target:
        if time.time() > deadline:
            raise AssertionError("the meta replica never caught up with the primary")
        time.sleep(0.05)


def meta_cli_json(argv: list[str]):
    """Run a meta subcommand that prints JSON (echoing its head); rc 0
    required."""
    rc, out, _ = cli(argv, echo_lines=12)
    if rc != 0:
        raise AssertionError(f"{argv[0]} rc {rc}")
    return json.loads(out)


def meta_subcommands(meta_url: str, written: dict, blocks: list, objects) -> dict:
    """status, info, summary, quota set/check, clone, rmr, restore and
    mdtest on the volume, each through the port's CLI, with their JSON
    checked. Returns each command's seconds."""
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = round(time.perf_counter() - t0, 3)
        return out

    nbytes = sum(len(b) for b in blocks)
    status = timed("status", lambda: meta_cli_json(["status", meta_url]))
    if status["format"]["hash_backend"] != "pallas" or status["used_space"] < nbytes \
            or status["object_plane"].get("probe") != "ok":
        raise AssertionError(f"status: {status['format']}, used {status['used_space']}, "
                             f"{status['object_plane']}")
    info = timed("info", lambda: meta_cli_json(["info", meta_url, "/meta.bin"]))
    n_slices = sum(len(c["slices"]) for c in info["chunks"])
    if info["length"] != nbytes or n_slices != len(blocks):
        raise AssertionError(f"info: length {info['length']}, {n_slices} slices")
    summary = timed("summary", lambda: meta_cli_json(["summary", meta_url, "/"]))
    if summary["files"] < 1 or summary["length"] < nbytes:
        raise AssertionError(f"summary {summary}")
    rc, _out, _ = cli(["quota", "set", meta_url, "/", "--inodes", "100000", "--space", "64"])
    check = timed("quota_check", lambda: meta_cli_json(["quota", "check", meta_url, "/"]))
    if rc != 0 or check["drifted"] or check["actual_space"] < nbytes:
        raise AssertionError(f"quota set rc {rc}; check {check}")
    n_objects = sum(1 for _ in objects.list_all("chunks/"))
    t0 = time.perf_counter()
    rc, out, _ = cli(["clone", meta_url, "/meta.bin", "/clone.bin"])
    secs["clone"] = round(time.perf_counter() - t0, 3)
    clone = meta_cli_json(["info", meta_url, "/clone.bin"])
    if rc != 0 or clone["length"] != nbytes or \
            sum(1 for _ in objects.list_all("chunks/")) != n_objects:
        raise AssertionError(f"clone rc {rc}: length {clone['length']}, objects "
                             "added")
    t0 = time.perf_counter()
    rc, out, _ = cli(["rmr", meta_url, "/clone.bin"])
    secs["rmr"] = round(time.perf_counter() - t0, 3)
    if rc != 0 or "(errno 0)" not in out:
        raise AssertionError(f"rmr rc {rc}")
    rc, out, _ = cli(["restore", meta_url])
    hours = [line.split(":")[0] for line in out.strip().splitlines()]
    if rc != 0 or len(hours) != 1:
        raise AssertionError(f"restore listing rc {rc}: {out!r}")
    t0 = time.perf_counter()
    rc, out, _ = cli(["restore", meta_url, hours[0]])
    secs["restore"] = round(time.perf_counter() - t0, 3)
    if rc != 0 or not out.startswith("restored 1,"):
        raise AssertionError(f"restore rc {rc}: {out!r}")
    back = meta_cli_json(["info", meta_url, "/clone.bin"])
    if back["chunks"] != clone["chunks"]:
        raise AssertionError("the restored clone's chunks differ")
    md = timed("mdtest", lambda: meta_cli_json(["mdtest", meta_url, "--dirs", "10",
                                                "--files", "100"]))
    if not all(md.get(k, 0) > 0 for k in ("dir_create_per_s", "file_create_per_s",
                                          "file_stat_per_s", "readdir_per_s",
                                          "file_unlink_per_s")):
        raise AssertionError(f"mdtest {md}")
    return {"seconds": secs, "mdtest": md, "quota_check": check}


def meta_phase(rng: np.random.Generator, volume_gib: float, kind: str, smi: str) -> dict:
    """Phase 19: BASELINE #3 (`fsck --verify-data`, Redis meta + an S3
    store) through the port's meta-server process and its read replica,
    with the port's gateway as the S3 store; the primary's restart from
    its AOF; the same leg on a sql:// volume with dump/load; the meta
    subcommands; destroy."""
    phase("meta: redis:// via meta-server + replica on an S3 store, sql://, subcommands")
    t_phase = time.perf_counter()
    bs = BLOCK_BYTES
    blocks, planted = plan_blocks(rng, max(1, int(volume_gib * (1 << 30)) // bs), bs,
                                  (1 << 20) + 7)
    n_blocks, nbytes = len(blocks), sum(len(b) for b in blocks)
    gib = nbytes / (1 << 30)
    base = tempfile.mkdtemp(prefix="jfs-torch-meta-")
    procs: dict = {}
    gw = vfs = gm = None
    try:
        # servers: the primary with its AOF, its replica, the S3 stand-in
        pport, rport = free_port(), free_port()
        aof = os.path.join(base, "meta.aof")
        procs["primary"] = meta_server_process(pport, "--data", aof, "--fsync", "always")
        procs["replica"] = meta_server_process(rport, "--replica-of", f"127.0.0.1:{pport}")
        s3_url = f"sqlite3://{base}/s3.db"
        rc, _out, _ = cli(["format", s3_url, "s3", "--storage", "file", "--bucket",
                           os.path.join(base, "s3-blob"), "--compress", "none",
                           "--trash-days", "0"])
        if rc != 0:
            raise AssertionError(f"format of the S3 store's volume rc {rc}")
        gw, vfs, gm = start_gateway_on(s3_url)
        redis_url = f"redis://127.0.0.1:{pport}/1"
        replica_url = f"{redis_url}?replica=127.0.0.1:{rport}"
        rc, out, _ = cli(["format", redis_url, "b3", "--storage", "minio", "--bucket",
                          f"{SERVE_AK}:{SERVE_SK}@127.0.0.1:{gw.port}/bkt", "--compress",
                          "lz4", "--hash-backend", "pallas", "--trash-days", "1"])
        if rc != 0 or kind not in out:
            raise AssertionError(f"format redis:// rc {rc}; probe line must name {kind}")
        redis = indexed_write(redis_url, blocks, b"meta.bin")
        wait_replica(pport, rport, 1)

        # BASELINE #3: fsck --verify-data on the replica URL. Its sweeps
        # read the primary, as the reference's do; the point reads of
        # `info` and `summary` on the same URL go to the replica
        replica0 = counter_value("juicefs_meta_cache_replica_reads")
        fsck_s, fsck_launches = verified_fsck(replica_url, n_blocks)
        fsck_replica_reads = counter_value("juicefs_meta_cache_replica_reads") - replica0
        info = meta_cli_json(["info", replica_url, "/meta.bin"])
        summary = meta_cli_json(["summary", replica_url, "/"])
        replica_reads = (counter_value("juicefs_meta_cache_replica_reads") - replica0
                         - fsck_replica_reads)
        if replica_reads <= 0 or info["length"] != nbytes or summary["length"] < nbytes:
            raise AssertionError(f"info/summary on the replica URL: {replica_reads} "
                                 f"replica reads, length {info['length']}")
        _m, fmt = cmd.open_meta(redis_url)
        _m.client.close()
        objects = resilient(cmd.storage_for(fmt))  # pools S3 connections; closed below
        victim = redis["order"][n_blocks // 3]
        objects.put(victim, planted_bitrot(replica_url, objects, victim, rng, "lz4"))

        # a crash of the primary (SIGKILL) and its restart on its AOF: every
        # acknowledged digest row survives `--fsync always`
        stop_process(procs.pop("primary"), "meta-server (primary)", signal.SIGKILL)
        t0 = time.perf_counter()
        procs["primary"] = meta_server_process(pport, "--data", aof, "--fsync", "always")
        restart_s = time.perf_counter() - t0
        wait_replica(pport, rport, 1)
        m = new_client(redis_url)
        rows = {block_key(sid, indx, bsize): d
                for sid, indx, bsize, d in m.scan_block_digests()}
        m.client.close()
        if rows != redis["rows"]:
            raise AssertionError("digest rows after the AOF replay != the indexer's")
        # gc --dedup trusts what survived and backfills a fifth of the rows,
        # deleted first, on the card through the restarted meta-server
        redis_gc, redis_gc_s, redis_gc_launches = dedup_gc(
            redis_url, redis, blocks, planted, os.path.join(base, "redis-index.json"),
            lost=5)
        sub = meta_subcommands(redis_url, redis, blocks, objects)
        objects.close()

        # the same leg on sql://, then dump -> load into sqlite3://, destroy
        sql_url = f"sql://{base}/sql/meta.db"
        rc, out, _ = cli(["format", sql_url, "sqlvol", "--storage", "file", "--bucket",
                          os.path.join(base, "sql-blob"), "--compress", "lz4",
                          "--hash-backend", "pallas", "--trash-days", "0"])
        if rc != 0 or kind not in out:
            raise AssertionError(f"format sql:// rc {rc}")
        sql = indexed_write(sql_url, blocks, b"sql.bin")
        sql_gc, sql_gc_s, sql_gc_launches = dedup_gc(
            sql_url, sql, blocks, planted, os.path.join(base, "sql-index.json"), lost=5)
        sql_fsck_s, sql_fsck_launches = verified_fsck(sql_url, n_blocks)
        sql_m, sql_fmt = cmd.open_meta(sql_url)
        close_meta(sql_m)
        sql_objects = cmd.storage_for(sql_fmt)
        sql_victim = sql["order"][n_blocks // 3]
        sql_objects.put(sql_victim, planted_bitrot(sql_url, sql_objects, sql_victim, rng,
                                                   "lz4"))
        m = new_client(sql_url)
        sql_rows = {block_key(sid, indx, bsize): d
                    for sid, indx, bsize, d in m.scan_block_digests()}
        close_meta(m)
        dump_path = os.path.join(base, "sql-dump.json")
        loaded_url = f"sqlite3://{base}/loaded.db"
        t0 = time.perf_counter()
        if cli(["dump", sql_url, dump_path])[0] != 0 \
                or cli(["load", loaded_url, dump_path])[0] != 0:
            raise AssertionError("dump/load of the sql:// volume failed")
        dump_load_s = time.perf_counter() - t0
        m = new_client(loaded_url)
        loaded = {block_key(sid, indx, bsize): d
                  for sid, indx, bsize, d in m.scan_block_digests()}
        m.client.close()
        if loaded != sql_rows or {k: loaded.get(k) for k in sql["rows"]} != sql["rows"]:
            raise AssertionError("digest rows loaded into sqlite3:// != the sql:// volume's")
        t0 = time.perf_counter()
        rc, out, _ = cli(["destroy", sql_url, "--yes"])
        destroy_s = time.perf_counter() - t0
        left = [f for _d, _s, files in os.walk(os.path.join(base, "sql-blob")) for f in files]
        if rc != 0 or left:
            raise AssertionError(f"destroy rc {rc}; {len(left)} files left in the bucket")
        print(f"gates ok: redis:// through the meta-server process on the S3 gateway: "
              f"{redis['indexer']['blocks']} indexed + {redis['indexer']['dropped']} dropped, "
              f"one launch per index batch; fsck --verify-data on the replica URL "
              f"verified {n_blocks} blocks in {fsck_launches} launches with 0 mismatches "
              f"({int(fsck_replica_reads)} replica reads: its sweeps read the primary), "
              f"then exactly {victim}; info and summary on it made {int(replica_reads)} "
              f"replica reads; the primary SIGKILLed and restarted from its AOF with every "
              f"digest row; gc --dedup from_index {redis_gc['from_index']}, hashed_now "
              f"{redis_gc['hashed_now']} in {redis_gc_launches} launches, {planted} "
              f"duplicates, sampled index == spec, the deleted rows written back; sql:// "
              f"the same gates (gc hashed_now {sql_gc['hashed_now']} in {sql_gc_launches} "
              f"launches, {sql_fsck_launches} fsck launches, then exactly {sql_victim}); "
              f"dump -> load "
              f"into sqlite3:// kept all {len(loaded)} digest rows; destroy left the bucket "
              f"empty; status, info, summary, quota, clone (no object added), rmr, restore "
              f"and mdtest exit 0 with their JSON checked")
        print(f"meta: redis:// write {redis['gibs']:.4f} GiB/s, fsck --verify-data "
              f"{gib / fsck_s:.4f} GiB/s ({fsck_s:.3f} s) on the replica URL, AOF restart "
              f"{restart_s:.3f} s, gc --dedup {redis_gc_s:.3f} s; sql:// write "
              f"{sql['gibs']:.4f} GiB/s, gc --dedup {sql_gc_s:.3f} s, fsck --verify-data "
              f"{gib / sql_fsck_s:.4f} GiB/s ({sql_fsck_s:.3f} s), dump+load "
              f"{dump_load_s:.3f} s, destroy {destroy_s:.3f} s; subcommands "
              f"{json.dumps(sub['seconds'])} s, mdtest {json.dumps(sub['mdtest'])}; phase "
              f"{time.perf_counter() - t_phase:.3f} s; card {smi}")
        return {"redis": {"write_gibs": redis["gibs"], "fsck_gibs": gib / fsck_s,
                          "gc_seconds": redis_gc_s, "restart_seconds": restart_s,
                          "replica_reads": replica_reads},
                "sql": {"write_gibs": sql["gibs"], "fsck_gibs": gib / sql_fsck_s,
                        "gc_seconds": sql_gc_s, "dump_load_seconds": dump_load_s},
                "subcommands": sub,
                "launches": {"meta_redis_index": redis["launches"],
                             "meta_redis_fsck": fsck_launches,
                             "meta_redis_gc": redis_gc_launches,
                             "meta_sql_index": sql["launches"],
                             "meta_sql_gc": sql_gc_launches,
                             "meta_sql_fsck": sql_fsck_launches}}
    finally:
        if gw is not None:
            gw.stop()
        if vfs is not None:
            vfs.close()
            vfs.store.close()
        if gm is not None:
            gm.close_session()
            gm.client.close()
        for name, proc in procs.items():
            try:
                stop_process(proc, f"meta-server ({name})")
            except Exception as e:  # the phase already failed; report, go on
                print(f"meta phase teardown: {e}", file=sys.stderr)
        shutil.rmtree(base, ignore_errors=True)


GROUP = "g"
GROUP_STAGES = ("chunk.ingest.hash", "gpu.index.batch")


class CountedFaultyStore(FaultyStore):
    """The phase's FaultyStore over a volume's object stack: it also counts
    every call that reaches it and the data GETs that returned bytes."""

    def __init__(self, store, **kw):
        super().__init__(store, **kw)
        self.calls = 0
        self.data_gets: list[str] = []

    def _maybe_fail(self, op, rate):
        with self._mu:
            self.calls += 1
        super()._maybe_fail(op, rate)

    def get(self, key, off=0, limit=-1):
        data = super().get(key, off, limit)
        with self._mu:
            self.data_gets.append(key)
        return data


class FaultyStacks:
    """While active, every object stack `cmd.storage_for` builds (the
    write store's, each member's, each warmup's, gc's and fsck's) is
    wrapped in a CountedFaultyStore; `fault_config` reaches all of them."""

    def __init__(self):
        self.stores: list[CountedFaultyStore] = []
        self.real = cmd.storage_for

    def __enter__(self):
        def wrapped(fmt):
            st = CountedFaultyStore(self.real(fmt), seed=20)
            self.stores.append(st)
            return st

        cmd.storage_for = wrapped
        return self

    def __exit__(self, *exc):
        cmd.storage_for = self.real

    def fault_config(self, **kw) -> None:
        for st in self.stores:
            st.fault_config(**kw)

    def totals(self) -> dict:
        return {"calls": sum(s.calls for s in self.stores),
                "data_gets": sum(len(s.data_gets) for s in self.stores),
                **{k: sum(s.counters[k] for s in self.stores)
                   for k in ("errors", "throttles", "hangs", "short_reads")}}

    def gets_since(self, mark: dict) -> list[str]:
        """Keys of the data GETs made since `mark` (a `marks()` result)."""
        return [k for s in self.stores for k in s.data_gets[mark.get(id(s), 0):]]

    def marks(self) -> dict:
        return {id(s): len(s.data_gets) for s in self.stores}


class GroupMember:
    """One cache-group member: `mount` of the volume started in-process with
    `cmd.mount.start_mount` over a socketpair (no kernel mount: the phase
    reads through the member's vfs), served on a thread."""

    def __init__(self, argv: list[str]):
        parser = argparse.ArgumentParser()
        mount_cmd.add_parser(parser.add_subparsers())
        self.args = parser.parse_args(["mount", *argv])
        self._ends = socket.socketpair(socket.AF_UNIX, socket.SOCK_SEQPACKET)
        self.mounted = mount_cmd.start_mount(self.args, fuse_fd=self._ends[1].fileno())
        self._thread = threading.Thread(target=self.mounted.srv.serve, daemon=True,
                                        name="smoke-group-serve")
        self._thread.start()
        self.addr = self.mounted.peer_srv.addr

    def status(self) -> dict:
        from juicefs_tpu_torch.vfs.internal import STATUS_INO

        vfs = self.mounted.vfs
        vfs.internal.open(STATUS_INO, 77)
        try:
            return json.loads(bytes(vfs.internal.read(STATUS_INO, 77, 0, 1 << 22)[1]))
        finally:
            vfs.internal.release(STATUS_INO, 77)

    def close(self) -> None:
        """Hang up the FUSE channel, wait for the serving loops, then close
        the peer server, pusher, vfs, store and session."""
        self._ends[0].shutdown(socket.SHUT_RDWR)
        self._thread.join(120)
        if self._thread.is_alive():
            raise AssertionError("a member's FUSE loops did not stop")
        self.mounted.close()
        self.mounted.meta.client.close()
        for s in self._ends:
            s.close()


class PushSinks:
    """A Pushgateway stand-in (stdlib HTTP, PUT) and a Graphite one (TCP),
    each keeping every payload it received, in order."""

    def __init__(self):
        import http.server

        self.gateway: list[str] = []
        self.graphite: list[str] = []
        self._lock = threading.Lock()
        sinks = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_PUT(self):  # noqa: N802
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                with sinks._lock:
                    sinks.gateway.append(body.decode())
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self._http = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self._http.daemon_threads = True
        self._tcp = socket.socket()
        self._tcp.bind(("127.0.0.1", 0))
        self._tcp.listen(16)
        self.http_port = self._http.server_port
        self.tcp_port = self._tcp.getsockname()[1]
        threading.Thread(target=self._http.serve_forever, daemon=True).start()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self._tcp.accept()
            except OSError:
                return
            with conn:
                buf = b""
                while True:
                    d = conn.recv(1 << 16)
                    if not d:
                        break
                    buf += d
            with self._lock:
                self.graphite.append(buf.decode())

    def counts(self) -> tuple[int, int]:
        with self._lock:
            return len(self.gateway), len(self.graphite)

    def latest(self) -> tuple[str, str]:
        with self._lock:
            return self.gateway[-1], self.graphite[-1]

    def close(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        self._tcp.close()


def cache_group_series(text: str) -> dict:
    """{series: value} of the juicefs_cache_group_* lines of a Prometheus
    text rendering."""
    out = {}
    for line in text.splitlines():
        if line.startswith("juicefs_cache_group_"):
            series, _, value = line.rpartition(" ")
            out[series] = float(value)
    return out


def graphite_paths(series: dict, prefix: str = "juicefs") -> dict:
    """The Graphite path each Prometheus series is pushed under: label
    values become path segments, as MetricsPusher names them."""
    out = {}
    for series_name, value in series.items():
        name, _, labels = series_name.partition("{")
        path = name
        for val in re.findall(r'="([^"]*)"', labels):
            path += "." + (re.sub(r"[^A-Za-z0-9_-]", "_", val) or "_")
        out[f"{prefix}.{path}"] = value
    return out


def graphite_values(payload: str) -> dict:
    out = {}
    for line in payload.splitlines():
        path, value, _ts = line.split(" ")
        out[path] = float(value)
    return out


def cached_keys(cache_dir: str) -> set:
    """Block keys a member's disk cache holds (files under raw/)."""
    raw = os.path.join(cache_dir, "raw")
    return {os.path.relpath(os.path.join(d, f), raw).replace(os.sep, "/")
            for d, _s, files in os.walk(raw) for f in files if not f.endswith(".tmp")}


def group_write(meta_url: str, blocks: list, planted: int) -> dict:
    """The plan as one file of 8-block slices, written by 4 writers through
    a store built as `mount --inline-dedup` builds it (`build_store` with
    its IngestPipeline on the card); gates: elided == planted, nothing
    passed through or failed, every hashed block estimated, one launch
    per hash batch. Returns the file's block keys in order and the
    write's numbers."""
    bs = BLOCK_BYTES
    m, fmt = cmd.open_meta(meta_url)
    store = cmd.build_store(fmt, argparse.Namespace(
        inline_dedup=True, no_dedup_bypass=True, ingest_flush_ms=5.0,
        compress_backend="cuda", cache_size=1024), meta=m)
    try:
        if store.ingest is None or store.ingest.backend != "cuda" \
                or store.compress_plane.config.backend != "cuda":
            raise AssertionError("build_store attached no cuda ingest stage")
        ctx = Context(uid=0, gid=0)
        st, ino, _ = m.create(ctx, 1, b"group.bin", 0o644)
        if st != 0:
            raise AssertionError(f"create: errno {st}")
        spans = list(range(0, len(blocks), 8))
        sids = [m.new_slice() for _ in spans]
        stages0 = stage_metrics_snapshot()
        hashed0 = counter_value("juicefs_torch_blocks_hashed")
        kernels.reset_launches()
        t0 = time.perf_counter()

        def write(k: int) -> None:
            data = b"".join(blocks[spans[k]:spans[k] + 8])
            w = store.new_writer(sids[k])
            w.write_at(data, 0)
            w.finish(len(data))

        with ThreadPoolExecutor(4, thread_name_prefix="smoke-group-writer") as ex:
            list(ex.map(write, range(len(spans))))
        store.flush_all()
        write_s = time.perf_counter() - t0
        write_launches = launches()
        stages = stage_delta(stages0, stage_metrics_snapshot(), GROUP_STAGES)
        hashed = int(counter_value("juicefs_torch_blocks_hashed") - hashed0)
        keys = []
        for k, i in enumerate(spans):
            chunk = blocks[i:i + 8]
            size = sum(len(b) for b in chunk)
            indx, pos = divmod(i * bs, CHUNK_SIZE)
            if m.write_chunk(ino, indx, pos, Slice(pos=pos, id=sids[k], size=size, off=0,
                                                  len=size)) != 0:
                raise AssertionError("write_chunk failed")
            keys += [block_key(sids[k], j, len(b)) for j, b in enumerate(chunk)]
        if m.close(ctx, ino) != 0:
            raise AssertionError("close of the written file failed")
        st = store.ingest.stats()
        ix = store.indexer.stats() if store.indexer is not None else {"errors": 0}
    finally:
        store.close()
        m.client.close()
    comp = st["compress"]
    ingest_batches = stages["chunk.ingest.hash"]["count"]
    index_batches = stages["gpu.index.batch"]["count"]
    print("group_ingest_stats " + json.dumps(st))
    if st["put_elided"] != planted or st["uploaded"] != len(blocks) - planted:
        raise AssertionError(f"put_elided {st['put_elided']}, uploaded {st['uploaded']}; "
                             f"planted {planted} of {len(blocks)}")
    for k in ("passthrough", "errors", "race_collapsed"):
        if st[k] != 0:
            raise AssertionError(f"ingest {k} = {st[k]}, want 0")
    if comp["degraded"] != 0 or comp["estimated"] != hashed or ix["errors"] != 0:
        raise AssertionError(f"compress plane {comp}, indexer {ix}: want no degrade, "
                             f"estimated == {hashed} hashed blocks, no indexer errors")
    if ingest_batches == 0 or write_launches != ingest_batches + index_batches:
        raise AssertionError(f"{write_launches} launches for {ingest_batches} ingest + "
                             f"{index_batches} index batches")
    return {"keys": keys, "seconds": write_s, "launches": write_launches,
            "ingest_batches": ingest_batches, "index_batches": index_batches,
            "hashed": hashed, "stats": st}


def group_phase(rng: np.random.Generator, volume_gib: float, kind: str, smi: str) -> dict:
    """Phase 20: a peer-served, card-hashed inline-dedup volume. Two
    cache-group members, a distributed `warmup`, a backend blackout that
    the peers absorb, then `fsck --verify-data` and `gc --dedup` on the
    card, and the metrics pusher's pushes checked against the registry."""
    phase("group: cache group over an inline-dedup volume, warmup, blackout, pusher")
    t_phase = time.perf_counter()
    bs = BLOCK_BYTES
    blocks, planted = plan_blocks(rng, max(1, int(volume_gib * (1 << 30)) // bs), bs,
                                  (1 << 20) + 7)
    n_blocks, nbytes = len(blocks), sum(len(b) for b in blocks)
    gib = nbytes / (1 << 30)
    base = tempfile.mkdtemp(prefix="jfs-torch-group-")
    meta_url = f"sqlite3://{base}/meta.db"
    old_runtime = os.environ.get("XDG_RUNTIME_DIR")
    os.environ["XDG_RUNTIME_DIR"] = os.path.join(base, "run")
    members: dict = {}
    sinks = PushSinks()
    stacks = FaultyStacks()
    port = {"a": free_port(), "b": free_port()}
    cache_dir = {side: os.path.join(base, f"cache-{side}") for side in port}

    def member_argv(side: str) -> list[str]:
        argv = [meta_url, os.path.join(base, f"mp-{side}"), "--cache-group", GROUP,
                "--group-listen", f"127.0.0.1:{port[side]}", "--cache-dir", cache_dir[side],
                "--cache-size", "4096", "--compress-backend", "cuda", "--heartbeat", "2",
                "--no-watchdog", "--no-bgjobs"]
        if side == "a":
            argv += ["--metrics-push", f"http://127.0.0.1:{sinks.http_port}/",
                     "--graphite", f"127.0.0.1:{sinks.tcp_port}", "--push-interval", "0.5"]
        return argv

    def live_members(member) -> dict:
        """Gate: the member's `.status` ring is both members, rebuilt from
        the live meta sessions (no static peer list)."""
        found = {s.peer_addr: s.group_weight for s in member.mounted.meta.do_list_sessions()
                 if s.cache_group == GROUP and s.peer_addr}
        group = member.mounted.store.cache_group
        if group._static:
            raise AssertionError(f"member {member.addr} has a static peer list")
        group.refresh(force=True)
        ring = member.status()["cache_group"]["members"]
        want = {f"127.0.0.1:{port[s]}": 1 for s in port}
        if found != want or ring != want:
            raise AssertionError(f"member {member.addr}: sessions {found}, ring {ring}, "
                                 f"want {want}")
        return ring

    try:
        format_device_volume(meta_url, base, "group")
        with stacks:
            # 1. the write, as `mount --inline-dedup` builds its store
            w = group_write(meta_url, blocks, planted)
            keys = w["keys"]
            content = dict(zip(keys, blocks))
            m, fmt = cmd.open_meta(meta_url)
            m.client.close()
            stored = {o.key for o in stacks.real(fmt).list_all("chunks/")}
            if len(stored) != n_blocks - planted:
                raise AssertionError(f"{len(stored)} objects stored, want {n_blocks - planted}")

            # 2. two members, found through the meta sessions
            for side in ("a", "b"):
                members[side] = GroupMember(member_argv(side))
            for side in ("a", "b"):
                live_members(members[side])
            owner = {k: members["a"].mounted.store.cache_group.ring.owner(k) for k in keys}
            owned = {side: {k for k in keys if owner[k] == members[side].addr}
                     for side in port}

            # 3. distributed warmup: each member's cache dir is filled while
            # that member is down (a live mount holds its dir's lock), with
            # the member's address as the ring identity; the other member's
            # live session completes the ring. The member then restarts on
            # the same address and serves what warmup filled.
            mark = stacks.marks()
            hedges0 = counter_total("juicefs_object_hedged_requests")
            kernels.reset_launches()
            warm_s = 0.0
            for side in ("a", "b"):
                addr = members[side].addr
                members.pop(side).close()
                t0 = time.perf_counter()
                rc, out, _ = cli(["warmup", meta_url, "/", "--cache-group", GROUP,
                                  "--group-self", addr, "--cache-dir", cache_dir[side],
                                  "--cache-size", "4096", "--threads", "16"])
                warm_s += time.perf_counter() - t0
                if rc != 0 or f"warmed 1 files / {len(range(0, n_blocks, 8))} slices" \
                        not in out:
                    raise AssertionError(f"warmup for {side}: rc {rc}")
                members[side] = GroupMember(member_argv(side))
                if members[side].addr != addr:
                    raise AssertionError(f"member {side} came back on {members[side].addr}")
            warm_launches = launches()
            warm_gets = stacks.gets_since(mark)
            warm_hedges = int(counter_total("juicefs_object_hedged_requests") - hedges0)
            in_cache = {side: cached_keys(cache_dir[side]) & set(keys) for side in port}
            for side in ("a", "b"):
                live_members(members[side])
            if warm_launches != 0:
                raise AssertionError(f"warmup launched {warm_launches} kernels")
            if in_cache["a"] & in_cache["b"] or in_cache["a"] | in_cache["b"] != set(keys) \
                    or in_cache != owned:
                raise AssertionError(
                    f"warm caches: a {len(in_cache['a'])}, b {len(in_cache['b'])}, shared "
                    f"{len(in_cache['a'] & in_cache['b'])}, union "
                    f"{len(in_cache['a'] | in_cache['b'])} of {n_blocks}; owned "
                    f"{len(owned['a'])} + {len(owned['b'])}")
            # each block moved from the object store once (an elided block as
            # its canonical object), and every stored object was fetched; a
            # GET that outlived the hedge delay may add its hedged twin, so
            # each GET beyond one per block must be a hedge of this warmup
            if not n_blocks <= len(warm_gets) <= n_blocks + warm_hedges \
                    or set(warm_gets) != stored:
                raise AssertionError(f"warmup made {len(warm_gets)} data GETs of "
                                     f"{len(set(warm_gets))} objects with {warm_hedges} "
                                     f"hedges; want {n_blocks} GETs (plus at most one per "
                                     f"hedge) of the {len(stored)} stored objects")

            # 4. blackout: every backend call fails; B reads the whole file
            # from its own cache and A's peer server
            b = members["b"].mounted
            stacks.fault_config(error_rate=1.0)
            before = stacks.totals()
            hits = global_registry()._metrics["juicefs_cache_group_peer_hits"]
            hits0 = hits.value
            kernels.reset_launches()
            ctx = Context(uid=0, gid=0, pid=1)
            t0 = time.perf_counter()
            st, ino, _ = b.vfs.lookup(ctx, 1, b"group.bin")
            st2, _attr, fh = b.vfs.open(ctx, ino, os.O_RDONLY)
            if st or st2:
                raise AssertionError(f"lookup/open through B: errno {st or st2}")
            got = bytearray()
            while len(got) < nbytes:
                st, data = b.vfs.read(ctx, ino, fh, len(got), 32 << 20)
                if st != 0 or not data:
                    raise AssertionError(f"read at {len(got)} through B: errno {st}")
                got += data
            b.vfs.release(ctx, ino, fh)
            blackout_s = time.perf_counter() - t0
            blackout_launches = launches()
            peer_hits = hits.value - hits0
            after = stacks.totals()
            stacks.fault_config(error_rate=0.0)
            if bytes(got) != b"".join(blocks):
                raise AssertionError("the blackout read through B differs from the plan")
            if after != before:
                raise AssertionError(f"backend touched during the blackout: {before} -> {after}")
            if peer_hits != len(owned["a"]):
                raise AssertionError(f"B's peer hits {peer_hits} != {len(owned['a'])} blocks "
                                     "A owns")

            # 5. the pusher of member A: a push after the blackout carries the
            # registry's juicefs_cache_group_* values to both sinks
            want = cache_group_series(global_registry().render())
            n0 = sinks.counts()
            deadline = time.monotonic() + 30
            # two new pushes on each sink: the second began after the read
            while min(c - c0 for c, c0 in zip(sinks.counts(), n0)) < 2:
                if time.monotonic() > deadline:
                    raise AssertionError(f"no push after the blackout: {sinks.counts()}")
                time.sleep(0.05)
            gw_body, gr_body = sinks.latest()
            if cache_group_series(global_registry().render()) != want:
                raise AssertionError("cache-group series moved after the blackout")
            pushed = cache_group_series(gw_body)
            graphite = {p: v for p, v in graphite_values(gr_body).items()
                        if p.startswith("juicefs.juicefs_cache_group_")}
            if pushed != want or graphite != graphite_paths(want):
                raise AssertionError(f"pushed cache-group series differ from the registry: "
                                     f"{sorted(set(pushed.items()) ^ set(want.items()))[:4]}")
            pushes = sinks.counts()
            for side in ("b", "a"):
                members.pop(side).close()

            # 6. on the card: fsck --verify-data, then gc --dedup with a fifth
            # of the digest rows deleted
            kernels.reset_launches()
            t0 = time.perf_counter()
            rc, out, _ = cli(["fsck", meta_url, "--verify-data", "--compress-backend", "cuda"])
            fsck_s = time.perf_counter() - t0
            fsck_launches = launches()
            if rc != 0 or f"verified {n_blocks} blocks (cuda)" not in out \
                    or "0 digest mismatches" not in out or fsck_launches != -(-n_blocks // 32):
                raise AssertionError(f"fsck rc {rc}, {fsck_launches} launches")
            m = new_client(meta_url)
            rows = {block_key(sid, indx, bsize): d
                    for sid, indx, bsize, d in m.scan_block_digests()}
            gone = sorted(rows)[::5]
            m.delete_block_digests([parse_block_key(k)[:2] for k in gone])
            m.client.close()
            kernels.reset_launches()
            t0 = time.perf_counter()
            rc, out, _ = cli(["gc", meta_url, "--dedup", "--threads", "16",
                              "--compress-backend", "cuda"])
            gc_s = time.perf_counter() - t0
            gc_launches = launches()
            lines = out.strip().splitlines()
            gc = json.loads(lines[-1])
            if rc != 0 or not lines[0].endswith("0 leaked, 0 missing"):
                raise AssertionError(f"gc rc {rc}: {lines[:1]}")
            if (gc["hashed_now"], gc["from_index"], gc["duplicate_blocks"]) != \
                    (len(gone), n_blocks - len(gone), planted) \
                    or gc_launches != -(-len(gone) // 32):
                raise AssertionError(f"gc hashed_now {gc['hashed_now']}, from_index "
                                     f"{gc['from_index']}, duplicates {gc['duplicate_blocks']} "
                                     f"in {gc_launches} launches; want {len(gone)} of "
                                     f"{n_blocks}, {planted}")
            m = new_client(meta_url)
            rows = {block_key(sid, indx, bsize): d
                    for sid, indx, bsize, d in m.scan_block_digests()}
            m.client.close()
            for k in gone:
                if rows.get(k) != jth256(content[k]):
                    raise AssertionError(f"{k}: gc's backfilled row != numpy spec")
        print(f"gates ok: {planted} elided == planted in {w['launches']} launches == "
              f"{w['ingest_batches']} ingest + {w['index_batches']} index batches; "
              f"{len(stored)} objects; two members found through the sessions; warmup "
              f"filled {len(in_cache['a'])} + {len(in_cache['b'])} blocks, disjoint, the "
              f"union every block, with {len(warm_gets)} data GETs ({warm_hedges} hedges) of "
              f"the {len(stored)} objects and 0 launches; the blackout read exact with 0 backend calls, "
              f"{peer_hits:.0f} peer hits == A's blocks; {pushes[0]} gateway and {pushes[1]} "
              f"graphite pushes, the latest == the registry's {len(want)} cache-group "
              f"series; fsck {n_blocks} blocks, 0 mismatches, {fsck_launches} launches; gc "
              f"hashed the {len(gone)} deleted rows in {gc_launches} launches, == spec")
        print(f"group: write {gib / w['seconds']:.4f} GiB/s, warmup {gib / warm_s:.4f} GiB/s "
              f"({warm_s:.3f} s for both members), blackout read {gib / blackout_s:.4f} GiB/s "
              f"({blackout_launches} launches), fsck --verify-data {gib / fsck_s:.4f} GiB/s, "
              f"gc --dedup {gc_s:.3f} s; phase {time.perf_counter() - t_phase:.3f} s; card {smi}")
        return {"write_gibs": gib / w["seconds"], "warmup_gibs": gib / warm_s,
                "blackout_gibs": gib / blackout_s, "fsck_gibs": gib / fsck_s,
                "gc_seconds": gc_s, "peer_hits": peer_hits, "pushes": pushes,
                "launches": {"group_ingest": w["launches"], "group_fsck": fsck_launches,
                             "group_gc": gc_launches}}
    finally:
        for side, member in members.items():
            try:
                member.close()
            except Exception as e:  # the phase already failed; report, go on
                print(f"group phase teardown ({side}): {e}", file=sys.stderr)
        sinks.close()
        if old_runtime is None:
            os.environ.pop("XDG_RUNTIME_DIR", None)
        else:
            os.environ["XDG_RUNTIME_DIR"] = old_runtime
        shutil.rmtree(base, ignore_errors=True)


STORES_BLOCKS = 64  # 256 MiB of the plan, plus the tail, for each leg


def stores_leg(name: str, meta_url: str, base: str, rng: np.random.Generator, kind: str,
               fmt_args: list[str]) -> dict:
    """One leg of phase 21: `format` with `fmt_args`, the indexed write
    through `build_store` (indexer on the card), `gc --dedup` with a fifth
    of the rows deleted, `fsck --verify-data`, and one planted bitrot that
    fsck must report alone (the phase-11 gates)."""
    bs = BLOCK_BYTES
    blocks, planted = plan_blocks(rng, STORES_BLOCKS, bs, (1 << 20) + 7)
    nbytes = sum(len(b) for b in blocks)
    rc, out, _ = cli(["format", meta_url, name, "--compress", "lz4", "--hash-backend",
                      "pallas", "--trash-days", "0", *fmt_args])
    if rc != 0 or kind not in out:
        raise AssertionError(f"format ({name}) rc {rc}")
    written = indexed_write(meta_url, blocks, f"{name}.bin".encode())
    gc, gc_s, gc_launches = dedup_gc(meta_url, written, blocks, planted,
                                     os.path.join(base, f"{name}-index.json"), lost=5)
    fsck_s, fsck_launches = verified_fsck(meta_url, len(blocks))
    m, fmt = cmd.open_meta(meta_url)
    close_meta(m)
    objects = cmd.storage_for(fmt)
    victim = written["order"][len(blocks) // 3]
    objects.put(victim, planted_bitrot(meta_url, objects, victim, rng, "lz4"))
    gib = nbytes / (1 << 30)
    print(f"stores {name}: write {written['gibs']:.4f} GiB/s ({written['launches']} "
          f"launches), gc --dedup {gc_s:.3f} s (hashed_now {gc['hashed_now']} in "
          f"{gc_launches} launches), fsck --verify-data {gib / fsck_s:.4f} GiB/s "
          f"({fsck_launches} launches), bitrot found at {victim}")
    return {"written": written, "blocks": blocks, "fmt": fmt, "write_gibs": written["gibs"],
            "gc_seconds": gc_s, "fsck_gibs": gib / fsck_s,
            "launches": {f"stores_{name}_index": written["launches"],
                         f"stores_{name}_gc": gc_launches,
                         f"stores_{name}_fsck": fsck_launches}}


def stores_phase(rng: np.random.Generator, kind: str, smi: str) -> dict:
    """Phase 21: the sqlite3 and redis blob stores and the encrypted
    volume, each under the card's indexer, gc and fsck."""
    from juicefs_tpu_torch.object import encrypt

    phase("stores: sqlite3 and redis blob stores, encrypted volumes, on the card")
    t_phase = time.perf_counter()
    base = tempfile.mkdtemp(prefix="jfs-torch-stores-")
    proc = None
    legs: dict = {}
    try:
        legs["sqlite3"] = stores_leg(
            "sqlite3", f"sqlite3://{base}/sq-meta.db", base, rng, kind,
            ["--storage", "sqlite3", "--bucket", os.path.join(base, "objs.db")])
        rport = free_port()
        proc = meta_server_process(rport)
        legs["redis"] = stores_leg(
            "redis", f"sqlite3://{base}/rd-meta.db", base, rng, kind,
            ["--storage", "redis", "--bucket", f"127.0.0.1:{rport}/2"])
        stop_process(proc, "meta-server (blob store)")
        proc = None
        encrypted = "not run"
        if encrypt.HAVE_CRYPTOGRAPHY:
            from juicefs_tpu_torch.object import generate_rsa_key_pem

            pem = os.path.join(base, "key.pem")
            with open(pem, "wb") as f:
                f.write(generate_rsa_key_pem())
            bucket = os.path.join(base, "enc-blob")
            leg = legs["encrypted"] = stores_leg(
                "encrypted", f"sqlite3://{base}/enc-meta.db", base, rng, kind,
                ["--storage", "file", "--bucket", bucket, "--encrypt-rsa-key", pem])
            raw = FileStorage(bucket)
            order, blocks = leg["written"]["order"], leg["blocks"]
            for key, data in zip(order, blocks):
                body = bytes(raw.get("encrypted/" + key))
                for off in (0, len(data) // 2, max(0, len(data) - 4096)):
                    if data[off:off + 4096] in body:
                        raise AssertionError(f"{key}: plaintext at rest")
            # aes256ctr: a flipped byte is caught by the checksum wrapper
            ctr_url = f"sqlite3://{base}/ctr-meta.db"
            rc, _out, _ = cli(["format", ctr_url, "ctr", "--storage", "file", "--bucket",
                               os.path.join(base, "ctr-blob"), "--compress", "none",
                               "--hash-backend", "pallas", "--trash-days", "0",
                               "--encrypt-rsa-key", pem, "--encrypt-algo", "aes256ctr-rsa"])
            if rc != 0:
                raise AssertionError(f"format aes256ctr rc {rc}")
            ctr = indexed_write(ctr_url, blocks[:8], b"ctr.bin")
            victim = ctr["order"][3]
            ctr_raw = FileStorage(os.path.join(base, "ctr-blob"))
            body = bytearray(ctr_raw.get("ctr/" + victim))
            body[len(body) // 2] ^= 0x01
            ctr_raw.put("ctr/" + victim, bytes(body))
            m, fmt = cmd.open_meta(ctr_url)
            close_meta(m)
            try:
                cmd.storage_for(fmt).get(victim)
            except IOError as e:
                if "checksum mismatch" not in str(e):
                    raise
            else:
                raise AssertionError("a flipped byte under aes256ctr came back as data")
            legs["encrypted"]["launches"]["stores_encrypted_ctr_index"] = ctr["launches"]
            encrypted = "run"
        else:
            print(f"encrypted leg not run: no cryptography on {kind}")
        print(f"gates ok: sqlite3://, redis:// (meta-server process, db 2)"
              + (" and the encrypted volume" if encrypted == "run" else "")
              + ": indexer 0 errors and indexed + dropped == written in one launch per "
              "batch, gc hashed exactly the dropped and deleted rows in one launch per 32 "
              "and wrote them back equal, fsck 0 mismatches in one launch per 32, then "
              "exactly the planted block"
              + ("; no raw encrypted object holds a 4 KiB window of its plaintext; "
                 "aes256ctr: a flipped byte is refused by the checksum" if encrypted == "run"
                 else ""))
        print("stores: " + "; ".join(
            f"{name} write {leg['write_gibs']:.4f} GiB/s, gc {leg['gc_seconds']:.3f} s, "
            f"fsck {leg['fsck_gibs']:.4f} GiB/s" for name, leg in legs.items())
            + f"; phase {time.perf_counter() - t_phase:.3f} s; card {smi}")
        return {"legs": {name: {k: leg[k] for k in ("write_gibs", "gc_seconds", "fsck_gibs")}
                         for name, leg in legs.items()},
                "encrypted": encrypted,
                "launches": {k: v for leg in legs.values() for k, v in leg["launches"].items()}}
    finally:
        if proc is not None:
            try:
                stop_process(proc, "meta-server (blob store)")
            except Exception as e:  # the phase already failed; report, go on
                print(f"stores phase teardown: {e}", file=sys.stderr)
        shutil.rmtree(base, ignore_errors=True)


def sdk_c_run(exe: str, *args: str, timeout: float = 600) -> subprocess.CompletedProcess:
    """Run a consumer of the port's C shim as its own process, in the
    environment `sdk_c.child_env()` gives it."""
    return subprocess.run([exe, *args], env=sdk_c.child_env(), capture_output=True,
                          text=True, timeout=timeout)


def child_index_report(stderr: str) -> dict:
    """What a shim consumer's stderr says of its content indexer: blocks in
    batches that failed ("index batch of N failed" warnings), and the
    counts `sdk.jfs_term` warns with when the drained indexer left blocks
    without a row (no such line: it left none). The lines are printed."""
    lines = [ln for ln in stderr.splitlines()
             if "index batch of" in ln or "overloaded" in ln or "content index at" in ln]
    for ln in lines:
        print(f"child: {ln}")
    failed = sum(int(n) for n in re.findall(r"index batch of (\d+) failed", stderr))
    term = re.findall(r"content index at jfs_term: (\d+) blocks hashed, (\d+) skipped "
                      r"under load, (\d+) failed", stderr)
    hashed, skipped, term_failed = map(int, term[-1]) if term else (0, 0, 0)
    return {"summary": bool(term), "hashed": hashed, "skipped": skipped,
            "failed": max(failed, term_failed)}


def sdk_c_phase(rng: np.random.Generator, volume_gib: float, kind: str, smi: str) -> dict:
    """Phase 22: the port's libjfs C shim driven by compiled C programs on
    card-hashed, card-estimated volumes. The C programs run as child
    processes, so their kernel launches (the indexer's, inside the embedded
    interpreter) are not visible here: the digest rows they leave are the
    proof, since such a volume hashes only on the card, and the child's
    stderr says whether a batch failed and how many blocks its indexer
    skipped (`child_index_report`). The launches this phase counts are the
    parent's gc and fsck."""
    phase("sdk_c: the port's libjfs C shim under compiled C programs, on the card")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    sdk_c.build()
    example = sdk_c.build_program(os.path.join(REPO, "sdk", "c", "example.c"))
    copier = sdk_c.build_program(sdk_c.JFS_COPY)
    print(f"built libjfs.so, example and jfs_copy in {time.perf_counter() - t0:.3f} s")
    bs = BLOCK_BYTES
    base = tempfile.mkdtemp(prefix="jfs-torch-sdkc-")
    try:
        # 1. the reference's consumer on a pallas + lz4 volume
        ex_url = f"sqlite3://{base}/ex-meta.db"
        format_device_volume(ex_url, os.path.join(base, "ex"), "sdkcex")
        out = sdk_c_run(example, ex_url)
        print("example: " + " | ".join(out.stdout.strip().splitlines()[-3:]))
        if out.returncode != 0 or "ALL OK" not in out.stdout or "FAIL" in out.stdout:
            raise AssertionError(f"example rc {out.returncode}:\n{out.stdout}{out.stderr[-3000:]}")

        # 2. jfs_copy of the plan (1 GiB of 4 MiB blocks + a 1 MiB + 7 B tail)
        blocks, planted = plan_blocks(rng, max(1, int(volume_gib * (1 << 30)) // bs), bs,
                                      (1 << 20) + 7)
        plan = b"".join(blocks)
        nbytes = len(plan)
        host = os.path.join(base, "plan.bin")
        with open(host, "wb") as f:
            f.write(plan)
        url = f"sqlite3://{base}/cp-meta.db"
        format_device_volume(url, os.path.join(base, "cp"), "sdkc")
        t0 = time.perf_counter()
        out = sdk_c_run(copier, url, host, "/plan.bin")
        child_s = time.perf_counter() - t0
        os.unlink(host)
        if out.returncode != 0:
            raise AssertionError(f"jfs_copy rc {out.returncode}:\n{out.stdout}"
                                 f"{out.stderr[-3000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"jfs_copy: {json.dumps(res)} ({child_s:.3f} s as a process)")
        report = child_index_report(out.stderr)
        if res["mismatches"] != 0 or res["bytes"] != nbytes:
            raise AssertionError(f"jfs_copy read back {res['mismatches']} mismatched "
                                 f"pieces of {res['bytes']} bytes, want 0 of {nbytes}")

        # 3. the meta: exactly the written file, no session left, digest
        # rows only for its blocks and equal to the numpy spec
        m, fmt = cmd.open_meta(url)
        ctx = Context(uid=0, gid=0)
        st, entries = m.readdir(ctx, 1)
        names = {bytes(e.name) for e in entries} - {b".", b".."}
        st, ino, attr = m.lookup(ctx, 1, b"plan.bin")
        if names != {b"plan.bin"} or st != 0 or attr.length != nbytes:
            raise AssertionError(f"volume lists {names} (plan.bin: errno {st})")
        if m.do_list_sessions():
            raise AssertionError("the C program left a session behind")
        order, spans = [], []
        for c in range(-(-nbytes // CHUNK_SIZE)):
            st, slices = m.read_chunk(ino, c)
            for sl in slices:
                if sl.id == 0 or sl.off != 0 or sl.len != sl.size:
                    raise AssertionError(f"chunk {c}: slice {sl} is not one fresh write")
                for i in range(-(-sl.size // bs)):
                    size = min(bs, sl.size - i * bs)
                    order.append(block_key(sl.id, i, size))
                    spans.append((c * CHUNK_SIZE + sl.pos + i * bs, size))
        rows = {block_key(sid, indx, bsize): d for sid, indx, bsize, d in m.scan_block_digests()}
        close_meta(m)
        stray = set(rows) - set(order)
        if len(order) != len(blocks) or stray:
            raise AssertionError(f"{len(order)} blocks in the file, want {len(blocks)}; "
                                 f"{len(stray)} digest rows for no block of it")
        by_order = [plan[off:off + size] for off, size in spans]
        del plan
        # the child's indexer, held as indexed_write holds one in-process:
        # no failed batch, rows for every block it hashed, and every other
        # block one it skipped under load; a row missing for another reason
        # fails the phase
        indexed = len(rows)
        dropped = report["skipped"]
        hashed = report["hashed"] if report["summary"] else len(order)
        missing_other = len(order) - indexed - dropped
        if report["failed"] or indexed == 0 or hashed != indexed or missing_other:
            raise AssertionError(
                f"the child's indexer: {report['failed']} blocks in failed batches, "
                f"{hashed} hashed, {dropped} skipped under load; {indexed} rows for "
                f"{len(order)} blocks ({missing_other} missing for another reason)")
        for key in [k for k in order[::max(1, len(order) // 8)] if k in rows] + \
                [k for k in order[-1:] if k in rows]:
            if rows[key] != jth256(by_order[order.index(key)]):
                raise AssertionError(f"{key}: digest row != numpy spec")

        # 4. gc --dedup (a fifth of the rows deleted) and fsck, counted here
        written = {"indexer": {"blocks": indexed, "dropped": dropped}, "rows": rows,
                   "order": order}
        gc, gc_s, gc_launches = dedup_gc(url, written, by_order, planted,
                                         os.path.join(base, "sdkc-index.json"), lost=5)
        m, _fmt = cmd.open_meta(url)
        tail = order[-1]
        tail_row = {block_key(sid, indx, bsize): d for sid, indx, bsize, d in
                    m.scan_block_digests()}.get(tail)
        close_meta(m)
        if tail_row != jth256(by_order[-1]):
            raise AssertionError(f"the tail's digest row {tail} != numpy spec")
        fsck_s, fsck_launches = verified_fsck(url, len(order))

        # 5. the port's FileSystem reads the file back byte for byte
        from juicefs_tpu_torch.fs import FileSystem
        from juicefs_tpu_torch.vfs import VFS

        m, fmt = cmd.open_meta(url)
        store = cmd.build_store(fmt, None, meta=m, with_indexer=False)
        vfs = VFS(m, store, fmt=fmt)
        try:
            f = FileSystem(vfs).open("/plan.bin")
            for (off, size), data in zip(spans, by_order):
                if f.pread(off, size) != data:
                    raise AssertionError(f"read back at {off}: bytes differ")
            f.close()
        finally:
            vfs.close()
            store.close()
            close_meta(m)
        gib = nbytes / (1 << 30)
        write_gibs, read_gibs = gib / res["write_seconds"], gib / res["read_seconds"]
        print(f"gates ok: example ALL OK on a pallas + lz4 volume; jfs_copy rc 0, 0 "
              f"mismatches; the volume lists only plan.bin with no session left; "
              f"the child's indexer hashed {indexed} blocks with no failed batch and "
              f"skipped {dropped} under load, {indexed} + {dropped} == {len(order)} "
              f"written, no row missing otherwise, no stray row, sampled rows and the "
              f"tail's == numpy spec; gc hashed_now "
              f"{gc['hashed_now']} (dropped + a fifth deleted) in {gc_launches} launches, "
              f"{gc['duplicate_blocks']} duplicates == planted; fsck verified "
              f"{len(order)} blocks in {fsck_launches} launches, 0 mismatches; the "
              f"port's FileSystem read the file back exact")
        print(f"sdk_c: C write {write_gibs:.4f} GiB/s ({res['write_seconds']:.3f} s, "
              f"{res['pieces']} pwrites), read {read_gibs:.4f} GiB/s "
              f"({res['read_seconds']:.3f} s), jfs_term {res['term_seconds']:.3f} s, child "
              f"{child_s:.3f} s; gc {gc_s:.3f} s, fsck {gib / fsck_s:.4f} GiB/s; phase "
              f"{time.perf_counter() - t_phase:.3f} s; card {smi}")
        return {"write_gibs": write_gibs, "read_gibs": read_gibs, "child_seconds": child_s,
                "indexed": indexed, "dropped": dropped,
                "launches": {"sdk_c_gc": gc_launches, "sdk_c_fsck": fsck_launches}}
    finally:
        shutil.rmtree(base, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--volume-gib", type=float, default=1.0)
    ap.add_argument("--compare-row-chain", metavar="DIR",
                    help="only build and time DIR's row-chain kernel beside this one")
    ap.add_argument("--compare-define", metavar="NAME=VALUE",
                    help="a macro for DIR's build under --compare-row-chain")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    smi, kind = device_phase()
    build_phase()
    plane_phase()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    if args.compare_row_chain:
        compare_phase(gen, smi, args.compare_row_chain, args.compare_define)
        end_phase()
        return 0
    err = kernel_phase(gen)
    digests_phase(rng)
    scan = scan_phase(rng, args.volume_gib)
    timing = timing_phase(gen, smi)
    breakdown = batch_breakdown_phase(rng)
    ingest = ingest_phase(rng, args.volume_gib)
    conc = concurrent_ingest_phase(rng, args.volume_gib)
    estimator_phase(rng)
    main_path = main_path_phase(rng, args.volume_gib, kind)
    serve = serve_phase(rng, args.volume_gib, smi)
    mount = mount_phase(rng, min(args.volume_gib, MOUNT_GIB), smi)
    placements = counter_value("juicefs_torch_shard_h2d_batches")
    if counter_value("juicefs_torch_shard_degraded") != 0:
        raise AssertionError("the process plane degraded during phases 5-13")
    print(f"phases 5-13 on the one-card plane: {int(placements)} placements, 0 degraded")
    shard = shard_phase(rng, args.volume_gib, timing, smi)
    objbench = objbench_phase(args.volume_gib, smi)
    bench = bench_phase(args.volume_gib, smi)
    sync = sync_phase(rng, smi)
    config = config_phase(rng, args.volume_gib, kind)
    meta = meta_phase(rng, args.volume_gib, kind, smi)
    group = group_phase(rng, args.volume_gib, kind, smi)
    stores = stores_phase(rng, kind, smi)
    shim = sdk_c_phase(rng, args.volume_gib, kind, smi)
    end_phase()
    by_path = {"scan": scan["launches"]["jth256_row_chain"],
               "ingest": ingest["launches"]["jth256_row_chain"],
               "ingest_cold_scan": ingest["cold_scan_launches"]["jth256_row_chain"],
               "ingest_concurrent": conc["launches"]["jth256_row_chain"],
               **main_path["launches"], **serve["launches"], **mount["launches"],
               **shard["launches"], **objbench["launches"], **bench["launches"],
               **sync["launches"], **config["launches"], **meta["launches"],
               **group["launches"], **stores["launches"], **shim["launches"]}
    # a read of the counts on a one-card path (launches()) fails unless it
    # saw one combine per row chain; the phases that kept the whole count
    # (launch_counts()) and the shard phase give the combines they read
    combine_by_path = {**by_path,
                       "scan": scan["launches"]["jth256_combine"],
                       "ingest": ingest["launches"]["jth256_combine"],
                       "ingest_cold_scan": ingest["cold_scan_launches"]["jth256_combine"],
                       "ingest_concurrent": conc["launches"]["jth256_combine"],
                       **shard["combine_launches"]}
    print(f"launches of jth256_row_chain: {by_path} ({args.volume_gib} GiB each: scan, "
          "ingest, its cold scan, concurrent ingest, indexed write, gc, fsck; then the "
          "gateway's index batches, the SDK's, gc --compact --dedup, fsck; then the "
          "mount's ingest and index batches, fsck and the mount process; then the "
          "sharded hash and scan over 2x1, 2x2, 4x2 and the odd 3, scan_many, and the "
          "multichip ingest and scan on 2x2; then objbench's indexer and the gateway's "
          "under objbench over s3://, the mount's indexer under bench, the gateway's and "
          "the webdav process's under sync, and gc --dedup after config; then the "
          "redis:// volume's indexer, fsck on the replica URL and gc after the AOF "
          "restart, and the sql:// volume's indexer, gc and fsck; then the cache-group "
          "volume's inline ingest, fsck and gc; then the sqlite3://, redis:// and encrypted "
          "blob-store volumes' indexer, gc and fsck; then gc and fsck after the C shim's "
          "jfs_copy); card " + smi)
    idle = [p for p in ("index", "fsck", "serve_index", "mount_ingest", "mount_process",
                        "objbench_index", "objbench_s3_gateway", "bench_index",
                        "sync_gateway", "sync_webdav", "config_gc", "meta_redis_index",
                        "meta_redis_fsck", "meta_redis_gc", "meta_sql_index", "meta_sql_gc",
                        "meta_sql_fsck", "group_ingest", "group_fsck", "group_gc",
                        *stores["launches"], *shim["launches"])
            if by_path[p] == 0]
    if idle:
        raise AssertionError(f"paths that launched no row-chain kernel: {idle}")
    print(f"card {smi}: ingest {ingest['gibs']:.4f} GiB/s (1 writer), "
          f"{conc['gibs']:.4f} GiB/s (4 writers); scan {scan['gibs']} GiB/s; indexed "
          f"write {main_path['write_gibs']:.4f} GiB/s, gc --dedup {main_path['gc_seconds']:.3f} "
          f"s, fsck --verify-data {main_path['fsck_gibs']:.4f} GiB/s; gateway PUT "
          f"{serve['put_gibs']:.4f} GiB/s ({serve['put_ops']:.2f} ops/s), GET "
          f"{serve['get_gibs']:.4f} GiB/s, SDK read {serve['sdk_read_gibs']:.4f} GiB/s; "
          f"mount (kernel, {mount['mounter']}) write {mount['write_gibs']:.4f} GiB/s, cold read "
          f"{mount['read_gibs']:.4f} GiB/s; objbench put {objbench['file']['put_MiB_s']} MiB/s, "
          f"get {objbench['file']['get_MiB_s']} MiB/s, hash "
          f"{objbench['file']['hash']['hash_mib_s']} MiB/s; bench {json.dumps(bench['bench'])}; "
          f"sync {sync['mib_s']:.2f} MiB/s; BASELINE #3 fsck --verify-data on redis:// "
          f"{meta['redis']['fsck_gibs']:.4f} GiB/s, on sql:// {meta['sql']['fsck_gibs']:.4f} "
          f"GiB/s; cache group: write {group['write_gibs']:.4f} GiB/s, warmup "
          f"{group['warmup_gibs']:.4f} GiB/s, blackout read {group['blackout_gibs']:.4f} GiB/s, "
          f"fsck {group['fsck_gibs']:.4f} GiB/s, gc {group['gc_seconds']:.3f} s; blob stores "
          f"{json.dumps(stores['legs'])} (encrypted leg {stores['encrypted']}); C shim "
          f"write {shim['write_gibs']:.4f} GiB/s, read {shim['read_gibs']:.4f} GiB/s")
    print(f"total {time.perf_counter() - t_start:.3f} s")
    print(f"launches of jth256_combine: {combine_by_path}; card {smi}")
    print(f"hash batch of 32 blocks: {breakdown['hash_ms']:.4f} ms in two launches "
          f"(lane digests {breakdown['lane_digests_ms']:.4f}, combine "
          f"{breakdown['combine_ms']:.4f}) against {breakdown['kernel_ms']:.4f} + "
          f"{breakdown['fold_ms']:.3f} ms for the states epilogue and the plain fold; "
          f"card {smi}")
    at_32 = timing["sizes"][32]
    big = timing["sizes"][TIMING_BLOCKS[-1]]
    print(json.dumps({"kernels": [{
        # one kernel, two C entries: the main path launches the lane-digests
        # entry alone (every read of the counts holds the row-chain launches
        # to the lane-digests ones), so its launches and times are that
        # entry's; the states entry's times stand beside them
        "name": "jth256_row_chain",
        "route": "cuda",
        "source": "juicefs_tpu_torch/gpu/kernels/jth256_row_chain.cu",
        "replaces": "juicefs_tpu/tpu/hash_jax.py:174",
        "shape": f"{TIMING_LANES} lanes (1 GiB) through jth256_lane_digests, the entry "
                 "the main path launches",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(err["jth256_row_chain"], err["jth256_lane_digests"]),
        "ms": big["lane_digests_ms"],
        "plain_ms": big["lane_digests_plain_ms"],
        "bound_ms": big["lane_digests_bound_ms"],
        "bound_by": big["lane_digests_bound_by"],
        "library_ms": None,
        "states_entry": {"entry": "jth256_row_chain", "main_path_launches": 0,
                         "ms": timing["ms"], "plain_ms": timing["plain_ms"],
                         "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"]},
    }, {
        "name": "jth256_combine",
        "route": "cuda",
        "source": "juicefs_tpu_torch/gpu/kernels/jth256_combine.cu",
        "replaces": "juicefs_tpu/tpu/hash_jax.py:103",
        "shape": "32 blocks x 64 lanes (the main path's hash batch)",
        "launches": sum(combine_by_path.values()),
        "launches_by_path": combine_by_path,
        "max_abs_err": err["jth256_combine"],
        "ms": at_32["combine_ms"],
        "plain_ms": at_32["combine_plain_ms"],
        "bound_ms": at_32["combine_bound_ms"],
        "bound_by": at_32["combine_bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
