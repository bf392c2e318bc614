"""Hand-written CUDA kernels of the port and their loader.

Sources live beside this file. Nothing is built when the module is
imported: `load_library(name)` compiles `<name>.cu` with nvcc for sm_90a
into `<repo>/build/torch_ext` at the first launch, as a shared library
with a plain C interface that the wrapper calls through ctypes (pointers
from `Tensor.data_ptr()`, the stream from the current torch stream). The
library name carries a digest of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.

`LAUNCHES` counts, per kernel, the launches its wrapper made; a run sets
the counts to 0 with `reset_launches()` and reads them afterwards to show
that a path went through the kernel. `jth256_row_chain` counts every
launch of the row-chain kernel under any entry, `jth256_block_digests`
those of the entry that also combines each block (a one-card hash batch),
`jth256_block_digests_estimate` those of the entry that also estimates
each block for the compress plane (a one-card ingest hash batch),
`jth256_lane_digests` those of the lane-fold entry alone (a lane shard of
a mesh), and `jth256_combine` the per-block combine kernel that a
lane-split mesh runs after its gather. `jth256_block_cta` counts the
block batches of the first two keys that the one-CTA design took (blocks
of at most CTA_BLOCK_LANES lanes, a block in one CTA: `block_entry`); they
count under their entry's key as well. `jth256_block_cta_estimate` counts
those of them that also estimate (`jth256_block_cta_digests_estimate`,
each block's estimate on a warp of its own beside its lanes' chains: a
small-file close). `compress_histogram` and
`compress_entropy` count the two entries a mesh's estimate runs (a
histogram per shard, an entropy per data row). The gauge
`juicefs_torch_kernel_launches{kernel}` reads the same counts, so another
process (a mount's `.stats` or `/metrics`) shows them too.

The row chain's ring depth is a launch argument of its entries;
`ring_depth` picks it from the launch's lane count, the card's SM count
and the entry's resident CTAs an SM at each depth (`row_chain_occupancy`).
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ...metric import global_registry

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(KERNEL_DIR)))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_ext")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: dict[str, int] = {"jth256_row_chain": 0, "jth256_block_digests": 0,
                            "jth256_block_digests_estimate": 0,
                            "jth256_lane_digests": 0, "jth256_combine": 0,
                            "compress_histogram": 0, "compress_entropy": 0,
                            "jth256_block_cta": 0, "jth256_block_cta_estimate": 0}
# the source file each C entry is built from
ENTRY_SOURCES = {"jth256_block_digests": "jth256_row_chain",
                 "jth256_block_digests_estimate": "jth256_row_chain",
                 "jth256_block_cta_digests": "jth256_row_chain",
                 "jth256_block_cta_digests_estimate": "jth256_row_chain",
                 "jth256_lane_digests": "jth256_row_chain",
                 "jth256_combine": "jth256_combine",
                 "compress_histogram": "compress_estimate",
                 "compress_entropy": "compress_estimate"}
_LAUNCH_GAUGE = global_registry().gauge(
    "juicefs_torch_kernel_launches",
    "Launches of each hand-written CUDA kernel since the last reset",
    labels=("kernel",),
)
for _name in LAUNCHES:
    _LAUNCH_GAUGE.labels(_name).set_function(lambda name=_name: LAUNCHES[name])

# seconds each library took to compile in this process (absent: loaded
# from an earlier build)
BUILD_SECONDS: dict[str, float] = {}

_lock = threading.Lock()
_build_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(KERNEL_DIR, "*.cu"))
                       + glob.glob(os.path.join(KERNEL_DIR, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_sources_digest()}.so")


def _start_build(name: str):
    """Start nvcc on `<name>.cu` unless its library is built; returns
    (process, temporary output, library path, start time) or None."""
    so = _library_path(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-I", KERNEL_DIR, "-o", tmp,
         os.path.join(KERNEL_DIR, name + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so, time.perf_counter()


def _finish_build(name: str, started) -> None:
    """Wait for a build `_start_build` started; raises if nvcc failed."""
    proc, tmp, so, t0 = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name} (rc {proc.returncode}):\n{out}")
    os.replace(tmp, so)
    BUILD_SECONDS[name] = time.perf_counter() - t0


def _build_lock(name: str) -> threading.Lock:
    with _lock:
        return _build_locks.setdefault(name, threading.Lock())


def load_library(name: str) -> ctypes.CDLL:
    """Build (once) and load `<name>.cu` as a ctypes library."""
    with _build_lock(name):
        lib = _libs.get(name)
        if lib is not None:
            return lib
        started = _start_build(name)
        if started is not None:
            _finish_build(name, started)
        lib = ctypes.CDLL(_library_path(name))
        _libs[name] = lib
        return lib


_SIGNATURES = {
    # (words, out, n_lanes, m, lane_offset, tweak, depth, stream)
    "jth256_lane_digests": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                            ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                            ctypes.c_void_p],
    # (words, lane_digests, lane_counts, lengths, arrivals, out, n_blocks, m,
    #  tweak, depth, stream)
    "jth256_block_digests": [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_uint,
                                                     ctypes.c_uint, ctypes.c_uint,
                                                     ctypes.c_void_p],
    # (words, lane_digests, lane_counts, lengths, arrivals, out, counts,
    #  advisories, n_blocks, m, tweak, depth, stream)
    "jth256_block_digests_estimate": [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p],
    # (words, lane_counts, lengths, out, n_blocks, m, tweak, depth, stream)
    "jth256_block_cta_digests": [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p],
    # (words, lane_counts, lengths, out, advisories, n_blocks, m, tweak,
    #  depth, stream)
    "jth256_block_cta_digests_estimate": [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p],
    # (accs, lane_counts, lengths, out, n_blocks, m, stream)
    "jth256_combine": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p],
    # (words, lane_counts, work, out, n_blocks, m, lane_offset, stream)
    "compress_histogram": [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_uint,
                                                   ctypes.c_uint, ctypes.c_void_p],
    # (hist, out, n_blocks, stream)
    "compress_entropy": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_void_p],
}


_fns: dict[str, object] = {}


def function(entry: str):
    """The C entry point `entry` (a key of ENTRY_SOURCES), with its ctypes
    signature; its library is built at the first call."""
    fn = _fns.get(entry)
    if fn is None:
        fn = getattr(load_library(ENTRY_SOURCES[entry]), entry)
        fn.argtypes = _SIGNATURES[entry]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


# The row chain's ring (jth256_row_chain.cu): 1-16 chunks of 4 KiB a lane
# CTA, chosen for each launch by `ring_depth`. RING_BYTES_IN_FLIGHT is what
# the card's memory needs in flight to stay busy: ~2.5 us of an H100's
# 3.35 TB/s, where a sweep of every depth at 1-32 blocks put the fastest
# ring (PERF.md section 6). A batch that no depth puts in one wave takes
# LARGE_BATCH_DEPTH (32 KiB a lane). A block entry's last CTA a block
# stages the block's lane digests (LANE_DIGEST_BYTES a lane) in its ring.
RING_DEPTHS = range(1, 17)
RING_CHUNK_BYTES = 4096
RING_BYTES_IN_FLIGHT = 8 << 20
LARGE_BATCH_DEPTH = 8
LANE_DIGEST_BYTES = 32
# The one-CTA design of the two block entries: a block of up to 8 lanes
# (8 x 128 threads, the most a CTA has) runs in one CTA, each lane through
# its own ring of 1-8 chunks of 8 KiB (CTA_RING_DEPTHS), and hands nothing
# to another CTA. Its jth256_block_cta_* entries take every batch whose
# pack has at most CTA_BLOCK_LANES lanes a block (256 KiB); longer blocks
# keep the cross-CTA entries. The cut is 4, not 8: one SM streams all of a
# block's lanes, and from 5 lanes on that stream outlasts the handoff the
# design saves (on an H100, the estimating entry at 1 and 8 blocks:
# 0.95-0.97x the cross-CTA entry's time at 4 lanes, 1.02-1.04x at 5,
# 1.10-1.13x at 6, 1.27-1.34x at 8; PERF.md section 6).
CTA_BLOCK_LANES = 4
CTA_CHUNK_BYTES = 8192
CTA_RING_DEPTHS = range(1, 9)
CTA_ENTRIES = {"jth256_block_digests": "jth256_block_cta_digests",
               "jth256_block_digests_estimate": "jth256_block_cta_digests_estimate"}
# the code jth256_row_chain_occupancy takes for each row-chain entry
_OCCUPANCY_ENTRY = {"jth256_lane_digests": 0, "jth256_block_digests": 1,
                    "jth256_block_digests_estimate": 2, "jth256_block_cta_digests": 3,
                    "jth256_block_cta_digests_estimate": 4}


def block_entry(entry: str, m: int) -> str:
    """The C entry that runs a batch of `entry` (a block entry) whose
    blocks have m lanes: its one-CTA design up to CTA_BLOCK_LANES lanes,
    else the entry itself."""
    return CTA_ENTRIES[entry] if m <= CTA_BLOCK_LANES else entry


def is_cta_entry(entry: str) -> bool:
    """Whether `entry` is a one-CTA block entry."""
    return entry in CTA_ENTRIES.values()


def ring_depth(n_lanes: int, sms: int, ctas: dict[int, int], staged: int = 0,
               lanes_per_cta: int = 1, chunk_bytes: int = RING_CHUNK_BYTES) -> int:
    """The ring depth, in chunks of `chunk_bytes` a lane, of a row-chain
    launch over n_lanes lanes, `lanes_per_cta` a CTA, on a card of `sms`
    SMs, where ctas[d] CTAs of the entry fit on an SM at depth d (0: the
    CTA cannot hold that ring), and a ring has to hold `staged` bytes (a
    block entry's lane digests of a block): the shallowest ring that keeps
    RING_BYTES_IN_FLIGHT in flight across the launch, or the deepest one
    below it at which every CTA is resident at once (ceil(CTAs / sms) an
    SM), so that the launch is one wave; 32 KiB a lane (LARGE_BATCH_DEPTH
    chunks of 4 KiB), or the deepest ring a CTA holds, where no depth is;
    never one too small for `staged`. A deeper ring only queues more bytes
    ahead of the chains, which then finish later. On an H100 the residency
    binds only past 16 CTAs an SM (2112 one-lane CTAs)."""
    least = max(min(ctas), -(-staged // chunk_bytes))
    deepest = max(d for d, n in ctas.items() if n > 0)
    need = -(-n_lanes // (lanes_per_cta * sms))
    want = -(-RING_BYTES_IN_FLIGHT // (n_lanes * chunk_bytes))
    for depth in range(min(max(want, least), deepest), least - 1, -1):
        if ctas[depth] >= need:
            return depth
    return max(min(LARGE_BATCH_DEPTH * RING_CHUNK_BYTES // chunk_bytes, deepest), least)


def waves(n_ctas: int, sms: int, ctas: int) -> int:
    """The waves a launch of n_ctas CTAs needs when `ctas` fit on each of
    `sms` SMs."""
    return -(-n_ctas // (sms * ctas))


def row_chain_occupancy(entry: str, lanes: int = 1) -> dict[int, int]:
    """The resident CTAs per SM of the row-chain entry `entry` on the
    current device at each of its ring depths (RING_DEPTHS; CTA_RING_DEPTHS
    for a one-CTA entry, whose CTA holds a block of `lanes` lanes), 0 where
    a CTA cannot hold the ring (the library is built at the first call)."""
    fn = getattr(load_library(ENTRY_SOURCES[entry]), "jth256_row_chain_occupancy")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    table = {}
    for depth in CTA_RING_DEPTHS if is_cta_entry(entry) else RING_DEPTHS:
        ctas = ctypes.c_int(0)
        rc = fn(_OCCUPANCY_ENTRY[entry], lanes, depth, ctypes.byref(ctas))
        if rc != 0:
            raise RuntimeError(f"jth256_row_chain_occupancy({entry}, {lanes}, {depth}) "
                               f"failed: CUDA error {rc}")
        table[depth] = ctas.value
    return table


def build_all() -> dict[str, float]:
    """Build every kernel source at once, one nvcc process each started
    side by side and then waited on; returns the seconds each build took
    (absent: loaded as built)."""
    names = sorted(set(ENTRY_SOURCES.values()))
    with contextlib.ExitStack() as held:
        for name in names:  # in sorted order, so two callers cannot deadlock
            held.enter_context(_build_lock(name))
        started = {name: _start_build(name) for name in names if name not in _libs}
        try:
            for name, build in started.items():
                if build is not None:
                    _finish_build(name, build)
        finally:
            for build in started.values():
                if build is not None and build[0].poll() is None:
                    build[0].kill()
                    build[0].wait()
    for name in names:
        load_library(name)
    return {n: BUILD_SECONDS[n] for n in names if n in BUILD_SECONDS}


def load_twin():
    """Build the CPU twin (jth256_twin.cpp, g++) with
    torch.utils.cpp_extension.load and return its module:
    `row_chain(words, m, tweak, lane_offset=0)` and `lane_digests(words, m,
    tweak, lane_offset=0)` take int32 (L, 128, 128) words on the CPU and
    return int32 (L, 128) states or (L, 8) digests; `combine(accs,
    lane_counts, lengths)` takes int32 (B, M, 8) digests and int64 counts
    and lengths and returns int64 (B, 8); `block_digests(words, m,
    lane_counts, lengths, tweak)` takes int32 (B*M, 128, 128) words and
    returns int64 (B, 8), as the block entry computes them;
    `block_digests_estimate(words, m, lane_counts, lengths, tweak)` those
    digests and float32 (B,) advisories, as the estimating entry computes
    them; `block_cta_digests_estimate(words, m, lane_counts, lengths,
    tweak)` the same pair as the one-CTA entries compute them, a block at
    a time, its live lanes alone;
    `estimate_histogram(words, lane_counts, lane_offset=0)` takes int32
    (B, M, 128, 128) words and int64 counts and returns int32 (B, 256)
    sampled byte counts, and `estimate_entropy(hist)` int32 (B, 256)
    counts and returns float32 (B,) advisories, as compress_estimate.cu's
    two entries compute them."""
    from torch.utils.cpp_extension import load

    build = os.path.join(REPO_ROOT, "build", "torch_ext", "twin")
    os.makedirs(build, exist_ok=True)
    return load(name="jth256_twin",
                sources=[os.path.join(KERNEL_DIR, "jth256_twin.cpp")],
                extra_include_paths=[KERNEL_DIR], extra_cflags=["-O2"],
                build_directory=build, verbose=False)
