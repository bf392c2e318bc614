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
launch of the row-chain kernel under either epilogue (states or lane
digests), `jth256_lane_digests` those of the digests epilogue alone, and
`jth256_combine` the per-block combine. The gauge
`juicefs_torch_kernel_launches{kernel}` reads the same counts, so another
process (a mount's `.stats` or `/metrics`) shows them too.
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

LAUNCHES: dict[str, int] = {"jth256_row_chain": 0, "jth256_lane_digests": 0,
                            "jth256_combine": 0}
# the source file each C entry is built from
ENTRY_SOURCES = {"jth256_row_chain": "jth256_row_chain",
                 "jth256_lane_digests": "jth256_row_chain",
                 "jth256_combine": "jth256_combine"}
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


# (words, out, n_lanes, m, lane_offset, tweak, stream)
_CHAIN_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
_SIGNATURES = {
    "jth256_row_chain": _CHAIN_SIGNATURE,
    "jth256_lane_digests": _CHAIN_SIGNATURE,
    # (accs, lane_counts, lengths, out, n_blocks, m, stream)
    "jth256_combine": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p],
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
    and lengths and returns int64 (B, 8)."""
    from torch.utils.cpp_extension import load

    build = os.path.join(REPO_ROOT, "build", "torch_ext", "twin")
    os.makedirs(build, exist_ok=True)
    return load(name="jth256_twin",
                sources=[os.path.join(KERNEL_DIR, "jth256_twin.cpp")],
                extra_include_paths=[KERNEL_DIR], extra_cflags=["-O2"],
                build_directory=build, verbose=False)
