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
that a path went through the kernel.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(KERNEL_DIR)))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_ext")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: dict[str, int] = {"jth256_row_chain": 0}
# seconds each library took to compile in this process (absent: loaded
# from an earlier build)
BUILD_SECONDS: dict[str, float] = {}

_lock = threading.Lock()
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


def load_library(name: str) -> ctypes.CDLL:
    """Build (once) and load `<name>.cu` as a ctypes library."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(KERNEL_DIR, name + ".cu")
        so = os.path.join(BUILD_DIR, f"lib{name}-{_sources_digest()}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-I", KERNEL_DIR, "-o", tmp, src],
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {name} (rc {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
            BUILD_SECONDS[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        _libs[name] = lib
        return lib


def row_chain_function():
    """The C entry point of jth256_row_chain.cu, with its ctypes signature."""
    fn = load_library("jth256_row_chain").jth256_row_chain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def load_twin():
    """Build the CPU twin (jth256_twin.cpp, g++) with
    torch.utils.cpp_extension.load and return its module;
    `row_chain(words, m, tweak)` takes int32 (L, 128, 128) words on the CPU."""
    from torch.utils.cpp_extension import load

    build = os.path.join(REPO_ROOT, "build", "torch_ext", "twin")
    os.makedirs(build, exist_ok=True)
    return load(name="jth256_twin",
                sources=[os.path.join(KERNEL_DIR, "jth256_twin.cpp")],
                extra_include_paths=[KERNEL_DIR], extra_cflags=["-O2"],
                build_directory=build, verbose=False)
