"""Native data-plane core: ctypes bindings for libjfscore (C++), a copy of
juicefs_tpu/native.

The shared library builds on first use from `jfscore.cpp` (beside this
file) with the system `g++` into `<repo>/build/native/`, never next to the
source; the library name carries a digest of the source and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Every
entry point has a pure-Python fallback for a host with no compiler. This
is host code: the port's device path is the CUDA row chain, not this.

Exports:
    crc32c(data, crc=0)            hardware CRC32C (SSE4.2 when available)
    jth256(data) -> 32B digest     C++ JTH-256, byte-identical to the spec
    jth256_batch(blocks, threads)  multithreaded batch hash
    available() -> bool
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

from ..utils import get_logger

logger = get_logger("native")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jfscore.cpp")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_SRC)))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "native")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """Where the built library lives: build/native/libjfscore-<digest>.so."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libjfscore-{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    # Build to a per-pid temp name and atomically rename: concurrent
    # processes may both compile, but no one ever loads a half-written .so.
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        proc = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("native build unavailable: %s", e)
        return False
    if proc.returncode != 0:
        logger.warning("native build failed: %s", proc.stderr.decode()[:500])
        return False
    try:
        os.replace(tmp, so)
    except OSError as e:
        logger.warning("native build install failed: %s", e)
        return False
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.jfs_crc32c.restype = ctypes.c_uint32
            lib.jfs_crc32c.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32,
            ]
            lib.jfs_jth256.restype = None
            lib.jfs_jth256.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
            ]
            lib.jfs_jth256_batch.restype = None
            lib.jfs_jth256_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_size_t,
                ctypes.c_char_p,
                ctypes.c_int,
            ]
            if lib.jfs_abi_version() != 1:
                raise OSError("jfscore ABI mismatch")
            _lib = lib
        except (OSError, AttributeError) as e:
            # AttributeError: stale .so missing a symbol — fall back too.
            logger.warning("libjfscore load failed: %s", e)
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _crc_table() -> list[int]:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE: list[int] = []


def crc32c_py(data: bytes, crc: int = 0) -> int:
    """Pure-Python CRC32C (Castagnoli): the fallback implementation."""
    if not _CRC_TABLE:
        _CRC_TABLE.extend(_crc_table())
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c(data: bytes, crc: int = 0) -> int:
    lib = _load()
    if lib is None:
        return crc32c_py(data, crc)
    return lib.jfs_crc32c(data, len(data), crc)


def jth256(data: bytes) -> bytes:
    lib = _load()
    if lib is None:
        from ..gpu.jth256 import jth256 as ref

        return ref(data)
    out = ctypes.create_string_buffer(32)
    lib.jfs_jth256(data, len(data), out)
    return out.raw


def jth256_batch(blocks: Sequence[bytes], threads: int = 0) -> list[bytes]:
    lib = _load()
    if lib is None:
        from ..gpu.jth256 import hash_blocks_np

        return hash_blocks_np(blocks)
    if not blocks:
        return []
    if threads <= 0:
        threads = min(len(blocks), os.cpu_count() or 1)
    n = len(blocks)
    # zero-copy pointers for bytes AND writable buffers (bytearray from
    # the WSlice block buffers — the ingest path hashes them in place;
    # the C side only reads, bounded by the explicit lengths)
    arr = (ctypes.c_char_p * n)()
    _keepalive = []
    for i, b in enumerate(blocks):
        if isinstance(b, bytes):
            arr[i] = b
        else:
            view = (ctypes.c_char * len(b)).from_buffer(b)
            _keepalive.append(view)
            arr[i] = ctypes.cast(view, ctypes.c_char_p)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in blocks])
    outs = ctypes.create_string_buffer(32 * n)
    lib.jfs_jth256_batch(
        ctypes.cast(arr, ctypes.POINTER(ctypes.c_char_p)), lens, n, outs, threads
    )
    return [outs.raw[i * 32 : (i + 1) * 32] for i in range(n)]
