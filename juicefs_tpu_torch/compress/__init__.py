"""Block compressors (a copy of juicefs_tpu/compress; reference
pkg/compress/compress.go:31-49).

The reference binds C libzstd / liblz4 through cgo; here the same native
libraries are bound directly:
  - LZ4 block format via ctypes -> system liblz4 (reference compress.go:107-120)
  - Zstd level 1 via the libzstd-backed `zstandard` module (compress.go:71-105)

Contract matches the reference Compressor interface:
  compress_bound(n) -> worst-case output size
  compress(data) -> bytes
  decompress(data, dst_size) -> bytes  (dst_size = exact original size,
  known from the block key's size field, as in the reference read path)
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

__all__ = ["Compressor", "new_compressor", "NoneCompressor", "LZ4Compressor", "ZstdCompressor"]


class Compressor:
    name = "none"

    def compress_bound(self, n: int) -> int:
        raise NotImplementedError

    def compress(self, data: bytes) -> bytes:
        raise NotImplementedError

    def decompress(self, data: bytes, dst_size: int) -> bytes:
        raise NotImplementedError


class NoneCompressor(Compressor):
    name = ""

    def compress_bound(self, n: int) -> int:
        return n

    def compress(self, data: bytes) -> bytes:
        return data  # pass-through: copying every 4 MiB block costs real bandwidth

    def decompress(self, data: bytes, dst_size: int) -> bytes:
        return data


class _LZ4Lib:
    _lib: Optional[ctypes.CDLL] = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls._lib is None:
            name = ctypes.util.find_library("lz4") or "liblz4.so.1"
            lib = ctypes.CDLL(name)
            lib.LZ4_compressBound.restype = ctypes.c_int
            lib.LZ4_compressBound.argtypes = [ctypes.c_int]
            # void* prototypes: the call sites pass raw buffer addresses so
            # a bytearray block never pays a bytes() copy on the way in
            lib.LZ4_compress_default.restype = ctypes.c_int
            lib.LZ4_compress_default.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ]
            lib.LZ4_decompress_safe.restype = ctypes.c_int
            lib.LZ4_decompress_safe.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ]
            cls._lib = lib
        return cls._lib


def _src_buffer(data):
    """(address, length, keepalive) of a bytes-like without copying.

    bytes/readonly views pin the object itself; bytearray/writable views
    export their buffer via a ctypes array (released when the keepalive
    drops at the end of the call).
    """
    if isinstance(data, memoryview) and not data.contiguous:
        data = bytes(data)
    n = len(data)
    if n == 0:
        return None, 0, data
    if isinstance(data, bytes):
        return ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value, n, data
    try:
        arr = (ctypes.c_char * n).from_buffer(data)
    except TypeError:  # readonly view: one copy, same as the old path
        data = bytes(data)
        return ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value, n, data
    return ctypes.addressof(arr), n, arr


class LZ4Compressor(Compressor):
    """LZ4 block format over system liblz4 (reference go-lz4 cgo binding).

    The ctypes crossing is zero-copy on both sides: a plain wrapper
    would pay a bytes() copy of the input, a create_string_buffer
    memset of the worst-case output, and a full-buffer .raw copy before
    the slice, far more than LZ4 itself costs on an incompressible 4 MiB
    block. The destination is
    a per-thread buffer reused across calls; only the compressed `n`
    bytes are copied out. Output stays byte-identical.
    """

    name = "lz4"

    def __init__(self):
        self._lib = _LZ4Lib.get()
        self._local = threading.local()

    def compress_bound(self, n: int) -> int:
        return self._lib.LZ4_compressBound(n)

    def _dst(self, bound: int):
        buf = getattr(self._local, "buf", None)
        if buf is None or len(buf) < bound:
            buf = (ctypes.c_char * bound)()
            self._local.buf = buf
        return buf

    def compress(self, data: bytes) -> bytes:
        src, n, keep = _src_buffer(data)
        bound = self.compress_bound(n)
        dst = self._dst(bound)
        out = self._lib.LZ4_compress_default(src, ctypes.addressof(dst),
                                             n, bound)
        del keep
        if out <= 0:
            raise IOError("lz4 compression failed")
        return bytes(memoryview(dst)[:out])

    def decompress(self, data: bytes, dst_size: int) -> bytes:
        src, n, keep = _src_buffer(data)
        dst = self._dst(dst_size)
        out = self._lib.LZ4_decompress_safe(src, ctypes.addressof(dst),
                                            n, dst_size)
        del keep
        if out < 0:
            raise IOError(f"lz4 decompression failed: {out}")
        return bytes(memoryview(dst)[:out])


class ZstdCompressor(Compressor):
    """Zstd level 1 (reference compress.go:71: DataDog/zstd level 1).

    zstandard context objects wrap a single ZSTD_CCtx/DCtx and are NOT
    thread safe — concurrent compress() on one instance segfaults. The
    chunk store's upload pool and objbench both compress from worker
    threads, so contexts are per-thread here (the reference gets this for
    free: DataDog/zstd's stateless API creates a cctx per call).
    """

    name = "zstd"

    def __init__(self, level: int = 1):
        import zstandard

        self._zstd = zstandard
        self._level = level
        self._local = threading.local()

    def _ctxs(self):
        c = getattr(self._local, "c", None)
        if c is None:
            self._local.c = self._zstd.ZstdCompressor(level=self._level)
            self._local.d = self._zstd.ZstdDecompressor()
        return self._local

    def compress_bound(self, n: int) -> int:
        return n + (n >> 8) + 64

    def compress(self, data: bytes) -> bytes:
        return self._ctxs().c.compress(data)

    def decompress(self, data: bytes, dst_size: int) -> bytes:
        return self._ctxs().d.decompress(data, max_output_size=dst_size)


def new_compressor(algo: str) -> Compressor:
    algo = (algo or "").lower()
    if algo in ("", "none"):
        return NoneCompressor()
    if algo == "lz4":
        return LZ4Compressor()
    if algo in ("zstd", "zstd1"):
        return ZstdCompressor(1)
    raise ValueError(f"unknown compress algorithm: {algo}")
