"""Per-object CRC32C transfer checksums (a copy of juicefs_tpu/object/
checksum.py; reference: pkg/object/checksum.go:28-88).

The reference attaches a CRC32C of the body as request metadata and verifies
on full-object GET. Here the wrapper stores `crc32c(body)` in an 8-byte
header (magic + crc) prepended to the body, so any store can carry it and
an object written by either package reads back in the other. Ranged reads
skip verification, matching the reference (it only checks full-object
reads).
"""

from __future__ import annotations

import struct
from typing import Iterator

from .interface import Obj, ObjectStorage

_MAGIC = 0x4A464353  # "JFCS"
_HDR = struct.Struct(">II")  # magic, crc32c


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C via the port's native library (SSE4.2); native falls back to
    crc32c_py itself when no toolchain is available."""
    from .. import native

    return native.crc32c(data, crc)


class _Checksummed(ObjectStorage):
    def __init__(self, store: ObjectStorage):
        self._s = store

    def string(self) -> str:
        return self._s.string()

    def create(self) -> None:
        self._s.create()

    def put(self, key, data):
        self._s.put(key, _HDR.pack(_MAGIC, crc32c(data)) + data)

    def get(self, key, off=0, limit=-1):
        if off == 0 and limit < 0:
            raw = self._s.get(key)
            if len(raw) >= _HDR.size:
                magic, crc = _HDR.unpack_from(raw)
                if magic == _MAGIC:
                    body = raw[_HDR.size:]
                    if crc32c(body) != crc:
                        raise IOError(f"checksum mismatch for {key}")
                    return body
            return raw  # legacy/unwrapped object
        # ranged read: shift past header, skip verification (reference behavior)
        return self._s.get(key, off + _HDR.size, limit)

    def delete(self, key):
        self._s.delete(key)

    def head(self, key) -> Obj:
        o = self._s.head(key)
        return Obj(key=o.key, size=max(o.size - _HDR.size, 0), mtime=o.mtime, is_dir=o.is_dir)

    def list_all(self, prefix: str = "", marker: str = "") -> Iterator[Obj]:
        for o in self._s.list_all(prefix, marker):
            yield Obj(key=o.key, size=max(o.size - _HDR.size, 0), mtime=o.mtime, is_dir=o.is_dir)


def new_checksummed(store: ObjectStorage) -> ObjectStorage:
    return _Checksummed(store)
