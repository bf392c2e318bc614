"""In-process object store (a copy of juicefs_tpu/object/mem.py;
reference pkg/object/mem.go) — the hermetic
test backend that makes the whole stack runnable without services."""

from __future__ import annotations

import threading
import time
import uuid
from typing import Iterator

from .interface import MultipartUpload, NotFoundError, Obj, ObjectStorage, Part


class MemStorage(ObjectStorage):
    def __init__(self, name: str = ""):
        self.name = name
        self._data: dict[str, tuple[bytes, float]] = {}
        self._uploads: dict[str, dict[int, bytes]] = {}
        self._lock = threading.RLock()

    def string(self) -> str:
        return f"mem://{self.name}"

    def get(self, key: str, off: int = 0, limit: int = -1) -> bytes:
        with self._lock:
            if key not in self._data:
                raise NotFoundError(key)
            data, _ = self._data[key]
        if limit < 0:
            return data[off:]
        return data[off : off + limit]

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._data[key] = (bytes(data), time.time())

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def head(self, key: str) -> Obj:
        with self._lock:
            if key not in self._data:
                raise NotFoundError(key)
            data, mtime = self._data[key]
            return Obj(key=key, size=len(data), mtime=mtime)

    def list_all(self, prefix: str = "", marker: str = "") -> Iterator[Obj]:
        with self._lock:
            keys = sorted(k for k in self._data if k.startswith(prefix) and k > marker)
            snapshot = [(k, len(self._data[k][0]), self._data[k][1]) for k in keys]
        for k, size, mtime in snapshot:
            yield Obj(key=k, size=size, mtime=mtime)

    def create_multipart_upload(self, key: str):
        uid = uuid.uuid4().hex
        with self._lock:
            self._uploads[uid] = {}
        return MultipartUpload(min_part_size=1 << 20, max_count=10000, upload_id=uid)

    def upload_part(self, key: str, upload_id: str, num: int, data: bytes) -> Part:
        with self._lock:
            self._uploads[upload_id][num] = bytes(data)
        return Part(num=num, etag=str(num), size=len(data))

    def complete_upload(self, key: str, upload_id: str, parts: list[Part]) -> None:
        with self._lock:
            chunks = self._uploads.pop(upload_id)
            self._data[key] = (b"".join(chunks[p.num] for p in sorted(parts, key=lambda p: p.num)), time.time())

    def abort_upload(self, key: str, upload_id: str) -> None:
        with self._lock:
            self._uploads.pop(upload_id, None)
