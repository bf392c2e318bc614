"""Prefix wrapper (reference: pkg/object/prefix.go) — namespaces every key
under a fixed prefix, used to pack multiple volumes into one bucket."""

from __future__ import annotations

from typing import Iterator

from .interface import Obj, ObjectStorage


class _Prefixed(ObjectStorage):
    def __init__(self, store: ObjectStorage, prefix: str):
        self._s = store
        self._p = prefix

    def string(self) -> str:
        return self._s.string() + self._p

    def create(self) -> None:
        self._s.create()

    def get(self, key, off=0, limit=-1):
        return self._s.get(self._p + key, off, limit)

    def put(self, key, data):
        self._s.put(self._p + key, data)

    def delete(self, key):
        self._s.delete(self._p + key)

    def head(self, key) -> Obj:
        o = self._s.head(self._p + key)
        return Obj(key=key, size=o.size, mtime=o.mtime, is_dir=o.is_dir)

    def copy(self, dst, src):
        self._s.copy(self._p + dst, self._p + src)

    def list_all(self, prefix: str = "", marker: str = "") -> Iterator[Obj]:
        m = self._p + marker if marker else ""
        for o in self._s.list_all(self._p + prefix, m):
            yield Obj(key=o.key[len(self._p):], size=o.size, mtime=o.mtime, is_dir=o.is_dir)

    def create_multipart_upload(self, key):
        return self._s.create_multipart_upload(self._p + key)

    def upload_part(self, key, upload_id, num, data):
        return self._s.upload_part(self._p + key, upload_id, num, data)

    def complete_upload(self, key, upload_id, parts):
        self._s.complete_upload(self._p + key, upload_id, parts)

    def abort_upload(self, key, upload_id):
        self._s.abort_upload(self._p + key, upload_id)


def with_prefix(store: ObjectStorage, prefix: str) -> ObjectStorage:
    return _Prefixed(store, prefix)
