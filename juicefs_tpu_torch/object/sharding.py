"""Sharding wrapper (reference: pkg/object/sharding.go:29-58) — fans keys
out over N stores by key hash for bucket-level scale-out."""

from __future__ import annotations

import heapq
import zlib
from typing import Iterator

from ..metric import global_registry
from .interface import Obj, ObjectStorage

_SHARD_OPS = global_registry().counter(
    "juicefs_object_shard_ops", "Object ops routed to each shard", ("shard",)
)


class _Sharded(ObjectStorage):
    def __init__(self, stores: list[ObjectStorage]):
        if not stores:
            raise ValueError("sharded: need at least one store")
        self._stores = stores
        self._shard_ops = [_SHARD_OPS.labels(str(i)) for i in range(len(stores))]

    def _pick(self, key: str) -> ObjectStorage:
        # stable fnv-ish hash by key, like the reference's hash-by-name
        h = zlib.crc32(key.encode()) & 0xFFFFFFFF
        i = h % len(self._stores)
        self._shard_ops[i].inc()
        return self._stores[i]

    def string(self) -> str:
        return f"shard{len(self._stores)}://[{self._stores[0].string()}...]"

    def create(self) -> None:
        for s in self._stores:
            s.create()

    def get(self, key, off=0, limit=-1):
        return self._pick(key).get(key, off, limit)

    def put(self, key, data):
        self._pick(key).put(key, data)

    def delete(self, key):
        self._pick(key).delete(key)

    def head(self, key) -> Obj:
        return self._pick(key).head(key)

    def list_all(self, prefix: str = "", marker: str = "") -> Iterator[Obj]:
        # ordered merge across shards (reference sharding.go ListAll)
        iters = [s.list_all(prefix, marker) for s in self._stores]
        yield from heapq.merge(*iters, key=lambda o: o.key)

    def create_multipart_upload(self, key):
        return self._pick(key).create_multipart_upload(key)

    def upload_part(self, key, upload_id, num, data):
        return self._pick(key).upload_part(key, upload_id, num, data)

    def complete_upload(self, key, upload_id, parts):
        self._pick(key).complete_upload(key, upload_id, parts)

    def abort_upload(self, key, upload_id):
        self._pick(key).abort_upload(key, upload_id)


def sharded(stores: list[ObjectStorage]) -> ObjectStorage:
    return _Sharded(stores)
