"""In-RAM block cache (a copy of juicefs_tpu/chunk/mem_cache.py;
reference pkg/chunk/mem_cache.go) — used with
`cache_dir="memory"` (gc/fsck runs) and in tests."""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..metric import global_registry

_reg = global_registry()
# shared across tiers; children pre-resolved per module (labels() locks)
_HITS = _reg.counter(
    "juicefs_blockcache_hits", "Block cache lookups served locally", ("tier",)
)
_MISS = _reg.counter(
    "juicefs_blockcache_miss", "Block cache lookups that missed", ("tier",)
)
_EVICT = _reg.counter(
    "juicefs_blockcache_evict", "Blocks evicted from the cache", ("tier",)
)
_EVICT_BYTES = _reg.counter(
    "juicefs_blockcache_evict_bytes", "Bytes evicted from the cache", ("tier",)
)
_HITS_MEM = _HITS.labels("mem")
_MISS_MEM = _MISS.labels("mem")
_EVICT_MEM = _EVICT.labels("mem")
_EVICT_BYTES_MEM = _EVICT_BYTES.labels("mem")


class MemCache:
    def __init__(self, capacity: int = 256 << 20):
        self.capacity = capacity
        self._data: dict[str, tuple[bytes, float]] = {}
        self._used = 0
        self._lock = threading.Lock()

    def cache(self, key: str, data: bytes) -> None:
        with self._lock:
            if key in self._data:
                return
            # no defensive copy: callers hand over buffers they no longer
            # mutate (the upload done-callback passes the popped block
            # bytearray; read loads pass immutable bytes) — a 4 MiB copy
            # per cached block is measurable on the single-core write path
            self._data[key] = (data, time.time())
            self._used += len(data)
            while self._used > self.capacity and self._data:
                victim = min(self._data, key=lambda k: self._data[k][1])
                buf, _ = self._data.pop(victim)
                self._used -= len(buf)
                _EVICT_MEM.inc()
                _EVICT_BYTES_MEM.inc(len(buf))

    def contains(self, key: str) -> bool:
        """Cheap membership probe (no bytes, no hit/miss accounting, no
        recency bump): the prefetch planner's skip check."""
        with self._lock:
            return key in self._data

    def load(self, key: str, count_miss: bool = True) -> Optional[bytes]:
        """count_miss=False marks a speculative probe whose miss will be
        re-checked (and counted) by the authoritative load — so one real
        miss increments the counter exactly once."""
        with self._lock:
            item = self._data.get(key)
            if item is None:
                if count_miss:
                    _MISS_MEM.inc()
                return None
            data, _ = item
            self._data[key] = (data, time.time())
        _HITS_MEM.inc()
        return data

    def remove(self, key: str) -> None:
        with self._lock:
            item = self._data.pop(key, None)
            if item is not None:
                self._used -= len(item[0])

    def stats(self) -> tuple[int, int]:
        with self._lock:
            return len(self._data), self._used

    # staging interface (no-op for memory cache: writeback not supported)
    def stage(self, key: str, data: bytes) -> Optional[str]:
        return None

    def uploaded(self, key: str, size: int) -> None:
        pass

    def scan_staging(self) -> dict[str, str]:
        return {}
