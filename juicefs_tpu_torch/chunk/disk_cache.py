"""Disk block cache with writeback staging
(a copy of juicefs_tpu/chunk/disk_cache.py; reference
pkg/chunk/disk_cache.go).

Layout under each cache dir (reference disk_cache.go cachePath/stagePath):
    {dir}/raw/{key}       cached blocks (evictable, LRU by atime)
    {dir}/rawstaging/{key} writeback blocks not yet uploaded (NOT evictable)

Eviction keeps used space under `capacity` by removing oldest-atime entries
(reference disk_cache.go:688 cleanup). Staged blocks survive process death
and are rescanned on startup (reference disk_cache.go:870 scanStaging).

Multiple cache dirs are supported through `CacheManager`, hashing keys over
the dirs (reference disk_cache.go:922 cacheManager).
"""

from __future__ import annotations

import fcntl
import os
import struct
import threading
import time
import zlib
from typing import Optional

from ..utils import get_logger
from .mem_cache import _EVICT, _EVICT_BYTES, _HITS, _MISS

logger = get_logger("chunk.cache")

_HITS_DISK = _HITS.labels("disk")
_MISS_DISK = _MISS.labels("disk")
_EVICT_DISK = _EVICT.labels("disk")
_EVICT_BYTES_DISK = _EVICT_BYTES.labels("disk")

_TRAILER = struct.Struct("<4sI")  # magic + crc32 of the payload
_MAGIC = b"JFC1"


class DiskCache:
    def __init__(self, dirpath: str, capacity: int = 1 << 30,
                 checksum: bool = True, lock_timeout: float = 10.0):
        self.dir = dirpath
        self.capacity = capacity
        self.checksum = checksum
        self.lock_timeout = lock_timeout
        self._raw = os.path.join(dirpath, "raw")
        self._staging = os.path.join(dirpath, "rawstaging")
        os.makedirs(self._raw, exist_ok=True)
        os.makedirs(self._staging, exist_ok=True)
        self._acquire_dir_lock(dirpath)
        self._lock = threading.Lock()
        # key -> (size, atime); rebuilt from disk on startup
        self._index: dict[str, tuple[int, float]] = {}
        self._used = 0
        self._scan_existing()

    def _acquire_dir_lock(self, dirpath: str) -> None:
        """Exclusive per-directory lock file (reference disk_cache.go:
        157-198 lock-file liveness): two processes sharing one cache dir
        would corrupt each other's eviction accounting and staging."""
        path = os.path.join(dirpath, ".lock")
        self._lockfd = os.open(path, os.O_CREAT | os.O_RDWR, 0o600)
        # brief retry: a seamless-upgrade predecessor releases its lock at
        # process exit moments after handing the mount over
        deadline = time.time() + self.lock_timeout
        while True:
            try:
                fcntl.flock(self._lockfd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                if time.time() < deadline:
                    time.sleep(0.1)
                    continue
                owner = b"?"
                try:
                    owner = os.pread(self._lockfd, 32, 0).strip(b"\x00") or b"?"
                except OSError:
                    pass
                os.close(self._lockfd)
                raise RuntimeError(
                    f"cache dir {dirpath} is in use by another process "
                    f"(pid {owner.decode(errors='replace')}); pick a "
                    f"different --cache-dir per mount"
                )
        os.ftruncate(self._lockfd, 0)
        os.pwrite(self._lockfd, str(os.getpid()).encode(), 0)
        # The checksum mode is a property of the DIRECTORY, not the opener:
        # serving trailered entries without verification (or vice versa)
        # corrupts reads, and a raw payload can't be sniffed reliably.
        marker = os.path.join(self.dir, ".checksum")
        try:
            with open(marker) as f:
                persisted = f.read().strip() == "1"
            if persisted != self.checksum:
                logger.warning(
                    "cache dir %s was created with checksum=%s; honoring it",
                    self.dir, persisted,
                )
                self.checksum = persisted
        except FileNotFoundError:
            with open(marker, "w") as f:
                f.write("1" if self.checksum else "0")

    def _scan_existing(self) -> None:
        for dirpath, _, filenames in os.walk(self._raw):
            for fn in filenames:
                p = os.path.join(dirpath, fn)
                key = os.path.relpath(p, self._raw).replace(os.sep, "/")
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                self._index[key] = (st.st_size, st.st_atime)
                self._used += st.st_size

    def _raw_path(self, key: str) -> str:
        return os.path.join(self._raw, key)

    def _stage_path(self, key: str) -> str:
        return os.path.join(self._staging, key)

    def cache(self, key: str, data: bytes) -> None:
        path = self._raw_path(key)
        # _used/_index always account the ON-DISK size (payload + trailer),
        # matching _scan_existing, so eviction targets are computed against
        # real disk usage
        ondisk = len(data) + (_TRAILER.size if self.checksum else 0)
        with self._lock:
            if key in self._index:
                return
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # per-thread tmp name, and the index entry is published only
            # AFTER the atomic replace: a concurrent cache() of the same
            # key (writer done-callback vs read populate) must neither
            # corrupt a shared tmp file nor make load() miss while the
            # first writer is still mid-write — block contents for one
            # key are immutable, so last-replace-wins is safe
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "wb") as f:
                f.write(data)
                if self.checksum:
                    # trailer checked on every load: silent media bitrot
                    # becomes a cache miss instead of corrupt reads
                    # (reference disk_cache.go checksum-on-read option)
                    f.write(_TRAILER.pack(_MAGIC, zlib.crc32(data)))
            os.replace(tmp, path)
        except OSError as e:
            logger.warning("cache write failed %s: %s", key, e)
            return
        with self._lock:
            if key in self._index:
                return  # racing writer published the same content first
            self._index[key] = (ondisk, time.time())
            self._used += ondisk
        self._maybe_evict()

    def contains(self, key: str) -> bool:
        """Cheap membership probe against the in-memory index — no file
        open, no payload read, no CRC, no hit/miss accounting (the
        prefetch planner's skip check).  The index can lag the
        disk contents across a restart scan; a false negative only costs
        one redundant prefetch enqueue."""
        with self._lock:
            return key in self._index

    def load(self, key: str, count_miss: bool = True) -> Optional[bytes]:
        """count_miss semantics: see MemCache.load — speculative probes
        pass False so each real miss is counted once."""
        path = self._raw_path(key)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            # also serve from staging (writeback block not yet uploaded)
            try:
                with open(self._stage_path(key), "rb") as f:
                    data = f.read()
                _HITS_DISK.inc()
                return data
            except OSError:
                if count_miss:
                    _MISS_DISK.inc()
                return None
        if self.checksum:
            if len(data) >= _TRAILER.size:
                magic, crc = _TRAILER.unpack_from(data, len(data) - _TRAILER.size)
            else:
                magic = b""
            if magic != _MAGIC:
                self._drop_corrupt(key, "missing checksum trailer")
                if count_miss:
                    _MISS_DISK.inc()
                return None
            data = data[: len(data) - _TRAILER.size]
            if zlib.crc32(data) != crc:
                self._drop_corrupt(key, "crc mismatch (bitrot?)")
                if count_miss:
                    _MISS_DISK.inc()
                return None
        with self._lock:
            item = self._index.get(key)
            if item is not None:
                # refresh atime only; the recorded size stays the on-disk
                # size so accounting doesn't drift from real usage
                self._index[key] = (item[0], time.time())
        _HITS_DISK.inc()
        return data

    def _drop_corrupt(self, key: str, why: str) -> None:
        """Self-heal: evict the bad entry; the caller refetches from the
        object store."""
        logger.warning("cache entry %s dropped: %s", key, why)
        self.remove(key)

    def remove(self, key: str) -> None:
        with self._lock:
            item = self._index.pop(key, None)
            if item is not None:
                self._used -= item[0]
        for p in (self._raw_path(key), self._stage_path(key)):
            try:
                os.unlink(p)
            except OSError:
                pass

    def _maybe_evict(self) -> None:
        with self._lock:
            if self._used <= self.capacity:
                return
            victims = sorted(self._index.items(), key=lambda kv: kv[1][1])
            to_free = self._used - int(self.capacity * 0.8)  # evict to 80%
            freed = 0
            doomed = []
            for key, (size, _) in victims:
                doomed.append(key)
                freed += size
                if freed >= to_free:
                    break
            for key in doomed:
                item = self._index.pop(key, None)
                if item is not None:
                    self._used -= item[0]
                    _EVICT_DISK.inc()
                    _EVICT_BYTES_DISK.inc(item[0])
        for key in doomed:
            try:
                os.unlink(self._raw_path(key))
            except OSError:
                pass

    # -- writeback staging -------------------------------------------------
    def stage(self, key: str, data: bytes) -> Optional[str]:
        """Persist a block pending upload; returns its path
        (reference disk_cache.go:655 stage)."""
        path = self._stage_path(key)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return path
        except OSError as e:
            logger.warning("stage failed %s: %s", key, e)
            return None

    def uploaded(self, key: str, size: int) -> None:
        """Move a staged block into the normal cache after upload
        (reference disk_cache.go uploaded). The staged copy is NEVER
        mutated: the checksum trailer is written while copying into raw/
        (tmp + rename), so a crash at any point leaves either a pristine
        raw staging file (re-uploaded verbatim on restart) or a complete
        trailered cache entry — never a trailered staging file that
        recovery would re-upload with 8 extra bytes."""
        spath = self._stage_path(key)
        rpath = self._raw_path(key)
        try:
            os.makedirs(os.path.dirname(rpath), exist_ok=True)
            if not self.checksum:
                # no trailer to add: the atomic rename is already crash-safe
                # and costs no block copy
                os.replace(spath, rpath)
            else:
                with open(spath, "rb") as f:
                    data = f.read()
                if 0 < size < len(data):
                    # legacy trailered staging file whose re-stage failed
                    # during recovery: the caller knows the true payload
                    # size — never enshrine the stale tail in the cache
                    data = data[:size]
                tmp = rpath + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                    f.write(_TRAILER.pack(_MAGIC, zlib.crc32(data)))
                os.replace(tmp, rpath)
            st = os.stat(rpath)
            with self._lock:
                if key not in self._index:
                    self._index[key] = (st.st_size, time.time())
                    self._used += st.st_size
            if self.checksum:
                # crash between replace and unlink is safe: restart
                # re-uploads (idempotent PUT) and lands here again
                os.unlink(spath)
        except OSError:
            pass
        self._maybe_evict()

    @staticmethod
    def strip_stale_trailer(raw: bytes, expect_size: int) -> bytes:
        """Recover the payload of a staging file longer than its block size.
        Older versions trailered staging files in place before renaming; a
        crash in that window left payload + (possibly partial) trailer.
        Staged payloads are fully written + fsynced before their own rename,
        so anything past expect_size is junk from that legacy append —
        truncate to the block size parsed from the key."""
        if 0 < expect_size < len(raw):
            return raw[:expect_size]
        return raw

    def scan_staging(self) -> dict[str, str]:
        """key -> path of blocks written back before a crash
        (reference disk_cache.go:870 scanStaging)."""
        out = {}
        for dirpath, _, filenames in os.walk(self._staging):
            for fn in filenames:
                if fn.endswith(".tmp"):
                    continue
                p = os.path.join(dirpath, fn)
                out[os.path.relpath(p, self._staging).replace(os.sep, "/")] = p
        return out

    def stats(self) -> tuple[int, int]:
        with self._lock:
            return len(self._index), self._used

    def close(self) -> None:
        """Release the dir lock (a crashed process releases it
        automatically; this is for orderly shutdown and tests)."""
        if getattr(self, "_lockfd", -1) >= 0:
            try:
                os.close(self._lockfd)
            except OSError:
                pass
            self._lockfd = -1


class CacheManager:
    """Hash keys over multiple cache dirs (reference disk_cache.go:922)."""

    def __init__(self, dirs: list[str], capacity: int = 1 << 30,
                 checksum: bool = True):
        self._stores = [
            DiskCache(d, capacity // max(len(dirs), 1), checksum=checksum)
            for d in dirs
        ]

    def _pick(self, key: str) -> DiskCache:
        return self._stores[zlib.crc32(key.encode()) % len(self._stores)]

    def cache(self, key, data):
        self._pick(key).cache(key, data)

    def contains(self, key) -> bool:
        return self._pick(key).contains(key)

    def load(self, key, count_miss: bool = True):
        return self._pick(key).load(key, count_miss)

    def remove(self, key):
        self._pick(key).remove(key)

    def stage(self, key, data):
        return self._pick(key).stage(key, data)

    def uploaded(self, key, size):
        self._pick(key).uploaded(key, size)

    def scan_staging(self):
        out = {}
        for s in self._stores:
            out.update(s.scan_staging())
        return out

    def stats(self):
        n, used = 0, 0
        for s in self._stores:
            a, b = s.stats()
            n += a
            used += b
        return n, used

    def close(self):
        for s in self._stores:
            s.close()
