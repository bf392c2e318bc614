"""Entry/attr TTL caches for the VFS (a copy of juicefs_tpu/vfs/cache.py).

Role-match to the reference's client-side metadata caching: the kernel
caches FUSE attrs/entries for the negotiated TTLs (pkg/fuse Serve attr/
entry timeouts) and pkg/fs keeps its own entry cache for the SDK path
(pkg/fs/fs.go:130). Here one cache layer serves every adapter (FUSE,
gateway, SDK): without it each lookup/getattr is a full meta round trip —
over `redis://` that is a network RTT per stat.

Coherence contract (same as a kernel attr cache): entries expire after
the configured TTL, so another client's change becomes visible at most
TTL seconds later; this client's own mutations invalidate synchronously,
so read-your-own-writes always holds. TTL 0 disables caching entirely.
"""

from __future__ import annotations

import threading
import time
from typing import Hashable, Optional


class TTLCache:
    """Thread-safe TTL map with lazy expiry and bounded size."""

    def __init__(self, ttl: float, maxsize: int = 100_000):
        self.ttl = ttl
        self.maxsize = maxsize
        self._data: dict[Hashable, tuple[object, float]] = {}
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.ttl > 0

    def get(self, key: Hashable):
        if not self.enabled:
            return None
        with self._lock:
            item = self._data.get(key)
            if item is None:
                return None
            value, expires = item
            if time.monotonic() >= expires:
                del self._data[key]
                return None
            return value

    def put(self, key: Hashable, value) -> None:
        if not self.enabled:
            return
        with self._lock:
            if len(self._data) >= self.maxsize:
                self._sweep_locked()
            self._data[key] = (value, time.monotonic() + self.ttl)

    def invalidate(self, key: Hashable) -> None:
        with self._lock:
            self._data.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def _sweep_locked(self) -> None:
        now = time.monotonic()
        dead = [k for k, (_, exp) in self._data.items() if now >= exp]
        for k in dead:
            del self._data[k]
        if len(self._data) >= self.maxsize:  # all fresh: drop oldest half
            for k in list(self._data)[: self.maxsize // 2]:
                del self._data[k]

    def __len__(self) -> int:
        return len(self._data)


class MetaCache:
    """The VFS's attr + dentry + readdir caches with mutation hooks."""

    def __init__(self, attr_ttl: float, entry_ttl: float,
                 dir_ttl: float = 0.0):
        self.attrs = TTLCache(attr_ttl)      # ino -> Attr (as stored in meta)
        self.entries = TTLCache(entry_ttl)   # (parent, name) -> ino
        # (ino, want_attr) -> list[Entry]: full readdir snapshots
        # (reference pkg/vfs readdir cache / pkg/fs dirStream cache)
        self.dirs = TTLCache(dir_ttl, maxsize=10_000)
        # reverse index: member ino -> dir-snapshot keys holding its attr.
        # Attr-ful snapshots must honor read-your-own-writes: a hardlink/
        # chmod/write on a member invalidates every snapshot that embeds
        # its (now stale) attr — READDIRPLUS primes the kernel attr cache
        # straight from these snapshots, so staleness here would surface
        # in stat() (caught by the POSIX oracle harness).
        self._dir_members: dict[int, set] = {}
        self._members_lock = threading.Lock()
        # publication guard: a snapshot whose attrs were read BEFORE a
        # concurrent mutation must not be published AFTER it (the mutation
        # could not invalidate what was not yet registered). Callers take
        # dir_read_begin() before the meta read and hand the token to
        # put_dir, which discards the publish if any attr mutated since.
        self._mutation_gen = 0

    # -- reads -------------------------------------------------------------
    def get_attr(self, ino: int):
        return self.attrs.get(ino)

    def put_attr(self, ino: int, attr) -> None:
        self.attrs.put(ino, attr)

    def get_entry(self, parent: int, name: bytes) -> Optional[int]:
        return self.entries.get((parent, name))

    def put_entry(self, parent: int, name: bytes, ino: int) -> None:
        self.entries.put((parent, name), ino)

    # -- invalidation (local mutations) ------------------------------------
    def invalidate_attr(self, ino: int) -> None:
        self.attrs.invalidate(ino)
        self._drop_member_snapshots(ino)

    def attr_mutated(self, ino: int, attr) -> None:
        """A LOCAL mutation produced this fresh attr: cache it, but drop
        every attr-bearing dir snapshot embedding the old one
        (read-your-own-writes for READDIRPLUS/SDK listings). put_attr
        alone is for read-path refreshes, where snapshot staleness is
        within the TTL contract."""
        self.attrs.put(ino, attr)
        self._drop_member_snapshots(ino)

    def _drop_member_snapshots(self, ino: int) -> None:
        with self._members_lock:
            self._mutation_gen += 1
            keys = self._dir_members.pop(ino, None)
        if keys:
            for key in keys:
                self.dirs.invalidate(key)

    def dir_read_begin(self) -> int:
        """Token for put_dir: take BEFORE reading the listing from meta."""
        with self._members_lock:
            return self._mutation_gen

    def invalidate_entry(self, parent: int, name: bytes) -> int | None:
        """Drop one dentry; returns the ino it pointed to if cached (so the
        caller can invalidate its attr too, e.g. nlink after unlink)."""
        ino = self.entries.get((parent, name))
        self.entries.invalidate((parent, name))
        self.invalidate_dir(parent)
        return ino

    # -- readdir snapshots --------------------------------------------------
    def get_dir(self, ino: int, want_attr: bool):
        return self.dirs.get((ino, want_attr))

    def put_dir(self, ino: int, want_attr: bool, entries,
                gen: int | None = None) -> None:
        key = (ino, want_attr)
        if not (want_attr and self.dirs.enabled):
            self.dirs.put(key, entries)
            return
        # gen-check, publish, and member registration are ONE critical
        # section: a mutation between any two of them would leave a stale
        # snapshot that invalidation can never find (lock order here is
        # members_lock -> dirs lock, same as _drop_member_snapshots)
        reset = False
        with self._members_lock:
            if gen is not None and self._mutation_gen != gen:
                # an attr mutated between the meta read and here: the
                # snapshot may embed the pre-mutation attr and the
                # mutation could not invalidate it — don't publish
                return
            if len(self._dir_members) > 100_000:
                # lazily-expired snapshots leave stale rows behind;
                # resetting must OVER-invalidate: dropping the index
                # while keeping the snapshots would disconnect them
                # from mutation invalidation permanently
                self._dir_members.clear()
                reset = True
            if reset:
                self.dirs.clear()
            self.dirs.put(key, entries)
            for e in entries:
                if e.name in (b".", b".."):
                    # never registered: the kernel gets zeroed attrs
                    # for these, and indexing them would evict every
                    # child snapshot on any parent namespace change
                    continue
                self._dir_members.setdefault(e.inode, set()).add(key)

    def invalidate_dir(self, ino: int) -> None:
        self.dirs.invalidate((ino, False))
        self.dirs.invalidate((ino, True))

    def clear(self) -> None:
        self.attrs.clear()
        self.entries.clear()
        self.dirs.clear()
