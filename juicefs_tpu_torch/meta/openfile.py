"""Client-side open-file attr/chunk cache (reference: pkg/meta/openfile.go:44).

Caches attributes and per-chunk slice lists for files the client holds open,
so repeated reads avoid metadata round trips. Invalidation happens on any
mutating op through the owning BaseMeta.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .types import Attr, Slice


class _OpenFile:
    __slots__ = ("attr", "refs", "last", "chunks")

    def __init__(self, attr: Attr):
        self.attr = attr
        self.refs = 1
        self.last = time.time()
        self.chunks: dict[int, list[Slice]] = {}


class OpenFiles:
    def __init__(self, expire: float = 10.0):
        self.expire = expire
        self._files: dict[int, _OpenFile] = {}
        self._lock = threading.Lock()
        # invalidation fan-out: BaseMeta hooks the lease cache here so
        # every existing of.invalidate site (including the ones inside
        # engine transactions) also drops the meta-level attr lease
        # — called OUTSIDE the lock below.
        self.on_invalidate = None

    @staticmethod
    def _content_changed(old: Attr, new: Attr) -> bool:
        """Another writer touched the data: cached chunks must go
        (reference openfile.go Update — mtime/length comparison)."""
        return (
            old.mtime != new.mtime
            or old.mtimensec != new.mtimensec
            or old.length != new.length
        )

    def open(self, ino: int, attr: Optional[Attr],
             trusted: bool = True) -> None:
        """``trusted=False`` registers the reference WITHOUT caching the
        attr as servable: a degraded open may carry a
        stale-lease attr whose staleness is ceiling-checked and counted
        at the lease layer — caching it here would re-serve it as fresh
        for `expire` seconds, uncounted and unbounded."""
        with self._lock:
            of = self._files.get(ino)
            if of is None:
                of = self._files[ino] = _OpenFile(attr or Attr())
                if not trusted:
                    of.last = 0.0  # registered, but attr never serves
            elif not trusted:
                of.refs += 1  # keep whatever trusted state exists
            else:
                of.refs += 1
                if attr is not None:
                    if self._content_changed(of.attr, attr):
                        of.chunks.clear()
                    of.attr = attr
                of.last = time.time()

    def close(self, ino: int) -> bool:
        """Returns True when this was the last reference."""
        with self._lock:
            of = self._files.get(ino)
            if of is None:
                return True
            of.refs -= 1
            if of.refs <= 0:
                del self._files[ino]
                return True
            return False

    def is_open(self, ino: int) -> bool:
        with self._lock:
            return ino in self._files

    def attr(self, ino: int) -> Optional[Attr]:
        with self._lock:
            of = self._files.get(ino)
            if of is None or time.time() - of.last > self.expire:
                return None
            return of.attr

    def update(self, ino: int, attr: Attr) -> None:
        """Refresh the cached attr; a content change detected here (mtime/
        length moved, e.g. another client wrote) drops the chunk cache —
        this is the cross-client invalidation path: stale chunks survive
        at most `expire` seconds, until the next attr refetch."""
        with self._lock:
            of = self._files.get(ino)
            if of is not None:
                if self._content_changed(of.attr, attr):
                    of.chunks.clear()
                of.attr = attr
                of.last = time.time()

    def chunk(self, ino: int, indx: int) -> Optional[list[Slice]]:
        with self._lock:
            of = self._files.get(ino)
            if of is None:
                return None
            if time.time() - of.last > self.expire:
                # attr is stale: chunks derived from it cannot be trusted
                # either (they may predate another client's write)
                of.chunks.clear()
                return None
            return of.chunks.get(indx)

    def cache_chunk(self, ino: int, indx: int, slices: list[Slice]) -> None:
        with self._lock:
            of = self._files.get(ino)
            if of is not None:
                of.chunks[indx] = slices

    def invalidate_chunk(self, ino: int, indx: int = -1) -> None:
        with self._lock:
            of = self._files.get(ino)
            if of is not None:
                if indx < 0:
                    of.chunks.clear()
                else:
                    of.chunks.pop(indx, None)

    def invalidate(self, ino: int) -> None:
        cb = self.on_invalidate
        if cb is not None:
            cb(ino)
        with self._lock:
            of = self._files.get(ino)
            if of is not None:
                of.last = 0.0
                of.chunks.clear()
