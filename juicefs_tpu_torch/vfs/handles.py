"""Open-handle table (a copy of juicefs_tpu/vfs/handles.py; reference:
pkg/vfs/handle.go:32-263).

A handle binds a kernel file descriptor to per-open state: flags, the
FileReader/FileWriter pair for regular files, a readdir snapshot for
directories, and reader/writer op accounting used to serialize flushes
against in-flight reads/writes. POSIX/BSD lock owners hang off the handle
too (lock state itself lives in the meta engine so it is cluster-wide).
"""

from __future__ import annotations

import threading
from typing import Optional

from ..meta.types import Entry


class Handle:
    def __init__(self, fh: int, ino: int, flags: int = 0):
        self.fh = fh
        self.ino = ino
        self.flags = flags
        self.reader = None  # FileReader
        self.writer = None  # FileWriter
        self.children: Optional[list[Entry]] = None  # readdir snapshot
        self.read_off = 0  # last sequential read end (readdir offset cache)
        self.lock_owner = 0
        self._cond = threading.Condition()
        self._readers = 0
        self._writers = 0

    # Op accounting: flush must wait out in-flight data ops on this handle
    # (reference handle.go Rlock/Wlock with interruptible wait).
    def begin_read(self) -> None:
        with self._cond:
            self._readers += 1

    def end_read(self) -> None:
        with self._cond:
            self._readers -= 1
            self._cond.notify_all()

    def begin_write(self) -> None:
        with self._cond:
            self._writers += 1

    def end_write(self) -> None:
        with self._cond:
            self._writers -= 1
            self._cond.notify_all()

    def wait_quiet(self, timeout: float = 30.0) -> bool:
        """Wait until no data op is in flight (for flush/release)."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._readers == 0 and self._writers == 0, timeout
            )


class HandleTable:
    def __init__(self):
        self._lock = threading.Lock()
        self._next = 1
        self._handles: dict[int, Handle] = {}
        self._by_ino: dict[int, list[Handle]] = {}

    def new(self, ino: int, flags: int = 0) -> Handle:
        with self._lock:
            fh = self._next
            self._next += 1
            h = Handle(fh, ino, flags)
            self._handles[fh] = h
            self._by_ino.setdefault(ino, []).append(h)
            return h

    def insert(self, fh: int, ino: int, flags: int = 0) -> Handle:
        """Recreate a handle with a FIXED fh — seamless-upgrade restore
        (reference handle.go:312-415): the kernel keeps using the fh
        numbers the predecessor issued."""
        with self._lock:
            h = Handle(fh, ino, flags)
            self._handles[fh] = h
            self._by_ino.setdefault(ino, []).append(h)
            if fh >= self._next:
                self._next = fh + 1
            return h

    def get(self, fh: int) -> Optional[Handle]:
        with self._lock:
            return self._handles.get(fh)

    def of_ino(self, ino: int) -> list[Handle]:
        with self._lock:
            return list(self._by_ino.get(ino, ()))

    def remove(self, fh: int) -> Optional[Handle]:
        with self._lock:
            h = self._handles.pop(fh, None)
            if h is not None:
                lst = self._by_ino.get(h.ino, [])
                if h in lst:
                    lst.remove(h)
                if not lst:
                    self._by_ino.pop(h.ino, None)
            return h

    def count(self) -> int:
        with self._lock:
            return len(self._handles)

    def all(self) -> list[Handle]:
        with self._lock:
            return list(self._handles.values())
