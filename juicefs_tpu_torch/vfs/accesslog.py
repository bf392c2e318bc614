"""Access log: per-op trace stream (a copy of juicefs_tpu/vfs/accesslog.py;
reference pkg/vfs/accesslog.go:64-140).

Every VFS operation `logit`s a line, but lines are only materialized while
at least one reader holds the virtual `.accesslog` file open — otherwise
logging is a near-free atomic check, exactly like the reference. Each
reader gets its own bounded ring buffer so a slow consumer cannot block
the filesystem or other readers.
"""

from __future__ import annotations

import threading
import time
from collections import deque

MAX_BUFFERED_LINES = 10240


class AccessLogger:
    def __init__(self):
        self._lock = threading.Lock()
        self._readers: dict[int, deque[bytes]] = {}
        self._active = False

    def open_reader(self, fh: int) -> None:
        with self._lock:
            self._readers[fh] = deque(maxlen=MAX_BUFFERED_LINES)
            self._active = True

    def close_reader(self, fh: int) -> None:
        with self._lock:
            self._readers.pop(fh, None)
            self._active = bool(self._readers)

    @property
    def active(self) -> bool:
        return self._active

    def logit(self, op: str, args: str, err: int, dur: float, pid: int = 0,
              uid: int = 0, gid: int = 0) -> None:
        if not self._active:
            return
        ts = time.time()
        # real caller identity (reference accesslog.go logs the request's
        # uid/gid/pid, not the server's); line format otherwise unchanged
        line = (
            f"{time.strftime('%Y.%m.%d %H:%M:%S', time.localtime(ts))}"
            f".{int(ts % 1 * 1e6):06d} [uid:{uid},gid:{gid},pid:{pid}] "
            f"{op} ({args}): {'OK' if err == 0 else f'errno {err}'} "
            f"<{dur:.6f}>\n"
        ).encode()
        with self._lock:
            for buf in self._readers.values():
                buf.append(line)

    def read(self, fh: int, max_bytes: int = 1 << 16) -> bytes:
        """Drain buffered lines for one reader (blocking up to 1s like the
        reference's readers so `tail -f` style consumers don't spin)."""
        deadline = time.time() + 1.0
        while True:
            with self._lock:
                buf = self._readers.get(fh)
                if buf is None:
                    return b""
                out = bytearray()
                while buf:
                    line = buf[0]
                    if len(out) + len(line) > max_bytes:
                        # Never exceed the requested size: an oversized FUSE
                        # reply is rejected by the kernel (EIO). Split a
                        # line only when nothing fits otherwise.
                        if not out:
                            out += line[:max_bytes]
                            buf[0] = line[max_bytes:]
                        break
                    out += buf.popleft()
            if out or time.time() >= deadline:
                return bytes(out)
            time.sleep(0.02)
