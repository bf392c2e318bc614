"""DataWriter: buffered, slice-ordered write pipeline (a copy of
juicefs_tpu/vfs/writer.py).

Mirrors the behavior of the reference's pkg/vfs/writer.go:

  - a file's writes split at 64 MiB chunk boundaries (fileWriter.Write
    writer.go:290) into per-chunk writers;
  - each contiguous run of bytes becomes one write-once *slice*
    (findWritableSlice writer.go:159: append to the open tail slice when the
    write continues it, else start a new slice);
  - block-complete data uploads asynchronously as it accumulates
    (chunk.WSlice.flush_to), and slices are committed to the metadata
    engine strictly in slice-creation order per chunk (commitThread
    writer.go:181-216) so a crash never exposes later writes without
    earlier ones;
  - flush()/fsync() is the barrier: finish every slice upload, then drain
    the ordered commits (fileWriter.flush writer.go:349);
  - a background flusher finishes slices idle for >5 s and chunks holding
    too many open slices (writer.go:181 auto-flush), bounding buffered
    memory and metadata staleness.

Threading model: one lock per file writer; the store's own upload pool does
the heavy lifting, so these locks are held only for buffer bookkeeping.
"""

from __future__ import annotations

import errno as _errno
import threading
import time
from typing import Optional

from ..chunk import CachedStore
from ..meta.base import BaseMeta
from ..meta.types import CHUNK_SIZE, Slice
from ..utils import get_logger, lockwatch

logger = get_logger("vfs.writer")

FLUSH_IDLE_SEC = 5.0
MAX_OPEN_SLICES_PER_CHUNK = 3


class SliceWriter:
    """One write-once slice being assembled (reference sliceWriter :68-125)."""

    __slots__ = ("id", "pos", "length", "ws", "done", "committed", "last_write")

    def __init__(self, sid: int, store: CachedStore, pos: int):
        self.id = sid
        self.pos = pos  # offset of this slice within its chunk
        self.length = 0
        self.ws = store.new_writer(sid)
        self.done = False
        self.committed = False
        self.last_write = time.monotonic()

    def writable_at(self, coff: int) -> bool:
        """Accept writes appending to, or rewriting within, the still-
        buffered tail (full blocks below are already uploaded)."""
        if self.done:
            return False
        uploaded = (self.length // self.ws.bs) * self.ws.bs
        return self.pos + uploaded <= coff <= self.pos + self.length

    def write(self, coff: int, data: bytes) -> None:
        off = coff - self.pos
        self.ws.write_at(data, off)
        self.length = max(self.length, off + len(data))
        # Upload any block this write just completed.
        self.ws.flush_to(self.length)
        self.last_write = time.monotonic()

    def finish(self) -> None:
        """Upload barrier (meta commit happens separately, in order)."""
        if not self.done:
            self.ws.finish(self.length)
            self.done = True


class ChunkWriter:
    """All open slices of one 64 MiB chunk (reference chunkWriter)."""

    def __init__(self, fw: "FileWriter", indx: int):
        self.fw = fw
        self.indx = indx
        self.slices: list[SliceWriter] = []

    def write(self, coff: int, data: bytes) -> int:
        sw = self._find_writable(coff)
        if sw is None:
            sw = SliceWriter(self.fw.dw.meta.new_slice(), self.fw.dw.store, coff)
            self.slices.append(sw)
        try:
            sw.write(coff, data)
        except IOError as e:
            logger.warning("write slice %d failed: %s", sw.id, e)
            return _errno.EIO
        return 0

    def _find_writable(self, coff: int) -> Optional[SliceWriter]:
        # Only the newest slice may accept writes: an older slice is
        # shadowed wherever they overlap, and appending to it could
        # resurrect stale bytes (reference findWritableSlice :159-179).
        if self.slices and self.slices[-1].writable_at(coff):
            return self.slices[-1]
        return None

    def commit_ready(self) -> int:
        """Commit the finished prefix of the slice list to meta, in order."""
        while self.slices and self.slices[0].done:
            sw = self.slices[0]
            slc = Slice(pos=sw.pos, id=sw.id, size=sw.length, off=0, len=sw.length)
            st = self.fw.dw.meta.write_chunk(self.fw.ino, self.indx, sw.pos, slc)
            if st != 0:
                logger.error("commit slice %d of ino %d: errno %d", sw.id, self.fw.ino, st)
                return st
            sw.committed = True
            self.slices.pop(0)
        return 0

    def flush(self) -> int:
        for sw in self.slices:
            try:
                sw.finish()
            except IOError as e:
                # Keep the slices: the error must stay visible to every
                # later flush/fsync (no silently-successful retry).
                logger.error("finish slice %d: %s", sw.id, e)
                return _errno.EIO
        return self.commit_ready()

    def overlaps(self, start: int, end: int) -> bool:
        return any(
            sw.pos < end and sw.pos + max(sw.length, 1) > start for sw in self.slices
        )

    def flush_idle(self, idle_before: float) -> int:
        """Finish slices idle past the deadline or beyond the open cap."""
        excess = len(self.slices) - MAX_OPEN_SLICES_PER_CHUNK
        for i, sw in enumerate(self.slices):
            if sw.done:
                continue
            if sw.last_write < idle_before or i < excess:
                try:
                    sw.finish()
                except IOError as e:
                    logger.error("finish slice %d: %s", sw.id, e)
                    self.fw.err = _errno.EIO
                    return _errno.EIO
        return self.commit_ready()


class FileWriter:
    """Write state of one open file (reference fileWriter writer.go:35)."""

    def __init__(self, dw: "DataWriter", ino: int, length: int):
        self.dw = dw
        self.ino = ino
        self.length = length
        self.lock = threading.RLock()
        self.chunks: dict[int, ChunkWriter] = {}
        self.refs = 1
        # Sticky error (reference fileWriter err): once a flush fails, every
        # later write/flush reports it until the file is closed, so an
        # application retrying fsync cannot see a false success.
        self.err = 0

    def write(self, off: int, data: bytes) -> int:
        with self.lock:
            if self.err:
                return self.err
            pos = off
            mv = memoryview(data)
            while mv:
                indx, coff = divmod(pos, CHUNK_SIZE)
                n = min(len(mv), CHUNK_SIZE - coff)
                cw = self.chunks.get(indx)
                if cw is None:
                    cw = self.chunks[indx] = ChunkWriter(self, indx)
                # pass the view through: WSlice.write_at copies into its
                # block buffer, so a bytes() here would copy every byte
                # twice
                st = cw.write(coff, mv[:n])
                if st != 0:
                    return st
                mv = mv[n:]
                pos += n
            self.length = max(self.length, pos)
            return 0

    def flush(self) -> int:
        # Intentional hold-while-blocking: flush IS the per-file commit
        # barrier — it waits out slice uploads under the file's own lock
        # so concurrent writers/readers of THIS file serialize against
        # the barrier.  Deadlock-free because upload-pool workers never
        # take FileWriter locks (docs/ARCHITECTURE.md "Checked
        # concurrency contracts").
        with self.lock, lockwatch.permit(
                "per-file flush barrier: upload workers never take "
                "FileWriter.lock, so waiting them out under it cannot "
                "cycle"):
            if self.err:
                return self.err
            for indx in sorted(self.chunks):
                st = self.chunks[indx].flush()
                if st != 0:
                    self.err = st
                    return st
            self.chunks = {i: c for i, c in self.chunks.items() if c.slices}
            return 0

    def flush_if_overlaps(self, off: int, size: int) -> int:
        """Flush only when buffered writes overlap [off, off+size); avoids
        finalizing the open tail slice on every interleaved read."""
        with self.lock:
            if self.err:
                return self.err
            start_indx, end_indx = off // CHUNK_SIZE, (off + size - 1) // CHUNK_SIZE
            for indx in range(start_indx, end_indx + 1):
                cw = self.chunks.get(indx)
                if cw is None:
                    continue
                c0 = max(off - indx * CHUNK_SIZE, 0)
                c1 = min(off + size - indx * CHUNK_SIZE, CHUNK_SIZE)
                if cw.overlaps(c0, c1):
                    return self.flush()
            return 0

    def has_pending(self) -> bool:
        with self.lock:
            return any(c.slices for c in self.chunks.values())

    def _background_flush(self) -> None:
        with self.lock, lockwatch.permit(
                "idle-slice flush: same per-file barrier contract as "
                "FileWriter.flush"):
            deadline = time.monotonic() - FLUSH_IDLE_SEC
            for cw in list(self.chunks.values()):
                cw.flush_idle(deadline)
            self.chunks = {i: c for i, c in self.chunks.items() if c.slices}


class DataWriter:
    """Per-mount writer registry + background flusher (writer.go:512-559)."""

    def __init__(self, meta: BaseMeta, store: CachedStore, flush_interval: float = 1.0):
        self.meta = meta
        self.store = store
        self._files: dict[int, FileWriter] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._flusher = threading.Thread(
            target=self._flush_loop, args=(flush_interval,), daemon=True,
            name="vfs-writer-flush",
        )
        self._flusher.start()

    def buffered_bytes(self) -> int:
        """Bytes currently held in un-uploaded write buffers — the memory
        accounting the reference keeps in pkg/utils/alloc.go + the
        used_buffer_size_bytes gauge (vfs.go:1290)."""
        total = 0
        with self._lock:
            writers = list(self._files.values())
        for fw in writers:
            with fw.lock:
                for cw in fw.chunks.values():
                    for sw in cw.slices:
                        for buf in sw.ws._blocks.values():
                            total += len(buf)
        return total

    def open(self, ino: int, length: int) -> FileWriter:
        with self._lock:
            fw = self._files.get(ino)
            if fw is None:
                fw = self._files[ino] = FileWriter(self, ino, length)
            else:
                fw.refs += 1
                fw.length = max(fw.length, length)
            return fw

    def close(self, ino: int) -> int:
        with self._lock:
            fw = self._files.get(ino)
            if fw is None:
                return 0
            fw.refs -= 1
            if fw.refs > 0:
                return 0
        # Flush while the writer is still registered: a concurrent open()
        # must find (and reuse) it, not create a second writer whose newer
        # slices could be shadowed by our late commits.
        st = fw.flush()
        with self._lock:
            if fw.refs == 0 and self._files.get(ino) is fw:
                self._files.pop(ino, None)
        return st

    def find(self, ino: int) -> Optional[FileWriter]:
        with self._lock:
            return self._files.get(ino)

    def flush(self, ino: int) -> int:
        fw = self.find(ino)
        return fw.flush() if fw is not None else 0

    def flush_all(self) -> int:
        with self._lock:
            files = list(self._files.values())
        st = 0
        for fw in files:
            st = fw.flush() or st
        # flush_all is the unmount/takeover barrier: the slice commits
        # queued above must also clear the meta write batch
        st2 = self.meta.sync_meta()
        return st or st2

    def get_length(self, ino: int) -> Optional[int]:
        """Buffered (not yet committed) length, for read-your-writes."""
        fw = self.find(ino)
        return fw.length if fw is not None else None

    def truncate(self, ino: int, length: int) -> None:
        fw = self.find(ino)
        if fw is not None:
            with fw.lock:
                fw.length = length

    def close_all(self) -> None:
        self._stop.set()  # wake the flusher out of its interval sleep
        self.flush_all()
        self._flusher.join(timeout=10.0)

    def _flush_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            with self._lock:
                files = list(self._files.values())
            for fw in files:
                try:
                    fw._background_flush()
                except Exception:
                    logger.exception("background flush of ino %d", fw.ino)
