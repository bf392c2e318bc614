"""Chunk compaction: merge a fragmented slice overlay into one slice (a
copy of juicefs_tpu/vfs/compact.py).

Reference pkg/vfs/compact.go:54 + pkg/meta/base.go:2009: read the chunk's
visible view, write it as a single new slice (zero-filling holes), then
transactionally swap the old slice list for the merged slice, decref'ing
the old slices (whose blocks get deleted when refs hit zero via the
DELETE_SLICE message). Concurrent appends during the rewrite survive: the
meta swap keeps any slices appended after the snapshot.
"""

from __future__ import annotations

from ..chunk.parallel import fetch_ordered
from ..meta.slice import build_slice
from ..meta.types import Slice
from ..qos import IOClass, scoped
from ..utils import get_logger

logger = get_logger("vfs.compact")

MIN_SLICES_TO_COMPACT = 2
# segment-read fan-out per compaction on the scheduler's "bulk" lane,
# NOT the store's download lane: RSlice.read submits block loads there
# and waits, and a bounded worker set waiting on itself deadlocks
# (docs/ARCHITECTURE.md "Concurrency model").  BACKGROUND class: the
# ambient-class demotion rule then keeps the nested block loads and the
# rewrite uploads at background priority too.
COMPACT_READ_WINDOW = 4


def compact_chunk(meta, store, ino: int, indx: int) -> bool:
    """Compact one chunk; True if a merge happened."""
    st, slices = meta.read_chunk(ino, indx)
    if st != 0 or len(slices) < MIN_SLICES_TO_COMPACT:
        return False
    snapshot = b"".join(s.encode() for s in slices)
    view = build_slice(slices)
    if not view:
        return False
    length = view[-1].pos + view[-1].len
    if length == 0:
        return False

    new_id = meta.new_slice()
    ws = store.new_writer(new_id)

    def read_seg(seg):
        if seg.id == 0:
            return b"\0" * seg.len
        return store.new_reader(seg.id, seg.size).read(seg.off, seg.len)

    window = min(COMPACT_READ_WINDOW, len(view))
    try:
        # overlap the old slices' reads; in-order yield keeps the writer
        # sequential.  A failed read is corruption here, so it raises and
        # aborts the rewrite (error policy opposite of the gc scan's).
        # scoped(BACKGROUND) demotes the nested block loads AND the
        # rewrite's uploads, which are submitted from this thread.
        with scoped(cls=IOClass.BACKGROUND), store.scheduler.executor(
            "bulk", IOClass.BACKGROUND, width=window
        ) as pool:
            for seg, data in fetch_ordered(view, read_seg, pool, window):
                ws.write_at(data, seg.pos)
            ws.finish(length)
    except Exception as e:
        logger.warning("compact ino=%d indx=%d: rewrite failed: %s", ino, indx, e)
        ws.abort()
        return False

    merged = Slice(pos=0, id=new_id, size=length, off=0, len=length)
    st = meta.compact_commit(ino, indx, snapshot, merged)
    if st != 0:
        # Lost the race to a concurrent compaction: drop our copy.
        logger.info("compact ino=%d indx=%d: conflict (%d), discarding", ino, indx, st)
        store.remove(new_id, length)
        return False
    return True


def compact_all(meta, store) -> int:
    """Compact every fragmented chunk (reference meta.CompactAll base.go:1984)."""
    n = 0
    for ino, slcs in meta.list_chunks():
        if len(slcs) >= MIN_SLICES_TO_COMPACT:
            ino_, indx = ino
            if compact_chunk(meta, store, ino_, indx):
                n += 1
    return n
