"""DataReader: chunk-aware reads with adaptive, feedback-driven readahead
(a copy of juicefs_tpu/vfs/reader.py).

Behavioral port of the reference's pkg/vfs/reader.go. The reference runs an
async per-slice state machine (sliceReader NEW/BUSY/READY... reader.go:34-50)
with an adaptive readahead window (checkReadahead :417-439); here reads are
synchronous against the chunk store (whose disk/mem cache and singleflight
already absorb concurrency) while readahead is delegated to the store's
prefetch stage at PREFETCH class.

Epoch-streaming read path — the dataloader shape the volume
exists to serve (many clients scanning shuffled shards every epoch):

  - sequential detection tolerates small out-of-order deliveries around
    `_last_end` (the FUSE kernel splits large reads and the fragments can
    arrive reordered): only a seek OUTSIDE the slack band collapses the
    window, mirroring the reference's two-session heuristic
    (reader.go:276,370-415);
  - the per-handle window doubles while sequential, but growth is gated by
    the live prefetch used/issued ratio (chunk/prefetch.py instance
    counters): a window whose speculation is not being consumed stops
    doubling and shrinks instead of wasting object GETs;
  - a handle that sustains sequential progress past `streaming_after`
    bytes enters STREAMING mode: the window cap escalates from
    `max_readahead` (block granularity) to the file-granularity
    `max_streaming`, bounded by the prefetcher's queue depth — sizing past
    what the PREFETCH class will accept only sheds;
  - readahead PLANNING (the chunk-meta walk) runs on a PREFETCH-class
    task, never the foreground read thread; the plan batches its
    `read_chunks` meta reads into one engine round trip, and a full
    PREFETCH queue sheds the plan (the reservation rolls back) instead of
    stalling the read;
  - at sequential EOF of a streaming handle, an epoch hook warms the NEXT
    shard (the name-ordered sibling file): the store's ring-aware prefetch
    fills the local cache with blocks this member owns and hints cache
    group peers to warm theirs, so epoch N+1 opens hot with zero
    redundant object GETs.
"""

from __future__ import annotations

import threading
import weakref
from typing import Optional

from ..chunk import CachedStore
from ..meta.base import BaseMeta
from ..meta.context import Context
from ..meta.slice import build_slice
from ..meta.types import CHUNK_SIZE, TYPE_FILE
from ..metric import global_registry
from ..metric.trace import global_tracer

DEFAULT_MAX_READAHEAD = 8 << 20
DEFAULT_MAX_STREAMING = 64 << 20
# sustained sequential bytes before a handle escalates to streaming mode
DEFAULT_STREAMING_AFTER = 16 << 20
# reorder slack: offsets within this band of the frontier still count as
# sequential (FUSE splits >=1 MiB reads into fragments it may deliver out
# of order; a fragment landing early must not zero a 64 MiB window)
DEFAULT_SEQ_SLACK = 1 << 20
# used/issued feedback thresholds: below LOW the window shrinks, above
# HIGH it may grow, in between it holds (hysteresis so a noisy ratio
# doesn't oscillate the window every read)
_EFF_LOW = 0.5
_EFF_HIGH = 0.8
_EFF_MIN_ISSUED = 8  # issued delta before the ratio is trusted
# epoch hook: cap on next-shard directory scans (a million-entry dir is
# not a shard layout; scanning it on every EOF would be pure waste)
_EPOCH_DIR_CAP = 65536

_TR = global_tracer()

_reg = global_registry()
_PLANS = _reg.counter(
    "juicefs_readahead_plans",
    "Readahead planning tasks run off the read thread (PREFETCH class)",
)
_PLAN_SHED = _reg.counter(
    "juicefs_readahead_plan_shed",
    "Readahead plans dropped on a saturated PREFETCH queue "
    "(the reservation rolls back; the read never stalls)",
)
_STREAMING = _reg.counter(
    "juicefs_readahead_streaming",
    "Streaming-mode transitions per handle", ("event",),
)
_EPOCH_WARMS = _reg.counter(
    "juicefs_readahead_epoch_warms",
    "Sequential-EOF epoch hooks that warmed the next shard",
)

# aggregate window state over every live reader (multiple mounts sum);
# weak refs so the gauges never pin a closed reader
_LIVE_READERS: "weakref.WeakSet[DataReader]" = weakref.WeakSet()


def _sum_readers(fn) -> float:
    total = 0
    try:
        for dr in list(_LIVE_READERS):
            total += fn(dr)
    except Exception:
        pass  # racing a reader teardown must never break a scrape
    return total


_reg.gauge(
    "juicefs_readahead_window_bytes",
    "Sum of live per-handle readahead windows",
).set_function(lambda: _sum_readers(lambda dr: dr._window_bytes()))
_reg.gauge(
    "juicefs_readahead_streaming_handles",
    "Open handles currently in streaming readahead mode",
).set_function(lambda: _sum_readers(lambda dr: dr._streaming_handles()))


class FileReader:
    """Read state of one open handle (reference fileReader reader.go:69)."""

    def __init__(self, dr: "DataReader", ino: int):
        self.dr = dr
        self.ino = ino
        self._lock = threading.Lock()
        self._last_end = -1
        self._ra_window = 0
        self._ra_done = 0  # readahead already enqueued up to this offset
        self._seq_bytes = 0  # sequential progress toward streaming mode
        self._streaming = False
        self._eof_warmed = False  # epoch hook fired for this pass
        # prefetch-counter snapshot for the window feedback: anchored to
        # the store's CURRENT totals, so a fresh handle's first
        # evaluation measures its own window, not the mount's lifetime
        # ratio (which would pin new handles' ramps to unrelated history)
        _issued, warmed, used, _dropped = dr.store.prefetcher.counters()
        self._eff_warmed = warmed
        self._eff_used = used

    # -- window state machine ----------------------------------------------
    def _is_sequential(self, off: int) -> bool:
        """Sequential continuation, with reorder tolerance: anything
        within `seq_slack` of the frontier (before OR after it) is the
        kernel splitting/reordering a large read, not a random seek."""
        if self._last_end < 0:
            return False
        return abs(off - self._last_end) <= self.dr.seq_slack

    def _efficiency(self) -> Optional[float]:
        """used/WARMED over the window since the last adjustment, or
        None while the signal is too thin to act on.  The counters are
        the owning store's (all handles share them): waste is a
        store-wide budget, and a per-handle split would starve every
        handle of signal at dataloader fan-outs.

        Warmed — completed speculative loads — is the denominator rather
        than raw issued: in a cache group most issued keys are ring-
        forwarded as peer warm HINTS (never warmed locally, so never
        creditable as used), and an issued-based ratio would read
        low-by-construction in exactly the multi-member deployment the
        streaming mode targets.

        The reader's TOTAL lookahead gap (planned-but-not-yet-read
        blocks across every open handle — the handles share this store's
        counters) is CREDITED to the numerator: a freshly warmed block
        ahead of a frontier is not waste, it is the whole point — without
        the credit a multi-handle ramp reads as a low ratio and the
        feedback would fight the doubling it gates.  To keep the credit
        from masking real waste, an evaluation only triggers once the
        warmed delta spans at least twice the gap: warmed-then-evicted
        blocks then dominate the window and the ratio reads low."""
        fetcher = self.dr.store.prefetcher
        _issued, warmed, used, _dropped = fetcher.counters()
        d_warmed = warmed - self._eff_warmed
        gap = self.dr.lookahead_gap_blocks()
        if d_warmed < max(_EFF_MIN_ISSUED, 2 * gap):
            return None
        d_used = used - self._eff_used
        self._eff_warmed, self._eff_used = warmed, used
        return max(0.0, (d_used + gap) / d_warmed)

    def _advance_window(self, size: int) -> None:
        """Called under self._lock on each sequential read."""
        bs = self.dr.store.conf.block_size
        self._seq_bytes += size
        if (not self._streaming and self.dr.streaming
                and self._seq_bytes >= self.dr.streaming_after):
            self._streaming = True
            _STREAMING.labels("enter").inc()
        cap = self.dr.streaming_cap() if self._streaming \
            else self.dr.max_readahead
        eff = self._efficiency()
        if eff is not None and eff < _EFF_LOW and self._ra_window > bs:
            # issued blocks are not being consumed: shrink instead of
            # paying object GETs for speculation nothing reads
            self._ra_window = max(bs, self._ra_window // 2)
        elif eff is None or eff >= _EFF_HIGH:
            self._ra_window = min(cap, max(self._ra_window * 2, bs))
        else:
            self._ra_window = min(cap, max(self._ra_window, bs))

    def _collapse(self) -> None:
        """A true random seek (outside the slack band): drop all
        speculative state, exit streaming."""
        self._ra_window = 0
        self._ra_done = 0
        self._seq_bytes = 0
        self._eof_warmed = False  # re-arm: a wrapped handle is a new epoch
        # re-anchor the feedback snapshots: the seek abandoned this
        # handle's planned-but-unread speculation, which would otherwise
        # count in the next evaluation's warmed-delta but never in used —
        # a spurious shrink on the new pass's first window
        _issued, warmed, used, _dropped = \
            self.dr.store.prefetcher.counters()
        self._eff_warmed = warmed
        self._eff_used = used
        if self._streaming:
            self._streaming = False
            _STREAMING.labels("exit").inc()

    def read(self, ctx: Context, off: int, size: int) -> tuple[int, bytes]:
        """Returns (errno, buffer). The buffer may be a zero-copy
        memoryview into a cached block on the single-segment fast path —
        callers (fuse writev reply, fs.pread accumulation) treat it as a
        read-only bytes-like."""
        st, attr = self.dr.meta.getattr(ctx, self.ino)
        if st != 0:
            return st, b""
        length = attr.length
        # Read-your-writes: an open writer may hold a longer buffered length.
        wlen = self.dr.writer_length(self.ino)
        if wlen is not None:
            length = max(length, wlen)
        if off >= length or size <= 0:
            return 0, b""
        size = min(size, length - off)

        end = off + size
        indx, coff = divmod(off, CHUNK_SIZE)
        if coff + size <= CHUNK_SIZE:
            # fast path: the read lives in one chunk — hand its buffer
            # through without reassembly (the dominant shape: FUSE reads
            # are <=1 MiB, chunks are 64 MiB)
            st, out = self._read_chunk(indx, coff, size)
            if st != 0:
                return st, b""
        else:
            parts = []
            pos = off
            while pos < end:
                indx, coff = divmod(pos, CHUNK_SIZE)
                n = min(end - pos, CHUNK_SIZE - coff)
                st, data = self._read_chunk(indx, coff, n)
                if st != 0:
                    return st, b""
                parts.append(data)
                pos += n
            out = b"".join(parts)

        epoch = False
        with self._lock:
            if self._is_sequential(off):
                if end > self._last_end:
                    # growth requires forward PROGRESS: a stationary
                    # re-read of one hot offset sits inside the slack
                    # band forever, and advancing on it would ramp a
                    # streaming window ahead of a frontier that never
                    # moves (pure prefetch waste).  Credit only the NET
                    # advance — overlapping strided reads must not
                    # double-count their overlap toward streaming_after
                    self._advance_window(end - self._last_end)
                    self._last_end = end
                # else: reorder tolerance — a fragment landing BEHIND
                # the frontier keeps the state but earns no growth (its
                # leading sibling already advanced for the whole read)
            else:
                self._collapse()
                # a true seek MOVES the frontier (a rewound handle — the
                # next epoch over the same fd — re-establishes the
                # sequential pattern from its new position; keeping the
                # old high-water mark would classify every read of the
                # new pass as random forever)
                self._last_end = end
            window = self._ra_window
            # only plan the part of the window not already enqueued —
            # re-walking warmed blocks costs a meta read + queue churn
            # per request (reference reader.go keeps per-session state)
            ra_start = max(end, self._ra_done)
            ra_end = min(end + window, length)
            self._ra_done = max(self._ra_done, ra_end)
            if (self._streaming and end >= length
                    and not self._eof_warmed):
                # sequential EOF on a streaming handle: one epoch hook
                self._eof_warmed = True
                epoch = True
        if window > 0 and ra_end > ra_start:
            # plan OFF the read thread (PREFETCH class): the chunk-meta
            # walk never costs the foreground read a round trip, and a
            # saturated queue sheds the plan instead of stalling here
            if not self.dr.submit_plan(self, ra_start, ra_end - ra_start):
                with self._lock:
                    # roll the reservation back (only the part nothing
                    # else advanced past) so a later read re-plans it
                    if self._ra_done == ra_end:
                        self._ra_done = ra_start
        if epoch:
            self.dr.submit_epoch_warm(ctx, self.ino)
        return 0, out

    def _read_chunk(self, indx: int, coff: int, size: int) -> tuple[int, bytes]:
        st, slices = self.dr.meta.read_chunk(self.ino, indx)
        if st != 0:
            return st, b""
        view = build_slice(slices)
        end = coff + size
        segs = []  # (s0, s1, seg) overlapping non-hole segments
        for seg in view:
            s0 = max(seg.pos, coff)
            s1 = min(seg.pos + seg.len, end)
            if s0 < s1 and seg.id != 0:
                segs.append((s0, s1, seg))
        if len(segs) == 1 and segs[0][0] == coff and segs[0][1] == end:
            # one slice covers the whole request, no holes: hand the
            # store's buffer (often a zero-copy view of a cached block)
            # straight through without the assembly bytearray
            s0, s1, seg = segs[0]
            return 0, self._read_seg(seg, s0, s1)
        out = bytearray(size)
        if len(segs) > 1:
            # fragmented chunk (the pre-compaction case: many small slices
            # from overwrites): fan the per-slice loads out instead of
            # walking them serially (reference reader.go:160 runs every
            # sliceReader as its own goroutine).
            # A dedicated pool avoids nested-submit deadlock with the
            # store's block-level download pool, which RSlice.read may
            # itself use for multi-block spans.
            ref = _TR.current_ref()  # span ref crosses the pool explicitly
            futs = [
                (s0, self.dr.spool.submit(self._read_seg, seg, s0, s1, ref))
                for s0, s1, seg in segs
            ]
            for s0, fut in futs:
                data = fut.result()
                out[s0 - coff : s0 - coff + len(data)] = data
        elif segs:
            s0, s1, seg = segs[0]
            data = self._read_seg(seg, s0, s1)
            out[s0 - coff : s0 - coff + len(data)] = data
        return 0, bytes(out)  # multi-seg/hole case: out was assembled here

    def _read_seg(self, seg, s0: int, s1: int, parent=None) -> bytes:
        rs = self.dr.store.new_reader(seg.id, seg.size)
        return rs.read(seg.off + (s0 - seg.pos), s1 - s0, parent=parent)

    def _readahead(self, off: int, size: int) -> None:
        """Warm the blocks backing [off, off+size) via the prefetch
        stage.  Runs at PREFETCH class (DataReader.submit_plan), never on
        the read thread; the chunk-meta walk batches into one
        `read_chunks` engine round trip."""
        end = off + size
        first = off // CHUNK_SIZE
        last = (end - 1) // CHUNK_SIZE
        indxs = list(range(first, last + 1))
        for indx, (st, slices) in zip(
                indxs, self.dr.meta.read_chunks(self.ino, indxs)):
            if st != 0:
                return
            coff = max(off - indx * CHUNK_SIZE, 0)
            cend = min(end - indx * CHUNK_SIZE, CHUNK_SIZE)
            for seg in build_slice(slices):
                s0 = max(seg.pos, coff)
                s1 = min(seg.pos + seg.len, cend)
                if s0 < s1 and seg.id != 0:
                    self.dr.store.prefetch(
                        seg.id, seg.size, seg.off + (s0 - seg.pos), s1 - s0
                    )

    # -- observability ------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "window": self._ra_window,
                "streaming": self._streaming,
                "seq_bytes": self._seq_bytes,
                "frontier": self._last_end,
            }


class DataReader:
    """Per-mount reader factory (reference DataReader reader.go:69-79)."""

    def __init__(
        self,
        meta: BaseMeta,
        store: CachedStore,
        max_readahead: int = DEFAULT_MAX_READAHEAD,
        writer=None,
        streaming: bool = True,
        streaming_after: int = DEFAULT_STREAMING_AFTER,
        max_streaming: int = DEFAULT_MAX_STREAMING,
        seq_slack: int = DEFAULT_SEQ_SLACK,
    ):
        self.meta = meta
        self.store = store
        self.max_readahead = max_readahead
        self.streaming = streaming
        self.streaming_after = max(0, streaming_after)
        self.max_streaming = max(max_streaming, max_readahead)
        self.seq_slack = max(0, seq_slack)
        self._writer = writer
        self._handles: "weakref.WeakSet[FileReader]" = weakref.WeakSet()
        # slice-level fan-out for fragmented chunks on the unified
        # scheduler's "slice" lane — a separate lane from the store's
        # block-level "download" lane so nested submits cannot deadlock
        # (docs/ARCHITECTURE.md "Concurrency model")
        from ..qos import IOClass

        self.spool = store.scheduler.executor(
            "slice", IOClass.FOREGROUND, width=store.conf.max_download)
        # readahead planning + epoch warming: PREFETCH class on
        # the slice lane — plans submit block fetches to the download lane
        # (slice -> download, the declared direction) and never wait on
        # them, and a full queue sheds the plan rather than backpressuring
        # the read thread
        self.ppool = store.scheduler.executor("slice", IOClass.PREFETCH)
        # dataset-manifest epoch hint: exact
        # ino -> next-shard-ino successor map installed via the `.control`
        # epoch_plan op; empty = fall back to the name-order readdir guess
        self._epoch_plan: dict[int, int] = {}
        _LIVE_READERS.add(self)

    def set_epoch_plan(self, plan: dict[int, int]) -> None:
        """Install (or clear) the manifest-driven next-shard plan: the
        sequential-EOF epoch hook warms plan[ino] instead of guessing
        the name-ordered sibling."""
        self._epoch_plan = dict(plan)

    def open(self, ino: int) -> FileReader:
        fr = FileReader(self, ino)
        self._handles.add(fr)
        return fr

    def writer_length(self, ino: int) -> Optional[int]:
        if self._writer is None:
            return None
        return self._writer.get_length(ino)

    def lookahead_gap_blocks(self) -> int:
        """Planned-but-not-yet-consumed blocks across every open handle
        (unlocked reads of two ints per handle: a heuristic input, benign
        races only under- or over-credit one block)."""
        bs = self.store.conf.block_size
        return sum(max(0, fr._ra_done - fr._last_end) // bs
                   for fr in list(self._handles))

    def streaming_cap(self) -> int:
        """Window cap in streaming mode: file-granularity, but bounded by
        what the PREFETCH stage will actually accept — the prefetcher's
        outstanding-fetch depth in blocks (sizing past it only sheds).
        Floored at max_readahead: escalating to streaming must never
        grant LESS window than a short-scan handle gets (small blocks ×
        depth can undercut it)."""
        return max(self.max_readahead,
                   min(self.max_streaming,
                       self.store.prefetcher.depth
                       * self.store.conf.block_size))

    # -- speculative-work dispatch (PREFETCH class) --------------
    def submit_plan(self, fr: FileReader, off: int, size: int) -> bool:
        """Queue a readahead plan; False when it was shed (full PREFETCH
        queue or closing reader) — the caller rolls back its reservation."""
        try:
            fut = self.ppool.submit(fr._readahead, off, size)
        except Exception:
            # racing close() (RuntimeError), scheduler backpressure
            # leaking out of a demoted submit (TimeoutError), or anything
            # else: a readahead plan is advisory — shed it, never let the
            # failure reach the read that only wanted to be faster
            fut = None
        if fut is None:
            _PLAN_SHED.inc()
            return False
        _PLANS.inc()
        return True

    def submit_epoch_warm(self, ctx: Context, ino: int) -> None:
        """Queue the sequential-EOF epoch hook (fire-and-forget)."""
        try:
            self.ppool.submit(self._warm_next_shard, ctx, ino)
        except Exception:
            pass  # advisory epoch warm: any dispatch failure is a shed

    def _warm_next_shard(self, ctx: Context, ino: int) -> None:
        """Epoch hook: a streaming handle just finished a shard-shaped
        file; warm the NEXT shard (name-ordered sibling) so epoch N+1
        opens hot.  Every block routes through the store's ring-aware
        prefetch: blocks this member owns fill the local cache, blocks a
        cache-group peer owns become warm hints to that peer — between
        the members, the whole next shard lands ring-locally."""
        try:
            # manifest-exact plan first: the loader
            # told us the successor, so the readdir guess — and its whole
            # directory scan — is skipped
            nxt_ino = self._epoch_plan.get(ino, 0)
            if not nxt_ino:
                st, attr = self.meta.getattr(ctx, ino)
                if st != 0 or not attr.parent:
                    return  # multi-linked or gone: no unambiguous sibling
                # attr-LESS readdir: the expensive part of a giant listing
                # is the per-entry attr assembly + lease priming
                # (readdirplus), which this deliberately skips — one plain
                # name scan, then a single getattr on the chosen sibling.
                # The cap bounds the sort/scan work on absurd layouts (a
                # 65k+-entry dir is not a shard directory; warming "the
                # next" of it is a guess not worth the walk).
                st, entries = self.meta.readdir(ctx, attr.parent)
                if st != 0 or len(entries) > _EPOCH_DIR_CAP:
                    return
                names = sorted(
                    (e.name, e.inode) for e in entries
                    if not e.name.startswith(b".")
                )
                for i, (_name, entry_ino) in enumerate(names):
                    if entry_ino == ino and i + 1 < len(names):
                        nxt_ino = names[i + 1][1]
                        break
            if not nxt_ino:
                return
            st, nattr = self.meta.getattr(ctx, nxt_ino)
            if st != 0 or nattr.typ != TYPE_FILE or nattr.length <= 0:
                # the name-ordered neighbor is not a readable shard (a
                # subdir, a socket, an empty file): this is a layout
                # guess, not a contract — bail rather than walk further
                return
            length = nattr.length
            # plan at most one prefetcher-depth of blocks: enqueueing past
            # the queue bound only sheds, and the tail warms on demand.
            # The budget clips at BLOCK granularity — a chunk is 64 MiB,
            # so chunk-level clipping alone could enqueue 8x the budget
            # on small-block volumes
            budget = self.store.prefetcher.depth * self.store.conf.block_size
            limit = min(length, budget)
            nchunks = (limit + CHUNK_SIZE - 1) // CHUNK_SIZE
            indxs = list(range(nchunks))
            for indx, (st, slices) in zip(
                    indxs, self.meta.read_chunks(nxt_ino, indxs)):
                if st != 0:
                    return
                cend = min(limit - indx * CHUNK_SIZE, CHUNK_SIZE)
                for seg in build_slice(slices):
                    s0, s1 = seg.pos, min(seg.pos + seg.len, cend)
                    if s0 < s1 and seg.id != 0:
                        self.store.prefetch(seg.id, seg.size,
                                            seg.off, s1 - s0)
            _EPOCH_WARMS.inc()
        except Exception:
            pass  # speculative: an epoch hook must never surface errors

    # -- observability ------------------------------------------------------
    def _window_bytes(self) -> int:
        return sum(fr._ra_window for fr in list(self._handles))

    def _streaming_handles(self) -> int:
        return sum(1 for fr in list(self._handles) if fr._streaming)

    def stats(self) -> dict:
        """Readahead section of `.status` (vfs/internal.py)."""
        handles = list(self._handles)
        issued, warmed, used, dropped = self.store.prefetcher.counters()
        return {
            "streaming_enabled": self.streaming,
            "handles": len(handles),
            "streaming_handles": self._streaming_handles(),
            "window_bytes": self._window_bytes(),
            "max_readahead": self.max_readahead,
            "max_streaming": self.max_streaming,
            "prefetch": {
                "issued": issued, "warmed": warmed, "used": used,
                "dropped": dropped,
                "used_ratio": round(used / issued, 3) if issued else None,
                # the window feedback's actual control signal: in a
                # cache group most issued keys are ring-forwarded hints
                # (never warmed locally), so used/issued reads low there
                # by construction — steer by used/warmed
                "feedback_ratio": round(used / warmed, 3)
                if warmed else None,
            },
        }

    def close(self) -> None:
        self.ppool.shutdown(wait=False, cancel_futures=True)
        self.spool.shutdown(wait=False)
