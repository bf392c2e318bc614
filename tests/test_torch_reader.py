"""The port's epoch-streaming read path (juicefs_tpu_torch/vfs/reader.py):
the cases of tests/test_reader.py run on the port — FileReader window
state machine, off-thread readahead planning, Prefetcher feedback
accounting, ring-aware prefetch routing, the epoch hook and plan.

The state-machine tests drive a REAL DataReader over mem meta + mem store
(small blocks so windows are a few KiB); where determinism matters the
plan submission is made synchronous instead of polled. The peer
server's warm-hint absorption runs on the port's cache group."""

import threading
import time

import pytest

from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig
from juicefs_tpu_torch.chunk.prefetch import Prefetcher
from juicefs_tpu_torch.meta import Format, new_client
from juicefs_tpu_torch.meta.context import Context
from juicefs_tpu_torch.object import create_storage
from juicefs_tpu_torch.qos import IOClass, Scheduler
from juicefs_tpu_torch.vfs import ROOT_INO, VFS, VFSConfig
from juicefs_tpu_torch.vfs.reader import DataReader

CTX = Context(uid=0, gid=0, pid=1)
BS = 1 << 16  # 64 KiB blocks: windows stay small and fast


def _mk_vfs(tmp_path, scheduler=None, streaming=True,
            streaming_after=4 * BS, max_streaming=1 << 30,
            max_readahead=4 * BS, prefetch=2):
    m = new_client("mem://")
    m.init(Format(name="t", storage="mem", block_size=BS), force=False)
    m.new_session()
    store = CachedStore(
        create_storage("mem://"),
        ChunkConfig(block_size=BS, cache_dirs=("memory",), prefetch=prefetch,
                    scheduler=scheduler),
    )
    v = VFS(m, store, VFSConfig(
        max_readahead=max_readahead, streaming_read=streaming,
        streaming_after=streaming_after, max_streaming=max_streaming,
    ))
    return v


def _write(vfs, name: bytes, size: int) -> int:
    st, ino, _attr, fh = vfs.create(CTX, ROOT_INO, name, 0o644)
    assert st == 0
    data = bytes(range(256)) * (size // 256 + 1)
    assert vfs.write(CTX, ino, fh, 0, data[:size]) == 0
    assert vfs.flush(CTX, ino, fh) == 0
    vfs.release(CTX, ino, fh)
    return ino


def _sync_plans(dr: DataReader):
    """Make readahead planning synchronous for deterministic assertions
    (the off-thread contract has its own test below)."""
    def submit_plan(fr, off, size):
        fr._readahead(off, size)
        return True
    dr.submit_plan = submit_plan


@pytest.fixture
def vfs(tmp_path):
    v = _mk_vfs(tmp_path)
    yield v
    v.close()


# ---------------------------------------------------------------------------
# window state machine

def test_sequential_growth_doubles_to_cap(vfs):
    ino = _write(vfs, b"f", 64 * BS)
    fr = vfs.reader.open(ino)
    _sync_plans(vfs.reader)
    fr.read(CTX, 0, BS)
    assert fr._ra_window == 0  # first read: no established pattern
    fr.read(CTX, BS, BS)
    assert fr._ra_window == BS
    fr.read(CTX, 2 * BS, BS)
    assert fr._ra_window == 2 * BS
    for i in range(3, 10):
        fr.read(CTX, i * BS, BS)
    # doubles until the streaming cap (streaming_after=4*BS was crossed)
    assert fr._ra_window == vfs.reader.streaming_cap()


def test_far_seek_collapses_window(vfs):
    ino = _write(vfs, b"f", 64 * BS)
    fr = vfs.reader.open(ino)
    _sync_plans(vfs.reader)
    for i in range(4):
        fr.read(CTX, i * BS, BS)
    assert fr._ra_window > 0
    fr.read(CTX, 40 * BS, BS)  # way outside the slack band
    assert fr._ra_window == 0
    # nothing is claimed planned beyond the new frontier
    assert fr._ra_done <= fr._last_end
    assert fr._seq_bytes == 0


def test_reorder_tolerance_keeps_window(vfs):
    """FUSE delivers large reads as fragments that can arrive out of
    order; anything within the slack band must stay 'sequential'
    (satellite: the seed collapsed to 0 on ANY non-contiguous offset)."""
    ino = _write(vfs, b"f", 64 * BS)
    fr = vfs.reader.open(ino)
    _sync_plans(vfs.reader)
    for i in range(4):
        fr.read(CTX, i * BS, BS)
    w = fr._ra_window
    assert w > 0
    # fragment lands AHEAD of the frontier (within slack)
    fr.read(CTX, 5 * BS, BS)
    assert fr._ra_window >= w
    # the gap-filler lands BEHIND the new frontier (within slack)
    fr.read(CTX, 4 * BS, BS)
    assert fr._ra_window >= w
    # frontier never regressed
    assert fr._last_end == 6 * BS


def test_beyond_slack_is_random(tmp_path):
    v = _mk_vfs(tmp_path)
    try:
        v.reader.seq_slack = BS  # tight band for the drill
        ino = _write(v, b"f", 64 * BS)
        fr = v.reader.open(ino)
        _sync_plans(v.reader)
        for i in range(4):
            fr.read(CTX, i * BS, BS)
        assert fr._ra_window > 0
        fr.read(CTX, 4 * BS + 2 * BS, BS)  # 2 blocks past frontier > slack
        assert fr._ra_window == 0
    finally:
        v.close()


def test_streaming_entry_and_exit(vfs):
    ino = _write(vfs, b"f", 64 * BS)
    fr = vfs.reader.open(ino)
    _sync_plans(vfs.reader)
    fr.read(CTX, 0, BS)
    assert not fr._streaming
    for i in range(1, 6):  # crosses streaming_after = 4 blocks
        fr.read(CTX, i * BS, BS)
    assert fr._streaming
    fr.read(CTX, 50 * BS, BS)  # random seek: exit
    assert not fr._streaming


def test_streaming_disabled_caps_at_max_readahead(tmp_path):
    v = _mk_vfs(tmp_path, streaming=False)
    try:
        ino = _write(v, b"f", 64 * BS)
        fr = v.reader.open(ino)
        _sync_plans(v.reader)
        for i in range(16):
            fr.read(CTX, i * BS, BS)
        assert not fr._streaming
        assert fr._ra_window <= v.reader.max_readahead
    finally:
        v.close()


def test_streaming_cap_bounded_by_prefetch_depth(vfs):
    cap = vfs.reader.streaming_cap()
    assert cap == vfs.store.prefetcher.depth * BS  # max_streaming is huge
    vfs.reader.max_streaming = 8 * BS
    assert vfs.reader.streaming_cap() == 8 * BS


def test_ra_done_dedups_planning(vfs):
    """The planner never re-plans offsets already enqueued — overlapping
    plans would re-walk chunk meta and churn the prefetch queue."""
    ino = _write(vfs, b"f", 64 * BS)
    fr = vfs.reader.open(ino)
    planned = []

    def submit_plan(fr_, off, size):
        planned.append((off, off + size))
        return True
    vfs.reader.submit_plan = submit_plan
    for i in range(10):
        fr.read(CTX, i * BS, BS)
    spans = sorted(planned)
    for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
        assert a1 <= b0, f"overlapping plans {spans}"


def test_window_feedback_shrinks_wasted_window(vfs):
    """Satellite: used/issued feeds growth — a window whose speculation
    is not consumed stops doubling and shrinks."""
    ino = _write(vfs, b"f", 64 * BS)
    fr = vfs.reader.open(ino)
    _sync_plans(vfs.reader)
    for i in range(6):
        fr.read(CTX, i * BS, BS)
    w = fr._ra_window
    assert w > BS

    class LowUse:
        depth = 64

        def counters(self):
            # huge issued delta, zero used: the handle's own lookahead
            # gap credit becomes negligible and the ratio reads ~0
            return (100000, 100000, 0, 0)

        def fetch(self, key):
            pass

        def consumed(self, key):
            pass

    vfs.store._fetcher = LowUse()
    fr._eff_warmed = fr._eff_used = 0
    fr.read(CTX, 6 * BS, BS)
    assert fr._ra_window == w // 2
    fr._eff_warmed = fr._eff_used = 0
    fr.read(CTX, 7 * BS, BS)
    assert fr._ra_window == w // 4


def test_window_feedback_holds_in_midband(vfs):
    ino = _write(vfs, b"f", 64 * BS)
    fr = vfs.reader.open(ino)
    _sync_plans(vfs.reader)
    for i in range(6):
        fr.read(CTX, i * BS, BS)
    w = fr._ra_window

    class MidUse:
        depth = 64

        def counters(self):
            return (100000, 100000, 65000, 0)  # ratio ~0.65: hold

        def fetch(self, key):
            pass

        def consumed(self, key):
            pass

    vfs.store._fetcher = MidUse()
    fr._eff_warmed = fr._eff_used = 0
    fr.read(CTX, 6 * BS, BS)
    assert fr._ra_window == w


# ---------------------------------------------------------------------------
# off-thread planning + shed behavior (the foreground contract)

def test_planning_runs_off_the_read_thread(vfs):
    """Acceptance: readahead planning meta reads never run on the read
    thread (PREFETCH class task)."""
    ino = _write(vfs, b"f", 64 * BS)
    fr = vfs.reader.open(ino)
    meta = vfs.reader.meta
    plan_threads = []
    orig = meta.read_chunks

    def spy(ino_, indxs):
        plan_threads.append(threading.get_ident())
        return orig(ino_, indxs)
    meta.read_chunks = spy
    try:
        for i in range(8):
            fr.read(CTX, i * BS, BS)
        deadline = time.time() + 5
        while not plan_threads and time.time() < deadline:
            time.sleep(0.01)
        assert plan_threads, "no plan ever ran"
        assert threading.get_ident() not in plan_threads, \
            "chunk-meta planning ran on the foreground read thread"
    finally:
        meta.read_chunks = orig


def test_saturated_prefetch_queue_sheds_never_stalls(tmp_path):
    """Acceptance: a full PREFETCH queue sheds the plan (reservation
    rolls back) instead of stalling FileReader.read."""
    sched = Scheduler(bounds={IOClass.PREFETCH: 0})  # every submit sheds
    v = _mk_vfs(tmp_path, scheduler=sched)
    try:
        from juicefs_tpu_torch.vfs.reader import _PLAN_SHED

        ino = _write(v, b"f", 32 * BS)
        fr = v.reader.open(ino)
        shed0 = _PLAN_SHED.value
        t0 = time.time()
        for i in range(8):
            st, data = fr.read(CTX, i * BS, BS)
            assert st == 0 and len(data) == BS
        assert time.time() - t0 < 5.0, "reads stalled behind readahead"
        assert _PLAN_SHED.value > shed0
        # the reservation rolled back: nothing recorded as planned
        assert fr._ra_done <= fr._last_end
    finally:
        v.close()
        sched.close()


def test_epoch_hook_warms_next_shard(tmp_path):
    """Sequential EOF on a streaming handle warms the name-ordered next
    shard so epoch N+1 opens hot."""
    v = _mk_vfs(tmp_path, streaming_after=2 * BS)
    try:
        shard0 = _write(v, b"shard-000", 8 * BS)
        shard1 = _write(v, b"shard-001", 8 * BS)
        # cold store for the read side: evict what the writes cached
        st, slices = v.meta.read_chunk(shard1, 0)
        assert st == 0 and slices
        for s in slices:
            v.store.evict_cache(s.id, s.size)
        hooks = []
        orig = v.reader.submit_epoch_warm

        def spy(ctx, ino):
            hooks.append(ino)
            orig(ctx, ino)
        v.reader.submit_epoch_warm = spy
        fr = v.reader.open(shard0)
        pos = 0
        while pos < 8 * BS:
            st, data = fr.read(CTX, pos, BS)
            assert st == 0
            pos += len(data)
        assert hooks == [shard0], "epoch hook must fire exactly once"
        # settle: the hook plans + prefetches on PREFETCH class
        deadline = time.time() + 5
        warmed = 0
        while time.time() < deadline:
            warmed = sum(v.store.check_cache(s.id, s.size) for s in slices)
            if warmed >= sum(
                    (s.size + BS - 1) // BS for s in slices):
                break
            time.sleep(0.02)
        assert warmed > 0, "next shard never warmed"
        # EOF re-read does not re-fire
        fr.read(CTX, 8 * BS - BS, BS)
        assert hooks == [shard0]
    finally:
        v.close()


# ---------------------------------------------------------------------------
# Prefetcher accounting drills

def _mk_prefetcher(fetch, sched, depth=8):
    return Prefetcher(
        fetch, depth=depth,
        executor=sched.executor("download", IOClass.PREFETCH, width=2))


def test_prefetcher_used_accounting_counts_once():
    sched = Scheduler()
    try:
        p = _mk_prefetcher(lambda k: True, sched)
        p.fetch("a")
        deadline = time.time() + 5
        while p.outstanding and time.time() < deadline:
            time.sleep(0.01)
        issued, warmed, used, dropped = p.counters()
        assert (issued, warmed, used) == (1, 1, 0)
        p.consumed("a")
        p.consumed("a")  # second hit: warm credit already popped
        assert p.counters()[2] == 1
    finally:
        sched.close()


def test_prefetcher_noop_fetch_earns_no_used_credit():
    sched = Scheduler()
    try:
        p = _mk_prefetcher(lambda k: False, sched)  # already-cached shape
        p.fetch("a")
        deadline = time.time() + 5
        while p.outstanding and time.time() < deadline:
            time.sleep(0.01)
        p.consumed("a")
        issued, warmed, used, _ = p.counters()
        assert (issued, warmed, used) == (1, 0, 0)
    finally:
        sched.close()


def test_prefetcher_sheds_at_depth_and_counts_drops():
    sched = Scheduler()
    gate = threading.Event()
    try:
        p = _mk_prefetcher(lambda k: gate.wait(5) or True, sched, depth=2)
        for i in range(5):
            p.fetch(f"k{i}")
        issued, _, _, dropped = p.counters()
        assert issued + dropped == 5
        assert dropped >= 3  # depth 2: at most 2 pending
    finally:
        gate.set()
        sched.close()


def test_prefetcher_close_stops_new_fetches():
    sched = Scheduler()
    try:
        ran = []
        p = _mk_prefetcher(lambda k: ran.append(k) or True, sched)
        p.close()
        p.fetch("late")
        time.sleep(0.05)
        assert "late" not in ran
    finally:
        sched.close()


# ---------------------------------------------------------------------------
# ring-aware prefetch routing

class _FakeGroup:
    def __init__(self, owns):
        self._owns = owns
        self.warms = []

    def owns(self, key):
        return self._owns

    def warm(self, key):
        self.warms.append(key)
        return True


def test_prefetch_block_non_owned_hints_instead_of_get(tmp_path):
    store = CachedStore(create_storage("mem://"),
                        ChunkConfig(block_size=BS, cache_dirs=("memory",)))
    try:
        from juicefs_tpu_torch.chunk.cached_store import block_key

        key = block_key(7, 0, BS)
        store.storage.put(key, b"x" * BS)
        gets = []
        orig_get = store.storage.get

        def spy(k, *a, **kw):
            gets.append(k)
            return orig_get(k, *a, **kw)
        store.storage.get = spy
        group = _FakeGroup(owns=False)
        store.cache_group = group
        assert store._prefetch_block((key, BS)) is False
        assert group.warms == [key]
        assert gets == [], "non-owned prefetch paid an object GET"
        # owned: fills the local cache from the backend
        group2 = _FakeGroup(owns=True)
        store.cache_group = group2
        group2.fetch = lambda *a, **kw: None  # peer rung: no copy
        assert store._prefetch_block((key, BS)) is True
        assert store.cache.load(key, count_miss=False) is not None
        assert not group2.warms
    finally:
        store.close()


def test_status_exposes_readahead_section(vfs):
    payload = vfs.internal._status_payload()
    ra = payload["readahead"]
    assert ra["streaming_enabled"] is True
    assert "prefetch" in ra and "window_bytes" in ra


def test_prefetcher_disabled_creates_no_executor():
    """workers=0 is the OFF switch: no executor may be built (a global-
    scheduler executor here would mean a disabled prefetcher still owns
    scheduler state) and fetch must be a silent no-op."""
    p = Prefetcher(lambda k: True, workers=0)
    assert p._ex is None
    p.fetch("k")
    assert p.counters() == (0, 0, 0, 0)
    p.close()


def test_prefetcher_depth_defaults_pinned():
    """depth is the streaming window's ceiling (DataReader.streaming_cap
    multiplies by it) — the default is part of the sizing contract."""
    sched = Scheduler()
    try:
        ex = sched.executor("download", IOClass.PREFETCH, width=2)
        assert Prefetcher(lambda k: True, executor=ex).depth == 64
        assert Prefetcher(lambda k: True, executor=ex, depth=5).depth == 5
    finally:
        sched.close()


# ---------------------------------------------------------------------------
# mutation-survivor drills (docs/BENCHMARKS.md §6g)

def test_readahead_plans_exact_offset_slice_ranges(vfs):
    """_readahead must translate chunk-relative ranges into exact
    slice-internal prefetch spans — offset slices (seg.pos/seg.off
    nonzero after overwrites) are where the arithmetic can silently
    rot while whole-file tests still pass."""
    from juicefs_tpu_torch.meta.types import Slice

    ino = _write(vfs, b"f", 8 * BS)
    fr = vfs.reader.open(ino)
    # one chunk whose live view is: [0,BS) hole, then slice 9 covering
    # [BS, 3*BS) out of a 4*BS-long stored slice starting at its off=BS
    crafted = [Slice(pos=BS, id=9, size=4 * BS, off=BS, len=2 * BS)]
    vfs.reader.meta.read_chunks = lambda ino_, indxs: [(0, crafted)
                                                       for _ in indxs]
    calls = []
    vfs.reader.store.prefetch = lambda sid, length, off=0, size=None: \
        calls.append((sid, length, off, size))
    fr._readahead(0, 4 * BS)  # plan the chunk prefix [0, 4*BS)
    # the only non-hole overlap is [BS,3*BS) -> slice-internal [BS,3*BS)
    assert calls == [(9, 4 * BS, BS, 2 * BS)], calls
    calls.clear()
    fr._readahead(2 * BS, 4 * BS)  # plan [2*BS, 6*BS): tail of the slice
    assert calls == [(9, 4 * BS, 2 * BS, BS)], calls


def test_window_grows_at_exactly_high_ratio(vfs):
    """The >=0.8 boundary is GROW, not hold (the bench gate counts on
    steady streaming sitting at the boundary)."""
    ino = _write(vfs, b"f", 64 * BS)
    fr = vfs.reader.open(ino)
    _sync_plans(vfs.reader)
    for i in range(6):
        fr.read(CTX, i * BS, BS)
    w = fr._ra_window

    class EdgeUse:
        depth = 64

        def counters(self):
            return (100000, 100000, 80000, 0)  # exactly 0.8 (gap ~0 noise)

        def fetch(self, key):
            pass

        def consumed(self, key):
            pass

    vfs.store._fetcher = EdgeUse()
    fr._eff_warmed = fr._eff_used = 0
    fr._ra_done = fr._last_end  # zero lookahead gap: ratio is exactly 0.8
    fr.read(CTX, 6 * BS, BS)
    assert fr._ra_window == min(vfs.reader.streaming_cap(), w * 2)


def test_efficiency_evaluates_at_exact_min_issued(vfs):
    """d_issued == max(8, 2*gap) must evaluate (shrink on waste), not
    return None (grow) — the boundary decides whether a barely-active
    prefetcher can ever be throttled."""
    ino = _write(vfs, b"f", 64 * BS)
    fr = vfs.reader.open(ino)
    _sync_plans(vfs.reader)
    for i in range(6):
        fr.read(CTX, i * BS, BS)
    w = fr._ra_window
    assert w > BS

    class EightIssued:
        depth = 64

        def counters(self):
            return (8, 8, 0, 0)  # exactly the minimum, all wasted

        def fetch(self, key):
            pass

        def consumed(self, key):
            pass

    vfs.store._fetcher = EightIssued()
    fr._eff_warmed = fr._eff_used = 0
    fr._ra_done = fr._last_end  # gap 0: threshold is exactly 8
    fr.read(CTX, 6 * BS, BS)
    assert fr._ra_window == w // 2


def test_reader_default_constants_pinned():
    """The defaults are mount-surface contract (docs/ARCHITECTURE.md
    'Streaming read path'): slack covers FUSE fragment reorder, the
    streaming threshold is past any kernel readahead, and the eval floor
    keeps the ratio from acting on noise."""
    from juicefs_tpu_torch.vfs import reader as rmod

    assert rmod.DEFAULT_MAX_READAHEAD == 8 << 20
    assert rmod.DEFAULT_MAX_STREAMING == 64 << 20
    assert rmod.DEFAULT_STREAMING_AFTER == 16 << 20
    assert rmod.DEFAULT_SEQ_SLACK == 1 << 20
    assert rmod._EFF_MIN_ISSUED == 8
    assert rmod._EFF_LOW == 0.5 and rmod._EFF_HIGH == 0.8


# ---------------------------------------------------------------------------
# review-fix regressions

def test_rewind_reestablishes_sequential_pattern(vfs):
    """A handle rewound to offset 0 (the next epoch over the SAME fd)
    must rebuild its window from the new position — the frontier moves
    on a true seek instead of pinning at the old high-water mark (which
    would classify every read of the new pass as random forever)."""
    vfs.reader.seq_slack = BS  # rewinds land far outside the band
    ino = _write(vfs, b"f", 64 * BS)
    fr = vfs.reader.open(ino)
    _sync_plans(vfs.reader)
    for i in range(8):
        fr.read(CTX, i * BS, BS)
    assert fr._ra_window > 0
    fr.read(CTX, 0, BS)  # rewind: collapse, frontier moves to BS
    assert fr._ra_window == 0
    assert fr._last_end == BS
    fr.read(CTX, BS, BS)  # the very next read is sequential again
    assert fr._ra_window == BS
    fr.read(CTX, 2 * BS, BS)
    assert fr._ra_window == 2 * BS




def test_cache_contains_probe_is_indexed(tmp_path):
    """contains() must not read block payloads (the disk tier's load()
    opens + CRCs the whole file; the planner probes every window)."""
    from juicefs_tpu_torch.chunk.disk_cache import CacheManager
    from juicefs_tpu_torch.chunk.mem_cache import MemCache

    mc = MemCache()
    mc.cache("k", b"x" * 64)
    assert mc.contains("k") and not mc.contains("nope")
    cm = CacheManager([str(tmp_path / "c")], 1 << 20)
    cm.cache("dk", b"y" * 64)
    assert cm.contains("dk") and not cm.contains("nope")
    # index-only: removing the file behind the index still answers True
    # (a false positive costs one prefetch no-op, never a wrong read)
    import os as _os
    for root, _dirs, files in _os.walk(str(tmp_path / "c")):
        for f in files:
            if "raw" in root:
                _os.unlink(_os.path.join(root, f))
    assert cm.contains("dk")


def test_stationary_hotspot_never_ramps(vfs):
    """Re-reading one offset sits inside the slack band but makes no
    progress — it must not grow the window, accrue streaming credit, or
    prefetch ahead of a frontier that never moves."""
    ino = _write(vfs, b"f", 64 * BS)
    fr = vfs.reader.open(ino)
    planned = []
    vfs.reader.submit_plan = lambda fr_, off, size: planned.append(
        (off, size)) or True
    fr.read(CTX, 0, BS)
    for _ in range(20):
        fr.read(CTX, BS, BS)  # poll the same record forever
    assert fr._ra_window <= BS  # at most the first transition's block
    assert not fr._streaming
    assert fr._seq_bytes <= 2 * BS
    assert len(planned) <= 1


def test_epoch_plan_overrides_name_order_guess(tmp_path):
    """Dataset-manifest epoch hint: with an exact
    plan installed, the sequential-EOF hook warms the PLANNED successor
    — not the name-ordered sibling — and skips the readdir guess."""
    v = _mk_vfs(tmp_path, streaming_after=2 * BS)
    try:
        shard0 = _write(v, b"shard-000", 8 * BS)
        shard1 = _write(v, b"shard-001", 8 * BS)  # the name-order guess
        shard7 = _write(v, b"shard-007", 8 * BS)  # the manifest's pick
        for ino in (shard1, shard7):
            st, slices = v.meta.read_chunk(ino, 0)
            assert st == 0 and slices
            for s in slices:
                v.store.evict_cache(s.id, s.size)
        v.reader.set_epoch_plan({shard0: shard7, shard7: shard0})
        readdirs = []
        orig_rd = v.meta.readdir

        def spy_rd(ctx, ino, want_attr=False):
            readdirs.append(ino)
            return orig_rd(ctx, ino, want_attr)
        v.meta.readdir = spy_rd
        fr = v.reader.open(shard0)
        pos = 0
        while pos < 8 * BS:
            st, data = fr.read(CTX, pos, BS)
            assert st == 0
            pos += len(data)
        st, planned = v.meta.read_chunk(shard7, 0)
        assert st == 0
        st, guessed = v.meta.read_chunk(shard1, 0)
        assert st == 0
        deadline = time.time() + 5
        warmed = 0
        want = sum((s.size + BS - 1) // BS for s in planned)
        while time.time() < deadline:
            warmed = sum(v.store.check_cache(s.id, s.size) for s in planned)
            if warmed >= want:
                break
            time.sleep(0.02)
        assert warmed > 0, "planned successor never warmed"
        assert not readdirs, "exact plan must skip the readdir guess"
        assert sum(v.store.check_cache(s.id, s.size) for s in guessed) == 0, \
            "name-order sibling must NOT be warmed when a plan exists"
    finally:
        v.close()


def test_epoch_plan_ctl_op_installs_and_clears(tmp_path):
    """`.control` epoch_plan: names resolve to an ino->successor map
    (wrapping), bad names errno out, empty clears."""
    v = _mk_vfs(tmp_path)
    try:
        a = _write(v, b"sh-a", BS)
        b = _write(v, b"sh-b", BS)
        c = _write(v, b"sh-c", BS)
        from juicefs_tpu_torch.vfs.internal import ControlHandler

        h = ControlHandler(v)
        out = h.handle(CTX, {"op": "epoch_plan", "dir": 1,
                             "shards": ["sh-c", "sh-a", "sh-b"]})
        assert out["errno"] == 0 and out["planned"] == 3
        assert v.reader._epoch_plan == {c: a, a: b, b: c}
        out = h.handle(CTX, {"op": "epoch_plan", "dir": 1,
                             "shards": ["missing"]})
        assert out["errno"] != 0
        out = h.handle(CTX, {"op": "epoch_plan", "shards": []})
        assert out["errno"] == 0 and v.reader._epoch_plan == {}
    finally:
        v.close()


def test_warm_hint_not_bounced_on_disagreeing_rings(tmp_path):
    """Churn can leave two members each believing the other owns a key;
    the receiving server must ABSORB such a hint (202, no enqueue) —
    enqueueing would re-forward it and ping-pong forever."""
    from juicefs_tpu_torch.cache import CacheGroup, PeerBlockServer
    from juicefs_tpu_torch.chunk.cached_store import block_key

    store = CachedStore(create_storage("mem://"),
                        ChunkConfig(block_size=BS, cache_dirs=("memory",)))
    srv = PeerBlockServer(store, group="pp")
    try:
        # this member's ring view: everything owned by SOMEONE ELSE
        store.cache_group = CacheGroup(
            "pp", self_addr="me:1",
            static_peers={"me:1": 1, "other:1": 1})
        key = next(block_key(s, 0, BS) for s in range(1000)
                   if store.cache_group.ring.owner(block_key(s, 0, BS))
                   == "other:1")
        fetched = []
        store.prefetcher.fetch = lambda ks: fetched.append(ks)
        assert srv._warm(key) is True  # absorbed
        assert fetched == [], "non-owned hint was enqueued (ping-pong)"
        # an owned key still warms
        mine = next(block_key(s, 0, BS) for s in range(1000)
                    if store.cache_group.ring.owner(block_key(s, 0, BS))
                    == "me:1")
        assert srv._warm(mine) is True
        assert fetched == [(mine, BS)]
    finally:
        srv.stop()
        store.close()
