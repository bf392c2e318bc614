"""Twin of tests/test_parallel_fetch.py on the port: the ordered
bounded-window parallel fetch stage (chunk/parallel.py), then the port's
stage held against the reference's on seeded items.

Results yield in input order under out-of-order
completion, the in-flight window is a hard bound (gating fake store), the
per-item error policy behaves (skip vs raise), and concurrent fetches of
one key collapse onto the store's singleflight leader.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig, block_key
from juicefs_tpu_torch.chunk.parallel import FetchStats, fetch_ordered
from juicefs_tpu_torch.object import MemStorage
from juicefs_tpu_torch.object.interface import NotFoundError


@pytest.fixture
def pool():
    p = ThreadPoolExecutor(max_workers=8, thread_name_prefix="t-fetch")
    yield p
    p.shutdown(wait=True)


def test_yields_in_input_order_under_out_of_order_completion(pool):
    # later items complete FIRST (reverse delays): output must not reorder
    def fn(i):
        time.sleep((9 - i) * 0.01)
        return i * 10

    out = list(fetch_ordered(range(10), fn, pool, window=8))
    assert out == [(i, i * 10) for i in range(10)]


def test_window_bounds_concurrent_gets(pool):
    # gating fake store: every GET records concurrency; the stage must
    # never have more than `window` in flight even though the pool has 8
    # workers and 40 items are offered
    lock = threading.Lock()
    state = {"cur": 0, "max": 0}

    def gated_get(i):
        with lock:
            state["cur"] += 1
            state["max"] = max(state["max"], state["cur"])
        time.sleep(0.005)
        with lock:
            state["cur"] -= 1
        return i

    list(fetch_ordered(range(40), gated_get, pool, window=3))
    assert state["max"] <= 3
    assert state["max"] >= 2  # it DID overlap (not accidentally serial)


def test_buffered_results_never_exceed_window(pool):
    # item 0 is the slow head: everything else completes and must wait,
    # but completed-minus-consumed can never exceed the window
    done = {"n": 0}
    lock = threading.Lock()
    max_buffered = {"n": 0}

    def fn(i):
        if i == 0:
            time.sleep(0.05)
        with lock:
            done["n"] += 1
        return i

    consumed = 0
    for _ in fetch_ordered(range(20), fn, pool, window=4):
        with lock:
            max_buffered["n"] = max(max_buffered["n"], done["n"] - consumed)
        consumed += 1
    assert max_buffered["n"] <= 4


def test_error_policy_skip_drops_item_and_counts(pool):
    stats = FetchStats()

    def fn(i):
        if i in (2, 5):
            raise IOError("backend hiccup")
        if i == 7:
            raise NotFoundError("gone")
        return i

    out = list(fetch_ordered(range(10), fn, pool, window=4,
                             on_error="skip", stats=stats))
    assert [i for i, _ in out] == [0, 1, 3, 4, 6, 8, 9]
    assert stats.errors == 3
    assert stats.items == 10  # every call recorded, errored or not


def test_error_policy_raise_propagates_in_input_order(pool):
    seen = []

    def fn(i):
        if i == 3:
            raise ValueError("block 3 corrupt")
        return i

    gen = fetch_ordered(range(10), fn, pool, window=4, on_error="raise")
    with pytest.raises(ValueError, match="block 3"):
        for i, _ in gen:
            seen.append(i)
    assert seen == [0, 1, 2]  # everything before the bad item arrived


def test_invalid_error_policy_rejected(pool):
    with pytest.raises(ValueError):
        next(fetch_ordered([1], lambda x: x, pool, 1, on_error="ignore"))


def test_stats_wall_is_busy_time_not_span(pool):
    # consumer-paced stage (hash-bound scan shape): GETs are instant but a
    # new one is only issued as the consumer drains.  Busy wall must stay
    # near zero — first-start-to-last-end would count the consumer's time
    # as GET time and misreport the bottleneck.
    stats = FetchStats()
    t0 = time.perf_counter()
    for _ in fetch_ordered(range(10), lambda i: i, pool, window=2,
                           stats=stats):
        time.sleep(0.02)  # the "hash" stage
    elapsed = time.perf_counter() - t0
    assert elapsed >= 0.15
    assert stats.wall < elapsed / 3  # idle gaps are NOT attributed to GET


def test_stats_wall_vs_aggregate_show_overlap(pool):
    # 8 sleeps of 30ms through a window of 8: aggregate thread time is
    # ~240ms but wall is ~30ms — the overlap factor the bench reports
    stats = FetchStats()
    list(fetch_ordered(range(8), lambda i: time.sleep(0.03), pool,
                       window=8, stats=stats))
    assert stats.seconds >= 8 * 0.025
    assert stats.wall < stats.seconds / 2  # genuinely overlapped


class _GatedStorage(MemStorage):
    """get() parks until released; counts raw GETs per key."""

    def __init__(self):
        super().__init__()
        self.release = threading.Event()
        self.get_calls = 0
        self._glock = threading.Lock()

    def get(self, key, off=0, size=-1):
        with self._glock:
            self.get_calls += 1
        self.release.wait(timeout=5)
        return super().get(key, off, size)


def test_singleflight_dedups_scan_and_reader(pool):
    # a dedup-scan fetch and a reader load of the SAME block in flight
    # concurrently must collapse to one storage GET (singleflight leader)
    storage = _GatedStorage()
    store = CachedStore(storage, ChunkConfig(block_size=1 << 16,
                                             cache_size=1))
    try:
        data = b"z" * (1 << 16)
        w = store.new_writer(5)
        w.write_at(data, 0)
        w.finish(len(data))
        key = block_key(5, 0, 1 << 16)
        storage.get_calls = 0

        results = []

        def scan():
            results.extend(fetch_ordered(
                [key],
                lambda k: store._load_block(k, 1 << 16, cache_after=False),
                store._rpool, window=2,
            ))

        # the leader is parked on the gate, so the flight stays open until
        # we release it — wait for BOTH the leader's GET and the follower's
        # singleflight join (a fixed sleep flakes under full-suite load)
        from juicefs_tpu_torch.metric import global_registry

        shared = global_registry()._metrics["juicefs_singleflight_shared"]
        s0 = shared.value  # one follower join is the target delta
        t_scan = threading.Thread(target=scan)
        t_scan.start()
        reader_out = []
        t_read = threading.Thread(
            target=lambda: reader_out.append(store._load_block(key, 1 << 16))
        )
        t_read.start()
        deadline = time.time() + 5
        while (storage.get_calls == 0 or shared.value < s0 + 1) \
                and time.time() < deadline:
            time.sleep(0.005)
        storage.release.set()
        t_scan.join(timeout=5)
        t_read.join(timeout=5)
        assert results == [(key, data)]
        assert reader_out == [data]
        assert storage.get_calls == 1  # the follower shared the leader's GET
    finally:
        store.close()


def test_store_remove_counts_only_real_errors():
    class FlakyDelete(MemStorage):
        """MemStorage.delete silently ignores missing keys; real backends
        raise NotFoundError — model that so the idempotent branch runs."""

        def __init__(self):
            super().__init__()
            self.fail_keys = set()

        def delete(self, key):
            if key in self.fail_keys:
                raise IOError("backend down")
            with self._lock:
                if key not in self._data:
                    raise NotFoundError(key)
            return super().delete(key)

    storage = FlakyDelete()
    store = CachedStore(storage, ChunkConfig(block_size=1 << 16,
                                             max_retries=1))
    try:
        data = b"y" * (3 << 16)
        w = store.new_writer(9)
        w.write_at(data, 0)
        w.finish(len(data))
        # one real failure; the others delete fine
        storage.fail_keys.add(block_key(9, 1, 1 << 16))
        assert store.remove(9, len(data)) == 1
        # second pass: the two deleted blocks are NotFound (idempotent,
        # not errors), the flaky one still fails
        assert store.remove(9, len(data)) == 1
        storage.fail_keys.clear()
        assert store.remove(9, len(data)) == 0  # all NotFound now: clean
    finally:
        store.close()


def test_fill_cache_parallel_and_raises():
    store = CachedStore(MemStorage(), ChunkConfig(block_size=1 << 16))
    try:
        data = b"w" * (4 << 16)
        w = store.new_writer(11)
        w.write_at(data, 0)
        w.finish(len(data))
        store.evict_cache(11, len(data))
        store.fill_cache(11, len(data))
        assert store.check_cache(11, len(data)) == 4
        # a missing slice raises (fill is an integrity-sensitive path)
        with pytest.raises(NotFoundError):
            store.fill_cache(404, 1 << 16)
    finally:
        store.close()


def test_prefetcher_close_stops_workers():
    """The prefetcher owns no threads — it submits to the
    unified scheduler at PREFETCH class.  close() drains its own work and
    refuses new fetches; the shared scheduler workers keep running."""
    from juicefs_tpu_torch.chunk.prefetch import Prefetcher

    fetched = []
    p = Prefetcher(lambda k: fetched.append(k) or True, workers=2)
    p.fetch(("k", 1))
    deadline = time.time() + 2
    while not fetched and time.time() < deadline:
        time.sleep(0.01)
    assert fetched == [("k", 1)]
    p.close()
    # a fetch after close is dropped, never submitted
    p.fetch(("k2", 1))
    time.sleep(0.05)
    assert fetched == [("k", 1)]
    # the scheduler the prefetcher rode is still alive for other users
    from juicefs_tpu_torch.qos import IOClass, global_scheduler

    ex = global_scheduler().executor("download", IOClass.FOREGROUND)
    assert ex.submit(lambda: 7).result(timeout=5) == 7
    ex.shutdown()


def test_pipeline_inflight_depth_preserves_results():
    from juicefs_tpu_torch.gpu.pipeline import HashPipeline, PipelineConfig
    from juicefs_tpu_torch.gpu.jth256 import jth256

    blocks = [bytes([i]) * 4096 for i in range(10)]
    for depth in (1, 2, 4):
        pipe = HashPipeline(PipelineConfig(
            backend="cpu", batch_blocks=3, pad_lanes=1,
            max_inflight_batches=depth,
        ))
        out = pipe.hash_blocks(blocks)
        assert out == [jth256(b) for b in blocks]


# ---------------------------------------------------------------------------
# parity with the reference's stage on the same seeded items


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("on_error", ["skip", "raise"])
def test_stage_matches_reference(pool, seed, on_error):
    """Both packages' fetch_ordered over the same seeded delays and
    failures: the same (item, result) sequence, the same first error
    under "raise", and the same item and error counts under "skip"."""
    import random

    from juicefs_tpu.chunk.parallel import FetchStats as RefFetchStats
    from juicefs_tpu.chunk.parallel import fetch_ordered as ref_fetch_ordered

    rng = random.Random(seed)
    delays = [rng.random() * 0.004 for _ in range(48)]
    failing = set(rng.sample(range(48), 5))

    def fn(i):
        time.sleep(delays[i])
        if i in failing:
            raise IOError(f"item {i}")
        return i * 7

    def run(stage, stats):
        out = []
        try:
            for item, res in stage(range(48), fn, pool, window=rng_window, on_error=on_error,
                                   stats=stats):
                out.append((item, res))
        except IOError as e:
            out.append(("raised", str(e)))
        return out, (stats.items, stats.errors) if on_error == "skip" else None

    rng_window = rng.randint(2, 8)
    got = run(fetch_ordered, FetchStats())
    want = run(ref_fetch_ordered, RefFetchStats())
    assert got == want
    if on_error == "skip":
        assert [i for i, _ in got[0]] == [i for i in range(48) if i not in failing]
    else:
        assert got[0][-1] == ("raised", f"item {min(failing)}")
