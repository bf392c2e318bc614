"""Chaos drills over the port (juicefs_tpu_torch/object/fault.py
FaultyStore under the port's chunk store, vfs, meta-server and sync): the
twins of tests/test_chaos.py, plus parity with the JAX package.

Failure classes covered, as in the reference's drills:

  1. flaky PUTs     — write path retries; no torn blocks, readback exact
  2. flaky + SHORT GETs — read path retries; short responses never
                      surface as torn data
  3. meta-server crash mid-workload — client reconnects, AOF restores
                      state, operations converge
  4. writeback upload outage — staged blocks survive the storm, serve
                      reads, and replay on recovery
  5. sync over a flaky destination — converges byte-identical
  6. hung GETs      — a backend call that never returns is abandoned at
                      its deadline and retried; no pinned worker threads
  7. brownout       — hangs + throttle errors; hedged GETs bound the
                      tail, readback exact
  8. blackout       — mid-workload total outage; breaker trips (and is
                      observable via `.status`), cached reads serve with
                      ZERO backend calls, writes degrade to staging and
                      replay byte-identical after heal

Parity: with one seed the port's FaultyStore rolls the reference's faults,
op for op, and each package's resilience layer classifies its own
injected faults the same way (InjectedFault TRANSIENT, InjectedThrottle
THROTTLE). The drills wait on state (a breaker state, a staged set, a
counter), not on fixed sleeps. The stores compress nothing, so no drill
touches a device.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time

import pytest

from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig
from juicefs_tpu_torch.meta import Format, new_client
from juicefs_tpu_torch.meta.context import Context
from juicefs_tpu_torch.object import create_storage
from juicefs_tpu_torch.object.fault import FaultyStore, InjectedFault
from juicefs_tpu_torch.object.interface import ObjectStorage
from juicefs_tpu_torch.object.resilient import (
    BreakerState,
    CircuitBreaker,
    RetryPolicy,
)
from juicefs_tpu_torch.vfs import ROOT_INO, VFS

CTX = Context(uid=0, gid=0, pid=1)


def _wait_for(cond, timeout: float, what: str) -> None:
    """Poll `cond` until it holds; fail naming `what` after `timeout`
    seconds (a generous bound: the drills wait on state, not on time)."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _mkvfs(storage, block_size=1 << 16, cache_dirs=("memory",), **chunk_kw):
    m = new_client("mem://")
    m.init(Format(name="chaos", storage="mem", trash_days=0), force=False)
    m.load()
    m.new_session()
    store = CachedStore(storage, ChunkConfig(
        block_size=block_size, cache_dirs=cache_dirs, **chunk_kw))
    return VFS(m, store), store


def test_flaky_puts_no_torn_blocks():
    """30% PUT failures: the upload retry/backoff absorbs them and every
    byte reads back exactly (reference cached_store.go:394-410 retry)."""
    faulty = FaultyStore(create_storage("mem://"), put_error_rate=0.3, seed=7)
    v, store = _mkvfs(faulty)
    rng = random.Random(1)
    files = {}
    for i in range(8):
        name = f"f{i}".encode()
        blob = rng.randbytes(rng.randrange(1, 300_000))
        st, ino, _, fh = v.create(CTX, ROOT_INO, name, 0o644)
        assert st == 0
        v.write(CTX, ino, fh, 0, blob)
        assert v.flush(CTX, ino, fh) == 0
        v.release(CTX, ino, fh)
        files[name] = (ino, blob)
    store.flush_all()
    assert faulty.counters["errors"] > 0, "no faults were injected"
    # cold readback: drop the cache so every block refetches
    store.cache = __import__("juicefs_tpu_torch.chunk.mem_cache",
                             fromlist=["MemCache"]).MemCache(0)
    faulty.fault_config(get_error_rate=0.2)
    for name, (ino, blob) in files.items():
        st, _, fh = v.open(CTX, ino, os.O_RDONLY)
        st, got = v.read(CTX, ino, fh, 0, len(blob) + 10)
        assert st == 0 and bytes(got) == blob, f"torn data in {name!r}"
        v.release(CTX, ino, fh)
    v.close()


def test_short_reads_never_surface_torn_data():
    """Truncated GET responses (flaky proxy / cut connection) must be
    retried, not passed through — both the full-block and the ranged-GET
    paths validate response length."""
    faulty = FaultyStore(create_storage("mem://"), short_reads=0.5, seed=3)
    v, store = _mkvfs(faulty)
    blob = random.Random(2).randbytes(250_000)
    st, ino, _, fh = v.create(CTX, ROOT_INO, b"sr.bin", 0o644)
    v.write(CTX, ino, fh, 0, blob)
    assert v.flush(CTX, ino, fh) == 0
    store.flush_all()
    store.cache = __import__("juicefs_tpu_torch.chunk.mem_cache",
                             fromlist=["MemCache"]).MemCache(0)
    # many small ranged reads (the short-read-prone path): a read either
    # succeeds EXACTLY or fails loudly after exhausting retries (at 50%
    # injection, 10 consecutive shorts do happen) — torn data never
    rng = random.Random(4)
    ok_reads = 0
    for _ in range(40):
        off = rng.randrange(0, len(blob) - 1)
        n = rng.randrange(1, 5000)
        try:
            st, got = v.read(CTX, ino, fh, off, n)
        except OSError:
            continue  # retries exhausted honestly: acceptable, never torn
        assert st == 0
        assert bytes(got) == blob[off:off + len(got)]
        assert len(got) == min(n, len(blob) - off), "short read surfaced"
        ok_reads += 1
    assert ok_reads > 10, "nearly every read exhausted retries"
    faulty.fault_config(short_reads=0.0)  # heal: the data must be intact
    st, got = v.read(CTX, ino, fh, 0, len(blob))
    assert st == 0 and bytes(got) == blob
    assert faulty.counters["short_reads"] > 0, "no short reads injected"
    v.release(CTX, ino, fh)
    v.close()


def test_meta_server_crash_and_recovery(tmp_path):
    """Kill the meta server mid-workload; the client's reconnect layer
    retries, the AOF restores committed state, and the tree converges."""
    from juicefs_tpu_torch.meta.redis_server import RedisServer

    aof = str(tmp_path / "meta.aof")
    srv = RedisServer(data_path=aof, fsync="always")
    port = srv.start()
    url = f"redis://127.0.0.1:{port}/0"
    m = new_client(url)
    m.init(Format(name="crashvol", trash_days=0), force=True)
    m.load()
    made = []
    for i in range(10):
        st, ino, _ = m.create(CTX, 1, f"pre{i}".encode(), 0o644)
        assert st == 0
        m.close(CTX, ino)
        made.append(f"pre{i}".encode())
    srv.stop()  # crash

    # restart on the SAME port with the AOF
    srv2 = RedisServer(port=port, data_path=aof, fsync="always")
    deadline = time.time() + 10
    while True:
        try:
            srv2.start()
            break
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)  # TIME_WAIT on the port
    try:
        # the SAME client object must recover (reconnect layer) and see
        # every pre-crash file
        st, entries = m.readdir(CTX, 1, want_attr=False)
        assert st == 0
        names = {bytes(e.name) for e in entries}
        for n in made:
            assert n in names, f"{n!r} lost across the crash"
        # and keep working
        st, ino, _ = m.create(CTX, 1, b"post", 0o644)
        assert st == 0
        m.close(CTX, ino)
        assert m.lookup(CTX, 1, b"post")[0] == 0
    finally:
        srv2.stop()


def test_writeback_survives_upload_outage(tmp_path):
    """A total object-store outage during writeback: acks stay fast,
    reads serve from staging, staged blocks survive a process restart and
    replay when the store heals (reference disk_cache.go staging)."""
    cache_dir = str(tmp_path / "cache")
    inner = create_storage("mem://")
    faulty = FaultyStore(inner, put_error_rate=1.0, seed=9)
    v, store = _mkvfs(faulty, cache_dirs=(cache_dir,), writeback=True,
                      max_retries=2)
    blob = os.urandom(200_000)
    st, ino, _, fh = v.create(CTX, ROOT_INO, b"wb.bin", 0o644)
    v.write(CTX, ino, fh, 0, blob)
    assert v.flush(CTX, ino, fh) == 0   # writeback: ack without the store
    # reads work during the outage (served from staging)
    st, got = v.read(CTX, ino, fh, 1000, 5000)
    assert st == 0 and bytes(got) == blob[1000:6000]
    v.release(CTX, ino, fh)
    meta = v.meta
    _wait_for(lambda: faulty.counters["errors"] > 0, 30.0,
              "a background upload to fail")
    v.writer.close_all()
    store._pool.shutdown(wait=True)
    store.release_cache_locks()

    # "restart": new store over the same cache dir, store healed
    healed = FaultyStore(inner, put_error_rate=0.0, seed=9)
    store2 = CachedStore(healed, ChunkConfig(
        block_size=1 << 16, cache_dirs=(cache_dir,), writeback=True))
    store2.flush_all(timeout=30)
    # every block of the file is now really in the object store
    st, slices = meta.read_chunk(ino, 0)
    assert st == 0 and slices
    from juicefs_tpu_torch.chunk.cached_store import block_key
    for s in slices:
        if s.id:
            nblocks = (s.size + (1 << 16) - 1) >> 16
            for i in range(nblocks):
                bsize = min(1 << 16, s.size - (i << 16))
                assert inner.head(block_key(s.id, i, bsize)).size > 0
    store2.close()


def test_sync_converges_over_flaky_destination(tmp_path):
    """Bulk sync with an error-prone destination: per-task retries plus a
    second pass converge to byte-identical trees."""
    from types import SimpleNamespace

    from juicefs_tpu_torch.cmd.sync import _copy_object, _diff, _new_stats

    src = create_storage(f"file://{tmp_path}/src")
    src.create()
    rng = random.Random(5)
    want = {}
    for i in range(25):
        key = f"obj{i:02d}"
        data = rng.randbytes(rng.randrange(10, 80_000))
        src.put(key, data)
        want[key] = data
    inner_dst = create_storage(f"file://{tmp_path}/dst")
    inner_dst.create()
    dst = FaultyStore(inner_dst, put_error_rate=0.3, seed=11)
    args = SimpleNamespace(big_threshold=1024, part_size=8, delete_dst=False,
                           delete_src=False, update=False, force_update=False,
                           check_all=False, check_new=False, dry=False)
    for _pass in range(6):  # flaky runs retry failed objects on later passes
        stats = _new_stats()
        tasks = list(_diff(src.list_all(""), dst.list_all(""), args))
        if not tasks:
            break
        for op, s, d in tasks:
            if op == "copy":
                try:
                    _copy_object(src, dst, s, args, stats)
                except InjectedFault:
                    pass  # next pass retries
    got = {o.key: bytes(inner_dst.get(o.key)) for o in inner_dst.list_all("")}
    assert got == want, "sync never converged over the flaky destination"
    assert dst.counters["errors"] > 0


# -- object-plane resilience drills -----------------------------------------

class _CallCounter(ObjectStorage):
    """Counts every DATA call (get/put/delete) that reaches the backend
    stack below the resilience layer — the blackout drill asserts ZERO of
    these while the breaker is open.  HEAD is tracked separately: the
    breaker's half-open recovery probes are sentinel HEADs and are the one
    backend touch an open circuit is SUPPOSED to make."""

    def __init__(self, inner):
        self._s = inner
        self.calls = 0
        self.head_calls = 0
        self._mu = threading.Lock()

    def _tick(self):
        with self._mu:
            self.calls += 1

    def string(self):
        return self._s.string()

    def create(self):
        self._s.create()

    def get(self, key, off=0, limit=-1):
        self._tick()
        return self._s.get(key, off, limit)

    def put(self, key, data):
        self._tick()
        self._s.put(key, data)

    def delete(self, key):
        self._tick()
        self._s.delete(key)

    def head(self, key):
        with self._mu:
            self.head_calls += 1
        return self._s.head(key)

    def list_all(self, prefix="", marker=""):
        self._tick()
        return self._s.list_all(prefix, marker)


def _counter_value(name, *labels):
    from juicefs_tpu_torch.metric import global_registry

    m = global_registry()._metrics[name]
    return (m.labels(*labels) if labels else m).value


def test_hung_get_abandoned_at_deadline_and_retried():
    """A GET that never returns must be abandoned at its attempt bound and
    retried — the download path finishes fast and no pool worker stays
    pinned (the autouse thread-leak guard enforces the latter)."""
    inner = create_storage("mem://")
    faulty = FaultyStore(inner, seed=5)
    store = CachedStore(faulty, ChunkConfig(
        block_size=1 << 16, hedge=False,
        retry_policy=RetryPolicy(deadline=6.0, max_attempts=5,
                                 attempt_timeout=0.2, base=0.001, jitter=0.0),
        breaker=CircuitBreaker(backend="hung-get", min_samples=1000,
                               probe_interval=999.0)))
    try:
        blob = os.urandom(1 << 16)
        w = store.new_writer(31)
        w.write_at(blob, 0)
        w.finish(len(blob))
        from juicefs_tpu_torch.chunk.mem_cache import MemCache

        store.cache = MemCache(0)  # force a backend GET
        a0 = _counter_value("juicefs_object_deadline_abandoned", "GET")
        # scripted outage: every op hangs "forever" for 0.45s of wall
        # time, then the store heals — attempts 1-3 are abandoned at
        # their 0.2s bound, the first post-heal attempt succeeds
        faulty.fault_schedule([
            (0.45, dict(hang_rate=1.0, hang_seconds=60.0)),
            (None, dict(hang_rate=0.0)),
        ])
        t0 = time.perf_counter()
        got = store.new_reader(31, len(blob)).read(0, len(blob))
        took = time.perf_counter() - t0
        assert bytes(got) == blob
        assert took < 3.0, f"hung GET was not abandoned ({took:.2f}s)"
        assert _counter_value("juicefs_object_deadline_abandoned",
                              "GET") > a0
        assert faulty.counters["hangs"] >= 1
    finally:
        faulty.fault_config(hang_rate=0.0)  # release any parked hangers
        store.close()


def test_brownout_hedged_gets_bound_tail_latency():
    """Brownout: a slice of ops hang and a slice throttle.  Hedged GETs +
    deadline abandonment keep every read far below the hang duration, all
    bytes come back exact, and the per-class retry counters show throttle
    handled as its own class."""
    inner = create_storage("mem://")
    faulty = FaultyStore(inner, seed=21)
    store = CachedStore(faulty, ChunkConfig(
        block_size=1 << 16, hedge=True, hedge_delay=0.05,
        retry_policy=RetryPolicy(deadline=10.0, max_attempts=6,
                                 attempt_timeout=0.5, base=0.001,
                                 throttle_base=0.01, jitter=0.0),
        breaker=CircuitBreaker(backend="brownout", min_samples=1000,
                               probe_interval=999.0)))
    try:
        rng = random.Random(3)
        slices = {}
        for sid in range(40, 46):
            blob = rng.randbytes(3 * (1 << 16))
            w = store.new_writer(sid)
            w.write_at(blob, 0)
            w.finish(len(blob))
            slices[sid] = blob
        from juicefs_tpu_torch.chunk.mem_cache import MemCache

        store.cache = MemCache(0)  # every read goes to the backend
        backend = store.storage.metric_backend  # hedge counters' label
        h0 = _counter_value("juicefs_object_hedged_requests", backend)
        th0 = _counter_value("juicefs_object_retries_by_class", "throttle")
        # throttle_rate high enough that several PRIMARY attempts throttle
        # (a throttle losing a hedged race is absorbed without a retry —
        # correct, but then it would never show up in the class counters)
        faulty.fault_config(hang_rate=0.2, hang_seconds=30.0,
                            throttle_rate=0.35)
        worst = 0.0
        for sid, blob in slices.items():
            t0 = time.perf_counter()
            got = store.new_reader(sid, len(blob)).read(0, len(blob))
            worst = max(worst, time.perf_counter() - t0)
            assert bytes(got) == blob, f"torn data in slice {sid}"
        # p100 stays far below the 30s hang: hedges + abandonment win
        assert worst < 5.0, f"brownout tail not bounded ({worst:.2f}s)"
        assert _counter_value("juicefs_object_hedged_requests",
                              backend) > h0, "no hedges were issued"
        assert _counter_value("juicefs_object_retries_by_class",
                              "throttle") > th0, "no throttle retries seen"
        assert faulty.counters["hangs"] > 0
        assert faulty.counters["throttles"] > 0
    finally:
        faulty.fault_config(hang_rate=0.0, throttle_rate=0.0)
        store.close()


def test_blackout_breaker_ladder_and_replay(tmp_path):
    """Total mid-workload outage: the breaker trips (observable through
    `.status`), cache-hit reads return correct bytes with ZERO backend
    calls, cache misses fail fast with EIO, writes degrade to forced
    writeback staging without touching the backend, and after heal the
    replay converges byte-identical."""
    inner = create_storage("mem://")
    faulty = FaultyStore(inner, seed=13)
    calls = _CallCounter(faulty)
    br = CircuitBreaker(backend="blackout", threshold=0.5, min_samples=4,
                        probe_interval=0.05)
    v, store = _mkvfs(
        calls, block_size=1 << 16, max_retries=2, hedge=False,
        retry_policy=RetryPolicy(deadline=5.0, max_attempts=2, base=0.001,
                                 jitter=0.0),
        breaker=br)
    rng = random.Random(9)
    try:
        blob_a = rng.randbytes(150_000)  # warm file: served during outage
        blob_b = rng.randbytes(100_000)  # evicted file: EIO during outage
        st, ino_a, _, fh_a = v.create(CTX, ROOT_INO, b"a.bin", 0o644)
        v.write(CTX, ino_a, fh_a, 0, blob_a)
        assert v.flush(CTX, ino_a, fh_a) == 0
        st, ino_b, _, fh_b = v.create(CTX, ROOT_INO, b"b.bin", 0o644)
        v.write(CTX, ino_b, fh_b, 0, blob_b)
        assert v.flush(CTX, ino_b, fh_b) == 0
        store.flush_all()
        st, got = v.read(CTX, ino_a, fh_a, 0, len(blob_a))  # warm the cache
        assert st == 0 and bytes(got) == blob_a

        # ---- outage + trip: cold reads of an evicted file burn failures
        faulty.fault_config(error_rate=1.0)
        st, slices_b = v.meta.read_chunk(ino_b, 0)
        for s in slices_b:
            if s.id:
                store.evict_cache(s.id, s.size)
        for _ in range(3):
            if br.state == BreakerState.OPEN:
                break
            with pytest.raises(OSError):
                v.read(CTX, ino_b, fh_b, 0, len(blob_b))
        assert br.state == BreakerState.OPEN
        assert store.degraded
        trips = _counter_value("juicefs_object_breaker_trips", "blackout")
        assert trips >= 1

        # ---- observable through the .status internal file
        from juicefs_tpu_torch.vfs.internal import STATUS_INO

        v.internal.open(STATUS_INO, 991)
        st, raw = v.internal.read(STATUS_INO, 991, 0, 1 << 20)
        v.internal.release(STATUS_INO, 991)
        status = json.loads(bytes(raw))
        assert status["degraded"] is True
        assert status["object_plane"]["breaker"]["state"] == "open"

        # ---- rung 1: cached reads serve exact bytes, ZERO backend calls
        _wait_for(lambda: store.prefetcher.outstanding == 0, 10.0,
                  "in-flight prefetches to settle")
        c0 = calls.calls
        for off in (0, 70_000, 130_000):
            st, got = v.read(CTX, ino_a, fh_a, off, 10_000)
            assert st == 0
            assert bytes(got) == blob_a[off:off + 10_000]
        # a stray prefetch would land here — none may
        _wait_for(lambda: store.prefetcher.outstanding == 0, 10.0,
                  "the reads' prefetches to settle")
        assert calls.calls == c0, "backend was called during open breaker"

        # ---- rung 3: cache misses fail FAST with EIO (no hang)
        t0 = time.perf_counter()
        with pytest.raises(OSError) as ei:
            v.read(CTX, ino_b, fh_b, 0, 4096)
        assert time.perf_counter() - t0 < 0.5, "EIO path was not fail-fast"
        assert ei.value.errno == 5  # EIO
        assert calls.calls == c0

        # ---- rung 2: writes degrade to forced staging, zero backend calls
        blob_c = rng.randbytes(120_000)
        st, ino_c, _, fh_c = v.create(CTX, ROOT_INO, b"c.bin", 0o644)
        v.write(CTX, ino_c, fh_c, 0, blob_c)
        assert v.flush(CTX, ino_c, fh_c) == 0, "degraded write must ack"
        assert calls.calls == c0, "degraded write touched the backend"
        with store._pending_lock:
            assert store._pending_staged, "nothing was staged"
        # staged data serves reads during the outage
        st, got = v.read(CTX, ino_c, fh_c, 5_000, 20_000)
        assert st == 0 and bytes(got) == blob_c[5_000:25_000]

        # ---- heal: probes close the breaker, reset replays staging
        faulty.fault_config(error_rate=0.0)
        deadline = time.time() + 8.0
        while br.state != BreakerState.CLOSED and time.time() < deadline:
            time.sleep(0.05)
        assert br.state == BreakerState.CLOSED
        assert _counter_value("juicefs_object_breaker_resets",
                              "blackout") >= 1
        store.flush_all(timeout=10.0)
        with store._pending_lock:
            assert not store._pending_staged

        # ---- converged: cold readback is byte-identical for every file
        from juicefs_tpu_torch.chunk.mem_cache import MemCache

        store.cache = MemCache(0)
        for ino, fh, blob in ((ino_a, fh_a, blob_a), (ino_b, fh_b, blob_b),
                              (ino_c, fh_c, blob_c)):
            st, got = v.read(CTX, ino, fh, 0, len(blob))
            assert st == 0 and bytes(got) == blob
    finally:
        v.close()
        store.close()


# -- parity with the JAX package ----------------------------------------------

def _rolls(pkg, seed: int) -> list:
    """One scripted op sequence through a FaultyStore of `pkg`: the
    outcome of every op (ok, short read length, or the fault's class)."""
    import importlib

    fault = importlib.import_module(pkg + ".object.fault")
    obj = importlib.import_module(pkg + ".object")
    st = fault.FaultyStore(obj.create_storage("mem://"), error_rate=0.2,
                           put_error_rate=0.3, short_reads=0.25,
                           throttle_rate=0.1, seed=seed)
    out = []
    payload = bytes(range(256)) * 8
    for i in range(300):
        key = f"k{i % 17}"
        op = ("put", "get", "head", "delete", "list")[i % 5]
        try:
            if op == "put":
                st.put(key, payload)
                out.append(("put", "ok"))
            elif op == "get":
                out.append(("get", len(st.get(key))))
            elif op == "head":
                out.append(("head", st.head(key).size))
            elif op == "delete":
                st.delete(key)
                out.append(("delete", "ok"))
            else:
                out.append(("list", len(list(st.list_all("")))))
        except Exception as e:
            out.append((op, type(e).__name__))
        if i == 150:
            st.fault_config(error_rate=0.05, short_reads=0.0)
    return out + [tuple(sorted(st.counters.items()))]


@pytest.mark.parametrize("seed", [0, 7, 2026])
def test_fault_rolls_equal_the_reference(seed):
    port, ref = _rolls("juicefs_tpu_torch", seed), _rolls("juicefs_tpu", seed)
    assert port == ref
    kinds = {o for _op, o in port[:-1] if isinstance(o, str)}
    assert {"InjectedFault", "InjectedThrottle", "ok"} <= kinds


def test_injected_faults_classify_as_the_reference():
    import importlib

    ref_fault = importlib.import_module("juicefs_tpu.object.fault")
    ref_resilient = importlib.import_module("juicefs_tpu.object.resilient")
    port_fault = importlib.import_module("juicefs_tpu_torch.object.fault")
    port_resilient = importlib.import_module("juicefs_tpu_torch.object.resilient")

    assert port_resilient.classify(port_fault.InjectedFault("x")) \
        == port_resilient.ErrorClass.TRANSIENT
    assert port_resilient.classify(port_fault.InjectedThrottle("x")) \
        == port_resilient.ErrorClass.THROTTLE
    for name in ("InjectedFault", "InjectedThrottle"):
        assert port_resilient.classify(getattr(port_fault, name)("x")).name \
            == ref_resilient.classify(getattr(ref_fault, name)("x")).name


def test_fault_schedule_and_keep_semantics():
    """fault_config leaves unnamed settings alone; a schedule's phases only
    advance, and its last phase holds."""
    st = FaultyStore(create_storage("mem://"), error_rate=0.5, latency=0.0,
                     throttle_rate=0.25, seed=1)
    st.fault_config(error_rate=0.0)
    assert (st.error_rate, st.throttle_rate) == (0.0, 0.25)
    st.fault_config(throttle_rate=0.0)
    st.fault_schedule([(60.0, dict(error_rate=1.0)), (None, dict(error_rate=0.0))])
    with pytest.raises(InjectedFault):
        st.put("k", b"v")
    assert st.counters["errors"] == 1
    st.fault_schedule([(0.0, dict(error_rate=1.0)), (None, dict(error_rate=0.0))])
    st.put("k", b"v")
    assert bytes(st.get("k")) == b"v" and st.string() == "faulty+" + \
        create_storage("mem://").string()
