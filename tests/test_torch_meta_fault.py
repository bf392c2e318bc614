"""The meta-plane fault contract of the port (juicefs_tpu_torch/meta/
resilient.py + meta/fault.py): the twins of tests/test_meta_fault.py's
drills, run over the port's FaultyMeta, plus parity with the JAX package.

The contract under test:
  * PERMANENT posix errnos pass through untouched; TRANSIENT/BUSY get
    jittered deadline-aware retries; AMBIGUOUS commits are never retried;
  * a failing engine trips a per-connection breaker (probe recovery);
  * while open: live-and-expired lease entries serve reads (stale-served,
    bounded by the configured ceiling) with ZERO engine round trips,
    guarded reads fail over to the replica, wbatch queues absorb writes
    and barriers surface EIO loudly;
  * heal replays the absorbed queue byte-identically, re-primes the
    replica epoch floor, and revives a reaped session;
  * default-off: nothing is wrapped, byte-identical engine calls.

Parity: with the same seed the port's fault rolls are the reference's, roll
for roll, and both packages classify their own injected faults the same
way. The blackout drill waits on state (replica caught up, breaker open,
lease expired, breaker closed), never on a fixed sleep. The port's txn
closures run under its own rerun harness, armed for the module.
"""

import errno
import os
import threading
import time

import pytest

from juicefs_tpu_torch.meta import Format, ROOT_INODE, Slice, new_client
from juicefs_tpu_torch.meta.context import Context
from juicefs_tpu_torch.meta.fault import (
    FaultyMeta,
    InjectedMetaFault,
    InjectedMetaThrottle,
)
from juicefs_tpu_torch.meta.redis_kv import MetaCommitUnknownError, MetaNetworkError
from juicefs_tpu_torch.meta.resilient import (
    BreakerState,
    MetaBreaker,
    MetaErrorClass,
    MetaRetryPolicy,
    MetaUnavailableError,
    classify_meta,
    meta_resilience_snapshot,
)

from juicefs_tpu_torch.utils import txnwatch

CTX = Context(uid=0, gid=0)


@pytest.fixture(scope="module", autouse=True)
def port_txnwatch():
    """Arm the port's rerun harness for this module (the suite's conftest
    arms only the reference's)."""
    assert txnwatch.enabled()
    txnwatch.install()
    try:
        yield txnwatch
    finally:
        txnwatch.uninstall()


@pytest.fixture(autouse=True)
def port_txnwatch_guard(port_txnwatch):
    before = len(txnwatch.violations())
    yield
    new = txnwatch.violations()[before:]
    assert not new, "port txn rerun violations:\n" + "\n".join(
        f"[{v['engine']}] {v['closure']}: {v['detail']}" for v in new)


def _wait_for(cond, timeout: float, what: str) -> None:
    """Poll `cond` until it holds; fail naming `what` after `timeout`
    seconds (a generous bound: the drills wait on state, not on time)."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)

# fast-breaker profile for drills: trips after 4 window samples at 50%,
# probes every 50ms, whole-op deadline 1.5s
FAST = dict(max_attempts=3, deadline=1.5, min_samples=4, window=10.0,
            threshold=0.5, probe_interval=0.05)


def _mk(name="fault", attr_ttl=0.0, entry_ttl=None):
    m = new_client("memkv://")
    m.init(Format(name=name, trash_days=0), force=True)
    m.load()
    if attr_ttl:
        m.configure_meta_cache(
            attr_ttl=attr_ttl,
            entry_ttl=attr_ttl if entry_ttl is None else entry_ttl)
    return m


def _counter(name, label=None):
    from juicefs_tpu_torch.metric import global_registry

    mt = next(mm for mm in global_registry().walk() if mm.name == name)
    if label is None:
        return mt
    return mt.labels(label)


def _trip(m, fm):
    """Drive the breaker open with injected failures."""
    fm.fault_config(error_rate=1.0)
    for _ in range(8):
        if m.resilience.degraded:
            return
        try:
            m.do_getattr(ROOT_INODE)
        except OSError:
            pass
    assert m.resilience.degraded, "breaker never tripped"


def _heal(m, fm, timeout=5.0):
    fm.fault_config(error_rate=0.0, hang_rate=0.0, throttle_rate=0.0)
    deadline = time.time() + timeout
    while time.time() < deadline:
        if m.resilience.breaker.state == BreakerState.CLOSED:
            # the reset sets CLOSED first and counts it under the same
            # lock hold: taking the lock waits for the rest of it
            with m.resilience.breaker._lock:
                return
        time.sleep(0.02)
    raise AssertionError("breaker never healed")


# ---------------------------------------------------------------------------
# classification + policy units
# ---------------------------------------------------------------------------

def test_classify_meta_classes():
    import sqlite3

    from juicefs_tpu_torch.meta.tkv_client import ConflictError

    assert classify_meta(MetaNetworkError("reset")) is MetaErrorClass.TRANSIENT
    assert classify_meta(InjectedMetaFault("x")) is MetaErrorClass.TRANSIENT
    assert classify_meta(TimeoutError()) is MetaErrorClass.TRANSIENT
    assert classify_meta(InjectedMetaThrottle("x")) is MetaErrorClass.BUSY
    assert classify_meta(
        sqlite3.OperationalError("database is locked")) is MetaErrorClass.BUSY
    assert classify_meta(ConflictError("hot")) is MetaErrorClass.BUSY
    # the engine ANSWERED: these must never be retried or breaker-counted
    assert classify_meta(
        sqlite3.OperationalError("no such table: kv")) \
        is MetaErrorClass.PERMANENT
    assert classify_meta(OSError(errno.ENOENT, "no")) \
        is MetaErrorClass.PERMANENT
    assert classify_meta(ValueError("bad")) is MetaErrorClass.PERMANENT
    # outcome unknowable: retrying could double-apply
    assert classify_meta(MetaCommitUnknownError("mid-commit")) \
        is MetaErrorClass.AMBIGUOUS


def test_retry_policy_busy_floor_above_transient():
    p = MetaRetryPolicy(base=0.005, cap=1.0, busy_base=0.05, busy_cap=2.0)
    rng = lambda: 0.0  # noqa: E731 — deterministic jitter
    assert p.backoff(0, MetaErrorClass.BUSY, rng) \
        > p.backoff(0, MetaErrorClass.TRANSIENT, rng)
    # caps hold at deep attempts
    assert p.backoff(20, MetaErrorClass.TRANSIENT, rng) == 1.0
    assert p.backoff(20, MetaErrorClass.BUSY, rng) == 2.0


def test_default_is_passthrough_byte_identical():
    m = _mk()
    assert not m.resilience.enabled
    assert "do_getattr" not in m.__dict__, \
        "unconfigured build must not wrap engine methods at all"
    m.configure_meta_retries(max_attempts=0)  # explicit off stays inert
    assert not m.resilience.enabled
    assert "do_getattr" not in m.__dict__
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    assert st == 0
    m.close(CTX, ino)


# ---------------------------------------------------------------------------
# retry behavior per class
# ---------------------------------------------------------------------------

def _flaky(m, name, exc, n):
    """Replace engine op `name` with one that raises `exc` n times."""
    orig = getattr(m, name)
    state = {"left": n, "calls": 0}

    def fn(*a, **kw):
        state["calls"] += 1
        if state["left"] > 0:
            state["left"] -= 1
            raise exc
        return orig(*a, **kw)

    setattr(m, name, fn)
    return state


def test_transient_retried_then_succeeds():
    m = _mk()
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    state = _flaky(m, "do_getattr", MetaNetworkError("reset"), 2)
    m.configure_meta_retries(**FAST)
    retries = _counter("juicefs_meta_fault_retries", "transient")
    before = retries.value
    st, attr = m.do_getattr(ino)
    assert st == 0 and attr.mode & 0o777 == 0o644
    assert state["calls"] == 3
    assert retries.value == before + 2


def test_busy_retried_from_higher_floor():
    m = _mk()
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    state = _flaky(m, "do_getattr", InjectedMetaThrottle("busy"), 1)
    m.configure_meta_retries(**FAST)
    busy = _counter("juicefs_meta_fault_retries", "busy")
    before = busy.value
    assert m.do_getattr(ino)[0] == 0
    assert state["calls"] == 2
    assert busy.value == before + 1
    # BUSY is breaker-neutral: the engine answered
    assert m.resilience.breaker.state == BreakerState.CLOSED


def test_permanent_never_retried_breaker_neutral():
    m = _mk()
    state = _flaky(m, "do_getattr", OSError(errno.ESTALE, "gone"), 99)
    m.configure_meta_retries(**FAST)
    retries = _counter("juicefs_meta_fault_retries")
    before = sum(c.value for c in retries._children.values())
    with pytest.raises(OSError) as ei:
        m.do_getattr(42)
    assert ei.value.errno == errno.ESTALE, \
        "a posix errno must pass through untouched"
    assert state["calls"] == 1, "PERMANENT must not be retried"
    assert sum(c.value for c in retries._children.values()) == before
    assert m.resilience.breaker.state == BreakerState.CLOSED


def test_ambiguous_commit_never_retried():
    m = _mk()
    state = _flaky(m, "do_setattr", MetaCommitUnknownError("mid-commit"), 99)
    m.configure_meta_retries(**FAST)
    with pytest.raises(MetaCommitUnknownError):
        m.do_setattr(CTX, 1, 0, None)
    assert state["calls"] == 1, \
        "an unknowable commit outcome must surface, never blind-retry"


def test_deadline_bounds_the_whole_op():
    m = _mk()
    _flaky(m, "do_getattr", MetaNetworkError("down"), 10**6)
    m.configure_meta_retries(max_attempts=100, deadline=0.3,
                             min_samples=1000)
    t0 = time.monotonic()
    with pytest.raises(OSError):
        m.do_getattr(1)
    assert time.monotonic() - t0 < 2.0, "retries must respect the deadline"


def test_hung_read_abandoned_at_attempt_timeout():
    m = _mk()
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    fm = FaultyMeta(m, hang_rate=1.0, hang_seconds=60.0)
    m.configure_meta_retries(max_attempts=2, deadline=1.0,
                             attempt_timeout=0.1, min_samples=1000)
    abandoned = _counter("juicefs_meta_fault_abandoned")
    before = abandoned.value
    t0 = time.monotonic()
    with pytest.raises(OSError):
        m.do_getattr(ino)
    assert time.monotonic() - t0 < 3.0, \
        "a hung engine call must not pin the caller past its budget"
    assert abandoned.value > before
    fm.fault_config(hang_rate=0.0)  # release the parked hangers
    m.resilience.close()


# ---------------------------------------------------------------------------
# breaker + degraded mode
# ---------------------------------------------------------------------------

def test_breaker_trips_probe_heals_counters():
    m = _mk(attr_ttl=5.0)
    fm = FaultyMeta(m)
    m.configure_meta_retries(**FAST)
    trips = _counter("juicefs_meta_breaker_trips", "memkv")
    resets = _counter("juicefs_meta_breaker_resets", "memkv")
    t_before, r_before = trips.value, resets.value
    _trip(m, fm)
    assert trips.value == t_before + 1
    snap = m.resilience.breaker.snapshot()
    assert snap["state"] == "open"
    _heal(m, fm)
    assert resets.value == r_before + 1
    snap = m.resilience.breaker.snapshot()
    assert snap["state"] == "closed"
    assert snap["probe_age_seconds"] is not None
    m.resilience.close()


def test_degraded_reads_serve_stale_leases_zero_round_trips():
    m = _mk(attr_ttl=0.25)
    st, ino, _ = m.create(CTX, ROOT_INODE, b"shard-0", 0o644)
    m.close(CTX, ino)
    # count REAL engine dials, below the fault injector
    counts = {"n": 0}
    for name in ("do_getattr", "do_lookup"):
        orig = getattr(m, name)

        def wrap(*a, _o=orig, **kw):
            counts["n"] += 1
            return _o(*a, **kw)

        setattr(m, name, wrap)
    fm = FaultyMeta(m)
    m.configure_meta_retries(degraded_max_stale=30.0, **FAST)
    assert m.lookup(CTX, ROOT_INODE, b"shard-0")[0] == 0  # warm the lease
    _trip(m, fm)
    time.sleep(0.3)  # the lease EXPIRES mid-outage
    stale = _counter("juicefs_meta_stale_served")
    before = stale.value
    counts["n"] = 0
    for _ in range(10):
        st, attr = m.getattr(CTX, ino)
        assert st == 0 and attr.mode & 0o777 == 0o644
        st, i2, _ = m.lookup(CTX, ROOT_INODE, b"shard-0")
        assert st == 0 and i2 == ino
    assert counts["n"] == 0, \
        "degraded stale-lease reads must make ZERO engine round trips"
    assert stale.value > before
    assert m.lease.n_stale_served > 0
    # a name with NO lease cannot be served: fail fast EIO, never hang
    t0 = time.monotonic()
    st, _, _ = m.lookup(CTX, ROOT_INODE, b"never-seen")
    assert st == errno.EIO
    assert time.monotonic() - t0 < 0.5
    _heal(m, fm)
    m.resilience.close()


def test_degraded_stale_bounded_by_ceiling():
    m = _mk(attr_ttl=0.15)
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    fm = FaultyMeta(m)
    m.configure_meta_retries(degraded_max_stale=0.2, **FAST)
    assert m.lookup(CTX, ROOT_INODE, b"f")[0] == 0
    _trip(m, fm)
    time.sleep(0.15 + 0.2 + 0.1)  # past lease TTL + the stale ceiling
    st, _ = m.getattr(CTX, ino)
    assert st == errno.EIO, \
        "an entry past the stale ceiling must NOT serve (bounded lie)"
    _heal(m, fm)
    m.resilience.close()


def test_degraded_without_stale_config_fails_eio():
    m = _mk(attr_ttl=0.1)
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    fm = FaultyMeta(m)
    m.configure_meta_retries(**FAST)  # degraded_max_stale defaults to 0
    assert m.getattr(CTX, ino)[0] == 0
    _trip(m, fm)
    time.sleep(0.15)
    assert m.getattr(CTX, ino)[0] == errno.EIO, \
        "--meta-degraded-max-stale 0 must never serve an expired lease"
    _heal(m, fm)
    m.resilience.close()


def test_degraded_writes_fail_fast_eio():
    m = _mk(attr_ttl=5.0)
    fm = FaultyMeta(m)
    m.configure_meta_retries(**FAST)
    _trip(m, fm)
    t0 = time.monotonic()
    with pytest.raises(OSError) as ei:
        m.create(CTX, ROOT_INODE, b"nope", 0o644)
    assert ei.value.errno == errno.EIO
    assert time.monotonic() - t0 < 0.5, "breaker-open writes fail FAST"
    _heal(m, fm)
    m.resilience.close()


# ---------------------------------------------------------------------------
# wbatch composition: absorb -> loud barriers -> heal replay
# ---------------------------------------------------------------------------

def test_wbatch_absorbs_barrier_eio_heal_replays():
    m = _mk(attr_ttl=30.0)
    m.configure_write_batch(flush_ms=2.0)
    st, dino, _ = m.mkdir(CTX, ROOT_INODE, b"ckpt", 0o755)
    assert st == 0
    # pre-outage durable shard (and: warms the inode prealloc range)
    st, f1, _ = m.create(CTX, dino, b"shard-pre", 0o644)
    sid = m.new_slice()
    assert m.write_chunk(f1, 0, 0,
                         Slice(pos=0, id=sid, size=4096, off=0, len=4096)) == 0
    assert m.sync_meta(f1) == 0  # acked fsync: durably committed
    # re-warm the parent attr lease (each ack's write-through drops it);
    # mid-storm the wbatch parent memo keeps it warm across the outage
    assert m.getattr(CTX, dino)[0] == 0
    fm = FaultyMeta(m)
    m.configure_meta_retries(degraded_max_stale=30.0, **FAST)
    _trip(m, fm)

    # acked-but-barriered writes FAIL LOUDLY: sticky EIO at the barrier
    st, f2, _ = m.create(CTX, dino, b"shard-lost", 0o644)
    assert st == 0, "wbatch must keep acking while absorbing"
    sid2 = m.new_slice()
    assert m.write_chunk(f2, 0, 0,
                         Slice(pos=0, id=sid2, size=4096, off=0,
                               len=4096)) == 0
    t0 = time.monotonic()
    assert m.sync_meta(f2) == errno.EIO, \
        "an fsync during the outage must surface EIO, never ack silently"
    assert time.monotonic() - t0 < 1.0
    assert m.close(CTX, f2) == errno.EIO  # sticky until the last close

    # writes acked AFTER the failed barrier stay queued (timer/kick are
    # suppressed while degraded) and replay byte-identically on heal
    st, f3, attr3 = m.create(CTX, dino, b"shard-replay", 0o644)
    assert st == 0
    sid3 = m.new_slice()
    assert m.write_chunk(f3, 0, 0,
                         Slice(pos=0, id=sid3, size=8192, off=0,
                               len=8192)) == 0
    assert m.wbatch.has_pending()

    _heal(m, fm)
    deadline = time.time() + 5.0
    while m.wbatch.has_pending() and time.time() < deadline:
        time.sleep(0.02)
    assert not m.wbatch.has_pending(), "heal must replay the absorbed queue"

    # engine truth, read via the RAW ops (below fault/guard):
    raw_lookup = m.resilience.raw("do_lookup")
    st, got, _ = raw_lookup(dino, b"shard-replay")
    assert st == 0 and got == f3, "replayed create must commit its acked ino"
    st, slices = m.resilience.raw("do_read_chunk")(f3, 0)
    assert st == 0 and [s.id for s in slices if s.id] == [sid3], \
        "replayed slice commit must be byte-identical to the ack"
    st, _, _ = raw_lookup(dino, b"shard-lost")
    assert st == errno.ENOENT, \
        "a write that failed loudly at its barrier must not half-commit"
    st, got, _ = raw_lookup(dino, b"shard-pre")
    assert st == 0 and got == f1, "acked-fsync data survives the outage"
    assert m.sync_meta(f3) == 0
    m.resilience.close()
    m.wbatch.close()


def test_rename_during_outage_returns_eio_cleanly():
    m = _mk(attr_ttl=30.0)
    m.configure_write_batch(flush_ms=2.0)
    st, dino, _ = m.mkdir(CTX, ROOT_INODE, b"d", 0o755)
    st, ino, _ = m.create(CTX, dino, b"tmp", 0o644)
    assert m.sync_meta(ino) == 0
    fm = FaultyMeta(m)
    m.configure_meta_retries(degraded_max_stale=30.0, **FAST)
    _trip(m, fm)
    st, _, _ = m.rename(CTX, dino, b"tmp", dino, b"final")
    assert st == errno.EIO, "a degraded rename must fail EIO, not crash"
    _heal(m, fm)
    st, _, _ = m.rename(CTX, dino, b"tmp", dino, b"final")
    assert st == 0
    m.resilience.close()
    m.wbatch.close()


# ---------------------------------------------------------------------------
# FaultyMeta mechanics
# ---------------------------------------------------------------------------

def test_fault_schedule_phases_and_uninstall():
    m = _mk()
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    fm = FaultyMeta(m)
    fm.fault_schedule([(0.2, dict(error_rate=1.0)),
                       (None, dict(error_rate=0.0))])
    with pytest.raises(InjectedMetaFault):
        m.do_getattr(ino)
    errs = fm.counters["errors"]
    assert errs >= 1
    time.sleep(0.25)
    assert m.do_getattr(ino)[0] == 0, "the heal phase must apply"
    fm.uninstall()
    fm.fault_config(error_rate=1.0)
    assert m.do_getattr(ino)[0] == 0, \
        "uninstall must restore the raw engine methods"


def test_fault_config_keep_semantics():
    m = _mk()
    fm = FaultyMeta(m, error_rate=0.5, latency=0.01, throttle_rate=0.2)
    fm.fault_config(error_rate=0.0)  # partial: others must KEEP
    assert fm.latency == 0.01 and fm.throttle_rate == 0.2


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

def test_status_meta_plane_section():
    from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig
    from juicefs_tpu_torch.object import create_storage
    from juicefs_tpu_torch.vfs import VFS

    m = _mk(attr_ttl=1.0)
    fm = FaultyMeta(m)
    m.configure_meta_retries(degraded_max_stale=5.0, **FAST)
    store = CachedStore(create_storage("mem://"),
                        ChunkConfig(block_size=1 << 20))
    v = VFS(m, store)
    try:
        _trip(m, fm)
        payload = v.internal._status_payload()
        mp = payload["meta_plane"]
        assert mp["enabled"] and mp["degraded"]
        assert mp["breaker"]["state"] == "open"
        assert mp["degraded_max_stale"] == 5.0
        assert "stale_served" in mp
        assert mp["replica"]["role"] == "primary"  # no replica configured
        assert "session" in mp and "lease" in mp
        _heal(m, fm)
        mp = v.internal._status_payload()["meta_plane"]
        assert not mp["degraded"]
        snap = meta_resilience_snapshot()
        assert "breaker_trips" in snap
    finally:
        v.close()
        store.close()
        m.resilience.close()
        m.close_session()


def test_status_meta_plane_disabled_is_minimal():
    from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig
    from juicefs_tpu_torch.object import create_storage
    from juicefs_tpu_torch.vfs import VFS

    m = _mk()
    store = CachedStore(create_storage("mem://"),
                        ChunkConfig(block_size=1 << 20))
    v = VFS(m, store)
    try:
        payload = v.internal._status_payload()
        assert payload["meta_plane"] == {"enabled": False}
    finally:
        v.close()
        store.close()
        m.close_session()


def test_breaker_unit_half_open_retrip():
    b = MetaBreaker(engine="unit", min_samples=2, threshold=0.5,
                    probe_interval=999.0)  # no probe thread interference
    b.probe = None
    b.record_failure()
    b.record_failure()
    assert b.state == BreakerState.OPEN
    # hand-drive half-open (what a probe success does)
    with b._lock:
        b._state = BreakerState.HALF_OPEN
    b.record_failure()
    assert b.state == BreakerState.OPEN, "a half-open failure must re-trip"
    b.close()


# ---------------------------------------------------------------------------
# redis blackout drill: kill the primary, fail over, heal, replay
# ---------------------------------------------------------------------------

def test_blackout_primary_kill_failover_and_heal(tmp_path):
    """The reference drill, waiting on state instead of time. The
    reference asserts the heal chain's effects (failover mode off, floor
    re-primed, session alive) the moment it sees the breaker CLOSED, but
    the chain runs on its own thread after the reset: under load it has
    not run yet and `primary_down` is still True. It also gives the
    replica a fixed 5 s to catch up without checking that it did."""
    from juicefs_tpu_torch.meta.cache import _REPLICA_READS
    from juicefs_tpu_torch.meta.redis_kv import RedisKV
    from juicefs_tpu_torch.meta.redis_server import RedisServer

    aof = str(tmp_path / "primary.aof")
    pri = RedisServer(data_path=aof)
    pport = pri.start()
    rep = RedisServer(replica_of=f"127.0.0.1:{pport}")
    rport = rep.start()
    url = f"redis://127.0.0.1:{pport}/0"
    m = None
    try:
        c0 = new_client(url)
        c0.init(Format(name="blackout", trash_days=0), force=True)
        c0.load()
        c0.client.close()

        m = new_client(url)
        m.load()
        m.configure_meta_cache(attr_ttl=0.3, entry_ttl=0.3)
        m.client.configure_replica(f"127.0.0.1:{rport}")
        m.configure_meta_retries(max_attempts=2, deadline=1.0,
                                 degraded_max_stale=60.0, min_samples=4,
                                 window=10.0, threshold=0.5,
                                 probe_interval=0.1)
        m.new_session()
        # the breaker's reset starts the heal chain on a thread of its own,
        # after CLOSED is already visible: signal when the chain has run
        healed = threading.Event()
        chain = m._on_meta_heal

        def heal_and_signal():
            try:
                chain()
            finally:
                healed.set()

        m._on_meta_heal = heal_and_signal

        st, warm_ino, _ = m.create(CTX, ROOT_INODE, b"warm", 0o644)
        assert st == 0
        m.close(CTX, warm_ino)
        st, cold_ino, _ = m.create(CTX, ROOT_INODE, b"cold", 0o640)
        assert st == 0
        m.close(CTX, cold_ino)
        assert m.lookup(CTX, ROOT_INODE, b"warm")[0] == 0  # lease warmed
        warmed_at = time.monotonic()
        floor_before = m.client._epoch_floor
        assert floor_before > 0

        # the replica must have caught up before the kill
        probe = RedisKV(f"127.0.0.1:{rport}/0")
        try:
            def caught_up():
                raw = probe.execute(b"GET", RedisKV.EPOCH_KEY)
                return bool(raw) and int(raw) >= floor_before

            _wait_for(caught_up, 30.0, "the replica to reach the floor")
        finally:
            probe.close()

        # ---- BLACKOUT ----
        pri.stop()

        def tripped():
            try:
                m.do_counter("faultprobe", 1)  # primary-bound write txn
            except Exception:
                pass
            return m.resilience.degraded

        _wait_for(tripped, 30.0, "the primary kill to trip the breaker")
        assert m.client.primary_down is True

        # expired-lease reads keep serving with zero engine round trips
        time.sleep(max(0.0, warmed_at + 0.35 - time.monotonic()))
        engine_calls = {"n": 0}
        raw_lookup = m.resilience.raw("do_lookup")

        def counting(parent, name, hint_ino=0, _o=raw_lookup):
            engine_calls["n"] += 1
            return _o(parent, name, hint_ino=hint_ino)

        m.resilience._raw["do_lookup"] = counting  # below the guard
        st, i2, _ = m.lookup(CTX, ROOT_INODE, b"warm")
        assert st == 0 and i2 == warm_ino
        m.resilience._raw["do_lookup"] = raw_lookup
        assert m.lease.n_stale_served > 0
        assert engine_calls["n"] == 0

        # replica FAILOVER: a guarded point read the lease cannot serve
        before_rr = _REPLICA_READS.value
        st, attr = m.do_getattr(cold_ino)
        assert st == 0 and attr.mode & 0o777 == 0o640, \
            "breaker-open guarded reads must fail over to the replica"
        assert _REPLICA_READS.value > before_rr

        # writes fail fast and loudly
        with pytest.raises(OSError):
            m.create(CTX, ROOT_INODE, b"during-outage", 0o644)

        # ---- HEAL: restart the primary on the same port + AOF ----
        pri2 = RedisServer(port=pport, data_path=aof)
        pri2.start()
        try:
            _wait_for(lambda: m.resilience.breaker.state
                      == BreakerState.CLOSED, 30.0,
                      "probe-driven recovery to close the breaker")
            assert healed.wait(30.0), "the heal chain never ran"
            assert m.client.primary_down is False
            assert m.client._epoch_floor >= floor_before, \
                "heal must re-prime the replica epoch floor"
            # the session survived (or was revived) across the blackout
            assert m.do_session_exists(m.sid)
            # and the plane serves writes again
            st, ino3, _ = m.create(CTX, ROOT_INODE, b"after-heal", 0o644)
            assert st == 0
            m.close(CTX, ino3)
            assert m.lookup(CTX, ROOT_INODE, b"after-heal")[0] == 0
        finally:
            pri2.stop()
    finally:
        if m is not None:
            m.resilience.close()
            try:
                m.client.close()
            except Exception:
                pass
        rep.stop()
        try:
            pri.stop()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# mutation-survivor drills (§6j): exact boundaries of the contract
# ---------------------------------------------------------------------------

def test_backoff_jitter_only_ever_lengthens():
    p = MetaRetryPolicy(base=0.01, jitter=0.2)
    base = p.backoff(0, MetaErrorClass.TRANSIENT, lambda: 0.0)
    assert p.backoff(0, MetaErrorClass.TRANSIENT, lambda: 1.0) \
        == pytest.approx(base * 1.2), \
        "full jitter must ADD 20%, never shorten the backoff"


def test_breaker_exact_half_open_close_streak():
    b = MetaBreaker(engine="streak", min_samples=2, threshold=0.5,
                    half_open_successes=2)
    b.probe = None
    b.record_failure()
    b.record_failure()
    assert b.state == BreakerState.OPEN
    with b._lock:
        b._state = BreakerState.HALF_OPEN
        import juicefs_tpu_torch.meta.resilient as _r

        _r._BREAKER_STATE.labels("streak").set(2)
    b.record_success()
    assert b.state == BreakerState.HALF_OPEN, \
        "one half-open success must NOT close (default streak is 2)"
    b.record_success()
    assert b.state == BreakerState.CLOSED, \
        "exactly two half-open successes must close"
    b.close()


def test_breaker_state_gauge_values():
    from juicefs_tpu_torch.metric import global_registry

    gauge = next(m for m in global_registry().walk()
                 if m.name == "juicefs_meta_breaker_state")
    b = MetaBreaker(engine="gaugeunit", min_samples=1, threshold=0.5)
    b.probe = None
    assert gauge.labels("gaugeunit").value == 0
    b.record_failure()
    assert gauge.labels("gaugeunit").value == 1
    with b._lock:
        b._state = BreakerState.HALF_OPEN
    gauge.labels("gaugeunit").set(2)
    assert gauge.labels("gaugeunit").value == 2, \
        "half-open is gauge value 2 (dashboards pin the encoding)"
    b.close()


def test_probeless_breaker_spawns_no_probe_thread():
    b = MetaBreaker(engine="noprobe", min_samples=1, threshold=0.5,
                    probe_interval=0.01)
    b.probe = None
    b.record_failure()  # trips
    assert b.state == BreakerState.OPEN
    time.sleep(0.05)
    assert not b._probe_alive, \
        "a probe-less breaker must not spin a probe thread"
    b.close()


def test_closed_breaker_probe_does_not_respawn():
    b = MetaBreaker(engine="respawn", min_samples=1, threshold=0.5,
                    probe_interval=0.01, probe=lambda: False)
    b.record_failure()  # trips, spawns the prober
    assert b.state == BreakerState.OPEN
    b.close()  # owner shut us down
    deadline = time.time() + 2.0
    while b._probe_alive and time.time() < deadline:
        time.sleep(0.01)
    assert not b._probe_alive, "close() must stop the prober"
    time.sleep(0.05)
    assert not b._probe_alive, \
        "a closed-down breaker must never respawn its prober"


def test_probe_age_is_a_recent_age():
    m = _mk(attr_ttl=5.0)
    fm = FaultyMeta(m)
    m.configure_meta_retries(**FAST)
    _trip(m, fm)
    _heal(m, fm)
    age = m.resilience.breaker.snapshot()["probe_age_seconds"]
    assert age is not None and 0.0 <= age < 60.0, \
        f"probe age must be seconds-since-last-probe, got {age}"
    m.resilience.close()


def test_half_open_recovery_driven_by_mutating_traffic_not_reads():
    """While not CLOSED, read successes may be replica-served and must
    not drive recovery; mutating successes are primary evidence and
    must.  (The _record policy — drop `not mutating` and the recovery
    logic inverts.)"""
    m = _mk()
    m.configure_meta_retries(**FAST)
    res = m.resilience
    b = res.breaker
    b.probe = None
    with b._lock:
        b._state = BreakerState.HALF_OPEN
    # two READ successes: no state change
    assert m.do_getattr(ROOT_INODE)[0] == 0
    assert m.do_getattr(ROOT_INODE)[0] == 0
    assert b.state == BreakerState.HALF_OPEN, \
        "read successes must not close a half-open breaker"
    # two MUTATING successes: closes
    m.do_counter("healprobe", 1)
    m.do_counter("healprobe", 1)
    assert b.state == BreakerState.CLOSED, \
        "mutating successes are primary evidence and must close it"
    res.close()


def test_fault_schedule_all_finite_phases_end_clean():
    """A timeline with NO forever phase must pin to its LAST phase after
    the durations run out (len-1 indexing), not walk off the end."""
    m = _mk()
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    fm = FaultyMeta(m)
    fm.fault_schedule([(0.05, dict(error_rate=1.0))])
    time.sleep(0.1)
    with pytest.raises(InjectedMetaFault):
        m.do_getattr(ino)  # last (only) phase holds past its duration


def test_fault_schedule_phase_applies_exactly_once():
    """A settled phase must not re-apply per op: re-running fault_config
    re-arms the hang release event, silently un-parking drill hangers."""
    m = _mk()
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    fm = FaultyMeta(m)
    fm.fault_schedule([(None, dict(error_rate=0.0, hang_rate=0.0))])
    ev = fm._hang_release
    for _ in range(5):
        assert m.do_getattr(ino)[0] == 0
    assert fm._hang_release is ev, \
        "ticking a settled phase must not re-run fault_config"


def test_zero_latency_profile_is_silent():
    m = _mk()
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    fm = FaultyMeta(m)  # all rates/latency zero
    for _ in range(4):
        assert m.do_getattr(ino)[0] == 0
    assert fm.counters == {"errors": 0, "delayed": 0, "throttles": 0,
                           "hangs": 0}


def test_fault_rolls_are_seed_deterministic_and_rng_frugal():
    """The seeded failure pattern is golden: a zero rate must not even
    BURN an rng draw (extra draws shift every later roll, breaking
    drill reproducibility)."""
    import random as _random

    m = _mk()
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    fm = FaultyMeta(m, seed=11)  # all rates zero: no draws may happen
    for _ in range(5):
        assert m.do_getattr(ino)[0] == 0
    fm.fault_config(error_rate=0.5)
    got = []
    for _ in range(20):
        try:
            m.do_getattr(ino)
            got.append(False)
        except InjectedMetaFault:
            got.append(True)
    rng = _random.Random(11)
    want = [rng.random() < 0.5 for _ in range(20)]
    assert got == want, \
        "seeded fault pattern diverged (a zero-rate check burned a draw)"


def test_statfs_serves_last_known_while_degraded():
    """statfs is the watchdog's liveness probe: a blackout must serve
    the last-known answer, or a 120s outage would make the mount
    watchdog shoot a mount that is successfully serving stale reads."""
    m = _mk(attr_ttl=5.0)
    fm = FaultyMeta(m)
    m.configure_meta_retries(**FAST)
    want = m.statfs(CTX)
    _trip(m, fm)
    assert m.statfs(CTX) == want, \
        "degraded statfs must serve the last-known snapshot"
    _heal(m, fm)
    assert m.statfs(CTX) == want
    m.resilience.close()


def test_degraded_barrier_is_scoped_to_its_inodes():
    """Writer B's fsync during the outage must NOT incinerate writer
    A's absorbed mutations: only the barrier's implicated inodes fail
    sticky-EIO; the rest stay queued and replay on heal."""
    m = _mk(attr_ttl=30.0)
    m.configure_write_batch(flush_ms=50.0)
    st, dino, _ = m.mkdir(CTX, ROOT_INODE, b"d", 0o755)
    st, warm, _ = m.create(CTX, dino, b"warm", 0o644)
    m.new_slice()
    assert m.sync_meta(warm) == 0
    assert m.getattr(CTX, dino)[0] == 0
    fm = FaultyMeta(m)
    m.configure_meta_retries(degraded_max_stale=30.0, **FAST)
    _trip(m, fm)
    st, fa, _ = m.create(CTX, dino, b"writer-a", 0o644)  # A: absorb only
    assert st == 0
    st, fb, _ = m.create(CTX, dino, b"writer-b", 0o644)  # B: will fsync
    assert st == 0
    assert m.sync_meta(fb) == errno.EIO, "B's own fsync fails loudly"
    assert m.wbatch.has_pending(), \
        "A's absorbed create must survive B's scoped barrier"
    _heal(m, fm)
    deadline = time.time() + 5.0
    while m.wbatch.has_pending() and time.time() < deadline:
        time.sleep(0.02)
    raw_lookup = m.resilience.raw("do_lookup")
    st, got, _ = raw_lookup(dino, b"writer-a")
    assert st == 0 and got == fa, "A's mutation must replay on heal"
    st, _, _ = raw_lookup(dino, b"writer-b")
    assert st == errno.ENOENT, "B's barrier-failed create stays failed"
    m.resilience.close()
    m.wbatch.close()


def test_half_open_probe_failure_retrips():
    """HALF_OPEN --(any failure)--> OPEN must hold for PROBE failures:
    a read-only mount has no mutating traffic to re-trip through, and a
    flapping primary would otherwise park the breaker half-open with
    degraded serving disabled."""
    flaps = {"n": 0}

    def flappy_probe():
        flaps["n"] += 1
        return flaps["n"] == 1  # first probe "heals", rest fail

    b = MetaBreaker(engine="flap", min_samples=2, threshold=0.5,
                    probe_interval=0.02, probe=flappy_probe,
                    half_open_successes=5)
    b.record_failure()
    b.record_failure()
    assert b.state == BreakerState.OPEN
    deadline = time.time() + 3.0
    seen_half = retripped = False
    while time.time() < deadline:
        s = b.state
        seen_half = seen_half or s == BreakerState.HALF_OPEN
        if seen_half and s == BreakerState.OPEN:
            retripped = True
            break
        time.sleep(0.005)
    b.close()
    assert retripped, "a failed probe in HALF_OPEN must re-trip to OPEN"


def test_degraded_open_does_not_relaunder_stale_attr():
    """A stale-served open must not prime the openfile cache: the stale
    attr would then serve as FRESH (uncounted, past the ceiling) for
    the openfile expire window."""
    m = _mk(attr_ttl=0.2)
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    fm = FaultyMeta(m)
    m.configure_meta_retries(degraded_max_stale=0.6, **FAST)
    assert m.getattr(CTX, ino)[0] == 0  # warm the lease
    _trip(m, fm)
    time.sleep(0.25)  # lease expired, inside the 0.6s ceiling
    st, attr = m.open(CTX, ino, os.O_RDONLY)
    assert st == 0, "degraded open must serve the bounded stale attr"
    assert m.of.attr(ino) is None, \
        "the stale attr must NOT be cached as trusted in OpenFiles"
    time.sleep(0.6)  # now PAST expires + ceiling
    st, _ = m.getattr(CTX, ino)
    assert st == errno.EIO, \
        "past the ceiling nothing may keep serving the stale attr"
    m.close(CTX, ino)
    _heal(m, fm)
    m.resilience.close()


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _rolls(pkg: str, seed: int, profiles) -> tuple:
    """Drive one package's FaultyMeta through `profiles` (a list of
    (fault_config kwargs, n ops)) and record every op's outcome."""
    import importlib

    meta_pkg = importlib.import_module(f"{pkg}.meta")
    fault_mod = importlib.import_module(f"{pkg}.meta.fault")
    ctx = importlib.import_module(f"{pkg}.meta.context").Context(uid=0, gid=0)
    _ROOT = meta_pkg.ROOT_INODE
    m = meta_pkg.new_client("memkv://")
    m.init(meta_pkg.Format(name="rolls", trash_days=0), force=True)
    m.load()
    st, ino, _ = m.create(ctx, _ROOT, b"f", 0o644)
    m.close(ctx, ino)
    fm = fault_mod.FaultyMeta(m, seed=seed)
    out = []
    for cfg, n in profiles:
        fm.fault_config(**cfg)
        for i in range(n):
            op = (m.do_getattr, (ino,)) if i % 3 else (m.do_lookup, (_ROOT, b"f"))
            try:
                op[0](*op[1])
                out.append("ok")
            except fault_mod.InjectedMetaThrottle:
                out.append("busy")
            except fault_mod.InjectedMetaFault:
                out.append("fault")
    return out, dict(fm.counters)


@pytest.mark.parametrize("seed", [0, 11, 2024])
def test_fault_rolls_match_the_reference(seed):
    """Same seed, same profile sequence: the port's FaultyMeta fails the
    same ops, with the same kind of fault, as the reference's."""
    profiles = [
        (dict(), 5),                                   # zero rates: no draws
        (dict(error_rate=0.5), 30),
        (dict(error_rate=0.0, throttle_rate=0.3), 30),
        (dict(throttle_rate=0.2, error_rate=0.4), 40),
        (dict(throttle_rate=0.0, read_error_rate=0.7, error_rate=0.1), 30),
    ]
    want = _rolls("juicefs_tpu", seed, profiles)
    got = _rolls("juicefs_tpu_torch", seed, profiles)
    assert got == want
    assert "fault" in got[0] and "busy" in got[0] and "ok" in got[0]


def test_injected_faults_are_classified_by_the_port():
    """The port's resilience layer classifies the port's injected faults
    as the reference classifies its own, and the classes are the port's
    (an exception of the other package is just an unknown error)."""
    from juicefs_tpu.meta import fault as ref_fault
    from juicefs_tpu.meta import resilient as ref_resilient

    for exc in (InjectedMetaFault("x"), InjectedMetaThrottle("x")):
        ref_exc = getattr(ref_fault, type(exc).__name__)("x")
        assert classify_meta(exc).name == \
            ref_resilient.classify_meta(ref_exc).name
    assert classify_meta(InjectedMetaFault("x")) is MetaErrorClass.TRANSIENT
    assert classify_meta(InjectedMetaThrottle("x")) is MetaErrorClass.BUSY
    assert InjectedMetaThrottle.__module__ == "juicefs_tpu_torch.meta.fault"
