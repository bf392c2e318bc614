"""Twin of tests/test_meta_cache.py on the port: the meta-plane lease
cache and replica routing drills, then the port's LeaseCache held against
the reference's on one seeded op sequence.

The coherence contract under test:
  * local mutations write through — read-your-own-writes holds with any
    TTL, byte-identically to the uncached engine;
  * remote mutations are visible within ONE lease TTL (and within ~a
    heartbeat when the change feed is exchanging);
  * TTL 0 is true passthrough (every read hits the engine);
  * replica reads are refused when the replica's change-epoch lags the
    client's floor (fall back to the primary, never serve a lagging
    replica past the bound).
"""

import errno
import time

import pytest

from juicefs_tpu_torch.meta import Format, ROOT_INODE, new_client
from juicefs_tpu_torch.meta.cache import LeaseCache, MetaOpLimiter
from juicefs_tpu_torch.meta.context import Context
from torch_txnwatch import port_txnwatch, port_txnwatch_guard  # noqa: F401

CTX = Context(uid=0, gid=0)


@pytest.fixture
def server():
    from juicefs_tpu_torch.meta.redis_server import RedisServer

    srv = RedisServer()
    port = srv.start()
    yield f"redis://127.0.0.1:{port}/0"
    srv.stop()


@pytest.fixture
def vol(server):
    c = new_client(server)
    c.init(Format(name="leasevol", trash_days=0), force=True)
    yield server


def _client(url, attr_ttl=0.0, entry_ttl=0.0, **kw):
    m = new_client(url)
    m.load()
    m.configure_meta_cache(attr_ttl=attr_ttl, entry_ttl=entry_ttl, **kw)
    return m


def _count_engine(m) -> dict:
    """Count engine round trips under the cache layer."""
    counts = {"getattr": 0, "lookup": 0}
    orig_ga, orig_lk = m.do_getattr, m.do_lookup

    def ga(ino):
        counts["getattr"] += 1
        return orig_ga(ino)

    def lk(parent, name, hint_ino=0):
        counts["lookup"] += 1
        return orig_lk(parent, name, hint_ino=hint_ino)

    m.do_getattr, m.do_lookup = ga, lk
    return counts


# ---------------------------------------------------------------------------
# hot path + passthrough
# ---------------------------------------------------------------------------

def test_hot_path_zero_engine_round_trips():
    m = new_client("memkv://")
    m.init(Format(name="hot", trash_days=0), force=True)
    m.load()
    m.configure_meta_cache(attr_ttl=5.0, entry_ttl=5.0)
    st, ino, _ = m.create(CTX, ROOT_INODE, b"shard-0001", 0o644)
    assert st == 0
    m.close(CTX, ino)
    # warm the leases
    assert m.lookup(CTX, ROOT_INODE, b"shard-0001")[0] == 0
    counts = _count_engine(m)
    for _ in range(50):
        st, i, attr = m.lookup(CTX, ROOT_INODE, b"shard-0001")
        assert st == 0 and i == ino
        st, attr = m.getattr(CTX, ino)
        assert st == 0
    assert counts == {"getattr": 0, "lookup": 0}, (
        "hot cached lookup/getattr must serve with ZERO meta round trips")


def test_ttl0_is_passthrough():
    m = new_client("memkv://")
    m.init(Format(name="pt", trash_days=0), force=True)
    m.load()  # default: lease cache disabled
    assert not m.lease.enabled
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    counts = _count_engine(m)
    n = 7
    for _ in range(n):
        assert m.getattr(CTX, ino)[0] == 0
    # openfile cache is closed (refs dropped): every read hits the engine
    assert counts["getattr"] == n


def test_feedless_engine_forced_to_passthrough():
    m = new_client("memkv://")
    m.init(Format(name="nf", trash_days=0), force=True)
    m.load()
    m.supports_inval_feed = False  # pretend the engine has no feed
    m.configure_meta_cache(attr_ttl=5.0, entry_ttl=5.0)
    assert not m.lease.enabled, \
        "an engine without the change feed must stay in TTL-0 passthrough"


# ---------------------------------------------------------------------------
# local write-through (read-your-own-writes at any TTL)
# ---------------------------------------------------------------------------

def test_local_mutations_write_through():
    from juicefs_tpu_torch.meta.types import Attr, SET_ATTR_MODE

    m = new_client("memkv://")
    m.init(Format(name="wt", trash_days=0), force=True)
    m.load()
    m.configure_meta_cache(attr_ttl=60.0, entry_ttl=60.0)  # only invalidation can win
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o640)
    m.close(CTX, ino)
    assert m.getattr(CTX, ino)[1].mode & 0o777 == 0o640
    st, _ = m.setattr(CTX, ino, SET_ATTR_MODE, Attr(mode=0o600))
    assert st == 0
    assert m.getattr(CTX, ino)[1].mode & 0o777 == 0o600  # no TTL wait

    # rename: old name gone, new name resolves, immediately
    assert m.rename(CTX, ROOT_INODE, b"f", ROOT_INODE, b"g")[0] == 0
    assert m.lookup(CTX, ROOT_INODE, b"f")[0] == errno.ENOENT
    st, i2, _ = m.lookup(CTX, ROOT_INODE, b"g")
    assert st == 0 and i2 == ino

    # unlink: dentry gone immediately
    assert m.unlink(CTX, ROOT_INODE, b"g") == 0
    assert m.lookup(CTX, ROOT_INODE, b"g")[0] == errno.ENOENT


def test_negative_entry_invalidated_on_create():
    m = new_client("memkv://")
    m.init(Format(name="neg", trash_days=0), force=True)
    m.load()
    m.configure_meta_cache(attr_ttl=5.0, entry_ttl=5.0)
    counts = _count_engine(m)
    assert m.lookup(CTX, ROOT_INODE, b"idx.json")[0] == errno.ENOENT
    first = counts["lookup"]
    assert first >= 1
    # the repeated miss (a dataloader probing a sidecar file) is served
    # from the negative entry: no further engine round trips
    for _ in range(20):
        assert m.lookup(CTX, ROOT_INODE, b"idx.json")[0] == errno.ENOENT
    assert counts["lookup"] == first
    # creating the name must invalidate the cached ENOENT synchronously
    st, ino, _ = m.create(CTX, ROOT_INODE, b"idx.json", 0o644)
    assert st == 0
    st, i2, _ = m.lookup(CTX, ROOT_INODE, b"idx.json")
    assert st == 0 and i2 == ino


def test_unlink_hardlink_victim_attr_invalidated():
    m = new_client("memkv://")
    m.init(Format(name="hl", trash_days=0), force=True)
    m.load()
    m.configure_meta_cache(attr_ttl=60.0, entry_ttl=60.0)
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    assert m.link(CTX, ino, ROOT_INODE, b"g")[0] == 0
    assert m.getattr(CTX, ino)[1].nlink == 2  # cached at nlink=2
    assert m.unlink(CTX, ROOT_INODE, b"f") == 0
    # the surviving name must not serve the stale nlink from the lease
    st, attr = m.getattr(CTX, ino)
    assert st == 0 and attr.nlink == 1


def test_rename_replace_victim_invalidated():
    m = new_client("memkv://")
    m.init(Format(name="rr", trash_days=0), force=True)
    m.load()
    m.configure_meta_cache(attr_ttl=60.0, entry_ttl=60.0)
    st, a, _ = m.create(CTX, ROOT_INODE, b"a", 0o644)
    st, b, _ = m.create(CTX, ROOT_INODE, b"b", 0o644)
    m.close(CTX, a)
    m.close(CTX, b)
    # cache b's dentry + attr, then replace it
    assert m.lookup(CTX, ROOT_INODE, b"b")[1] == b
    assert m.rename(CTX, ROOT_INODE, b"a", ROOT_INODE, b"b")[0] == 0
    st, i2, _ = m.lookup(CTX, ROOT_INODE, b"b")
    assert st == 0 and i2 == a, "replaced dentry must resolve to the mover"
    assert m.getattr(CTX, b)[0] == errno.ENOENT, \
        "the replaced victim's attr lease must not outlive the rename"


# ---------------------------------------------------------------------------
# two-client staleness bounds
# ---------------------------------------------------------------------------

TTL = 0.4
SLACK = 0.3


@pytest.mark.parametrize("engine", ["redis", "sql"])
def test_two_client_stale_read_bound(engine, server, tmp_path):
    from juicefs_tpu_torch.meta.types import Attr, SET_ATTR_MODE

    url = server if engine == "redis" else f"sql://{tmp_path}/lease.db"
    c0 = new_client(url)
    c0.init(Format(name="bound", trash_days=0), force=True)
    c1 = _client(url, attr_ttl=TTL, entry_ttl=TTL)
    c2 = _client(url, attr_ttl=TTL, entry_ttl=TTL)
    st, ino, _ = c1.create(CTX, ROOT_INODE, b"f", 0o640)
    c1.close(CTX, ino)

    # B caches through a lookup...
    st, ino_b, attr_b = c2.lookup(CTX, ROOT_INODE, b"f")
    assert st == 0 and attr_b.mode & 0o777 == 0o640

    # ...A chmods. No sessions => no push: B serves the stale lease NOW
    # (that is the documented bound), and MUST converge within one TTL.
    st, _ = c1.setattr(CTX, ino, SET_ATTR_MODE, Attr(mode=0o600))
    assert st == 0
    assert c2.getattr(CTX, ino_b)[1].mode & 0o777 == 0o640, \
        "within the lease the stale attr is the expected serve"
    time.sleep(TTL + SLACK)
    assert c2.getattr(CTX, ino_b)[1].mode & 0o777 == 0o600, \
        "remote mutation must be visible within one lease TTL"

    # entry lease: A renames; B converges within one TTL
    assert c1.rename(CTX, ROOT_INODE, b"f", ROOT_INODE, b"g")[0] == 0
    time.sleep(TTL + SLACK)
    assert c2.lookup(CTX, ROOT_INODE, b"f")[0] == errno.ENOENT
    st, i2, _ = c2.lookup(CTX, ROOT_INODE, b"g")
    assert st == 0 and i2 == ino


def test_remote_create_bounded_by_negative_ttl(vol):
    c1 = _client(vol, attr_ttl=TTL, entry_ttl=TTL)
    c2 = _client(vol, attr_ttl=TTL, entry_ttl=TTL)
    assert c2.lookup(CTX, ROOT_INODE, b"new")[0] == errno.ENOENT  # negative cached
    st, ino, _ = c1.create(CTX, ROOT_INODE, b"new", 0o644)
    assert st == 0
    time.sleep(min(1.0, TTL) + SLACK)  # the negative-lease bound
    st, i2, _ = c2.lookup(CTX, ROOT_INODE, b"new")
    assert st == 0 and i2 == ino


def test_push_invalidation_beats_lease_ttl(vol):
    """With sessions heartbeating, the change feed drops peers' leases
    mid-TTL: convergence in ~a heartbeat against a 30s lease."""
    from juicefs_tpu_torch.meta.types import Attr, SET_ATTR_MODE

    BEAT = 0.15
    c1 = _client(vol, attr_ttl=30.0, entry_ttl=30.0)
    c2 = _client(vol, attr_ttl=30.0, entry_ttl=30.0)
    c1.new_session(heartbeat=BEAT)
    c2.new_session(heartbeat=BEAT)
    try:
        st, ino, _ = c1.create(CTX, ROOT_INODE, b"f", 0o640)
        c1.close(CTX, ino)
        time.sleep(2 * BEAT + 0.1)  # drain the create events
        assert c2.lookup(CTX, ROOT_INODE, b"f")[0] == 0
        assert c2.getattr(CTX, ino)[1].mode & 0o777 == 0o640

        st, _ = c1.setattr(CTX, ino, SET_ATTR_MODE, Attr(mode=0o600))
        assert st == 0
        deadline = time.time() + 10 * BEAT
        mode = 0
        while time.time() < deadline:
            mode = c2.getattr(CTX, ino)[1].mode & 0o777
            if mode == 0o600:
                break
            time.sleep(BEAT / 3)
        assert mode == 0o600, "change feed never dropped the peer's lease"
    finally:
        c1.close_session()
        c2.close_session()


# ---------------------------------------------------------------------------
# replica routing
# ---------------------------------------------------------------------------

def test_replica_serves_point_reads(server):
    from juicefs_tpu_torch.meta.cache import _REPLICA_READS
    from juicefs_tpu_torch.meta.redis_server import RedisServer

    pport = int(server.split(":")[2].split("/")[0])
    rep = RedisServer(replica_of=f"127.0.0.1:{pport}")
    rport = rep.start()
    try:
        c0 = new_client(server)
        c0.init(Format(name="repl", trash_days=0), force=True)
        c0.load()
        st, ino, _ = c0.create(CTX, ROOT_INODE, b"f", 0o644)
        c0.close(CTX, ino)

        # wait for the replica to apply the stream
        from juicefs_tpu_torch.meta.redis_kv import RedisKV

        probe = RedisKV(f"127.0.0.1:{rport}/0")
        deadline = time.time() + 5.0
        while time.time() < deadline:
            if probe.execute(b"GET", b"setting") is not None:
                break
            time.sleep(0.05)
        probe.close()

        m = new_client(server)
        m.client.configure_replica(f"127.0.0.1:{rport}")
        m.load()
        before = _REPLICA_READS.value
        st, attr = m.do_getattr(ino)
        assert st == 0 and attr.mode & 0o777 == 0o644
        st, i2, _ = m.do_lookup(ROOT_INODE, b"f")
        assert st == 0 and i2 == ino
        assert _REPLICA_READS.value > before
        m.client.close()
    finally:
        rep.stop()


def test_replica_lag_guard_falls_back_to_primary(server):
    """A replica whose change-epoch trails the client's floor must be
    refused: reads fall back to the primary and stay correct."""
    from juicefs_tpu_torch.meta.cache import _REPLICA_STALE
    from juicefs_tpu_torch.meta.redis_server import RedisServer

    # a NON-replicating second server stands in for a wedged replica
    lagging = RedisServer()
    lport = lagging.start()
    try:
        c0 = new_client(server)
        c0.init(Format(name="lag", trash_days=0), force=True)
        c0.load()
        st, ino, _ = c0.create(CTX, ROOT_INODE, b"f", 0o644)
        c0.close(CTX, ino)

        m = new_client(server)
        m.load()
        m.client.configure_replica(f"127.0.0.1:{lport}")
        # configure_replica primes the floor from the PRIMARY's current
        # epoch, so even this never-writes client is guarded against the
        # empty "replica" (review finding: a read-only dataloader client
        # would otherwise trust a still-syncing replica and see ENOENT)
        assert m.client._epoch_floor > 0, \
            "configure_replica must prime the epoch floor"
        before = _REPLICA_STALE.value
        st, attr = m.do_getattr(ino)
        assert st == 0 and attr.mode & 0o777 == 0o644, \
            "guarded fallback must serve the primary's truth"
        assert _REPLICA_STALE.value > before
        m.client.close()
    finally:
        lagging.stop()


def test_write_bumps_epoch_and_reads_own_writes(server):
    """Every committed write transaction raises the client's replica
    floor, so a client's OWN create is never read back ENOENT from a
    lagging replica — and once the replica applies that epoch, guarded
    reads route to it again (found live: open(O_CREAT) through a FUSE
    mount transiently ENOENT'd when the replica trailed the create)."""
    from juicefs_tpu_torch.meta.cache import _REPLICA_READS
    from juicefs_tpu_torch.meta.redis_kv import RedisKV
    from juicefs_tpu_torch.meta.redis_server import RedisServer

    pport = int(server.split(":")[2].split("/")[0])
    rep = RedisServer(replica_of=f"127.0.0.1:{pport}")
    rport = rep.start()
    try:
        c0 = new_client(server)
        c0.init(Format(name="catch", trash_days=0), force=True)
        c0.load()

        m = new_client(server)
        m.load()
        m.client.configure_replica(f"127.0.0.1:{rport}")
        # m's OWN write commits on the primary and must raise its floor
        st, ino, _ = m.create(CTX, ROOT_INODE, b"mine", 0o644)
        assert st == 0
        m.close(CTX, ino)
        floor = m.client._epoch_floor
        assert floor > 0, "a committed write txn must raise the epoch floor"
        # read-your-own-writes holds immediately, replica lag or not
        for _ in range(10):
            st, attr = m.do_getattr(ino)
            assert st == 0, "own create read back ENOENT (replica lag leak)"

        # once the replica has applied >= floor, guarded reads use it
        probe = RedisKV(f"127.0.0.1:{rport}/0")
        deadline = time.time() + 5.0
        while time.time() < deadline:
            raw = probe.execute(b"GET", RedisKV.EPOCH_KEY)
            if raw and int(raw) >= floor:
                break
            time.sleep(0.05)
        probe.close()
        before = _REPLICA_READS.value
        st, attr = m.do_getattr(ino)
        assert st == 0 and attr.mode & 0o777 == 0o644
        assert _REPLICA_READS.value > before, \
            "a caught-up replica must serve guarded reads again"
        m.client.close()
    finally:
        rep.stop()


def test_open_revalidates_despite_lease(vol):
    """open() is the openfile revalidation point: a peer's write must be
    seen at open time even while the attr lease is live (a lease-served
    open would hide the new length for lease TTL + openfile expire)."""
    from juicefs_tpu_torch.meta import Slice

    c1 = _client(vol, attr_ttl=60.0, entry_ttl=60.0)
    c2 = _client(vol)
    st, ino, _ = c1.create(CTX, ROOT_INODE, b"f", 0o644)
    c1.close(CTX, ino)
    assert c1.getattr(CTX, ino)[1].length == 0  # lease caches length 0

    sid = c2.new_slice()
    assert c2.write_chunk(ino, 0, 0,
                          Slice(pos=0, id=sid, size=4096, off=0, len=4096)) == 0

    st, attr = c1.open(CTX, ino, 0)
    assert st == 0 and attr.length == 4096, \
        "open served a lease-stale length over the peer's write"
    c1.close(CTX, ino)


# ---------------------------------------------------------------------------
# round-trip economy on the wire
# ---------------------------------------------------------------------------

def test_point_read_round_trips(vol, monkeypatch):
    """do_getattr is ONE wire round trip (no WATCH/UNWATCH), and a hinted
    do_lookup revalidates dentry + child attr in ONE round trip."""
    from juicefs_tpu_torch.meta import redis_kv

    m = new_client(vol)
    m.load()
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)

    sends = [0]
    orig = redis_kv.RespConnection.send

    def counting(self, *cmds):
        sends[0] += 1
        return orig(self, *cmds)

    monkeypatch.setattr(redis_kv.RespConnection, "send", counting)

    sends[0] = 0
    assert m.do_getattr(ino)[0] == 0
    assert sends[0] == 1, "a point getattr must be one round trip"

    sends[0] = 0
    st, i2, attr = m.do_lookup(ROOT_INODE, b"f", hint_ino=ino)
    assert st == 0 and i2 == ino and attr.full
    assert sends[0] == 1, "a hinted lookup must be one round trip"

    sends[0] = 0
    st, i2, _ = m.do_lookup(ROOT_INODE, b"f")
    assert st == 0 and i2 == ino
    assert sends[0] == 2, "an unhinted lookup is dentry+parent, then attr"
    m.client.close()


def test_epoch_floor_is_monotonic(vol):
    """advance_epoch never regresses: observing an older epoch after a
    newer one must not lower the replica-read floor."""
    m = new_client(vol)
    m.load()
    m.client.advance_epoch(5)
    m.client.advance_epoch(3)
    assert m.client._epoch_floor == 5
    m.client.advance_epoch(0)
    assert m.client._epoch_floor == 5
    m.client.close()


def test_keys_only_scan_skips_value_fetch(vol, monkeypatch):
    """A keys_only read-txn scan is the index range alone — no MGET."""
    from juicefs_tpu_torch.meta import redis_kv

    m = new_client(vol)
    m.load()
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)

    sends = [0]
    orig = redis_kv.RespConnection.send

    def counting(self, *cmds):
        sends[0] += 1
        return orig(self, *cmds)

    monkeypatch.setattr(redis_kv.RespConnection, "send", counting)

    def keys_only(tx):
        return list(tx.scan(b"A", b"B", keys_only=True))

    sends[0] = 0
    out = m.client.simple_txn(keys_only)
    assert out and all(v == b"" for _, v in out)
    assert sends[0] == 1, "keys_only scan must not fetch values"
    m.client.close()


def test_simple_txn_write_closure_falls_back(vol):
    """A simple_txn closure that writes reruns under the WATCH txn."""
    m = new_client(vol)
    m.load()

    def writer(tx):
        tx.set(b"probe-key", b"v")
        return 42

    assert m.client.simple_txn(writer) == 42
    assert m.client.execute(b"GET", b"probe-key") == b"v"
    m.client.close()


# ---------------------------------------------------------------------------
# per-tenant meta-op throttling
# ---------------------------------------------------------------------------

def test_meta_op_throttle_queues_never_errors():
    from juicefs_tpu_torch.metric import global_registry

    m = new_client("memkv://")
    m.init(Format(name="thr", trash_days=0), force=True)
    m.load()
    st, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    m.configure_op_limit(50.0)  # burst ~6 ops, then 50/s
    waits = next(mt for mt in global_registry().walk()
                 if mt.name == "juicefs_meta_throttle_waits")
    before = waits.value
    t0 = time.perf_counter()
    for _ in range(20):
        assert m.getattr(CTX, ino)[0] == 0  # throttled, never an error
    elapsed = time.perf_counter() - t0
    assert elapsed >= 0.15, f"20 ops at 50/s must queue (took {elapsed:.3f}s)"
    assert waits.value > before

    # tenant isolation: a different uid's bucket is full, no queuing
    t0 = time.perf_counter()
    assert m.getattr(Context(uid=777, gid=0), ino)[0] == 0
    assert time.perf_counter() - t0 < 0.05
    m.configure_op_limit(0)
    assert m.op_limiter is None


def test_op_limiter_snapshot_and_bounds():
    lim = MetaOpLimiter(10.0)
    lim.acquire(1)
    lim.acquire(2)
    snap = lim.snapshot()
    assert snap["tenants"] == 2 and snap["rate_ops"] == 10.0
    with pytest.raises(ValueError):
        MetaOpLimiter(0)


# ---------------------------------------------------------------------------
# LeaseCache unit drills (mutation-killing boundaries)
# ---------------------------------------------------------------------------

def test_lease_cache_lru_bound_and_hints():
    lc = LeaseCache(attr_ttl=5.0, entry_ttl=0.05, maxsize=16)
    for i in range(40):
        lc.put_attr(i, _fake_attr())
    assert len(lc._attrs) <= 16
    assert lc.get_attr(0) is None      # oldest evicted
    assert lc.get_attr(39) is not None  # newest retained

    lc.put_entry(1, b"n", 42)
    assert lc.get_entry(1, b"n") == 42
    time.sleep(0.08)
    assert lc.get_entry(1, b"n") is None, "expired lease must not serve"
    assert lc.entry_hint(1, b"n") == 42, \
        "an expired dentry stays behind as a revalidation hint"

    lc.put_negative(1, b"gone")
    assert lc.get_entry(1, b"gone") == LeaseCache.NEGATIVE
    time.sleep(0.08)
    assert lc.get_entry(1, b"gone") is None
    assert lc.entry_hint(1, b"gone") == 0, "an expired ENOENT is no hint"

    lc.put_entry(1, b"x", 7)
    lc.invalidate_entry(1, b"x")
    assert lc.get_entry(1, b"x") is None and lc.entry_hint(1, b"x") == 0


def test_lease_cache_boundary_contracts():
    """Survivor drills: exact eviction boundaries, one-sided enablement,
    default sizing, and counter silence on the disabled path."""
    from juicefs_tpu_torch.metric import global_registry

    # default LRU bound is part of the memory contract
    assert LeaseCache(1.0, 1.0).maxsize == 100_000

    # one-sided TTLs still enable the cache (attr-only / entry-only)
    assert LeaseCache(attr_ttl=1.0, entry_ttl=0.0).enabled
    assert LeaseCache(attr_ttl=0.0, entry_ttl=1.0).enabled

    # eviction keeps EXACTLY maxsize entries, not maxsize-1
    lc = LeaseCache(attr_ttl=5.0, entry_ttl=5.0, maxsize=16)
    for i in range(17):
        lc.put_attr(i, _fake_attr())
        lc.put_entry(1, str(i).encode(), i + 1)
    assert len(lc._attrs) == 16
    assert len(lc._entries) == 16

    # neg_ttl 0 stores nothing at all (not a zero-TTL ghost row)
    lc0 = LeaseCache(attr_ttl=1.0, entry_ttl=1.0, neg_ttl=0.0)
    lc0.put_negative(1, b"gone")
    assert lc0.stats()["entries"] == 0

    # a DISABLED cache is silent: no miss counters move
    missc = next(m for m in global_registry().walk()
                 if m.name == "juicefs_meta_cache_misses")
    off = LeaseCache()
    before = {k: c.value for k, c in missc._children.items()}
    off.get_attr(1)
    off.get_entry(1, b"n")
    assert {k: c.value for k, c in missc._children.items()} == before


def test_op_limiter_boundary_contracts():
    from juicefs_tpu_torch.metric import global_registry

    # burst is an eighth of a second of ops (floored at one)
    assert MetaOpLimiter(80.0).burst == 10.0
    assert MetaOpLimiter(1.0).burst == 1.0

    # tenant LRU keeps EXACTLY MAX_TENANTS buckets
    lim = MetaOpLimiter(1000.0)
    lim.MAX_TENANTS = 2
    lim.acquire(1)
    lim.acquire(2)
    lim.acquire(3)
    assert lim.snapshot()["tenants"] == 2

    # a no-wait acquire must NOT bill the throttle counters
    waits = next(m for m in global_registry().walk()
                 if m.name == "juicefs_meta_throttle_waits")
    before = waits.value
    MetaOpLimiter(1000.0).acquire(7)  # burst covers it: zero wait
    assert waits.value == before


def test_lease_cache_disabled_is_inert():
    lc = LeaseCache()  # TTL 0 both sides
    assert not lc.enabled
    lc.put_attr(1, _fake_attr())
    lc.put_entry(1, b"n", 2)
    lc.put_negative(1, b"m")
    assert lc.get_attr(1) is None
    assert lc.get_entry(1, b"n") is None
    assert lc.stats()["attrs"] == 0 and lc.stats()["entries"] == 0


def _fake_attr():
    from juicefs_tpu_torch.meta.types import Attr

    return Attr(typ=1, mode=0o644)


# ---------------------------------------------------------------------------
# replica reconnect/re-SYNC edges

def test_heal_reprimes_floor_so_frozen_replica_demotes(server):
    """The replica reconnect edge: a reader attached through an outage
    has a floor frozen at its last observed epoch, while the primary
    commits past it.  A replica that lost replication (it will re-SYNC,
    but has not yet) still holds pre-outage state AT an epoch >= the
    reader's stale floor — so the lag guard PASSES and serves pre-outage
    state as fresh.  The heal hook must re-prime the floor from the
    primary so the frozen replica demotes until it catches up."""
    from juicefs_tpu_torch.meta.cache import _REPLICA_STALE
    from juicefs_tpu_torch.meta.redis_server import RedisServer
    from juicefs_tpu_torch.meta.types import Attr, SET_ATTR_MODE

    pport = int(server.split(":")[2].split("/")[0])
    rep = RedisServer(replica_of=f"127.0.0.1:{pport}")
    rport = rep.start()
    try:
        c0 = new_client(server)
        c0.init(Format(name="refloor", trash_days=0), force=True)
        c0.load()
        st, ino, _ = c0.create(CTX, ROOT_INODE, b"f", 0o640)
        assert st == 0
        c0.close(CTX, ino)

        # reader attaches: floor primed at the current epoch E
        m = new_client(server)
        m.load()
        m.client.configure_replica(f"127.0.0.1:{rport}")
        floor = m.client._epoch_floor
        assert floor > 0

        # replica catches up to E, then replication is SEVERED (the
        # outage): it keeps serving its frozen pre-outage state
        from juicefs_tpu_torch.meta.redis_kv import RedisKV

        probe = RedisKV(f"127.0.0.1:{rport}/0")
        deadline = time.time() + 5.0
        while time.time() < deadline:
            raw = probe.execute(b"GET", RedisKV.EPOCH_KEY)
            if raw and int(raw) >= floor:
                break
            time.sleep(0.05)
        probe.close()
        rep._repl_stop.set()
        pull = rep._repl_pull_conn
        if pull is not None:
            pull.close()

        # the primary moves on (the writes the reader never observed)
        st, _ = c0.setattr(CTX, ino, SET_ATTR_MODE, Attr(mode=0o600))
        assert st == 0

        # WITHOUT the re-prime the frozen replica passes the stale
        # floor's guard and serves the pre-outage mode as fresh — that
        # is the bug the re-prime closes
        st, attr = m.do_getattr(ino)
        assert st == 0 and attr.mode & 0o777 == 0o640, \
            "(pre-fix behavior proof: frozen replica admitted by stale floor)"

        # heal hook: re-prime from the primary -> frozen replica demotes
        before = _REPLICA_STALE.value
        m.client.on_primary_heal()
        assert m.client._epoch_floor > floor
        st, attr = m.do_getattr(ino)
        assert st == 0 and attr.mode & 0o777 == 0o600, \
            "after the re-prime the read must demote to the primary's truth"
        assert _REPLICA_STALE.value > before
        assert m.client.primary_down is False
        m.client.close()
    finally:
        rep.stop()


def test_snapshot_payload_is_multi_exec_framed():
    """The re-SYNC snapshot must apply ATOMICALLY on the replica: framed
    MULTI..EXEC so the pull loop applies it under one lock hold.  Applied
    command-by-command, a reader attached mid-re-SYNC could pass the
    epoch guard (the !epoch key applies early — first-commit dict order)
    while most of the namespace is still missing post-FLUSHDB."""
    from juicefs_tpu_torch.meta.redis_server import RedisServer, _Conn

    pri = RedisServer()
    port = pri.start()
    try:
        c0 = new_client(f"redis://127.0.0.1:{port}/0")
        c0.init(Format(name="frame", trash_days=0), force=True)
        c0.load()
        st, ino, _ = c0.create(CTX, ROOT_INODE, b"f", 0o644)
        assert st == 0
        c0.close(CTX, ino)
        c0.client.close()
        with pri.lock:
            payload = pri._snapshot_payload()
    finally:
        pri.stop()
    assert payload.startswith(_Conn._enc([b"MULTI"])), \
        "snapshot must open a MULTI frame"
    assert payload.endswith(_Conn._enc([b"EXEC"])), \
        "snapshot must close with EXEC (atomic apply on the replica)"
    # the epoch key rides INSIDE the frame, with real volume data
    assert b"!epoch" in payload and b"setting" in payload


# ---------------------------------------------------------------------------
# parity with the reference's LeaseCache on one seeded op sequence


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_lease_cache_matches_reference(seed, monkeypatch):
    """Both packages' LeaseCache under one fake monotonic clock and the
    same seeded puts, gets, hints, invalidations and degraded-mode stale
    reads: every answer and the final stats are equal."""
    import random

    from juicefs_tpu.meta.cache import LeaseCache as RefLeaseCache

    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    rng = random.Random(seed)
    kw = dict(attr_ttl=rng.choice([0.0, 1.0, 2.5]), entry_ttl=rng.choice([0.0, 1.0, 3.0]),
              neg_ttl=rng.choice([0.0, 0.5, 2.0]), maxsize=rng.choice([4, 8, 64]))
    caches = (LeaseCache(**kw), RefLeaseCache(**kw))
    keep_stale = rng.random() < 0.5
    for c in caches:
        c.keep_stale = keep_stale
    names = [b"a", b"b", b"c", b"d"]
    for step in range(600):
        op = rng.choice(["put_attr", "get_attr", "get_attr_stale", "invalidate_attr",
                         "put_entry", "put_negative", "get_entry", "get_entry_stale",
                         "entry_hint", "invalidate_entry", "tick", "clear"])
        ino, parent, name = rng.randint(1, 12), rng.randint(1, 3), rng.choice(names)
        stale, token, dt = rng.choice([0.0, 0.5, 5.0]), f"attr{step}", rng.random() * 0.8
        out = []
        for c in caches:
            if op == "put_attr":
                out.append(c.put_attr(ino, token))
            elif op == "get_attr":
                out.append(c.get_attr(ino))
            elif op == "get_attr_stale":
                out.append(c.get_attr_stale(ino, stale))
            elif op == "invalidate_attr":
                out.append(c.invalidate_attr(ino))
            elif op == "put_entry":
                out.append(c.put_entry(parent, name, ino))
            elif op == "put_negative":
                out.append(c.put_negative(parent, name))
            elif op == "get_entry":
                out.append(c.get_entry(parent, name))
            elif op == "get_entry_stale":
                out.append(c.get_entry_stale(parent, name, stale))
            elif op == "entry_hint":
                out.append(c.entry_hint(parent, name))
            elif op == "invalidate_entry":
                out.append(c.invalidate_entry(parent, name))
            elif op == "clear":
                out.append(c.clear())
            else:
                out.append(None)
        if op == "tick":
            now[0] += dt
        assert out[0] == out[1], f"step {step} {op}: port {out[0]!r}, reference {out[1]!r}"
    assert caches[0].stats() == caches[1].stats()
    assert caches[0].enabled == caches[1].enabled
