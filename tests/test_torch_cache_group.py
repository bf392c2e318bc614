"""The port's cache group (juicefs_tpu_torch/cache/: ring.py, server.py,
group.py; cmd/warmup.py): the twins of tests/test_cache_group.py's drills
over the port, plus parity with the JAX package.

The invariants under test, as in the reference's drills:
  - placement: deterministic, weight-proportional, bounded churn on
    join/leave, bounded total vnodes — and the same owners as the
    reference's ring for the same members, weights and keys;
  - the acceptance path: client B's cold read of a block cached on A is
    served by A's peer server with ZERO object-store GETs
    (counter-asserted), and a dead peer mid-GET still completes the read
    via the object store with the peer breaker observably open in
    `.status`;
  - integrity: digest/key-echo mismatches are rejected before entering
    the local cache (membership churn must never serve wrong bytes);
  - chaos: a backend blackout with a warm peer keeps every read exact
    with zero backend data calls (object/fault.py drill);
  - warmup: `--cache-group` partitions the fill across ring owners.

Parity: a port PeerBlockServer serves a reference CacheGroup and the
other way round (one wire format), a port member and a reference member
discover each other through one meta-server's sessions and serve each
other, and `warmup` through both CLIs on one volume fetches the same
blocks.

The drills wait on state, never on time. A written block enters the
writer's cache in the upload future's done-callback, which runs on the
pool thread AFTER `finish()` has seen the future complete; so the
reference's `test_peer_hit_zero_object_store_gets` can ask the peer
before the block is cached there (a 404), and the read falls through to
the object store. `_write_slice` here waits until the writer's cache
holds every block of the slice.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import Counter

import pytest

from juicefs_tpu_torch.cache import CacheGroup, HashRing, PeerBlockServer
from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig
from juicefs_tpu_torch.chunk.cached_store import block_key
from juicefs_tpu_torch.meta import Format, new_client
from juicefs_tpu_torch.meta.context import Context
from juicefs_tpu_torch.object import create_storage
from juicefs_tpu_torch.object.fault import FaultyStore
from juicefs_tpu_torch.object.resilient import BreakerState, RetryPolicy

CTX = Context(uid=0, gid=0, pid=1)
BS = 1 << 16


def _counter_value(name, *labels):
    from juicefs_tpu_torch.metric import global_registry

    m = global_registry()._metrics[name]
    return (m.labels(*labels) if labels else m).value


def _wait_for(cond, timeout: float, what: str) -> None:
    """Poll `cond` until it holds; fail naming `what` after `timeout`
    seconds (a generous bound: the drills wait on state, not on time)."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _write_slice(store, sid: int, blob: bytes) -> None:
    """Write one slice and wait until the writer's own cache holds every
    block of it (the cache fill runs after finish() returns)."""
    w = store.new_writer(sid)
    w.write_at(blob, 0)
    w.finish(len(blob))
    n = -(-len(blob) // store.conf.block_size)
    _wait_for(lambda: store.check_cache(sid, len(blob)) == n, 30.0,
              f"slice {sid} in the writer's cache")


def _spy_gets(backend):
    """Monkeypatch backend.get to count data GETs; returns the counter."""
    counter = [0]
    real = backend.get

    def spy(key, off=0, limit=-1):
        counter[0] += 1
        return real(key, off, limit)

    backend.get = spy
    return counter


# -- ring placement ----------------------------------------------------------

def test_ring_deterministic_and_weighted():
    a, b = HashRing(), HashRing()
    members = {"h1:1": 1, "h2:1": 1, "h3:1": 3}
    a.rebuild(members)
    b.rebuild(members)
    keys = [block_key(i, 0, BS) for i in range(3000)]
    assert [a.owner(k) for k in keys] == [b.owner(k) for k in keys]
    share = Counter(a.owner(k) for k in keys)
    # weight 3 owns roughly 3x a weight-1 member (loose bounds: md5 spread)
    assert share["h3:1"] > 1.8 * share["h1:1"]
    assert share["h3:1"] > 1.8 * share["h2:1"]


def test_ring_join_leave_moves_only_its_share():
    ring = HashRing()
    ring.rebuild({"a:1": 1, "b:1": 1, "c:1": 1})
    keys = [block_key(i, 0, BS) for i in range(4000)]
    before = {k: ring.owner(k) for k in keys}
    ring.rebuild({"a:1": 1, "c:1": 1})  # b leaves
    stolen = [k for k in keys if before[k] != ring.owner(k)]
    # ONLY b's keys moved, and they all moved off b
    assert all(before[k] == "b:1" for k in stolen)
    assert not any(ring.owner(k) == "b:1" for k in keys)
    ring.rebuild({"a:1": 1, "b:1": 1, "c:1": 1})  # b rejoins
    assert {k: ring.owner(k) for k in keys} == before  # exact rehash back


def test_ring_bounded_vnodes_and_fallback_order():
    ring = HashRing(vnodes=64, max_total=512)
    ring.rebuild({f"n{i}": 2 for i in range(40)})  # would be 5120 unbounded
    assert len(ring._points) <= 512
    order = ring.owners(block_key(7, 0, BS), 3)
    assert len(order) == 3 and len(set(order)) == 3
    assert ring.owners("x", 99)  # capped at member count, never raises
    empty = HashRing()
    assert empty.owner("k") is None and empty.owners("k", 2) == []


# -- acceptance: peer-served cold read, zero object GETs ---------------------

def test_peer_hit_zero_object_store_gets(tmp_path):
    backend = create_storage("mem://")
    A = CachedStore(backend, ChunkConfig(
        block_size=BS, cache_dirs=(str(tmp_path / "a"),)))
    blob = os.urandom(3 * BS + 777)
    _write_slice(A, 11, blob)
    srv = PeerBlockServer(A, group="g")
    addr = srv.start()
    B = CachedStore(backend, ChunkConfig(block_size=BS))
    B.cache_group = CacheGroup("g", static_peers={addr: 1})
    try:
        hits0 = _counter_value("juicefs_cache_group_peer_hits")
        served0 = _counter_value("juicefs_cache_group_served", "get")
        gets = _spy_gets(backend)
        got = B.new_reader(11, len(blob)).read(0, len(blob))
        assert bytes(got) == blob
        assert gets[0] == 0, "peer-hit path touched the object store"
        assert _counter_value("juicefs_cache_group_peer_hits") - hits0 >= 4
        assert _counter_value("juicefs_cache_group_served", "get") > served0
        # second read: B's local cache now holds the peer-fetched copies
        hits1 = _counter_value("juicefs_cache_group_peer_hits")
        got = B.new_reader(11, len(blob)).read(0, len(blob))
        assert bytes(got) == blob
        assert _counter_value("juicefs_cache_group_peer_hits") == hits1
    finally:
        srv.stop()
        A.close()
        B.close()


def test_peer_serves_writeback_staging(tmp_path):
    """A block a peer wrote but has NOT uploaded yet (writeback staging)
    is exactly the block the object store cannot serve — the peer can."""
    backend = create_storage("mem://")
    faulty = FaultyStore(backend, put_error_rate=1.0, seed=3)
    A = CachedStore(faulty, ChunkConfig(
        block_size=BS, cache_dirs=(str(tmp_path / "a"),), writeback=True,
        max_retries=1))
    blob = os.urandom(BS)
    _write_slice(A, 21, blob)  # staged; upload fails (outage)
    srv = PeerBlockServer(A, group="wb")
    addr = srv.start()
    B = CachedStore(backend, ChunkConfig(block_size=BS))
    B.cache_group = CacheGroup("wb", static_peers={addr: 1})
    try:
        assert backend.head(block_key(21, 0, BS)) is not None
    except Exception:
        pass  # expected: the block never reached the store
    try:
        got = B.new_reader(21, len(blob)).read(0, len(blob))
        assert bytes(got) == blob
    finally:
        faulty.fault_config(put_error_rate=0.0)
        srv.stop()
        A.close()
        B.close()


# -- meta-session discovery --------------------------------------------------

def test_discovery_via_meta_sessions(tmp_path):
    meta_url = f"sqlite3://{tmp_path}/meta.db"
    m1 = new_client(meta_url)
    m1.init(Format(name="grp", storage="mem", trash_days=0), force=False)
    m1.load()

    backend = create_storage("mem://")
    A = CachedStore(backend, ChunkConfig(
        block_size=BS, cache_dirs=(str(tmp_path / "a"),)))
    srv = PeerBlockServer(A, group="train")
    addr = srv.start()
    # the mount wiring order (cmd/mount.py): server first, THEN the
    # session publishes the dialable address
    m1.session_extras.update(cache_group="train", peer_addr=addr,
                             group_weight=2)
    m1.new_session()
    A.cache_group = CacheGroup("train", self_addr=addr, meta=m1, weight=2)

    blob = os.urandom(2 * BS)
    _write_slice(A, 31, blob)

    m2 = new_client(meta_url)
    m2.load()
    m2.new_session()  # plain session: no cache-group fields published
    B = CachedStore(backend, ChunkConfig(block_size=BS))
    B.cache_group = CacheGroup("train", meta=m2)
    try:
        assert B.cache_group.ring.members == {addr: 2}
        gets = _spy_gets(backend)
        got = B.new_reader(31, len(blob)).read(0, len(blob))
        assert bytes(got) == blob and gets[0] == 0
        # A leaves: session cleanup drops it from the next refresh
        m1.close_session()
        B.cache_group.refresh(force=True)
        assert len(B.cache_group.ring) == 0
    finally:
        srv.stop()
        m2.close_session()
        A.close()
        B.close()


def test_discovery_skips_stale_heartbeats(tmp_path):
    """A member that died without cleanup (kill -9) ages out of the ring
    once its heartbeat passes the stale window — no coordination needed."""
    meta_url = f"sqlite3://{tmp_path}/meta.db"
    m1 = new_client(meta_url)
    m1.init(Format(name="stale", storage="mem", trash_days=0), force=False)
    m1.load()
    m1.session_extras.update(cache_group="g2", peer_addr="10.0.0.9:7001")
    m1.new_session()
    sid = m1.sid

    m2 = new_client(meta_url)
    m2.load()
    g = CacheGroup("g2", meta=m2)
    try:
        assert "10.0.0.9:7001" in g.ring.members
        # age the heartbeat past the 300s stale window, engine-side
        # (sqlite3:// is the ordered-KV family: beats live under SH keys)
        from juicefs_tpu_torch.meta.kv import _F64

        m1.client.txn(lambda tx: tx.set(
            m1._heartbeat_key(sid), _F64.pack(time.time() - 9999)))
        g.refresh(force=True)
        assert "10.0.0.9:7001" not in g.ring.members
    finally:
        g.close()
        m1.close_session()


def test_takeover_republishes_session_info(tmp_path):
    """A seamless-upgrade successor adopts the predecessor's sid WITHOUT
    new_session; update_session_info must overwrite the stored record so
    the group stops advertising the dead predecessor's peer address."""
    meta_url = f"sqlite3://{tmp_path}/meta.db"
    m1 = new_client(meta_url)
    m1.init(Format(name="tk", storage="mem", trash_days=0), force=False)
    m1.load()
    m1.session_extras.update(cache_group="tg", peer_addr="old:1")
    m1.new_session()
    sid = m1.sid

    m2 = new_client(meta_url)  # the successor, same sid (takeover)
    m2.load()
    m2.sid = sid
    m2.session_extras.update(cache_group="tg", peer_addr="new:2")
    m2.update_session_info()
    try:
        sessions = {s.sid: s for s in m2.do_list_sessions()}
        assert sessions[sid].peer_addr == "new:2"
        g = CacheGroup("tg", meta=m2)
        try:
            assert "new:2" in g.ring.members
            assert "old:1" not in g.ring.members
        finally:
            g.close()
    finally:
        m2.close_session()


def test_warmup_without_ring_identity_fills_everything(tmp_path):
    """_group_for with no local member and no --group-self returns None
    (fill-all): a filter whose owns() rejects every key would silently
    warm NOTHING."""
    from juicefs_tpu_torch.cmd.warmup import _group_for

    meta_url = f"sqlite3://{tmp_path}/meta.db"
    m1 = new_client(meta_url)
    m1.init(Format(name="wnone", storage="mem", trash_days=0), force=False)
    m1.load()
    # the only group member lives on ANOTHER host
    m1.session_extras.update(cache_group="far", peer_addr="9.9.9.9:1")
    m1.new_session()
    try:
        s = [x for x in m1.do_list_sessions() if x.sid == m1.sid][0]
        s_host = s.hostname
        # fake a foreign hostname so the hostname match cannot fire
        m1.client.txn(lambda tx: tx.set(
            m1._session_key(m1.sid),
            s.to_json().replace(s_host, "elsewhere").encode()))
        assert _group_for(m1, "far", "") is None
    finally:
        m1.close_session()


# -- failure drills ----------------------------------------------------------

def test_dead_peer_falls_through_and_breaker_opens(tmp_path):
    """Acceptance: kill A's peer server; B's reads still succeed via the
    object store, the TRANSIENT error path is counter-asserted, and the
    peer's breaker is observably OPEN in the `.status` payload."""
    from juicefs_tpu_torch.vfs import ROOT_INO, VFS
    from juicefs_tpu_torch.vfs.internal import STATUS_INO

    backend = create_storage("mem://")
    A = CachedStore(backend, ChunkConfig(
        block_size=BS, cache_dirs=(str(tmp_path / "a"),)))
    blobs = {sid: os.urandom(BS) for sid in range(41, 49)}
    for sid, blob in blobs.items():
        _write_slice(A, sid, blob)
    srv = PeerBlockServer(A, group="kill")
    addr = srv.start()

    m = new_client("mem://")
    m.init(Format(name="kill", storage="mem", trash_days=0), force=False)
    m.load()
    m.new_session()
    B = CachedStore(backend, ChunkConfig(block_size=BS))
    B.cache_group = CacheGroup("kill", static_peers={addr: 1},
                               peer_timeout=1.0)
    v = VFS(m, B)
    try:
        # warm path proven first
        got = B.new_reader(41, BS).read(0, BS)
        assert bytes(got) == blobs[41]
        srv.stop()  # ---- A dies
        err0 = _counter_value("juicefs_cache_group_peer_errors", "transient")
        # the breaker (threshold 0.5 over >= 4 samples) holds 1 success
        # from the warm read, so it must open after EXACTLY 3 failures —
        # the 4th read already skips the peer (no new transient error)
        for sid in range(42, 46):
            got = B.new_reader(sid, BS).read(0, BS)  # still correct, via store
            assert bytes(got) == blobs[sid]
        assert _counter_value("juicefs_cache_group_peer_errors",
                              "transient") == err0 + 3
        peer = B.cache_group._peers[addr]
        assert peer.breaker.state == BreakerState.OPEN
        # breaker-open: subsequent reads skip the peer (counted as a MISS,
        # no new transient errors) and go straight to the store
        err1 = _counter_value("juicefs_cache_group_peer_errors", "transient")
        miss0 = _counter_value("juicefs_cache_group_peer_misses")
        got = B.new_reader(48, BS).read(0, BS)
        assert bytes(got) == blobs[48]
        assert _counter_value("juicefs_cache_group_peer_errors",
                              "transient") == err1
        assert _counter_value("juicefs_cache_group_peer_misses") > miss0
        # observable through .status
        v.internal.open(STATUS_INO, 71)
        st, raw = v.internal.read(STATUS_INO, 71, 0, 1 << 20)
        v.internal.release(STATUS_INO, 71)
        status = json.loads(bytes(raw))
        assert status["cache_group"]["group"] == "kill"
        assert status["cache_group"]["peers"][addr]["state"] == "open"
    finally:
        v.close()
        A.close()
        B.close()


def test_peer_dies_mid_get_read_still_succeeds():
    """A peer that accepts the connection and dies mid-body (partial
    stream) is a TRANSIENT failure: rejected, fallen through, read exact."""
    backend = create_storage("mem://")
    A = CachedStore(backend, ChunkConfig(block_size=BS))
    blob = os.urandom(BS)
    _write_slice(A, 51, blob)

    # rogue "peer": advertises the full block, sends half, drops the conn
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(4)
    addr = f"127.0.0.1:{sock.getsockname()[1]}"

    def half_server():
        while True:
            try:
                conn, _ = sock.accept()
            except OSError:
                return
            try:
                conn.recv(4096)
                conn.sendall(
                    b"HTTP/1.1 200 OK\r\n"
                    b"Content-Type: application/octet-stream\r\n"
                    + f"Content-Length: {BS}\r\n".encode()
                    + f"X-Block-Crc32: 1\r\nX-Block-Key: x\r\n\r\n".encode()
                    + b"\x00" * (BS // 2)
                )
            finally:
                conn.close()

    t = threading.Thread(target=half_server, daemon=True)
    t.start()
    B = CachedStore(backend, ChunkConfig(block_size=BS))
    B.cache_group = CacheGroup("mid", static_peers={addr: 1},
                               peer_timeout=1.0)
    try:
        err0 = _counter_value("juicefs_cache_group_peer_errors", "transient")
        got = B.new_reader(51, BS).read(0, BS)
        assert bytes(got) == blob
        assert _counter_value("juicefs_cache_group_peer_errors",
                              "transient") > err0
    finally:
        sock.close()
        A.close()
        B.close()


def test_digest_mismatch_rejected_never_cached():
    """A peer answering with a wrong digest (corrupt copy / wrong block
    during churn) is rejected BEFORE the bytes can enter B's cache."""
    backend = create_storage("mem://")
    A = CachedStore(backend, ChunkConfig(block_size=BS))
    blob = os.urandom(BS)
    _write_slice(A, 61, blob)
    key = block_key(61, 0, BS)

    # rogue peer: full-length response, valid crc OF THE WRONG BYTES but
    # a crc header claiming something else entirely
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    wrong = os.urandom(BS)

    class Rogue(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(BS))
            self.send_header("X-Block-Crc32", "12345")  # doesn't match body
            self.send_header("X-Block-Key", key)
            self.end_headers()
            self.wfile.write(wrong)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Rogue)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    addr = f"127.0.0.1:{httpd.server_address[1]}"

    B = CachedStore(backend, ChunkConfig(block_size=BS))
    B.cache_group = CacheGroup("rx", static_peers={addr: 1})
    try:
        d0 = _counter_value("juicefs_cache_group_peer_errors", "digest")
        got = B.new_reader(61, BS).read(0, BS)
        assert bytes(got) == blob, "wrong bytes surfaced to the reader"
        assert _counter_value("juicefs_cache_group_peer_errors",
                              "digest") > d0
        assert B.cache.load(key) is not None  # backend copy was cached
    finally:
        httpd.shutdown()
        httpd.server_close()
        A.close()
        B.close()


def test_wrong_key_echo_rejected():
    """The key-echo check: a peer resolving the WRONG block (stale ring /
    routing bug) is caught even when its digest matches its payload."""
    backend = create_storage("mem://")
    A = CachedStore(backend, ChunkConfig(block_size=BS))
    blob = os.urandom(BS)
    _write_slice(A, 62, blob)
    key = block_key(62, 0, BS)

    import zlib
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    wrong = os.urandom(BS)

    class Rogue(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(BS))
            self.send_header("X-Block-Crc32", str(zlib.crc32(wrong)))
            self.send_header("X-Block-Key", "chunks/0/0/999_0_65536")
            self.end_headers()
            self.wfile.write(wrong)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Rogue)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    addr = f"127.0.0.1:{httpd.server_address[1]}"
    B = CachedStore(backend, ChunkConfig(block_size=BS))
    B.cache_group = CacheGroup("echo", static_peers={addr: 1})
    try:
        d0 = _counter_value("juicefs_cache_group_peer_errors", "digest")
        got = B.new_reader(62, BS).read(0, BS)
        assert bytes(got) == blob
        assert _counter_value("juicefs_cache_group_peer_errors",
                              "digest") > d0
    finally:
        httpd.shutdown()
        httpd.server_close()
        A.close()
        B.close()


def test_membership_churn_reads_stay_exact(tmp_path):
    """Join/leave mid-workload: owners rehash, every read stays exact
    (misses fall through; the integrity checks keep wrong bytes out)."""
    backend = create_storage("mem://")
    A = CachedStore(backend, ChunkConfig(
        block_size=BS, cache_dirs=(str(tmp_path / "a"),)))
    C = CachedStore(backend, ChunkConfig(
        block_size=BS, cache_dirs=(str(tmp_path / "c"),)))
    blobs = {sid: os.urandom(2 * BS + sid) for sid in range(70, 76)}
    for sid, blob in blobs.items():
        _write_slice(A, sid, blob)
    srv_a = PeerBlockServer(A, group="churn")
    srv_c = PeerBlockServer(C, group="churn")
    addr_a, addr_c = srv_a.start(), srv_c.start()

    B = CachedStore(backend, ChunkConfig(block_size=BS))
    B.cache_group = CacheGroup("churn", static_peers={addr_a: 1},
                               refresh_interval=0.0)
    try:
        for sid, blob in list(blobs.items())[:2]:
            assert bytes(B.new_reader(sid, len(blob)).read(0, len(blob))) == blob
        # C joins (its cache is cold: misses there must fall through)
        B.cache_group._static = {addr_a: 1, addr_c: 1}
        B.cache_group.refresh(force=True)
        assert len(B.cache_group.ring) == 2
        for sid, blob in blobs.items():
            assert bytes(B.new_reader(sid, len(blob)).read(0, len(blob))) == blob
        # A leaves
        B.cache_group._static = {addr_c: 1}
        B.cache_group.refresh(force=True)
        for sid, blob in blobs.items():
            B.cache = __import__("juicefs_tpu_torch.chunk.mem_cache",
                                 fromlist=["MemCache"]).MemCache(1 << 30)
            assert bytes(B.new_reader(sid, len(blob)).read(0, len(blob))) == blob
    finally:
        srv_a.stop()
        srv_c.stop()
        A.close()
        B.close()
        C.close()


def test_chaos_blackout_served_entirely_by_peer(tmp_path):
    """object/fault.py drill with the group enabled: total backend outage,
    warm peer — every cold read on B is exact with ZERO backend data
    calls; after the peer dies too, reads fail fast; healing the backend
    restores them (degrade, never fail, then converge)."""
    inner = create_storage("mem://")
    faulty = FaultyStore(inner, seed=17)
    A = CachedStore(faulty, ChunkConfig(
        block_size=BS, cache_dirs=(str(tmp_path / "a"),)))
    blobs = {sid: os.urandom(2 * BS) for sid in range(80, 84)}
    for sid, blob in blobs.items():
        _write_slice(A, sid, blob)
    srv = PeerBlockServer(A, group="chaos")
    addr = srv.start()
    B = CachedStore(faulty, ChunkConfig(
        block_size=BS, hedge=False, max_retries=2,
        retry_policy=RetryPolicy(deadline=3.0, max_attempts=2, base=0.001,
                                 jitter=0.0)))
    B.cache_group = CacheGroup("chaos", static_peers={addr: 1},
                               peer_timeout=1.0)
    try:
        faulty.fault_config(error_rate=1.0)  # ---- blackout
        e0 = faulty.counters["errors"]
        for sid, blob in blobs.items():
            got = B.new_reader(sid, len(blob)).read(0, len(blob))
            assert bytes(got) == blob, f"torn read during blackout sid {sid}"
        assert faulty.counters["errors"] == e0, \
            "peer-served reads touched the dead backend"
        # peer dies too: now the read honestly fails (objects unreachable)
        srv.stop()
        B.cache = __import__("juicefs_tpu_torch.chunk.mem_cache",
                             fromlist=["MemCache"]).MemCache(1 << 30)
        with pytest.raises(Exception):
            B.new_reader(80, BS).read(0, BS)
        # heal: reads converge from the object store
        faulty.fault_config(error_rate=0.0)
        for sid, blob in blobs.items():
            got = B.new_reader(sid, len(blob)).read(0, len(blob))
            assert bytes(got) == blob
    finally:
        faulty.fault_config(error_rate=0.0)
        srv.stop()
        A.close()
        B.close()


def test_peer_server_wire_protocol(tmp_path):
    """Pin the wire statuses/headers exactly (the
    CacheGroup client is lenient — non-200 just falls through — so only a
    direct protocol test notices a drifted status code)."""
    import http.client as hc

    backend = create_storage("mem://")
    A = CachedStore(backend, ChunkConfig(block_size=BS))
    blob = os.urandom(BS)
    _write_slice(A, 55, blob)
    key = block_key(55, 0, BS)
    g = CacheGroup("wire", self_addr="self:1", static_peers={"self:1": 1})
    A.cache_group = g  # /ring reports the ring through the store's group
    srv = PeerBlockServer(A, group="wire")
    # ":0" form: host defaults to loopback, port auto-picks
    addr = srv.start(":0")
    assert addr.startswith("127.0.0.1:")
    host, _, port = addr.rpartition(":")

    def req(method, path):
        conn = hc.HTTPConnection(host, int(port), timeout=5)
        try:
            conn.request(method, path)
            r = conn.getresponse()
            return r.status, r.read(), dict(r.getheaders())
        finally:
            conn.close()

    try:
        import zlib

        st, body, hdr = req("GET", "/block/" + key)
        assert st == 200 and body == blob
        assert hdr["X-Block-Key"] == key
        assert int(hdr["X-Block-Crc32"]) == zlib.crc32(blob)
        st, body, hdr = req("HEAD", "/block/" + key)
        assert st == 200 and body == b""
        assert int(hdr["Content-Length"]) == BS
        assert req("GET", "/block/chunks/0/0/999_0_65536")[0] == 404
        assert req("GET", "/block/../../etc/passwd")[0] == 404  # key shape
        assert req("GET", "/nope")[0] == 404
        assert req("HEAD", "/nope")[0] == 404
        st, body, _ = req("GET", "/ring")
        assert st == 200
        view = json.loads(body)
        assert view["group"] == "wire" and view["addr"] == addr
        assert view["ring_size"] == 1 and "self:1" in view["members"]
    finally:
        srv.stop()
        A.close()


def test_peer_server_explicit_port(tmp_path):
    """An explicit --group-listen port is honored verbatim (the published
    session address must be the one the operator opened in the fabric)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    A = CachedStore(create_storage("mem://"), ChunkConfig(block_size=BS))
    srv = PeerBlockServer(A, group="port")
    try:
        addr = srv.start(f"127.0.0.1:{port}")
        assert addr == f"127.0.0.1:{port}"
    finally:
        srv.stop()
        A.close()


def test_online_peer_miss_is_clean_not_an_error():
    """A healthy peer without the block answers 404: counted as a MISS,
    zero transient errors, breaker stays closed (a clean no must never
    poison the peer's health)."""
    backend = create_storage("mem://")
    A = CachedStore(backend, ChunkConfig(block_size=BS))
    B = CachedStore(backend, ChunkConfig(block_size=BS))
    blob = os.urandom(BS)
    _write_slice(B, 57, blob)  # only in the backend + B's own cache
    B.cache = __import__("juicefs_tpu_torch.chunk.mem_cache",
                         fromlist=["MemCache"]).MemCache(1 << 30)
    srv = PeerBlockServer(A, group="m")  # A's cache is COLD
    addr = srv.start()
    B.cache_group = CacheGroup("m", static_peers={addr: 1})
    try:
        err0 = _counter_value("juicefs_cache_group_peer_errors", "transient")
        miss0 = _counter_value("juicefs_cache_group_peer_misses")
        got = B.new_reader(57, BS).read(0, BS)
        assert bytes(got) == blob
        assert _counter_value("juicefs_cache_group_peer_errors",
                              "transient") == err0
        assert _counter_value("juicefs_cache_group_peer_misses") > miss0
        assert B.cache_group._peers[addr].breaker.state == BreakerState.CLOSED
    finally:
        srv.stop()
        A.close()
        B.close()


def test_peer_breaker_recovers_after_restart(tmp_path):
    """The /ring half-open probe drives recovery: kill the peer, trip its
    breaker, restart the server on the SAME port — the breaker must close
    again on its own and peer serving resume."""
    backend = create_storage("mem://")
    A = CachedStore(backend, ChunkConfig(
        block_size=BS, cache_dirs=(str(tmp_path / "a"),)))
    blob = os.urandom(BS)
    _write_slice(A, 58, blob)
    srv = PeerBlockServer(A, group="rec")
    addr = srv.start()
    host, _, port = addr.rpartition(":")

    B = CachedStore(backend, ChunkConfig(block_size=BS))
    B.cache_group = CacheGroup("rec", static_peers={addr: 1},
                               peer_timeout=1.0)
    try:
        peer = B.cache_group._peers[addr]
        srv.stop()
        for _ in range(4):
            assert B.cache_group.fetch(block_key(58, 0, BS), BS) is None
        assert peer.breaker.state == BreakerState.OPEN
        # resurrect on the same port; the 1s probe cadence heals it
        srv2 = PeerBlockServer(A, group="rec")
        srv2.start(f"{host}:{port}")
        try:
            _wait_for(lambda: peer.breaker.state == BreakerState.CLOSED, 30.0,
                      "the probe to close the peer's breaker")
            got = B.cache_group.fetch(block_key(58, 0, BS), BS)
            assert got is not None and bytes(got) == blob
        finally:
            srv2.stop()
    finally:
        srv.stop()
        A.close()
        B.close()


def test_group_peer_split_and_refresh_gate():
    """Unit pins: a bare ':port' peer address dials loopback; the
    time-gated refresh really gates (one discovery per interval) and
    does not recreate live GroupPeer objects (breaker state would be
    lost and metric labels would leak '#2' suffixes)."""
    from juicefs_tpu_torch.cache.group import GroupPeer

    p = GroupPeer(":7701")
    try:
        assert p._split() == ("127.0.0.1", 7701)
    finally:
        p.close()

    class CountingMeta:
        calls = 0

        def do_list_sessions(self):
            CountingMeta.calls += 1
            return []

    g = CacheGroup("gate", meta=CountingMeta(),
                   static_peers={"p:1": 1}, refresh_interval=60.0)
    try:
        assert CountingMeta.calls == 1  # constructor refresh
        g.refresh()
        g.refresh()
        assert CountingMeta.calls == 1, "time gate did not gate"
        before = g._peers["p:1"]
        g.refresh(force=True)
        assert CountingMeta.calls == 2
        assert g._peers["p:1"] is before, "refresh recreated a live peer"
    finally:
        g.close()


def test_ring_owners_zero_and_walk_direction():
    """owners(key, 0) is empty, and the fallback order is the CLOCKWISE
    ring walk from the owner (an independent reference walk agrees)."""
    import bisect as _bisect

    from juicefs_tpu_torch.cache.ring import _hash

    ring = HashRing()
    ring.rebuild({"a:1": 1, "b:1": 1, "c:1": 1})
    key = block_key(123, 0, BS)
    assert ring.owners(key, 0) == []
    want: list[str] = []
    i = _bisect.bisect_right(ring._points, _hash(key))
    step = 0
    while len(want) < 3:
        n = ring._owners[(i + step) % len(ring._points)]
        if n not in want:
            want.append(n)
        step += 1
    assert ring.owners(key, 3) == want


def test_ring_golden_placement():
    """Golden placement pin: every member must hash the same membership
    to the same owners ACROSS CODE VERSIONS — a hash-width or walk-order
    change is a rolling-upgrade ring split, so the exact mapping is
    contract, not implementation detail."""
    ring = HashRing()
    ring.rebuild({"10.0.0.1:7000": 1, "10.0.0.2:7000": 2,
                  "10.0.0.3:7000": 1})
    golden = {
        "chunks/0/0/1_0_4194304": "10.0.0.2:7000",
        "chunks/0/0/2_0_4194304": "10.0.0.2:7000",
        "chunks/0/0/3_0_4194304": "10.0.0.1:7000",
        "chunks/0/0/4_0_4194304": "10.0.0.3:7000",
        "chunks/0/0/5_0_4194304": "10.0.0.2:7000",
    }
    assert {k: ring.owner(k) for k in golden} == golden
    # fallback order is the clockwise walk — pinned on a key whose
    # backward walk would differ
    assert ring.owners("chunks/0/0/4_0_4194304", 3) == [
        "10.0.0.3:7000", "10.0.0.1:7000", "10.0.0.2:7000"]


def test_peer_hit_latency_histogram_observes_wall_time(tmp_path):
    """The peer GET histogram records the fetch's wall time (seconds) —
    a localhost hit lands in fractions of a second, never garbage."""
    from juicefs_tpu_torch.cache.group import _PEER_HIST

    backend = create_storage("mem://")
    A = CachedStore(backend, ChunkConfig(block_size=BS))
    blob = os.urandom(BS)
    _write_slice(A, 59, blob)
    srv = PeerBlockServer(A, group="hist")
    addr = srv.start()
    B = CachedStore(backend, ChunkConfig(block_size=BS))
    B.cache_group = CacheGroup("hist", static_peers={addr: 1})
    try:
        child = _PEER_HIST.labels("hist")
        n0, s0 = child.total, child.sum
        got = B.cache_group.fetch(block_key(59, 0, BS), BS)
        assert got is not None
        assert child.total == n0 + 1
        assert 0 <= child.sum - s0 < 10.0, "histogram observed non-wall time"
    finally:
        srv.stop()
        A.close()
        B.close()


def test_self_only_ring_counts_no_misses():
    """The first member of a rolling-out group consults nobody: its cold
    reads are NOT peer misses (a fake 0% hit rate would mask real
    regressions once peers join)."""
    g = CacheGroup("solo", self_addr="me:1",
                   static_peers={"me:1": 1})
    try:
        m0 = _counter_value("juicefs_cache_group_peer_misses")
        assert g.fetch(block_key(1, 0, BS), BS) is None
        assert _counter_value("juicefs_cache_group_peer_misses") == m0
    finally:
        g.close()


def test_ring_default_vnode_budget():
    """One weight-1 member materializes exactly DEFAULT_VNODES points
    (the documented 64/weight-unit budget)."""
    ring = HashRing()
    ring.rebuild({"solo:1": 1})
    assert len(ring._points) == 64
    ring.rebuild({"solo:1": 2})
    assert len(ring._points) == 128


# -- distributed warmup ------------------------------------------------------

def test_warmup_partitions_fill_across_ring(tmp_path):
    backend = create_storage("mem://")
    seed = CachedStore(backend, ChunkConfig(block_size=BS))
    nblocks = 24
    blob = os.urandom(nblocks * BS)
    _write_slice(seed, 91, blob)
    seed.close()

    members = {"hostA:1": 1, "hostB:1": 1}
    ga = CacheGroup("wm", self_addr="hostA:1", static_peers=members)
    gb = CacheGroup("wm", self_addr="hostB:1", static_peers=members)
    A = CachedStore(backend, ChunkConfig(
        block_size=BS, cache_dirs=(str(tmp_path / "wa"),)))
    B = CachedStore(backend, ChunkConfig(
        block_size=BS, cache_dirs=(str(tmp_path / "wb"),)))
    try:
        A.fill_cache(91, len(blob), only=ga.owns)
        B.fill_cache(91, len(blob), only=gb.owns)
        in_a = {k for k, _ in A._block_range(91, len(blob))
                if A.cache.load(k, count_miss=False) is not None}
        in_b = {k for k, _ in B._block_range(91, len(blob))
                if B.cache.load(k, count_miss=False) is not None}
        assert in_a and in_b, "one member warmed nothing: ring is lopsided"
        assert not (in_a & in_b), "both members fetched the same block"
        assert len(in_a | in_b) == nblocks  # union covers the slice
        # each member fetched exactly its ring share
        for k in in_a:
            assert ga.ring.owner(k) == "hostA:1"
        for k in in_b:
            assert gb.ring.owner(k) == "hostB:1"
    finally:
        ga.close()
        gb.close()
        A.close()
        B.close()


def test_warmup_cli_group_self_resolution(tmp_path):
    """cmd/warmup._group_for finds this host's member by hostname from
    the session table when --group-self is not given."""
    from juicefs_tpu_torch.cmd.warmup import _group_for

    meta_url = f"sqlite3://{tmp_path}/meta.db"
    m1 = new_client(meta_url)
    m1.init(Format(name="wcli", storage="mem", trash_days=0), force=False)
    m1.load()
    m1.session_extras.update(cache_group="wg", peer_addr="1.2.3.4:9000")
    m1.new_session()
    try:
        g = _group_for(m1, "wg", "")
        try:
            # session hostname == this host (same process), so the local
            # member is adopted as the ring identity
            assert g.self_addr == "1.2.3.4:9000"
        finally:
            g.close()
        g2 = _group_for(m1, "wg", "5.6.7.8:1")
        try:
            assert g2.self_addr == "5.6.7.8:1"  # explicit --group-self wins
        finally:
            g2.close()
    finally:
        m1.close_session()


# -- ring-aware warm placement ------------------------------------------------

def _owned_by(ring, addr, bs=BS, limit=4000):
    """A (sid, key) whose single block the ring places on `addr`."""
    for sid in range(1000, 1000 + limit):
        k = block_key(sid, 0, bs)
        if ring.owner(k) == addr:
            return sid, k
    raise AssertionError("no key landed on the target member")


def test_warm_hint_fills_owner_not_sender(tmp_path):
    """`CacheGroup.warm` makes the ring OWNER fetch its own copy; no
    bytes ever land in the sender's cache."""
    backend = create_storage("mem://")
    A = CachedStore(backend, ChunkConfig(block_size=BS))
    srv = PeerBlockServer(A, group="warm")
    addr = srv.start()
    B = CachedStore(backend, ChunkConfig(block_size=BS))
    B.cache_group = CacheGroup("warm", self_addr="b-self:1",
                               static_peers={addr: 1})
    try:
        sid, key = _owned_by(B.cache_group.ring, addr)
        backend.put(key, b"w" * BS)
        hints0 = _counter_value("juicefs_cache_group_warm_hints")
        reqs0 = _counter_value("juicefs_cache_group_warm_requests")
        assert B.cache_group.warm(key) is True
        _wait_for(lambda: A.cache.load(key, count_miss=False) is not None, 30.0,
                  "the owner to warm the block")
        assert A.cache.load(key, count_miss=False) is not None, \
            "owner never warmed the hinted block"
        assert B.cache.load(key, count_miss=False) is None, \
            "warm hint moved bytes to the sender"
        assert _counter_value("juicefs_cache_group_warm_hints") == hints0 + 1
        assert _counter_value("juicefs_cache_group_warm_requests") == reqs0 + 1
    finally:
        B.close()
        srv.stop()
        A.close()


def test_prefetch_routes_non_owned_to_warm_hint(tmp_path):
    """The prefetch stage consults the ring: a non-owned block's warm is
    DELEGATED to the owner — the local member pays no object GET for it."""
    backend = create_storage("mem://")
    A = CachedStore(backend, ChunkConfig(block_size=BS))
    srv = PeerBlockServer(A, group="route")
    addr = srv.start()
    B = CachedStore(backend, ChunkConfig(block_size=BS))
    B.cache_group = CacheGroup("route", self_addr="b-self:1",
                               static_peers={addr: 1})
    try:
        sid, key = _owned_by(B.cache_group.ring, addr)
        backend.put(key, b"r" * BS)
        gets = _spy_gets(backend)
        B.prefetch(sid, BS)  # enqueue on B's prefetch stage
        _wait_for(lambda: A.cache.load(key, count_miss=False) is not None, 30.0,
                  "the owner to warm the block")
        assert A.cache.load(key, count_miss=False) is not None
        assert B.cache.load(key, count_miss=False) is None
        # exactly ONE object GET for the whole group: the owner's fill
        assert gets[0] == 1
    finally:
        B.close()
        srv.stop()
        A.close()


def test_warm_endpoint_rejects_malformed_keys(tmp_path):
    import http.client

    A = CachedStore(create_storage("mem://"), ChunkConfig(block_size=BS))
    srv = PeerBlockServer(A, group="bad")
    addr = srv.start()
    try:
        host, _, port = addr.rpartition(":")
        for path in ("/warm/../../etc/passwd", "/warm/notablockkey",
                     "/warm/"):
            conn = http.client.HTTPConnection(host, int(port), timeout=2)
            conn.request("POST", path, headers={"Content-Length": "0"})
            assert conn.getresponse().status == 400, path
            conn.close()
    finally:
        srv.stop()
        A.close()


# -- parity with the JAX package ----------------------------------------------

def test_ring_placement_equals_the_reference():
    """The same members, weights and keys place exactly as in the
    reference's ring, over seeded memberships (weights 1-4, up to 40
    members, so the bounded-vnode scaling is covered too)."""
    import random

    from juicefs_tpu.cache import HashRing as RefHashRing

    rng = random.Random(2026)
    for _ in range(6):
        members = {f"10.0.{rng.randrange(256)}.{rng.randrange(256)}:{rng.randrange(1, 65535)}":
                   rng.randrange(1, 5) for _ in range(rng.randrange(1, 41))}
        port, ref = HashRing(), RefHashRing()
        port.rebuild(members)
        ref.rebuild(members)
        assert port._points == ref._points and port._owners == ref._owners
        keys = [block_key(rng.randrange(1 << 40), rng.randrange(16), BS)
                for _ in range(500)]
        assert [port.owner(k) for k in keys] == [ref.owner(k) for k in keys]
        assert [port.owners(k, 3) for k in keys[:50]] == [ref.owners(k, 3) for k in keys[:50]]


def _ref_store(backend, **kw):
    from juicefs_tpu.chunk import CachedStore as RefCachedStore
    from juicefs_tpu.chunk import ChunkConfig as RefChunkConfig

    return RefCachedStore(backend, RefChunkConfig(block_size=BS, **kw))


@pytest.mark.parametrize("server", ["port", "ref"])
def test_peer_server_serves_the_other_package(tmp_path, server):
    """One wire format: a port PeerBlockServer serves a reference
    CacheGroup, and a reference server serves a port CacheGroup, with
    zero object-store GETs on the reader and the key and crc headers
    checked by the reader's package."""
    from juicefs_tpu import object as ref_object
    from juicefs_tpu.cache import CacheGroup as RefCacheGroup
    from juicefs_tpu.cache import PeerBlockServer as RefPeerBlockServer

    blob = os.urandom(3 * BS + 777)
    if server == "port":
        backend_w = create_storage("mem://")
        A = CachedStore(backend_w, ChunkConfig(block_size=BS,
                                               cache_dirs=(str(tmp_path / "a"),)))
        srv = PeerBlockServer(A, group="x")
        backend_r = ref_object.create_storage("mem://")
        B = _ref_store(backend_r)
        B.cache_group = RefCacheGroup("x", static_peers={})
    else:
        backend_w = ref_object.create_storage("mem://")
        A = _ref_store(backend_w, cache_dirs=(str(tmp_path / "a"),))
        srv = RefPeerBlockServer(A, group="x")
        backend_r = create_storage("mem://")
        B = CachedStore(backend_r, ChunkConfig(block_size=BS))
        B.cache_group = CacheGroup("x", static_peers={})
    _write_slice(A, 11, blob)
    addr = srv.start()
    B.cache_group._static = {addr: 1}
    B.cache_group.refresh(force=True)
    try:
        gets = _spy_gets(backend_r)  # the reader's backend holds nothing
        got = B.new_reader(11, len(blob)).read(0, len(blob))
        assert bytes(got) == blob and gets[0] == 0
        assert {B.cache_group.ring.owner(block_key(11, i, BS)) for i in range(3)} == {addr}
    finally:
        srv.stop()
        A.close()
        B.close()


def test_port_and_reference_members_form_one_ring(tmp_path):
    """A port member and a reference member publish themselves in one
    meta-server's sessions, discover each other, build the same ring and
    serve each other's owned blocks with zero object-store GETs."""
    from juicefs_tpu import object as ref_object
    from juicefs_tpu.cache import CacheGroup as RefCacheGroup
    from juicefs_tpu.cache import PeerBlockServer as RefPeerBlockServer
    from juicefs_tpu.meta import Format as RefFormat
    from juicefs_tpu.meta import new_client as ref_new_client
    from juicefs_tpu_torch.meta.redis_server import RedisServer

    msrv = RedisServer()
    mport = msrv.start()
    url = f"redis://127.0.0.1:{mport}/3"
    mp = new_client(url)
    mp.init(Format(name="ring", storage="mem", trash_days=0), force=True)
    mp.load()
    mr = ref_new_client(url)
    mr.load()
    bp, br = create_storage("mem://"), ref_object.create_storage("mem://")
    P = CachedStore(bp, ChunkConfig(block_size=BS, cache_dirs=(str(tmp_path / "p"),)))
    R = _ref_store(br, cache_dirs=(str(tmp_path / "r"),))
    sp, sr = PeerBlockServer(P, group="mix"), RefPeerBlockServer(R, group="mix")
    ap, ar = sp.start(), sr.start()
    mp.session_extras.update(cache_group="mix", peer_addr=ap, group_weight=1)
    mr.session_extras.update(cache_group="mix", peer_addr=ar, group_weight=2)
    mp.new_session()
    mr.new_session()
    P.cache_group = CacheGroup("mix", self_addr=ap, meta=mp, weight=1)
    R.cache_group = RefCacheGroup("mix", self_addr=ar, meta=mr, weight=2)
    try:
        assert P.cache_group.ring.members == R.cache_group.ring.members == {ap: 1, ar: 2}
        blobs = {sid: os.urandom(BS) for sid in range(100, 124)}
        owner = {sid: P.cache_group.ring.owner(block_key(sid, 0, BS)) for sid in blobs}
        assert owner == {sid: R.cache_group.ring.owner(block_key(sid, 0, BS))
                         for sid in blobs}
        assert set(owner.values()) == {ap, ar}
        for sid, blob in blobs.items():  # each block cached by its owner
            _write_slice(P if owner[sid] == ap else R, sid, blob)
        gp, gr = _spy_gets(bp), _spy_gets(br)
        for sid, blob in blobs.items():
            for reader in (P, R):
                assert bytes(reader.new_reader(sid, BS).read(0, BS)) == blob
        assert gp[0] == 0 and gr[0] == 0
    finally:
        sp.stop()
        sr.stop()
        P.close()
        R.close()
        mp.close_session()
        mr.close_session()
        msrv.stop()


def _warmup_volume(tmp_path):
    """A port volume (1 MiB blocks, no compression, cpu hash backend)
    with one file written through an inline-dedup store, so some of its
    blocks are PUT-elided aliases; returns the meta URL, the file's block
    keys and the number of elided blocks."""
    import types

    from juicefs_tpu_torch import cmd
    from juicefs_tpu_torch.meta import CHUNK_SIZE, Slice

    bs = 1 << 20
    meta_url = f"sqlite3://{tmp_path}/warm.db"
    assert cmd.main(["format", meta_url, "warm", "--storage", "file", "--bucket",
                     str(tmp_path / "blob"), "--block-size", str(bs >> 10),
                     "--compress", "none", "--hash-backend", "cpu",
                     "--trash-days", "0"]) == 0
    rng = __import__("numpy").random.default_rng(5)
    uniq = [rng.bytes(bs) for _ in range(9)]
    blocks = uniq[:4] + [uniq[0], uniq[4], uniq[1], uniq[5], uniq[0]] + uniq[6:]
    blocks.append(rng.bytes(bs // 3 + 5))
    m, fmt = cmd.open_meta(meta_url)
    store = cmd.build_store(fmt, types.SimpleNamespace(
        compress_backend="cpu", inline_dedup=True, ingest_flush_ms=0), meta=m)
    keys = []
    try:
        st, ino, _ = m.create(CTX, 1, b"data.bin", 0o644)
        assert st == 0
        for i, data in enumerate(blocks):
            sid = m.new_slice()
            w = store.new_writer(sid)
            w.write_at(data, 0)
            w.finish(len(data))
            indx, pos = divmod(i * bs, CHUNK_SIZE)
            assert m.write_chunk(ino, indx, pos, Slice(pos=pos, id=sid, size=len(data),
                                                       off=0, len=len(data))) == 0
            keys.append(block_key(sid, 0, len(data)))
        assert m.close(CTX, ino) == 0
        store.flush_all()
        elided = store.ingest.stats()["put_elided"]
    finally:
        store.close()
        m.client.close()
    assert elided == 3
    return meta_url, keys, elided


def test_warmup_through_both_clis_fetches_the_same_blocks(tmp_path, monkeypatch, capsys):
    """`warmup META / --cache-group wg --group-self A` through the port's
    CLI and the reference's, on one volume whose members are published in
    its sessions, print the same line. The reference fetches the blocks the
    ring gives A, PUT-elided ones through their canonical objects; the port
    goes by the key a block's bytes live under, so it fetches once each
    stored object the ring gives A, a canonical shared by elided blocks
    included, and caches it under that key alone. The fill lands in the
    port's --cache-dir, and nothing ran on a device."""
    from juicefs_tpu import cmd as ref_cmd
    from juicefs_tpu.cache import HashRing as RefHashRing
    from juicefs_tpu.chunk import ContentRefs as RefContentRefs
    from juicefs_tpu.meta import new_client as ref_new_client
    from juicefs_tpu.object.file import FileStorage as RefFileStorage
    from juicefs_tpu_torch import cmd
    from juicefs_tpu_torch.gpu import kernels
    from juicefs_tpu_torch.object.file import FileStorage

    meta_url, keys, _elided = _warmup_volume(tmp_path)
    capsys.readouterr()
    members = {"10.9.0.1:7000": 1, "10.9.0.2:7000": 2}
    pubs = []
    for addr, w in members.items():
        m = new_client(meta_url)
        m.load()
        m.session_extras.update(cache_group="wg", peer_addr=addr, group_weight=w)
        m.new_session()
        pubs.append(m)
    ring = RefHashRing()
    ring.rebuild(members)
    owned = {k for k in keys if ring.owner(k) == "10.9.0.1:7000"}
    assert 0 < len(owned) < len(keys)
    m = ref_new_client(meta_url)
    try:
        refs = RefContentRefs(m)
        stored_as = {k: refs.resolve(k) or k for k in keys}
    finally:
        m.client.close()
    assert len(set(stored_as.values())) == len(keys) - _elided
    objects = {c for c in stored_as.values() if ring.owner(c) == "10.9.0.1:7000"}
    assert 0 < len(objects) < len(keys) - _elided

    fetched: dict = {"port": [], "ref": []}

    def spy(side, real):
        def get(self, key, off=0, limit=-1):
            data = real(self, key, off, limit)
            if "chunks/" in key:  # block data, not the format probe
                fetched[side].append(key)
            return data
        return get

    monkeypatch.setattr(FileStorage, "get", spy("port", FileStorage.get))
    monkeypatch.setattr(RefFileStorage, "get", spy("ref", RefFileStorage.get))
    launches0 = dict(kernels.LAUNCHES)
    try:
        argv = ["warmup", meta_url, "/", "--cache-group", "wg", "--group-self",
                "10.9.0.1:7000", "--threads", "4"]
        assert cmd.main(argv + ["--cache-dir", str(tmp_path / "cache")]) == 0
        port_out = capsys.readouterr().out
        assert ref_cmd.main(argv) == 0
        ref_out = capsys.readouterr().out
    finally:
        for m in pubs:
            m.close_session()
            m.client.close()
    assert port_out == ref_out == \
        f"warmed 1 files / {len(keys)} slices (ring shard of group 'wg')\n"
    # the reference: each owned block once, its own object or its canonical
    assert sorted(fetched["ref"]) == sorted("warm/" + stored_as[k] for k in owned)
    # the port: each stored object A owns once
    assert sorted(fetched["port"]) == sorted("warm/" + c for c in objects)
    assert dict(kernels.LAUNCHES) == launches0
    # the fill landed in the port's --cache-dir: a store over it holds
    # exactly those objects, under their own keys
    store = CachedStore(create_storage("mem://"), ChunkConfig(
        block_size=1 << 20, cache_dirs=(str(tmp_path / "cache"),)))
    try:
        cached = {k for k in keys if store.cache.load(k, count_miss=False) is not None}
    finally:
        store.close()
    assert cached == objects


def test_warmup_needs_no_card_whatever_the_hash_backend(tmp_path, capsys):
    """Warmup moves blocks and hashes none: on a host with no card it warms
    a volume whose hash backend is a device one (set by the reference's
    `config`, which does not probe a card), PUT-elided blocks included,
    into the cache dir it is given: each stored object is cached under its
    own key, and a store over that dir with the volume's content-ref plane
    and an empty backend serves every block, an elided one through its
    canonical's entry."""
    from juicefs_tpu import cmd as ref_cmd
    from juicefs_tpu_torch import cmd
    from juicefs_tpu_torch.chunk import ContentRefs

    meta_url, keys, _elided = _warmup_volume(tmp_path)
    assert ref_cmd.main(["config", meta_url, "--hash-backend", "pallas"]) == 0
    capsys.readouterr()
    assert cmd.main(["warmup", meta_url, "/", "--cache-dir", str(tmp_path / "wc")]) == 0
    assert capsys.readouterr().out == f"warmed 1 files / {len(keys)} slices\n"
    store = CachedStore(create_storage("mem://"), ChunkConfig(
        block_size=1 << 20, cache_dirs=(str(tmp_path / "wc"),)))
    m = new_client(meta_url)
    m.load()
    store.content_refs = ContentRefs(m)
    try:
        stored_as = {store.content_refs.resolve(k) or k for k in keys}
        assert len(stored_as) == len(keys) - _elided
        assert all(store.cache.load(k, count_miss=False) is not None
                   for k in stored_as)
        for k in keys:
            bsize = int(k.rsplit("_", 1)[1])
            assert len(store._load_block(k, bsize)) == bsize
    finally:
        store.close()
        m.client.close()
