"""The port's bundled Redis-protocol meta server (juicefs_tpu_torch/meta/
redis_server.py) against the JAX package's, across the wire in both
directions.

  - RESP: one command sequence gets the same replies from both servers,
    and the seeded random op drill of tests/test_meta_random.py agrees
    step for step between a port client and a reference client on either
    package's server.
  - AOF: the twins of tests/test_meta_server_persist.py (restart, torn
    tail, compaction, unterminated txn) on the port's server; the same
    commands write the same AOF bytes in both packages; an AOF written by
    either package's server replays in the other's with the same
    namespace, slices, digest rows and content refs.
  - Replication: a port replica of a reference primary, and the other way
    round, hold the primary's volume after the SYNC snapshot and the live
    stream.
  - Two clients, one of each package, on one server (the twins of
    tests/test_meta_dist.py): cross-client visibility, flock/plock,
    stale-session takeover, conflict retry, push invalidation and the
    push lock wake.
"""

from __future__ import annotations

import errno
import struct
import threading
import time

import pytest

from juicefs_tpu.meta import redis_server as ref_server
from juicefs_tpu_torch.meta import redis_server as port_server
from juicefs_tpu_torch.meta.redis_kv import RedisError, RedisKV, RespConnection
from juicefs_tpu_torch.utils import txnwatch
from tests.test_torch_meta import PACKAGES, Driver, _populate, _volume, gen_ops

SERVERS = {"ref": ref_server.RedisServer, "port": port_server.RedisServer}


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


def _ctx(pkg: str):
    return PACKAGES[pkg][3].Context(uid=0, gid=0)


def _wait_for(cond, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _epoch(port: int, db: int = 0) -> int:
    conn = RespConnection("127.0.0.1", port, db=db)
    try:
        raw = conn.execute(b"GET", RedisKV.EPOCH_KEY)
    finally:
        conn.close()
    return int(raw) if raw else 0


# ---------------------------------------------------------------------------
# RESP across the wire
# ---------------------------------------------------------------------------

COMMANDS = [
    (b"PING",), (b"ECHO", b"hi"), (b"SELECT", b"3"), (b"DBSIZE",),
    (b"SET", b"a", b"1"), (b"SET", b"b", b"\x00\xff"), (b"GET", b"a"),
    (b"GET", b"missing"), (b"MGET", b"a", b"b", b"missing"),
    (b"EXISTS", b"a", b"missing", b"b"), (b"INCRBY", b"n", b"5"),
    (b"INCRBY", b"n", b"-7"),
    (b"ZADD", b"z", b"0", b"m2", b"0", b"m1", b"0", b"m3"), (b"ZCARD", b"z"),
    (b"ZRANGEBYLEX", b"z", b"-", b"+"), (b"ZRANGEBYLEX", b"z", b"[m2", b"+"),
    (b"ZRANGEBYLEX", b"z", b"(m1", b"[m3", b"LIMIT", b"0", b"1"),
    (b"ZREM", b"z", b"m2", b"nope"), (b"DEL", b"b", b"missing"),
    (b"WATCH", b"a"), (b"MULTI",), (b"SET", b"a", b"2"), (b"GET", b"a"),
    (b"EXEC",), (b"MULTI",), (b"SET", b"c", b"3"), (b"DISCARD",),
    (b"GET", b"c"), (b"EXEC",), (b"UNWATCH",), (b"DBSIZE",),
    (b"NOSUCHCMD", b"x"), (b"SELECT", b"99"), (b"FLUSHDB",),
    (b"DBSIZE",), (b"PUBLISH", b"ch", b"msg"),
]


def _replies(port: int) -> list:
    conn = RespConnection("127.0.0.1", port)
    out = []
    try:
        for cmd in COMMANDS:
            try:
                out.append(conn.execute(*cmd))
            except RedisError as e:
                out.append(("error", str(e)))
    finally:
        conn.close()
    return out


def test_one_command_sequence_gets_the_same_replies():
    got = {}
    for pkg, cls in SERVERS.items():
        srv = cls()
        try:
            got[pkg] = _replies(srv.start())
        finally:
            srv.stop()
    assert got["port"] == got["ref"]
    assert got["port"][0] == "PONG"
    assert any(isinstance(r, tuple) for r in got["port"]), "no error reply"


def test_bad_command_is_answered_and_the_connection_lives():
    """A command short of its arguments, or with a number that is not
    one, gets Redis's error from the port's server, and the connection
    goes on serving (the reference's server drops the connection)."""
    srv = port_server.RedisServer()
    conn = RespConnection("127.0.0.1", srv.start())
    try:
        for cmd in ((b"GET",), (b"SET", b"k"), (b"ZADD", b"z", b"0")):
            with pytest.raises(RedisError, match="wrong number of arguments"):
                conn.execute(*cmd)
        conn.execute(b"SET", b"a", b"1")
        for cmd in ((b"INCRBY", b"a", b"x"), (b"SELECT", b"one")):
            with pytest.raises(RedisError, match="not an integer"):
                conn.execute(*cmd)
        assert conn.execute(b"INCRBY", b"a", b"2") == 3
        assert conn.execute(b"PING") == "PONG"
    finally:
        conn.close()
        srv.stop()


@pytest.mark.parametrize("server_pkg", ["ref", "port"])
def test_random_drill_agrees_across_the_wire(server_pkg):
    """A port client and a reference client, each on its own db of one
    server, replay the same seeded op drill: every step and the final
    tree agree, whichever package serves them."""
    srv = SERVERS[server_pkg]()
    port = srv.start()
    clients = {pkg: PACKAGES[pkg][0].new_client(f"redis://127.0.0.1:{port}/{db}")
               for db, pkg in enumerate(PACKAGES)}
    try:
        drivers = {}
        for pkg, m in clients.items():
            assert m.init(PACKAGES[pkg][1].Format(name="wire", trash_days=0,
                                                  enable_acl=True),
                          force=True) == 0
            m.load()
            drivers[pkg] = Driver(m, pkg)
        for i, op in enumerate(gen_ops(31 + len(server_pkg), 500)):
            want = drivers["ref"].apply(op)
            got = drivers["port"].apply(op)
            assert got == want, f"step {i} {op}: reference {want!r}, port {got!r}"
        tree = drivers["ref"].tree()
        assert tree and drivers["port"].tree() == tree
    finally:
        for m in clients.values():
            m.client.close()
        srv.stop()


# ---------------------------------------------------------------------------
# AOF: twins of tests/test_meta_server_persist.py on the port's server
# ---------------------------------------------------------------------------

def _port_client(port: int, db: int = 0):
    return PACKAGES["port"][0].new_client(f"redis://127.0.0.1:{port}/{db}")


def test_volume_survives_server_restart(tmp_path):
    _, types, _, _ = PACKAGES["port"]
    ctx = _ctx("port")
    aof = str(tmp_path / "meta.aof")
    srv = port_server.RedisServer(data_path=aof, fsync="always")
    m = _port_client(srv.start())
    m.init(types.Format(name="durable", trash_days=0), force=True)
    m.load()
    m.new_session()
    st, dino, _ = m.mkdir(ctx, types.ROOT_INODE, b"docs", 0o755)
    st, fino, _ = m.create(ctx, dino, b"a.txt", 0o644)
    m.close(ctx, fino)
    assert m.setxattr(ctx, fino, b"user.k", b"v") == 0
    m.close_session()
    m.client.close()
    srv.stop()

    srv2 = port_server.RedisServer(data_path=aof, fsync="always")
    m2 = _port_client(srv2.start())
    try:
        assert m2.load().name == "durable"
        st, ino, _ = m2.lookup(ctx, types.ROOT_INODE, b"docs")
        assert st == 0 and ino == dino
        st, ino2, attr = m2.lookup(ctx, dino, b"a.txt")
        assert st == 0 and ino2 == fino and attr.mode == 0o644
        st, val = m2.getxattr(ctx, fino, b"user.k")
        assert st == 0 and bytes(val) == b"v"
        st, entries = m2.readdir(ctx, dino)
        assert {e.name for e in entries} >= {b"a.txt"}
        st, f2, _ = m2.create(ctx, dino, b"b.txt", 0o600)
        assert st == 0
        m2.close(ctx, f2)
    finally:
        m2.client.close()
        srv2.stop()


def test_torn_tail_write_tolerated(tmp_path):
    _, types, _, _ = PACKAGES["port"]
    ctx = _ctx("port")
    aof = str(tmp_path / "meta.aof")
    srv = port_server.RedisServer(data_path=aof, fsync="always")
    m = _port_client(srv.start())
    m.init(types.Format(name="torn", trash_days=0), force=True)
    m.load()
    st, dino, _ = m.mkdir(ctx, types.ROOT_INODE, b"keep", 0o755)
    assert st == 0
    m.client.close()
    srv.stop()

    with open(aof, "r+b") as f:  # a crash mid-append
        f.seek(0, 2)
        f.truncate(f.tell() - 7)

    srv2 = port_server.RedisServer(data_path=aof)
    m2 = _port_client(srv2.start())
    try:
        m2.load()
        st, entries = m2.readdir(ctx, types.ROOT_INODE)
        assert st == 0
    finally:
        m2.client.close()
        srv2.stop()


def test_snapshot_compaction_bounds_growth(tmp_path):
    import os

    _, types, _, _ = PACKAGES["port"]
    ctx = _ctx("port")
    aof = str(tmp_path / "meta.aof")
    srv = port_server.RedisServer(data_path=aof, fsync="always")
    m = _port_client(srv.start())
    m.init(types.Format(name="compact", trash_days=0), force=True)
    m.load()
    m.new_session()
    for _ in range(50):
        st, ino, _ = m.create(ctx, types.ROOT_INODE, b"churn", 0o644)
        m.close(ctx, ino)
        assert m.unlink(ctx, types.ROOT_INODE, b"churn") == 0
    m.close_session()
    m.client.close()
    srv.stop()
    churned = os.path.getsize(aof)

    srv2 = port_server.RedisServer(data_path=aof)
    srv2.start()
    srv2.stop()
    compacted = os.path.getsize(aof)
    assert compacted < churned / 2, (churned, compacted)


def test_unterminated_txn_discarded_on_replay(tmp_path):
    _, types, _, _ = PACKAGES["port"]
    aof = str(tmp_path / "meta.aof")
    srv = port_server.RedisServer(data_path=aof, fsync="always")
    m = _port_client(srv.start())
    m.init(types.Format(name="atomic", trash_days=0), force=True)
    m.load()
    m.client.txn(lambda tx: tx.set(b"committed", b"yes"))
    m.client.close()
    srv.stop()

    enc = port_server._Conn._enc
    with open(aof, "ab") as f:  # MULTI + one record, no EXEC: the crash point
        f.write(enc([b"SELECT", b"0"]))
        f.write(enc([b"MULTI"]))
        f.write(enc([b"SET", b"half-applied", b"poison"]))

    srv2 = port_server.RedisServer(data_path=aof)
    m2 = _port_client(srv2.start())
    try:
        assert m2.client.execute(b"GET", b"committed") == b"yes"
        assert m2.client.execute(b"GET", b"half-applied") is None
    finally:
        m2.client.close()
        srv2.stop()


def test_same_commands_write_the_same_aof(tmp_path):
    """Both servers log one command sequence, transactions included, to
    byte-identical AOFs (fsync always, so the file is complete at stop)."""
    logs = {}
    for pkg, cls in SERVERS.items():
        aof = str(tmp_path / f"{pkg}.aof")
        srv = cls(data_path=aof, fsync="always")
        try:
            conn = RespConnection("127.0.0.1", srv.start())
            for cmd in COMMANDS:
                if cmd[0] in (b"FLUSHDB", b"SELECT"):
                    continue  # keep the state for the log to hold
                try:
                    conn.execute(*cmd)
                except RedisError:
                    pass
            conn.execute(b"SELECT", b"2")
            conn.execute(b"SET", b"other-db", b"v")
            conn.close()
        finally:
            srv.stop()
        with open(aof, "rb") as f:
            logs[pkg] = f.read()
    assert logs["port"] == logs["ref"]
    assert b"MULTI" in logs["port"] and b"other-db" in logs["port"]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_aof_replays_in_the_other_package(tmp_path, writer, reader):
    """A volume written through one package's server and client replays
    from its AOF in the other package's server, and the other package's
    client reads the same namespace, slices, digest rows and refs."""
    aof = str(tmp_path / "meta.aof")
    srv = SERVERS[writer](data_path=aof, fsync="always")
    port = srv.start()
    w = PACKAGES[writer][0].new_client(f"redis://127.0.0.1:{port}/1")
    _populate(writer, w)
    want = _volume(writer, w)
    w.client.close()
    srv.stop()

    srv2 = SERVERS[reader](data_path=aof)
    port2 = srv2.start()
    r = PACKAGES[reader][0].new_client(f"redis://127.0.0.1:{port2}/1")
    try:
        assert _volume(reader, r) == want
        assert len(want["digests"]) == 5 and len(want["aliases"]) == 4
    finally:
        r.client.close()
        srv2.stop()


# ---------------------------------------------------------------------------
# replication across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("primary,replica", [("ref", "port"), ("port", "ref")])
def test_replica_of_the_other_package(primary, replica):
    """The replica SYNCs the primary's snapshot (written before it
    started), then applies the live stream (written after); a client of
    the replica's package reads the primary's volume from the replica."""
    pri = SERVERS[primary]()
    pport = pri.start()
    rep = None
    w = PACKAGES[primary][0].new_client(f"redis://127.0.0.1:{pport}/2")
    try:
        _populate(primary, w)  # the snapshot half
        rep = SERVERS[replica](replica_of=f"127.0.0.1:{pport}")
        rport = rep.start()
        _wait_for(lambda: _epoch(rport, 2) == _epoch(pport, 2) > 0, 30.0,
                  "the replica to take the snapshot")
        ctx = _ctx(primary)
        types = PACKAGES[primary][1]
        st, d, _ = w.mkdir(ctx, types.ROOT_INODE, b"live", 0o755)  # the stream
        assert st == 0
        st, f, _ = w.create(ctx, d, b"f", 0o600)
        assert st == 0
        w.close(ctx, f)
        w.set_block_digests([(77, 1, 9, b"\x07" * 32)])
        want = _volume(primary, w)
        target = _epoch(pport, 2)
        _wait_for(lambda: _epoch(rport, 2) >= target, 30.0,
                  "the replica to apply the stream")
        r = PACKAGES[replica][0].new_client(f"redis://127.0.0.1:{rport}/2")
        try:
            assert _volume(replica, r) == want
        finally:
            r.client.close()
    finally:
        w.client.close()
        if rep is not None:
            rep.stop()
        pri.stop()


# ---------------------------------------------------------------------------
# two clients of different packages on one server (tests/test_meta_dist.py)
# ---------------------------------------------------------------------------

CROSS = [("port", "port", "ref"), ("ref", "ref", "port")]


@pytest.fixture(params=CROSS, ids=lambda p: f"{p[0]}-server-{p[1]}-{p[2]}")
def cross(request):
    """(server url, c1, c2): c1 and c2 are clients of different packages;
    c1 formats the volume, both hold a session."""
    server_pkg, p1, p2 = request.param
    srv = SERVERS[server_pkg]()
    url = f"redis://127.0.0.1:{srv.start()}/0"
    c1 = PACKAGES[p1][0].new_client(url)
    c1.init(PACKAGES[p1][1].Format(name="dist", trash_days=0), force=True)
    c1.load()
    c1.new_session()
    c2 = PACKAGES[p2][0].new_client(url)
    c2.load()
    c2.new_session()
    try:
        yield url, (c1, p1), (c2, p2)
    finally:
        c1.close_session()
        c2.close_session()
        c1.client.close()
        c2.client.close()
        srv.stop()


def test_cross_client_visibility(cross):
    _, (c1, p1), (c2, p2) = cross
    ctx1, ctx2 = _ctx(p1), _ctx(p2)
    root = PACKAGES[p1][1].ROOT_INODE
    st, dino, _ = c1.mkdir(ctx1, root, b"shared", 0o755)
    assert st == 0
    st, ino2, _ = c2.lookup(ctx2, root, b"shared")
    assert st == 0 and ino2 == dino
    st, f, _ = c2.create(ctx2, dino, b"f", 0o644)
    assert st == 0
    sid = c2.new_slice()
    assert c2.write_chunk(f, 0, 0, PACKAGES[p2][1].Slice(
        pos=0, id=sid, size=4096, off=0, len=4096)) == 0
    c2.close(ctx2, f)
    st, slices = c1.read_chunk(f, 0)
    assert st == 0 and any(s.id == sid for s in slices)
    assert c1.rename(ctx1, dino, b"f", root, b"g")[0] == 0
    assert c2.lookup(ctx2, dino, b"f")[0] == errno.ENOENT
    st, ino, _ = c2.lookup(ctx2, root, b"g")
    assert st == 0 and ino == f


def test_distributed_flock(cross):
    _, (c1, p1), (c2, p2) = cross
    ctx1, ctx2 = _ctx(p1), _ctx(p2)
    st, ino, _ = c1.create(ctx1, PACKAGES[p1][1].ROOT_INODE, b"lk", 0o644)
    assert c1.flock(ctx1, ino, owner=1, ltype="W") == 0
    assert c2.flock(ctx2, ino, owner=1, ltype="W") == errno.EAGAIN
    assert c2.flock(ctx2, ino, owner=1, ltype="R") == errno.EAGAIN
    assert c1.flock(ctx1, ino, owner=1, ltype="U") == 0
    assert c2.flock(ctx2, ino, owner=1, ltype="W") == 0
    assert c1.flock(ctx1, ino, owner=1, ltype="R") == errno.EAGAIN
    assert c2.flock(ctx2, ino, owner=1, ltype="U") == 0


def test_distributed_plock(cross):
    _, (c1, p1), (c2, p2) = cross
    ctx1, ctx2 = _ctx(p1), _ctx(p2)
    st, ino, _ = c1.create(ctx1, PACKAGES[p1][1].ROOT_INODE, b"plk", 0o644)
    assert c1.setlk(ctx1, ino, owner=7, ltype=c1.F_WRLCK, start=0, end=100) == 0
    assert c2.setlk(ctx2, ino, owner=7, ltype=c2.F_WRLCK, start=50,
                    end=60) == errno.EAGAIN
    assert c2.setlk(ctx2, ino, owner=7, ltype=c2.F_WRLCK, start=200, end=300) == 0
    st, lt, _s, _e, _pid = c2.getlk(ctx2, ino, owner=9, ltype=c2.F_WRLCK,
                                    start=0, end=10)
    assert st == 0 and lt == c2.F_WRLCK
    st, lt, _s, _e, _pid = c1.getlk(ctx1, ino, owner=9, ltype=c1.F_WRLCK,
                                    start=250, end=260)
    assert st == 0 and lt == c1.F_WRLCK


def test_stale_session_takeover(cross):
    _, (c1, p1), (c2, p2) = cross
    ctx1 = _ctx(p1)
    types = PACKAGES[p1][1]
    st, ino, _ = c1.create(ctx1, types.ROOT_INODE, b"sus", 0o644)
    sid = c1.new_slice()
    c1.write_chunk(ino, 0, 0, types.Slice(pos=0, id=sid, size=4096, off=0, len=4096))
    assert c1.unlink(ctx1, types.ROOT_INODE, b"sus") == 0
    assert c2.cleanup_deleted_files() == 0  # c1's live session holds it
    c1.flock(ctx1, ino, owner=1, ltype="W")
    stale = struct.pack(">d", time.time() - 3600)  # c1 "dies"
    c1.client.txn(lambda tx: tx.set(c1._heartbeat_key(c1.sid), stale))
    assert c2.clean_stale_sessions(age=300) >= 1
    assert c2.cleanup_deleted_files() == 1
    assert all(s.sid != c1.sid for s in c2.do_list_sessions())


@pytest.mark.parametrize("server_pkg", ["ref", "port"])
def test_txn_conflict_retry_fires(server_pkg):
    """Read-modify-write txns from both packages' clients race on one
    key: they conflict, retry and converge with no lost update."""
    from juicefs_tpu.meta.redis_kv import RedisKV as RefRedisKV

    srv = SERVERS[server_pkg]()
    addr = f"127.0.0.1:{srv.start()}/0"
    n_threads, n_incr = 4, 25
    attempts = [0] * n_threads
    clients = [(RedisKV if i % 2 else RefRedisKV)(addr) for i in range(n_threads)]
    start = threading.Barrier(n_threads)

    def worker(idx):
        start.wait()
        for _ in range(n_incr):
            def fn(tx):
                attempts[idx] += 1
                cur = int(tx.get(b"ctr") or b"0")
                time.sleep(0.001)  # widen the conflict window
                tx.set(b"ctr", str(cur + 1).encode())
                return 0
            clients[idx].txn(fn)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert int(clients[0].execute(b"GET", b"ctr")) == n_threads * n_incr
        assert sum(attempts) > n_threads * n_incr  # retries fired
    finally:
        for c in clients:
            c.close()
        srv.stop()


def test_push_invalidation_beats_ttl(cross, tmp_path):
    """Client B (one package) sees client A's (the other package) chmod
    and rename well inside a 30 s attr/entry TTL: the heartbeat's change
    hints cross between the packages."""
    url, (c1, p1), (c2, p2) = cross
    ttl, beat = 30.0, 0.15

    def mount(pkg):
        import importlib

        vfs_mod = importlib.import_module(f"{PACKAGES[pkg][0].__name__[:-5]}.vfs")
        chunk = importlib.import_module(f"{PACKAGES[pkg][0].__name__[:-5]}.chunk")
        obj = importlib.import_module(f"{PACKAGES[pkg][0].__name__[:-5]}.object")
        m = PACKAGES[pkg][0].new_client(url)
        m.load()
        m.new_session(heartbeat=beat)
        conf = {"block_size": 1 << 18}
        if pkg == "port":
            conf.update(compress_backend="cpu", device="cpu")
        store = chunk.CachedStore(obj.create_storage(f"file://{tmp_path}/{pkg}"),
                                  chunk.ChunkConfig(**conf))
        return vfs_mod.VFS(m, store, vfs_mod.VFSConfig(attr_timeout=ttl,
                                                       entry_timeout=ttl))

    # Both packages' rerun harnesses patch the process's one `time.time`
    # while they double a closure; with both packages' heartbeat threads
    # doubling session refreshes at once, one harness restores the real
    # clock in the middle of the other's doubled run. The port's harness
    # is off for this drill (the reference's stays armed, as for every
    # test); the port's session closures are doubled by the module's
    # other drills.
    txnwatch.uninstall()
    va, vb = mount(p1), mount(p2)
    ctx_a, ctx_b = _ctx(p1), _ctx(p2)
    try:
        st, ino, _attr, fh = va.create(ctx_a, 1, b"f", 0o640)
        assert st == 0
        va.release(ctx_a, ino, fh)
        time.sleep(2 * beat + 0.1)  # let A's create event drain
        st, ino_b, _ = vb.lookup(ctx_b, 1, b"f")
        assert st == 0
        assert vb.getattr(ctx_b, ino_b)[1].mode & 0o777 == 0o640

        types_a = PACKAGES[p1][1]
        st, _ = va.setattr(ctx_a, ino, types_a.SET_ATTR_MODE, types_a.Attr(mode=0o600))
        assert st == 0
        _wait_for(lambda: vb.getattr(ctx_b, ino_b)[1].mode & 0o777 == 0o600,
                  10 * beat + 5.0, "the chmod push")
        st, _, _ = va.rename(ctx_a, 1, b"f", 1, b"g", 0)
        assert st == 0
        _wait_for(lambda: vb.lookup(ctx_b, 1, b"f")[0] == errno.ENOENT
                  and vb.lookup(ctx_b, 1, b"g")[0] == 0,
                  10 * beat + 5.0, "the rename push")
    finally:
        for v in (va, vb):
            v.close()
            v.store.close()
            v.meta.close_session()
            v.meta.client.close()
        txnwatch.install()


def test_cross_client_lock_wake_via_push(cross):
    """One package's unlock wakes the other package's parked waiter
    through the server's pub/sub channel, well before the 5 s poll."""
    _, (c1, p1), (c2, p2) = cross
    ctx1, ctx2 = _ctx(p1), _ctx(p2)
    _, ino, _ = c1.create(ctx1, PACKAGES[p1][1].ROOT_INODE, b"locked", 0o644)
    c1.close(ctx1, ino)
    assert c1.setlk(ctx1, ino, owner=1, ltype=c1.F_WRLCK, start=0, end=100) == 0
    assert c2.setlk(ctx2, ino, owner=2, ltype=c2.F_WRLCK, start=0,
                    end=100) == errno.EAGAIN
    gen = c2.lock_generation(ino)
    woke = {}

    def waiter():
        t0 = time.perf_counter()
        c2.lock_wait(ino, 5.0, gen)
        woke["dt"] = time.perf_counter() - t0
        woke["st"] = c2.setlk(ctx2, ino, owner=2, ltype=c2.F_WRLCK,
                              start=0, end=100)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.2)  # let the waiter park
    assert c1.setlk(ctx1, ino, owner=1, ltype=c1.F_UNLCK, start=0, end=100) == 0
    t.join(6)
    assert not t.is_alive()
    assert woke["st"] == 0
    assert woke["dt"] < 1.0, f"waiter slept {woke['dt']:.2f}s: no push wake"
    assert c2.setlk(ctx2, ino, owner=2, ltype=c2.F_UNLCK, start=0, end=100) == 0


def test_server_double_stop_then_restart_pub_loop_alive():
    srv = port_server.RedisServer()
    srv.start()
    srv.stop()
    srv.stop()  # idempotent teardown
    try:
        srv.start()
        time.sleep(0.1)
        assert srv._pub_thread.is_alive(), \
            "pub delivery loop died right after restart (stale sentinel)"
    finally:
        srv.stop()


def test_meta_server_subcommand_serves_both_clients(tmp_path):
    """`python -m juicefs_tpu_torch.cmd meta-server` as a process, with
    an AOF and a replica process: a reference client formats through
    the primary, a port client reads the volume back from the replica
    through its replica routing, and SIGTERM ends both: each dies on the
    signal, as the reference's does, with the primary's AOF on disk."""
    import os
    import signal
    import subprocess
    import sys

    from juicefs_tpu import meta as ref_meta
    from juicefs_tpu_torch.meta.cache import _REPLICA_READS

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def spawn(*extra):
        p = subprocess.Popen(
            [sys.executable, "-m", "juicefs_tpu_torch.cmd", "meta-server",
             "--host", "127.0.0.1", "--port", "0", *extra],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        line = p.stdout.readline()
        assert "meta-server listening on 127.0.0.1:" in line, line
        return p, int(line.split("127.0.0.1:")[1].split()[0])

    aof = str(tmp_path / "meta.aof")
    pri, pport = spawn("--data", aof, "--fsync", "always")
    rep = None
    try:
        rep, rport = spawn("--replica-of", f"127.0.0.1:{pport}")
        w = ref_meta.new_client(f"redis://127.0.0.1:{pport}/1")
        _populate("ref", w)
        want = _volume("ref", w)
        w.client.close()
        target = _epoch(pport, 1)
        _wait_for(lambda: _epoch(rport, 1) >= target, 30.0, "the replica")
        r = PACKAGES["port"][0].new_client(f"redis://127.0.0.1:{pport}/1")
        try:
            r.client.configure_replica(f"127.0.0.1:{rport}")
            before = _REPLICA_READS.value
            assert _volume("port", r) == want
            assert _REPLICA_READS.value > before
        finally:
            r.client.close()
    finally:
        rcs = []
        for p in (rep, pri):
            if p is not None:
                p.send_signal(signal.SIGTERM)
                try:
                    rcs.append(p.wait(timeout=30))
                except subprocess.TimeoutExpired:
                    p.kill()
                    rcs.append(p.wait())
                p.stdout.close()
    assert rcs == [-signal.SIGTERM] * 2, "a meta-server outlived SIGTERM"
    assert os.path.getsize(aof) > 0


def test_sweeps_read_the_primary_past_a_lagging_replica():
    """Sweeps (`scan`: session cleanup and listing, gc, fsck, dump) read
    the primary, as the reference's do; only point reads go to a replica.
    A replica that passes this client's epoch guard but lags another
    client's heartbeat gets no live session cleaned."""
    from juicefs_tpu_torch.meta.cache import _REPLICA_READS

    meta, types = PACKAGES["port"][0], PACKAGES["port"][1]
    pri, lag = port_server.RedisServer(), port_server.RedisServer()
    pport, lport = pri.start(), lag.start()
    url = f"redis://127.0.0.1:{pport}/0"
    c1 = meta.new_client(url)
    c1.init(types.Format(name="lag", trash_days=0), force=True)
    c1.load()
    c1.new_session()
    c2 = meta.new_client(f"{url}?replica=127.0.0.1:{lport}")
    c2.load()
    stale_kv = RedisKV(f"127.0.0.1:{lport}/0")
    try:
        # the lagging replica holds c1's heartbeat of an hour ago, and a
        # change epoch past every floor, so the epoch guard lets it serve
        stale = struct.pack(">d", time.time() - 3600)
        stale_kv.txn(lambda tx: tx.set(c1._heartbeat_key(c1.sid), stale))
        conn = RespConnection("127.0.0.1", lport, db=0)
        conn.execute(b"SET", RedisKV.EPOCH_KEY, b"%d" % 10**9)
        conn.close()
        before = _REPLICA_READS.value
        assert c2.clean_stale_sessions(age=300) == 0
        assert any(s.sid == c1.sid for s in c2.do_list_sessions())
        assert list(c2.client.scan(b"SH", b"SI")) == list(c1.client.scan(b"SH", b"SI"))
        assert _REPLICA_READS.value == before, "a sweep read the replica"
        # a point read does go to the replica, whose guard it passes
        key = c1._heartbeat_key(c1.sid)
        assert c2.client.simple_txn(lambda tx: tx.get(key)) == stale
        assert _REPLICA_READS.value > before
    finally:
        c1.close_session()
        c1.client.close()
        c2.client.close()
        stale_kv.close()
        lag.stop()
        pri.stop()
