"""The port's kv meta engine (juicefs_tpu_torch/meta) against the JAX
package's.

  - The seeded random op drill of tests/test_meta_random.py replays on both
    packages' engines (mem://, sqlite3://, and redis:// against the JAX
    package's in-process RESP server): every step's result (errnos
    included) and the final tree must be equal.
  - A sqlite3:// volume written by either package opens in the other with
    the same namespace, slices, digest rows, content refs, aliases and hot
    fingerprints: the on-disk key layout is the reference's own.
  - The content-ref plane and the digest index give the same answers on
    the same call sequence.
  - Unported schemes raise the reference's error.

The port's txn closures run under the port's own rerun harness
(juicefs_tpu_torch/utils/txnwatch.py), installed for the whole module, as
tests/conftest.py installs the reference's for every test: each successful
closure runs twice and any divergence fails the test.
"""

from __future__ import annotations

import errno
import os
import random
import threading

import pytest

from juicefs_tpu import meta as ref_meta
from juicefs_tpu.meta import acl as ref_acl
from juicefs_tpu.meta import context as ref_context
from juicefs_tpu.meta import types as ref_types
from juicefs_tpu.meta.redis_server import RedisServer
from juicefs_tpu_torch import meta as port_meta
from juicefs_tpu_torch.meta import acl as port_acl
from juicefs_tpu_torch.meta import context as port_context
from juicefs_tpu_torch.meta import types as port_types
from juicefs_tpu_torch.utils import lockwatch, txnwatch

PACKAGES = {
    "ref": (ref_meta, ref_types, ref_acl, ref_context),
    "port": (port_meta, port_types, port_acl, port_context),
}
NAMES = [f"n{i}".encode() for i in range(8)]  # small namespace -> collisions


@pytest.fixture(scope="module", autouse=True)
def port_txnwatch():
    """Arm the port's rerun harness for this module (the suite's conftest
    sets JUICEFS_TXN_RERUN=1 and arms only the reference's)."""
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


class Driver:
    """Applies generated ops to one engine through one package's types (a
    copy of tests/test_meta_random.py's driver, parametrised by package)."""

    def __init__(self, m, pkg: str):
        _meta, self.types, self.acl, context = PACKAGES[pkg]
        self.m = m
        self.ctx = context.Context(uid=0, gid=0, pid=1)
        self.dirs = [self.types.ROOT_INODE]

    def _resolve(self, dir_idx: int) -> int:
        return self.dirs[dir_idx % len(self.dirs)]

    def _lookup(self, dir_idx, name):
        st, ino, _ = self.m.lookup(self.ctx, self._resolve(dir_idx), name)
        return st, ino

    def apply(self, op) -> tuple:
        kind, m, ctx = op[0], self.m, self.ctx
        if kind == "mkdir":
            st, ino, _ = m.mkdir(ctx, self._resolve(op[1]), op[2], 0o755)
            if st == 0:
                self.dirs.append(ino)
            return (st,)
        if kind == "create":
            st, ino, attr = m.create(ctx, self._resolve(op[1]), op[2], op[3])
            if st == 0:
                m.close(ctx, ino)
            return (st, attr.mode if st == 0 else 0)
        if kind == "symlink":
            return (m.symlink(ctx, self._resolve(op[1]), op[2], op[3])[0],)
        if kind == "unlink":
            return (m.unlink(ctx, self._resolve(op[1]), op[2]),)
        if kind == "rmdir":
            return (m.rmdir(ctx, self._resolve(op[1]), op[2]),)
        if kind == "rename":
            _, di1, n1, di2, n2 = op
            return (m.rename(ctx, self._resolve(di1), n1, self._resolve(di2), n2, 0)[0],)
        if kind == "lookup":
            st, _, attr = m.lookup(ctx, self._resolve(op[1]), op[2])
            return (st, attr.typ if st == 0 else 0, attr.mode if st == 0 else 0)
        if kind == "readdir":
            st, entries = m.readdir(ctx, self._resolve(op[1]))
            return (st, tuple(sorted(bytes(e.name) for e in entries)))
        if kind == "quota":
            dino = self._resolve(op[1])
            st = m.set_dir_quota(ctx, dino, op[2] << 20, 1000)
            rec = m.get_dir_quota(dino)
            return ("quota", st, rec[0] if rec else None)
        # the rest act on a looked-up entry
        st, ino = self._lookup(op[1], op[2])
        if st != 0:
            return ("lookup", st)
        if kind == "link":
            st2, attr = m.link(ctx, ino, self._resolve(op[3]), op[4])
            return ("link", st2, attr.nlink if st2 == 0 else 0)
        if kind == "chmod":
            st2, attr = m.setattr(ctx, ino, self.types.SET_ATTR_MODE,
                                  self.types.Attr(mode=op[3]))
            return ("chmod", st2, attr.mode if st2 == 0 else 0)
        if kind == "truncate":
            st2, attr = m.truncate(ctx, ino, op[3])
            return ("trunc", st2, attr.length if st2 == 0 else -1)
        if kind == "xattr":
            st2 = m.setxattr(ctx, ino, op[3], op[4])
            st3, got = m.getxattr(ctx, ino, op[3])
            return ("xattr", st2, st3, bytes(got) if st3 == 0 else b"")
        if kind == "facl":
            rule = self.acl.Rule(owner=6, group=4, mask=op[4], other=0,
                                 named_users=((op[3], op[4]),))
            st2 = m.set_facl(ctx, ino, self.acl.TYPE_ACCESS, rule)
            st3, back = m.get_facl(ctx, ino, self.acl.TYPE_ACCESS)
            return ("facl", st2, st3, back.named_users if st3 == 0 else None)
        raise AssertionError(kind)

    def tree(self, ino=None) -> dict:
        """Canonical logical state: structure + deterministic attr fields."""
        ino = self.types.ROOT_INODE if ino is None else ino
        st, entries = self.m.readdir(self.ctx, ino, want_attr=True)
        assert st == 0
        out = {}
        for e in entries:
            if e.name in (b".", b".."):
                continue
            a = e.attr
            node = {"typ": a.typ, "mode": a.mode, "nlink": a.nlink,
                    "length": a.length if a.typ != self.types.TYPE_DIRECTORY else None}
            if a.typ == self.types.TYPE_SYMLINK:
                node["target"] = bytes(self.m.readlink(self.ctx, e.inode)[1])
            if a.typ == self.types.TYPE_DIRECTORY:
                node["children"] = self.tree(e.inode)
            _st, xnames = self.m.listxattr(self.ctx, e.inode)
            node["xattrs"] = {bytes(x): bytes(self.m.getxattr(self.ctx, e.inode, x)[1])
                              for x in xnames}
            out[bytes(e.name)] = node
        return out


def gen_ops(seed: int, n: int) -> list:
    """The op mix of tests/test_meta_random.py gen_ops."""
    rng = random.Random(seed)
    ops = []
    for _ in range(n):
        kind = rng.choice(
            ["mkdir", "create", "create", "symlink", "unlink", "unlink",
             "rmdir", "rename", "rename", "link", "chmod", "truncate",
             "xattr", "lookup", "lookup", "readdir", "facl", "quota"])
        di, name = rng.randrange(16), rng.choice(NAMES)
        if kind == "mkdir" or kind in ("unlink", "rmdir", "lookup"):
            ops.append((kind, di, name))
        elif kind == "create":
            ops.append(("create", di, name, rng.choice([0o644, 0o600, 0o755])))
        elif kind == "symlink":
            ops.append(("symlink", di, name, b"/t/" + name))
        elif kind in ("rename", "link"):
            ops.append((kind, di, name, rng.randrange(16), rng.choice(NAMES)))
        elif kind == "chmod":
            ops.append(("chmod", di, name, rng.choice([0o600, 0o640, 0o777])))
        elif kind == "truncate":
            ops.append(("truncate", di, name, rng.randrange(0, 1 << 20)))
        elif kind == "xattr":
            ops.append(("xattr", di, name, b"user.k%d" % rng.randrange(3),
                        os.urandom(rng.randrange(1, 16))))
        elif kind == "readdir":
            ops.append(("readdir", di))
        elif kind == "facl":
            ops.append(("facl", di, name, 1000 + rng.randrange(4), rng.choice([4, 6, 7])))
        else:
            ops.append(("quota", di, rng.randrange(1, 100)))
    return ops


@pytest.fixture
def engines(request, tmp_path):
    """{"ref": client, "port": client} on the requested engine; each package
    keeps its own database (redis: its own db index on one server)."""
    kind = request.param
    srv = None
    if kind == "redis":
        srv = RedisServer()
        port = srv.start()
        uris = {"ref": f"redis://127.0.0.1:{port}/0", "port": f"redis://127.0.0.1:{port}/1"}
    elif kind == "sqlite3":
        uris = {p: f"sqlite3://{tmp_path}/{p}.db" for p in PACKAGES}
    else:
        uris = {p: "mem://" for p in PACKAGES}
    clients = {p: PACKAGES[p][0].new_client(uris[p]) for p in PACKAGES}
    try:
        yield clients
    finally:
        for m in clients.values():
            m.client.close()
        if srv is not None:
            srv.stop()


@pytest.mark.parametrize("engines,seed,trash_days,n_ops", [
    ("mem", 7, 0, 1200), ("mem", 99, 1, 1200),
    ("sqlite3", 1234, 0, 1200), ("sqlite3", 99, 1, 1200),
    ("redis", 7, 0, 1200),
], indirect=["engines"])
def test_random_ops_agree_with_reference(engines, seed, trash_days, n_ops):
    doubled0 = txnwatch.state().doubled
    drivers = {}
    for pkg, m in engines.items():
        types = PACKAGES[pkg][1]
        assert m.init(types.Format(name="rnd", trash_days=trash_days, enable_acl=True),
                      force=True) == 0
        m.load()
        drivers[pkg] = Driver(m, pkg)
    for i, op in enumerate(gen_ops(seed, n_ops)):
        want = drivers["ref"].apply(op)
        got = drivers["port"].apply(op)
        assert got == want, f"step {i} {op}: reference {want!r}, port {got!r}"
    tree = drivers["ref"].tree()
    assert tree, "random sequence produced an empty tree"
    assert drivers["port"].tree() == tree
    # the port's closures really ran twice under its own harness
    assert txnwatch.state().doubled > doubled0


def _populate(pkg: str, m) -> None:
    """Write namespace, slices, digest rows, content refs, aliases and hot
    fingerprints through one package's engine."""
    _meta, types, _acl, context = PACKAGES[pkg]
    ctx = context.Context(uid=0, gid=0, pid=1)
    assert m.init(types.Format(name="xvol", trash_days=0, block_size=256,
                               hash_backend="cpu"), force=True) == 0
    m.load()
    root = types.ROOT_INODE
    st, d, _ = m.mkdir(ctx, root, b"dir", 0o755)
    assert st == 0
    assert m.symlink(ctx, d, b"ln", b"../a.bin")[0] == 0
    rng = random.Random(5)
    for name, parent, n_slices in ((b"a.bin", root, 3), (b"b.bin", d, 2)):
        st, ino, _ = m.create(ctx, parent, name, 0o640)
        assert st == 0
        assert m.setxattr(ctx, ino, b"user.tag", name) == 0
        for j in range(n_slices):
            sid = m.new_slice()
            size = rng.randrange(1, 256 << 10)
            assert m.write_chunk(ino, 0, j * (256 << 10), types.Slice(
                pos=j * (256 << 10), id=sid, size=size, off=0, len=size)) == 0
    digests = [bytes([i]) * 32 for i in range(4)]
    m.set_block_digests([(sid, 0, 1000 + sid, digests[sid % 4]) for sid in range(1, 6)])
    m.content_register([(digests[1], 1, 0, 1001), (digests[2], 2, 0, 1002)])
    m.content_incref([(digests[1], 5, 0, 1001), (digests[2], 3, 0, 1002)])
    m.set_hot_fingerprints([(b"f" * 8, digests[0]), (b"g" * 8, digests[3])])


def _volume(pkg: str, m) -> dict:
    """Everything a volume holds, as plain values comparable across packages."""
    drv = Driver(m, pkg)
    fmt = m.load()
    return {
        "format": (fmt.name, fmt.uuid, fmt.block_size, fmt.trash_days, fmt.hash_backend),
        "tree": drv.tree(),
        "slices": {ino: [(s.id, s.size, s.off, s.len, s.pos) for s in sl]
                   for ino, sl in m.list_slices().items()},
        "digests": sorted(m.scan_block_digests()),
        "refs": sorted(m.scan_content_refs()),
        "aliases": sorted(m.scan_content_aliases()),
        "hot": sorted(m.load_hot_fingerprints()),
    }


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_sqlite_volume_opens_in_the_other_package(tmp_path, writer, reader):
    uri = f"sqlite3://{tmp_path}/meta.db"
    w = PACKAGES[writer][0].new_client(uri)
    _populate(writer, w)
    want = _volume(writer, w)
    w.client.close()
    r = PACKAGES[reader][0].new_client(uri)
    try:
        got = _volume(reader, r)
        assert got == want
        assert len(want["slices"]) == 2 and len(want["aliases"]) == 4
        # the reader can go on writing the same volume
        r.set_block_digests([(9, 0, 7, b"\x09" * 32)])
        assert (9, 0, 7, b"\x09" * 32) in list(r.scan_block_digests())
    finally:
        r.client.close()


@pytest.mark.parametrize("engines", ["mem", "sqlite3"], indirect=True)
def test_content_plane_and_digest_index_match_reference(engines):
    """One call sequence through both packages' engines: every return value
    and every scan is equal (alias timestamps aside: they are clock reads)."""
    d = [bytes([7, i]) * 16 for i in range(3)]
    calls = [
        ("set_block_digests", [(1, 0, 100, d[0]), (2, 0, 100, d[0]), (3, 1, 50, d[1])]),
        ("content_incref", [(d[0], 2, 0, 100)]),
        ("content_register", [(d[0], 1, 0, 100), (d[1], 3, 1, 50)]),
        ("content_register", [(d[0], 4, 0, 100)]),
        ("content_incref", [(d[0], 2, 0, 100), (d[2], 5, 0, 9)]),
        ("content_resolve", 2, 0),
        ("content_resolve", 9, 9),
        ("content_decref", [(4, 0), (9, 9)]),
        ("content_decref", [(3, 1)]),
        ("content_set_refs", d[0], 5),
        ("content_delete_aliases", [(2, 0)]),
        ("delete_block_digests", [(2, 0), (8, 8)]),
        ("set_hot_fingerprints", [(b"h" * 8, d[2])]),
    ]
    for pkg, m in engines.items():
        assert m.init(PACKAGES[pkg][1].Format(name="cr", trash_days=0), force=True) == 0
        m.load()
    for call in calls:
        out = {pkg: getattr(m, call[0])(*call[1:]) for pkg, m in engines.items()}
        assert out["port"] == out["ref"], call
        scans = {pkg: (sorted(m.scan_block_digests()), sorted(m.scan_content_refs()),
                       sorted((k, dg, b) for k, dg, b, _ts in m.scan_content_aliases()),
                       m.load_hot_fingerprints())
                 for pkg, m in engines.items()}
        assert scans["port"] == scans["ref"], call


def test_unported_schemes_raise_the_reference_error():
    # every engine of the reference is ported (sql:// included); a scheme
    # neither package knows raises the same error in both
    for scheme in ("etcd", "postgres"):
        with pytest.raises(ValueError, match=f"invalid meta driver: {scheme}"):
            port_meta.new_client(f"{scheme}://127.0.0.1:1/x")
        with pytest.raises(ValueError, match=f"invalid meta driver: {scheme}"):
            ref_meta.new_client(f"{scheme}://127.0.0.1:1/x")
    with pytest.raises(ValueError, match="invalid meta driver: tikv"):
        port_meta.new_client("tikv://127.0.0.1:2379")
    # the reference raises the same for a scheme neither package knows
    with pytest.raises(ValueError, match="invalid meta driver: tikv"):
        ref_meta.new_client("tikv://127.0.0.1:2379")


def test_errno_conventions_match_reference(tmp_path):
    """POSIX results are return values, not exceptions, in both packages."""
    for pkg, (meta, types, _acl, context) in PACKAGES.items():
        m = meta.new_client(f"sqlite3://{tmp_path}/{pkg}.db")
        try:
            m.init(types.Format(name="e", trash_days=0), force=True)
            m.load()
            ctx = context.Context(uid=0, gid=0, pid=1)
            assert m.lookup(ctx, types.ROOT_INODE, b"nope")[0] == errno.ENOENT
            assert m.mkdir(ctx, types.ROOT_INODE, b"d", 0o755)[0] == 0
            assert m.mkdir(ctx, types.ROOT_INODE, b"d", 0o755)[0] == errno.EEXIST
            assert m.rmdir(ctx, types.ROOT_INODE, b"nope") == errno.ENOENT
        finally:
            m.client.close()


def test_port_lockwatch_is_its_own_watchdog():
    """The port's lock watchdog (wbatch.py permits its blocking sites
    through it) marks the port's own files and catches an inversion."""
    assert lockwatch._JUICEFS_MARK == os.sep + "juicefs_tpu_torch" + os.sep
    with pytest.raises(ValueError):
        lockwatch.permit(" ")
    with lockwatch.scoped_state() as st:
        a = lockwatch.watched_lock("drill.A")
        b = lockwatch.watched_lock("drill.B")
        for first, second in ((a, b), (b, a)):
            def take(first=first, second=second):
                with first:
                    with second:
                        pass

            th = threading.Thread(target=take, daemon=True)
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
        inv = [v for v in st.snapshot() if v["kind"] == "inversion"]
    assert len(inv) == 1
    assert "drill.A" in inv[0]["detail"] and "drill.B" in inv[0]["detail"]


def _wb_commit_counter(m):
    """Count real engine transactions (outermost only: nested joins are
    the same commit), on the kv engine's client or the sql engine."""
    calls = [0]
    if hasattr(m, "client"):
        orig = m.client.txn

        def counting(fn, retries=50, _o=orig):
            if not m.client.in_txn():
                calls[0] += 1
            return _o(fn, retries)

        m.client.txn = counting
    else:
        orig = m._txn

        def counting(fn, retries=50, errno_abort=True, _o=orig):
            if not getattr(m._tlocal, "in_txn", False):
                calls[0] += 1
            return _o(fn, retries, errno_abort)

        m._txn = counting
    return calls


@pytest.mark.parametrize("pkg", ["port", "ref"])
@pytest.mark.parametrize("engine", ["kv", "sql"])
def test_group_commit_amortizes_engine_txns(tmp_path, pkg, engine):
    """The twin of tests/test_wbatch.py's headline drill, on both
    packages: a create+commit burst of 16 files acks with at most the two
    id-range allocations, and the barrier lands all 32 mutations in ONE
    group commit. The flush timer is held far beyond the ack window
    (flush_ms = 10 minutes), so no timed drain can run mid-storm however
    slowly the storm runs: the reference drill's 50 ms timer fires
    during a storm slowed by a busy host, and then a drain lands inside
    the ack window."""
    meta, types_, _acl, context = PACKAGES[pkg]
    root = context.Context(uid=0, gid=0)
    url = "memkv://" if engine == "kv" else f"sql://{tmp_path}/wb-{pkg}.db"
    m = meta.new_client(url)
    m.init(meta.Format(name="wb", trash_days=0), force=True)
    m.load()
    m.configure_write_batch(flush_ms=600_000.0)
    st, dino, _ = m.mkdir(root, meta.ROOT_INODE, b"ckpt", 0o755)
    assert st == 0
    assert m.sync_meta() == 0  # settle the mkdir group
    calls = _wb_commit_counter(m)
    inos = []
    for i in range(16):
        st, ino, _ = m.create(root, dino, b"s%d.tmp" % i, 0o644)
        assert st == 0, st
        inos.append(ino)
        sid = m.new_slice()
        assert m.write_chunk(ino, 0, 0, types_.Slice(pos=0, id=sid, size=4096, off=0,
                                                     len=4096)) == 0
    enqueue_txns = calls[0]
    assert enqueue_txns <= 2, enqueue_txns
    assert m.wbatch.stats()["drained"] == 1  # only the mkdir's group so far
    assert m.sync_meta(inos[0]) == 0
    assert calls[0] - enqueue_txns == 1  # 32 mutations, ONE group txn
    assert m.wbatch.stats()["drained"] == 2
    st, ino, attr = m.do_lookup(dino, b"s3.tmp")
    assert st == 0 and ino == inos[3] and attr.length == 4096
    m.close_session()
