"""Twin of tests/test_meta.py on the port: the named meta engine drills,
run against every engine of the port (mirrors reference
pkg/meta/base_test.go's all-engine matrix), each port txn closure run
twice under the port's rerun harness.

Every drill is also a parity check: its client is a `Paired` one, which
runs each call on a port client and on a reference client of the same
engine, each with its own database, and fails unless both return the same
values (clock fields aside) or raise errors of the same name. One drill,
`test_local_unlock_wakes_blocked_waiter`, drives the port's client alone:
its two threads would race between the two packages' halves of a call.
The random drill against the reference's engines is
tests/test_torch_meta.py."""

import dataclasses
import errno
import importlib
import os
import threading

import pytest

from juicefs_tpu import meta as ref_meta
from juicefs_tpu.meta import dump as ref_dump
from juicefs_tpu.meta.slice import build_slice as ref_build_slice
from juicefs_tpu_torch.meta import (
    Attr,
    Format,
    Slice,
    new_client,
    CHUNK_SIZE,
    ROOT_INODE,
    TYPE_DIRECTORY,
    TYPE_FILE,
    TYPE_SYMLINK,
)
from juicefs_tpu_torch.meta import interface as meta_interface
from juicefs_tpu_torch.meta.context import Context
from juicefs_tpu_torch.meta.slice import build_slice
from juicefs_tpu_torch.meta.types import (
    RENAME_EXCHANGE,
    RENAME_NOREPLACE,
    SET_ATTR_GID,
    SET_ATTR_MODE,
    SET_ATTR_UID,
    TRASH_INODE,
)
from torch_txnwatch import port_txnwatch, port_txnwatch_guard  # noqa: F401

CTX = Context(uid=0, gid=0)
USER = Context(uid=1000, gid=1000, gids=(1000,))

# fields that read the clock: two clients never agree on them
_CLOCK = frozenset({"atime", "mtime", "ctime", "atimensec", "mtimensec",
                    "ctimensec", "expire"})


def _plain(x):
    """A value of either package as plain data, clock fields left out."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _plain(getattr(x, f.name)))
            for f in dataclasses.fields(x) if f.name not in _CLOCK)
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return frozenset(_plain(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted(((_plain(k), _plain(v)) for k, v in x.items()), key=repr))
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    return x


def _to_ref(x):
    """A port argument as the reference's type of the same name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        mod = type(x).__module__
        if mod.startswith("juicefs_tpu_torch."):
            cls = getattr(importlib.import_module(
                "juicefs_tpu." + mod[len("juicefs_tpu_torch."):]), type(x).__name__)
            return cls(**{f.name: _to_ref(getattr(x, f.name))
                          for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (list, tuple)):
        return type(x)(_to_ref(v) for v in x)
    return x


class _Mirror:
    """A record both clients hold (the loaded Format): reads come from the
    port's, a field set is set on both."""

    def __init__(self, port, ref):
        object.__setattr__(self, "_pair", (port, ref))

    def __getattr__(self, name):
        return getattr(self._pair[0], name)

    def __setattr__(self, name, value):
        for obj in self._pair:
            setattr(obj, name, value)


class Paired:
    """A port client and a reference client driven as one. A call runs on
    the port, then on the reference with its arguments converted, and the
    two results must agree; the port's result (or error) is returned. A
    call made inside another (a message callback reading the engine) goes
    to the port alone. Callbacks given to `on_msg` run on the port's
    messages; the reference's are recorded, and `check()` holds the two
    message logs equal."""

    def __init__(self, port, ref):
        self.port, self.ref = port, ref
        self._depth = threading.local()
        self._msgs = {"port": [], "ref": []}

    def on_msg(self, mtype, callback):
        port_log, ref_log = self._msgs["port"], self._msgs["ref"]

        def on_port(*args):
            port_log.append((mtype, _plain(args)))
            return callback(*args)

        self.port.on_msg(mtype, on_port)
        self.ref.on_msg(mtype, lambda *args: ref_log.append((mtype, _plain(args))))

    def check(self):
        assert self._msgs["port"] == self._msgs["ref"], (
            f"messages: port {self._msgs['port']} != reference {self._msgs['ref']}")

    def __getattr__(self, name):
        port_attr = getattr(self.port, name)
        if not callable(port_attr):
            ref_attr = getattr(self.ref, name)
            assert _plain(port_attr) == _plain(ref_attr), name
            if dataclasses.is_dataclass(port_attr):
                return _Mirror(port_attr, ref_attr)
            return port_attr
        ref_attr = getattr(self.ref, name)

        def call(*args, **kwargs):
            depth = getattr(self._depth, "n", 0)
            if depth:
                return port_attr(*args, **kwargs)
            self._depth.n = depth + 1
            try:
                got = want = port_err = ref_err = None
                try:
                    got = port_attr(*args, **kwargs)
                except Exception as e:  # compared with the reference's below
                    port_err = e
                try:
                    want = ref_attr(*_to_ref(args), **{k: _to_ref(v) for k, v in kwargs.items()})
                except Exception as e:
                    ref_err = e
            finally:
                self._depth.n = depth
            if port_err is not None or ref_err is not None:
                assert type(port_err).__name__ == type(ref_err).__name__, (
                    f"{name}: port raised {port_err!r}, reference {ref_err!r}")
                raise port_err
            assert _plain(got) == _plain(want), (
                f"{name}{args}: port {got!r} != reference {want!r}")
            return got

        return call


def paired_client(port_uri: str, ref_uri: str) -> Paired:
    return Paired(new_client(port_uri), ref_meta.new_client(ref_uri))


def both_build_slice(slices):
    """build_slice of the port, held equal to the reference's."""
    view = build_slice(slices)
    assert _plain(view) == _plain(ref_build_slice(_to_ref(slices)))
    return view


@pytest.fixture(scope="session")
def redis_server():
    from juicefs_tpu_torch.meta.redis_server import RedisServer

    srv = RedisServer()
    port = srv.start()
    yield f"127.0.0.1:{port}"
    srv.stop()


@pytest.fixture(params=["memkv", "sqlite3", "redis", "sql"])
def m(request, tmp_path):
    """A `Paired` client on the engine: the port's and the reference's
    databases side by side (redis: db 0 and db 1 of one server)."""
    if request.param == "memkv":
        uris = ("memkv://test", "memkv://test")
    elif request.param == "redis":
        addr = request.getfixturevalue("redis_server")
        uris = (f"redis://{addr}/0", f"redis://{addr}/1")
    elif request.param == "sql":
        uris = (f"sql://{tmp_path}/meta-rel.db", f"sql://{tmp_path}/ref-meta-rel.db")
    else:
        uris = (f"sqlite3://{tmp_path}/meta.db", f"sqlite3://{tmp_path}/ref-meta.db")
    client = paired_client(*uris)
    if request.param == "redis":
        client.reset()  # the server is session-scoped: wipe previous state
    client.init(Format(name="test", trash_days=0), force=True)
    client.load()
    client.new_session()
    yield client
    client.close_session()
    client.check()


def test_format_roundtrip(tmp_path):
    c = paired_client(f"sqlite3://{tmp_path}/f.db", f"sqlite3://{tmp_path}/ref-f.db")
    fmt = Format(name="vol1", block_size=4096, compression="lz4", trash_days=3)
    c.init(fmt)
    c2 = paired_client(f"sqlite3://{tmp_path}/f.db", f"sqlite3://{tmp_path}/ref-f.db")
    loaded = c2.load()
    assert loaded.name == "vol1"
    assert loaded.compression == "lz4"
    assert loaded.trash_days == 3
    # re-init with different name without force fails
    with pytest.raises(RuntimeError):
        c2.init(Format(name="other"))


def test_mkdir_lookup_rmdir(m):
    st, ino, attr = m.mkdir(CTX, ROOT_INODE, b"d1", 0o755)
    assert st == 0 and ino > 1
    assert attr.typ == TYPE_DIRECTORY and attr.nlink == 2
    st, ino2, attr2 = m.lookup(CTX, ROOT_INODE, b"d1")
    assert st == 0 and ino2 == ino
    st, _, _ = m.mkdir(CTX, ROOT_INODE, b"d1", 0o755)
    assert st == errno.EEXIST
    # parent nlink reflects subdir
    st, rattr = m.getattr(CTX, ROOT_INODE)
    assert rattr.nlink == 3
    assert m.rmdir(CTX, ROOT_INODE, b"d1") == 0
    st, _, _ = m.lookup(CTX, ROOT_INODE, b"d1")
    assert st == errno.ENOENT
    assert m.rmdir(CTX, ROOT_INODE, b"d1") == errno.ENOENT


def test_rmdir_notempty(m):
    _, d, _ = m.mkdir(CTX, ROOT_INODE, b"d", 0o755)
    m.create(CTX, d, b"f", 0o644)
    assert m.rmdir(CTX, ROOT_INODE, b"d") == errno.ENOTEMPTY
    assert m.unlink(CTX, d, b"f") == 0
    assert m.rmdir(CTX, ROOT_INODE, b"d") == 0


def test_create_unlink(m):
    st, ino, attr = m.create(CTX, ROOT_INODE, b"f1", 0o644)
    assert st == 0 and attr.typ == TYPE_FILE and attr.nlink == 1
    assert m.close(CTX, ino) == 0
    st, _, _ = m.create(CTX, ROOT_INODE, b"f1", 0o644, flags=os.O_EXCL)
    assert st == errno.EEXIST
    assert m.unlink(CTX, ROOT_INODE, b"f1") == 0
    st, _ = m.getattr(CTX, ino)
    assert st == errno.ENOENT


def test_symlink(m):
    st, ino, attr = m.symlink(CTX, ROOT_INODE, b"ln", b"/target/path")
    assert st == 0 and attr.typ == TYPE_SYMLINK
    st, target = m.readlink(CTX, ino)
    assert st == 0 and target == b"/target/path"


def test_hardlink(m):
    st, ino, _ = m.create(CTX, ROOT_INODE, b"a", 0o644)
    m.close(CTX, ino)
    st, attr = m.link(CTX, ino, ROOT_INODE, b"b")
    assert st == 0 and attr.nlink == 2
    assert m.unlink(CTX, ROOT_INODE, b"a") == 0
    st, attr = m.getattr(CTX, ino)
    assert st == 0 and attr.nlink == 1
    st, ino2, _ = m.lookup(CTX, ROOT_INODE, b"b")
    assert ino2 == ino
    # hardlink to directory is EPERM
    _, d, _ = m.mkdir(CTX, ROOT_INODE, b"d", 0o755)
    st, _ = m.link(CTX, d, ROOT_INODE, b"dl")
    assert st == errno.EPERM


def test_readdir(m):
    _, d, _ = m.mkdir(CTX, ROOT_INODE, b"dir", 0o755)
    names = [f"f{i}".encode() for i in range(10)]
    for n in names:
        st, ino, _ = m.create(CTX, d, n, 0o644)
        assert st == 0
        m.close(CTX, ino)
    st, entries = m.readdir(CTX, d, want_attr=True)
    assert st == 0
    got = sorted(e.name for e in entries if e.name not in (b".", b".."))
    assert got == sorted(names)
    assert entries[0].name == b"." and entries[1].name == b".."


def test_rename_basic(m):
    _, ino, _ = m.create(CTX, ROOT_INODE, b"src", 0o644)
    m.close(CTX, ino)
    st, rino, _ = m.rename(CTX, ROOT_INODE, b"src", ROOT_INODE, b"dst")
    assert st == 0 and rino == ino
    assert m.lookup(CTX, ROOT_INODE, b"src")[0] == errno.ENOENT
    assert m.lookup(CTX, ROOT_INODE, b"dst")[1] == ino


def test_rename_across_dirs(m):
    _, d1, _ = m.mkdir(CTX, ROOT_INODE, b"d1", 0o755)
    _, d2, _ = m.mkdir(CTX, ROOT_INODE, b"d2", 0o755)
    _, sub, _ = m.mkdir(CTX, d1, b"sub", 0o755)
    st, _, _ = m.rename(CTX, d1, b"sub", d2, b"sub2")
    assert st == 0
    _, a1 = m.getattr(CTX, d1)
    _, a2 = m.getattr(CTX, d2)
    assert a1.nlink == 2 and a2.nlink == 3
    _, sattr = m.getattr(CTX, sub)
    assert sattr.parent == d2


def test_rename_replace_and_flags(m):
    _, a, _ = m.create(CTX, ROOT_INODE, b"a", 0o644)
    _, b, _ = m.create(CTX, ROOT_INODE, b"b", 0o644)
    m.close(CTX, a)
    m.close(CTX, b)
    st, _, _ = m.rename(CTX, ROOT_INODE, b"a", ROOT_INODE, b"b", RENAME_NOREPLACE)
    assert st == errno.EEXIST
    st, _, _ = m.rename(CTX, ROOT_INODE, b"a", ROOT_INODE, b"b")
    assert st == 0
    assert m.getattr(CTX, b)[0] == errno.ENOENT  # replaced inode freed
    # exchange
    _, c, _ = m.create(CTX, ROOT_INODE, b"c", 0o644)
    m.close(CTX, c)
    st, _, _ = m.rename(CTX, ROOT_INODE, b"b", ROOT_INODE, b"c", RENAME_EXCHANGE)
    assert st == 0
    assert m.lookup(CTX, ROOT_INODE, b"b")[1] == c
    assert m.lookup(CTX, ROOT_INODE, b"c")[1] == a


def test_rename_dir_into_own_subtree(m):
    _, d1, _ = m.mkdir(CTX, ROOT_INODE, b"d1", 0o755)
    _, d2, _ = m.mkdir(CTX, d1, b"d2", 0o755)
    st, _, _ = m.rename(CTX, ROOT_INODE, b"d1", d2, b"bad")
    assert st == errno.EINVAL


def test_rename_exchange_with_ancestor(m):
    """EXCHANGE that would make a directory its own descendant is the
    mirrored cycle of rename-into-own-subtree: kernel says EINVAL."""
    _, d1, _ = m.mkdir(CTX, ROOT_INODE, b"d1", 0o755)
    _, d2, _ = m.mkdir(CTX, d1, b"d2", 0o755)
    st, _, _ = m.rename(CTX, d1, b"d2", ROOT_INODE, b"d1", RENAME_EXCHANGE)
    assert st == errno.EINVAL
    # and the legit sibling exchange still works
    _, d3, _ = m.mkdir(CTX, ROOT_INODE, b"d3", 0o755)
    st, _, _ = m.rename(CTX, ROOT_INODE, b"d3", d1, b"d2", RENAME_EXCHANGE)
    assert st == 0


def test_rename_hardlink_same_inode_noop(m):
    """POSIX: renaming one hardlink over another of the SAME inode
    succeeds and changes nothing — both names survive."""
    _, ino, _ = m.create(CTX, ROOT_INODE, b"a", 0o644)
    m.close(CTX, ino)
    st, _ = m.link(CTX, ino, ROOT_INODE, b"b")
    assert st == 0
    st, rino, attr = m.rename(CTX, ROOT_INODE, b"a", ROOT_INODE, b"b")
    assert st == 0 and rino == ino
    assert m.lookup(CTX, ROOT_INODE, b"a")[1] == ino
    assert m.lookup(CTX, ROOT_INODE, b"b")[1] == ino
    assert m.getattr(CTX, ino)[1].nlink == 2
    # NOREPLACE still refuses: the destination name exists
    st, _, _ = m.rename(CTX, ROOT_INODE, b"a", ROOT_INODE, b"b",
                        RENAME_NOREPLACE)
    assert st == errno.EEXIST


def test_truncate_directory_eisdir(m):
    _, d, _ = m.mkdir(CTX, ROOT_INODE, b"d", 0o755)
    st, _ = m.truncate(CTX, d, 0)
    assert st == errno.EISDIR


def test_link_existing_dst_beats_eperm(m):
    """linkat checks destination existence before the EPERM-for-
    directories refusal (Linux vfs_link ordering)."""
    _, d, _ = m.mkdir(CTX, ROOT_INODE, b"d", 0o755)
    _, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    st, _ = m.link(CTX, d, ROOT_INODE, b"f")
    assert st == errno.EEXIST  # not EPERM: dst exists
    st, _ = m.link(CTX, d, ROOT_INODE, b"fresh")
    assert st == errno.EPERM   # dst free: dir hardlinks refused


def test_setattr_chmod_chown(m):
    _, ino, _ = m.create(CTX, ROOT_INODE, b"f", 0o644)
    m.close(CTX, ino)
    st, attr = m.setattr(CTX, ino, SET_ATTR_MODE, Attr(mode=0o600))
    assert st == 0 and attr.mode == 0o600
    st, attr = m.setattr(CTX, ino, SET_ATTR_UID | SET_ATTR_GID, Attr(uid=1000, gid=1000))
    assert st == 0 and attr.uid == 1000 and attr.gid == 1000
    # non-owner can't chmod
    other = Context(uid=2000, gid=2000, gids=(2000,))
    st, _ = m.setattr(other, ino, SET_ATTR_MODE, Attr(mode=0o777))
    assert st == errno.EPERM


def test_permissions(m):
    _, d, _ = m.mkdir(CTX, ROOT_INODE, b"priv", 0o700)
    st, _, _ = m.create(USER, d, b"f", 0o644)
    assert st == errno.EACCES
    st, _, _ = m.lookup(USER, d, b"anything")
    assert st == errno.EACCES
    # open modes
    _, ino, _ = m.create(CTX, ROOT_INODE, b"rootfile", 0o600)
    m.close(CTX, ino)
    st, _ = m.open(USER, ino, os.O_RDONLY)
    assert st == errno.EACCES


def test_sticky_bit(m):
    _, d, _ = m.mkdir(CTX, ROOT_INODE, b"tmp", 0o777)
    m.setattr(CTX, d, SET_ATTR_MODE, Attr(mode=0o1777))
    alice = Context(uid=1000, gid=1000, gids=(1000,))
    bob = Context(uid=2000, gid=2000, gids=(2000,))
    st, f, _ = m.create(alice, d, b"af", 0o644)
    assert st == 0
    m.close(alice, f)
    assert m.unlink(bob, d, b"af") == errno.EACCES
    assert m.unlink(alice, d, b"af") == 0


def test_write_read_chunks(m):
    _, ino, _ = m.create(CTX, ROOT_INODE, b"data", 0o644)
    sid = m.new_slice()
    assert sid > 0
    st = m.write_chunk(ino, 0, 0, Slice(pos=0, id=sid, size=1 << 20, off=0, len=1 << 20))
    assert st == 0
    sid2 = m.new_slice()
    assert sid2 != sid
    st = m.write_chunk(ino, 0, 1 << 19, Slice(pos=1 << 19, id=sid2, size=1 << 20, off=0, len=1 << 20))
    assert st == 0
    _, attr = m.getattr(CTX, ino)
    assert attr.length == (1 << 19) + (1 << 20)
    st, slices = m.read_chunk(ino, 0)
    assert st == 0 and len(slices) == 2
    view = both_build_slice(slices)
    # second write shadows the tail of the first
    assert view[0].id == sid and view[0].len == 1 << 19
    assert view[1].id == sid2 and view[1].len == 1 << 20
    m.close(CTX, ino)


def test_write_chunk_boundaries(m):
    _, ino, _ = m.create(CTX, ROOT_INODE, b"big", 0o644)
    sid = m.new_slice()
    assert m.write_chunk(ino, 1, 0, Slice(pos=0, id=sid, size=4096, off=0, len=4096)) == 0
    _, attr = m.getattr(CTX, ino)
    assert attr.length == CHUNK_SIZE + 4096
    assert m.write_chunk(ino, 0, CHUNK_SIZE, Slice(pos=CHUNK_SIZE, id=sid, size=1, off=0, len=1)) == errno.EINVAL
    m.close(CTX, ino)


def test_truncate(m):
    _, ino, _ = m.create(CTX, ROOT_INODE, b"t", 0o644)
    sid = m.new_slice()
    m.write_chunk(ino, 0, 0, Slice(pos=0, id=sid, size=8192, off=0, len=8192))
    st, attr = m.truncate(CTX, ino, 4096)
    assert st == 0 and attr.length == 4096
    st, attr = m.truncate(CTX, ino, 1 << 20)
    assert st == 0 and attr.length == 1 << 20
    m.close(CTX, ino)


def test_delete_file_reclaims_slices(m):
    deleted = []
    m.on_msg(meta_interface.DELETE_SLICE, lambda sid, size: deleted.append((sid, size)))
    _, ino, _ = m.create(CTX, ROOT_INODE, b"del", 0o644)
    sid = m.new_slice()
    m.write_chunk(ino, 0, 0, Slice(pos=0, id=sid, size=4096, off=0, len=4096))
    m.close(CTX, ino)
    assert m.unlink(CTX, ROOT_INODE, b"del") == 0
    n = m.cleanup_deleted_files()
    assert n == 1
    assert (sid, 4096) in deleted


def test_open_unlink_sustained(m):
    _, ino, _ = m.create(CTX, ROOT_INODE, b"of", 0o644)
    sid = m.new_slice()
    m.write_chunk(ino, 0, 0, Slice(pos=0, id=sid, size=4096, off=0, len=4096))
    # file still open: unlink must keep data until close
    assert m.unlink(CTX, ROOT_INODE, b"of") == 0
    assert m.cleanup_deleted_files() == 0
    m.close(CTX, ino)
    assert m.cleanup_deleted_files() == 1


def test_xattr(m):
    _, ino, _ = m.create(CTX, ROOT_INODE, b"x", 0o644)
    m.close(CTX, ino)
    assert m.setxattr(CTX, ino, b"user.k1", b"v1") == 0
    st, v = m.getxattr(CTX, ino, b"user.k1")
    assert st == 0 and v == b"v1"
    st, names = m.listxattr(CTX, ino)
    assert st == 0 and b"user.k1" in names
    assert m.removexattr(CTX, ino, b"user.k1") == 0
    st, _ = m.getxattr(CTX, ino, b"user.k1")
    assert st == errno.ENODATA
    assert m.setxattr(CTX, ino, b"user.k2", b"v", flags=2) == errno.ENODATA  # REPLACE
    assert m.setxattr(CTX, ino, b"user.k2", b"v", flags=1) == 0  # CREATE
    assert m.setxattr(CTX, ino, b"user.k2", b"v", flags=1) == errno.EEXIST


def test_statfs_accounting(m):
    total0, avail0, iused0, _ = m.statfs(CTX)
    _, ino, _ = m.create(CTX, ROOT_INODE, b"s", 0o644)
    sid = m.new_slice()
    m.write_chunk(ino, 0, 0, Slice(pos=0, id=sid, size=1 << 20, off=0, len=1 << 20))
    m.close(CTX, ino)
    total, avail, iused, _ = m.statfs(CTX)
    assert iused == iused0 + 1
    assert avail0 - avail == 1 << 20
    m.unlink(CTX, ROOT_INODE, b"s")
    total, avail, iused, _ = m.statfs(CTX)
    assert iused == iused0 and avail == avail0


def test_volume_quota(m):
    m.fmt.inodes = m.used_inodes() + 2
    _, a, _ = m.create(CTX, ROOT_INODE, b"q1", 0o644)
    _, b, _ = m.create(CTX, ROOT_INODE, b"q2", 0o644)
    st, _, _ = m.create(CTX, ROOT_INODE, b"q3", 0o644)
    assert st == errno.ENOSPC
    m.fmt.inodes = 0


def test_resolve_and_paths(m):
    _, d1, _ = m.mkdir(CTX, ROOT_INODE, b"a", 0o755)
    _, d2, _ = m.mkdir(CTX, d1, b"b", 0o755)
    _, f, _ = m.create(CTX, d2, b"c.txt", 0o644)
    m.close(CTX, f)
    st, ino, attr = m.resolve(CTX, "/a/b/c.txt")
    assert st == 0 and ino == f
    assert m.get_paths(f) == ["/a/b/c.txt"]


def test_summary_and_rmr(m):
    _, d, _ = m.mkdir(CTX, ROOT_INODE, b"tree", 0o755)
    _, sub, _ = m.mkdir(CTX, d, b"sub", 0o755)
    for i in range(3):
        _, f, _ = m.create(CTX, sub, f"f{i}".encode(), 0o644)
        sid = m.new_slice()
        m.write_chunk(f, 0, 0, Slice(pos=0, id=sid, size=1000, off=0, len=1000))
        m.close(CTX, f)
    st, s = m.summary(CTX, d)
    assert st == 0 and s.files == 3 and s.dirs == 2 and s.length == 3000
    st, n = m.remove_recursive(CTX, ROOT_INODE, b"tree")
    assert st == 0 and n == 5
    assert m.lookup(CTX, ROOT_INODE, b"tree")[0] == errno.ENOENT


def test_copy_file_range(m):
    _, src, _ = m.create(CTX, ROOT_INODE, b"cfr_src", 0o644)
    sid = m.new_slice()
    m.write_chunk(src, 0, 0, Slice(pos=0, id=sid, size=8192, off=0, len=8192))
    _, dst, _ = m.create(CTX, ROOT_INODE, b"cfr_dst", 0o644)
    st, copied = m.copy_file_range(CTX, src, 0, dst, 0, 8192, 0)
    assert st == 0 and copied == 8192
    st, slices = m.read_chunk(dst, 0)
    view = both_build_slice(slices)
    assert view[0].id == sid and view[0].len == 8192
    m.close(CTX, src)
    m.close(CTX, dst)


def test_flock(m):
    _, ino, _ = m.create(CTX, ROOT_INODE, b"lk", 0o644)
    m.close(CTX, ino)
    assert m.flock(CTX, ino, owner=1, ltype="W") == 0
    assert m.flock(CTX, ino, owner=2, ltype="W") == errno.EAGAIN
    assert m.flock(CTX, ino, owner=2, ltype="R") == errno.EAGAIN
    assert m.flock(CTX, ino, owner=1, ltype="U") == 0
    assert m.flock(CTX, ino, owner=2, ltype="R") == 0
    assert m.flock(CTX, ino, owner=3, ltype="R") == 0
    assert m.flock(CTX, ino, owner=1, ltype="W") == errno.EAGAIN


def test_setlk(m):
    _, ino, _ = m.create(CTX, ROOT_INODE, b"plk", 0o644)
    m.close(CTX, ino)
    W, R, U = m.F_WRLCK, m.F_RDLCK, m.F_UNLCK
    assert m.setlk(CTX, ino, owner=1, ltype=W, start=0, end=100) == 0
    assert m.setlk(CTX, ino, owner=2, ltype=R, start=50, end=150) == errno.EAGAIN
    assert m.setlk(CTX, ino, owner=2, ltype=R, start=100, end=200) == 0
    st, lt, s, e, pid = m.getlk(CTX, ino, owner=2, ltype=W, start=0, end=50)
    assert st == 0 and lt == W
    assert m.setlk(CTX, ino, owner=1, ltype=U, start=0, end=100) == 0
    assert m.setlk(CTX, ino, owner=2, ltype=W, start=0, end=50) == 0


def test_setlk_downgrade_splits_own_lock(m):
    """POSIX: re-locking a subrange REPLACES the overlap, even when the
    new lock's type differs (a W->R downgrade used to leave
    the old write-lock row alive because acquire only deleted own locks
    fully contained in the new range)."""
    _, ino, _ = m.create(CTX, ROOT_INODE, b"plk2", 0o644)
    m.close(CTX, ino)
    W, R, U = m.F_WRLCK, m.F_RDLCK, m.F_UNLCK
    assert m.setlk(CTX, ino, owner=1, ltype=W, start=0, end=100) == 0
    # downgrade the middle to a read lock
    assert m.setlk(CTX, ino, owner=1, ltype=R, start=20, end=40) == 0
    # another owner can now share-read [20,40) ...
    assert m.setlk(CTX, ino, owner=2, ltype=R, start=20, end=40) == 0
    # ... and getlk over the subrange reports a read lock, not W
    st, lt, _, _, _ = m.getlk(CTX, ino, owner=3, ltype=W, start=20, end=40)
    assert st == 0 and lt == R
    # the flanks [0,20) and [40,100) stay write-locked
    assert m.setlk(CTX, ino, owner=2, ltype=R, start=0, end=20) == errno.EAGAIN
    assert m.setlk(CTX, ino, owner=2, ltype=R, start=40, end=100) == errno.EAGAIN
    m.setlk(CTX, ino, owner=2, ltype=U, start=0, end=200)
    m.setlk(CTX, ino, owner=1, ltype=U, start=0, end=200)


def test_trash(tmp_path):
    c = paired_client(f"sqlite3://{tmp_path}/trash.db", f"sqlite3://{tmp_path}/ref-trash.db")
    c.init(Format(name="t", trash_days=1), force=True)
    c.load()
    c.new_session()
    _, ino, _ = c.create(CTX, ROOT_INODE, b"doomed", 0o644)
    sid = c.new_slice()
    c.write_chunk(ino, 0, 0, Slice(pos=0, id=sid, size=4096, off=0, len=4096))
    c.close(CTX, ino)
    assert c.unlink(CTX, ROOT_INODE, b"doomed") == 0
    # inode still alive, parked in trash
    st, attr = c.getattr(CTX, ino)
    assert st == 0
    delfiles, trash_count = c.scan_deleted_objects()
    assert trash_count == 1
    # expire everything in trash
    import time as _t

    assert c.cleanup_trash_before(_t.time() + 3600) >= 1
    assert c.getattr(CTX, ino)[0] == errno.ENOENT
    assert c.cleanup_deleted_files() == 1
    c.close_session()
    c.check()


def test_sessions(m):
    sessions = m.do_list_sessions()
    assert any(s.sid == m.sid for s in sessions)


def test_list_slices(m):
    _, ino, _ = m.create(CTX, ROOT_INODE, b"ls", 0o644)
    sid = m.new_slice()
    m.write_chunk(ino, 0, 0, Slice(pos=0, id=sid, size=4096, off=0, len=4096))
    m.close(CTX, ino)
    all_slices = m.list_slices()
    assert any(s.id == sid for slices in all_slices.values() for s in slices)


def test_compact_chunk(m):
    _, ino, _ = m.create(CTX, ROOT_INODE, b"cc", 0o644)
    sids = []
    for i in range(4):
        sid = m.new_slice()
        sids.append(sid)
        m.write_chunk(ino, 0, i * 1000, Slice(pos=i * 1000, id=sid, size=1000, off=0, len=1000))
    deleted = []
    m.on_msg(meta_interface.DELETE_SLICE, lambda sid, size: deleted.append(sid))
    st, slices = m.read_chunk(ino, 0)
    snapshot = b"".join(s.encode() for s in slices)
    new_id = m.new_slice()
    merged = Slice(pos=0, id=new_id, size=4000, off=0, len=4000)
    assert m.do_compact_chunk(ino, 0, snapshot, merged) == 0
    st, slices = m.read_chunk(ino, 0)
    assert len(slices) == 1 and slices[0].id == new_id and slices[0].len == 4000
    assert sorted(deleted) == sorted(sids)
    # a stale snapshot must lose (concurrent compaction protection)
    assert m.do_compact_chunk(ino, 0, snapshot, merged) != 0
    m.close(CTX, ino)


def test_build_slice_overlays():
    s1 = Slice(pos=0, id=1, size=100, off=0, len=100)
    s2 = Slice(pos=50, id=2, size=100, off=0, len=100)
    view = both_build_slice([s1, s2])
    assert [(v.pos, v.id, v.len) for v in view] == [(0, 1, 50), (50, 2, 100)]
    # hole between writes
    s3 = Slice(pos=300, id=3, size=50, off=0, len=50)
    view = both_build_slice([s1, s3])
    assert [(v.pos, v.id, v.len) for v in view] == [(0, 1, 100), (100, 0, 200), (300, 3, 50)]
    # full shadow
    view = both_build_slice([s1, Slice(pos=0, id=4, size=100, off=0, len=100)])
    assert [(v.pos, v.id, v.len) for v in view] == [(0, 4, 100)]


def test_truncate_shrink_grow_reads_zeros(m):
    """POSIX: region exposed by shrink-then-grow must read as zeros."""
    _, ino, _ = m.create(CTX, ROOT_INODE, b"tz", 0o644)
    sid = m.new_slice()
    m.write_chunk(ino, 0, 0, Slice(pos=0, id=sid, size=8192, off=0, len=8192))
    m.truncate(CTX, ino, 4096)
    m.truncate(CTX, ino, 8192)
    st, slices = m.read_chunk(ino, 0)
    view = both_build_slice(slices)
    covering = [v for v in view if v.pos < 8192 and v.pos + v.len > 4096]
    assert all(v.id == 0 for v in covering if v.pos >= 4096), view
    m.close(CTX, ino)


def test_copy_file_range_refcount(m):
    """Shared slices must survive source deletion (refcount incremented)."""
    deleted = []
    m.on_msg(meta_interface.DELETE_SLICE, lambda sid, size: deleted.append(sid))
    _, src, _ = m.create(CTX, ROOT_INODE, b"rc_src", 0o644)
    sid = m.new_slice()
    m.write_chunk(src, 0, 0, Slice(pos=0, id=sid, size=4096, off=0, len=4096))
    _, dst, _ = m.create(CTX, ROOT_INODE, b"rc_dst", 0o644)
    m.copy_file_range(CTX, src, 0, dst, 0, 4096, 0)
    m.close(CTX, src)
    m.close(CTX, dst)
    m.unlink(CTX, ROOT_INODE, b"rc_src")
    m.cleanup_deleted_files()
    assert sid not in deleted  # dst still references it
    m.unlink(CTX, ROOT_INODE, b"rc_dst")
    m.cleanup_deleted_files()
    assert sid in deleted  # last reference gone


def test_sustained_no_double_accounting(m):
    total0, avail0, iused0, _ = m.statfs(CTX)
    _, ino, _ = m.create(CTX, ROOT_INODE, b"sus", 0o644)
    sid = m.new_slice()
    m.write_chunk(ino, 0, 0, Slice(pos=0, id=sid, size=4096, off=0, len=4096))
    m.unlink(CTX, ROOT_INODE, b"sus")  # still open -> sustained
    m.close(CTX, ino)
    m.cleanup_deleted_files()
    total, avail, iused, _ = m.statfs(CTX)
    assert iused == iused0 and avail == avail0  # no drift, no double decrement


def test_hardlink_parent_tracking(m):
    _, d1, _ = m.mkdir(CTX, ROOT_INODE, b"hp1", 0o755)
    _, d2, _ = m.mkdir(CTX, ROOT_INODE, b"hp2", 0o755)
    _, ino, _ = m.create(CTX, d1, b"f", 0o644)
    m.close(CTX, ino)
    m.link(CTX, ino, d2, b"l1")
    m.link(CTX, ino, d2, b"l2")
    parents = m.get_parents(ino)
    assert parents == {d1: 1, d2: 2}
    m.unlink(CTX, d2, b"l1")
    assert m.get_parents(ino) == {d1: 1, d2: 1}


def test_setattr_size_truncates(m):
    from juicefs_tpu_torch.meta.types import SET_ATTR_SIZE

    _, ino, _ = m.create(CTX, ROOT_INODE, b"ss", 0o644)
    sid = m.new_slice()
    m.write_chunk(ino, 0, 0, Slice(pos=0, id=sid, size=8192, off=0, len=8192))
    st, attr = m.setattr(CTX, ino, SET_ATTR_SIZE, Attr(length=100))
    assert st == 0 and attr.length == 100
    m.close(CTX, ino)


def test_deep_tree_rmr_and_summary(m):
    parent = ROOT_INODE
    for i in range(600):  # deeper than Python's default recursion limit / 2
        st, parent, _ = m.mkdir(CTX, parent, b"d", 0o755)
        assert st == 0
    st, s = m.summary(CTX, ROOT_INODE)
    assert st == 0 and s.dirs >= 601
    st, n = m.remove_recursive(CTX, ROOT_INODE, b"d", skip_trash=True)
    assert st == 0 and n == 600


def test_trash_parent_updated(tmp_path):
    """Trashed inode's parent must point at the trash hour dir."""
    c = paired_client(f"sqlite3://{tmp_path}/tp.db", f"sqlite3://{tmp_path}/ref-tp.db")
    c.init(Format(name="tp", trash_days=1), force=True)
    c.load()
    c.new_session()
    _, ino, _ = c.create(CTX, ROOT_INODE, b"f", 0o644)
    c.close(CTX, ino)
    assert c.unlink(CTX, ROOT_INODE, b"f") == 0
    _, attr = c.getattr(CTX, ino)
    assert attr.parent > TRASH_INODE  # hour dir, not old parent
    c.close_session()


def test_notifications_fire_after_commit(m):
    """DELETE_SLICE callbacks observe committed metadata state."""
    states = []

    def on_delete(sid, size):
        # at callback time the chunk key must already be gone
        st, slices = m.do_read_chunk(probe_ino, 0)
        states.append([s.id for s in slices])

    _, probe_ino, _ = m.create(CTX, ROOT_INODE, b"nf", 0o644)
    sid = m.new_slice()
    m.write_chunk(probe_ino, 0, 0, Slice(pos=0, id=sid, size=4096, off=0, len=4096))
    m.on_msg(meta_interface.DELETE_SLICE, on_delete)
    m.close(CTX, probe_ino)
    m.unlink(CTX, ROOT_INODE, b"nf")
    m.cleanup_deleted_files()
    assert states == [[]]


def test_local_unlock_wakes_blocked_waiter(m):
    """SETLKW waiters park on the meta lock condition and a local unlock
    wakes them immediately — no 10ms poll spin against the engine
    (the cadence itself matches redis_lock.go:86-88). The port's client
    alone: two threads would interleave the packages' halves of a call."""
    import time as _time

    m = m.port

    st, ino, _ = m.create(CTX, ROOT_INODE, b"lkw", 0o644)
    assert st == 0
    assert m.setlk(CTX, ino, owner=1, ltype=m.F_WRLCK, start=0, end=100) == 0

    got = []

    def waiter():
        attempts = 0
        while True:
            gen = m.lock_generation(ino)
            st = m.setlk(CTX, ino, owner=2, ltype=m.F_WRLCK, start=0, end=100)
            attempts += 1
            if st != errno.EAGAIN:
                got.append((st, attempts))
                return
            # deliberately huge poll interval: only the wake (or the
            # generation snapshot catching a pre-wait release) saves us
            m.lock_wait(ino, 10.0, gen)

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    _time.sleep(0.2)  # waiter is parked now
    t0 = _time.monotonic()
    assert m.setlk(CTX, ino, owner=1, ltype=m.F_UNLCK, start=0, end=100) == 0
    t.join(5.0)
    elapsed = _time.monotonic() - t0
    assert got and got[0][0] == 0, "waiter never acquired the lock"
    assert elapsed < 5.0, f"waiter polled instead of waking ({elapsed:.1f}s)"
    assert m.setlk(CTX, ino, owner=2, ltype=m.F_UNLCK, start=0, end=100) == 0


def test_engine_migration_kv_to_sql_and_back(tmp_path):
    """dump/load moves a volume between engine FAMILIES: the KV engine's
    record dump loads into the relational engine (and back) with the
    logical tree, xattrs, chunks, and quotas intact (reference: engine
    migration via dump/load, pkg/meta/dump.go)."""
    from juicefs_tpu_torch.meta.dump import dump_doc, load_doc
    from juicefs_tpu_torch.meta.types import Slice

    src = paired_client(f"sqlite3://{tmp_path}/src.db", f"sqlite3://{tmp_path}/ref-src.db")
    src.init(Format(name="mig", trash_days=0), force=True)
    src.load()
    st, d1, _ = src.mkdir(CTX, ROOT_INODE, b"docs", 0o755)
    assert st == 0
    st, f1, _ = src.create(CTX, d1, b"a.txt", 0o644)
    assert st == 0
    sid = src.new_slice()
    assert src.write_chunk(f1, 0, 0, Slice(pos=0, id=sid, size=1000, off=0, len=1000)) == 0
    assert src.setxattr(CTX, f1, b"user.k", b"v") == 0
    assert src.set_dir_quota(CTX, d1, 10 << 20, 100) == 0
    st, _, _ = src.symlink(CTX, ROOT_INODE, b"lnk", b"/docs/a.txt")
    assert st == 0

    def logical_state(m):
        st, entries = m.readdir(CTX, ROOT_INODE, want_attr=True)
        assert st == 0
        out = {}
        for e in entries:
            if e.name in (b".", b".."):
                continue
            out[bytes(e.name)] = (e.attr.typ, e.attr.mode, e.attr.length)
        return out

    want = logical_state(src)

    # KV family -> relational family
    # each package moves its own twin volume; the moved volumes are paired
    doc = dump_doc(src.port)
    dst = paired_client(f"sql://{tmp_path}/dst-rel.db", f"sql://{tmp_path}/ref-dst-rel.db")
    load_doc(dst.port, doc)
    ref_dump.load_doc(dst.ref, ref_dump.dump_doc(src.ref))
    dst.load()
    assert logical_state(dst) == want
    st, ino, _ = dst.lookup(CTX, d1, b"a.txt")
    assert st == 0 and ino == f1
    st, slices = dst.read_chunk(f1, 0)
    assert st == 0 and [(s.id, s.size) for s in slices] == [(sid, 1000)]
    st, val = dst.getxattr(CTX, f1, b"user.k")
    assert st == 0 and bytes(val) == b"v"
    assert dst.get_dir_quota(d1)[0] == 10 << 20
    st, target = dst.readlink(CTX, (dst.lookup(CTX, ROOT_INODE, b"lnk")[1]))
    assert st == 0 and bytes(target) == b"/docs/a.txt"

    # relational family -> KV family (round trip)
    doc2 = dump_doc(dst.port)
    back = paired_client(f"sqlite3://{tmp_path}/back.db", f"sqlite3://{tmp_path}/ref-back.db")
    load_doc(back.port, doc2)
    ref_dump.load_doc(back.ref, ref_dump.dump_doc(dst.ref))
    back.load()
    assert logical_state(back) == want
    st, slices = back.read_chunk(f1, 0)
    assert st == 0 and [(s.id, s.size) for s in slices] == [(sid, 1000)]
    # both directions preserve the record set byte-for-byte
    recs1 = {tuple(r) for r in doc["records"]}
    recs2 = {tuple(r) for r in doc2["records"]}
    assert recs1 == recs2


def test_build_slice_partial_overlap_offsets():
    """A newer slice covering the MIDDLE of an older one splits it into
    head/tail segments whose `off` must point into the ORIGINAL stored
    slice at the right byte (found as a surviving mutant of slice.py by
    tools/mutate.py: test_meta never pinned the off arithmetic)."""
    old = Slice(pos=0, id=7, size=100, off=0, len=100)
    new = Slice(pos=30, id=9, size=40, off=0, len=40)
    view = both_build_slice([old, new])
    assert [(s.pos, s.id, s.off, s.len) for s in view] == [
        (0, 7, 0, 30),     # head of the old slice
        (30, 9, 0, 40),    # the overwrite
        (70, 7, 70, 30),   # tail: off MUST be 70 into slice 7
    ]
    # overlapping chain of three writes, non-zero base offsets
    a = Slice(pos=10, id=1, size=50, off=5, len=50)
    b = Slice(pos=40, id=2, size=30, off=2, len=30)
    c = Slice(pos=20, id=3, size=10, off=0, len=10)
    view = both_build_slice([a, b, c])
    assert [(s.pos, s.id, s.off, s.len) for s in view] == [
        (0, 0, 0, 10),         # leading hole reads zeros
        (10, 1, 5, 10),        # a's head
        (20, 3, 0, 10),        # c overwrote a's middle
        (30, 1, 25, 10),       # a resumes: off = 5 + (30-10)
        (40, 2, 2, 30),        # b overwrote a's tail
    ]
    # hole segments keep size == len (consumers read either field)
    assert all(s.size == s.len for s in view if s.id == 0)
