"""The port's VFS core (juicefs_tpu_torch/vfs) over mem meta + mem store:
the cases of tests/test_vfs.py run on the port, then a seeded drill that
runs one random op sequence through the JAX package's VFS and the port's
and compares every result, and a cross-package volume on sqlite3:// +
file:// written by one package's FileSystem and read by the other's.
Nothing here needs a card: the cross-package volume hashes and
compresses on the CPU (`--hash-backend cpu`, `compress_backend="cpu"`),
the others are uncompressed and have no hash backend. The fan-out case
counts GETs in flight instead of timing the read."""

import errno
import os

import pytest

from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig
from juicefs_tpu_torch.meta import Format, new_client
from juicefs_tpu_torch.meta.context import Context
from juicefs_tpu_torch.meta.types import CHUNK_SIZE, SET_ATTR_SIZE, Attr
from juicefs_tpu_torch.object import create_storage
from juicefs_tpu_torch.vfs import ROOT_INO, VFS, VFSConfig


@pytest.fixture
def vfs(tmp_path):
    m = new_client("mem://")
    m.init(Format(name="test", storage="mem", block_size=1 << 20), force=False)
    m.new_session()
    store = CachedStore(
        create_storage("mem://"),
        ChunkConfig(block_size=1 << 20, cache_dirs=(str(tmp_path / "cache"),)),
    )
    v = VFS(m, store)
    yield v
    v.close()


CTX = Context(uid=0, gid=0, pid=1)


def test_create_write_read(vfs):
    st, ino, attr, fh = vfs.create(CTX, ROOT_INO, b"f.txt", 0o644)
    assert st == 0 and ino > 0
    assert vfs.write(CTX, ino, fh, 0, b"hello world") == 0
    st, data = vfs.read(CTX, ino, fh, 0, 100)
    assert st == 0 and data == b"hello world"
    # stat sees buffered length
    st, attr = vfs.getattr(CTX, ino)
    assert st == 0 and attr.length == 11
    assert vfs.release(CTX, ino, fh) == 0


def test_overwrite_and_shadowing(vfs):
    st, ino, _, fh = vfs.create(CTX, ROOT_INO, b"f", 0o644)
    assert vfs.write(CTX, ino, fh, 0, b"aaaaaaaaaa") == 0
    assert vfs.flush(CTX, ino, fh) == 0
    assert vfs.write(CTX, ino, fh, 3, b"BBB") == 0
    st, data = vfs.read(CTX, ino, fh, 0, 10)
    assert st == 0 and data == b"aaaBBBaaaa"


def test_sparse_write_holes(vfs):
    st, ino, _, fh = vfs.create(CTX, ROOT_INO, b"sparse", 0o644)
    assert vfs.write(CTX, ino, fh, 5, b"xx") == 0
    st, data = vfs.read(CTX, ino, fh, 0, 10)
    assert st == 0 and data == b"\0" * 5 + b"xx"


def test_cross_block_and_chunk_write(vfs):
    st, ino, _, fh = vfs.create(CTX, ROOT_INO, b"big", 0o644)
    blob = bytes(range(256)) * 4096 * 5  # 5 MiB > 1 MiB block size
    assert vfs.write(CTX, ino, fh, 0, blob) == 0
    st, data = vfs.read(CTX, ino, fh, 0, len(blob))
    assert st == 0 and data == blob
    # offset read spanning block boundary
    st, data = vfs.read(CTX, ino, fh, (1 << 20) - 10, 20)
    assert st == 0 and data == blob[(1 << 20) - 10 : (1 << 20) + 10]


def test_write_at_chunk_boundary(vfs):
    st, ino, _, fh = vfs.create(CTX, ROOT_INO, b"cb", 0o644)
    off = CHUNK_SIZE - 4
    assert vfs.write(CTX, ino, fh, off, b"12345678") == 0
    st, data = vfs.read(CTX, ino, fh, off, 8)
    assert st == 0 and data == b"12345678"
    st, attr = vfs.getattr(CTX, ino)
    assert attr.length == off + 8


def test_append_mode(vfs):
    st, ino, _, fh = vfs.create(CTX, ROOT_INO, b"log", 0o644, flags=os.O_RDWR | os.O_APPEND)
    assert vfs.write(CTX, ino, fh, 0, b"one,") == 0
    assert vfs.write(CTX, ino, fh, 0, b"two,") == 0  # offset ignored: appends
    assert vfs.write(CTX, ino, fh, 1, b"three") == 0
    st, data = vfs.read(CTX, ino, fh, 0, 64)
    assert st == 0 and data == b"one,two,three"


def test_truncate_via_setattr(vfs):
    st, ino, _, fh = vfs.create(CTX, ROOT_INO, b"t", 0o644)
    assert vfs.write(CTX, ino, fh, 0, b"0123456789") == 0
    a = Attr(length=4)
    st, out = vfs.setattr(CTX, ino, SET_ATTR_SIZE, a)
    assert st == 0 and out.length == 4
    st, data = vfs.read(CTX, ino, fh, 0, 10)
    assert st == 0 and data == b"0123"
    # extend with zeros
    st, out = vfs.setattr(CTX, ino, SET_ATTR_SIZE, Attr(length=8))
    assert st == 0
    st, data = vfs.read(CTX, ino, fh, 0, 10)
    assert st == 0 and data == b"0123\0\0\0\0"


def test_open_trunc(vfs):
    st, ino, _, fh = vfs.create(CTX, ROOT_INO, b"ot", 0o644)
    vfs.write(CTX, ino, fh, 0, b"data")
    vfs.release(CTX, ino, fh)
    st, attr, fh2 = vfs.open(CTX, ino, os.O_RDWR | os.O_TRUNC)
    assert st == 0 and attr.length == 0
    st, data = vfs.read(CTX, ino, fh2, 0, 10)
    assert st == 0 and data == b""
    vfs.release(CTX, ino, fh2)


def test_two_handles_read_own_writes(vfs):
    st, ino, _, fh1 = vfs.create(CTX, ROOT_INO, b"shared", 0o644)
    st, attr, fh2 = vfs.open(CTX, ino, os.O_RDONLY)
    assert st == 0
    assert vfs.write(CTX, ino, fh1, 0, b"visible") == 0
    st, data = vfs.read(CTX, ino, fh2, 0, 10)
    assert st == 0 and data == b"visible"
    vfs.release(CTX, ino, fh1)
    vfs.release(CTX, ino, fh2)


def test_readonly_handle_cannot_write(vfs):
    st, ino, _, fh = vfs.create(CTX, ROOT_INO, b"ro", 0o644)
    vfs.release(CTX, ino, fh)
    st, attr, fh = vfs.open(CTX, ino, os.O_RDONLY)
    assert vfs.write(CTX, ino, fh, 0, b"x") == errno.EACCES


def test_bad_handle(vfs):
    st, data = vfs.read(CTX, 123, 999, 0, 10)
    assert st == errno.EBADF
    assert vfs.write(CTX, 123, 999, 0, b"x") == errno.EBADF


def test_readonly_mount(tmp_path):
    m = new_client("mem://")
    m.init(Format(name="t", storage="mem"), force=False)
    m.new_session()
    store = CachedStore(create_storage("mem://"), ChunkConfig(cache_dirs=(str(tmp_path / "c"),)))
    v = VFS(m, store, VFSConfig(readonly=True))
    st, ino, attr, fh = v.create(CTX, ROOT_INO, b"x", 0o644)
    assert st == errno.EROFS
    assert v.unlink(CTX, ROOT_INO, b"x") == errno.EROFS
    st, _, _ = v.mkdir(CTX, ROOT_INO, b"d", 0o755)
    assert st == errno.EROFS
    st, _, _ = v.open(CTX, ROOT_INO, os.O_RDWR)
    assert st == errno.EROFS


def test_readdir_and_release(vfs):
    for name in (b"a", b"b", b"c"):
        st, ino, _, fh = vfs.create(CTX, ROOT_INO, name, 0o644)
        vfs.release(CTX, ino, fh)
    st, fh = vfs.opendir(CTX, ROOT_INO)
    assert st == 0
    st, entries = vfs.readdir(CTX, ROOT_INO, fh, 0)
    names = sorted(e.name for e in entries)
    assert names[:2] == [b".", b".."] or b"a" in names
    assert {b"a", b"b", b"c"} <= set(names)
    # offset continuation
    st, rest = vfs.readdir(CTX, ROOT_INO, fh, len(entries) - 1)
    assert st == 0 and len(rest) == 1
    assert vfs.releasedir(CTX, fh) == 0


def test_copy_file_range(vfs):
    st, src, _, fh1 = vfs.create(CTX, ROOT_INO, b"src", 0o644)
    vfs.write(CTX, src, fh1, 0, b"0123456789")
    st, dst, _, fh2 = vfs.create(CTX, ROOT_INO, b"dst", 0o644)
    vfs.write(CTX, dst, fh2, 0, b"XXXXXXXXXX")
    st, copied = vfs.copy_file_range(CTX, src, 2, dst, 4, 3)
    assert st == 0 and copied == 3
    st, data = vfs.read(CTX, dst, fh2, 0, 10)
    assert st == 0 and data == b"XXXX234XXX"


def test_fallocate_extends(vfs):
    st, ino, _, fh = vfs.create(CTX, ROOT_INO, b"fa", 0o644)
    vfs.write(CTX, ino, fh, 0, b"ab")
    assert vfs.fallocate(CTX, ino, fh, 0, 0, 100) == 0
    st, attr = vfs.getattr(CTX, ino)
    assert st == 0 and attr.length == 100


def test_statfs(vfs):
    total, avail, iused, iavail = vfs.statfs(CTX)
    assert total > 0 and avail > 0 and iavail > 0


def test_xattr_roundtrip(vfs):
    st, ino, _, fh = vfs.create(CTX, ROOT_INO, b"x", 0o644)
    assert vfs.setxattr(CTX, ino, b"user.k", b"v") == 0
    st, val = vfs.getxattr(CTX, ino, b"user.k")
    assert st == 0 and val == b"v"
    st, names = vfs.listxattr(CTX, ino)
    assert st == 0 and b"user.k" in names
    assert vfs.removexattr(CTX, ino, b"user.k") == 0


def test_flush_persists_across_vfs_instances(tmp_path):
    addr = f"sqlite3://{tmp_path}/m.db"
    blob_dir = tmp_path / "blobs"
    m = new_client(addr)
    m.init(Format(name="p", storage="file"), force=False)
    m.new_session()
    store = CachedStore(
        create_storage(f"file://{blob_dir}"), ChunkConfig(cache_dirs=(str(tmp_path / "c1"),))
    )
    v = VFS(m, store)
    st, ino, _, fh = v.create(CTX, ROOT_INO, b"persist", 0o644)
    v.write(CTX, ino, fh, 0, b"durable bytes")
    v.release(CTX, ino, fh)
    v.close()

    m2 = new_client(addr)
    m2.load()
    m2.new_session()
    store2 = CachedStore(
        create_storage(f"file://{blob_dir}"), ChunkConfig(cache_dirs=(str(tmp_path / "c2"),))
    )
    v2 = VFS(m2, store2)
    st, ino2, attr = v2.lookup(CTX, ROOT_INO, b"persist")
    assert st == 0 and ino2 == ino
    st, attr, fh2 = v2.open(CTX, ino2, os.O_RDONLY)
    assert st == 0 and attr.length == 13
    st, data = v2.read(CTX, ino2, fh2, 0, 64)
    assert st == 0 and data == b"durable bytes"
    v2.close()


def test_sequential_read_triggers_readahead(vfs):
    st, ino, _, fh = vfs.create(CTX, ROOT_INO, b"seq", 0o644)
    blob = os.urandom(3 << 20)
    vfs.write(CTX, ino, fh, 0, blob)
    vfs.flush(CTX, ino, fh)
    got = bytearray()
    step = 256 << 10
    for off in range(0, len(blob), step):
        st, data = vfs.read(CTX, ino, fh, off, step)
        assert st == 0
        got += data
    assert bytes(got) == blob
    h = vfs.handles.get(fh)
    assert h.reader._ra_window > 0  # window grew during sequential scan


def test_read_nonoverlapping_does_not_flush(vfs):
    st, ino, _, fh = vfs.create(CTX, ROOT_INO, b"inter", 0o644)
    vfs.write(CTX, ino, fh, 0, b"committed")
    vfs.flush(CTX, ino, fh)
    # buffered write at 1 MiB; read at 0 must not finalize its slice
    assert vfs.write(CTX, ino, fh, 1 << 20, b"buffered") == 0
    fw = vfs.writer.find(ino)
    assert fw.has_pending()
    st, data = vfs.read(CTX, ino, fh, 0, 9)
    assert st == 0 and data == b"committed"
    assert fw.has_pending()  # untouched by the non-overlapping read
    # overlapping read flushes and sees the bytes
    st, data = vfs.read(CTX, ino, fh, 1 << 20, 8)
    assert st == 0 and data == b"buffered"
    assert not fw.has_pending()


def test_flush_error_is_sticky(vfs, monkeypatch):
    st, ino, _, fh = vfs.create(CTX, ROOT_INO, b"err", 0o644)
    assert vfs.write(CTX, ino, fh, 0, b"doomed") == 0
    fw = vfs.writer.find(ino)
    # Make every upload fail: the first flush must error, and so must
    # every retry (no silent success after dropped buffers).
    monkeypatch.setattr(
        vfs.store.storage, "put",
        lambda *a, **k: (_ for _ in ()).throw(IOError("store down")),
    )
    monkeypatch.setattr(vfs.store.conf, "max_retries", 1)
    st1 = vfs.flush(CTX, ino, fh)
    st2 = vfs.flush(CTX, ino, fh)
    assert st1 != 0 and st2 != 0
    assert vfs.write(CTX, ino, fh, 10, b"more") == st1


def test_readdir_cache_invalidation(vfs):
    """Readdir snapshots are cached (reference pkg/fs dir cache) but local
    namespace mutations invalidate them synchronously."""
    st, dino, _ = vfs.mkdir(CTX, ROOT_INO, b"rd", 0o755)
    st, fh = vfs.opendir(CTX, dino)
    st, entries = vfs.readdir(CTX, dino, fh, 0)
    assert st == 0 and {e.name for e in entries} == {b".", b".."}
    # create through the same VFS: next readdir must see it immediately
    st, ino, _, ffh = vfs.create(CTX, dino, b"new.txt", 0o644)
    vfs.release(CTX, ino, ffh)
    st, fh2 = vfs.opendir(CTX, dino)
    st, entries = vfs.readdir(CTX, dino, fh2, 0)
    assert b"new.txt" in {e.name for e in entries}
    assert vfs.unlink(CTX, dino, b"new.txt") == 0
    st, fh3 = vfs.opendir(CTX, dino)
    st, entries = vfs.readdir(CTX, dino, fh3, 0)
    assert b"new.txt" not in {e.name for e in entries}
    for h in (fh, fh2, fh3):
        vfs.releasedir(CTX, h)


def test_readdir_cache_permission_recheck(vfs):
    """A cached readdir snapshot must not leak to a user without read
    permission on the directory."""
    import errno as _e

    st, dino, _ = vfs.mkdir(CTX, ROOT_INO, b"priv", 0o700)
    st, fh = vfs.opendir(CTX, dino)
    assert vfs.readdir(CTX, dino, fh, 0)[0] == 0  # warms the cache
    stranger = Context(uid=4444, gid=4444, gids=(4444,), pid=1)
    st, fh2 = vfs.opendir(stranger, dino)
    if st == 0:  # opendir may itself deny; both outcomes are correct
        st, _ = vfs.readdir(stranger, dino, fh2, 0)
    assert st == _e.EACCES
    vfs.releasedir(CTX, fh)




def test_ttlcache_capacity_sweep():
    """TTLCache bounds: at maxsize the sweep evicts expired entries, and
    when everything is fresh it drops the oldest half (mutation-testing
    survivors: the sweep was only integration-covered)."""
    import time as _time

    from juicefs_tpu_torch.vfs.cache import TTLCache

    c = TTLCache(ttl=60.0, maxsize=10)
    for i in range(10):
        c.put(i, i)
    assert len(c) == 10
    c.put(10, 10)  # triggers the all-fresh sweep: oldest half dropped
    assert len(c) == 6  # 10 - 10//2 + 1 new
    assert c.get(10) == 10

    # expired entries are swept before resorting to the half-drop
    c2 = TTLCache(ttl=0.05, maxsize=10)
    for i in range(10):
        c2.put(i, i)
    _time.sleep(0.06)
    c2.put(99, 99)
    assert c2.get(99) == 99
    assert len(c2) == 1  # the 10 expired entries were swept


def test_metacache_gen_guard_and_member_index():
    """Dir-snapshot coherence machinery, tested directly: the mutation
    generation guard drops a publish that raced an attr mutation, and the
    member reverse-index invalidates exactly the embedding snapshots."""
    from juicefs_tpu_torch.meta.types import Attr, Entry
    from juicefs_tpu_torch.vfs.cache import MetaCache

    mc = MetaCache(attr_ttl=60, entry_ttl=60, dir_ttl=60)
    entries = [
        Entry(inode=10, name=b"f", attr=Attr()),
        Entry(inode=2, name=b".", attr=Attr()),
    ]

    # normal publish: visible, and member 10 is indexed
    gen = mc.dir_read_begin()
    mc.put_dir(2, True, entries, gen=gen)
    assert mc.get_dir(2, True) is not None
    mc.attr_mutated(10, Attr())
    assert mc.get_dir(2, True) is None  # member mutation dropped it

    # raced publish: a mutation between dir_read_begin and put_dir means
    # the snapshot may embed a pre-mutation attr — it must NOT appear
    gen = mc.dir_read_begin()
    mc.attr_mutated(10, Attr())
    mc.put_dir(2, True, entries, gen=gen)
    assert mc.get_dir(2, True) is None

    # "." / ".." entries are not indexed: invalidating the PARENT's attr
    # must not evict the snapshot through its "." self-entry
    gen = mc.dir_read_begin()
    mc.put_dir(2, True, entries, gen=gen)
    mc.invalidate_attr(2)   # parent attr change -> attrs dropped, but...
    # ...the snapshot was evicted only via invalidate_dir semantics; the
    # "." member registration must not exist
    mc2 = MetaCache(attr_ttl=60, entry_ttl=60, dir_ttl=60)
    sub = [Entry(inode=5, name=b"..", attr=Attr())]
    gen = mc2.dir_read_begin()
    mc2.put_dir(7, True, sub, gen=gen)
    mc2.attr_mutated(5, Attr())  # ".." target changed
    assert mc2.get_dir(7, True) is not None  # not registered via ".."

    # want_attr=False snapshots carry no attrs: member mutations must not
    # evict them
    gen = mc.dir_read_begin()
    mc.put_dir(3, False, entries, gen=gen)
    mc.attr_mutated(10, Attr())
    assert mc.get_dir(3, False) is not None


def test_fragmented_chunk_reads_fan_out(tmp_path):
    """A heavily-overwritten chunk (many small slices — the pre-compaction
    case) reads its slices in parallel, not one at a time: with a 5 ms
    GET, several GETs are in flight at once during the cold read."""
    import threading
    import time

    from juicefs_tpu_torch.chunk.mem_cache import MemCache

    m = new_client("mem://")
    m.init(Format(name="frag", storage="mem", block_size=1 << 16), force=False)
    m.new_session()
    storage = create_storage("mem://")
    store = CachedStore(storage, ChunkConfig(block_size=1 << 16, max_download=16))
    v = VFS(m, store)
    st, ino, attr, fh = v.create(CTX, ROOT_INO, b"frag.bin", 0o644)
    assert st == 0
    # 48 separate flushed writes -> 48 distinct slices in one chunk
    n_slices, piece = 48, 8192
    blob = os.urandom(n_slices * piece)
    for i in range(n_slices):
        assert v.write(CTX, ino, fh, i * piece, blob[i * piece:(i + 1) * piece]) == 0
        assert v.flush(CTX, ino, fh) == 0
    store.flush_all()
    st, slices = m.read_chunk(ino, 0)
    assert st == 0 and len(slices) >= n_slices

    store.cache = MemCache(0)  # cold
    real_get = storage.get
    lock = threading.Lock()
    inflight = [0, 0]  # now, most

    def slow_get(key, off=0, size=-1):
        with lock:
            inflight[0] += 1
            inflight[1] = max(inflight[1], inflight[0])
        try:
            time.sleep(0.005)
            return real_get(key, off, size)
        finally:
            with lock:
                inflight[0] -= 1

    storage.get = slow_get
    st, data = v.read(CTX, ino, fh, 0, len(blob))
    assert st == 0 and bytes(data) == blob
    assert inflight[1] >= 4, f"at most {inflight[1]} GETs in flight"
    v.release(CTX, ino, fh)
    v.close()


# ---------------------------------------------------------------------------
# the port against the JAX package

import types  # noqa: E402

import numpy as np  # noqa: E402

from juicefs_tpu import cmd as ref_cmd  # noqa: E402
from juicefs_tpu import fs as ref_fs  # noqa: E402
from juicefs_tpu import vfs as ref_vfs  # noqa: E402
from juicefs_tpu.chunk import CachedStore as RefCachedStore  # noqa: E402
from juicefs_tpu.chunk import ChunkConfig as RefChunkConfig  # noqa: E402
from juicefs_tpu.meta import Format as RefFormat  # noqa: E402
from juicefs_tpu.meta import new_client as ref_new_client  # noqa: E402
from juicefs_tpu.meta.context import Context as RefContext  # noqa: E402
from juicefs_tpu.meta.types import Attr as RefAttr  # noqa: E402
from juicefs_tpu.object import create_storage as ref_create_storage  # noqa: E402
from juicefs_tpu_torch import cmd as port_cmd  # noqa: E402
from juicefs_tpu_torch import fs as port_fs  # noqa: E402

DRILL_BS = 64 << 10
NAMES = (b"a", b"b", b"c", b"d")


class _Side:
    """One package's VFS over mem meta + mem store, with the drill's open
    handles (one per inode)."""

    def __init__(self, new_client_, format_, cached_store, chunk_config, storage, vfs_mod,
                 ctx, attr_cls):
        self.meta = new_client_("mem://")
        self.meta.init(format_(name="drill", storage="mem", block_size=DRILL_BS >> 10),
                       force=False)
        self.meta.new_session()
        store = cached_store(storage("mem://"),
                             chunk_config(block_size=DRILL_BS, cache_dirs=("memory",)))
        self.vfs = vfs_mod.VFS(self.meta, store)
        self.ctx, self.Attr = ctx, attr_cls
        self.fh: dict[int, int] = {}

    def ino(self, name):
        st, ino, _ = self.vfs.lookup(self.ctx, vfs_root(), name)
        return st, ino

    def handle(self, ino):
        if ino not in self.fh:
            st, _attr, fh = self.vfs.open(self.ctx, ino, os.O_RDWR)
            assert st == 0
            self.fh[ino] = fh
        return self.fh[ino]

    def apply(self, op):
        """Run one drill op; returns what the op observed."""
        kind = op[0]
        if kind == "create":
            st, ino, _attr, fh = self.vfs.create(self.ctx, vfs_root(), op[1], 0o644)
            if st == 0:
                self.fh[ino] = fh
            return st
        if kind == "rename":
            return self.vfs.rename(self.ctx, vfs_root(), op[1], vfs_root(), op[2])[0]
        if kind == "unlink":
            return self.vfs.unlink(self.ctx, vfs_root(), op[1])
        st, ino = self.ino(op[1])
        if st:
            return ("lookup", st)
        if kind == "write":
            return self.vfs.write(self.ctx, ino, self.handle(ino), op[2], op[3])
        if kind == "truncate":
            st, attr = self.vfs.setattr(self.ctx, ino, SET_ATTR_SIZE, self.Attr(length=op[2]))
            return st, attr.length if st == 0 else None
        if kind == "flush":
            return self.vfs.flush(self.ctx, ino, self.handle(ino))
        if kind == "read":
            st, data = self.vfs.read(self.ctx, ino, self.handle(ino), op[2], op[3])
            return st, bytes(data)
        if kind == "getattr":
            st, attr = self.vfs.getattr(self.ctx, ino)
            return st, attr.length
        if kind == "copy":
            st2, dst = self.ino(op[4])
            if st2:
                return ("lookup", st2)
            return self.vfs.copy_file_range(self.ctx, ino, op[2], dst, op[3], op[5])
        raise AssertionError(kind)

    def close(self):
        for ino, fh in self.fh.items():
            self.vfs.release(self.ctx, ino, fh)
        self.vfs.close()


def vfs_root():
    return ROOT_INO


def _drill_ops(seed: int, n: int):
    """A seeded sequence of namespace and data ops. Offsets sit at random
    places, on and around block boundaries, and around the 64 MiB chunk
    boundary, so writes, reads and truncates cross both."""
    rng = np.random.default_rng(seed)

    def offset():
        pick = int(rng.integers(0, 4))
        if pick == 0:
            return int(rng.integers(0, 3 * DRILL_BS))
        if pick == 1:
            return int(rng.integers(1, 4)) * DRILL_BS + int(rng.integers(-9, 10))
        if pick == 2:
            return CHUNK_SIZE + int(rng.integers(-DRILL_BS, DRILL_BS))
        return int(rng.integers(0, 2 * CHUNK_SIZE + DRILL_BS))

    def name():
        return NAMES[int(rng.integers(0, len(NAMES)))]

    ops = [("create", b"a"), ("create", b"b")]
    for _ in range(n):
        kind = int(rng.integers(0, 10))
        if kind == 0:
            ops.append(("create", name()))
        elif kind in (1, 2, 3):
            size = int(rng.integers(1, 2 * DRILL_BS))
            ops.append(("write", name(), offset(), rng.bytes(size)))
        elif kind == 4:
            ops.append(("truncate", name(), offset()))
        elif kind == 5:
            ops.append(("rename", name(), name()))
        elif kind == 6 and rng.random() < 0.5:
            ops.append(("unlink", name()))
        elif kind == 7:
            ops.append(("copy", name(), offset(), offset(), name(),
                        int(rng.integers(1, 3 * DRILL_BS))))
        elif kind == 8:
            ops.append(("flush", name()))
        else:
            ops.append(("read", name(), offset(), int(rng.integers(1, 3 * DRILL_BS))))
        ops.append(("getattr", name()))
    # read back every name whole at the end
    for nm in NAMES:
        ops.append(("read", nm, 0, 2 * DRILL_BS))
        ops.append(("read", nm, CHUNK_SIZE - DRILL_BS, 2 * DRILL_BS))
    return ops


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_drill_matches_reference_vfs(seed):
    """The same seeded op sequence through the JAX package's VFS and the
    port's: every read's bytes, every attr length and every errno agree."""
    ref = _Side(ref_new_client, RefFormat, RefCachedStore, RefChunkConfig, ref_create_storage,
                ref_vfs, RefContext(uid=0, gid=0, pid=1), RefAttr)
    port = _Side(new_client, Format, CachedStore, ChunkConfig, create_storage,
                 __import__("juicefs_tpu_torch.vfs", fromlist=["VFS"]), CTX, Attr)
    try:
        kinds = set()
        for i, op in enumerate(_drill_ops(seed, 120)):
            want, got = ref.apply(op), port.apply(op)
            assert got == want, f"op {i} {op[:3]}: port {got!r:.200} != reference {want!r:.200}"
            kinds.add((op[0], want == 0 or (isinstance(want, tuple) and want[0] == 0)))
        # the drill reached every op, both succeeding and failing somewhere
        assert {k for k, ok in kinds if ok} >= {"create", "write", "truncate", "rename",
                                                "read", "getattr", "flush"}
    finally:
        ref.close()
        port.close()


def _files(seed: int):
    """Files whose sizes cross block boundaries, one empty, one sparse."""
    rng = np.random.default_rng(seed)
    bs = 256 << 10
    return {
        "/d/one.bin": rng.bytes(bs + 7),
        "/d/sub/three-blocks.bin": rng.bytes(3 * bs),
        "/empty": b"",
        "/small.txt": rng.bytes(100),
        "/sparse.bin": None,  # a hole, then bytes at 1 MiB + 3
    }, rng.bytes(5000)


def _write_files(fs, files, tail):
    for path, data in files.items():
        parent = path.rsplit("/", 1)[0]
        if parent:
            fs.makedirs(parent)
        with fs.open(path, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o644) as f:
            if data is None:
                f.pwrite((1 << 20) + 3, tail)
            else:
                f.write(data)


def _check_files(fs, files, tail):
    for path, data in files.items():
        if data is None:
            data = bytes((1 << 20) + 3) + tail
        assert fs.stat(path).length == len(data), path
        with fs.open(path) as f:
            assert f.pread(0, len(data) + 10) == data, path
    assert sorted(e.name for e in fs.listdir("/d") if e.name not in (b".", b"..")) == \
        [b"one.bin", b"sub"]


def _port_open(meta_url, tmp_path):
    m, fmt = port_cmd.open_meta(meta_url)
    m.new_session()
    store = port_cmd.build_store(fmt, types.SimpleNamespace(
        compress_backend="cpu", cache_dir=str(tmp_path / "port-cache")), meta=m)
    v = VFS(m, store, fmt=fmt)
    return port_fs.FileSystem(v), v, m


def _ref_open(meta_url, tmp_path):
    m, fmt = ref_cmd.open_meta(meta_url)
    m.new_session()
    store = ref_cmd.build_store(fmt, types.SimpleNamespace(
        cache_dir=str(tmp_path / "ref-cache"), writeback=False, cache_size=0), meta=m)
    v = ref_vfs.VFS(m, store, fmt=fmt)
    return ref_fs.FileSystem(v), v, m


def _close(v, m):
    v.close()
    v.store.close()
    m.close_session()
    m.client.close()  # one sqlite file, two packages: one client at a time


def test_volume_round_trips_between_packages(tmp_path):
    """A sqlite3:// + file:// volume (lz4, cpu hash backend): files the
    port's FileSystem writes read back identically through the JAX
    package's, and the reverse."""
    meta_url = f"sqlite3://{tmp_path}/vol.db"
    assert port_cmd.main(["format", meta_url, "x", "--storage", "file", "--bucket",
                          str(tmp_path / "blob"), "--block-size", "256", "--compress",
                          "lz4", "--hash-backend", "cpu", "--trash-days", "0"]) == 0
    port_files, port_tail = _files(1)
    ref_files, ref_tail = _files(2)
    ref_files = {"/r" + p: d for p, d in ref_files.items()}

    fs, v, m = _port_open(meta_url, tmp_path)
    try:
        _write_files(fs, port_files, port_tail)
        v.store.indexer.flush()
    finally:
        _close(v, m)

    fs, v, m = _ref_open(meta_url, tmp_path)
    try:
        _check_files(fs, port_files, port_tail)
        fs.makedirs("/r")
        _write_files(fs, ref_files, ref_tail)
        v.store.indexer.flush()
    finally:
        _close(v, m)

    fs, v, m = _port_open(meta_url, tmp_path)
    try:
        _check_files(fs, port_files, port_tail)
        for path, data in ref_files.items():
            if data is None:
                data = bytes((1 << 20) + 3) + ref_tail
            assert fs.read_file(path) == data, path
        # both packages' indexers wrote the same rows for the same bytes
        rows = {d for _sid, _indx, _b, d in m.scan_block_digests()}
        from juicefs_tpu_torch.gpu.jth256 import jth256

        assert jth256(ref_files["/r/d/one.bin"][:256 << 10]) in rows
        assert jth256(port_files["/d/one.bin"][:256 << 10]) in rows
    finally:
        _close(v, m)
