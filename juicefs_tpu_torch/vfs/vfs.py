"""VFS core: the filesystem every presentation adapter serves (a copy of
juicefs_tpu/vfs/vfs.py).

Port of the reference's pkg/vfs/vfs.go surface (vfs.go:155-1157): FUSE, the
S3 gateway, WebDAV, and the SDK all call these methods. Namespace/attr ops
delegate to the metadata engine; file data flows through DataReader /
DataWriter over the chunk store; the handle table binds kernel fds to open
state. Key consistency behaviors preserved from the reference:

  - reads flush overlapping buffered writes first (vfs.go:651 Read calls
    writer flush), so a process always reads its own writes;
  - truncate/fallocate flush the target file before mutating length
    (vfs.go:867-947), and open writers learn the new length;
  - O_APPEND writes land at the current (buffered) end of file;
  - release waits out in-flight ops, flushes, then drops the handle.
"""

from __future__ import annotations

import errno as _errno
import os
import threading
from dataclasses import dataclass, field, replace

from ..chunk import CachedStore
from ..meta.base import BaseMeta
from ..meta.context import Context
from ..meta.types import (
    Attr,
    CHUNK_SIZE,
    Entry,
    Format,
    SET_ATTR_SIZE,
    TYPE_DIRECTORY,
    TYPE_FILE,
)
from ..metric import global_registry
from ..qos import tenant_scope
from ..utils import get_logger
from .accesslog import AccessLogger
from .cache import MetaCache
from .handles import Handle, HandleTable
from .internal import INTERNAL_NAMES, InternalFiles, internal_attr, is_internal
from .reader import DataReader
from .writer import DataWriter

logger = get_logger("vfs")

ROOT_INO = 1
MAX_FILE_SIZE = CHUNK_SIZE << 31  # cap file length like the reference
MAX_SYMLINK = 4096


@dataclass
class VFSConfig:
    readonly: bool = False
    max_readahead: int = 8 << 20
    # epoch-streaming read path: a handle sustaining
    # sequential progress past `streaming_after` bytes escalates from the
    # block-granularity window doubler to file-granularity readahead
    # capped at `max_streaming` (further bounded by the prefetch queue)
    streaming_read: bool = True
    streaming_after: int = 16 << 20
    max_streaming: int = 64 << 20
    attr_timeout: float = 1.0
    entry_timeout: float = 1.0
    dir_entry_timeout: float = 1.0
    hide_internal: bool = False
    extra: dict = field(default_factory=dict)


class VFS:
    def __init__(
        self,
        meta: BaseMeta,
        store: CachedStore,
        conf: VFSConfig | None = None,
        fmt: Format | None = None,
    ):
        self.meta = meta
        self.store = store
        self.conf = conf or VFSConfig()
        self.fmt = fmt
        self.handles = HandleTable()
        self.writer = DataWriter(meta, store)
        self.reader = DataReader(
            meta, store, self.conf.max_readahead, writer=self.writer,
            streaming=self.conf.streaming_read,
            streaming_after=self.conf.streaming_after,
            max_streaming=self.conf.max_streaming,
        )
        self._append_lock = threading.Lock()
        # entry/attr TTL caches (vfs/cache.py): kernel-style caching for
        # every adapter; local mutations invalidate synchronously below
        self.cache = MetaCache(self.conf.attr_timeout, self.conf.entry_timeout,
                               self.conf.dir_entry_timeout)
        # push invalidation: peers' changes arrive via the
        # session refresher well inside the TTLs; the FUSE server attaches
        # itself as kernel_notifier so the dcache is poked too
        self.kernel_notifier = None
        if hasattr(meta, "on_invalidate"):
            meta.on_invalidate(self._remote_invalidate)
        self.accesslog = AccessLogger()
        self.internal = InternalFiles(self)
        self._op_hist = global_registry().histogram(
            "juicefs_fuse_ops_durations_histogram_seconds",
            "Operation latencies (reference vfs/accesslog.go:30-46)",
            ("method",),
        )
        # memory accounting (reference vfs.go:1276-1315 buffer gauges +
        # pkg/utils/alloc.go): scraped via /metrics and `juicefs stats`
        reg = global_registry()
        reg.gauge(
            "juicefs_used_buffer_size_bytes",
            "Bytes in un-uploaded write buffers",
        ).set_function(self.writer.buffered_bytes)
        reg.gauge(
            "juicefs_blockcache_bytes", "Bytes in the local block cache"
        ).set_function(lambda: self.store.cache.stats()[1])
        reg.gauge(
            "juicefs_blockcache_blocks", "Blocks in the local block cache"
        ).set_function(lambda: self.store.cache.stats()[0])
        reg.gauge(
            "juicefs_index_dropped_blocks",
            "Blocks skipped by the content indexer under overload "
            "(advisory index; gc --dedup backfills)",
        ).set_function(
            lambda: self.store.indexer.dropped if self.store.indexer else 0
        )
        self._instrument()

    def _instrument(self) -> None:
        """Wrap public ops with latency metrics + access logging + vfs-layer
        spans (reference: every VFS method logit()s, accesslog.go:64). Ops
        on the internal virtual files are never logged or traced — they
        would feed the very stream being read."""
        import time as _time

        from ..metric.trace import NULL_SPAN, global_tracer

        self._op_depth = threading.local()
        tracer = global_tracer()

        for name in (
            "lookup", "getattr", "setattr", "mknod", "mkdir", "unlink",
            "rmdir", "rename", "link", "symlink", "readdir", "create",
            "open", "read", "write", "flush", "fsync", "release",
            "truncate_ino", "copy_file_range", "statfs",
        ):
            orig = getattr(self, name)
            op_hist = self._op_hist.labels(name)

            def wrapper(ctx, *a, __orig=orig, __name=name, __hist=op_hist, **kw):
                # Only the outermost op records: fsync->flush and
                # O_APPEND-write->getattr are internal self-calls, not
                # kernel requests (one log line per VFS op, like the
                # reference).
                if getattr(self._op_depth, "d", 0) > 0:
                    return __orig(ctx, *a, **kw)
                internal = (
                    bool(a) and isinstance(a[0], int) and is_internal(a[0])
                )
                sp = NULL_SPAN if internal else tracer.span("vfs", __name)
                self._op_depth.d = 1
                t0 = _time.perf_counter()
                # tenant tagging of meta ops: EVERY vfs op runs
                # under the request uid's tenant scope, so the per-tenant
                # meta-op limiter and the DRR fairness queues attribute
                # lookups/getattrs — not just block I/O — to the real user
                with sp, tenant_scope(getattr(ctx, "uid", 0)):
                    try:
                        out = __orig(ctx, *a, **kw)
                    finally:
                        self._op_depth.d = 0
                        dur = _time.perf_counter() - t0
                        __hist.observe(dur)
                    err = out[0] if isinstance(out, tuple) else out
                    if not isinstance(err, int):
                        err = 0
                    if sp.active:
                        sp.set(
                            ino=a[0] if a and isinstance(a[0], int) else 0,
                            errno=err,
                        )
                    if self.accesslog.active and not internal:
                        args = ",".join(
                            str(x) for x in a[:3] if isinstance(x, (int, bytes, str))
                        )
                        self.accesslog.logit(
                            __name, args, err, dur,
                            pid=getattr(ctx, "pid", 0),
                            uid=getattr(ctx, "uid", 0),
                            gid=getattr(ctx, "gid", 0),
                        )
                return out

            setattr(self, name, wrapper)

    # -- namespace ---------------------------------------------------------

    def lookup(self, ctx: Context, parent: int, name: bytes) -> tuple[int, int, Attr]:
        if parent == ROOT_INO and name in INTERNAL_NAMES:
            ino, attr = self.internal.lookup(name)
            return 0, ino, attr
        # "." / ".." resolve relative to a directory whose parentage can
        # change under rename with no (parent, name) key to invalidate —
        # never cache them.
        cacheable = name not in (b".", b"..")
        if cacheable:
            ino = self.cache.get_entry(parent, name)
            if ino is not None:
                attr = self.cache.get_attr(ino)
                if attr is not None:
                    # The dentry is shared across users, so the parent
                    # execute-permission check meta.lookup would do must
                    # still run per-caller (cached parent attr avoids the
                    # round trip on warm walks).
                    from ..meta.base import MODE_MASK_X

                    st = self.meta.access(
                        ctx, parent, MODE_MASK_X, self.cache.get_attr(parent)
                    )
                    if st != 0:
                        return st, 0, Attr()
                    return 0, ino, self._overlay_length(ino, attr)
        st, ino, attr = self.meta.lookup(ctx, parent, name)
        if st == 0:
            if cacheable:
                self.cache.put_entry(parent, name, ino)
                self.cache.put_attr(ino, attr)
            attr = self._overlay_length(ino, attr)
        return st, ino, attr

    def _overlay_length(self, ino: int, attr: Attr) -> Attr:
        """Surface buffered writes in stat (reference UpdateLength). Copy
        first: the attr may be a cached instance (meta openfile cache or
        our TTL cache) and mutating it would poison the cache."""
        if attr.typ == TYPE_FILE:
            wlen = self.writer.get_length(ino)
            if wlen is not None and wlen > attr.length:
                attr = replace(attr)
                attr.length = wlen
        return attr

    def getattr(self, ctx: Context, ino: int) -> tuple[int, Attr]:
        if is_internal(ino):
            return 0, internal_attr(ino)
        attr = self.cache.get_attr(ino)
        if attr is not None:
            return 0, self._overlay_length(ino, attr)
        st, attr = self.meta.getattr(ctx, ino)
        if st == 0:
            self.cache.put_attr(ino, attr)
            attr = self._overlay_length(ino, attr)
        return st, attr

    def setattr(self, ctx: Context, ino: int, flags: int, attr: Attr) -> tuple[int, Attr]:
        if self.conf.readonly:
            return _errno.EROFS, Attr()
        if flags & SET_ATTR_SIZE:
            if attr.length > MAX_FILE_SIZE:
                return _errno.EFBIG, Attr()
            st = self.writer.flush(ino)
            if st != 0:
                return st, Attr()
        st, out = self.meta.setattr(ctx, ino, flags, attr)
        if st == 0:
            self.cache.attr_mutated(ino, out)
            if flags & SET_ATTR_SIZE:
                self.writer.truncate(ino, out.length)
        return st, out

    def _remote_invalidate(self, events: list[tuple]) -> None:
        """Another client changed these: drop TTL caches now (instead of
        waiting out the TTL) and poke the kernel's attr/page/dcache
        (reference pkg/vfs/vfs.go:1228 invalidation callbacks)."""
        kn = self.kernel_notifier
        for ev in events:
            if ev[0] == "a":
                ino = ev[1]
                self.cache.invalidate_attr(ino)
                self.cache.invalidate_dir(ino)
                if kn is not None:
                    try:
                        kn.notify_inval_inode(ino)
                    except Exception:
                        pass
            elif ev[0] == "e":
                parent, name = ev[1], ev[2]
                self.cache.invalidate_entry(parent, name)
                if kn is not None:
                    try:
                        kn.notify_inval_entry(parent, name)
                    except Exception:
                        pass

    def _entry_created(self, parent: int, name: bytes, ino: int, attr: Attr) -> None:
        """Cache bookkeeping after a successful namespace insert: the new
        dentry/attr are known exactly; the parent's attr (mtime, nlink for
        mkdir) changed in meta, so drop it."""
        self.cache.invalidate_attr(parent)
        self.cache.invalidate_dir(parent)
        self.cache.put_entry(parent, name, ino)
        # mutation-grade: a hardlink target's nlink changed in EVERY
        # directory snapshot that embeds it, not just the new parent's
        self.cache.attr_mutated(ino, attr)

    def _entry_removed(self, parent: int, name: bytes) -> None:
        ino = self.cache.invalidate_entry(parent, name)
        self.cache.invalidate_attr(parent)
        if ino is not None:
            self.cache.invalidate_attr(ino)  # nlink/ctime changed

    def mknod(self, ctx, parent, name, mode, cumask=0, rdev=0) -> tuple[int, int, Attr]:
        if self.conf.readonly:
            return _errno.EROFS, 0, Attr()
        st, ino, attr = self.meta.mknod(ctx, parent, name, TYPE_FILE, mode, cumask, rdev)
        if st == 0:
            self._entry_created(parent, name, ino, attr)
        return st, ino, attr

    def mkdir(self, ctx, parent, name, mode, cumask=0) -> tuple[int, int, Attr]:
        if self.conf.readonly:
            return _errno.EROFS, 0, Attr()
        st, ino, attr = self.meta.mkdir(ctx, parent, name, mode, cumask)
        if st == 0:
            self._entry_created(parent, name, ino, attr)
        return st, ino, attr

    def symlink(self, ctx, parent, name, target: bytes) -> tuple[int, int, Attr]:
        if self.conf.readonly:
            return _errno.EROFS, 0, Attr()
        if len(target) >= MAX_SYMLINK:
            return _errno.ENAMETOOLONG, 0, Attr()
        st, ino, attr = self.meta.symlink(ctx, parent, name, target)
        if st == 0:
            self._entry_created(parent, name, ino, attr)
        return st, ino, attr

    def readlink(self, ctx, ino) -> tuple[int, bytes]:
        return self.meta.readlink(ctx, ino)

    def unlink(self, ctx, parent, name) -> int:
        if self.conf.readonly:
            return _errno.EROFS
        st = self.meta.unlink(ctx, parent, name)
        if st == 0:
            self._entry_removed(parent, name)
        return st

    def rmdir(self, ctx, parent, name) -> int:
        if self.conf.readonly:
            return _errno.EROFS
        st = self.meta.rmdir(ctx, parent, name)
        if st == 0:
            self._entry_removed(parent, name)
        return st

    def rename(self, ctx, psrc, nsrc, pdst, ndst, flags=0) -> tuple[int, int, Attr]:
        if self.conf.readonly:
            return _errno.EROFS, 0, Attr()
        st, ino, attr = self.meta.rename(ctx, psrc, nsrc, pdst, ndst, flags)
        if st == 0:
            self._entry_removed(psrc, nsrc)
            self._entry_removed(pdst, ndst)  # replaced target (if any)
            if not flags:  # EXCHANGE/WHITEOUT: leave both uncached
                self.cache.put_entry(pdst, ndst, ino)
                self.cache.put_attr(ino, attr)
        return st, ino, attr

    def link(self, ctx, ino, parent, name) -> tuple[int, Attr]:
        if self.conf.readonly:
            return _errno.EROFS, Attr()
        st = self.writer.flush(ino)
        if st != 0:
            return st, Attr()
        st, attr = self.meta.link(ctx, ino, parent, name)
        if st == 0:
            self._entry_created(parent, name, ino, attr)
        return st, attr

    # -- directories -------------------------------------------------------

    def opendir(self, ctx: Context, ino: int) -> tuple[int, int]:
        st, attr = self.meta.getattr(ctx, ino)
        if st != 0:
            return st, 0
        if attr.typ != TYPE_DIRECTORY:
            return _errno.ENOTDIR, 0
        h = self.handles.new(ino)
        return 0, h.fh

    def readdir(
        self, ctx: Context, ino: int, fh: int, offset: int, want_attr: bool = False
    ) -> tuple[int, list[Entry]]:
        h = self.handles.get(fh)
        if h is None:
            return _errno.EBADF, []
        if h.children is None or offset == 0:
            entries = self.cache.get_dir(ino, want_attr)
            if entries is not None:
                # snapshot is shared across users: re-check this caller's
                # read permission (same rule as cached lookups)
                st = self.meta.access(ctx, ino, 4, self.cache.get_attr(ino))
                if st != 0:
                    return st, []
            else:
                gen = self.cache.dir_read_begin()
                st, entries = self.meta.readdir(ctx, ino, want_attr)
                if st != 0:
                    return st, []
                self.cache.put_dir(ino, want_attr, entries, gen=gen)
            h.children = entries
        return 0, h.children[offset:]

    def releasedir(self, ctx: Context, fh: int) -> int:
        self.handles.remove(fh)
        return 0

    # -- files -------------------------------------------------------------

    def create(
        self, ctx: Context, parent: int, name: bytes, mode: int, cumask: int = 0,
        flags: int = os.O_RDWR,
    ) -> tuple[int, int, Attr, int]:
        if self.conf.readonly:
            return _errno.EROFS, 0, Attr(), 0
        st, ino, attr = self.meta.create(ctx, parent, name, mode, cumask, flags)
        if st != 0:
            return st, 0, Attr(), 0
        self._entry_created(parent, name, ino, attr)
        fh = self._new_file_handle(ino, attr.length, flags)
        return 0, ino, attr, fh

    def open(self, ctx: Context, ino: int, flags: int) -> tuple[int, Attr, int]:
        if is_internal(ino):
            h = self.handles.new(ino, flags)
            self.internal.open(ino, h.fh)
            return 0, internal_attr(ino), h.fh
        accmode = flags & os.O_ACCMODE
        if self.conf.readonly and (
            accmode != os.O_RDONLY or flags & (os.O_TRUNC | os.O_APPEND)
        ):
            return _errno.EROFS, Attr(), 0
        st, attr = self.meta.open(ctx, ino, flags)
        if st != 0:
            return st, Attr(), 0
        if flags & os.O_TRUNC:
            st, attr = self.truncate_ino(ctx, ino, 0)
            if st != 0:
                self.meta.close(ctx, ino)
                return st, Attr(), 0
        fh = self._new_file_handle(ino, attr.length, flags)
        return 0, attr, fh

    # With the kernel writeback cache the kernel issues READs on handles
    # the app opened O_WRONLY (read-modify-write of partial pages); the
    # FUSE server sets this so such handles carry a reader too.
    always_readable_handles = False

    def _new_file_handle(self, ino: int, length: int, flags: int) -> int:
        h = self.handles.new(ino, flags)
        accmode = flags & os.O_ACCMODE
        if accmode in (os.O_RDONLY, os.O_RDWR) or self.always_readable_handles:
            h.reader = self.reader.open(ino)
        if accmode in (os.O_WRONLY, os.O_RDWR):
            h.writer = self.writer.open(ino, length)
        return h.fh

    def read(self, ctx: Context, ino: int, fh: int, off: int, size: int) -> tuple[int, bytes]:
        h = self.handles.get(fh)
        if h is None or h.ino != ino:
            return _errno.EBADF, b""
        if is_internal(ino):
            return self.internal.read(ino, fh, off, size)
        if h.reader is None:
            return _errno.EACCES, b""
        if off >= MAX_FILE_SIZE or size > (64 << 20):
            return _errno.EFBIG, b""
        # Read-after-write consistency: push buffered writes down first,
        # but only when they overlap the read range (avoids slice churn
        # in interleaved write/read workloads).
        fw = self.writer.find(ino)
        if fw is not None:
            st = fw.flush_if_overlaps(off, size)
            if st != 0:
                return st, b""
        h.begin_read()
        try:
            # per-tenant fair queueing: block I/O this read fans
            # out is DRR-queued under the requesting uid, so one user
            # flooding reads cannot monopolize the foreground class
            with tenant_scope(ctx.uid):
                return h.reader.read(ctx, off, size)
        finally:
            h.end_read()

    def write(self, ctx: Context, ino: int, fh: int, off: int, data: bytes) -> int:
        h = self.handles.get(fh)
        if h is None or h.ino != ino:
            return _errno.EBADF
        if is_internal(ino):
            return self.internal.write(ctx, ino, fh, data)
        if h.writer is None:
            return _errno.EACCES
        if off + len(data) > MAX_FILE_SIZE:
            return _errno.EFBIG
        h.begin_write()
        try:
            # uploads triggered by this write are queued under the
            # requesting uid (per-tenant fair queueing)
            with tenant_scope(ctx.uid):
                # Kernel-writeback mode: the kernel positions O_APPEND
                # writes itself and flushes whole cached pages at explicit
                # offsets — re-deriving EOF here would double-place the
                # data.
                if h.flags & os.O_APPEND and not self.always_readable_handles:
                    with self._append_lock:
                        st, attr = self.getattr(ctx, ino)
                        if st != 0:
                            return st
                        return h.writer.write(attr.length, data)
                return h.writer.write(off, data)
        finally:
            h.end_write()

    def flush(self, ctx: Context, ino: int, fh: int, lock_owner: int = 0) -> int:
        h = self.handles.get(fh)
        if h is None:
            return _errno.EBADF
        if is_internal(ino):
            # virtual files: nothing to flush and no POSIX locks — the
            # unlock-on-close below would dial the meta engine, making
            # `.status`/`.stats` reads fail at CLOSE during the very
            # outage they exist to observe
            return 0
        if h.writer is not None:
            st = h.writer.flush()
            if st != 0:
                return st
        # fsync barrier for the checkpoint write plane: the
        # slice commits the writer just queued — and the create that
        # opened this file — must be durably committed before fsync
        # acks; a deferred failure surfaces here, never silently (the
        # vfs/writer.py sticky-error contract at the meta layer).
        # OUTSIDE the writer guard: POSIX fsync flushes the FILE, so an
        # O_RDONLY fd of a file with pending batched mutations must
        # drain them too.
        st = self.meta.sync_meta(ino)
        if st != 0:
            return st
        if h.writer is not None:
            self.cache.invalidate_attr(ino)  # committed length/mtime
        # Drop this owner's POSIX locks on close, per POSIX close(2).
        if lock_owner and hasattr(self.meta, "setlk"):
            try:
                self.meta.setlk(
                    ctx, ino, lock_owner, self.meta.F_UNLCK, 0,
                    0x7FFFFFFFFFFFFFFF
                )
            except OSError as e:
                # (POSIX results are RETURN codes here — setlk only
                # raises for engine faults: MetaNetworkError pre-trip,
                # MetaUnavailableError once the breaker is open)
                # best-effort during a meta outage: the engine
                # that holds the lock table is dark, so the lock is
                # unenforceable right now and dies with the session
                # either way — failing the CLOSE of (usually unlocked)
                # files would turn every degraded read into an EIO
                logger.warning("unlock-on-close skipped (meta down): %s", e)
        return 0

    def fsync(self, ctx: Context, ino: int, fh: int) -> int:
        return self.flush(ctx, ino, fh)

    def release(self, ctx: Context, ino: int, fh: int) -> int:
        h = self.handles.remove(fh)
        if h is None:
            return 0
        if is_internal(ino):
            self.internal.release(ino, fh)
            return 0
        h.wait_quiet()
        st = 0
        if h.writer is not None:
            st = self.writer.close(ino)
            self.cache.invalidate_attr(ino)
        # meta close is the last write-batch barrier for this inode: a
        # deferred commit that failed after the final fsync surfaces here
        st2 = self.meta.close(ctx, ino)
        return st or st2

    # -- data shaping ------------------------------------------------------

    def truncate_ino(self, ctx: Context, ino: int, length: int) -> tuple[int, Attr]:
        st = self.writer.flush(ino)
        if st != 0:
            return st, Attr()
        st, attr = self.meta.truncate(ctx, ino, length)
        if st == 0:
            self.cache.attr_mutated(ino, attr)
            self.writer.truncate(ino, length)
        return st, attr

    def fallocate(self, ctx: Context, ino: int, fh: int, mode: int, off: int, size: int) -> int:
        if self.conf.readonly:
            return _errno.EROFS
        h = self.handles.get(fh)
        if h is None or h.writer is None:
            return _errno.EBADF
        if off + size > MAX_FILE_SIZE:
            return _errno.EFBIG
        st = self.writer.flush(ino)
        if st != 0:
            return st
        st = self.meta.fallocate(ctx, ino, mode, off, size)
        if st == 0:
            self.cache.invalidate_attr(ino)
        return st

    def copy_file_range(
        self, ctx: Context, fin: int, off_in: int, fout: int, off_out: int,
        size: int, flags: int = 0,
    ) -> tuple[int, int]:
        if self.conf.readonly:
            return _errno.EROFS, 0
        for ino in (fin, fout):
            st = self.writer.flush(ino)
            if st != 0:
                return st, 0
        st, copied = self.meta.copy_file_range(ctx, fin, off_in, fout, off_out, size, flags)
        if st == 0:
            self.cache.invalidate_attr(fout)
        return st, copied

    # -- xattr / statfs / ACLs ---------------------------------------------
    # system.posix_acl_* xattrs bridge to GetFacl/SetFacl meta ops with the
    # kernel wire codec (reference pkg/vfs/vfs.go:1040-1160, 1348-1420).

    _ACL_XATTRS = {
        b"system.posix_acl_access": 1,   # acl.TYPE_ACCESS
        b"system.posix_acl_default": 2,  # acl.TYPE_DEFAULT
    }

    def _acl_enabled(self) -> bool:
        return bool(self.fmt is not None and self.fmt.enable_acl)

    def getxattr(self, ctx, ino, name) -> tuple[int, bytes]:
        acl_type = self._ACL_XATTRS.get(bytes(name))
        if acl_type is not None:
            from ..meta import acl as _acl

            if not self._acl_enabled():
                return _errno.ENOTSUP, b""
            st, rule = self.meta.get_facl(ctx, ino, acl_type)
            if st != 0:
                return st, b""
            return 0, _acl.to_xattr(rule)
        return self.meta.getxattr(ctx, ino, name)

    def setxattr(self, ctx, ino, name, value, flags=0) -> int:
        if self.conf.readonly:
            return _errno.EROFS
        acl_type = self._ACL_XATTRS.get(bytes(name))
        if acl_type is not None:
            from ..meta import acl as _acl

            if not self._acl_enabled():
                return _errno.ENOTSUP
            rule = _acl.from_xattr(bytes(value))
            if rule is None:
                return _errno.EINVAL
            st = self.meta.set_facl(ctx, ino, acl_type, rule)
        else:
            st = self.meta.setxattr(ctx, ino, name, value, flags)
        if st == 0:
            self.cache.invalidate_attr(ino)  # mode/ctime changed
        return st

    def listxattr(self, ctx, ino) -> tuple[int, list[bytes]]:
        st, names = self.meta.listxattr(ctx, ino)
        if st == 0 and self._acl_enabled():
            st2, attr = self.getattr(ctx, ino)
            if st2 == 0:
                if getattr(attr, "access_acl", 0):
                    names = list(names) + [b"system.posix_acl_access"]
                if getattr(attr, "default_acl", 0):
                    names = list(names) + [b"system.posix_acl_default"]
        return st, names

    def removexattr(self, ctx, ino, name) -> int:
        if self.conf.readonly:
            return _errno.EROFS
        acl_type = self._ACL_XATTRS.get(bytes(name))
        if acl_type is not None:
            from ..meta import acl as _acl

            if not self._acl_enabled():
                return _errno.ENOTSUP
            st = self.meta.set_facl(ctx, ino, acl_type, _acl.empty_rule())
        else:
            st = self.meta.removexattr(ctx, ino, name)
        if st == 0:
            self.cache.invalidate_attr(ino)
        return st

    def statfs(self, ctx) -> tuple[int, int, int, int]:
        return self.meta.statfs(ctx)

    # -- lifecycle / seamless upgrade --------------------------------------

    def dump_handles(self) -> list[dict]:
        """Serializable open-handle state for fd-passing takeover
        (reference vfs/handle.go:302 dump). Writers must be flushed by the
        caller first — only structural state crosses the boundary."""
        out = []
        for h in self.handles.all():
            if is_internal(h.ino):
                continue  # internal virtual files don't survive a swap
            out.append({
                "fh": h.fh,
                "ino": h.ino,
                "flags": h.flags,
                "lock_owner": h.lock_owner,
                "dir": h.reader is None and h.writer is None,
            })
        return out

    def restore_handles(self, dumped: list[dict]) -> None:
        """Rebuild the handle table from a predecessor's dump
        (reference vfs/handle.go:351 restore)."""
        from ..meta.context import BACKGROUND

        for d in dumped:
            h = self.handles.insert(int(d["fh"]), int(d["ino"]), int(d["flags"]))
            h.lock_owner = int(d.get("lock_owner", 0))
            if d.get("dir"):
                continue
            accmode = h.flags & os.O_ACCMODE
            if accmode in (os.O_RDONLY, os.O_RDWR) or self.always_readable_handles:
                h.reader = self.reader.open(h.ino)
            if accmode in (os.O_WRONLY, os.O_RDWR):
                st, attr = self.meta.getattr(BACKGROUND, h.ino)
                h.writer = self.writer.open(h.ino, attr.length if st == 0 else 0)
            # the meta open-file refcount moved with the session id; the
            # local openfile cache just needs the entry back
            self.meta.open(BACKGROUND, h.ino, 0)

    def flush_all(self) -> int:
        return self.writer.flush_all()

    def close(self) -> None:
        self.writer.close_all()
        self.store.flush_all()
        self.reader.close()
        self.kernel_notifier = None
        if hasattr(self.meta, "off_invalidate"):
            self.meta.off_invalidate(self._remote_invalidate)
