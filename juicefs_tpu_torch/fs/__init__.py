"""Path-based FileSystem SDK (a copy of juicefs_tpu/fs; reference: pkg/fs).

The embedding surface the S3 gateway, WebDAV server, and applications use
(reference pkg/fs/fs.go:130 FileSystem / NewFileSystem:163): path
resolution + per-open File handles with Seek/Pread semantics over the same
VFS core the FUSE mount serves, so every client sees identical behavior.
"""

from __future__ import annotations

import errno as _errno
import os
import posixpath
import threading
from typing import Optional

from ..meta.context import Context
from ..meta.types import Attr, Entry, TYPE_DIRECTORY, TYPE_FILE, TYPE_SYMLINK
from ..utils import lockwatch
from ..vfs import ROOT_INO, VFS

__all__ = ["FileSystem", "File", "FSError"]


class FSError(OSError):
    def __init__(self, err: int, path: str = ""):
        super().__init__(err, os.strerror(err), path)


def _split(path: str) -> list[bytes]:
    path = posixpath.normpath("/" + path.strip())
    return [p.encode() for p in path.split("/") if p and p != "."]


class FileSystem:
    """Path-based operations over a VFS (reference fs.go FileSystem)."""

    def __init__(self, vfs: VFS, ctx: Optional[Context] = None):
        self.vfs = vfs
        self.ctx = ctx or Context(uid=0, gid=0, pid=os.getpid())

    # -- resolution --------------------------------------------------------

    MAX_SYMLINK_DEPTH = 40  # matches kernel SYMLOOP_MAX behavior (ELOOP)

    def resolve(
        self, path: str, follow: bool = True, _depth: int = 0
    ) -> tuple[int, int, Attr]:
        parts = _split(path)
        ino = ROOT_INO
        st, attr = self.vfs.getattr(self.ctx, ino)
        if st:
            return st, 0, Attr()
        for i, name in enumerate(parts):
            st, ino, attr = self.vfs.lookup(self.ctx, ino, name)
            if st:
                return st, 0, Attr()
            if attr.typ == TYPE_SYMLINK and (follow or i < len(parts) - 1):
                if _depth >= self.MAX_SYMLINK_DEPTH:
                    return _errno.ELOOP, 0, Attr()
                st, target = self.vfs.readlink(self.ctx, ino)
                if st:
                    return st, 0, Attr()
                t = target.decode()
                if not t.startswith("/"):
                    # Relative targets resolve against the symlink's parent.
                    parent_dir = "/" + "/".join(p.decode() for p in parts[:i])
                    t = posixpath.join(parent_dir, t)
                st, ino, attr = self.resolve(t, True, _depth + 1)
                if st:
                    return st, 0, Attr()
        return 0, ino, attr

    def _parent_of(self, path: str) -> tuple[int, int, bytes]:
        parts = _split(path)
        if not parts:
            return _errno.EINVAL, 0, b""
        st, parent, attr = self.resolve("/".join(p.decode() for p in parts[:-1]))
        if st:
            return st, 0, b""
        return 0, parent, parts[-1]

    # -- namespace ---------------------------------------------------------

    def stat(self, path: str, follow: bool = True) -> Attr:
        st, ino, attr = self.resolve(path, follow)
        if st:
            raise FSError(st, path)
        return attr

    def exists(self, path: str) -> bool:
        return self.resolve(path)[0] == 0

    def mkdir(self, path: str, mode: int = 0o777) -> None:
        st, parent, name = self._parent_of(path)
        if st == 0:
            st, _, _ = self.vfs.mkdir(self.ctx, parent, name, mode)
        if st:
            raise FSError(st, path)

    def makedirs(self, path: str, mode: int = 0o777) -> None:
        parts = _split(path)
        cur = ""
        for p in parts:
            cur += "/" + p.decode()
            st, ino, attr = self.resolve(cur)
            if st == _errno.ENOENT:
                try:
                    self.mkdir(cur, mode)
                except FSError as e:
                    # Concurrent creator won the race: fine if it's a dir.
                    if e.errno != _errno.EEXIST:
                        raise
                    if self.stat(cur).typ != TYPE_DIRECTORY:
                        raise FSError(_errno.ENOTDIR, cur)
            elif st:
                raise FSError(st, cur)
            elif attr.typ != TYPE_DIRECTORY:
                raise FSError(_errno.ENOTDIR, cur)

    def unlink(self, path: str) -> None:
        st, parent, name = self._parent_of(path)
        if st == 0:
            st = self.vfs.unlink(self.ctx, parent, name)
        if st:
            raise FSError(st, path)

    def rmdir(self, path: str) -> None:
        st, parent, name = self._parent_of(path)
        if st == 0:
            st = self.vfs.rmdir(self.ctx, parent, name)
        if st:
            raise FSError(st, path)

    def remove_all(self, path: str) -> int:
        """Recursive delete (reference fs Rmr); returns entries removed."""
        st, parent, name = self._parent_of(path)
        if st:
            raise FSError(st, path)
        st, n = self.vfs.meta.remove_recursive(self.ctx, parent, name, skip_trash=False)
        # bulk removal bypassed the VFS per-op invalidation hooks
        self.vfs.cache.clear()
        if st and st != _errno.ENOENT:
            raise FSError(st, path)
        return n

    def rename(self, src: str, dst: str, flags: int = 0) -> None:
        st, psrc, nsrc = self._parent_of(src)
        if st:
            raise FSError(st, src)
        st, pdst, ndst = self._parent_of(dst)
        if st:
            raise FSError(st, dst)
        st, _, _ = self.vfs.rename(self.ctx, psrc, nsrc, pdst, ndst, flags)
        if st:
            raise FSError(st, src)

    def symlink(self, target: str, path: str) -> None:
        st, parent, name = self._parent_of(path)
        if st == 0:
            st, _, _ = self.vfs.symlink(self.ctx, parent, name, target.encode())
        if st:
            raise FSError(st, path)

    def readlink(self, path: str) -> str:
        st, ino, attr = self.resolve(path, follow=False)
        if st == 0:
            st, target = self.vfs.readlink(self.ctx, ino)
        if st:
            raise FSError(st, path)
        return target.decode()

    def listdir(self, path: str, want_attr: bool = False) -> list[Entry]:
        st, ino, attr = self.resolve(path)
        if st:
            raise FSError(st, path)
        st, entries = self.vfs.meta.readdir(self.ctx, ino, want_attr)
        if st:
            raise FSError(st, path)
        return [e for e in entries if e.name not in (b".", b"..")]

    def chmod(self, path: str, mode: int) -> None:
        from ..meta.types import SET_ATTR_MODE

        st, ino, _ = self.resolve(path)
        if st == 0:
            st, _ = self.vfs.setattr(self.ctx, ino, SET_ATTR_MODE, Attr(mode=mode & 0o7777))
        if st:
            raise FSError(st, path)

    def chown(self, path: str, uid: int = -1, gid: int = -1) -> None:
        from ..meta.types import SET_ATTR_GID, SET_ATTR_UID

        flags = 0
        a = Attr()
        if uid >= 0:
            flags |= SET_ATTR_UID
            a.uid = uid
        if gid >= 0:
            flags |= SET_ATTR_GID
            a.gid = gid
        st, ino, _ = self.resolve(path)
        if st == 0:
            st, _ = self.vfs.setattr(self.ctx, ino, flags, a)
        if st:
            raise FSError(st, path)

    def utime(self, path: str, atime: float, mtime: float) -> None:
        from ..meta.types import SET_ATTR_ATIME, SET_ATTR_MTIME

        a = Attr(atime=int(atime), mtime=int(mtime),
                 atimensec=int((atime % 1) * 1e9), mtimensec=int((mtime % 1) * 1e9))
        st, ino, _ = self.resolve(path)
        if st == 0:
            st, _ = self.vfs.setattr(
                self.ctx, ino, SET_ATTR_ATIME | SET_ATTR_MTIME, a
            )
        if st:
            raise FSError(st, path)

    def truncate(self, path: str, length: int) -> None:
        st, ino, _ = self.resolve(path)
        if st == 0:
            st, _ = self.vfs.truncate_ino(self.ctx, ino, length)
        if st:
            raise FSError(st, path)

    def summary(self, path: str):
        st, ino, _ = self.resolve(path)
        if st:
            raise FSError(st, path)
        st, s = self.vfs.meta.summary(self.ctx, ino)
        if st:
            raise FSError(st, path)
        return s

    def statfs(self):
        return self.vfs.statfs(self.ctx)

    def getxattr(self, path: str, name: bytes) -> bytes:
        st, ino, _ = self.resolve(path)
        if st == 0:
            st, val = self.vfs.getxattr(self.ctx, ino, name)
        if st:
            raise FSError(st, path)
        return val

    def setxattr(self, path: str, name: bytes, value: bytes) -> None:
        st, ino, _ = self.resolve(path)
        if st == 0:
            st = self.vfs.setxattr(self.ctx, ino, name, value)
        if st:
            raise FSError(st, path)

    # -- files -------------------------------------------------------------

    def open(self, path: str, flags: int = os.O_RDONLY, mode: int = 0o666) -> "File":
        st, ino, attr = self.resolve(path)
        if st == _errno.ENOENT and flags & os.O_CREAT:
            st, parent, name = self._parent_of(path)
            if st:
                raise FSError(st, path)
            st, ino, attr, fh = self.vfs.create(self.ctx, parent, name, mode, 0, flags)
            if st:
                raise FSError(st, path)
            return File(self, ino, fh, path, attr)
        if st:
            raise FSError(st, path)
        if attr.typ == TYPE_DIRECTORY:
            raise FSError(_errno.EISDIR, path)
        if flags & os.O_CREAT and flags & os.O_EXCL:
            raise FSError(_errno.EEXIST, path)
        st, attr, fh = self.vfs.open(self.ctx, ino, flags)
        if st:
            raise FSError(st, path)
        f = File(self, ino, fh, path, attr)
        if flags & os.O_APPEND:
            f._pos = attr.length
        return f

    def create(self, path: str, mode: int = 0o666, overwrite: bool = True) -> "File":
        flags = os.O_RDWR | os.O_CREAT | (os.O_TRUNC if overwrite else os.O_EXCL)
        return self.open(path, flags, mode)

    def copy_range(self, src: str, dst: str, off_out: int = 0,
                   off_in: int = 0, size: int = -1) -> int:
        """Server-side copy by slice-reference sharing (vfs
        copy_file_range over meta slice increfs): no data bytes move —
        the gateway's CompleteMultipartUpload and CopyObject stitch at
        the metadata level instead of read+rewrite.  ``dst`` must exist
        (create it first); returns bytes copied."""
        st, fin, sattr = self.resolve(src)
        if st:
            raise FSError(st, src)
        st, fout, _ = self.resolve(dst)
        if st:
            raise FSError(st, dst)
        if size < 0:
            size = max(0, sattr.length - off_in)
        if size == 0:
            return 0
        st, copied = self.vfs.copy_file_range(
            self.ctx, fin, off_in, fout, off_out, size
        )
        if st:
            raise FSError(st, dst)
        return copied

    def read_file(self, path: str) -> bytes:
        with self.open(path) as f:
            return f.read()

    def write_file(self, path: str, data: bytes) -> None:
        with self.create(path) as f:
            f.write(data)


class File:
    """One open file (reference pkg/fs File: Seek/Read/Pread/Write...)."""

    def __init__(self, fs: FileSystem, ino: int, fh: int, path: str, attr: Attr):
        self.fs = fs
        self.ino = ino
        self.fh = fh
        self.path = path
        self._pos = 0
        self._lock = threading.Lock()
        self._closed = False

    # context manager
    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def pread(self, off: int, size: int = -1) -> bytes:
        if size < 0:
            st, attr = self.fs.vfs.getattr(self.fs.ctx, self.ino)
            if st:
                raise FSError(st, self.path)
            size = max(0, attr.length - off)
        out = bytearray()
        while size > 0:
            st, data = self.fs.vfs.read(
                self.fs.ctx, self.ino, self.fh, off, min(size, 32 << 20)
            )
            if st:
                raise FSError(st, self.path)
            if not data:
                break
            out += data
            off += len(data)
            size -= len(data)
        return bytes(out)

    def read(self, size: int = -1) -> bytes:
        # Intentional hold-while-blocking: POSIX offset atomicity — two
        # concurrent read()s on ONE handle must advance the shared
        # position and get disjoint data, and how far it advances is
        # only known after the read returns.  Deadlock-free: File sits
        # at the top of the stack; no layer below takes a File lock.
        with self._lock, lockwatch.permit(
                "per-handle offset atomicity: the position advance is "
                "only known after the read; lower layers never take "
                "File._lock"):
            data = self.pread(self._pos, size)
            self._pos += len(data)
            return data

    def pwrite(self, off: int, data: bytes) -> int:
        st = self.fs.vfs.write(self.fs.ctx, self.ino, self.fh, off, data)
        if st:
            raise FSError(st, self.path)
        return len(data)

    def write(self, data: bytes) -> int:
        # Same per-handle offset contract as read() above (a synchronous
        # flush inside vfs.write may reach the object store).
        with self._lock, lockwatch.permit(
                "per-handle offset atomicity: same contract as "
                "File.read; lower layers never take File._lock"):
            n = self.pwrite(self._pos, data)
            self._pos += n
            return n

    def seek(self, off: int, whence: int = os.SEEK_SET) -> int:
        with self._lock:
            if whence == os.SEEK_SET:
                self._pos = off
            elif whence == os.SEEK_CUR:
                self._pos += off
            elif whence == os.SEEK_END:
                st, attr = self.fs.vfs.getattr(self.fs.ctx, self.ino)
                if st:
                    raise FSError(st, self.path)
                self._pos = attr.length + off
            else:
                raise FSError(_errno.EINVAL, self.path)
            return self._pos

    def tell(self) -> int:
        return self._pos

    def flush(self) -> None:
        st = self.fs.vfs.flush(self.fs.ctx, self.ino, self.fh)
        if st:
            raise FSError(st, self.path)

    def fsync(self) -> None:
        st = self.fs.vfs.fsync(self.fs.ctx, self.ino, self.fh)
        if st:
            raise FSError(st, self.path)

    def close(self) -> None:
        """Release the handle; raises if the final flush failed (so a
        `with fs.create(...)` block cannot silently lose writes)."""
        if not self._closed:
            self._closed = True
            st = self.fs.vfs.release(self.fs.ctx, self.ino, self.fh)
            if st:
                raise FSError(st, self.path)
