"""Flat call surface for the libjfs C ABI (a copy of juicefs_tpu/sdk.py;
reference sdk/java/libjfs/main.go:409-900: the Go c-shared layer keeps a
per-mount wrapper table and exposes `jfs_*` functions, which do all
marshalling in Python so a C shim embedding CPython stays a thin
trampoline). The port's C shim, `sdk_c/libjfs.cpp` (built by
`sdk_c.build()`), embeds this module behind the reference's C ABI
(`sdk_c/jfs.h`).

Conventions (mirroring the reference C ABI):
  - every function returns >= 0 on success or -errno on failure;
  - mounts and open files are referenced by small integer ids;
  - paths are UTF-8 strings, data moves as bytes.

`jfs_init(meta_url)` builds the volume's store as `gateway` does: a volume
formatted with a device hash backend (tpu | xla | pallas) fingerprints its
blocks on the card, and a compressed volume runs its compress plane there,
so on a host with no card both fail with -EIO. The call takes no option
that would ask for the CPU: on such a host, use a volume formatted with
`--hash-backend cpu` (or none) and `--compress none`.
"""

from __future__ import annotations

import errno as _errno
import logging
import os
import threading

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_mounts: dict[int, tuple] = {}   # mid -> (FileSystem, VFS, meta)
_files: dict[tuple[int, int], object] = {}  # (mid, fd) -> File
_next_mid = 1
_next_fd = 1


def _fs(mid: int):
    ent = _mounts.get(mid)
    if ent is None:
        raise OSError(_errno.EBADF, "bad mount id")
    return ent[0]


def _file(mid: int, fd: int):
    f = _files.get((mid, fd))
    if f is None:
        raise OSError(_errno.EBADF, "bad file id")
    return f


def _wrap(fn):
    """Map FSError/OSError to -errno for the C boundary."""
    def run(*args):
        try:
            out = fn(*args)
            return 0 if out is None else out
        except OSError as e:
            return -(e.errno or _errno.EIO)
        except Exception:
            import traceback

            traceback.print_exc()
            return -_errno.EIO
    return run


@_wrap
def jfs_init(meta_url: str) -> int:
    """Open a volume; returns a mount id (reference jfs_init main.go:409)."""
    global _next_mid
    from .chunk import CachedStore, ChunkConfig  # noqa: F401  (import check)
    from .cmd import build_store, open_meta
    from .fs import FileSystem
    from .vfs import VFS

    m, fmt = open_meta(meta_url)
    m.new_session(heartbeat=12.0)
    try:
        store = build_store(fmt, None, meta=m)
    except BaseException:
        m.close_session()
        raise
    vfs = VFS(m, store, fmt=fmt)
    with _lock:
        mid = _next_mid
        _next_mid += 1
        _mounts[mid] = (FileSystem(vfs), vfs, m)
    return mid


@_wrap
def jfs_term(mid: int) -> int:
    with _lock:
        ent = _mounts.pop(mid, None)
        for key in [k for k in _files if k[0] == mid]:
            _files.pop(key)
    if ent is not None:
        ent[1].close()
        # the store too: its indexer drains, so every block written
        # before jfs_term is in the content index, and the cache dir's
        # lock is released for the next mount
        ent[1].store.close()
        ent[2].close_session()
        _report_index(ent[1].store)
    return 0


def _report_index(store) -> None:
    """Warn at jfs_term when the store's content indexer, now drained, left
    blocks without a digest row: skipped because hashing fell behind, or in
    a batch that failed. gc --dedup backfills both; the line tells a
    caller of the C ABI, which cannot read the indexer, how many there
    were."""
    idx = getattr(store, "indexer", None)
    if idx is not None and (idx.dropped or idx.errors):
        logger.warning(
            "content index at jfs_term: %d blocks hashed, %d skipped under load, "
            "%d failed (gc --dedup backfills their digests)",
            idx.blocks, idx.dropped, idx.errors,
        )


@_wrap
def jfs_open(mid: int, path: str, flags: int, mode: int) -> int:
    global _next_fd
    from .fs import FSError

    try:
        f = _fs(mid).open(path, flags, mode)
    except FSError as e:
        return -e.errno
    with _lock:
        fd = _next_fd
        _next_fd += 1
        _files[(mid, fd)] = f
    return fd


@_wrap
def jfs_close(mid: int, fd: int) -> int:
    f = _files.pop((mid, fd), None)
    if f is not None:
        f.close()
    return 0


def jfs_pread(mid: int, fd: int, off: int, size: int):
    """-> bytes, or int -errno."""
    try:
        return _file(mid, fd).pread(off, size)
    except OSError as e:
        return -(e.errno or _errno.EIO)


@_wrap
def jfs_pwrite(mid: int, fd: int, off: int, data: bytes) -> int:
    return _file(mid, fd).pwrite(off, data)


@_wrap
def jfs_flush(mid: int, fd: int) -> int:
    _file(mid, fd).flush()
    return 0


@_wrap
def jfs_mkdir(mid: int, path: str, mode: int) -> int:
    _fs(mid).mkdir(path, mode)


@_wrap
def jfs_rmdir(mid: int, path: str) -> int:
    _fs(mid).rmdir(path)


@_wrap
def jfs_unlink(mid: int, path: str) -> int:
    _fs(mid).unlink(path)


@_wrap
def jfs_rename(mid: int, src: str, dst: str) -> int:
    _fs(mid).rename(src, dst)


@_wrap
def jfs_truncate(mid: int, path: str, length: int) -> int:
    _fs(mid).truncate(path, length)


def jfs_stat(mid: int, path: str):
    """-> (size, mode_with_type, uid, gid, atime, mtime, ctime, nlink)
    or int -errno."""
    from .fs import FSError
    from .meta.types import type_to_stat_mode

    try:
        a = _fs(mid).stat(path)
    except FSError as e:
        return -e.errno
    except OSError as e:
        return -(e.errno or _errno.EIO)
    return (a.length, type_to_stat_mode(a.typ, a.mode), a.uid, a.gid,
            a.atime, a.mtime, a.ctime, a.nlink)


def jfs_listdir(mid: int, path: str):
    """-> newline-joined names string, or int -errno."""
    from .fs import FSError

    try:
        entries = _fs(mid).listdir(path)
    except FSError as e:
        return -e.errno
    except OSError as e:
        return -(e.errno or _errno.EIO)
    return "\n".join(
        e.name.decode("utf-8", "replace")
        for e in entries
        if e.name not in (b".", b"..")
    )


def jfs_statvfs(mid: int):
    """-> (total_bytes, avail_bytes, used_inodes, avail_inodes) or -errno."""
    try:
        return tuple(_fs(mid).statfs())
    except OSError as e:
        return -(e.errno or _errno.EIO)
