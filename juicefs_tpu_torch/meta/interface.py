"""Meta contract + driver registry (a copy of juicefs_tpu/meta/interface.py;
reference: pkg/meta/interface.go:308-507).

All operations return POSIX errno ints (0 == OK) plus results, mirroring the
reference's `syscall.Errno` convention so the VFS layer can pass codes through
to FUSE unchanged.

URI forms accepted by `new_client` (reference interface.go:476-507):
    memkv://[name]              in-proc ordered KV (tests)
    sqlite3:///path/to/meta.db  durable single-host KV
    redis://host:port/db        RESP server as an ordered KV
"""

from __future__ import annotations

from typing import Callable

from ..utils import get_logger

logger = get_logger("meta")

# control messages pushed from meta to the client (reference interface.go:40-58)
DELETE_SLICE = 0
COMPACT_CHUNK = 1

_registry: dict[str, Callable[[str, str], "Meta"]] = {}


def register(scheme: str, factory: Callable[[str, str], "Meta"]) -> None:
    _registry[scheme] = factory


def new_client(uri: str, **kw) -> "Meta":
    """Open a meta engine by URI (reference interface.go NewClient:496)."""
    if "://" not in uri:
        uri = "sqlite3://" + uri
    scheme, addr = uri.split("://", 1)
    scheme = scheme.lower()
    if scheme not in _registry:
        # the kv engine registers lazily to avoid import cycles; the
        # relational engine (sql://) is not ported, so its scheme stays
        # unknown
        from . import kv  # noqa: F401
    if scheme not in _registry:
        raise ValueError(f"invalid meta driver: {scheme}")
    return _registry[scheme](scheme, addr)


class Meta:
    """POSIX metadata contract (reference pkg/meta/interface.go:308-465).

    Concrete engines subclass BaseMeta; this class only documents the surface.
    Methods return `(errno, ...)`; errno 0 means success.
    """

    # lifecycle: init/load/reset/new_session/close_session/flush
    # namespace: lookup/resolve/readdir/mknod/mkdir/create/unlink/rmdir/
    #            rename/link/symlink/readlink
    # attrs:     getattr/setattr/truncate/fallocate/access/check_quota
    # data:      new_slice/read_chunk/write_chunk/copy_file_range/list_slices
    # xattr:     getxattr/setxattr/listxattr/removexattr
    # locks:     flock/getlk/setlk
    # admin:     statfs/summary/remove_recursive/dump/load/counters/sessions
    def name(self) -> str:
        raise NotImplementedError
