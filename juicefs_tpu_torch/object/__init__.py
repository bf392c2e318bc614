"""Object storage layer of the port: the contract, the file:// and mem://
stores, the prefix and sharding wrappers, the metering and resilience
wrappers, and the scheme registry behind `create_storage` (copies of their
juicefs_tpu/object counterparts).

    create_storage("file:///var/jfs/vol/")       local-disk store
    create_storage("mem://")                     in-proc store (tests)
    sharded(...)  with_prefix(...)

Only `file` and `mem` are registered: the remote backends (s3, gs, azure,
webdav, the db stores) and the checksum and encryption wrappers are not
ported, and their schemes raise the reference's `invalid object storage`
error.
"""

from __future__ import annotations

from typing import Callable

from .file import FileStorage
from .interface import (
    MultipartUpload,
    NotFoundError,
    Obj,
    ObjectStorage,
    Part,
    PermanentError,
    ThrottleError,
)
from .mem import MemStorage
from .prefix import with_prefix
from .sharding import sharded

_registry: dict[str, Callable[[str], ObjectStorage]] = {}


def register(scheme: str, factory: Callable[[str], ObjectStorage]) -> None:
    _registry[scheme] = factory


def create_storage(uri: str) -> ObjectStorage:
    """Open an object store by URI (reference object_storage.go CreateStorage)."""
    if "://" not in uri:
        uri = "file://" + uri
    scheme, addr = uri.split("://", 1)
    scheme = scheme.lower()
    if scheme not in _registry:
        raise ValueError(f"invalid object storage: {scheme}")
    return _registry[scheme](addr)


register("file", lambda addr: FileStorage(addr))
register("mem", lambda addr: MemStorage(addr))

__all__ = ["FileStorage", "MemStorage", "MultipartUpload", "NotFoundError",
           "Obj", "ObjectStorage", "Part", "PermanentError", "ThrottleError",
           "create_storage", "register", "sharded", "with_prefix"]
