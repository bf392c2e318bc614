"""Object storage layer of the port: the contract, the file:// and mem://
stores, the S3 and WebDAV clients, the prefix and sharding wrappers, the
metering and resilience wrappers, and the scheme registry behind
`create_storage` (copies of their juicefs_tpu/object counterparts).

    create_storage("file:///var/jfs/vol/")       local-disk store
    create_storage("mem://")                     in-proc store (tests)
    create_storage("s3://AK:SK@host:port/bucket")   S3 / MinIO (also minio://)
    create_storage("webdav://host:port/base")    WebDAV
    sharded(...)  with_prefix(...)

`file`, `mem`, `s3`, `minio` and `webdav` are registered. The other
remote backends (gs, azure, the db stores) and the checksum and encryption
wrappers are not ported, and their schemes raise the reference's `invalid
object storage` error.
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


def _s3_factory(addr: str) -> ObjectStorage:
    from .s3 import S3Storage

    return S3Storage(addr)


def _webdav_factory(addr: str) -> ObjectStorage:
    from .webdav import WebDAVStorage

    return WebDAVStorage(addr)


register("file", lambda addr: FileStorage(addr))
register("mem", lambda addr: MemStorage(addr))
register("s3", _s3_factory)
register("minio", _s3_factory)
register("webdav", _webdav_factory)

__all__ = ["FileStorage", "MemStorage", "MultipartUpload", "NotFoundError",
           "Obj", "ObjectStorage", "Part", "PermanentError", "ThrottleError",
           "create_storage", "register", "sharded", "with_prefix"]
