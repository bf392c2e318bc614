"""Metadata engine of the port: a copy of juicefs_tpu/meta with the kv
engine (memkv://, mem://, sqlite3://, sqlite://, redis://), the relational
engine (sql://), the bundled RESP server (redis_server.py) and the fault
injector (fault.py) (reference: pkg/meta).

Public surface:
    new_client(uri)  -> Meta          driver registry (reference interface.go:476)
    Meta                               80+-op POSIX metadata contract
    Attr / Entry / Slice / Format      shared data model
"""

from .types import (  # noqa: F401
    Attr,
    Entry,
    Format,
    Slice,
    Summary,
    TreeSummary,
    CHUNK_SIZE,
    TYPE_FILE,
    TYPE_DIRECTORY,
    TYPE_SYMLINK,
    TYPE_FIFO,
    TYPE_BLOCKDEV,
    TYPE_CHARDEV,
    TYPE_SOCKET,
    ROOT_INODE,
    TRASH_INODE,
)
from .interface import Meta, new_client, register  # noqa: F401
