"""Shared metadata data model (reference: pkg/meta/interface.go:38-305,
pkg/meta/config.go:72-98).

File layout model (reference pkg/meta/interface.go:38-39 + slice.go):
file -> fixed 64 MiB chunks -> ordered overlay list of slices (one slice =
one contiguous write) -> each slice stored as <= block_size blocks in the
object store.
"""

from __future__ import annotations

import json
import os
import stat as _stat
import struct
import time
import uuid as _uuid
from dataclasses import dataclass, field, asdict

# --- constants (reference pkg/meta/interface.go:26-58) -----------------------
CHUNK_SIZE = 1 << 26  # 64 MiB fixed chunk size (interface.go:39)
MAX_NAME_LEN = 255
MAX_SYMLINK_LEN = 4096

TYPE_FILE = 1
TYPE_DIRECTORY = 2
TYPE_SYMLINK = 3
TYPE_FIFO = 4
TYPE_BLOCKDEV = 5
TYPE_CHARDEV = 6
TYPE_SOCKET = 7

ROOT_INODE = 1
# Reserved inode anchoring the trash tree (reference pkg/meta/base.go TrashInode);
# children are hourly directories trash/YYYY-MM-DD-HH holding deleted entries.
TRASH_INODE = 0x7FFFFFFF10000000
TRASH_NAME = ".trash"

# A session whose heartbeat is older than this is stale: the GC reaps it
# and liveness consumers (status, cache-group discovery) ignore it.  ONE
# constant — a cleaner reaping at 60s while discovery trusts beat+300s
# would route peer reads to sessions the cleaner already killed.
SESSION_STALE_AGE = 300.0

# setattr field masks (reference pkg/meta/interface.go SetAttr* flags)
SET_ATTR_MODE = 1 << 0
SET_ATTR_UID = 1 << 1
SET_ATTR_GID = 1 << 2
SET_ATTR_SIZE = 1 << 3
SET_ATTR_ATIME = 1 << 4
SET_ATTR_MTIME = 1 << 5
SET_ATTR_CTIME = 1 << 6
SET_ATTR_ATIME_NOW = 1 << 7
SET_ATTR_MTIME_NOW = 1 << 8
SET_ATTR_FLAG = 1 << 15

# rename flags (linux renameat2)
RENAME_NOREPLACE = 1 << 0
RENAME_EXCHANGE = 1 << 1
RENAME_WHITEOUT = 1 << 2

# file attr flags (reference pkg/meta/interface.go FlagImmutable/FlagAppend)
FLAG_IMMUTABLE = 1 << 0
FLAG_APPEND = 1 << 1

_TYPE_TO_STAT = {
    TYPE_FILE: _stat.S_IFREG,
    TYPE_DIRECTORY: _stat.S_IFDIR,
    TYPE_SYMLINK: _stat.S_IFLNK,
    TYPE_FIFO: _stat.S_IFIFO,
    TYPE_BLOCKDEV: _stat.S_IFBLK,
    TYPE_CHARDEV: _stat.S_IFCHR,
    TYPE_SOCKET: _stat.S_IFSOCK,
}


def type_to_stat_mode(typ: int, perm: int) -> int:
    return _TYPE_TO_STAT.get(typ, 0) | (perm & 0o7777)


@dataclass
class Attr:
    """Inode attributes (reference pkg/meta/interface.go:150-200 Attr struct).

    Binary wire/storage codec is `encode`/`decode`; big-endian fixed layout so
    all engines share one representation (reference pkg/meta/utils.go marshal).
    """

    flags: int = 0
    typ: int = TYPE_FILE
    mode: int = 0  # permission bits only (type kept separately)
    uid: int = 0
    gid: int = 0
    atime: int = 0
    mtime: int = 0
    ctime: int = 0
    atimensec: int = 0
    mtimensec: int = 0
    ctimensec: int = 0
    nlink: int = 1
    length: int = 0
    rdev: int = 0
    parent: int = 0  # 0 when the inode is hard-linked from multiple parents
    access_acl: int = 0
    default_acl: int = 0
    full: bool = True  # in-memory only: attr fully loaded

    _FMT = ">BBHIIqIqIqIIQIQII"
    ENCODED_LEN = struct.calcsize(_FMT)

    def encode(self) -> bytes:
        return struct.pack(
            self._FMT,
            self.typ & 0xFF,
            self.flags & 0xFF,
            self.mode & 0xFFFF,
            self.uid & 0xFFFFFFFF,
            self.gid & 0xFFFFFFFF,
            self.atime,
            self.atimensec & 0xFFFFFFFF,
            self.mtime,
            self.mtimensec & 0xFFFFFFFF,
            self.ctime,
            self.ctimensec & 0xFFFFFFFF,
            self.nlink & 0xFFFFFFFF,
            self.length & 0xFFFFFFFFFFFFFFFF,
            self.rdev & 0xFFFFFFFF,
            self.parent & 0xFFFFFFFFFFFFFFFF,
            self.access_acl & 0xFFFFFFFF,
            self.default_acl & 0xFFFFFFFF,
        )

    @classmethod
    def decode(cls, data: bytes) -> "Attr":
        # hot path (every attr read; 200+ per readdirplus listing): build
        # via __new__ + direct stores, skipping dataclass __init__
        a = cls.__new__(cls)
        (
            a.typ,
            a.flags,
            a.mode,
            a.uid,
            a.gid,
            a.atime,
            a.atimensec,
            a.mtime,
            a.mtimensec,
            a.ctime,
            a.ctimensec,
            a.nlink,
            a.length,
            a.rdev,
            a.parent,
            a.access_acl,
            a.default_acl,
        ) = struct.unpack_from(cls._FMT, data)
        a.full = True
        return a

    def smode(self) -> int:
        """Full stat.st_mode (type | permissions)."""
        return type_to_stat_mode(self.typ, self.mode)

    def touch_atime(self, ts: float | None = None) -> None:
        ts = time.time() if ts is None else ts
        self.atime = int(ts)
        self.atimensec = int((ts - int(ts)) * 1e9)

    def touch_mtime(self, ts: float | None = None) -> None:
        ts = time.time() if ts is None else ts
        self.mtime = int(ts)
        self.mtimensec = int((ts - int(ts)) * 1e9)
        self.ctime = self.mtime
        self.ctimensec = self.mtimensec

    def touch_ctime(self, ts: float | None = None) -> None:
        ts = time.time() if ts is None else ts
        self.ctime = int(ts)
        self.ctimensec = int((ts - int(ts)) * 1e9)


@dataclass
class Slice:
    """One contiguous write inside a chunk (reference interface.go:246-252).

    `pos` is the offset of the slice inside its 64 MiB chunk; `id == 0` means
    a hole (zeros). (`off`, `len`) select the live sub-range of the stored
    slice after overlapping writes are resolved (reference pkg/meta/slice.go).
    """

    pos: int = 0
    id: int = 0
    size: int = 0
    off: int = 0
    len: int = 0

    _FMT = ">IQIII"
    ENCODED_LEN = struct.calcsize(_FMT)

    def encode(self) -> bytes:
        return struct.pack(self._FMT, self.pos, self.id, self.size, self.off, self.len)

    @classmethod
    def decode(cls, data: bytes, offset: int = 0) -> "Slice":
        pos, sid, size, off, ln = struct.unpack_from(cls._FMT, data, offset)
        return cls(pos=pos, id=sid, size=size, off=off, len=ln)

    @classmethod
    def decode_list(cls, data: bytes) -> list["Slice"]:
        n = len(data) // cls.ENCODED_LEN
        return [cls.decode(data, i * cls.ENCODED_LEN) for i in range(n)]


@dataclass
class Entry:
    """Directory entry returned by lookup/readdir (reference interface.go:254)."""

    inode: int
    name: bytes
    attr: Attr


@dataclass
class Summary:
    """du-style aggregate (reference interface.go Summary)."""

    length: int = 0
    size: int = 0
    files: int = 0
    dirs: int = 0


@dataclass
class TreeSummary:
    inode: int = 0
    path: str = ""
    typ: int = 0
    size: int = 0
    files: int = 0
    dirs: int = 0
    children: list = field(default_factory=list)


@dataclass
class Format:
    """Volume format record stored in the meta engine as JSON
    (reference pkg/meta/config.go:72-98, loaded base.go:317)."""

    name: str = ""
    uuid: str = ""
    storage: str = "file"
    bucket: str = ""
    access_key: str = ""
    secret_key: str = ""
    block_size: int = 4096  # KiB; default 4 MiB blocks (cached_store.go:39)
    compression: str = ""  # "" | "lz4" | "zstd"
    shards: int = 0
    hash_prefix: bool = False
    capacity: int = 0  # bytes, 0 = unlimited
    inodes: int = 0  # count, 0 = unlimited
    encrypt_key: str = ""
    encrypt_algo: str = ""
    key_encrypted: bool = False
    trash_days: int = 1
    # version 2: hash_backend became an explicit opt-in ("" default);
    # from_json() uses this to ignore the old implicit "cpu" default
    meta_version: int = 2
    dir_stats: bool = True
    enable_acl: bool = False
    # "" = no content indexing; "cpu"|"tpu"|"xla"|"pallas" = fingerprint
    # every written block and persist digests in the meta content index
    hash_backend: str = ""

    def __post_init__(self):
        if not self.uuid:
            self.uuid = str(_uuid.uuid4())

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @classmethod
    def from_json(cls, data: str | bytes) -> "Format":
        raw = json.loads(data)
        if raw.get("meta_version", 1) < 2 and raw.get("hash_backend") == "cpu":
            # v1 volumes stored "cpu" as an implicit default, before content
            # indexing existed as a feature; only an explicit (v2+) value
            # may opt a volume into write-path fingerprinting.
            raw["hash_backend"] = ""
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in raw.items() if k in known})

    def remove_secret(self) -> "Format":
        clone = Format(**{k: getattr(self, k) for k in self.__dataclass_fields__})
        if clone.secret_key:
            clone.secret_key = "removed"
        if clone.encrypt_key:
            clone.encrypt_key = "removed"
        return clone


@dataclass
class Session:
    """A live client session (reference pkg/meta/interface.go Session)."""

    sid: int = 0
    version: str = ""
    hostname: str = ""
    mount_point: str = ""
    process_id: int = 0
    expire: float = 0.0
    # cache-group membership: a mount serving its block cache
    # to peers publishes its group, dial address, and ring weight here —
    # peer discovery IS the session table, no extra coordination service
    cache_group: str = ""
    peer_addr: str = ""
    group_weight: int = 1

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, data: str | bytes) -> "Session":
        raw = json.loads(data)
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in raw.items() if k in known})


def new_session_info(mount_point: str = "", **extras) -> Session:
    import socket

    return Session(
        version="juicefs_tpu/0.1",
        hostname=socket.gethostname(),
        mount_point=mount_point,
        process_id=os.getpid(),
        **extras,
    )
