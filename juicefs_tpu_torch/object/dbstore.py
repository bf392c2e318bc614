"""Database-backed object drivers (a copy of juicefs_tpu/object/
dbstore.py; reference pkg/object/sqlite.go, pkg/object/redis.go): blocks
stored as rows/values in a database — the small-volume option when no
object store is deployed.

  sqlite:///path/objs.db      one table, WAL mode, thread-local conns
  redis://host:port/db        values in the bundled meta-server or any
                              real Redis (shares the RESP client)
"""

from __future__ import annotations

import os
import sqlite3
import threading
import time
from typing import Iterator, Optional

from .interface import NotFoundError, Obj, ObjectStorage


class SqliteStorage(ObjectStorage):
    """Objects in a sqlite table (reference pkg/object/sqlite.go)."""

    def __init__(self, addr: str):
        if not addr or addr == ":memory:":
            # thread-local connections would each get a private empty
            # :memory: database; use mem:// for an in-memory store
            raise ValueError("sqlite3:// needs a file path (use mem:// "
                             "for an in-memory object store)")
        self.path = addr
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self._local = threading.local()
        conn = self._conn()
        conn.execute(
            "CREATE TABLE IF NOT EXISTS objs ("
            "k TEXT PRIMARY KEY, v BLOB NOT NULL, mtime REAL NOT NULL"
            ") WITHOUT ROWID"
        )
        conn.commit()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30.0)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
        return conn

    def string(self) -> str:
        return f"sqlite://{self.path}"

    def create(self) -> None:
        pass

    def get(self, key: str, off: int = 0, limit: int = -1) -> bytes:
        # ranged reads slice inside sqlite (substr is 1-based): a few-KB
        # page read must not copy the whole 4 MiB blob out first
        if off or limit >= 0:
            n = -1 if limit < 0 else limit
            row = self._conn().execute(
                "SELECT substr(v, ?, CASE WHEN ? < 0 THEN length(v) "
                "ELSE ? END) FROM objs WHERE k = ?",
                (off + 1, n, n, key),
            ).fetchone()
        else:
            row = self._conn().execute(
                "SELECT v FROM objs WHERE k = ?", (key,)
            ).fetchone()
        if row is None:
            raise NotFoundError(key)
        return bytes(row[0])

    def put(self, key: str, data: bytes) -> None:
        conn = self._conn()
        conn.execute(
            "INSERT INTO objs(k, v, mtime) VALUES(?, ?, ?) "
            "ON CONFLICT(k) DO UPDATE SET v=excluded.v, mtime=excluded.mtime",
            (key, bytes(data), time.time()),
        )
        conn.commit()

    def delete(self, key: str) -> None:
        conn = self._conn()
        conn.execute("DELETE FROM objs WHERE k = ?", (key,))
        conn.commit()

    def head(self, key: str) -> Obj:
        row = self._conn().execute(
            "SELECT length(v), mtime FROM objs WHERE k = ?", (key,)
        ).fetchone()
        if row is None:
            raise NotFoundError(key)
        return Obj(key=key, size=row[0], mtime=row[1])

    def list_all(self, prefix: str = "", marker: str = "") -> Iterator[Obj]:
        # plain key-range scan + exact startswith: LIKE would treat _/% as
        # wildcards and compare case-insensitively (block keys contain '_')
        lo, op = (marker, ">") if marker else (prefix, ">=")
        for k, size, mtime in self._conn().execute(
            f"SELECT k, length(v), mtime FROM objs WHERE k {op} ? ORDER BY k",
            (lo,),
        ):
            if prefix and not k.startswith(prefix):
                if k > prefix:
                    break  # sorted: past the prefix range
                continue
            yield Obj(key=k, size=size, mtime=mtime)


class RedisStorage(ObjectStorage):
    """Objects as values over the Redis wire protocol (reference
    pkg/object/redis.go) — works against the bundled meta-server or any
    real Redis. Keys live under `obj:`; an index zset provides ordered
    listings; `objm:` holds mtimes."""

    PREFIX = b"obj:"
    META = b"objm:"
    IDX = b"!objidx"

    def __init__(self, addr: str):
        from ..meta.redis_kv import RedisKV

        self._kv = RedisKV(addr)
        self.addr = addr

    def string(self) -> str:
        return f"redis://{self.addr}"

    def create(self) -> None:
        self._kv.execute(b"PING")

    def get(self, key: str, off: int = 0, limit: int = -1) -> bytes:
        data = self._kv.execute(b"GET", self.PREFIX + key.encode())
        if data is None:
            raise NotFoundError(key)
        if off or limit >= 0:
            return data[off:] if limit < 0 else data[off:off + limit]
        return bytes(data)

    def _pipeline(self, *cmds: tuple) -> list:
        """MULTI/EXEC pipeline: crash/network loss mid-put must never
        leave a block stored but missing from the listing index (gc/fsck
        enumerate via the index — an unindexed block would leak forever)."""

        def run():
            conn = self._kv._conn()
            conn.send((b"MULTI",), *cmds, (b"EXEC",))
            replies = [conn.read_reply() for _ in range(len(cmds) + 2)]
            return replies[-1]

        return self._kv._retry_io(run)

    def put(self, key: str, data: bytes) -> None:
        k = key.encode()
        meta = f"{len(data)}:{time.time()}".encode()
        self._pipeline(
            (b"SET", self.PREFIX + k, bytes(data)),
            (b"SET", self.META + k, meta),
            (b"ZADD", self.IDX, b"0", k),
        )

    def delete(self, key: str) -> None:
        k = key.encode()
        self._pipeline(
            (b"DEL", self.PREFIX + k, self.META + k),
            (b"ZREM", self.IDX, k),
        )

    def head(self, key: str) -> Obj:
        # size+mtime live in the small objm: record — head and listings
        # must not GET multi-MiB bodies just to report sizes
        k = key.encode()
        raw = self._kv.execute(b"GET", self.META + k)
        if raw is None:
            if self._kv.execute(b"EXISTS", self.PREFIX + k):
                data = self._kv.execute(b"GET", self.PREFIX + k)
                return Obj(key=key, size=len(data or b""), mtime=0.0)
            raise NotFoundError(key)
        size_s, _, mtime_s = bytes(raw).partition(b":")
        return Obj(key=key, size=int(size_s), mtime=float(mtime_s or 0))

    def list_all(self, prefix: str = "", marker: str = "") -> Iterator[Obj]:
        lo = b"[" + (marker or prefix).encode() if (marker or prefix) else b"-"
        page = 1024
        last: Optional[bytes] = None
        while True:
            names = self._kv.execute(
                b"ZRANGEBYLEX", self.IDX,
                (b"(" + last) if last is not None else lo,
                b"+", b"LIMIT", b"0", str(page).encode(),
            )
            if not names:
                return
            for k in names:
                ks = k.decode()
                if marker and ks <= marker:
                    continue
                if prefix and not ks.startswith(prefix):
                    if ks > prefix:
                        return  # sorted: past the prefix range
                    continue
                try:
                    yield self.head(ks)
                except NotFoundError:
                    continue  # raced a delete
            last = names[-1]
            if len(names) < page:
                return
