"""Ordered-KV transaction clients backing the KV meta engine
(reference: pkg/meta/tkv.go `tkvClient`/`kvTxn` interfaces, tkv_mem.go:272).

Engines provided here:
    memkv://      in-process ordered KV (hermetic tests; reference tkv_mem.go)
    sqlite3://    single-file durable KV over sqlite (single-writer txns)

The transaction model is the same as the reference: `txn(fn)` runs `fn(tx)`
with snapshot reads + buffered writes and commits atomically, retrying on
conflict. Both local engines serialize writers, so retries only matter for
future networked engines (TiKV/etcd) which plug in behind the same ABC.
"""

from __future__ import annotations

import bisect
import os
import sqlite3
import threading
import time
from typing import Callable, Iterator, Optional

from ..utils import get_logger, txnwatch

logger = get_logger("meta.tkv")


class KVTxn:
    """One transaction. Reads see the snapshot plus this txn's own writes."""

    _discarded = False

    def discard(self) -> None:
        """Mark the transaction aborted: buffered writes must not commit.

        Mirrors the reference's Go semantics (pkg/meta/tkv.go txn): a do_*
        closure that returns a nonzero errno aborts the backend transaction,
        so a mutate-then-fail path can never leak counters or partial state.
        """
        self._discarded = True

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def gets(self, *keys: bytes) -> list[Optional[bytes]]:
        return [self.get(k) for k in keys]

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def append(self, key: bytes, value: bytes) -> bytes:
        old = self.get(key) or b""
        new = old + value
        self.set(key, new)
        return new

    def incr_by(self, key: bytes, delta: int) -> int:
        old = self.get(key)
        v = int.from_bytes(old, "big", signed=True) if old else 0
        v += delta
        self.set(key, v.to_bytes(8, "big", signed=True))
        return v

    def scan(
        self,
        begin: bytes,
        end: bytes,
        keys_only: bool = False,
        limit: int = -1,
    ) -> Iterator[tuple[bytes, bytes]]:
        """Iterate [begin, end) in key order."""
        raise NotImplementedError

    def scan_keys(self, prefix: bytes) -> list[bytes]:
        return [k for k, _ in self.scan(prefix, next_key(prefix), keys_only=True)]

    def scan_values(self, prefix: bytes) -> dict[bytes, bytes]:
        return dict(self.scan(prefix, next_key(prefix)))

    def exists(self, prefix: bytes) -> bool:
        for _ in self.scan(prefix, next_key(prefix), keys_only=True, limit=1):
            return True
        return False


class TKVClient:
    """Engine handle (reference tkv.go tkvClient)."""

    name = "tkv"

    def txn(self, fn: Callable[[KVTxn], object], retries: int = 50) -> object:
        raise NotImplementedError

    def simple_txn(self, fn: Callable[[KVTxn], object]) -> object:
        """Read-mostly transaction; same semantics, may skip write locking."""
        return self.txn(fn)

    def in_txn(self) -> bool:
        """True when the calling thread is inside an open transaction."""
        return False

    def scan(self, begin: bytes, end: bytes) -> Iterator[tuple[bytes, bytes]]:
        """Non-transactional bulk scan for gc/fsck/dump sweeps."""
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def gc(self) -> None:
        pass


def next_key(prefix: bytes) -> bytes:
    """Smallest key strictly greater than every key with this prefix."""
    b = bytearray(prefix)
    i = len(b) - 1
    while i >= 0:
        if b[i] < 0xFF:
            b[i] += 1
            return bytes(b[: i + 1])
        i -= 1
    return b"\xff" * (len(prefix) + 1)


class ConflictError(Exception):
    """Optimistic transaction conflict; caller retries."""


# --------------------------------------------------------------------------
# In-memory engine (reference pkg/meta/tkv_mem.go:272)
# --------------------------------------------------------------------------


class _MemTxn(KVTxn):
    def __init__(self, store: "MemKV"):
        self._store = store
        self._writes: dict[bytes, Optional[bytes]] = {}

    def get(self, key: bytes) -> Optional[bytes]:
        if key in self._writes:
            return self._writes[key]
        return self._store._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        self._writes[key] = bytes(value)

    def delete(self, key: bytes) -> None:
        self._writes[key] = None

    def scan(self, begin, end, keys_only=False, limit=-1):
        data = self._store._data
        keys = self._store._keys
        lo = bisect.bisect_left(keys, begin)
        hi = bisect.bisect_left(keys, end)
        merged: dict[bytes, Optional[bytes]] = {}
        for k in keys[lo:hi]:
            merged[k] = data[k]
        for k, v in self._writes.items():
            if begin <= k < end:
                merged[k] = v
        n = 0
        for k in sorted(merged):
            v = merged[k]
            if v is None:
                continue
            yield (k, b"" if keys_only else v)
            n += 1
            if limit >= 0 and n >= limit:
                return


class MemKV(TKVClient):
    """Serialized in-process ordered KV; the hermetic test engine."""

    name = "memkv"

    def __init__(self):
        self._data: dict[bytes, bytes] = {}
        self._keys: list[bytes] = []  # sorted index of _data keys
        self._lock = threading.RLock()
        self._local = threading.local()

    def in_txn(self) -> bool:
        return getattr(self._local, "tx", None) is not None

    def txn(self, fn, retries: int = 50):
        # nested txn: join the enclosing transaction (single atomic commit)
        active = getattr(self._local, "tx", None)
        if active is not None:
            return fn(active)
        with self._lock:
            # txn-rerun harness seam: under JUICEFS_TXN_RERUN the closure
            # runs twice against fresh buffers (the lock serializes, so
            # the comparison is race-free) and the second run's writes
            # commit; inactive, double_run is a plain single call
            def run_once():
                tx = _MemTxn(self)
                self._local.tx = tx
                try:
                    r = fn(tx)
                finally:
                    self._local.tx = None
                return r, tx._writes, tx._discarded

            result, writes, discarded = txnwatch.double_run(
                "memkv", fn, run_once)
            if discarded:
                return result
            for k, v in writes.items():
                if v is None:
                    if k in self._data:
                        del self._data[k]
                        i = bisect.bisect_left(self._keys, k)
                        if i < len(self._keys) and self._keys[i] == k:
                            self._keys.pop(i)
                else:
                    if k not in self._data:
                        bisect.insort(self._keys, k)
                    self._data[k] = v
            return result

    def scan(self, begin, end):
        with self._lock:
            lo = bisect.bisect_left(self._keys, begin)
            hi = bisect.bisect_left(self._keys, end)
            snapshot = [(k, self._data[k]) for k in self._keys[lo:hi]]
        yield from snapshot

    def reset(self):
        with self._lock:
            self._data.clear()
            self._keys.clear()


# --------------------------------------------------------------------------
# SQLite-backed ordered KV
# --------------------------------------------------------------------------


class _SqliteTxn(KVTxn):
    # txnwatch write recorder: the harness compares the ordered
    # set/delete stream between the doubled runs (writes here go
    # straight to the connection, so there is no buffer to diff)
    _log = None

    def __init__(self, conn: sqlite3.Connection):
        self._conn = conn

    def get(self, key):
        row = self._conn.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return bytes(row[0]) if row else None

    def gets(self, *keys):
        """Batched point lookups in ONE statement (the readdirplus attr
        assembly path: per-entry SELECTs dominate first-listing latency)."""
        if not keys:
            return []
        found = {}
        ks = list(keys)
        for i in range(0, len(ks), 512):  # sqlite parameter limit headroom
            chunk = ks[i:i + 512]
            q = "SELECT k, v FROM kv WHERE k IN ({})".format(
                ",".join("?" * len(chunk))
            )
            for k, v in self._conn.execute(q, chunk):
                found[bytes(k)] = bytes(v)
        return [found.get(bytes(k)) for k in keys]

    def set(self, key, value):
        if self._log is not None:
            self._log.append(("set", bytes(key), bytes(value)))
        self._conn.execute(
            "INSERT INTO kv(k, v) VALUES(?, ?) ON CONFLICT(k) DO UPDATE SET v=excluded.v",
            (key, bytes(value)),
        )

    def delete(self, key):
        if self._log is not None:
            self._log.append(("del", bytes(key)))
        self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))

    def scan(self, begin, end, keys_only=False, limit=-1):
        sql = "SELECT k{} FROM kv WHERE k >= ? AND k < ? ORDER BY k".format(
            "" if keys_only else ", v"
        )
        if limit >= 0:
            sql += f" LIMIT {int(limit)}"
        for row in self._conn.execute(sql, (begin, end)):
            if keys_only:
                yield (bytes(row[0]), b"")
            else:
                yield (bytes(row[0]), bytes(row[1]))


class SqliteKV(TKVClient):
    """Durable single-host engine over one sqlite file (WAL mode).

    sqlite is single-writer, so transactions take a process-wide lock plus
    BEGIN IMMEDIATE; cross-process writers serialize on the sqlite lock with
    a busy timeout.
    """

    name = "sqlite3"

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        self._wlock = threading.RLock()
        conn = self._get_conn()
        conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID"
        )
        conn.commit()

    def _get_conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30.0, isolation_level=None)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
        return conn

    def in_txn(self) -> bool:
        return getattr(self._local, "in_txn", False)

    def txn(self, fn, retries: int = 50):
        conn = self._get_conn()
        # nested txn: join the enclosing transaction (single atomic commit)
        if getattr(self._local, "in_txn", False):
            return fn(_SqliteTxn(conn))
        last: Exception | None = None
        for attempt in range(retries):
            with self._wlock:
                try:
                    conn.execute("BEGIN IMMEDIATE")
                    self._local.in_txn = True
                    # txn-rerun harness seam: writes land on the
                    # connection directly, so the doubled first run is
                    # discarded by rolling back to a savepoint and the
                    # recorded set/delete streams are compared
                    tw = txnwatch.active()
                    if tw:
                        conn.execute("SAVEPOINT txnwatch")

                    def run_once():
                        tx = _SqliteTxn(conn)
                        if tw:
                            tx._log = []
                        r = fn(tx)
                        return (r, tuple(tx._log) if tw else None,
                                tx._discarded)

                    result, _w, discarded = txnwatch.double_run(
                        "sqlite3", fn, run_once,
                        (lambda: conn.execute("ROLLBACK TO txnwatch"))
                        if tw else None)
                    if tw:
                        conn.execute("RELEASE txnwatch")
                    conn.execute("ROLLBACK" if discarded else "COMMIT")
                    return result
                except sqlite3.OperationalError as e:
                    try:
                        conn.execute("ROLLBACK")
                    except sqlite3.OperationalError:
                        pass  # BEGIN itself failed: no transaction to roll back
                    last = e
                    time.sleep(min(0.001 * (1 << min(attempt, 8)), 0.1))
                except BaseException:
                    try:
                        conn.execute("ROLLBACK")
                    except sqlite3.OperationalError:
                        pass
                    raise
                finally:
                    self._local.in_txn = False
        raise last  # type: ignore[misc]

    def simple_txn(self, fn):
        """Read-mostly transaction: BEGIN DEFERRED snapshot, no writer
        lock — in WAL mode readers never block (or take) the single write
        lock, so hot read paths (lookup/getattr/readdir) don't serialize
        behind writers the way BEGIN IMMEDIATE does."""
        conn = self._get_conn()
        if getattr(self._local, "in_txn", False):
            return fn(_SqliteTxn(conn))
        for attempt in range(50):
            try:
                conn.execute("BEGIN")
                self._local.in_txn = True
                before = conn.total_changes
                # txn-rerun harness seam: read closures double too (the
                # BEGIN snapshot makes the comparison race-free); a
                # writer closure's first run rolls back to the savepoint
                tw = txnwatch.active()
                if tw:
                    conn.execute("SAVEPOINT txnwatch")
                last_tx: dict = {}

                def run_once():
                    tx = _SqliteTxn(conn)
                    if tw:
                        tx._log = []
                    last_tx["tx"] = tx
                    r = fn(tx)
                    return (r, tuple(tx._log) if tw else None,
                            tx._discarded)

                ok = False
                try:
                    result, _w, _d = txnwatch.double_run(
                        "sqlite3", fn, run_once,
                        (lambda: conn.execute("ROLLBACK TO txnwatch"))
                        if tw else None)
                    ok = True
                    return result
                finally:
                    self._local.in_txn = False
                    # same contract as txn(): an exception or discard()
                    # must never commit partial writes; a caller that
                    # (unexpectedly) wrote and returned cleanly commits.
                    # (total_changes is monotonic, so a rolled-back first
                    # run still marks `wrote` — commit then covers the
                    # surviving second run's writes.)
                    wrote = conn.total_changes != before
                    if tw and ok:
                        conn.execute("RELEASE txnwatch")
                    tx = last_tx.get("tx")
                    conn.execute(
                        "COMMIT"
                        if (ok and wrote and tx is not None
                            and not tx._discarded)
                        else "ROLLBACK"
                    )
            except sqlite3.OperationalError:
                self._local.in_txn = False
                time.sleep(min(0.001 * (1 << min(attempt, 8)), 0.1))
        return self.txn(fn)  # fall back to the write path

    def scan(self, begin, end):
        conn = self._get_conn()
        for row in conn.execute(
            "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k", (begin, end)
        ):
            yield (bytes(row[0]), bytes(row[1]))

    def reset(self):
        conn = self._get_conn()
        with self._wlock:
            conn.execute("DELETE FROM kv")
            conn.commit()

    def close(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


def new_tkv_client(driver: str, addr: str) -> TKVClient:
    """Open an ordered-KV engine (reference tkv.go newTkvClient)."""
    if driver in ("memkv", "mem"):
        return MemKV()
    if driver in ("sqlite3", "sqlite"):
        if addr and addr != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(addr)) or ".", exist_ok=True)
        return SqliteKV(addr or ":memory:")
    if driver == "redis":
        from .redis_kv import RedisKV

        return RedisKV(addr)
    raise ValueError(f"unknown tkv driver: {driver}")
