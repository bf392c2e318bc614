"""Relational SQL meta engine (a copy of juicefs_tpu/meta/sql.py;
reference: pkg/meta/sql.go dbMeta).

A second, independent engine family beside the KV engine: every entity
lives in its own table (reference sql.go:51-230 table definitions —
node/edge/chunk/sliceRef/xattr/symlink/flock/plock/session2/delfile/
dirStats/dirQuota/acl) and every do_* operation is implemented directly
with SQL statements — none of meta/kv.py's key-schema logic is reused.
That independence is the point: the cross-engine random harness
(tests/test_meta_random.py) compares this engine against the KV family,
so a semantic bug in one implementation shows up as a divergence instead
of passing everywhere.

Registered as `sql://path.db` (sqlite3 database file). The transaction
model matches the reference's optimistic retry (sql.go:354 doInit /
txn wrappers): BEGIN IMMEDIATE, the do_* body returns an errno, nonzero
rolls back, sqlite BUSY retries with backoff. Slices are fully
normalized into `chunkslice` rows (one row per slice, ordered by seq) —
unlike both the KV engine's packed blobs and the reference's blob
column, which makes the two families structurally dissimilar on purpose.
"""

from __future__ import annotations

import errno
import json
import os
import sqlite3
import threading
import time
from typing import Iterator, Optional

from ..utils import get_logger, txnwatch
from . import acl as acl_mod
from . import interface
from .base import BaseMeta
from .context import Context
from .types import (
    Attr,
    Entry,
    Format,
    Session,
    Slice,
    CHUNK_SIZE,
    FLAG_APPEND,
    FLAG_IMMUTABLE,
    RENAME_EXCHANGE,
    RENAME_NOREPLACE,
    ROOT_INODE,
    SESSION_STALE_AGE,
    SET_ATTR_ATIME,
    SET_ATTR_ATIME_NOW,
    SET_ATTR_FLAG,
    SET_ATTR_GID,
    SET_ATTR_MODE,
    SET_ATTR_MTIME,
    SET_ATTR_MTIME_NOW,
    SET_ATTR_UID,
    TRASH_INODE,
    TYPE_DIRECTORY,
    TYPE_FILE,
    TYPE_SYMLINK,
)

logger = get_logger("meta.sql")


def _align4k(length: int) -> int:
    return (length + 4095) // 4096 * 4096 if length else 0


_SCHEMA = """
CREATE TABLE IF NOT EXISTS setting (
    name TEXT PRIMARY KEY, value BLOB NOT NULL);
CREATE TABLE IF NOT EXISTS counter (
    name TEXT PRIMARY KEY, value INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS node (
    inode INTEGER PRIMARY KEY, type INTEGER NOT NULL, flags INTEGER NOT NULL,
    mode INTEGER NOT NULL, uid INTEGER NOT NULL, gid INTEGER NOT NULL,
    atime INTEGER NOT NULL, atimensec INTEGER NOT NULL,
    mtime INTEGER NOT NULL, mtimensec INTEGER NOT NULL,
    ctime INTEGER NOT NULL, ctimensec INTEGER NOT NULL,
    nlink INTEGER NOT NULL, length INTEGER NOT NULL, rdev INTEGER NOT NULL,
    parent INTEGER NOT NULL, access_acl INTEGER NOT NULL DEFAULT 0,
    default_acl INTEGER NOT NULL DEFAULT 0);
CREATE TABLE IF NOT EXISTS edge (
    parent INTEGER NOT NULL, name BLOB NOT NULL,
    inode INTEGER NOT NULL, type INTEGER NOT NULL,
    PRIMARY KEY (parent, name));
CREATE INDEX IF NOT EXISTS edge_inode ON edge (inode);
CREATE TABLE IF NOT EXISTS chunkslice (
    inode INTEGER NOT NULL, indx INTEGER NOT NULL, seq INTEGER NOT NULL,
    pos INTEGER NOT NULL, sliceid INTEGER NOT NULL, size INTEGER NOT NULL,
    off INTEGER NOT NULL, len INTEGER NOT NULL,
    PRIMARY KEY (inode, indx, seq));
CREATE TABLE IF NOT EXISTS sliceref (
    sliceid INTEGER NOT NULL, size INTEGER NOT NULL, refs INTEGER NOT NULL,
    PRIMARY KEY (sliceid, size));
CREATE TABLE IF NOT EXISTS symlink (
    inode INTEGER PRIMARY KEY, target BLOB NOT NULL);
CREATE TABLE IF NOT EXISTS xattr (
    inode INTEGER NOT NULL, name BLOB NOT NULL, value BLOB NOT NULL,
    PRIMARY KEY (inode, name));
CREATE TABLE IF NOT EXISTS parentlink (
    inode INTEGER NOT NULL, parent INTEGER NOT NULL, cnt INTEGER NOT NULL,
    PRIMARY KEY (inode, parent));
CREATE TABLE IF NOT EXISTS delfile (
    inode INTEGER PRIMARY KEY, length INTEGER NOT NULL, expire REAL NOT NULL);
CREATE TABLE IF NOT EXISTS session2 (
    sid INTEGER PRIMARY KEY, info TEXT NOT NULL, heartbeat REAL NOT NULL);
CREATE TABLE IF NOT EXISTS sustained (
    sid INTEGER NOT NULL, inode INTEGER NOT NULL, PRIMARY KEY (sid, inode));
CREATE TABLE IF NOT EXISTS flock (
    inode INTEGER NOT NULL, sid INTEGER NOT NULL, owner INTEGER NOT NULL,
    ltype TEXT NOT NULL, PRIMARY KEY (inode, sid, owner));
CREATE TABLE IF NOT EXISTS plock (
    inode INTEGER NOT NULL, sid INTEGER NOT NULL, owner INTEGER NOT NULL,
    ltype INTEGER NOT NULL, start INTEGER NOT NULL, end INTEGER NOT NULL,
    pid INTEGER NOT NULL);
CREATE INDEX IF NOT EXISTS plock_inode ON plock (inode);
CREATE TABLE IF NOT EXISTS dirstats (
    inode INTEGER PRIMARY KEY, length INTEGER NOT NULL,
    space INTEGER NOT NULL, inodes INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS dirquota (
    inode INTEGER PRIMARY KEY, space_limit INTEGER NOT NULL,
    inode_limit INTEGER NOT NULL, used_space INTEGER NOT NULL,
    used_inodes INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS acl (
    id INTEGER PRIMARY KEY, rule BLOB NOT NULL UNIQUE);
CREATE TABLE IF NOT EXISTS blockdigest (
    sliceid INTEGER NOT NULL, indx INTEGER NOT NULL,
    bsize INTEGER NOT NULL, digest BLOB NOT NULL,
    PRIMARY KEY (sliceid, indx));
CREATE TABLE IF NOT EXISTS invalidation (
    seq INTEGER PRIMARY KEY, sid INTEGER NOT NULL,
    ts REAL NOT NULL, events TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS contentref (
    digest BLOB PRIMARY KEY, sliceid INTEGER NOT NULL,
    indx INTEGER NOT NULL, bsize INTEGER NOT NULL, refs INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS contentalias (
    sliceid INTEGER NOT NULL, indx INTEGER NOT NULL,
    digest BLOB NOT NULL, bsize INTEGER NOT NULL,
    created REAL NOT NULL DEFAULT 0,
    PRIMARY KEY (sliceid, indx));
CREATE INDEX IF NOT EXISTS contentalias_digest ON contentalias (digest);
"""

_NODE_COLS = (
    "inode,type,flags,mode,uid,gid,atime,atimensec,mtime,mtimensec,"
    "ctime,ctimensec,nlink,length,rdev,parent,access_acl,default_acl"
)


def _row_to_attr(row) -> Attr:
    return Attr(
        typ=row[1], flags=row[2], mode=row[3], uid=row[4], gid=row[5],
        atime=row[6], atimensec=row[7], mtime=row[8], mtimensec=row[9],
        ctime=row[10], ctimensec=row[11], nlink=row[12], length=row[13],
        rdev=row[14], parent=row[15], access_acl=row[16], default_acl=row[17],
        full=True,
    )


def _attr_params(ino: int, a: Attr) -> tuple:
    return (
        ino, a.typ, a.flags, a.mode, a.uid, a.gid, a.atime, a.atimensec,
        a.mtime, a.mtimensec, a.ctime, a.ctimensec, a.nlink, a.length,
        a.rdev, a.parent, a.access_acl, a.default_acl,
    )


def _direct_space(attr: Attr) -> int:
    return 4096 if attr.typ == TYPE_DIRECTORY else _align4k(attr.length)


def _direct_len(attr: Attr) -> int:
    return 0 if attr.typ == TYPE_DIRECTORY else attr.length


class SQLMeta(BaseMeta):
    """Relational meta engine over sqlite3 (reference pkg/meta/sql.go dbMeta)."""

    F_UNLCK, F_RDLCK, F_WRLCK = 2, 0, 1
    _QUOTA_HINT_TTL = 1.0
    # the invalidation table + invalSeq counter are the per-volume change
    # feed the lease cache requires
    supports_inval_feed = True
    # _txn nests (a do_* on the same thread joins the open transaction),
    # so the write batcher's group commit is one atomic txn
    supports_group_txn = True

    def __init__(self, path: str, addr: str = ""):
        super().__init__(addr or f"sql://{path}")
        if not path or path == ":memory:":
            # per-thread connections would each get their own empty
            # in-memory database — reject instead of failing obscurely
            raise ValueError(
                "sql:// needs a database file path (in-memory databases "
                "are per-connection; use memkv:// for a hermetic engine)"
            )
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(self.path)) or ".", exist_ok=True)
        self._tlocal = threading.local()
        self._wmutex = threading.RLock()  # in-process writer serialization
        self._qcache: tuple[set[int], float] | None = None
        self._acl_cache: dict[int, "acl_mod.Rule"] = {}
        self._acl_rev: dict[bytes, int] = {}
        conn = self._conn()
        with self._wmutex:
            conn.executescript(_SCHEMA)
            conn.commit()

    def name(self) -> str:
        return "sql"

    # ---- connections & transactions --------------------------------------
    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._tlocal, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30.0, isolation_level=None)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            conn.execute("PRAGMA foreign_keys=OFF")
            self._tlocal.conn = conn
        return conn

    def _txn(self, fn, retries: int = 50, errno_abort: bool = True):
        """Write transaction under the errno convention: `fn(cur)` returns
        an int errno or an (errno, ...) tuple; nonzero errno ROLLS BACK
        (pass errno_abort=False for bodies whose int return is a VALUE —
        counters, session ids — not an errno). Nested calls on one thread
        join the enclosing transaction (the outermost owner decides
        commit/rollback), mirroring the reference's per-engine txn wrappers
        (sql.go txn + the errno-abort convention)."""
        conn = self._conn()
        if getattr(self._tlocal, "in_txn", False):
            return fn(conn.cursor())
        last: Exception | None = None
        for attempt in range(retries):
            committed = None  # set -> (result, queued notifications)
            with self._wmutex:
                try:
                    conn.execute("BEGIN IMMEDIATE")
                    self._tlocal.in_txn = True
                    msgs: list = []
                    self._tlocal.msgs = msgs
                    # txn-rerun harness seam: the doubled first run rolls
                    # back to a savepoint and the recorded mutating-SQL
                    # streams are compared; queued notifications are
                    # cleared per run so a rerun cannot double them
                    tw = txnwatch.active()
                    if tw:
                        conn.execute("SAVEPOINT txnwatch")

                    def run_once():
                        del msgs[:]
                        cur = txnwatch.RecordingCursor(conn.cursor()) \
                            if tw else conn.cursor()
                        r = fn(cur)
                        return (r, tuple(cur.log) if tw else None, False)

                    result, _w, _d = txnwatch.double_run(
                        "sql", fn, run_once,
                        (lambda: conn.execute("ROLLBACK TO txnwatch"))
                        if tw else None)
                    st = result if isinstance(result, int) else (
                        result[0] if isinstance(result, tuple) and result else 0
                    )
                    if errno_abort and isinstance(st, int) and st:
                        conn.execute("ROLLBACK")
                        return result
                    if tw:
                        conn.execute("RELEASE txnwatch")
                    conn.execute("COMMIT")
                    committed = (result, msgs)
                except sqlite3.OperationalError as e:
                    try:
                        conn.execute("ROLLBACK")
                    except sqlite3.OperationalError:
                        pass
                    last = e
                except BaseException:
                    try:
                        conn.execute("ROLLBACK")
                    except sqlite3.OperationalError:
                        pass
                    raise
                finally:
                    self._tlocal.in_txn = False
                    self._tlocal.msgs = None
            if committed is not None:
                # fire notifications OUTSIDE the writer mutex and with
                # in_txn already cleared: a callback (e.g. compaction) may
                # open its own transactions and must not join this
                # already-committed one or convoy other writers
                result, msgs = committed
                for mtype, args in msgs:
                    self._notify(mtype, *args)
                return result
            # BUSY backoff outside the mutex so an out-of-process sqlite
            # lock doesn't stall every writer thread in this process
            time.sleep(min(0.001 * (1 << min(attempt, 8)), 0.1))
        raise last  # type: ignore[misc]

    def _rtxn(self, fn, retries: int = 50):
        """Read-only snapshot (sqlite gives repeatable reads inside one
        DEFERRED transaction; WAL readers never block the writer)."""
        conn = self._conn()
        if getattr(self._tlocal, "in_txn", False):
            return fn(conn.cursor())
        last: Exception | None = None
        for attempt in range(retries):
            try:
                conn.execute("BEGIN")
                try:
                    # txn-rerun harness seam: read closures double under
                    # the snapshot (race-free); nothing to reset — the
                    # whole transaction rolls back below either way
                    def run_once():
                        r = fn(conn.cursor())
                        return r, None, False

                    result, _w, _d = txnwatch.double_run(
                        "sql-read", fn, run_once)
                    return result
                finally:
                    conn.execute("ROLLBACK")
            except sqlite3.OperationalError as e:
                last = e
                time.sleep(min(0.001 * (1 << min(attempt, 8)), 0.1))
        raise last  # type: ignore[misc]

    def _queue_notify(self, mtype: int, *args) -> None:
        msgs = getattr(self._tlocal, "msgs", None)
        if msgs is not None:
            msgs.append((mtype, args))
        else:
            self._notify(mtype, *args)

    def group_txn(self, fn, ops=()):
        """Write-batch group commit: the drain closure runs
        inside ONE BEGIN IMMEDIATE transaction — nested do_* calls join
        it, and a nonzero return rolls the whole group back atomically
        (the errno-abort convention).  One commit per group is also one
        WAL fsync per group under synchronous=FULL — the durable-
        checkpoint posture this plane exists to amortize."""
        return self._txn(lambda cur: fn())

    def shutdown(self) -> None:
        """Close this thread's database connection (NOT the file-close meta
        op — that is BaseMeta.close(ctx, ino))."""
        conn = getattr(self._tlocal, "conn", None)
        if conn is not None:
            conn.close()
            self._tlocal.conn = None

    # ---- row helpers ------------------------------------------------------
    def _get_node(self, cur, ino: int) -> Optional[Attr]:
        row = cur.execute(
            f"SELECT {_NODE_COLS} FROM node WHERE inode=?", (ino,)
        ).fetchone()
        return _row_to_attr(row) if row else None

    def _put_node(self, cur, ino: int, attr: Attr) -> None:
        cur.execute(
            f"INSERT OR REPLACE INTO node ({_NODE_COLS}) VALUES "
            "(?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            _attr_params(ino, attr),
        )

    def _get_edge(self, cur, parent: int, name: bytes) -> tuple[int, int]:
        row = cur.execute(
            "SELECT type, inode FROM edge WHERE parent=? AND name=?",
            (parent, bytes(name)),
        ).fetchone()
        return (row[0], row[1]) if row else (0, 0)

    def _put_edge(self, cur, parent: int, name: bytes, typ: int, ino: int) -> None:
        cur.execute(
            "INSERT OR REPLACE INTO edge (parent,name,inode,type) VALUES (?,?,?,?)",
            (parent, bytes(name), ino, typ),
        )

    def _counter(self, cur, name: str) -> int:
        row = cur.execute("SELECT value FROM counter WHERE name=?", (name,)).fetchone()
        return row[0] if row else 0

    def _incr_counter(self, cur, name: str, delta: int) -> int:
        cur.execute(
            "INSERT INTO counter (name, value) VALUES (?, ?) "
            "ON CONFLICT(name) DO UPDATE SET value = value + excluded.value",
            (name, delta),
        )
        return self._counter(cur, name)

    @staticmethod
    def _sticky_violation(pattr: Attr, attr: Attr, ctx: Context) -> bool:
        return (
            ctx.check_permission
            and ctx.uid != 0
            and pattr.mode & 0o1000 != 0
            and ctx.uid != pattr.uid
            and ctx.uid != attr.uid
        )

    def _update_dirstat(self, cur, ino: int, dl: int, ds: int, di: int) -> None:
        if ino == 0:
            return
        if self.fmt.dir_stats:
            cur.execute(
                "INSERT INTO dirstats (inode,length,space,inodes) VALUES (?,?,?,?) "
                "ON CONFLICT(inode) DO UPDATE SET length=length+excluded.length, "
                "space=space+excluded.space, inodes=inodes+excluded.inodes",
                (ino, dl, ds, di),
            )
        self._quota_update(cur, ino, ds, di)

    def _update_used(self, cur, dspace: int, dinodes: int) -> int:
        if dspace > 0 and self.fmt.capacity:
            if self._counter(cur, "usedSpace") + dspace > self.fmt.capacity:
                return errno.ENOSPC
        if dinodes > 0 and self.fmt.inodes:
            if self._counter(cur, "totalInodes") + dinodes > self.fmt.inodes:
                return errno.ENOSPC
        if dspace:
            self._incr_counter(cur, "usedSpace", dspace)
        if dinodes:
            self._incr_counter(cur, "totalInodes", dinodes)
        return 0

    # ---- lifecycle ---------------------------------------------------------
    def do_init(self, fmt: Format, force: bool) -> int:
        def fn(cur):
            row = cur.execute(
                "SELECT value FROM setting WHERE name='format'"
            ).fetchone()
            if row is not None and not force:
                prev = Format.from_json(row[0])
                if prev.name != fmt.name:
                    raise RuntimeError(
                        f"volume already formatted as {prev.name}; use force to overwrite"
                    )
            cur.execute(
                "INSERT OR REPLACE INTO setting (name, value) VALUES ('format', ?)",
                (fmt.to_json().encode(),),
            )
            if self._get_node(cur, ROOT_INODE) is None:
                now = time.time()
                root = Attr(typ=TYPE_DIRECTORY, mode=0o777, nlink=2, length=4096,
                            parent=ROOT_INODE)
                root.touch_mtime(now)
                root.touch_atime(now)
                self._put_node(cur, ROOT_INODE, root)
                trash = Attr(typ=TYPE_DIRECTORY, mode=0o555, nlink=2, length=4096,
                             parent=TRASH_INODE)
                trash.touch_mtime(now)
                self._put_node(cur, TRASH_INODE, trash)
                cur.execute(
                    "INSERT OR REPLACE INTO counter (name,value) VALUES "
                    "('nextInode',2),('nextSlice',1)"
                )
            return 0

        self._txn(fn)
        self.fmt = fmt
        return 0

    def do_load(self) -> Optional[bytes]:
        def fn(cur):
            row = cur.execute(
                "SELECT value FROM setting WHERE name='format'"
            ).fetchone()
            return bytes(row[0]) if row else None

        return self._rtxn(fn)

    def do_reset(self) -> None:
        def fn(cur):
            for t in ("setting", "counter", "node", "edge", "chunkslice",
                      "sliceref", "symlink", "xattr", "parentlink", "delfile",
                      "session2", "sustained", "flock", "plock", "dirstats",
                      "dirquota", "acl", "blockdigest"):
                cur.execute(f"DELETE FROM {t}")
            return 0

        self._txn(fn)
        self._acl_cache.clear()
        self._acl_rev.clear()
        self._qcache = None

    def do_new_inodes(self, n: int) -> int:
        return self._txn(lambda cur: self._incr_counter(cur, "nextInode", n),
                         errno_abort=False) - n

    def do_new_slices(self, n: int) -> int:
        return self._txn(lambda cur: self._incr_counter(cur, "nextSlice", n),
                         errno_abort=False) - n

    def do_counter(self, name: str, delta: int = 0) -> int:
        if delta:
            return self._txn(lambda cur: self._incr_counter(cur, name, delta),
                             errno_abort=False)
        return self._rtxn(lambda cur: self._counter(cur, name))

    # ---- sessions ----------------------------------------------------------
    def do_new_session(self, info: Session) -> int:
        def fn(cur):
            sid = self._incr_counter(cur, "nextSession", 1)
            info.sid = sid
            cur.execute(
                "INSERT OR REPLACE INTO session2 (sid, info, heartbeat) VALUES (?,?,?)",
                (sid, info.to_json(), time.time()),
            )
            return sid

        return self._txn(fn, errno_abort=False)

    def do_refresh_session(self, sid: int) -> None:
        def fn(cur):
            cur.execute("UPDATE session2 SET heartbeat=? WHERE sid=?",
                        (time.time(), sid))
            return 0

        self._txn(fn)

    def do_update_session(self, sid: int, info: Session) -> None:
        def fn(cur):
            cur.execute("UPDATE session2 SET info=? WHERE sid=?",
                        (info.to_json(), sid))
            return 0

        self._txn(fn)

    def do_session_exists(self, sid: int) -> bool:
        return self._rtxn(lambda cur: cur.execute(
            "SELECT 1 FROM session2 WHERE sid=?", (sid,)
        ).fetchone() is not None)

    def do_revive_session(self, info: Session) -> None:
        """Re-register a reaped session under its original sid: the
        base default's UPDATE pair writes zero rows once the
        record is gone, so sql needs a real INSERT."""
        def fn(cur):
            cur.execute(
                "INSERT OR REPLACE INTO session2 (sid, info, heartbeat) "
                "VALUES (?,?,?)",
                (info.sid, info.to_json(), time.time()),
            )
            return 0

        self._txn(fn)

    def do_clean_session(self, sid: int) -> None:
        sustained = self._rtxn(lambda cur: [
            r[0] for r in cur.execute(
                "SELECT inode FROM sustained WHERE sid=?", (sid,)
            )
        ])
        for ino in sustained:
            self.do_delete_sustained(sid, ino)

        def fn(cur):
            cur.execute("DELETE FROM session2 WHERE sid=?", (sid,))
            cur.execute("DELETE FROM flock WHERE sid=?", (sid,))
            cur.execute("DELETE FROM plock WHERE sid=?", (sid,))
            return 0

        self._txn(fn)

    def do_list_sessions(self) -> list[Session]:
        rows = self._rtxn(lambda cur: cur.execute(
            "SELECT info, heartbeat FROM session2 ORDER BY sid"
        ).fetchall())
        out = []
        for info, heartbeat in rows:
            try:
                s = Session.from_json(info)
            except ValueError:
                continue
            # liveness for status / cache-group discovery (same stale age
            # as clean_stale_sessions)
            s.expire = float(heartbeat or 0) + SESSION_STALE_AGE
            out.append(s)
        return out

    def clean_stale_sessions(self, age: float = SESSION_STALE_AGE) -> int:
        cutoff = time.time() - age
        stale = self._rtxn(lambda cur: [
            r[0] for r in cur.execute(
                "SELECT sid FROM session2 WHERE heartbeat < ?", (cutoff,)
            )
        ])
        for sid in stale:
            self.do_clean_session(sid)
        return len(stale)

    def do_delete_sustained(self, sid: int, ino: int) -> None:
        def fn(cur):
            cur.execute("DELETE FROM sustained WHERE sid=? AND inode=?", (sid, ino))
            attr = self._get_node(cur, ino)
            if attr is not None and attr.nlink == 0:
                cur.execute("DELETE FROM node WHERE inode=?", (ino,))
                cur.execute(
                    "INSERT OR REPLACE INTO delfile (inode,length,expire) VALUES (?,?,?)",
                    (ino, attr.length, time.time()),
                )
            return 0

        self._txn(fn)

    # ---- attrs -------------------------------------------------------------
    def do_getattr(self, ino: int) -> tuple[int, Attr]:
        attr = self._rtxn(lambda cur: self._get_node(cur, ino))
        if attr is None:
            return errno.ENOENT, Attr()
        return 0, attr

    def do_setattr(self, ctx: Context, ino: int, flags: int, new: Attr) -> tuple[int, Attr]:
        interned: list = []

        def fn(cur):
            interned.clear()
            attr = self._get_node(cur, ino)
            if attr is None:
                return errno.ENOENT, Attr()
            now = time.time()
            changed = False
            if flags & SET_ATTR_MODE:
                mode = new.mode & 0o7777
                if ctx.uid != 0 and ctx.uid != attr.uid and ctx.check_permission:
                    return errno.EPERM, Attr()
                if ctx.uid != 0 and not ctx.contains_gid(attr.gid) and ctx.check_permission:
                    mode &= ~0o2000
                if attr.access_acl != acl_mod.ACL_NONE:
                    from dataclasses import replace as _rep

                    rule = self._load_acl(cur, attr.access_acl)
                    if rule is not None:
                        rule = _rep(rule)
                        rule.set_mode(mode)
                        attr.access_acl = self._insert_acl(cur, rule)
                        interned.append((attr.access_acl, rule))
                        mode = (mode & 0o7000) | rule.get_mode()
                attr.mode = mode
                changed = True
            if flags & SET_ATTR_UID and attr.uid != new.uid:
                attr.uid = new.uid
                changed = True
            if flags & SET_ATTR_GID and attr.gid != new.gid:
                attr.gid = new.gid
                changed = True
            if flags & SET_ATTR_ATIME:
                attr.atime, attr.atimensec = new.atime, new.atimensec
                changed = True
            if flags & SET_ATTR_ATIME_NOW:
                attr.touch_atime(now)
                changed = True
            if flags & SET_ATTR_MTIME:
                attr.mtime, attr.mtimensec = new.mtime, new.mtimensec
                changed = True
            if flags & SET_ATTR_MTIME_NOW:
                attr.touch_mtime(now)
                changed = True
            if flags & SET_ATTR_FLAG:
                attr.flags = new.flags
                changed = True
            if changed:
                attr.touch_ctime(now)
                self._put_node(cur, ino, attr)
            return 0, attr

        out = self._txn(fn)
        if out[0] == 0:
            for aid, r in interned:
                self._acl_publish(aid, r)
        return out

    # ---- namespace ---------------------------------------------------------
    def do_lookup(self, parent: int, name: bytes, hint_ino: int = 0) -> tuple[int, int, Attr]:
        # hint_ino is accepted for interface parity with the KV engine's
        # batched lookup; an in-process SQL read has no round trips to save
        def fn(cur):
            typ, ino = self._get_edge(cur, parent, name)
            if ino == 0:
                pattr = self._get_node(cur, parent)
                if pattr is None:
                    return errno.ENOENT, 0, Attr()
                if pattr.typ != TYPE_DIRECTORY:
                    return errno.ENOTDIR, 0, Attr()
                return errno.ENOENT, 0, Attr()
            attr = self._get_node(cur, ino)
            if attr is None:
                return 0, ino, Attr(typ=typ, full=False)
            return 0, ino, attr

        return self._rtxn(fn)

    def do_mknod(self, ctx, parent, name, typ, mode, cumask, rdev, path,
                 ino: int = 0) -> tuple[int, int, Attr]:
        # ino != 0: the write batcher's preallocated id
        ino = ino or self.new_inode()
        interned: list = []

        def fn(cur):
            interned.clear()
            pattr = self._get_node(cur, parent)
            if pattr is None:
                return errno.ENOENT, 0, Attr()
            if pattr.typ != TYPE_DIRECTORY:
                return errno.ENOTDIR, 0, Attr()
            if pattr.flags & FLAG_IMMUTABLE:
                return errno.EPERM, 0, Attr()
            etyp, _ = self._get_edge(cur, parent, name)
            if etyp:
                return errno.EEXIST, 0, Attr()
            if typ == TYPE_DIRECTORY:
                ispace = 4096
            elif typ == TYPE_SYMLINK:
                ispace = _align4k(len(path))
            else:
                ispace = 0
            st = self._update_used(cur, ispace, 1)
            if st:
                return st, 0, Attr()
            st = self._quota_check(cur, parent, ispace, 1)
            if st:
                return st, 0, Attr()
            now = time.time()
            req_mode = mode & 0o7777
            child_access = acl_mod.ACL_NONE
            child_default = acl_mod.ACL_NONE
            if pattr.default_acl != acl_mod.ACL_NONE and typ != TYPE_SYMLINK:
                if typ == TYPE_DIRECTORY:
                    child_default = pattr.default_acl
                drule = self._load_acl(cur, pattr.default_acl)
                if drule is None:
                    eff_mode = req_mode & ~cumask
                elif drule.is_minimal():
                    eff_mode = req_mode & (0o7000 | drule.get_mode())
                else:
                    crule = drule.child_access_acl(req_mode)
                    child_access = self._insert_acl(cur, crule)
                    interned.append((child_access, crule))
                    eff_mode = (req_mode & 0o7000) | crule.get_mode()
            else:
                eff_mode = req_mode & ~cumask
            attr = Attr(typ=typ, mode=eff_mode & 0o7777, uid=ctx.uid, gid=ctx.gid,
                        rdev=rdev, access_acl=child_access, default_acl=child_default)
            if typ == TYPE_DIRECTORY:
                attr.nlink = 2
                attr.length = 4096
            elif typ == TYPE_SYMLINK:
                attr.length = len(path)
                cur.execute(
                    "INSERT OR REPLACE INTO symlink (inode, target) VALUES (?,?)",
                    (ino, bytes(path)),
                )
            attr.parent = parent
            if pattr.mode & 0o2000:
                attr.gid = pattr.gid
                if typ == TYPE_DIRECTORY:
                    attr.mode |= 0o2000
            attr.touch_atime(now)
            attr.touch_mtime(now)
            self._put_node(cur, ino, attr)
            self._put_edge(cur, parent, name, typ, ino)
            if typ == TYPE_DIRECTORY:
                pattr.nlink += 1
            pattr.touch_mtime(now)
            self._put_node(cur, parent, pattr)
            self._update_dirstat(
                cur, parent, attr.length if typ != TYPE_DIRECTORY else 0, ispace, 1
            )
            return 0, ino, attr

        out = self._txn(fn)
        if out[0] == 0:
            for aid, r in interned:
                self._acl_publish(aid, r)
        return out

    def _trash_entry(self, cur, parent: int, name: bytes, ino: int, typ: int) -> None:
        """Move a doomed entry under the hourly trash dir; hour-dir inodes
        are deterministic (TRASH_INODE + 1 + hours since epoch), matching
        the KV engine so cross-engine trees stay comparable."""
        now = time.time()
        hname = time.strftime("%Y-%m-%d-%H", time.gmtime(now)).encode()
        hino = TRASH_INODE + 1 + int(now // 3600)
        if self._get_node(cur, hino) is None:
            hattr = Attr(typ=TYPE_DIRECTORY, mode=0o555, nlink=2, length=4096,
                         parent=TRASH_INODE)
            hattr.touch_mtime(now)
            self._put_node(cur, hino, hattr)
            self._put_edge(cur, TRASH_INODE, hname, TYPE_DIRECTORY, hino)
        tname = f"{parent}-{ino}-".encode() + name
        self._put_edge(cur, hino, tname[:250], typ, ino)
        attr = self._get_node(cur, ino)
        if attr is not None:
            attr.parent = hino
            attr.touch_ctime(now)
            self._put_node(cur, ino, attr)

    def do_unlink(self, ctx, parent, name, skip_trash=False) -> tuple[int, int]:
        trash = self.fmt.trash_days > 0 and not skip_trash and parent < TRASH_INODE
        victim = [0]  # resolved inside the txn: races with a concurrent
        # rename-onto-name cannot desync it from the deleted entry

        def fn(cur):
            typ, ino = self._get_edge(cur, parent, name)
            if ino == 0:
                return errno.ENOENT
            victim[0] = ino
            if typ == TYPE_DIRECTORY:
                return errno.EISDIR
            pattr = self._get_node(cur, parent)
            attr = self._get_node(cur, ino)
            if pattr is None:
                return errno.ENOENT
            if attr is not None and self._sticky_violation(pattr, attr, ctx):
                return errno.EACCES
            if attr is not None and attr.flags & (FLAG_IMMUTABLE | FLAG_APPEND):
                return errno.EPERM
            now = time.time()
            cur.execute("DELETE FROM edge WHERE parent=? AND name=?",
                        (parent, bytes(name)))
            pattr.touch_mtime(now)
            self._put_node(cur, parent, pattr)
            if attr is None:
                return 0
            if trash and attr.nlink == 1:
                self._trash_entry(cur, parent, name, ino, typ)
                self._update_dirstat(cur, parent, -attr.length, -_align4k(attr.length), -1)
                return 0
            attr.nlink -= 1
            attr.touch_ctime(now)
            if attr.parent == 0:
                row = cur.execute(
                    "SELECT cnt FROM parentlink WHERE inode=? AND parent=?",
                    (ino, parent),
                ).fetchone()
                cnt = row[0] if row else 1
                if cnt > 1:
                    cur.execute(
                        "UPDATE parentlink SET cnt=? WHERE inode=? AND parent=?",
                        (cnt - 1, ino, parent),
                    )
                else:
                    cur.execute(
                        "DELETE FROM parentlink WHERE inode=? AND parent=?",
                        (ino, parent),
                    )
            self._update_dirstat(cur, parent, -attr.length, -_align4k(attr.length), -1)
            if attr.nlink > 0:
                self._put_node(cur, ino, attr)
                return 0
            if typ == TYPE_FILE and self.of.is_open(ino) and self.sid:
                attr.parent = 0
                self._put_node(cur, ino, attr)
                cur.execute(
                    "INSERT OR REPLACE INTO sustained (sid, inode) VALUES (?,?)",
                    (self.sid, ino),
                )
                self._update_used(cur, -_align4k(attr.length), -1)
                return 0
            cur.execute("DELETE FROM node WHERE inode=?", (ino,))
            if typ == TYPE_FILE and attr.length > 0:
                cur.execute(
                    "INSERT OR REPLACE INTO delfile (inode,length,expire) VALUES (?,?,?)",
                    (ino, attr.length, now),
                )
            elif typ == TYPE_SYMLINK:
                cur.execute("DELETE FROM symlink WHERE inode=?", (ino,))
            cur.execute("DELETE FROM xattr WHERE inode=?", (ino,))
            cur.execute("DELETE FROM parentlink WHERE inode=?", (ino,))
            self._update_used(cur, -_align4k(attr.length), -1)
            return 0

        st = self._txn(fn)
        return st, victim[0] if st == 0 else 0

    def do_rmdir(self, ctx, parent, name, skip_trash=False) -> int:
        trash = self.fmt.trash_days > 0 and not skip_trash and parent < TRASH_INODE

        def fn(cur):
            typ, ino = self._get_edge(cur, parent, name)
            if ino == 0:
                return errno.ENOENT
            if typ != TYPE_DIRECTORY:
                return errno.ENOTDIR
            if cur.execute(
                "SELECT 1 FROM edge WHERE parent=? LIMIT 1", (ino,)
            ).fetchone():
                return errno.ENOTEMPTY
            pattr = self._get_node(cur, parent)
            attr = self._get_node(cur, ino)
            if pattr is None:
                return errno.ENOENT
            if attr is not None and self._sticky_violation(pattr, attr, ctx):
                return errno.EACCES
            now = time.time()
            cur.execute("DELETE FROM edge WHERE parent=? AND name=?",
                        (parent, bytes(name)))
            pattr.nlink -= 1
            pattr.touch_mtime(now)
            self._put_node(cur, parent, pattr)
            self._update_dirstat(cur, parent, 0, -4096, -1)
            if attr is None:
                return 0
            if trash:
                self._trash_entry(cur, parent, name, ino, typ)
                return 0
            cur.execute("DELETE FROM node WHERE inode=?", (ino,))
            cur.execute("DELETE FROM dirstats WHERE inode=?", (ino,))
            cur.execute("DELETE FROM dirquota WHERE inode=?", (ino,))
            cur.execute("DELETE FROM xattr WHERE inode=?", (ino,))
            self._update_used(cur, -4096, -1)
            return 0

        return self._txn(fn)

    def do_rename(self, ctx, psrc, nsrc, pdst, ndst, flags) -> tuple[int, int, Attr]:
        if flags & ~(RENAME_NOREPLACE | RENAME_EXCHANGE):
            return errno.ENOTSUP, 0, Attr()
        victim = [0]  # replaced/exchanged destination, resolved in-txn

        def fn(cur):
            styp, sino = self._get_edge(cur, psrc, nsrc)
            if sino == 0:
                return errno.ENOENT, 0, Attr()
            if psrc == pdst and nsrc == ndst:
                attr = self._get_node(cur, sino)
                return 0, sino, attr or Attr()
            sattr = self._get_node(cur, sino)
            spattr = self._get_node(cur, psrc)
            dpattr = self._get_node(cur, pdst)
            if spattr is None or dpattr is None or sattr is None:
                return errno.ENOENT, 0, Attr()
            if dpattr.typ != TYPE_DIRECTORY:
                return errno.ENOTDIR, 0, Attr()
            if self._sticky_violation(spattr, sattr, ctx):
                return errno.EACCES, 0, Attr()
            if (styp == TYPE_DIRECTORY and psrc != pdst
                    and self._is_ancestor(lambda i: self._get_node(cur, i),
                                          sino, pdst)):
                return errno.EINVAL, 0, Attr()
            dtyp, dino = self._get_edge(cur, pdst, ndst)
            victim[0] = dino if dino != sino else 0
            # the mirrored cycle: exchanging puts the DESTINATION dir
            # under psrc, so dino must not be an ancestor of psrc either
            # (kernel: EINVAL), or it becomes its own child
            if (flags & RENAME_EXCHANGE and dino and dtyp == TYPE_DIRECTORY
                    and psrc != pdst
                    and self._is_ancestor(lambda i: self._get_node(cur, i),
                                          dino, psrc)):
                return errno.EINVAL, 0, Attr()
            now = time.time()
            if dino and flags & RENAME_NOREPLACE:
                return errno.EEXIST, 0, Attr()
            if dino == sino and not flags & RENAME_EXCHANGE:
                # POSIX: old and new are directory entries for the same
                # file (hardlinks) -> succeed and change NOTHING; both
                # names remain (the kernel's vfs_rename short-circuits
                # this before any fs op)
                return 0, sino, sattr
            squota = dquota = None
            move_space = move_inodes = 0
            if psrc != pdst:
                squota = self._quota_roots(cur, psrc)
                dquota = self._quota_roots(cur, pdst)
                if squota != dquota and not flags & RENAME_EXCHANGE:
                    if styp == TYPE_DIRECTORY:
                        move_space, move_inodes = self._tree_usage(cur, sino)
                    else:
                        move_space, move_inodes = _align4k(sattr.length), 1
            if flags & RENAME_EXCHANGE:
                if dino == 0:
                    return errno.ENOENT, 0, Attr()
                dattr = self._get_node(cur, dino)
                if dattr is None:
                    return errno.ENOENT, 0, Attr()
                s_direct = _direct_space(sattr)
                d_direct = _direct_space(dattr)
                if psrc != pdst and squota != dquota:
                    s_space, s_inodes = (
                        self._tree_usage(cur, sino)
                        if styp == TYPE_DIRECTORY
                        else (s_direct, 1)
                    )
                    d_space, d_inodes = (
                        self._tree_usage(cur, dino)
                        if dtyp == TYPE_DIRECTORY
                        else (d_direct, 1)
                    )
                    st = self._quota_check_roots(
                        cur, dquota - squota, s_space - d_space, s_inodes - d_inodes
                    ) or self._quota_check_roots(
                        cur, squota - dquota, d_space - s_space, d_inodes - s_inodes
                    )
                    if st:
                        return st, 0, Attr()
                self._put_edge(cur, psrc, nsrc, dtyp, dino)
                self._put_edge(cur, pdst, ndst, styp, sino)
                sattr.parent, dattr.parent = pdst, psrc
                sattr.touch_ctime(now)
                dattr.touch_ctime(now)
                self._put_node(cur, sino, sattr)
                self._put_node(cur, dino, dattr)
                if psrc != pdst and styp != dtyp:
                    if styp == TYPE_DIRECTORY:
                        spattr.nlink -= 1
                        dpattr.nlink += 1
                    if dtyp == TYPE_DIRECTORY:
                        spattr.nlink += 1
                        dpattr.nlink -= 1
                spattr.touch_mtime(now)
                self._put_node(cur, psrc, spattr)
                if psrc != pdst:
                    dpattr.touch_mtime(now)
                    self._put_node(cur, pdst, dpattr)
                    ssz = _direct_len(sattr)
                    dsz = _direct_len(dattr)
                    self._update_dirstat(cur, psrc, dsz - ssz, d_direct - s_direct, 0)
                    self._update_dirstat(cur, pdst, ssz - dsz, s_direct - d_direct, 0)
                    if squota != dquota:
                        extra_s = (d_space - d_direct) - (s_space - s_direct)
                        extra_i = d_inodes - s_inodes
                        if extra_s or extra_i:
                            self._quota_update(cur, psrc, extra_s, extra_i)
                            self._quota_update(cur, pdst, -extra_s, -extra_i)
                return 0, sino, sattr
            if dino:
                dattr = self._get_node(cur, dino)
                if dtyp == TYPE_DIRECTORY:
                    if styp != TYPE_DIRECTORY:
                        return errno.EISDIR, 0, Attr()
                    if cur.execute(
                        "SELECT 1 FROM edge WHERE parent=? LIMIT 1", (dino,)
                    ).fetchone():
                        return errno.ENOTEMPTY, 0, Attr()
                elif styp == TYPE_DIRECTORY:
                    return errno.ENOTDIR, 0, Attr()
                if dattr is not None and self._sticky_violation(dpattr, dattr, ctx):
                    return errno.EACCES, 0, Attr()
                st = self._free_entry(cur, pdst, ndst, dtyp, dino, dattr, now)
                if st:
                    return st, 0, Attr()
            if psrc != pdst and squota != dquota:
                st = self._quota_check_roots(
                    cur, dquota - squota, move_space, move_inodes
                )
                if st:
                    return st, 0, Attr()
            cur.execute("DELETE FROM edge WHERE parent=? AND name=?",
                        (psrc, bytes(nsrc)))
            self._put_edge(cur, pdst, ndst, styp, sino)
            if sattr.parent:
                sattr.parent = pdst
            else:
                cur.execute("DELETE FROM parentlink WHERE inode=? AND parent=?",
                            (sino, psrc))
                cur.execute(
                    "INSERT INTO parentlink (inode,parent,cnt) VALUES (?,?,1) "
                    "ON CONFLICT(inode,parent) DO UPDATE SET cnt=cnt+1",
                    (sino, pdst),
                )
            sattr.touch_ctime(now)
            self._put_node(cur, sino, sattr)
            if styp == TYPE_DIRECTORY and psrc != pdst:
                spattr.nlink -= 1
                dpattr.nlink += 1
            spattr.touch_mtime(now)
            self._put_node(cur, psrc, spattr)
            if psrc != pdst:
                dpattr.touch_mtime(now)
                self._put_node(cur, pdst, dpattr)
            dsz = _direct_len(sattr)
            dspace = _direct_space(sattr)
            self._update_dirstat(cur, psrc, -dsz, -dspace, -1)
            self._update_dirstat(cur, pdst, dsz, dspace, 1)
            if styp == TYPE_DIRECTORY and psrc != pdst and squota != dquota:
                extra_s, extra_i = move_space - 4096, move_inodes - 1
                if extra_s or extra_i:
                    self._quota_update(cur, psrc, -extra_s, -extra_i)
                    self._quota_update(cur, pdst, extra_s, extra_i)
            return 0, sino, sattr

        st, ino, attr = self._txn(fn)
        if st == 0 and victim[0]:
            # the destination's nlink/ctime changed (decref on replace,
            # reparent on exchange): evict its open-file cached attr
            self.of.invalidate(victim[0])
        return st, ino, attr

    def _free_entry(self, cur, parent: int, name: bytes, typ: int, ino: int, attr, now) -> int:
        """Drop the entry at (parent, name) whose inode is being replaced."""
        trash = self.fmt.trash_days > 0 and parent < TRASH_INODE
        cur.execute("DELETE FROM edge WHERE parent=? AND name=?",
                    (parent, bytes(name)))
        if attr is None:
            return 0
        if trash and (typ == TYPE_DIRECTORY or attr.nlink == 1):
            self._trash_entry(cur, parent, name, ino, typ)
            self._update_dirstat(
                cur, parent, -(attr.length if typ == TYPE_FILE else 0),
                -(_align4k(attr.length) if typ == TYPE_FILE else 4096), -1,
            )
            return 0
        if typ == TYPE_DIRECTORY:
            cur.execute("DELETE FROM node WHERE inode=?", (ino,))
            cur.execute("DELETE FROM dirstats WHERE inode=?", (ino,))
            self._update_used(cur, -4096, -1)
            self._update_dirstat(cur, parent, 0, -4096, -1)
            return 0
        attr.nlink -= 1
        attr.touch_ctime(now)
        self._update_dirstat(cur, parent, -attr.length, -_align4k(attr.length), -1)
        if attr.nlink > 0:
            self._put_node(cur, ino, attr)
        else:
            if typ == TYPE_FILE and self.of.is_open(ino) and self.sid:
                attr.parent = 0
                self._put_node(cur, ino, attr)
                cur.execute(
                    "INSERT OR REPLACE INTO sustained (sid, inode) VALUES (?,?)",
                    (self.sid, ino),
                )
            else:
                cur.execute("DELETE FROM node WHERE inode=?", (ino,))
                if typ == TYPE_FILE and attr.length > 0:
                    cur.execute(
                        "INSERT OR REPLACE INTO delfile (inode,length,expire) "
                        "VALUES (?,?,?)",
                        (ino, attr.length, now),
                    )
                elif typ == TYPE_SYMLINK:
                    cur.execute("DELETE FROM symlink WHERE inode=?", (ino,))
            self._update_used(cur, -_align4k(attr.length), -1)
        return 0

    def do_link(self, ctx, ino, parent, name) -> tuple[int, Attr]:
        def fn(cur):
            attr = self._get_node(cur, ino)
            if attr is None:
                return errno.ENOENT, Attr()
            # an existing destination wins over EPERM-class refusals
            # (kernel linkat checks newpath existence first)
            etyp, _ = self._get_edge(cur, parent, name)
            if etyp:
                return errno.EEXIST, Attr()
            if attr.typ == TYPE_DIRECTORY:
                return errno.EPERM, Attr()
            if attr.flags & FLAG_IMMUTABLE:
                return errno.EPERM, Attr()
            pattr = self._get_node(cur, parent)
            if pattr is None:
                return errno.ENOENT, Attr()
            if pattr.typ != TYPE_DIRECTORY:
                return errno.ENOTDIR, Attr()
            now = time.time()
            if attr.parent and attr.parent != parent:
                cur.execute(
                    "INSERT OR REPLACE INTO parentlink (inode,parent,cnt) VALUES (?,?,1)",
                    (ino, attr.parent),
                )
                attr.parent = 0
            if attr.parent == 0:
                cur.execute(
                    "INSERT INTO parentlink (inode,parent,cnt) VALUES (?,?,1) "
                    "ON CONFLICT(inode,parent) DO UPDATE SET cnt=cnt+1",
                    (ino, parent),
                )
            attr.nlink += 1
            attr.touch_ctime(now)
            self._put_node(cur, ino, attr)
            self._put_edge(cur, parent, name, attr.typ, ino)
            pattr.touch_mtime(now)
            self._put_node(cur, parent, pattr)
            self._update_dirstat(cur, parent, attr.length, _align4k(attr.length), 1)
            return 0, attr

        return self._txn(fn)

    def do_readdir(self, ctx, ino, want_attr) -> tuple[int, list[Entry]]:
        def fn(cur):
            attr = self._get_node(cur, ino)
            if attr is None:
                return errno.ENOENT, []
            if attr.typ != TYPE_DIRECTORY:
                return errno.ENOTDIR, []
            out = []
            if want_attr:
                # one join instead of a per-entry attr fetch (the relational
                # engine's natural shape, and the readdir batch)
                rows = cur.execute(
                    "SELECT e.name, e.type, e.inode, " +
                    ",".join("n." + c for c in _NODE_COLS.split(",")[1:]) +
                    " FROM edge e LEFT JOIN node n ON n.inode = e.inode "
                    "WHERE e.parent=? ORDER BY e.name", (ino,)
                ).fetchall()
                for row in rows:
                    name, typ, cino = row[0], row[1], row[2]
                    if row[3] is None:
                        cattr = Attr(typ=typ, full=False)
                    else:
                        cattr = _row_to_attr((cino,) + tuple(row[3:]))
                    out.append(Entry(inode=cino, name=bytes(name), attr=cattr))
            else:
                for name, typ, cino in cur.execute(
                    "SELECT name, type, inode FROM edge WHERE parent=? ORDER BY name",
                    (ino,),
                ):
                    out.append(Entry(inode=cino, name=bytes(name),
                                     attr=Attr(typ=typ, full=False)))
            return 0, out

        return self._rtxn(fn)

    def do_readlink(self, ino) -> tuple[int, bytes]:
        row = self._rtxn(lambda cur: cur.execute(
            "SELECT target FROM symlink WHERE inode=?", (ino,)
        ).fetchone())
        if row is None:
            return errno.EINVAL, b""
        return 0, bytes(row[0])

    def get_parents(self, ino: int) -> dict[int, int]:
        st, attr = self.do_getattr(ino)
        if st:
            return {}
        if attr.parent:
            return {attr.parent: 1}
        rows = self._rtxn(lambda cur: cur.execute(
            "SELECT parent, cnt FROM parentlink WHERE inode=?", (ino,)
        ).fetchall())
        return {p: c for p, c in rows}

    # ---- file data ---------------------------------------------------------
    def _read_slices(self, cur, ino: int, indx: int) -> list[Slice]:
        return [
            Slice(pos=r[0], id=r[1], size=r[2], off=r[3], len=r[4])
            for r in cur.execute(
                "SELECT pos, sliceid, size, off, len FROM chunkslice "
                "WHERE inode=? AND indx=? ORDER BY seq", (ino, indx),
            )
        ]

    def _append_slice(self, cur, ino: int, indx: int, s: Slice) -> int:
        """Insert a slice after all existing ones; returns the new count."""
        row = cur.execute(
            "SELECT COALESCE(MAX(seq), -1), COUNT(*) FROM chunkslice "
            "WHERE inode=? AND indx=?", (ino, indx),
        ).fetchone()
        cur.execute(
            "INSERT INTO chunkslice (inode,indx,seq,pos,sliceid,size,off,len) "
            "VALUES (?,?,?,?,?,?,?,?)",
            (ino, indx, row[0] + 1, s.pos, s.id, s.size, s.off, s.len),
        )
        return row[1] + 1

    def do_read_chunk(self, ino, indx) -> tuple[int, list[Slice]]:
        return 0, self._rtxn(lambda cur: self._read_slices(cur, ino, indx))

    def do_write_chunk(self, ino, indx, pos, slc: Slice, length_hint: int, incref: bool = False) -> int:
        def fn(cur):
            attr = self._get_node(cur, ino)
            if attr is None:
                return errno.ENOENT
            if attr.typ != TYPE_FILE:
                return errno.EPERM
            now = time.time()
            if length_hint > attr.length:
                delta = _align4k(length_hint) - _align4k(attr.length)
                if delta > 0:
                    st = self._update_used(cur, delta, 0)
                    if st:
                        return st
                    if attr.parent:
                        st = self._quota_check(cur, attr.parent, delta, 0)
                        if st:
                            return st
                if attr.parent:
                    self._update_dirstat(cur, attr.parent,
                                         length_hint - attr.length, delta, 0)
                attr.length = length_hint
            if incref and slc.id:
                self._incref_slice(cur, slc.id, slc.size)
            attr.touch_mtime(now)
            self._put_node(cur, ino, attr)
            n = self._append_slice(cur, ino, indx, slc)
            if n > 100:
                self._queue_notify(interface.COMPACT_CHUNK, ino, indx)
            return 0

        return self._txn(fn)

    def do_compact_chunk(self, ino: int, indx: int, snapshot: bytes, new_slice: Slice) -> int:
        """Swap the compacted slice-list prefix for one merged slice.
        `snapshot` (the encoded list the merge was built from) must still be
        the chunk's prefix; concurrently appended slices survive as the tail
        (reference base.go:2009 compactChunk)."""
        snap = Slice.decode_list(snapshot)

        def fn(cur):
            rows = cur.execute(
                "SELECT seq, pos, sliceid, size, off, len FROM chunkslice "
                "WHERE inode=? AND indx=? ORDER BY seq", (ino, indx),
            ).fetchall()
            if len(rows) < len(snap):
                return errno.EINVAL
            for want, row in zip(snap, rows):
                if (want.pos, want.id, want.size, want.off, want.len) != tuple(row[1:]):
                    return errno.EINVAL
            first_seq = rows[0][0] if rows else 0
            last_seq = rows[len(snap) - 1][0] if snap else first_seq - 1
            cur.execute(
                "DELETE FROM chunkslice WHERE inode=? AND indx=? AND seq<=?",
                (ino, indx, last_seq),
            )
            cur.execute(
                "INSERT INTO chunkslice (inode,indx,seq,pos,sliceid,size,off,len) "
                "VALUES (?,?,?,?,?,?,?,?)",
                (ino, indx, last_seq, new_slice.pos, new_slice.id,
                 new_slice.size, new_slice.off, new_slice.len),
            )
            for s in snap:
                if s.id:
                    self._decref_slice(cur, s.id, s.size)
            return 0

        st = self._txn(fn)
        if st == 0:
            self.of.invalidate_chunk(ino, indx)
        return st

    def do_truncate(self, ctx, ino, length) -> tuple[int, Attr]:
        def fn(cur):
            attr = self._get_node(cur, ino)
            if attr is None:
                return errno.ENOENT, Attr()
            if attr.typ != TYPE_FILE:
                return errno.EPERM, Attr()
            if attr.flags & (FLAG_IMMUTABLE | FLAG_APPEND):
                return errno.EPERM, Attr()
            old = attr.length
            delta = _align4k(length) - _align4k(old)
            if delta > 0:
                st = self._update_used(cur, delta, 0)
                if st:
                    return st, Attr()
                if attr.parent:
                    st = self._quota_check(cur, attr.parent, delta, 0)
                    if st:
                        return st, Attr()
            elif delta < 0:
                self._update_used(cur, delta, 0)
            if attr.parent:
                self._update_dirstat(cur, attr.parent, length - old, delta, 0)
            attr.length = length
            attr.touch_mtime(time.time())
            self._put_node(cur, ino, attr)
            if length < old:
                first_dead = (length + CHUNK_SIZE - 1) // CHUNK_SIZE
                last = old // CHUNK_SIZE
                for i in range(first_dead, last + 1):
                    for s in self._read_slices(cur, ino, i):
                        if s.id:
                            self._decref_slice(cur, s.id, s.size)
                    cur.execute(
                        "DELETE FROM chunkslice WHERE inode=? AND indx=?", (ino, i)
                    )
                bpos = length % CHUNK_SIZE
                if bpos:
                    bindx = length // CHUNK_SIZE
                    tail = min(old - bindx * CHUNK_SIZE, CHUNK_SIZE) - bpos
                    if tail > 0 and cur.execute(
                        "SELECT 1 FROM chunkslice WHERE inode=? AND indx=? LIMIT 1",
                        (ino, bindx),
                    ).fetchone():
                        hole = Slice(pos=bpos, id=0, size=tail, off=0, len=tail)
                        self._append_slice(cur, ino, bindx, hole)
            return 0, attr

        return self._txn(fn)

    def do_fallocate(self, ctx, ino, mode, off, size) -> int:
        FALLOC_KEEP_SIZE, FALLOC_PUNCH_HOLE, FALLOC_ZERO_RANGE = 0x1, 0x2, 0x10

        def fn(cur):
            attr = self._get_node(cur, ino)
            if attr is None:
                return errno.ENOENT
            if attr.typ != TYPE_FILE:
                return errno.EPERM
            length = attr.length
            if not mode & FALLOC_KEEP_SIZE and off + size > length:
                delta = _align4k(off + size) - _align4k(length)
                if delta > 0:
                    st = self._update_used(cur, delta, 0)
                    if st:
                        return st
                    if attr.parent:
                        st = self._quota_check(cur, attr.parent, delta, 0)
                        if st:
                            return st
                if attr.parent:
                    self._update_dirstat(cur, attr.parent, off + size - length,
                                         max(delta, 0), 0)
                attr.length = off + size
            if mode & (FALLOC_PUNCH_HOLE | FALLOC_ZERO_RANGE):
                end = min(off + size, attr.length)
                pos = off
                while pos < end:
                    indx = pos // CHUNK_SIZE
                    cpos = pos % CHUNK_SIZE
                    n = min(CHUNK_SIZE - cpos, end - pos)
                    self._append_slice(
                        cur, ino, indx, Slice(pos=cpos, id=0, size=n, off=0, len=n)
                    )
                    pos += n
            attr.touch_mtime(time.time())
            self._put_node(cur, ino, attr)
            return 0

        return self._txn(fn)

    def _incref_slice(self, cur, sid: int, size: int) -> None:
        cur.execute(
            "INSERT INTO sliceref (sliceid, size, refs) VALUES (?,?,1) "
            "ON CONFLICT(sliceid, size) DO UPDATE SET refs=refs+1",
            (sid, size),
        )

    def _decref_slice(self, cur, sid: int, size: int) -> None:
        """refs column counts EXTRA references beyond the implicit first one
        (same convention as the KV engine / reference tkv sliceRef): absent
        row == 1 reference; decrement below zero frees the slice."""
        row = cur.execute(
            "SELECT refs FROM sliceref WHERE sliceid=? AND size=?", (sid, size)
        ).fetchone()
        cnt = (row[0] if row else 0) - 1
        if cnt < 0:
            cur.execute("DELETE FROM sliceref WHERE sliceid=? AND size=?",
                        (sid, size))
            self._queue_notify(interface.DELETE_SLICE, sid, size)
        else:
            cur.execute("UPDATE sliceref SET refs=? WHERE sliceid=? AND size=?",
                        (cnt, sid, size))

    def do_find_deleted_files(self, limit: int) -> dict[int, int]:
        rows = self._rtxn(lambda cur: cur.execute(
            "SELECT inode, length FROM delfile ORDER BY inode LIMIT ?", (limit,)
        ).fetchall())
        return {ino: length for ino, length in rows}

    def do_delete_file_data(self, ino: int, length: int) -> None:
        chunks = self._rtxn(lambda cur: [
            r[0] for r in cur.execute(
                "SELECT DISTINCT indx FROM chunkslice WHERE inode=?", (ino,)
            )
        ])
        for indx in chunks:
            def fn(cur, indx=indx):
                for s in self._read_slices(cur, ino, indx):
                    if s.id:
                        self._decref_slice(cur, s.id, s.size)
                cur.execute("DELETE FROM chunkslice WHERE inode=? AND indx=?",
                            (ino, indx))
                return 0

            self._txn(fn)

        def done(cur):
            cur.execute("DELETE FROM delfile WHERE inode=?", (ino,))
            return 0

        self._txn(done)

    def do_list_slices(self) -> dict[int, list[Slice]]:
        out: dict[int, list[Slice]] = {}
        for (ino, _indx), slcs in self.list_chunks():
            out.setdefault(ino, []).extend(s for s in slcs if s.id)
        return out

    def list_chunks(self):
        """Yield ((ino, indx), slices) for every chunk (gc/compaction scan)."""
        rows = self._rtxn(lambda cur: cur.execute(
            "SELECT inode, indx, pos, sliceid, size, off, len FROM chunkslice "
            "ORDER BY inode, indx, seq"
        ).fetchall())
        cur_key = None
        slcs: list[Slice] = []
        for ino, indx, pos, sid, size, off, ln in rows:
            if (ino, indx) != cur_key:
                if cur_key is not None:
                    yield cur_key, slcs
                cur_key = (ino, indx)
                slcs = []
            slcs.append(Slice(pos=pos, id=sid, size=size, off=off, len=ln))
        if cur_key is not None:
            yield cur_key, slcs

    # ---- push invalidation (reference vfs.go:1228 / openfile.go) ---------
    _INVAL_TTL = 60.0

    def do_publish_invalidations(self, sid: int, events: list[tuple]) -> None:
        payload = self._encode_inval_events(events)

        def fn(cur):
            seq = self._incr_counter(cur, "invalSeq", 1)
            cur.execute(
                "INSERT OR REPLACE INTO invalidation (seq, sid, ts, events) "
                "VALUES (?,?,?,?)",
                (seq, sid, time.time(), payload),
            )
            cur.execute("DELETE FROM invalidation WHERE ts < ?",
                        (time.time() - self._INVAL_TTL,))
            return 0

        self._txn(fn)

    def do_fetch_invalidations(self, since: int, exclude_sid: int) -> tuple[int, list[tuple]]:
        if since < 0:
            return self._rtxn(lambda cur: self._counter(cur, "invalSeq")), []
        rows = self._rtxn(lambda cur: cur.execute(
            "SELECT seq, sid, events FROM invalidation WHERE seq > ? "
            "ORDER BY seq", (since,)
        ).fetchall())
        events: list[tuple] = []
        latest = since
        for seq, sid, raw in rows:
            latest = max(latest, seq)
            if sid == exclude_sid:
                continue
            events.extend(self._decode_inval_events(raw))
        return latest, events

    # ---- content-hash index (device fingerprint plane) ----------------------
    def set_block_digests(self, entries: list[tuple[int, int, int, bytes]]) -> None:
        for i in range(0, len(entries), 1024):
            batch = entries[i:i + 1024]

            def fn(cur, batch=batch):
                cur.executemany(
                    "INSERT OR REPLACE INTO blockdigest (sliceid,indx,bsize,digest) "
                    "VALUES (?,?,?,?)",
                    [(sid, indx, bsize, digest) for sid, indx, bsize, digest in batch],
                )
                return 0

            self._txn(fn)

    def scan_block_digests(self):
        rows = self._rtxn(lambda cur: cur.execute(
            "SELECT sliceid, indx, bsize, digest FROM blockdigest "
            "ORDER BY sliceid, indx"
        ).fetchall())
        for sid, indx, bsize, digest in rows:
            yield sid, indx, bsize, bytes(digest)

    def delete_block_digests(self, pairs: list[tuple[int, int]]) -> None:
        for i in range(0, len(pairs), 1024):
            batch = pairs[i:i + 1024]

            def fn(cur, batch=batch):
                cur.executemany(
                    "DELETE FROM blockdigest WHERE sliceid=? AND indx=?", batch
                )
                return 0

            self._txn(fn)

    # ---- hot-content fingerprint snapshot -------------------------------
    # Relational mirror of kv.py's b"hotfp" blob: one setting-table row,
    # 64 bytes per (fp32, digest32) entry MRU-first, replaced wholesale.

    def set_hot_fingerprints(self, rows: list[tuple[bytes, bytes]]) -> None:
        blob = b"".join(fp + digest for fp, digest in rows)

        def fn(cur):
            if blob:
                cur.execute(
                    "INSERT OR REPLACE INTO setting (name, value) "
                    "VALUES ('hotfp', ?)", (blob,))
            else:
                cur.execute("DELETE FROM setting WHERE name='hotfp'")
            return 0

        self._txn(fn)

    def load_hot_fingerprints(self) -> list[tuple[bytes, bytes]]:
        row = self._rtxn(lambda cur: cur.execute(
            "SELECT value FROM setting WHERE name='hotfp'"
        ).fetchone())
        blob = bytes(row[0]) if row else b""
        return [
            (blob[i:i + 32], blob[i + 32:i + 64])
            for i in range(0, len(blob) - len(blob) % 64, 64)
        ]

    # ---- content-ref plane (inline ingest dedup) -------------------------
    # Relational mirror of the KV engine's H/G keyspace: contentref counts
    # every block served by one canonical stored object; contentalias rows
    # resolve a block back to its canonical for the read and delete paths.
    # Same single-transaction transition contract as kv.py.

    @staticmethod
    def _tx_lookup_refs(cur, digests: list[bytes]) -> dict:
        """{digest: (sliceid, indx, bsize)} for every digest with a
        contentref row, fetched with chunked IN queries. One statement
        per ~500 digests instead of one per digest: the ingest hot path
        runs these txns while compress/hash/PUT threads saturate the
        cores, and every extra cursor op is a GIL handoff the txn waits
        out (measured 245 ms for a 12-entry register under lane churn
        vs <1 ms idle — the statement count IS the latency)."""
        found: dict = {}
        uniq = list(dict.fromkeys(digests))
        for i in range(0, len(uniq), 500):
            chunk = uniq[i:i + 500]
            marks = ",".join("?" * len(chunk))
            for d, s, ix, b in cur.execute(
                    "SELECT digest, sliceid, indx, bsize FROM contentref "
                    f"WHERE digest IN ({marks})", chunk):
                found[bytes(d)] = (s, ix, b)
        return found

    @staticmethod
    def _tx_apply_refs(cur, bumps: dict, alias_rows: list) -> None:
        if bumps:
            cur.executemany(
                "UPDATE contentref SET refs=refs+? WHERE digest=?",
                [(n, d) for d, n in bumps.items()])
        if alias_rows:
            cur.executemany(
                "INSERT OR REPLACE INTO contentalias "
                "(sliceid,indx,digest,bsize,created) VALUES (?,?,?,?,?)",
                alias_rows)

    def content_incref(
        self, entries: list[tuple[bytes, int, int, int]]
    ) -> list[Optional[tuple[int, int, int]]]:
        """See KVMeta.content_incref."""

        def fn(cur):
            found = self._tx_lookup_refs(cur, [e[0] for e in entries])
            out: list = []
            bumps: dict = {}
            alias_rows: list = []
            now = time.time()
            for digest, sid, indx, bsize in entries:
                row = found.get(digest)
                if row is None:
                    out.append(None)
                    continue
                bumps[digest] = bumps.get(digest, 0) + 1
                alias_rows.append((sid, indx, digest, bsize, now))
                out.append(row)
            self._tx_apply_refs(cur, bumps, alias_rows)
            return out

        return self._txn(fn, errno_abort=False)

    def content_register(
        self, entries: list[tuple[bytes, int, int, int]]
    ) -> list[Optional[tuple[int, int, int]]]:
        """See KVMeta.content_register."""

        def fn(cur):
            found = self._tx_lookup_refs(cur, [e[0] for e in entries])
            out: list = []
            new_rows: list = []
            bumps: dict = {}
            alias_rows: list = []
            now = time.time()
            for digest, sid, indx, bsize in entries:
                row = found.get(digest)
                if row is None:
                    # first occurrence registers; a same-call duplicate
                    # behind it collapses onto this row (refs bumped)
                    found[digest] = (sid, indx, bsize)
                    new_rows.append((digest, sid, indx, bsize))
                    alias_rows.append((sid, indx, digest, bsize, now))
                    out.append(None)
                else:
                    bumps[digest] = bumps.get(digest, 0) + 1
                    alias_rows.append((sid, indx, digest, bsize, now))
                    out.append(row)
            if new_rows:
                cur.executemany(
                    "INSERT INTO contentref (digest,sliceid,indx,bsize,refs) "
                    "VALUES (?,?,?,?,1)", new_rows)
            self._tx_apply_refs(cur, bumps, alias_rows)
            return out

        return self._txn(fn, errno_abort=False)

    def content_decref(
        self, pairs: list[tuple[int, int]]
    ) -> list[tuple[str, Optional[tuple[int, int, int]]]]:
        """See KVMeta.content_decref."""

        def fn(cur):
            out: list = []
            for sid, indx in pairs:
                arow = cur.execute(
                    "SELECT digest FROM contentalias "
                    "WHERE sliceid=? AND indx=?", (sid, indx)).fetchone()
                if arow is None:
                    out.append(("untracked", None))
                    continue
                digest = bytes(arow[0])
                cur.execute("DELETE FROM contentalias "
                            "WHERE sliceid=? AND indx=?", (sid, indx))
                row = cur.execute(
                    "SELECT sliceid, indx, bsize, refs FROM contentref "
                    "WHERE digest=?", (digest,)).fetchone()
                if row is None:
                    out.append(("dangling", None))
                    continue
                canonical = (row[0], row[1], row[2])
                if row[3] <= 1:
                    cur.execute("DELETE FROM contentref WHERE digest=?",
                                (digest,))
                    out.append(("last", canonical))
                else:
                    cur.execute("UPDATE contentref SET refs=refs-1 "
                                "WHERE digest=?", (digest,))
                    out.append(("released", canonical))
            return out

        return self._txn(fn, errno_abort=False)

    def content_resolve(self, sid: int, indx: int) -> Optional[tuple[int, int, int]]:
        """See KVMeta.content_resolve."""
        row = self._rtxn(lambda cur: cur.execute(
            "SELECT r.sliceid, r.indx, r.bsize FROM contentalias a "
            "JOIN contentref r ON r.digest = a.digest "
            "WHERE a.sliceid=? AND a.indx=?", (sid, indx)).fetchone())
        return (row[0], row[1], row[2]) if row is not None else None

    def scan_content_refs(self):
        rows = self._rtxn(lambda cur: cur.execute(
            "SELECT digest, sliceid, indx, bsize, refs FROM contentref "
            "ORDER BY sliceid, indx").fetchall())
        for digest, sid, indx, bsize, refs in rows:
            yield bytes(digest), (sid, indx, bsize), refs

    def scan_content_aliases(self):
        """See KVMeta.scan_content_aliases (4th element = created_ts)."""
        rows = self._rtxn(lambda cur: cur.execute(
            "SELECT sliceid, indx, digest, bsize, created FROM contentalias "
            "ORDER BY sliceid, indx").fetchall())
        for sid, indx, digest, bsize, created in rows:
            yield (sid, indx), bytes(digest), bsize, created

    def content_set_refs(self, digest: bytes, refs: int) -> None:
        def fn(cur):
            if refs <= 0:
                cur.execute("DELETE FROM contentref WHERE digest=?", (digest,))
            else:
                cur.execute("UPDATE contentref SET refs=? WHERE digest=?",
                            (refs, digest))
            return 0

        self._txn(fn)

    def content_delete_aliases(self, pairs: list[tuple[int, int]]) -> None:
        for i in range(0, len(pairs), 1024):
            batch = pairs[i:i + 1024]

            def fn(cur, batch=batch):
                cur.executemany(
                    "DELETE FROM contentalias WHERE sliceid=? AND indx=?",
                    batch)
                return 0

            self._txn(fn)

    # ---- POSIX ACLs (reference pkg/meta/sql.go ACL rows + pkg/acl) -------
    def _load_acl(self, cur, aid: int) -> Optional["acl_mod.Rule"]:
        if aid == acl_mod.ACL_NONE:
            return None
        rule = self._acl_cache.get(aid)
        if rule is None:
            row = cur.execute("SELECT rule FROM acl WHERE id=?", (aid,)).fetchone()
            if row is None:
                return None
            raw = bytes(row[0])
            rule = acl_mod.Rule.decode(raw)
            self._acl_cache[aid] = rule
            self._acl_rev[raw] = aid
        return rule

    def _acl_publish(self, aid: int, rule: Optional["acl_mod.Rule"]) -> None:
        if aid != acl_mod.ACL_NONE and rule is not None:
            self._acl_cache.setdefault(aid, rule)
            self._acl_rev.setdefault(rule.encode(), aid)

    def _insert_acl(self, cur, rule: Optional["acl_mod.Rule"]) -> int:
        """Intern a rule; the UNIQUE(rule) constraint is the dedup (the
        relational answer to the KV engine's R-range scan). Only committed
        rows enter the in-memory maps — see _acl_publish."""
        if rule is None or rule.is_empty():
            return acl_mod.ACL_NONE
        enc = rule.encode()
        aid = self._acl_rev.get(enc)
        if aid is not None:
            return aid
        row = cur.execute("SELECT id FROM acl WHERE rule=?", (enc,)).fetchone()
        if row is not None:
            return row[0]
        aid = self._incr_counter(cur, "nextAcl", 1)
        cur.execute("INSERT INTO acl (id, rule) VALUES (?,?)", (aid, enc))
        return aid

    def do_load_acl(self, aid: int) -> Optional["acl_mod.Rule"]:
        if aid == acl_mod.ACL_NONE:
            return None
        rule = self._acl_cache.get(aid)
        if rule is not None:
            return rule
        return self._rtxn(lambda cur: self._load_acl(cur, aid))

    def do_set_facl(self, ctx: Context, ino: int, acl_type: int,
                    rule: "acl_mod.Rule") -> int:
        from dataclasses import replace as _rep

        interned: list = []

        def fn(cur):
            interned.clear()
            attr = self._get_node(cur, ino)
            if attr is None:
                return errno.ENOENT
            if ctx.check_permission and ctx.uid != 0 and ctx.uid != attr.uid:
                return errno.EPERM
            if attr.flags & FLAG_IMMUTABLE:
                return errno.EPERM
            if acl_type == acl_mod.TYPE_DEFAULT and attr.typ != TYPE_DIRECTORY:
                return errno.EACCES
            ori_id = (attr.access_acl if acl_type == acl_mod.TYPE_ACCESS
                      else attr.default_acl)
            ori_mode = attr.mode
            if (acl_type == acl_mod.TYPE_ACCESS and not rule.is_empty()
                    and ctx.check_permission and ctx.uid != 0
                    and not ctx.contains_gid(attr.gid)):
                attr.mode &= 0o5777
            if rule.is_empty():
                new_id = acl_mod.ACL_NONE
            elif rule.is_minimal() and acl_type == acl_mod.TYPE_ACCESS:
                new_id = acl_mod.ACL_NONE
                attr.mode = (attr.mode & 0o7000) | rule.get_mode()
            else:
                r = _rep(rule)
                r.inherit_perms(attr.mode)
                new_id = self._insert_acl(cur, r)
                interned.append((new_id, r))
                if acl_type == acl_mod.TYPE_ACCESS:
                    attr.mode = (attr.mode & 0o7000) | r.get_mode()
            if acl_type == acl_mod.TYPE_ACCESS:
                attr.access_acl = new_id
            else:
                attr.default_acl = new_id
            if ori_id != new_id or ori_mode != attr.mode:
                attr.touch_ctime(time.time())
                self._put_node(cur, ino, attr)
            return 0

        st = self._txn(fn)
        if st == 0:
            for aid, r in interned:
                self._acl_publish(aid, r)
        return st

    def do_get_facl(self, ino: int, acl_type: int) -> tuple[int, Optional["acl_mod.Rule"]]:
        from dataclasses import replace as _rep

        def fn(cur):
            attr = self._get_node(cur, ino)
            if attr is None:
                return errno.ENOENT, None
            aid = (attr.access_acl if acl_type == acl_mod.TYPE_ACCESS
                   else attr.default_acl)
            if aid == acl_mod.ACL_NONE:
                return errno.ENODATA, None
            rule = self._load_acl(cur, aid)
            if rule is None:
                return errno.EIO, None
            return 0, _rep(rule)

        return self._rtxn(fn)

    # ---- dir quotas (reference pkg/meta/quota.go over dirQuota rows) -----
    def _quota_roots_hint(self) -> set[int]:
        cached = self._qcache
        now = time.monotonic()
        if cached is not None and now - cached[1] <= self._QUOTA_HINT_TTL:
            return cached[0]
        roots = set(self._rtxn(lambda cur: [
            r[0] for r in cur.execute("SELECT inode FROM dirquota")
        ]))
        self._qcache = (roots, now)
        return roots

    def _quota_chain(self, cur, dir_ino: int):
        hint = self._quota_roots_hint()
        if not hint:
            return
        ino, hops = dir_ino, 0
        while ino and hops < 100:
            if ino in hint:
                row = cur.execute(
                    "SELECT space_limit, inode_limit, used_space, used_inodes "
                    "FROM dirquota WHERE inode=?", (ino,)
                ).fetchone()
                if row:
                    yield ino, row
            if ino == ROOT_INODE:
                break
            attr = self._get_node(cur, ino)
            if attr is None:
                break
            ino = attr.parent
            hops += 1

    def _quota_check(self, cur, dir_ino: int, dspace: int, dinodes: int) -> int:
        if dspace <= 0 and dinodes <= 0:
            return 0
        return self._quota_check_roots(
            cur, self._quota_roots(cur, dir_ino), dspace, dinodes
        )

    def _quota_update(self, cur, dir_ino: int, dspace: int, dinodes: int) -> None:
        if not dspace and not dinodes:
            return
        for ino, _row in self._quota_chain(cur, dir_ino):
            cur.execute(
                "UPDATE dirquota SET used_space=used_space+?, "
                "used_inodes=used_inodes+? WHERE inode=?",
                (dspace, dinodes, ino),
            )

    def _quota_roots(self, cur, dir_ino: int) -> set[int]:
        return {ino for ino, _ in self._quota_chain(cur, dir_ino)}

    def _quota_check_roots(self, cur, roots: set[int], dspace: int, dinodes: int) -> int:
        if dspace <= 0 and dinodes <= 0:
            return 0
        for ino in roots:
            row = cur.execute(
                "SELECT space_limit, inode_limit, used_space, used_inodes "
                "FROM dirquota WHERE inode=?", (ino,)
            ).fetchone()
            if not row:
                continue
            sl, il, us, ui = row
            if sl and dspace > 0 and us + dspace > sl:
                return errno.EDQUOT
            if il and dinodes > 0 and ui + dinodes > il:
                return errno.EDQUOT
        return 0

    def _tree_usage(self, cur, ino: int) -> tuple[int, int]:
        space = inodes = 0
        stack = [ino]
        while stack:
            cur_ino = stack.pop()
            attr = self._get_node(cur, cur_ino)
            if attr is None:
                continue
            space += _direct_space(attr)
            inodes += 1
            if attr.typ == TYPE_DIRECTORY:
                stack.extend(r[0] for r in cur.execute(
                    "SELECT inode FROM edge WHERE parent=?", (cur_ino,)
                ).fetchall())
        return space, inodes

    def set_dir_quota(self, ctx: Context, ino: int, space_limit: int, inode_limit: int) -> int:
        st, summ = self.summary(ctx, ino)
        if st:
            return st
        used_space = max(0, summ.size - 4096)
        used_inodes = summ.files + summ.dirs - 1

        def fn(cur):
            if self._get_node(cur, ino) is None:
                return errno.ENOENT
            cur.execute(
                "INSERT OR REPLACE INTO dirquota "
                "(inode, space_limit, inode_limit, used_space, used_inodes) "
                "VALUES (?,?,?,?,?)",
                (ino, space_limit, inode_limit, used_space, used_inodes),
            )
            return 0

        st = self._txn(fn)
        self._qcache = None
        return st

    def get_dir_quota(self, ino: int):
        row = self._rtxn(lambda cur: cur.execute(
            "SELECT space_limit, inode_limit, used_space, used_inodes "
            "FROM dirquota WHERE inode=?", (ino,)
        ).fetchone())
        return tuple(row) if row else None

    def check_dir_quota(self, ctx: Context, ino: int, repair: bool = False):
        rec = self.get_dir_quota(ino)
        if rec is None:
            return errno.ENOENT, (0, 0), (0, 0)
        sl, il, us, ui = rec
        st, summ = self.summary(ctx, ino)
        if st:
            return st, (us, ui), (0, 0)
        actual_space = max(0, summ.size - 4096)
        actual_inodes = summ.files + summ.dirs - 1
        if repair and (us, ui) != (actual_space, actual_inodes):
            def fn(cur):
                row = cur.execute(
                    "SELECT used_space, used_inodes FROM dirquota WHERE inode=?",
                    (ino,),
                ).fetchone()
                if row is None:
                    return errno.ENOENT
                if tuple(row) != (us, ui):
                    return errno.EAGAIN  # usage moved during the walk
                cur.execute(
                    "UPDATE dirquota SET used_space=?, used_inodes=? WHERE inode=?",
                    (actual_space, actual_inodes, ino),
                )
                return 0

            st = self._txn(fn)
            if st:
                return st, (us, ui), (actual_space, actual_inodes)
        return 0, (us, ui), (actual_space, actual_inodes)

    def del_dir_quota(self, ino: int) -> int:
        def fn(cur):
            cur.execute("DELETE FROM dirquota WHERE inode=?", (ino,))
            return 0

        st = self._txn(fn)
        self._qcache = None
        return st

    def list_dir_quotas(self) -> dict[int, tuple[int, int, int, int]]:
        rows = self._rtxn(lambda cur: cur.execute(
            "SELECT inode, space_limit, inode_limit, used_space, used_inodes "
            "FROM dirquota"
        ).fetchall())
        return {r[0]: tuple(r[1:]) for r in rows}

    # ---- clone (reference base.go:2427-2588 Clone) -----------------------
    def clone(self, ctx: Context, src_ino: int, dst_parent: int, name: bytes) -> tuple[int, int]:
        def fn(cur):
            sattr = self._get_node(cur, src_ino)
            if sattr is None:
                return errno.ENOENT, 0
            pattr = self._get_node(cur, dst_parent)
            if pattr is None:
                return errno.ENOENT, 0
            if pattr.typ != TYPE_DIRECTORY:
                return errno.ENOTDIR, 0
            typ, _ = self._get_edge(cur, dst_parent, name)
            if typ:
                return errno.EEXIST, 0
            space, count = self._tree_usage(cur, src_ino)
            if space > 0 and self.fmt.capacity:
                if self._counter(cur, "usedSpace") + space > self.fmt.capacity:
                    return errno.ENOSPC, 0
            if self.fmt.inodes:
                if self._counter(cur, "totalInodes") + count > self.fmt.inodes:
                    return errno.ENOSPC, 0
            st = self._quota_check(cur, dst_parent, space, count)
            if st:
                return st, 0
            next_ino = self._incr_counter(cur, "nextInode", count) - count
            now = time.time()
            new_root = 0
            dir_attrs: dict[int, Attr] = {}
            dir_children: dict[int, int] = {}
            stack = [(src_ino, dst_parent, None, 0)]
            while stack:
                old, new_parent, cname, ctyp = stack.pop()
                attr = self._get_node(cur, old)
                if attr is None:
                    continue
                new = next_ino
                next_ino += 1
                nattr = Attr.decode(attr.encode())
                nattr.parent = new_parent
                nattr.touch_ctime(now)
                nattr.nlink = 2 if nattr.typ == TYPE_DIRECTORY else 1
                self._put_node(cur, new, nattr)
                if cname is None:
                    new_root = new
                else:
                    self._put_edge(cur, new_parent, cname, ctyp, new)
                    if ctyp == TYPE_DIRECTORY:
                        dir_children[new_parent] = dir_children.get(new_parent, 0) + 1
                cur.execute(
                    "INSERT INTO xattr (inode, name, value) "
                    "SELECT ?, name, value FROM xattr WHERE inode=?",
                    (new, old),
                )
                if attr.typ == TYPE_SYMLINK:
                    cur.execute(
                        "INSERT INTO symlink (inode, target) "
                        "SELECT ?, target FROM symlink WHERE inode=?",
                        (new, old),
                    )
                elif attr.typ == TYPE_FILE:
                    cur.execute(
                        "INSERT INTO chunkslice "
                        "(inode,indx,seq,pos,sliceid,size,off,len) "
                        "SELECT ?, indx, seq, pos, sliceid, size, off, len "
                        "FROM chunkslice WHERE inode=?",
                        (new, old),
                    )
                    for sid, size in cur.execute(
                        "SELECT sliceid, size FROM chunkslice "
                        "WHERE inode=? AND sliceid != 0", (old,)
                    ).fetchall():
                        self._incref_slice(cur, sid, size)
                else:
                    dir_attrs[new] = nattr
                    for n2, t2, child in cur.execute(
                        "SELECT name, type, inode FROM edge WHERE parent=?",
                        (old,),
                    ).fetchall():
                        stack.append((child, new, bytes(n2), t2))
                    cur.execute(
                        "INSERT INTO dirstats (inode,length,space,inodes) "
                        "SELECT ?, length, space, inodes FROM dirstats "
                        "WHERE inode=?",
                        (new, old),
                    )
            for dino, n in dir_children.items():
                nattr = dir_attrs.get(dino)
                if nattr is not None and n:
                    nattr.nlink = 2 + n
                    self._put_node(cur, dino, nattr)
            self._put_edge(cur, dst_parent, name, sattr.typ, new_root)
            if sattr.typ == TYPE_DIRECTORY:
                pattr.nlink += 1
            pattr.touch_mtime(now)
            self._put_node(cur, dst_parent, pattr)
            self._incr_counter(cur, "usedSpace", space)
            self._incr_counter(cur, "totalInodes", count)
            if sattr.typ == TYPE_DIRECTORY:
                self._update_dirstat(cur, dst_parent, 0, 4096, 1)
                self._quota_update(cur, dst_parent, space - 4096, count - 1)
            else:
                self._update_dirstat(
                    cur, dst_parent, sattr.length, _align4k(sattr.length), 1
                )
            return 0, new_root

        return self._txn(fn)

    # ---- xattr -------------------------------------------------------------
    def do_getxattr(self, ino, name) -> tuple[int, bytes]:
        row = self._rtxn(lambda cur: cur.execute(
            "SELECT value FROM xattr WHERE inode=? AND name=?",
            (ino, bytes(name)),
        ).fetchone())
        if row is None:
            return errno.ENODATA, b""
        return 0, bytes(row[0])

    def do_setxattr(self, ino, name, value, flags) -> int:
        XATTR_CREATE, XATTR_REPLACE = 1, 2

        def fn(cur):
            if self._get_node(cur, ino) is None:
                return errno.ENOENT
            old = cur.execute(
                "SELECT 1 FROM xattr WHERE inode=? AND name=?",
                (ino, bytes(name)),
            ).fetchone()
            if flags & XATTR_CREATE and old is not None:
                return errno.EEXIST
            if flags & XATTR_REPLACE and old is None:
                return errno.ENODATA
            cur.execute(
                "INSERT OR REPLACE INTO xattr (inode, name, value) VALUES (?,?,?)",
                (ino, bytes(name), bytes(value)),
            )
            return 0

        return self._txn(fn)

    def do_listxattr(self, ino) -> tuple[int, list[bytes]]:
        def fn(cur):
            if self._get_node(cur, ino) is None:
                return errno.ENOENT, []
            return 0, [
                bytes(r[0]) for r in cur.execute(
                    "SELECT name FROM xattr WHERE inode=? ORDER BY name", (ino,)
                )
            ]

        return self._rtxn(fn)

    def do_removexattr(self, ino, name) -> int:
        def fn(cur):
            if cur.execute(
                "SELECT 1 FROM xattr WHERE inode=? AND name=?",
                (ino, bytes(name)),
            ).fetchone() is None:
                return errno.ENODATA
            cur.execute("DELETE FROM xattr WHERE inode=? AND name=?",
                        (ino, bytes(name)))
            return 0

        return self._txn(fn)

    # ---- locks (reference sql_lock.go over flock/plock rows) -------------
    @staticmethod
    def _s64(v: int) -> int:
        """Lock owners are kernel-generated u64 cookies, frequently >=
        2^63; sqlite INTEGER is signed 64-bit, so store the two's
        complement (caught by the POSIX oracle over a real mount)."""
        return v - (1 << 64) if v >= (1 << 63) else v

    def flock(self, ctx, ino: int, owner: int, ltype: str) -> int:
        sowner = self._s64(owner)

        def fn(cur):
            rows = cur.execute(
                "SELECT sid, owner, ltype FROM flock WHERE inode=?", (ino,)
            ).fetchall()
            if ltype == "U":
                cur.execute(
                    "DELETE FROM flock WHERE inode=? AND sid=? AND owner=?",
                    (ino, self.sid, sowner),
                )
            elif ltype == "R":
                if any(t == "W" and (s, o) != (self.sid, sowner)
                       for s, o, t in rows):
                    return errno.EAGAIN
                cur.execute(
                    "INSERT OR REPLACE INTO flock (inode,sid,owner,ltype) "
                    "VALUES (?,?,?,'R')",
                    (ino, self.sid, sowner),
                )
            elif ltype == "W":
                if any((s, o) != (self.sid, sowner) for s, o, _t in rows):
                    return errno.EAGAIN
                cur.execute(
                    "INSERT OR REPLACE INTO flock (inode,sid,owner,ltype) "
                    "VALUES (?,?,?,'W')",
                    (ino, self.sid, sowner),
                )
            else:
                return errno.EINVAL
            return 0

        st = self._txn(fn)
        if st == 0 and ltype == "U":
            self.lock_released(ino)
        return st

    def setlk(self, ctx, ino: int, owner: int, ltype: int, start: int, end: int, pid: int = 0) -> int:
        owner = self._s64(owner)

        def fn(cur):
            if ltype == self.F_UNLCK:
                mine = cur.execute(
                    "SELECT rowid, ltype, start, end, pid FROM plock "
                    "WHERE inode=? AND sid=? AND owner=? AND start<? AND end>?",
                    (ino, self.sid, owner, end, start),
                ).fetchall()
                for rowid, lt, ls, le, lpid in mine:
                    cur.execute("DELETE FROM plock WHERE rowid=?", (rowid,))
                    # keep the non-overlapping remains of the split range
                    if ls < start:
                        cur.execute(
                            "INSERT INTO plock (inode,sid,owner,ltype,start,end,pid) "
                            "VALUES (?,?,?,?,?,?,?)",
                            (ino, self.sid, owner, lt, ls, start, lpid),
                        )
                    if le > end:
                        cur.execute(
                            "INSERT INTO plock (inode,sid,owner,ltype,start,end,pid) "
                            "VALUES (?,?,?,?,?,?,?)",
                            (ino, self.sid, owner, lt, end, le, lpid),
                        )
            else:
                conflict = cur.execute(
                    "SELECT 1 FROM plock WHERE inode=? AND start<? AND end>? "
                    "AND NOT (sid=? AND owner=?) AND (?=1 OR ltype=1) LIMIT 1",
                    (ino, end, start, self.sid, owner,
                     1 if ltype == self.F_WRLCK else 0),
                ).fetchone()
                if conflict:
                    return errno.EAGAIN
                # Split own partially-overlapping locks like the F_UNLCK
                # path does, so e.g. a read-lock over a subrange of an own
                # write lock downgrades that subrange (POSIX) instead of
                # leaving the old write-lock row to shadow it.
                mine = cur.execute(
                    "SELECT rowid, ltype, start, end, pid FROM plock "
                    "WHERE inode=? AND sid=? AND owner=? AND start<? AND end>?",
                    (ino, self.sid, owner, end, start),
                ).fetchall()
                for rowid, lt, ls, le, lpid in mine:
                    cur.execute("DELETE FROM plock WHERE rowid=?", (rowid,))
                    if ls < start:
                        cur.execute(
                            "INSERT INTO plock (inode,sid,owner,ltype,start,end,pid) "
                            "VALUES (?,?,?,?,?,?,?)",
                            (ino, self.sid, owner, lt, ls, start, lpid),
                        )
                    if le > end:
                        cur.execute(
                            "INSERT INTO plock (inode,sid,owner,ltype,start,end,pid) "
                            "VALUES (?,?,?,?,?,?,?)",
                            (ino, self.sid, owner, lt, end, le, lpid),
                        )
                cur.execute(
                    "INSERT INTO plock (inode,sid,owner,ltype,start,end,pid) "
                    "VALUES (?,?,?,?,?,?,?)",
                    (ino, self.sid, owner, ltype, start, end, pid),
                )
            return 0

        st = self._txn(fn)
        if st == 0 and ltype == self.F_UNLCK:
            self.lock_released(ino)
        return st

    def getlk(self, ctx, ino: int, owner: int, ltype: int, start: int, end: int) -> tuple[int, int, int, int, int]:
        owner = self._s64(owner)

        def fn(cur):
            row = cur.execute(
                "SELECT ltype, start, end, pid FROM plock "
                "WHERE inode=? AND start<? AND end>? "
                "AND NOT (sid=? AND owner=?) AND (?=1 OR ltype=1) LIMIT 1",
                (ino, end, start, self.sid, owner,
                 1 if ltype == self.F_WRLCK else 0),
            ).fetchone()
            if row:
                return 0, row[0], row[1], row[2], row[3]
            return 0, self.F_UNLCK, 0, 0, 0

        return self._rtxn(fn)

    # ---- admin -------------------------------------------------------------
    def do_statfs(self) -> tuple[int, int, int, int]:
        used, iused = self._rtxn(lambda cur: (
            self._counter(cur, "usedSpace"), self._counter(cur, "totalInodes")
        ))
        used = max(used, 0)
        iused = max(iused, 0)
        total = self.fmt.capacity or (1 << 50)
        iavail = (self.fmt.inodes - iused) if self.fmt.inodes else (10 << 20)
        return total, max(total - used, 0), iused, max(iavail, 0)

    # ---- dump/load bridge (engine migration) ------------------------------
    # The dump document format is the KV engine's documented binary record
    # schema (meta/kv.py:1-31) — by speaking it, a dump taken from any KV
    # backend loads into this relational engine and vice versa, which is
    # the reference's "engine migration via dump/load" capability
    # (pkg/meta/dump.go). These two methods are pure FORMAT converters;
    # no engine logic is shared. Unlike the reference's, they carry the
    # content-ref plane too (H/G records and the hotfp blob, byte for byte
    # as the kv engine keys them), so a dump -> load of an inline-dedup
    # volume keeps its aliases; the reference's sql import skips those
    # records and its kv import stores them as they are.

    def export_kv_records(self) -> Iterator[tuple[bytes, bytes]]:
        import struct as _s

        recs: list[tuple[bytes, bytes]] = []

        def fn(cur):
            # reset-first: _rtxn reruns the closure on a sqlite BUSY
            # retry, and an append-only accumulator would double every
            # record in the dump (txn-purity contract)
            del recs[:]
            row = cur.execute("SELECT value FROM setting WHERE name='format'").fetchone()
            if row:
                recs.append((b"setting", bytes(row[0])))
            row = cur.execute("SELECT value FROM setting WHERE name='hotfp'").fetchone()
            if row:
                recs.append((b"hotfp", bytes(row[0])))
            for digest, sid, indx, bsize, refs in cur.execute(
                "SELECT digest, sliceid, indx, bsize, refs FROM contentref"
            ):
                recs.append((
                    b"H" + bytes(digest),
                    sid.to_bytes(8, "big") + indx.to_bytes(4, "big")
                    + bsize.to_bytes(4, "big") + _s.pack(">q", refs),
                ))
            for sid, indx, digest, bsize, created in cur.execute(
                "SELECT sliceid, indx, digest, bsize, created FROM contentalias"
            ):
                recs.append((
                    b"G" + sid.to_bytes(8, "big") + indx.to_bytes(4, "big"),
                    bytes(digest) + _s.pack(">I", bsize) + _s.pack(">d", created),
                ))
            for name, value in cur.execute("SELECT name, value FROM counter"):
                recs.append((b"C" + name.encode(),
                             int(value).to_bytes(8, "big", signed=True)))
            for row in cur.execute(f"SELECT {_NODE_COLS} FROM node"):
                ino = row[0]
                recs.append((b"A" + ino.to_bytes(8, "big") + b"I",
                             _row_to_attr(row).encode()))
            for parent, name, ino, typ in cur.execute(
                "SELECT parent, name, inode, type FROM edge"
            ):
                recs.append((
                    b"A" + parent.to_bytes(8, "big") + b"D" + bytes(name),
                    bytes([typ]) + ino.to_bytes(8, "big"),
                ))
            last = None
            buf = b""
            for ino, indx, pos, sid, size, off, ln in cur.execute(
                "SELECT inode, indx, pos, sliceid, size, off, len "
                "FROM chunkslice ORDER BY inode, indx, seq"
            ):
                key = b"A" + ino.to_bytes(8, "big") + b"C" + indx.to_bytes(4, "big")
                if key != last:
                    if last is not None:
                        recs.append((last, buf))
                    last, buf = key, b""
                buf += Slice(pos=pos, id=sid, size=size, off=off, len=ln).encode()
            if last is not None:
                recs.append((last, buf))
            for ino, target in cur.execute("SELECT inode, target FROM symlink"):
                recs.append((b"A" + ino.to_bytes(8, "big") + b"S", bytes(target)))
            for ino, name, value in cur.execute("SELECT inode, name, value FROM xattr"):
                recs.append((b"A" + ino.to_bytes(8, "big") + b"X" + bytes(name),
                             bytes(value)))
            for ino, parent, cnt in cur.execute(
                "SELECT inode, parent, cnt FROM parentlink"
            ):
                recs.append((
                    b"A" + ino.to_bytes(8, "big") + b"P" + parent.to_bytes(8, "big"),
                    _s.pack(">I", cnt),
                ))
            for sid, indx, bsize, digest in cur.execute(
                "SELECT sliceid, indx, bsize, digest FROM blockdigest"
            ):
                recs.append((
                    b"B" + sid.to_bytes(8, "big") + indx.to_bytes(4, "big"),
                    bsize.to_bytes(4, "big") + bytes(digest),
                ))
            for ino, length, expire in cur.execute(
                "SELECT inode, length, expire FROM delfile"
            ):
                recs.append((
                    b"D" + ino.to_bytes(8, "big") + length.to_bytes(8, "big"),
                    _s.pack(">d", expire),
                ))
            for aid, rule in cur.execute("SELECT id, rule FROM acl"):
                recs.append((b"R" + aid.to_bytes(4, "big"), bytes(rule)))
            for sid, size, refs in cur.execute(
                "SELECT sliceid, size, refs FROM sliceref"
            ):
                recs.append((
                    b"K" + sid.to_bytes(8, "big") + size.to_bytes(4, "big"),
                    _s.pack(">q", refs),
                ))
            flocks: dict[int, dict] = {}
            for ino, sid, owner, lt in cur.execute(
                "SELECT inode, sid, owner, ltype FROM flock"
            ):
                # dump format is canonical-unsigned (the KV engine keys by
                # the raw u64 cookie); convert back from signed storage
                flocks.setdefault(ino, {})[
                    f"{sid}/{owner & ((1 << 64) - 1):x}"] = lt
            for ino, table in flocks.items():
                recs.append((b"F" + ino.to_bytes(8, "big"),
                             json.dumps(table).encode()))
            plocks: dict[int, list] = {}
            u64 = (1 << 64) - 1
            for ino, sid, owner, lt, ls, le, pid in cur.execute(
                "SELECT inode, sid, owner, ltype, start, end, pid FROM plock"
            ):
                plocks.setdefault(ino, []).append(
                    [sid, owner & u64, lt, ls & u64, le & u64, pid])
            for ino, lst in plocks.items():
                recs.append((b"L" + ino.to_bytes(8, "big"),
                             json.dumps(lst).encode()))
            for sid, info, hb in cur.execute(
                "SELECT sid, info, heartbeat FROM session2"
            ):
                recs.append((b"SE" + sid.to_bytes(8, "big"), info.encode()))
                recs.append((b"SH" + sid.to_bytes(8, "big"), _s.pack(">d", hb)))
            for sid, ino in cur.execute("SELECT sid, inode FROM sustained"):
                recs.append((
                    b"SS" + sid.to_bytes(8, "big") + ino.to_bytes(8, "big"), b"1"
                ))
            for ino, length, space, inodes in cur.execute(
                "SELECT inode, length, space, inodes FROM dirstats"
            ):
                recs.append((b"U" + ino.to_bytes(8, "big"),
                             _s.pack(">qqq", length, space, inodes)))
            for ino, sl, il, us, ui in cur.execute(
                "SELECT inode, space_limit, inode_limit, used_space, used_inodes "
                "FROM dirquota"
            ):
                recs.append((b"QD" + ino.to_bytes(8, "big"),
                             _s.pack(">qqqq", sl, il, us, ui)))
            return 0

        self._rtxn(fn)
        recs.sort()
        return iter(recs)

    def import_kv_records(self, records: list[tuple[bytes, bytes]]) -> int:
        import struct as _s

        def fn(cur):
            for k, v in records:
                k = bytes(k)
                v = bytes(v)
                if k == b"setting":
                    cur.execute(
                        "INSERT OR REPLACE INTO setting (name, value) "
                        "VALUES ('format', ?)", (v,))
                elif k == b"hotfp":
                    cur.execute(
                        "INSERT OR REPLACE INTO setting (name, value) "
                        "VALUES ('hotfp', ?)", (v,))
                elif k.startswith(b"H"):
                    cur.execute(
                        "INSERT OR REPLACE INTO contentref "
                        "(digest,sliceid,indx,bsize,refs) VALUES (?,?,?,?,?)",
                        (k[1:], int.from_bytes(v[:8], "big"),
                         int.from_bytes(v[8:12], "big"),
                         int.from_bytes(v[12:16], "big"), _s.unpack_from(">q", v, 16)[0]))
                elif k.startswith(b"G"):
                    cur.execute(
                        "INSERT OR REPLACE INTO contentalias "
                        "(sliceid,indx,digest,bsize,created) VALUES (?,?,?,?,?)",
                        (int.from_bytes(k[1:9], "big"), int.from_bytes(k[9:13], "big"),
                         v[:32], _s.unpack_from(">I", v, 32)[0],
                         _s.unpack_from(">d", v, 36)[0] if len(v) >= 44 else 0.0))
                elif k.startswith(b"QD"):
                    sl, il, us, ui = _s.unpack(">qqqq", v)
                    cur.execute(
                        "INSERT OR REPLACE INTO dirquota VALUES (?,?,?,?,?)",
                        (int.from_bytes(k[2:10], "big"), sl, il, us, ui))
                elif k.startswith(b"C"):
                    cur.execute(
                        "INSERT OR REPLACE INTO counter VALUES (?,?)",
                        (k[1:].decode(), int.from_bytes(v, "big", signed=True)))
                elif k.startswith(b"A"):
                    ino = int.from_bytes(k[1:9], "big")
                    kind = k[9:10]
                    if kind == b"I":
                        self._put_node(cur, ino, Attr.decode(v))
                    elif kind == b"D":
                        self._put_edge(cur, ino, k[10:], v[0],
                                       int.from_bytes(v[1:9], "big"))
                    elif kind == b"C":
                        indx = int.from_bytes(k[10:14], "big")
                        for seq, s in enumerate(Slice.decode_list(v)):
                            cur.execute(
                                "INSERT OR REPLACE INTO chunkslice "
                                "VALUES (?,?,?,?,?,?,?,?)",
                                (ino, indx, seq, s.pos, s.id, s.size, s.off, s.len))
                    elif kind == b"S":
                        cur.execute(
                            "INSERT OR REPLACE INTO symlink VALUES (?,?)", (ino, v))
                    elif kind == b"X":
                        cur.execute(
                            "INSERT OR REPLACE INTO xattr VALUES (?,?,?)",
                            (ino, k[10:], v))
                    elif kind == b"P":
                        cur.execute(
                            "INSERT OR REPLACE INTO parentlink VALUES (?,?,?)",
                            (ino, int.from_bytes(k[10:18], "big"),
                             _s.unpack(">I", v)[0]))
                elif k.startswith(b"B"):
                    cur.execute(
                        "INSERT OR REPLACE INTO blockdigest VALUES (?,?,?,?)",
                        (int.from_bytes(k[1:9], "big"),
                         int.from_bytes(k[9:13], "big"),
                         int.from_bytes(v[:4], "big"), v[4:]))
                elif k.startswith(b"D"):
                    cur.execute(
                        "INSERT OR REPLACE INTO delfile VALUES (?,?,?)",
                        (int.from_bytes(k[1:9], "big"),
                         int.from_bytes(k[9:17], "big"), _s.unpack(">d", v)[0]))
                elif k.startswith(b"R"):
                    cur.execute(
                        "INSERT OR REPLACE INTO acl VALUES (?,?)",
                        (int.from_bytes(k[1:5], "big"), v))
                elif k.startswith(b"K"):
                    cur.execute(
                        "INSERT OR REPLACE INTO sliceref VALUES (?,?,?)",
                        (int.from_bytes(k[1:9], "big"),
                         int.from_bytes(k[9:13], "big"), _s.unpack(">q", v)[0]))
                elif k.startswith(b"F"):
                    ino = int.from_bytes(k[1:9], "big")
                    for ow, lt in json.loads(v).items():
                        sid_s, owner_s = ow.split("/")
                        cur.execute(
                            "INSERT OR REPLACE INTO flock VALUES (?,?,?,?)",
                            (ino, int(sid_s), self._s64(int(owner_s, 16)), lt))
                elif k.startswith(b"L"):
                    ino = int.from_bytes(k[1:9], "big")
                    for sid, owner, lt, ls, le, pid in json.loads(v):
                        cur.execute(
                            "INSERT INTO plock VALUES (?,?,?,?,?,?,?)",
                            (ino, sid, self._s64(owner), lt,
                             self._s64(ls), self._s64(le), pid))
                elif k.startswith(b"SE"):
                    cur.execute(
                        "INSERT OR REPLACE INTO session2 (sid, info, heartbeat) "
                        "VALUES (?, ?, COALESCE((SELECT heartbeat FROM session2 "
                        "WHERE sid=?), 0))",
                        (int.from_bytes(k[2:10], "big"), v.decode(),
                         int.from_bytes(k[2:10], "big")))
                elif k.startswith(b"SH"):
                    cur.execute(
                        "UPDATE session2 SET heartbeat=? WHERE sid=?",
                        (_s.unpack(">d", v)[0], int.from_bytes(k[2:10], "big")))
                elif k.startswith(b"SS"):
                    cur.execute(
                        "INSERT OR REPLACE INTO sustained VALUES (?,?)",
                        (int.from_bytes(k[2:10], "big"),
                         int.from_bytes(k[10:18], "big")))
                elif k.startswith(b"U"):
                    ln, sp, ic = _s.unpack(">qqq", v)
                    cur.execute(
                        "INSERT OR REPLACE INTO dirstats VALUES (?,?,?,?)",
                        (int.from_bytes(k[1:9], "big"), ln, sp, ic))
            return 0

        self._txn(fn)
        return len(records)

    def has_records(self) -> bool:
        return self._rtxn(lambda cur: bool(
            cur.execute("SELECT 1 FROM setting LIMIT 1").fetchone()
            or cur.execute("SELECT 1 FROM node LIMIT 1").fetchone()
        ))


def _factory(scheme: str, addr: str) -> SQLMeta:
    return SQLMeta(addr, f"{scheme}://{addr}")


interface.register("sql", _factory)
