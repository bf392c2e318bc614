"""KV meta engine over an ordered-KV client
(reference: pkg/meta/tkv.go kvMeta + key schema tkv.go:165-196).

Binary key schema (big-endian; adapted from the reference's TKV schema,
the cleanest of its three engines — SURVEY.md §7.1):

    setting                      -> Format JSON
    C{name}                      -> counter (i64): nextInode nextSlice
                                    nextSession usedSpace totalInodes
    A{ino8}I                     -> inode attribute (Attr codec)
    A{ino8}D{name}               -> dentry: typ(1) + ino(8)
    A{ino8}C{indx4}              -> chunk: concatenated 24B Slice records
    A{ino8}S                     -> symlink target
    A{ino8}X{name}               -> xattr value
    A{ino8}P{parent8}            -> hard-link parent refcount (u32)
    B{sliceid8}{indx4}           -> content index: bsize(u32) + JTH-256
                                    digest(32B) of the raw block (device
                                    fingerprint plane; no reference
                                    equivalent — the reference addresses
                                    blocks by slice id only)
    H{digest32}                  -> content ref: canonical sliceid(8) +
                                    indx(4) + bsize(4) + refcount(i64)
                                    (inline ingest dedup)
    G{sliceid8}{indx4}           -> content alias: digest(32) + bsize(4) +
                                    created(f64) — this block's bytes live
                                    under the canonical block of H{digest};
                                    the timestamp guards gc reconciliation
                                    against repairing in-flight writes
    D{ino8}{length8}             -> deleted file pending data reclaim (ts f64)
    R{aclid4}                    -> interned POSIX ACL rule (insert-only;
                                    Attr.access_acl/default_acl point here)
    K{sliceid8}{size4}           -> slice refcount delta (i64; absent == 1)
    F{ino8}                      -> BSD flock table (JSON)
    L{ino8}                      -> POSIX record locks (JSON)
    SE{sid8} / SH{sid8}          -> session info (JSON) / heartbeat (f64)
    SS{sid8}{ino8}               -> sustained (open-but-unlinked) inode
    U{ino8}                      -> dir stats: length, space, inodes (3x i64)
    QD{ino8}                     -> dir quota: space,inodes,used_space,used_inodes
"""

from __future__ import annotations

import errno
import json
import struct
import threading
import time
from typing import Optional

from ..utils import get_logger
from . import acl as acl_mod
from . import interface
from .base import BaseMeta
from .context import Context
from .slice import build_slice
from .tkv_client import KVTxn, TKVClient, new_tkv_client, next_key
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
    SET_ATTR_SIZE,
    SET_ATTR_UID,
    TRASH_INODE,
    TRASH_NAME,
    TYPE_DIRECTORY,
    TYPE_FILE,
    TYPE_SYMLINK,
)

logger = get_logger("meta.kv")

_I64 = struct.Struct(">q")
_U32 = struct.Struct(">I")
_F64 = struct.Struct(">d")


def _align4k(length: int) -> int:
    return (length + 4095) // 4096 * 4096 if length else 0


def _direct_space(attr: "Attr") -> int:
    """Space one inode itself charges: dir flat 4096, file/symlink its
    4k-aligned length (symmetric with mknod/unlink accounting)."""
    return 4096 if attr.typ == TYPE_DIRECTORY else _align4k(attr.length)


def _direct_len(attr: "Attr") -> int:
    """Byte-length contribution to the parent's dirstat (dirs count 0)."""
    return 0 if attr.typ == TYPE_DIRECTORY else attr.length


class KVMeta(BaseMeta):
    """Meta engine over any TKVClient (reference pkg/meta/tkv.go kvMeta)."""

    # the IV{seq} journal + invalSeq counter below are the per-volume
    # change feed the lease cache requires
    supports_inval_feed = True
    # every TKVClient nests (a do_* inside an open txn joins it), so the
    # write batcher's group commit is one atomic engine txn
    supports_group_txn = True

    def __init__(self, client: TKVClient, addr: str = ""):
        super().__init__(addr)
        self.client = client
        self._nlocal = threading.local()  # deferred notification buffer
        self._qcache: tuple[set[int], float] | None = None  # quota-roots hint
        # interned ACL rules (reference pkg/acl/cache.go): id -> rule and
        # the reverse encode -> id used as the insert-dedup fast path. Only
        # COMMITTED rows enter these maps (_load_acl reads of committed
        # ids, or _acl_publish after a successful txn) — never allocations
        # from an open transaction, so a conflict-aborted txn can never
        # leave phantom ids that would later alias a different rule.
        self._acl_cache: dict[int, "acl_mod.Rule"] = {}
        self._acl_rev: dict[bytes, int] = {}

    def name(self) -> str:
        return self.client.name

    # ---- transactions with post-commit notifications ---------------------
    def _etxn(self, fn):
        """Write transaction under the errno convention: `fn` returns an int
        errno or an (errno, ...) tuple, and a nonzero errno DISCARDS the
        buffered writes. This mirrors the reference, where a do_* closure
        returning an error aborts the backend transaction (pkg/meta/tkv.go
        txn commits only on nil error) — so mutate-then-fail paths (e.g.
        counter bumps before a quota rejection) can never leak state.

        When called inside an enclosing transaction we join it unwrapped:
        the outermost owner decides commit/abort from its own return.
        """
        if self.client.in_txn():
            return self.client.txn(fn)

        def wrapped(tx):
            r = fn(tx)
            st = r if isinstance(r, int) else (r[0] if isinstance(r, tuple) and r else 0)
            if isinstance(st, int) and st:
                tx.discard()
            return r

        return self.client.txn(wrapped)

    def _txn_notify(self, fn):
        """Run a transaction whose body may queue DELETE_SLICE/COMPACT_CHUNK
        messages; fire them only after a successful commit so callbacks never
        act on uncommitted (or rolled-back) state."""
        if getattr(self._nlocal, "msgs", None) is not None:
            return self.client.txn(fn)  # nested: outermost commit fires
        msgs: list = []
        self._nlocal.msgs = msgs
        try:
            def wrapped(tx):
                del msgs[:]  # retry: drop notifications from the failed attempt
                return fn(tx)

            result = self._etxn(wrapped)
        except BaseException:
            del msgs[:]
            raise
        finally:
            self._nlocal.msgs = None
        for mtype, args in msgs:
            self._notify(mtype, *args)
        return result

    def _queue_notify(self, mtype: int, *args) -> None:
        msgs = getattr(self._nlocal, "msgs", None)
        if msgs is not None:
            msgs.append((mtype, args))
        else:
            self._notify(mtype, *args)

    def group_txn(self, fn, ops=()):
        """Write-batch group commit: run the drain closure
        inside ONE engine transaction — every nested do_* joins it via
        `in_txn`, a nonzero return discards the whole buffer atomically,
        and queued DELETE_SLICE/COMPACT_CHUNK notifications fire only
        after the commit.

        The group's predictable read set (dentry-exists keys, parent and
        target attrs, the usage counters) is pre-warmed with ONE batched
        `tx.gets` — on a networked engine that is one MGET round trip
        for the whole group instead of one WATCH+GET per member, which
        also shrinks the optimistic-conflict window a shard storm's hot
        keys (parent attr, totalInodes) would otherwise blow open."""
        def run(tx: KVTxn):
            keys: list[bytes] = []
            seen: set[bytes] = set()
            rename_edges: list[tuple[int, bytes]] = []
            for op in ops:
                if op.kind == "mknod":
                    ks = (self._entry_key(op.parent, op.name),
                          self._attr_key(op.parent))
                elif op.kind in ("write_chunk", "setattr"):
                    ks = (self._attr_key(op.ino),)
                elif op.kind == "rename" and op.args:
                    psrc, nsrc, pdst, ndst = op.args
                    rename_edges += [(psrc, nsrc), (pdst, ndst)]
                    ks = (self._entry_key(psrc, nsrc), self._attr_key(psrc),
                          self._entry_key(pdst, ndst), self._attr_key(pdst))
                else:
                    ks = ()
                for k in ks:
                    if k not in seen:
                        seen.add(k)
                        keys.append(k)
            if keys:
                keys.append(self._counter_key("usedSpace"))
                keys.append(self._counter_key("totalInodes"))
                tx.gets(*keys)  # warm the txn read cache in one trip
            # phase 2: the renames' source/victim attrs — the entry reads
            # above are cached now, so resolving them costs no trip, and
            # one more batched gets covers every resolved inode
            extra: list[bytes] = []
            for parent, name in rename_edges:
                raw = tx.get(self._entry_key(parent, name))
                if raw:
                    k = self._attr_key(int.from_bytes(raw[1:9], "big"))
                    if k not in seen:
                        seen.add(k)
                        extra.append(k)
            if extra:
                tx.gets(*extra)
            return fn()

        return self._txn_notify(run)

    # ---- key builders (reference tkv.go:198-296) -------------------------
    @staticmethod
    def _ino_key(ino: int) -> bytes:
        return b"A" + ino.to_bytes(8, "big")

    def _attr_key(self, ino: int) -> bytes:
        return self._ino_key(ino) + b"I"

    def _entry_key(self, parent: int, name: bytes) -> bytes:
        return self._ino_key(parent) + b"D" + name

    def _chunk_key(self, ino: int, indx: int) -> bytes:
        return self._ino_key(ino) + b"C" + indx.to_bytes(4, "big")

    def _symlink_key(self, ino: int) -> bytes:
        return self._ino_key(ino) + b"S"

    def _xattr_key(self, ino: int, name: bytes) -> bytes:
        return self._ino_key(ino) + b"X" + name

    def _parent_key(self, ino: int, parent: int) -> bytes:
        return self._ino_key(ino) + b"P" + parent.to_bytes(8, "big")

    @staticmethod
    def _counter_key(name: str) -> bytes:
        return b"C" + name.encode()

    @staticmethod
    def _delfile_key(ino: int, length: int) -> bytes:
        return b"D" + ino.to_bytes(8, "big") + length.to_bytes(8, "big")

    @staticmethod
    def _sliceref_key(sid: int, size: int) -> bytes:
        return b"K" + sid.to_bytes(8, "big") + size.to_bytes(4, "big")

    @staticmethod
    def _flock_key(ino: int) -> bytes:
        return b"F" + ino.to_bytes(8, "big")

    @staticmethod
    def _plock_key(ino: int) -> bytes:
        return b"L" + ino.to_bytes(8, "big")

    @staticmethod
    def _session_key(sid: int) -> bytes:
        return b"SE" + sid.to_bytes(8, "big")

    @staticmethod
    def _heartbeat_key(sid: int) -> bytes:
        return b"SH" + sid.to_bytes(8, "big")

    @staticmethod
    def _sustained_key(sid: int, ino: int) -> bytes:
        return b"SS" + sid.to_bytes(8, "big") + ino.to_bytes(8, "big")

    @staticmethod
    def _dirstat_key(ino: int) -> bytes:
        return b"U" + ino.to_bytes(8, "big")

    @staticmethod
    def _dirquota_key(ino: int) -> bytes:
        return b"QD" + ino.to_bytes(8, "big")

    @staticmethod
    def _blockdigest_key(sid: int, indx: int) -> bytes:
        return b"B" + sid.to_bytes(8, "big") + indx.to_bytes(4, "big")

    @staticmethod
    def _acl_key(aid: int) -> bytes:
        return b"R" + aid.to_bytes(4, "big")

    # ---- txn-scoped helpers ---------------------------------------------
    def _get_attr(self, tx: KVTxn, ino: int) -> Optional[Attr]:
        raw = tx.get(self._attr_key(ino))
        return Attr.decode(raw) if raw else None

    def _set_attr(self, tx: KVTxn, ino: int, attr: Attr) -> None:
        tx.set(self._attr_key(ino), attr.encode())

    def _get_entry(self, tx: KVTxn, parent: int, name: bytes) -> tuple[int, int]:
        raw = tx.get(self._entry_key(parent, name))
        if not raw:
            return 0, 0
        return raw[0], int.from_bytes(raw[1:9], "big")

    def _set_entry(self, tx: KVTxn, parent: int, name: bytes, typ: int, ino: int) -> None:
        tx.set(self._entry_key(parent, name), bytes([typ]) + ino.to_bytes(8, "big"))

    def _scan_entries(self, tx: KVTxn, ino: int) -> list[tuple[bytes, int, int]]:
        prefix = self._ino_key(ino) + b"D"
        out = []
        for k, v in tx.scan(prefix, next_key(prefix)):
            out.append((k[len(prefix):], v[0], int.from_bytes(v[1:9], "big")))
        return out

    def _update_dirstat(self, tx: KVTxn, ino: int, dl: int, ds: int, di: int) -> None:
        if ino == 0:
            return
        if self.fmt.dir_stats:
            key = self._dirstat_key(ino)
            raw = tx.get(key)
            l, s, i = struct.unpack(">qqq", raw) if raw else (0, 0, 0)
            tx.set(key, struct.pack(">qqq", l + dl, s + ds, i + di))
        # dir quota usage propagates up the ancestor chain regardless of
        # the dir_stats toggle (reference quota.go update path)
        self._quota_update(tx, ino, ds, di)

    def _update_used(self, tx: KVTxn, dspace: int, dinodes: int) -> int:
        """Global usage counters + volume quota check (reference quota.go)."""
        if dspace > 0 and self.fmt.capacity:
            used = self._counter_get(tx, "usedSpace")
            if used + dspace > self.fmt.capacity:
                return errno.ENOSPC
        if dinodes > 0 and self.fmt.inodes:
            used = self._counter_get(tx, "totalInodes")
            if used + dinodes > self.fmt.inodes:
                return errno.ENOSPC
        if dspace:
            tx.incr_by(self._counter_key("usedSpace"), dspace)
        if dinodes:
            tx.incr_by(self._counter_key("totalInodes"), dinodes)
        return 0

    def _counter_get(self, tx: KVTxn, name: str) -> int:
        raw = tx.get(self._counter_key(name))
        return int.from_bytes(raw, "big", signed=True) if raw else 0

    @staticmethod
    def _sticky_violation(pattr: Attr, attr: Attr, ctx: Context) -> bool:
        return (
            ctx.check_permission
            and ctx.uid != 0
            and pattr.mode & 0o1000 != 0
            and ctx.uid != pattr.uid
            and ctx.uid != attr.uid
        )

    # ---- lifecycle -------------------------------------------------------
    def do_init(self, fmt: Format, force: bool) -> int:
        def fn(tx: KVTxn):
            old = tx.get(b"setting")
            if old is not None and not force:
                prev = Format.from_json(old)
                if prev.name != fmt.name:
                    raise RuntimeError(
                        f"volume already formatted as {prev.name}; use force to overwrite"
                    )
            tx.set(b"setting", fmt.to_json().encode())
            if self._get_attr(tx, ROOT_INODE) is None:
                now = time.time()
                root = Attr(typ=TYPE_DIRECTORY, mode=0o777, nlink=2, length=4096)
                root.parent = ROOT_INODE
                root.touch_mtime(now)
                root.touch_atime(now)
                self._set_attr(tx, ROOT_INODE, root)
                trash = Attr(typ=TYPE_DIRECTORY, mode=0o555, nlink=2, length=4096)
                trash.parent = TRASH_INODE
                trash.touch_mtime(now)
                self._set_attr(tx, TRASH_INODE, trash)
                tx.set(self._counter_key("nextInode"), (2).to_bytes(8, "big", signed=True))
                tx.set(self._counter_key("nextSlice"), (1).to_bytes(8, "big", signed=True))
            return 0

        self.client.txn(fn)
        self.fmt = fmt
        return 0

    def do_load(self) -> Optional[bytes]:
        return self.client.txn(lambda tx: tx.get(b"setting"))

    def do_reset(self) -> None:
        self.client.reset()

    def do_new_inodes(self, n: int) -> int:
        end = self.client.txn(lambda tx: tx.incr_by(self._counter_key("nextInode"), n))
        return end - n

    def do_new_slices(self, n: int) -> int:
        end = self.client.txn(lambda tx: tx.incr_by(self._counter_key("nextSlice"), n))
        return end - n

    def do_counter(self, name: str, delta: int = 0) -> int:
        if delta:
            return self.client.txn(lambda tx: tx.incr_by(self._counter_key(name), delta))
        return self.client.txn(lambda tx: self._counter_get(tx, name))

    # ---- sessions --------------------------------------------------------
    def do_new_session(self, info: Session) -> int:
        def fn(tx: KVTxn):
            sid = tx.incr_by(self._counter_key("nextSession"), 1)
            info.sid = sid
            tx.set(self._session_key(sid), info.to_json().encode())
            tx.set(self._heartbeat_key(sid), _F64.pack(time.time()))
            return sid

        return self.client.txn(fn)  # returns sid, not errno: no _etxn

    def do_refresh_session(self, sid: int) -> None:
        self.client.txn(lambda tx: tx.set(self._heartbeat_key(sid), _F64.pack(time.time())))

    def do_update_session(self, sid: int, info: Session) -> None:
        self.client.txn(lambda tx: tx.set(
            self._session_key(sid), info.to_json().encode()))

    def do_session_exists(self, sid: int) -> bool:
        return self.client.simple_txn(
            lambda tx: tx.get(self._session_key(sid)) is not None)

    # -- meta fault contract hooks ------------------------------
    def replica_available(self) -> bool:
        return getattr(self.client, "replica_host", None) is not None

    def engine_heal(self) -> None:
        """Breaker heal: re-prime the replica-read epoch floor from the
        healed primary — a replica still re-SYNCing holds pre-outage
        state at a pre-outage epoch, and a stale floor would let it pass
        the lag guard and serve that state as fresh."""
        heal = getattr(self.client, "on_primary_heal", None)
        if heal is not None:
            heal()

    def do_clean_session(self, sid: int) -> None:
        """Release a session: reclaim sustained inodes, drop its locks
        (reference base.go:504 CleanStaleSessions / doCleanStaleSession)."""
        prefix = b"SS" + sid.to_bytes(8, "big")
        sustained = [
            int.from_bytes(k[len(prefix):], "big") for k, _ in self.client.scan(prefix, next_key(prefix))
        ]
        for ino in sustained:
            self.do_delete_sustained(sid, ino)

        def fn(tx: KVTxn):
            tx.delete(self._session_key(sid))
            tx.delete(self._heartbeat_key(sid))
            return 0

        self.client.txn(fn)
        # drop this session's locks
        for kind in (b"F", b"L"):
            for k, v in list(self.client.scan(kind, next_key(kind))):
                if len(k) != 9:
                    continue
                try:
                    table = json.loads(v)
                except ValueError:
                    continue
                if isinstance(table, dict):  # flock: {"sid/owner": type}
                    keep = {o: r for o, r in table.items() if not o.startswith(f"{sid}/")}
                    changed = len(keep) != len(table)
                else:  # plock: [[sid, owner, ltype, start, end, pid], ...]
                    keep = [l for l in table if l[0] != sid]
                    changed = len(keep) != len(table)
                if changed:
                    self.client.txn(
                        lambda tx, k=k, keep=keep: tx.set(k, json.dumps(keep).encode())
                        if keep
                        else tx.delete(k)
                    )

    def do_list_sessions(self) -> list[Session]:
        # heartbeats ride along so consumers (status, cache-group peer
        # discovery) can judge liveness: expire = last beat + stale age
        beats = {
            int.from_bytes(k[2:], "big"): _F64.unpack(v)[0]
            for k, v in self.client.scan(b"SH", next_key(b"SH"))
            if len(k) == 10
        }
        out = []
        for _, v in self.client.scan(b"SE", next_key(b"SE")):
            try:
                s = Session.from_json(v)
            except ValueError:
                continue
            if s.sid in beats:
                s.expire = beats[s.sid] + SESSION_STALE_AGE
            out.append(s)
        return out

    def clean_stale_sessions(self, age: float = SESSION_STALE_AGE) -> int:
        """GC sessions whose heartbeat is older than `age` seconds."""
        cleaned = 0
        now = time.time()
        for k, v in list(self.client.scan(b"SH", next_key(b"SH"))):
            if len(k) == 10 and now - _F64.unpack(v)[0] > age:
                self.do_clean_session(int.from_bytes(k[2:], "big"))
                cleaned += 1
        return cleaned

    def do_delete_sustained(self, sid: int, ino: int) -> None:
        # usedSpace/totalInodes were already decremented when the file was
        # unlinked into the sustained set; only the data reclaim is deferred.
        def fn(tx: KVTxn):
            tx.delete(self._sustained_key(sid, ino))
            attr = self._get_attr(tx, ino)
            if attr is not None and attr.nlink == 0:
                tx.delete(self._attr_key(ino))
                tx.set(self._delfile_key(ino, attr.length), _F64.pack(time.time()))
            return 0

        self.client.txn(fn)

    # ---- attrs -----------------------------------------------------------
    def do_getattr(self, ino: int) -> tuple[int, Attr]:
        attr = self.client.simple_txn(lambda tx: self._get_attr(tx, ino))
        if attr is None:
            return errno.ENOENT, Attr()
        return 0, attr

    def do_setattr(self, ctx: Context, ino: int, flags: int, new: Attr) -> tuple[int, Attr]:
        interned: list = []  # chmod-derived ACL internings (post-commit)

        def fn(tx: KVTxn):
            interned.clear()
            attr = self._get_attr(tx, ino)
            if attr is None:
                return errno.ENOENT, Attr()
            now = time.time()
            changed = False
            if flags & SET_ATTR_MODE:
                mode = new.mode & 0o7777
                if ctx.uid != 0 and ctx.uid != attr.uid and ctx.check_permission:
                    return errno.EPERM, Attr()
                # non-member setgid clear (POSIX)
                if ctx.uid != 0 and not ctx.contains_gid(attr.gid) and ctx.check_permission:
                    mode &= ~0o2000
                if attr.access_acl != acl_mod.ACL_NONE:
                    # chmod with an ACL: group-class bits become the mask
                    # (reference tkv.go doSetAttr + acl.go SetMode)
                    from dataclasses import replace as _rep

                    rule = self._load_acl(tx, attr.access_acl)
                    if rule is not None:
                        rule = _rep(rule)
                        rule.set_mode(mode)
                        attr.access_acl = self._insert_acl(tx, rule)
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
                self._set_attr(tx, ino, attr)
            return 0, attr

        out = self._etxn(fn)
        if out[0] == 0:
            for aid, r in interned:
                self._acl_publish(aid, r)
        return out

    # ---- namespace -------------------------------------------------------
    def do_lookup(self, parent: int, name: bytes, hint_ino: int = 0) -> tuple[int, int, Attr]:
        # One batched read covers the whole uncached lookup: dentry +
        # parent attr (needed anyway to classify a miss) + — when the
        # lease cache supplies a last-known child — the SPECULATIVE child
        # attr, revalidated against the live entry. On a networked engine
        # (redis) tx.gets is ONE round trip, so a warm-but-expired lookup
        # costs 1 RTT instead of 3.
        def fn(tx: KVTxn):
            keys = [self._entry_key(parent, name), self._attr_key(parent)]
            if hint_ino:
                keys.append(self._attr_key(hint_ino))
            raws = tx.gets(*keys)
            eraw = raws[0]
            if not eraw:
                praw = raws[1]
                if praw is None:
                    return errno.ENOENT, 0, Attr()
                if Attr.decode(praw).typ != TYPE_DIRECTORY:
                    return errno.ENOTDIR, 0, Attr()
                return errno.ENOENT, 0, Attr()
            typ, ino = eraw[0], int.from_bytes(eraw[1:9], "big")
            if hint_ino and ino == hint_ino and raws[2] is not None:
                return 0, ino, Attr.decode(raws[2])
            attr = self._get_attr(tx, ino)
            if attr is None:
                # dangling entry: report with partial attr (reference tkv.go Lookup)
                return 0, ino, Attr(typ=typ, full=False)
            return 0, ino, attr

        return self.client.simple_txn(fn)

    def do_mknod(self, ctx, parent, name, typ, mode, cumask, rdev, path,
                 ino: int = 0) -> tuple[int, int, Attr]:
        # ino != 0: the write batcher's preallocated id — the
        # deferred commit must create the inode the client already uses
        ino = ino or self.new_inode()
        interned: list = []  # inherited-ACL internings, published post-commit

        def fn(tx: KVTxn):
            interned.clear()
            pattr = self._get_attr(tx, parent)
            if pattr is None:
                return errno.ENOENT, 0, Attr()
            if pattr.typ != TYPE_DIRECTORY:
                return errno.ENOTDIR, 0, Attr()
            if pattr.flags & FLAG_IMMUTABLE:
                return errno.EPERM, 0, Attr()
            etyp, _ = self._get_entry(tx, parent, name)
            if etyp:
                return errno.EEXIST, 0, Attr()
            # initial space: dir 4096, symlink its aligned target length
            # (unlink releases _align4k(length) — charges must be symmetric),
            # file 0 (growth is charged by write/truncate deltas)
            if typ == TYPE_DIRECTORY:
                ispace = 4096
            elif typ == TYPE_SYMLINK:
                ispace = _align4k(len(path))
            else:
                ispace = 0
            st = self._update_used(tx, ispace, 1)
            if st:
                return st, 0, Attr()
            st = self._quota_check(tx, parent, ispace, 1)
            if st:
                return st, 0, Attr()
            now = time.time()
            # default-ACL inheritance (reference tkv.go:1136-1162): when the
            # parent carries a default ACL, the umask is ignored (POSIX) and
            # the child's access ACL/mode derive from the default rule
            req_mode = mode & 0o7777
            child_access = acl_mod.ACL_NONE
            child_default = acl_mod.ACL_NONE
            if pattr.default_acl != acl_mod.ACL_NONE and typ != TYPE_SYMLINK:
                if typ == TYPE_DIRECTORY:
                    child_default = pattr.default_acl
                drule = self._load_acl(tx, pattr.default_acl)
                if drule is None:
                    eff_mode = req_mode & ~cumask
                elif drule.is_minimal():
                    eff_mode = req_mode & (0o7000 | drule.get_mode())
                else:
                    crule = drule.child_access_acl(req_mode)
                    child_access = self._insert_acl(tx, crule)
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
                tx.set(self._symlink_key(ino), path)
            attr.parent = parent
            # setgid dir: children inherit gid (and dirs inherit setgid)
            if pattr.mode & 0o2000:
                attr.gid = pattr.gid
                if typ == TYPE_DIRECTORY:
                    attr.mode |= 0o2000
            attr.touch_atime(now)
            attr.touch_mtime(now)
            self._set_attr(tx, ino, attr)
            self._set_entry(tx, parent, name, typ, ino)
            if typ == TYPE_DIRECTORY:
                pattr.nlink += 1
            pattr.touch_mtime(now)
            self._set_attr(tx, parent, pattr)
            self._update_dirstat(
                tx, parent, attr.length if typ != TYPE_DIRECTORY else 0, ispace, 1
            )
            return 0, ino, attr

        out = self._etxn(fn)
        if out[0] == 0:
            for aid, r in interned:
                self._acl_publish(aid, r)
        return out

    def _trash_entry(self, tx: KVTxn, parent: int, name: bytes, ino: int, typ: int) -> None:
        """Move a doomed entry under the hourly trash dir
        (reference base.go trash handling: entries renamed {parent}-{ino}-{name}).

        Hour-dir inodes are deterministic (TRASH_INODE + 1 + hours since
        epoch): no id allocation inside the transaction, and every trash
        directory sorts >= TRASH_INODE so `parent < TRASH_INODE` reliably
        detects "not already in trash"."""
        now = time.time()
        hname = time.strftime("%Y-%m-%d-%H", time.gmtime(now)).encode()
        hino = TRASH_INODE + 1 + int(now // 3600)
        if self._get_attr(tx, hino) is None:
            hattr = Attr(typ=TYPE_DIRECTORY, mode=0o555, nlink=2, length=4096, parent=TRASH_INODE)
            hattr.touch_mtime(now)
            self._set_attr(tx, hino, hattr)
            self._set_entry(tx, TRASH_INODE, hname, TYPE_DIRECTORY, hino)
        tname = f"{parent}-{ino}-".encode() + name
        self._set_entry(tx, hino, tname[:250], typ, ino)
        attr = self._get_attr(tx, ino)
        if attr is not None:
            attr.parent = hino
            attr.touch_ctime(now)
            self._set_attr(tx, ino, attr)

    def do_unlink(self, ctx, parent, name, skip_trash=False) -> tuple[int, int]:
        trash = self.fmt.trash_days > 0 and not skip_trash and parent < TRASH_INODE
        victim = [0]  # resolved inside the txn: races with a concurrent
        # rename-onto-name cannot desync it from the deleted entry

        def fn(tx: KVTxn):
            typ, ino = self._get_entry(tx, parent, name)
            if ino == 0:
                return errno.ENOENT
            victim[0] = ino
            if typ == TYPE_DIRECTORY:
                return errno.EISDIR
            pattr = self._get_attr(tx, parent)
            attr = self._get_attr(tx, ino)
            if pattr is None:
                return errno.ENOENT
            if attr is not None and self._sticky_violation(pattr, attr, ctx):
                return errno.EACCES
            if attr is not None and attr.flags & (FLAG_IMMUTABLE | FLAG_APPEND):
                return errno.EPERM
            now = time.time()
            tx.delete(self._entry_key(parent, name))
            pattr.touch_mtime(now)
            self._set_attr(tx, parent, pattr)
            if attr is None:  # dangling entry
                return 0
            if trash and attr.nlink == 1:
                # _trash_entry re-reads, re-parents, and writes the attr itself
                self._trash_entry(tx, parent, name, ino, typ)
                self._update_dirstat(tx, parent, -attr.length, -_align4k(attr.length), -1)
                return 0
            attr.nlink -= 1
            attr.touch_ctime(now)
            if attr.parent == 0:
                # multi-parent tracking: drop one link from this parent
                pk = self._parent_key(ino, parent)
                raw_pk = tx.get(pk)
                cnt = _U32.unpack(raw_pk)[0] if raw_pk else 1
                if cnt > 1:
                    tx.set(pk, _U32.pack(cnt - 1))
                else:
                    tx.delete(pk)
            self._update_dirstat(tx, parent, -attr.length, -_align4k(attr.length), -1)
            if attr.nlink > 0:
                self._set_attr(tx, ino, attr)
                return 0
            # last link gone
            if typ == TYPE_FILE and self.of.is_open(ino) and self.sid:
                attr.parent = 0
                self._set_attr(tx, ino, attr)
                tx.set(self._sustained_key(self.sid, ino), b"1")
                self._update_used(tx, -_align4k(attr.length), -1)
                return 0
            tx.delete(self._attr_key(ino))
            if typ == TYPE_FILE and attr.length > 0:
                tx.set(self._delfile_key(ino, attr.length), _F64.pack(now))
            elif typ == TYPE_SYMLINK:
                tx.delete(self._symlink_key(ino))
            for k in tx.scan_keys(self._ino_key(ino) + b"X"):
                tx.delete(k)
            for k in tx.scan_keys(self._ino_key(ino) + b"P"):
                tx.delete(k)
            self._update_used(tx, -_align4k(attr.length), -1)
            return 0

        st = self._etxn(fn)
        return st, victim[0] if st == 0 else 0

    def do_rmdir(self, ctx, parent, name, skip_trash=False) -> int:
        trash = self.fmt.trash_days > 0 and not skip_trash and parent < TRASH_INODE

        def fn(tx: KVTxn):
            typ, ino = self._get_entry(tx, parent, name)
            if ino == 0:
                return errno.ENOENT
            if typ != TYPE_DIRECTORY:
                return errno.ENOTDIR
            if tx.exists(self._ino_key(ino) + b"D"):
                return errno.ENOTEMPTY
            pattr = self._get_attr(tx, parent)
            attr = self._get_attr(tx, ino)
            if pattr is None:
                return errno.ENOENT
            if attr is not None and self._sticky_violation(pattr, attr, ctx):
                return errno.EACCES
            now = time.time()
            tx.delete(self._entry_key(parent, name))
            pattr.nlink -= 1
            pattr.touch_mtime(now)
            self._set_attr(tx, parent, pattr)
            self._update_dirstat(tx, parent, 0, -4096, -1)
            if attr is None:
                return 0
            if trash:
                self._trash_entry(tx, parent, name, ino, typ)
                return 0
            tx.delete(self._attr_key(ino))
            tx.delete(self._dirstat_key(ino))
            tx.delete(self._dirquota_key(ino))
            for k in tx.scan_keys(self._ino_key(ino) + b"X"):
                tx.delete(k)
            self._update_used(tx, -4096, -1)
            return 0

        return self._etxn(fn)

    def do_rename(self, ctx, psrc, nsrc, pdst, ndst, flags) -> tuple[int, int, Attr]:
        if flags & ~(RENAME_NOREPLACE | RENAME_EXCHANGE):
            return errno.ENOTSUP, 0, Attr()
        victim = [0]  # replaced/exchanged destination, resolved in-txn

        def fn(tx: KVTxn):
            styp, sino = self._get_entry(tx, psrc, nsrc)
            if sino == 0:
                return errno.ENOENT, 0, Attr()
            if psrc == pdst and nsrc == ndst:
                attr = self._get_attr(tx, sino)
                return 0, sino, attr or Attr()
            sattr = self._get_attr(tx, sino)
            spattr = self._get_attr(tx, psrc)
            dpattr = self._get_attr(tx, pdst)
            if spattr is None or dpattr is None or sattr is None:
                return errno.ENOENT, 0, Attr()
            if dpattr.typ != TYPE_DIRECTORY:
                return errno.ENOTDIR, 0, Attr()
            if self._sticky_violation(spattr, sattr, ctx):
                return errno.EACCES, 0, Attr()
            # moving a directory into its own subtree is forbidden
            if (styp == TYPE_DIRECTORY and psrc != pdst
                    and self._is_ancestor(lambda i: self._get_attr(tx, i),
                                          sino, pdst)):
                return errno.EINVAL, 0, Attr()
            dtyp, dino = self._get_entry(tx, pdst, ndst)
            victim[0] = dino if dino != sino else 0
            # the mirrored cycle: exchanging puts the DESTINATION dir
            # under psrc, so dino must not be an ancestor of psrc either
            # (kernel: EINVAL), or it becomes its own child
            if (flags & RENAME_EXCHANGE and dino and dtyp == TYPE_DIRECTORY
                    and psrc != pdst
                    and self._is_ancestor(lambda i: self._get_attr(tx, i),
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
            # Cross-directory moves shift usage between quota trees: measure
            # the moved subtree; the EDQUOT check runs below once a replaced
            # destination's credit is known (errno discards the txn).
            squota = dquota = None
            move_space = move_inodes = 0
            if psrc != pdst:
                squota = self._quota_roots(tx, psrc)
                dquota = self._quota_roots(tx, pdst)
                if squota != dquota and not flags & RENAME_EXCHANGE:
                    # identical chains see no net change: skip the subtree
                    # walk and the no-op transfer entirely
                    if styp == TYPE_DIRECTORY:
                        move_space, move_inodes = self._tree_usage(tx, sino)
                    else:
                        move_space, move_inodes = _align4k(sattr.length), 1
            if flags & RENAME_EXCHANGE:
                if dino == 0:
                    return errno.ENOENT, 0, Attr()
                dattr = self._get_attr(tx, dino)
                if dattr is None:
                    return errno.ENOENT, 0, Attr()
                s_direct = _direct_space(sattr)
                d_direct = _direct_space(dattr)
                if psrc != pdst and squota != dquota:
                    s_space, s_inodes = (
                        self._tree_usage(tx, sino)
                        if styp == TYPE_DIRECTORY
                        else (s_direct, 1)
                    )
                    d_space, d_inodes = (
                        self._tree_usage(tx, dino)
                        if dtyp == TYPE_DIRECTORY
                        else (d_direct, 1)
                    )
                    st = self._quota_check_roots(
                        tx, dquota - squota, s_space - d_space, s_inodes - d_inodes
                    ) or self._quota_check_roots(
                        tx, squota - dquota, d_space - s_space, d_inodes - s_inodes
                    )
                    if st:
                        return st, 0, Attr()
                self._set_entry(tx, psrc, nsrc, dtyp, dino)
                self._set_entry(tx, pdst, ndst, styp, sino)
                sattr.parent, dattr.parent = pdst, psrc
                sattr.touch_ctime(now)
                dattr.touch_ctime(now)
                self._set_attr(tx, sino, sattr)
                self._set_attr(tx, dino, dattr)
                if psrc != pdst and styp != dtyp:
                    if styp == TYPE_DIRECTORY:
                        spattr.nlink -= 1
                        dpattr.nlink += 1
                    if dtyp == TYPE_DIRECTORY:
                        spattr.nlink += 1
                        dpattr.nlink -= 1
                spattr.touch_mtime(now)
                self._set_attr(tx, psrc, spattr)
                if psrc != pdst:
                    dpattr.touch_mtime(now)
                    self._set_attr(tx, pdst, dpattr)
                    ssz = _direct_len(sattr)
                    dsz = _direct_len(dattr)
                    self._update_dirstat(tx, psrc, dsz - ssz, d_direct - s_direct, 0)
                    self._update_dirstat(tx, pdst, ssz - dsz, s_direct - d_direct, 0)
                    if squota != dquota:
                        # subtrees below the swapped roots are invisible to
                        # the dirstat delta; transfer them explicitly
                        extra_s = (d_space - d_direct) - (s_space - s_direct)
                        extra_i = d_inodes - s_inodes
                        if extra_s or extra_i:
                            self._quota_update(tx, psrc, extra_s, extra_i)
                            self._quota_update(tx, pdst, -extra_s, -extra_i)
                return 0, sino, sattr
            if dino:
                dattr = self._get_attr(tx, dino)
                if dtyp == TYPE_DIRECTORY:
                    if styp != TYPE_DIRECTORY:
                        return errno.EISDIR, 0, Attr()
                    if tx.exists(self._ino_key(dino) + b"D"):
                        return errno.ENOTEMPTY, 0, Attr()
                elif styp == TYPE_DIRECTORY:
                    return errno.ENOTDIR, 0, Attr()
                if dattr is not None and self._sticky_violation(dpattr, dattr, ctx):
                    return errno.EACCES, 0, Attr()
                # replace: dst loses its entry (goes to trash / delfiles)
                st = self._free_entry(tx, pdst, ndst, dtyp, dino, dattr, now)
                if st:
                    return st, 0, Attr()
            if psrc != pdst and squota != dquota:
                # checked AFTER _free_entry: a replaced destination already
                # released its usage in this txn, so a net-zero replace
                # never EDQUOTs (errno returns discard the txn)
                st = self._quota_check_roots(
                    tx, dquota - squota, move_space, move_inodes
                )
                if st:
                    return st, 0, Attr()
            tx.delete(self._entry_key(psrc, nsrc))
            self._set_entry(tx, pdst, ndst, styp, sino)
            if sattr.parent:
                sattr.parent = pdst
            else:
                tx.delete(self._parent_key(sino, psrc))
                pk = self._parent_key(sino, pdst)
                old = tx.get(pk)
                tx.set(pk, _U32.pack((_U32.unpack(old)[0] if old else 0) + 1))
            sattr.touch_ctime(now)
            self._set_attr(tx, sino, sattr)
            if styp == TYPE_DIRECTORY and psrc != pdst:
                spattr.nlink -= 1
                dpattr.nlink += 1
            spattr.touch_mtime(now)
            self._set_attr(tx, psrc, spattr)
            if psrc != pdst:
                dpattr.touch_mtime(now)
                self._set_attr(tx, pdst, dpattr)
            dsz = _direct_len(sattr)
            dspace = _direct_space(sattr)
            self._update_dirstat(tx, psrc, -dsz, -dspace, -1)
            self._update_dirstat(tx, pdst, dsz, dspace, 1)
            if styp == TYPE_DIRECTORY and psrc != pdst and squota != dquota:
                # the subtree below the moved dir is invisible to the
                # dirstat delta; transfer it between the quota chains
                extra_s, extra_i = move_space - 4096, move_inodes - 1
                if extra_s or extra_i:
                    self._quota_update(tx, psrc, -extra_s, -extra_i)
                    self._quota_update(tx, pdst, extra_s, extra_i)
            return 0, sino, sattr

        st, ino, attr = self._etxn(fn)
        if st == 0 and victim[0]:
            # the destination's nlink/ctime changed (decref on replace,
            # reparent on exchange): evict its open-file cached attr
            self.of.invalidate(victim[0])
        return st, ino, attr

    def _free_entry(self, tx: KVTxn, parent: int, name: bytes, typ: int, ino: int, attr, now) -> int:
        """Drop the entry at (parent, name) whose inode is being replaced."""
        trash = self.fmt.trash_days > 0 and parent < TRASH_INODE
        tx.delete(self._entry_key(parent, name))
        if attr is None:
            return 0
        if trash and (typ == TYPE_DIRECTORY or attr.nlink == 1):
            self._trash_entry(tx, parent, name, ino, typ)
            self._update_dirstat(
                tx, parent, -(attr.length if typ == TYPE_FILE else 0),
                -(_align4k(attr.length) if typ == TYPE_FILE else 4096), -1,
            )
            return 0
        if typ == TYPE_DIRECTORY:
            tx.delete(self._attr_key(ino))
            tx.delete(self._dirstat_key(ino))
            self._update_used(tx, -4096, -1)
            self._update_dirstat(tx, parent, 0, -4096, -1)
            return 0
        attr.nlink -= 1
        attr.touch_ctime(now)
        self._update_dirstat(tx, parent, -attr.length, -_align4k(attr.length), -1)
        if attr.nlink > 0:
            self._set_attr(tx, ino, attr)
        else:
            if typ == TYPE_FILE and self.of.is_open(ino) and self.sid:
                attr.parent = 0
                self._set_attr(tx, ino, attr)
                tx.set(self._sustained_key(self.sid, ino), b"1")
            else:
                tx.delete(self._attr_key(ino))
                if typ == TYPE_FILE and attr.length > 0:
                    tx.set(self._delfile_key(ino, attr.length), _F64.pack(now))
                elif typ == TYPE_SYMLINK:
                    tx.delete(self._symlink_key(ino))
            self._update_used(tx, -_align4k(attr.length), -1)
        return 0

    def do_link(self, ctx, ino, parent, name) -> tuple[int, Attr]:
        def fn(tx: KVTxn):
            attr = self._get_attr(tx, ino)
            if attr is None:
                return errno.ENOENT, Attr()
            # an existing destination wins over EPERM-class refusals
            # (kernel linkat checks newpath existence first)
            etyp, _ = self._get_entry(tx, parent, name)
            if etyp:
                return errno.EEXIST, Attr()
            if attr.typ == TYPE_DIRECTORY:
                return errno.EPERM, Attr()
            if attr.flags & FLAG_IMMUTABLE:
                return errno.EPERM, Attr()
            pattr = self._get_attr(tx, parent)
            if pattr is None:
                return errno.ENOENT, Attr()
            if pattr.typ != TYPE_DIRECTORY:
                return errno.ENOTDIR, Attr()
            now = time.time()
            if attr.parent and attr.parent != parent:
                # becomes multi-parent: track parents out-of-band
                pk_old = self._parent_key(ino, attr.parent)
                tx.set(pk_old, _U32.pack(1))
                attr.parent = 0
            if attr.parent == 0:
                pk = self._parent_key(ino, parent)
                old = tx.get(pk)
                tx.set(pk, _U32.pack((_U32.unpack(old)[0] if old else 0) + 1))
            attr.nlink += 1
            attr.touch_ctime(now)
            self._set_attr(tx, ino, attr)
            self._set_entry(tx, parent, name, attr.typ, ino)
            pattr.touch_mtime(now)
            self._set_attr(tx, parent, pattr)
            self._update_dirstat(tx, parent, attr.length, _align4k(attr.length), 1)
            return 0, attr

        return self._etxn(fn)

    def do_readdir(self, ctx, ino, want_attr) -> tuple[int, list[Entry]]:
        def fn(tx: KVTxn):
            attr = self._get_attr(tx, ino)
            if attr is None:
                return errno.ENOENT, []
            if attr.typ != TYPE_DIRECTORY:
                return errno.ENOTDIR, []
            entries = self._scan_entries(tx, ino)
            if want_attr:
                # batch the attr fetches: one round trip / statement per
                # directory instead of one per entry (first-listing
                # readdirplus cost)
                raws = tx.gets(*(self._attr_key(c) for _, _, c in entries))
            out = []
            for i, (name, typ, cino) in enumerate(entries):
                if want_attr:
                    raw = raws[i]
                    cattr = Attr.decode(raw) if raw else Attr(typ=typ, full=False)
                else:
                    cattr = Attr(typ=typ, full=False)
                out.append(Entry(inode=cino, name=name, attr=cattr))
            return 0, out

        return self.client.simple_txn(fn)

    def do_readlink(self, ino) -> tuple[int, bytes]:
        raw = self.client.simple_txn(lambda tx: tx.get(self._symlink_key(ino)))
        if raw is None:
            return errno.EINVAL, b""
        return 0, raw

    def get_parents(self, ino: int) -> dict[int, int]:
        """parent-ino -> link count (reference base.go GetParents)."""
        st, attr = self.do_getattr(ino)
        if st:
            return {}
        if attr.parent:
            return {attr.parent: 1}
        prefix = self._ino_key(ino) + b"P"
        return {
            int.from_bytes(k[len(prefix):], "big"): _U32.unpack(v)[0]
            for k, v in self.client.scan(prefix, next_key(prefix))
        }

    # ---- file data -------------------------------------------------------
    def do_read_chunk(self, ino, indx) -> tuple[int, list[Slice]]:
        raw = self.client.simple_txn(lambda tx: tx.get(self._chunk_key(ino, indx)))
        if raw is None:
            return 0, []
        return 0, Slice.decode_list(raw)

    def do_read_chunks(self, ino, indxs) -> list[tuple[int, list[Slice]]]:
        """Readahead-planner batch: every chunk of the window
        in ONE MGET txn — on a networked/replica engine that is one round
        trip instead of len(indxs)."""
        keys = [self._chunk_key(ino, i) for i in indxs]
        raws = self.client.simple_txn(lambda tx: tx.gets(*keys))
        return [(0, Slice.decode_list(raw) if raw else []) for raw in raws]

    def do_compact_chunk(self, ino: int, indx: int, snapshot: bytes, new_slice: Slice) -> int:
        """Replace the compacted prefix of a chunk's slice list with one
        merged slice (reference base.go:2009 compactChunk txn). `snapshot`
        is the encoded slice list the merged data was built from; slices
        appended concurrently stay, anything else means a conflicting
        compaction already won (EINVAL -> caller discards its work)."""

        def fn(tx: KVTxn):
            key = self._chunk_key(ino, indx)
            raw = tx.get(key) or b""
            if not raw.startswith(snapshot):
                return errno.EINVAL
            tail = raw[len(snapshot):]
            tx.set(key, new_slice.encode() + tail)
            for s in Slice.decode_list(snapshot):
                if s.id:
                    self._decref_slice(tx, s.id, s.size)
            return 0

        st = self._txn_notify(fn)
        if st == 0:
            self.of.invalidate_chunk(ino, indx)
        return st

    def do_write_chunk(self, ino, indx, pos, slc: Slice, length_hint: int, incref: bool = False) -> int:
        def fn(tx: KVTxn):
            attr = self._get_attr(tx, ino)
            if attr is None:
                return errno.ENOENT
            if attr.typ != TYPE_FILE:
                return errno.EPERM
            now = time.time()
            if length_hint > attr.length:
                delta = _align4k(length_hint) - _align4k(attr.length)
                if delta > 0:
                    st = self._update_used(tx, delta, 0)
                    if st:
                        return st
                    if attr.parent:
                        st = self._quota_check(tx, attr.parent, delta, 0)
                        if st:
                            return st
                if attr.parent:
                    self._update_dirstat(tx, attr.parent, length_hint - attr.length, delta, 0)
                attr.length = length_hint
            if incref and slc.id:
                # sharing an existing slice (copy_file_range/clone): bump
                # refs — after the quota/space checks so a rejected write
                # leaves no stray reference
                self._incref_slice(tx, slc.id, slc.size)
            attr.touch_mtime(now)
            self._set_attr(tx, ino, attr)
            data = tx.append(self._chunk_key(ino, indx), slc.encode())
            if len(data) // Slice.ENCODED_LEN > 100:
                self._queue_notify(interface.COMPACT_CHUNK, ino, indx)
            return 0

        return self._txn_notify(fn)

    def do_truncate(self, ctx, ino, length) -> tuple[int, Attr]:
        def fn(tx: KVTxn):
            attr = self._get_attr(tx, ino)
            if attr is None:
                return errno.ENOENT, Attr()
            if attr.typ != TYPE_FILE:
                return errno.EPERM, Attr()
            if attr.flags & (FLAG_IMMUTABLE | FLAG_APPEND):
                return errno.EPERM, Attr()
            old = attr.length
            delta = _align4k(length) - _align4k(old)
            if delta > 0:
                st = self._update_used(tx, delta, 0)
                if st:
                    return st, Attr()
                if attr.parent:
                    st = self._quota_check(tx, attr.parent, delta, 0)
                    if st:
                        return st, Attr()
            elif delta < 0:
                self._update_used(tx, delta, 0)
            if attr.parent:
                self._update_dirstat(tx, attr.parent, length - old, delta, 0)
            attr.length = length
            attr.touch_mtime(time.time())
            self._set_attr(tx, ino, attr)
            if length < old:
                # drop whole chunks beyond the new end
                first_dead = (length + CHUNK_SIZE - 1) // CHUNK_SIZE
                last = old // CHUNK_SIZE
                for i in range(first_dead, last + 1):
                    key = self._chunk_key(ino, i)
                    raw = tx.get(key)
                    if raw:
                        for s in Slice.decode_list(raw):
                            if s.id:
                                self._decref_slice(tx, s.id, s.size)
                        tx.delete(key)
                # boundary chunk: shadow the truncated tail with a hole so a
                # later grow reads zeros, not resurrected data (POSIX)
                bpos = length % CHUNK_SIZE
                if bpos:
                    bindx = length // CHUNK_SIZE
                    tail = min(old - bindx * CHUNK_SIZE, CHUNK_SIZE) - bpos
                    if tail > 0 and tx.get(self._chunk_key(ino, bindx)):
                        hole = Slice(pos=bpos, id=0, size=tail, off=0, len=tail)
                        tx.append(self._chunk_key(ino, bindx), hole.encode())
            return 0, attr

        return self._txn_notify(fn)

    def do_fallocate(self, ctx, ino, mode, off, size) -> int:
        FALLOC_KEEP_SIZE, FALLOC_PUNCH_HOLE, FALLOC_ZERO_RANGE = 0x1, 0x2, 0x10

        def fn(tx: KVTxn):
            attr = self._get_attr(tx, ino)
            if attr is None:
                return errno.ENOENT
            if attr.typ != TYPE_FILE:
                return errno.EPERM
            length = attr.length
            if not mode & FALLOC_KEEP_SIZE and off + size > length:
                delta = _align4k(off + size) - _align4k(length)
                if delta > 0:
                    st = self._update_used(tx, delta, 0)
                    if st:
                        return st
                    if attr.parent:
                        st = self._quota_check(tx, attr.parent, delta, 0)
                        if st:
                            return st
                if attr.parent:
                    self._update_dirstat(tx, attr.parent, off + size - length, max(delta, 0), 0)
                attr.length = off + size
            if mode & (FALLOC_PUNCH_HOLE | FALLOC_ZERO_RANGE):
                end = min(off + size, attr.length)
                cur = off
                while cur < end:
                    indx = cur // CHUNK_SIZE
                    pos = cur % CHUNK_SIZE
                    n = min(CHUNK_SIZE - pos, end - cur)
                    hole = Slice(pos=pos, id=0, size=n, off=0, len=n)
                    tx.append(self._chunk_key(ino, indx), hole.encode())
                    cur += n
            attr.touch_mtime(time.time())
            self._set_attr(tx, ino, attr)
            return 0

        return self._etxn(fn)

    def _incref_slice(self, tx: KVTxn, sid: int, size: int) -> None:
        """Add one reference to a stored slice (reference tkv.go sliceRef:
        stored value == refcount-1, absent == 1)."""
        key = self._sliceref_key(sid, size)
        raw = tx.get(key)
        cnt = _I64.unpack(raw)[0] if raw else 0
        tx.set(key, _I64.pack(cnt + 1))

    def _decref_slice(self, tx: KVTxn, sid: int, size: int) -> None:
        """Decrement a slice refcount; schedule block deletion at zero
        (reference tkv.go sliceRef: stored value == refcount-1)."""
        key = self._sliceref_key(sid, size)
        raw = tx.get(key)
        cnt = _I64.unpack(raw)[0] if raw else 0
        cnt -= 1
        if cnt < 0:
            tx.delete(key)
            self._queue_notify(interface.DELETE_SLICE, sid, size)
        else:
            tx.set(key, _I64.pack(cnt))

    def do_find_deleted_files(self, limit: int) -> dict[int, int]:
        out: dict[int, int] = {}
        for k, _ in self.client.scan(b"D", next_key(b"D")):
            if len(k) == 17:
                out[int.from_bytes(k[1:9], "big")] = int.from_bytes(k[9:17], "big")
                if len(out) >= limit:
                    break
        return out

    def do_delete_file_data(self, ino: int, length: int) -> None:
        """Reclaim all slices of a deleted file (reference base.go
        doDeleteFileData): decref every slice, notify DELETE_SLICE at zero."""
        prefix = self._ino_key(ino) + b"C"
        chunks = [k for k, _ in self.client.scan(prefix, next_key(prefix))]
        for key in chunks:

            def fn(tx: KVTxn, key=key):
                raw = tx.get(key)
                if raw:
                    for s in Slice.decode_list(raw):
                        if s.id:
                            self._decref_slice(tx, s.id, s.size)
                    tx.delete(key)
                return 0

            self._txn_notify(fn)
        self.client.txn(lambda tx: tx.delete(self._delfile_key(ino, length)))

    def do_list_slices(self) -> dict[int, list[Slice]]:
        out: dict[int, list[Slice]] = {}
        for (ino, _indx), slcs in self.list_chunks():
            out.setdefault(ino, []).extend(s for s in slcs if s.id)
        return out

    def list_chunks(self):
        """Yield ((ino, indx), slices) for every chunk record — the scan
        feeding compaction and gc (reference base.go scanAllChunks)."""
        for k, v in self.client.scan(b"A", next_key(b"A")):
            if len(k) == 14 and k[9:10] == b"C":
                ino = int.from_bytes(k[1:9], "big")
                indx = int.from_bytes(k[10:14], "big")
                yield (ino, indx), Slice.decode_list(v)

    # ---- push invalidation (reference vfs.go:1228 / openfile.go) ---------
    # IV{seq8} -> sid8 + ts f64 + JSON events. A small rolling journal:
    # peers tail it on their heartbeat; stale records are pruned by
    # publishers. Best-effort acceleration of the TTL contract.

    _INVAL_TTL = 60.0

    @staticmethod
    def _inval_key(seq: int) -> bytes:
        return b"IV" + seq.to_bytes(8, "big")

    def do_publish_invalidations(self, sid: int, events: list[tuple]) -> None:
        # (replica-read coherence needs no help here: the engine's own
        # per-commit !epoch bump already floors replica reads at this
        # client's writes — redis_kv.py EPOCH_KEY)
        payload = self._encode_inval_events(events).encode()

        def fn(tx: KVTxn):
            seq = tx.incr_by(self._counter_key("invalSeq"), 1)
            tx.set(self._inval_key(seq), sid.to_bytes(8, "big") + _F64.pack(time.time()) + payload)
            return seq

        self.client.txn(fn)
        # prune aged records (journal stays tiny; the ordered scan stops at
        # the first FRESH record — malformed ones are doomed, not treated
        # as fresh, so one bad record cannot block pruning forever)
        cutoff = time.time() - self._INVAL_TTL
        doomed = []
        for k, v in self.client.scan(b"IV", next_key(b"IV")):
            if len(v) < 16 or _F64.unpack_from(v, 8)[0] < cutoff:
                doomed.append(k)
            else:
                break
        if doomed:
            def prune(tx: KVTxn):
                for k in doomed:
                    tx.delete(k)
                return 0

            self.client.txn(prune)

    def do_fetch_invalidations(self, since: int, exclude_sid: int) -> tuple[int, list[tuple]]:
        if since < 0:
            # first heartbeat: learn the current position, deliver nothing
            return self.do_counter("invalSeq"), []
        events: list[tuple] = []
        latest = since
        for k, v in self.client.scan(self._inval_key(since + 1), next_key(b"IV")):
            if len(k) != 10 or len(v) < 16:
                continue
            latest = max(latest, int.from_bytes(k[2:10], "big"))
            if int.from_bytes(v[:8], "big") == exclude_sid:
                continue
            events.extend(self._decode_inval_events(v[16:]))
        return latest, events

    # ---- content-hash index (device fingerprint plane) -------------------
    # Persists the write path's JTH-256 block digests so gc --dedup and
    # fsck consume an index instead of re-hashing the volume. The index is
    # advisory: entries for deleted slices are garbage-collected by the
    # next gc sweep, and missing entries are backfilled there too, so a
    # lost write can never corrupt anything.

    def set_block_digests(
        self, entries: list[tuple[int, int, int, bytes]]
    ) -> None:
        """Record (sliceid, indx, bsize, digest32) rows, batched per txn."""
        for i in range(0, len(entries), 1024):
            batch = entries[i:i + 1024]

            def fn(tx: KVTxn, batch=batch):
                for sid, indx, bsize, digest in batch:
                    tx.set(
                        self._blockdigest_key(sid, indx),
                        bsize.to_bytes(4, "big") + digest,
                    )
                return 0

            self.client.txn(fn)

    def scan_block_digests(self):
        """Yield (sliceid, indx, bsize, digest32) for every indexed block."""
        for k, v in self.client.scan(b"B", next_key(b"B")):
            if len(k) == 13 and len(v) >= 36:
                yield (
                    int.from_bytes(k[1:9], "big"),
                    int.from_bytes(k[9:13], "big"),
                    int.from_bytes(v[:4], "big"),
                    bytes(v[4:36]),
                )

    def delete_block_digests(self, pairs: list[tuple[int, int]]) -> None:
        """Drop index rows for (sliceid, indx) pairs, batched per txn."""
        for i in range(0, len(pairs), 1024):
            batch = pairs[i:i + 1024]

            def fn(tx: KVTxn, batch=batch):
                for sid, indx in batch:
                    tx.delete(self._blockdigest_key(sid, indx))
                return 0

            self.client.txn(fn)

    # ---- hot-content fingerprint snapshot ---------------------
    # One advisory blob under a single key (like the Format under
    # b"setting"): 64 bytes per row (fp32 + digest32), MRU-first, replaced
    # wholesale at unmount. Single-txn either way — the snapshot is small
    # (bounded by the persist limit) and internally order-dependent.

    def set_hot_fingerprints(self, rows: list[tuple[bytes, bytes]]) -> None:
        blob = b"".join(fp + digest for fp, digest in rows)

        def fn(tx: KVTxn):
            if blob:
                tx.set(b"hotfp", blob)
            else:
                tx.delete(b"hotfp")
            return 0

        self.client.txn(fn)

    def load_hot_fingerprints(self) -> list[tuple[bytes, bytes]]:
        blob = self.client.txn(lambda tx: tx.get(b"hotfp")) or b""
        return [
            (bytes(blob[i:i + 32]), bytes(blob[i + 32:i + 64]))
            for i in range(0, len(blob) - len(blob) % 64, 64)
        ]

    # ---- content-ref plane (inline ingest dedup) ----------------
    # H{digest} rows count every block whose bytes are served by one
    # canonical stored object; G{sid,indx} alias rows let the read and
    # delete paths resolve a block key back to its canonical. All
    # transitions are single transactions, so a concurrent incref (writer
    # eliding a PUT) and decref-to-zero (deleter reclaiming the canonical)
    # serialize: whichever commits first decides whether the other sees
    # the row (see chunk/ingest.py for the write-path contract).

    @staticmethod
    def _contentref_key(digest: bytes) -> bytes:
        return b"H" + digest

    @staticmethod
    def _contentalias_key(sid: int, indx: int) -> bytes:
        return b"G" + sid.to_bytes(8, "big") + indx.to_bytes(4, "big")

    @staticmethod
    def _unpack_canonical(v: bytes) -> tuple[int, int, int]:
        return (int.from_bytes(v[:8], "big"),
                int.from_bytes(v[8:12], "big"),
                int.from_bytes(v[12:16], "big"))

    def _tx_add_ref(self, tx: KVTxn, rk: bytes, v: bytes,
                    digest: bytes, sid: int, indx: int, bsize: int):
        canonical = self._unpack_canonical(v)
        refs = _I64.unpack_from(v, 16)[0]
        tx.set(rk, v[:16] + _I64.pack(refs + 1))
        tx.set(self._contentalias_key(sid, indx),
               digest + _U32.pack(bsize) + _F64.pack(time.time()))
        return canonical

    def content_incref(
        self, entries: list[tuple[bytes, int, int, int]]
    ) -> list[Optional[tuple[int, int, int]]]:
        """For each (digest, sid, indx, bsize): if a content ref exists,
        atomically refcount+=1 and record the alias row, returning the
        canonical (sid, indx, bsize); else None (caller must upload)."""

        def fn(tx: KVTxn):
            out: list = []
            for digest, sid, indx, bsize in entries:
                rk = self._contentref_key(digest)
                v = tx.get(rk)
                if v is None or len(v) < 24:
                    out.append(None)
                else:
                    out.append(self._tx_add_ref(tx, rk, v, digest,
                                                sid, indx, bsize))
            return out

        return self.client.txn(fn)

    def content_register(
        self, entries: list[tuple[bytes, int, int, int]]
    ) -> list[Optional[tuple[int, int, int]]]:
        """Register (sid, indx) as the canonical block for digest, with a
        refcount of 1 (its own reference) and its own alias row. If the
        digest is already registered (a concurrent writer won the race),
        incref + alias instead and return the existing canonical so the
        caller can collapse its redundant upload; None = registered."""

        def fn(tx: KVTxn):
            out: list = []
            for digest, sid, indx, bsize in entries:
                rk = self._contentref_key(digest)
                v = tx.get(rk)
                if v is None or len(v) < 24:
                    tx.set(rk, sid.to_bytes(8, "big")
                           + indx.to_bytes(4, "big")
                           + bsize.to_bytes(4, "big") + _I64.pack(1))
                    tx.set(self._contentalias_key(sid, indx),
                           digest + _U32.pack(bsize) + _F64.pack(time.time()))
                    out.append(None)
                else:
                    out.append(self._tx_add_ref(tx, rk, v, digest,
                                                sid, indx, bsize))
            return out

        return self.client.txn(fn)

    def content_decref(
        self, pairs: list[tuple[int, int]]
    ) -> list[tuple[str, Optional[tuple[int, int, int]]]]:
        """Release (sid, indx) blocks being deleted. Per pair:
        ("untracked", None)   — no alias row: delete the object as usual;
        ("released", canon)   — refs remain: do NOT delete the canonical;
        ("last", canon)       — this was the final ref: caller deletes the
                                canonical object;
        ("dangling", None)    — alias row without a ref row (repaired by
                                dropping the alias; gc reports these)."""

        def fn(tx: KVTxn):
            out: list = []
            for sid, indx in pairs:
                ak = self._contentalias_key(sid, indx)
                av = tx.get(ak)
                if av is None or len(av) < 32:
                    out.append(("untracked", None))
                    continue
                tx.delete(ak)
                rk = self._contentref_key(bytes(av[:32]))
                v = tx.get(rk)
                if v is None or len(v) < 24:
                    out.append(("dangling", None))
                    continue
                canonical = self._unpack_canonical(v)
                refs = _I64.unpack_from(v, 16)[0]
                if refs <= 1:
                    tx.delete(rk)
                    out.append(("last", canonical))
                else:
                    tx.set(rk, v[:16] + _I64.pack(refs - 1))
                    out.append(("released", canonical))
            return out

        return self.client.txn(fn)

    def content_resolve(self, sid: int, indx: int) -> Optional[tuple[int, int, int]]:
        """Read path: canonical (sid, indx, bsize) serving this block's
        bytes, or None when the block is untracked/dangling."""

        def fn(tx: KVTxn):
            av = tx.get(self._contentalias_key(sid, indx))
            if av is None or len(av) < 32:
                return None
            v = tx.get(self._contentref_key(bytes(av[:32])))
            if v is None or len(v) < 24:
                return None
            return self._unpack_canonical(v)

        return self.client.simple_txn(fn)

    def scan_content_refs(self):
        """Yield (digest, (sid, indx, bsize), refcount) for every content
        ref row (gc reconciliation)."""
        for k, v in self.client.scan(b"H", next_key(b"H")):
            if len(k) == 33 and len(v) >= 24:
                yield (bytes(k[1:]), self._unpack_canonical(v),
                       _I64.unpack_from(v, 16)[0])

    def scan_content_aliases(self):
        """Yield ((sid, indx), digest, bsize, created_ts) for every alias
        row (created_ts guards reconciliation's orphan repair against
        in-flight writes whose slice has not committed yet)."""
        for k, v in self.client.scan(b"G", next_key(b"G")):
            if len(k) == 13 and len(v) >= 36:
                ts = _F64.unpack_from(v, 36)[0] if len(v) >= 44 else 0.0
                yield ((int.from_bytes(k[1:9], "big"),
                        int.from_bytes(k[9:13], "big")),
                       bytes(v[:32]), _U32.unpack_from(v, 32)[0], ts)

    def content_set_refs(self, digest: bytes, refs: int) -> None:
        """gc repair: pin a ref row's count to the observed alias count
        (refs <= 0 deletes the row)."""

        def fn(tx: KVTxn):
            rk = self._contentref_key(digest)
            if refs <= 0:
                tx.delete(rk)
            else:
                v = tx.get(rk)
                if v is not None and len(v) >= 24:
                    tx.set(rk, v[:16] + _I64.pack(refs))
            return 0

        self.client.txn(fn)

    def content_delete_aliases(self, pairs: list[tuple[int, int]]) -> None:
        """gc repair: drop alias rows (dangling or orphaned)."""
        for i in range(0, len(pairs), 1024):
            batch = pairs[i:i + 1024]

            def fn(tx: KVTxn, batch=batch):
                for sid, indx in batch:
                    tx.delete(self._contentalias_key(sid, indx))
                return 0

            self.client.txn(fn)

    # ---- POSIX ACLs (reference pkg/acl, pkg/meta/tkv.go:3594-3689) -------
    def _load_acl(self, tx: KVTxn, aid: int) -> Optional["acl_mod.Rule"]:
        """Rule by interned id; cached (rows are insert-only, and callers
        only pass ids from committed attrs, so a cached entry is always
        committed data even if the enclosing txn later aborts)."""
        if aid == acl_mod.ACL_NONE:
            return None
        rule = self._acl_cache.get(aid)
        if rule is None:
            raw = tx.get(self._acl_key(aid))
            if raw is None:
                return None
            rule = acl_mod.Rule.decode(raw)
            self._acl_cache[aid] = rule
            self._acl_rev[bytes(raw)] = aid
        return rule

    def _acl_publish(self, aid: int, rule: Optional["acl_mod.Rule"]) -> None:
        """Record a rule interning AFTER its transaction committed, making
        it eligible as an _insert_acl fast-path hit."""
        if aid != acl_mod.ACL_NONE and rule is not None:
            self._acl_cache.setdefault(aid, rule)
            self._acl_rev.setdefault(rule.encode(), aid)

    def _insert_acl(self, tx: KVTxn, rule: Optional["acl_mod.Rule"]) -> int:
        """Intern a rule, deduplicating against all persisted rules
        (reference tkv.go insertACL + tryLoadMissACLs).

        Dedup is purely transaction-local: the R range is scanned inside
        the txn (engines merge this txn's own buffered inserts into scans),
        and nothing is published to the in-memory cache here — if the txn
        aborts or conflict-retries, a cached id would point at a row that
        was never written, and the id could later be re-allocated to a
        DIFFERENT rule (wrong-ACL enforcement). The R keyspace is small
        (rules are shared across inodes), so the scan is cheap.
        """
        if rule is None or rule.is_empty():
            return acl_mod.ACL_NONE
        enc = rule.encode()
        aid = self._acl_rev.get(enc)  # committed-rule fast path
        if aid is not None:
            return aid
        for k, v in tx.scan(b"R", next_key(b"R")):
            if len(k) == 5 and bytes(v) == enc:
                return int.from_bytes(k[1:5], "big")
        aid = tx.incr_by(self._counter_key("nextAcl"), 1)
        tx.set(self._acl_key(aid), enc)
        return aid

    def do_load_acl(self, aid: int) -> Optional["acl_mod.Rule"]:
        """Non-txn rule read for access() checks (reference base.go:873)."""
        if aid == acl_mod.ACL_NONE:
            return None
        rule = self._acl_cache.get(aid)
        if rule is not None:
            return rule
        return self.client.simple_txn(lambda tx: self._load_acl(tx, aid))

    def do_set_facl(self, ctx: Context, ino: int, acl_type: int,
                    rule: "acl_mod.Rule") -> int:
        """Port of reference tkv.go:3594 doSetFacl: ACL<->mode interplay."""
        from dataclasses import replace as _rep

        interned: list = []  # (aid, rule) published after commit

        def fn(tx: KVTxn):
            interned.clear()  # conflict retry reruns the closure
            attr = self._get_attr(tx, ino)
            if attr is None:
                return errno.ENOENT
            if ctx.check_permission and ctx.uid != 0 and ctx.uid != attr.uid:
                return errno.EPERM
            if attr.flags & FLAG_IMMUTABLE:
                return errno.EPERM
            if acl_type == acl_mod.TYPE_DEFAULT and attr.typ != TYPE_DIRECTORY:
                return errno.EACCES  # default ACLs exist on directories only
            ori_id = (attr.access_acl if acl_type == acl_mod.TYPE_ACCESS
                      else attr.default_acl)
            ori_mode = attr.mode
            if (acl_type == acl_mod.TYPE_ACCESS and not rule.is_empty()
                    and ctx.check_permission and ctx.uid != 0
                    and not ctx.contains_gid(attr.gid)):
                # Setting an access ACL is mode-changing, so the kernel's
                # chmod-equivalent sgid kill applies (fuse/acl.c); default-
                # ACL ops and removals leave the mode untouched.
                attr.mode &= 0o5777
            if rule.is_empty():
                new_id = acl_mod.ACL_NONE
            elif rule.is_minimal() and acl_type == acl_mod.TYPE_ACCESS:
                # equivalent to plain mode: store no rule
                new_id = acl_mod.ACL_NONE
                attr.mode = (attr.mode & 0o7000) | rule.get_mode()
            else:
                r = _rep(rule)
                r.inherit_perms(attr.mode)
                new_id = self._insert_acl(tx, r)
                interned.append((new_id, r))
                if acl_type == acl_mod.TYPE_ACCESS:
                    attr.mode = (attr.mode & 0o7000) | r.get_mode()
            if acl_type == acl_mod.TYPE_ACCESS:
                attr.access_acl = new_id
            else:
                attr.default_acl = new_id
            if ori_id != new_id or ori_mode != attr.mode:
                attr.touch_ctime(time.time())
                self._set_attr(tx, ino, attr)
            return 0

        st = self.client.txn(fn)
        if st == 0:
            for aid, r in interned:
                self._acl_publish(aid, r)
        return st

    def do_get_facl(self, ino: int, acl_type: int) -> tuple[int, Optional["acl_mod.Rule"]]:
        """reference tkv.go:3656 doGetFacl; ENODATA when no such ACL."""
        from dataclasses import replace as _rep

        def fn(tx: KVTxn):
            attr = self._get_attr(tx, ino)
            if attr is None:
                return errno.ENOENT, None
            aid = (attr.access_acl if acl_type == acl_mod.TYPE_ACCESS
                   else attr.default_acl)
            if aid == acl_mod.ACL_NONE:
                return errno.ENODATA, None
            rule = self._load_acl(tx, aid)
            if rule is None:
                return errno.EIO, None
            return 0, _rep(rule)  # copy: callers may mutate

        return self.client.simple_txn(fn)

    # ---- dir quotas (reference pkg/meta/quota.go:32-44,209,396) ----------
    _QFMT = struct.Struct(">qqqq")  # space_limit inode_limit used_space used_inodes

    _QUOTA_HINT_TTL = 1.0

    def _quota_roots_hint(self) -> set[int]:
        """Cached set of quota-root inodes (reference quota.go keeps loaded
        quotas in memory, refreshed periodically). The hint only prunes the
        ancestor walk — actual records are still read inside the txn.

        Staleness consequence: a quota created by ANOTHER
        client is invisible to this client's hint for up to TTL seconds,
        and any write committed in that window skips _quota_update for it
        — the stored used_space/used_inodes then stay drifted until
        `quota check --repair` (check_dir_quota) recomputes them. The
        reference has the same window and the same repair tool. Without
        the hint every dirstat update walks the parent chain: O(depth)
        network round trips per op on a networked engine."""
        cached = self._qcache
        now = time.monotonic()
        if cached is not None and now - cached[1] <= self._QUOTA_HINT_TTL:
            return cached[0]
        roots: set[int] = set()
        for k, _ in self.client.scan(b"QD", next_key(b"QD")):
            if len(k) == 10:
                roots.add(int.from_bytes(k[2:], "big"))
        self._qcache = (roots, now)
        return roots

    def _quota_chain(self, tx: KVTxn, dir_ino: int):
        """Yield (ino, record) for every quota on the ancestor chain."""
        hint = self._quota_roots_hint()
        if not hint:
            return
        ino, hops = dir_ino, 0
        while ino and hops < 100:
            if ino in hint:
                raw = tx.get(self._dirquota_key(ino))
                if raw:
                    yield ino, raw
            if ino == ROOT_INODE:
                break
            attr = self._get_attr(tx, ino)
            if attr is None:
                break
            ino = attr.parent
            hops += 1

    def _quota_check(self, tx: KVTxn, dir_ino: int, dspace: int, dinodes: int) -> int:
        """Reject growth that would exceed any ancestor quota."""
        if dspace <= 0 and dinodes <= 0:
            return 0
        return self._quota_check_roots(
            tx, self._quota_roots(tx, dir_ino), dspace, dinodes
        )

    def _quota_update(self, tx: KVTxn, dir_ino: int, dspace: int, dinodes: int) -> None:
        if not dspace and not dinodes:
            return
        for ino, raw in self._quota_chain(tx, dir_ino):
            sl, il, us, ui = self._QFMT.unpack(raw)
            tx.set(
                self._dirquota_key(ino),
                self._QFMT.pack(sl, il, us + dspace, ui + dinodes),
            )

    def _quota_roots(self, tx: KVTxn, dir_ino: int) -> set[int]:
        return {ino for ino, _ in self._quota_chain(tx, dir_ino)}

    def _quota_check_roots(self, tx: KVTxn, roots: set[int], dspace: int, dinodes: int) -> int:
        """_quota_check over an explicit set of quota roots. Rename uses it
        so only quotas the destination chain ADDS can reject a move — a
        quota shared by both chains sees no net usage change (reference
        pkg/meta/quota.go rename handling)."""
        if dspace <= 0 and dinodes <= 0:
            return 0
        for ino in roots:
            raw = tx.get(self._dirquota_key(ino))
            if not raw:
                continue
            sl, il, us, ui = self._QFMT.unpack(raw)
            if sl and dspace > 0 and us + dspace > sl:
                return errno.EDQUOT
            if il and dinodes > 0 and ui + dinodes > il:
                return errno.EDQUOT
        return 0

    def _tree_usage(self, tx: KVTxn, ino: int) -> tuple[int, int]:
        """(space, inodes) of a whole subtree including its root — what a
        cross-quota-tree move must transfer (reference quota.go rename)."""
        space = inodes = 0
        stack = [ino]
        while stack:  # iterative: arbitrarily deep trees must not blow the
            cur = stack.pop()  # Python stack (cf. base.py remove_recursive)
            attr = self._get_attr(tx, cur)
            if attr is None:
                continue
            space += _direct_space(attr)
            inodes += 1
            if attr.typ == TYPE_DIRECTORY:
                stack.extend(child for _n, _t, child in self._scan_entries(tx, cur))
        return space, inodes

    def set_dir_quota(self, ctx: Context, ino: int, space_limit: int, inode_limit: int) -> int:
        """Set/replace a directory quota; current usage is initialized from
        a tree walk (reference HandleQuota quota.go:396)."""
        st, summ = self.summary(ctx, ino)
        if st:
            return st
        # usage counts the subtree below the quota dir, not the dir itself
        used_space = max(0, summ.size - 4096)
        used_inodes = summ.files + summ.dirs - 1

        def fn(tx: KVTxn):
            if self._get_attr(tx, ino) is None:
                return errno.ENOENT
            tx.set(
                self._dirquota_key(ino),
                self._QFMT.pack(space_limit, inode_limit, used_space, used_inodes),
            )
            return 0

        st = self._etxn(fn)
        self._qcache = None
        return st

    def get_dir_quota(self, ino: int):
        raw = self.client.simple_txn(lambda tx: tx.get(self._dirquota_key(ino)))
        if raw is None:
            return None
        return self._QFMT.unpack(raw)

    def check_dir_quota(self, ctx: Context, ino: int, repair: bool = False):
        """Recompute a quota root's true usage from a tree walk and compare
        to the stored counters; with repair=True write the recomputed
        values back (reference `juicefs quota check` cmd/quota.go).

        This is the recovery path for the hint-window drift documented at
        _quota_roots_hint: writes committed before another client observes
        a brand-new quota are missed permanently until repaired here.
        Returns (errno, stored(space,inodes), actual(space,inodes)).
        """
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
            def fn(tx: KVTxn):
                raw = tx.get(self._dirquota_key(ino))
                if raw is None:
                    return errno.ENOENT
                cur = self._QFMT.unpack(raw)
                if cur[2:] != (us, ui):
                    # usage moved while the tree walk ran: blindly writing
                    # the stale walk result would erase that activity —
                    # surface EAGAIN so the caller re-runs the check
                    return errno.EAGAIN
                tx.set(
                    self._dirquota_key(ino),
                    self._QFMT.pack(cur[0], cur[1], actual_space, actual_inodes),
                )
                return 0

            st = self._etxn(fn)
            if st:
                return st, (us, ui), (actual_space, actual_inodes)
        return 0, (us, ui), (actual_space, actual_inodes)

    def del_dir_quota(self, ino: int) -> int:
        def fn(tx: KVTxn):
            tx.delete(self._dirquota_key(ino))
            return 0

        st = self._etxn(fn)
        self._qcache = None
        return st

    def list_dir_quotas(self) -> dict[int, tuple[int, int, int, int]]:
        out = {}
        for k, v in self.client.scan(b"QD", next_key(b"QD")):
            out[int.from_bytes(k[2:10], "big")] = self._QFMT.unpack(v)
        return out

    def clone(self, ctx: Context, src_ino: int, dst_parent: int, name: bytes) -> tuple[int, int]:
        """Server-side O(meta) copy of a subtree (reference base.go:2427-2588
        Clone): duplicate the metadata tree, share data by incref'ing every
        slice. Returns (errno, new root inode). Runs as one transaction —
        correct for any size, batched only by the engine's txn capacity."""

        def fn(tx: KVTxn):
            sattr = self._get_attr(tx, src_ino)
            if sattr is None:
                return errno.ENOENT, 0
            pattr = self._get_attr(tx, dst_parent)
            if pattr is None:
                return errno.ENOENT, 0
            if pattr.typ != TYPE_DIRECTORY:
                return errno.ENOTDIR, 0
            typ, _ = self._get_entry(tx, dst_parent, name)
            if typ:
                return errno.EEXIST, 0

            # Pass 1: measure the subtree (inodes/space) for the capacity
            # and quota checks.
            space, count = self._tree_usage(tx, src_ino)
            if space > 0 and self.fmt.capacity:
                if self._counter_get(tx, "usedSpace") + space > self.fmt.capacity:
                    return errno.ENOSPC, 0
            if self.fmt.inodes:
                if self._counter_get(tx, "totalInodes") + count > self.fmt.inodes:
                    return errno.ENOSPC, 0
            st = self._quota_check(tx, dst_parent, space, count)
            if st:
                return st, 0
            next_ino = tx.incr_by(self._counter_key("nextInode"), count) - count
            now = time.time()

            # Pass 2: iterative pre-order copy (deep trees must not blow
            # the Python stack); children link into their parent as they
            # are visited, dir nlinks are patched once at the end.
            new_root = 0
            dir_attrs: dict[int, Attr] = {}  # new dir ino -> its attr
            dir_children: dict[int, int] = {}  # new dir ino -> dir child count
            stack = [(src_ino, dst_parent, None, 0)]
            while stack:
                old, new_parent, cname, ctyp = stack.pop()
                attr = self._get_attr(tx, old)
                if attr is None:
                    continue  # dangling entry: skip, like the measurement
                new = next_ino
                next_ino += 1
                nattr = Attr.decode(attr.encode())  # deep copy via codec
                nattr.parent = new_parent
                nattr.touch_ctime(now)
                nattr.nlink = 2 if nattr.typ == TYPE_DIRECTORY else 1
                self._set_attr(tx, new, nattr)
                if cname is None:
                    new_root = new
                else:
                    self._set_entry(tx, new_parent, cname, ctyp, new)
                    if ctyp == TYPE_DIRECTORY:
                        dir_children[new_parent] = dir_children.get(new_parent, 0) + 1
                # xattrs
                xprefix = self._ino_key(old) + b"X"
                for k, v in tx.scan(xprefix, next_key(xprefix)):
                    tx.set(self._xattr_key(new, k[len(xprefix):]), v)
                if attr.typ == TYPE_SYMLINK:
                    target = tx.get(self._symlink_key(old))
                    if target is not None:
                        tx.set(self._symlink_key(new), target)
                elif attr.typ == TYPE_FILE:
                    cprefix = self._ino_key(old) + b"C"
                    for k, v in tx.scan(cprefix, next_key(cprefix)):
                        indx = int.from_bytes(k[len(cprefix):], "big")
                        tx.set(self._chunk_key(new, indx), v)
                        for s in Slice.decode_list(v):
                            if s.id:
                                self._incref_slice(tx, s.id, s.size)
                else:  # directory: queue children, copy dirstat verbatim
                    dir_attrs[new] = nattr
                    for name2, typ2, child in self._scan_entries(tx, old):
                        stack.append((child, new, name2, typ2))
                    dstat = tx.get(self._dirstat_key(old))
                    if dstat is not None:
                        tx.set(self._dirstat_key(new), dstat)
            for dino, n in dir_children.items():
                nattr = dir_attrs.get(dino)
                if nattr is not None and n:
                    nattr.nlink = 2 + n
                    self._set_attr(tx, dino, nattr)
            self._set_entry(tx, dst_parent, name, sattr.typ, new_root)
            if sattr.typ == TYPE_DIRECTORY:
                pattr.nlink += 1
            pattr.touch_mtime(now)
            self._set_attr(tx, dst_parent, pattr)
            # quota checked above; only charge the counters here
            tx.incr_by(self._counter_key("usedSpace"), space)
            tx.incr_by(self._counter_key("totalInodes"), count)
            # dst_parent's dirstat gains only its one new direct child
            if sattr.typ == TYPE_DIRECTORY:
                self._update_dirstat(tx, dst_parent, 0, 4096, 1)
                # the cloned subtree below the root is invisible to the
                # dirstat delta; charge it to the ancestor quotas explicitly
                self._quota_update(tx, dst_parent, space - 4096, count - 1)
            else:
                self._update_dirstat(
                    tx, dst_parent, sattr.length, _align4k(sattr.length), 1
                )
            return 0, new_root

        result = self._txn_notify(fn)
        return result

    # ---- xattr -----------------------------------------------------------
    def do_getxattr(self, ino, name) -> tuple[int, bytes]:
        raw = self.client.simple_txn(lambda tx: tx.get(self._xattr_key(ino, name)))
        if raw is None:
            return errno.ENODATA, b""
        return 0, raw

    def do_setxattr(self, ino, name, value, flags) -> int:
        XATTR_CREATE, XATTR_REPLACE = 1, 2

        def fn(tx: KVTxn):
            if self._get_attr(tx, ino) is None:
                return errno.ENOENT
            key = self._xattr_key(ino, name)
            old = tx.get(key)
            if flags & XATTR_CREATE and old is not None:
                return errno.EEXIST
            if flags & XATTR_REPLACE and old is None:
                return errno.ENODATA
            tx.set(key, value)
            return 0

        return self._etxn(fn)

    def do_listxattr(self, ino) -> tuple[int, list[bytes]]:
        def fn(tx: KVTxn):
            if self._get_attr(tx, ino) is None:
                return errno.ENOENT, []
            prefix = self._ino_key(ino) + b"X"
            return 0, [k[len(prefix):] for k, _ in tx.scan(prefix, next_key(prefix), keys_only=True)]

        return self.client.simple_txn(fn)

    def do_removexattr(self, ino, name) -> int:
        def fn(tx: KVTxn):
            key = self._xattr_key(ino, name)
            if tx.get(key) is None:
                return errno.ENODATA
            tx.delete(key)
            return 0

        return self._etxn(fn)

    # ---- locks (reference redis_lock.go / tkv_lock.go semantics) ---------
    F_UNLCK, F_RDLCK, F_WRLCK = 2, 0, 1

    def flock(self, ctx, ino: int, owner: int, ltype: str) -> int:
        """BSD flock: ltype in {"R","W","U"} (reference interface.go Flock)."""

        def fn(tx: KVTxn):
            key = self._flock_key(ino)
            raw = tx.get(key)
            table: dict[str, str] = json.loads(raw) if raw else {}
            me = f"{self.sid}/{owner:x}"
            if ltype == "U":
                table.pop(me, None)
            elif ltype == "R":
                if any(t == "W" and o != me for o, t in table.items()):
                    return errno.EAGAIN
                table[me] = "R"
            elif ltype == "W":
                if any(o != me for o in table):
                    return errno.EAGAIN
                table[me] = "W"
            else:
                return errno.EINVAL
            if table:
                tx.set(key, json.dumps(table).encode())
            else:
                tx.delete(key)
            return 0

        st = self._etxn(fn)
        if st == 0 and ltype == "U":
            self.lock_released(ino)
            self._publish_unlock(ino)
        return st

    # -- cross-client lock wake (reference redis_lock.go) ---
    _UNLOCK_CHANNEL = b"jfs:unlock"

    def _publish_unlock(self, ino: int) -> None:
        pub = getattr(self.client, "publish", None)
        if pub is not None:
            pub(self._UNLOCK_CHANNEL, str(ino).encode())

    def do_watch_unlocks(self) -> None:
        sub = getattr(self.client, "subscribe", None)
        if sub is None or getattr(self, "_watching_unlocks", False):
            return
        self._watching_unlocks = True

        def on_msg(payload: bytes) -> None:
            try:
                ino = int(payload)
            except ValueError:
                return
            # wake local waiters parked in lock_wait on this inode; they
            # re-contend through the normal setlk/flock path
            self.lock_released(ino)

        sub(self._UNLOCK_CHANNEL, on_msg)

    def setlk(self, ctx, ino: int, owner: int, ltype: int, start: int, end: int, pid: int = 0) -> int:
        """POSIX record lock set/unset; non-blocking (reference Setlk)."""

        def fn(tx: KVTxn):
            key = self._plock_key(ino)
            raw = tx.get(key)
            locks: list = json.loads(raw) if raw else []
            me = [self.sid, owner]
            if ltype == self.F_UNLCK:
                locks = [
                    l for l in locks
                    if not (l[0] == me[0] and l[1] == me[1] and l[3] < end and l[4] > start)
                ] + [
                    # keep non-overlapping remains of own locks
                    part
                    for l in locks
                    if l[0] == me[0] and l[1] == me[1] and l[3] < end and l[4] > start
                    for part in (
                        ([[l[0], l[1], l[2], l[3], start, l[5]]] if l[3] < start else [])
                        + ([[l[0], l[1], l[2], end, l[4], l[5]]] if l[4] > end else [])
                    )
                ]
            else:
                for l in locks:
                    if (l[0] != me[0] or l[1] != me[1]) and l[3] < end and l[4] > start:
                        if ltype == self.F_WRLCK or l[2] == self.F_WRLCK:
                            return errno.EAGAIN
                # Split own partially-overlapping locks like F_UNLCK does,
                # so a lock of a different type over a subrange replaces the
                # overlap (POSIX downgrade/upgrade) instead of leaving the
                # old row to shadow it.
                keep, remains = [], []
                for l in locks:
                    if l[0] == me[0] and l[1] == me[1] and l[3] < end and l[4] > start:
                        if l[3] < start:
                            remains.append([l[0], l[1], l[2], l[3], start, l[5]])
                        if l[4] > end:
                            remains.append([l[0], l[1], l[2], end, l[4], l[5]])
                    else:
                        keep.append(l)
                locks = keep + remains
                locks.append([me[0], me[1], ltype, start, end, pid])
            if locks:
                tx.set(key, json.dumps(locks).encode())
            else:
                tx.delete(key)
            return 0

        st = self._etxn(fn)
        if st == 0 and ltype == self.F_UNLCK:
            self.lock_released(ino)
            self._publish_unlock(ino)
        return st

    def getlk(self, ctx, ino: int, owner: int, ltype: int, start: int, end: int) -> tuple[int, int, int, int, int]:
        """Returns (errno, ltype, start, end, pid); F_UNLCK if free."""

        def fn(tx: KVTxn):
            raw = tx.get(self._plock_key(ino))
            locks: list = json.loads(raw) if raw else []
            for l in locks:
                if (l[0] != self.sid or l[1] != owner) and l[3] < end and l[4] > start:
                    if ltype == self.F_WRLCK or l[2] == self.F_WRLCK:
                        return 0, l[2], l[3], l[4], l[5]
            return 0, self.F_UNLCK, 0, 0, 0

        return self.client.simple_txn(fn)

    # ---- admin -----------------------------------------------------------
    def do_statfs(self) -> tuple[int, int, int, int]:
        def fn(tx: KVTxn):
            used = self._counter_get(tx, "usedSpace")
            inodes = self._counter_get(tx, "totalInodes")
            return used, inodes

        used, iused = self.client.simple_txn(fn)
        used = max(used, 0)
        iused = max(iused, 0)
        total = self.fmt.capacity or (1 << 50)
        iavail = (self.fmt.inodes - iused) if self.fmt.inodes else (10 << 20)
        return total, max(total - used, 0), iused, max(iavail, 0)

def _factory(scheme: str, addr: str) -> KVMeta:
    client = new_tkv_client(scheme, addr)
    return KVMeta(client, f"{scheme}://{addr}")


interface.register("memkv", _factory)
interface.register("mem", _factory)
interface.register("sqlite3", _factory)
interface.register("sqlite", _factory)
interface.register("redis", _factory)
