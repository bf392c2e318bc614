"""Engine-agnostic metadata logic (reference: pkg/meta/base.go baseMeta:147).

BaseMeta owns everything that does not touch the KV/SQL wire: permission
checks, name validation, path resolution, open-file cache, session lifecycle,
background-job hooks, message callbacks (slice deletion, compaction), statfs,
recursive tools (summary, rmr). Engines implement the `do_*` methods
(reference base.go:51-125 internal `engine` interface).
"""

from __future__ import annotations

import errno
import os
import threading
import time
from typing import Callable, Optional

from ..utils import get_logger
from . import interface
from .cache import LeaseCache, MetaOpLimiter
from .context import Context
from .openfile import OpenFiles
from .resilient import MetaResilience, MetaUnavailableError
from .wbatch import WriteBatcher
from .types import (
    Attr,
    Entry,
    Format,
    Session,
    Slice,
    Summary,
    CHUNK_SIZE,
    MAX_NAME_LEN,
    MAX_SYMLINK_LEN,
    ROOT_INODE,
    TRASH_INODE,
    SET_ATTR_GID,
    SET_ATTR_MODE,
    SET_ATTR_SIZE,
    SET_ATTR_UID,
    TYPE_DIRECTORY,
    TYPE_FILE,
    TYPE_SYMLINK,
    new_session_info,
)

logger = get_logger("meta.base")

MODE_MASK_R = 4
MODE_MASK_W = 2
MODE_MASK_X = 1

_UMOUNTED, _MOUNTED = 0, 1


class BaseMeta(interface.Meta):
    # engines with a change feed (the invalSeq journal exchanged on the
    # session heartbeat) set this True; without one the lease cache below
    # stays in TTL-0 passthrough — remote staleness could not even be
    # accelerated, so it is not cached at all.
    supports_inval_feed = False
    # engines whose transactions NEST (a do_* call inside group_txn joins
    # the enclosing transaction) set this True; without it the write
    # batcher stays disabled — a "group" that cannot roll back atomically
    # could commit partial state on a mid-group failure.
    supports_group_txn = False

    def __init__(self, addr: str):
        self.addr = addr
        self.fmt: Format = Format()
        self.sid: int = 0
        self.of = OpenFiles()
        # lease-based attr/dentry cache in front of the do_* engine ops
        # (meta/cache.py). Disabled (TTL 0) until
        # configure_meta_cache — the default path is byte-identical to
        # the uncached engine. Every of.invalidate site (including the
        # ones inside engine transactions, e.g. a rename victim) also
        # drops the lease through this hook.
        self.lease = LeaseCache()
        self.of.on_invalidate = lambda ino: self.lease.invalidate_attr(ino)
        # per-tenant meta-op token buckets (--meta-op-limit)
        self.op_limiter: Optional[MetaOpLimiter] = None
        # checkpoint write plane (meta/wbatch.py): group-commit
        # write batching behind the same seam the lease cache fronts for
        # reads.  Disabled by default — every hook below is a single bool
        # check and the path stays byte-identical to an unbatched build
        # until configure_write_batch (mount --write-batch).
        self.wbatch = WriteBatcher(self)
        # meta-plane fault contract (meta/resilient.py):
        # classified retries + engine breaker + degraded mode over the
        # do_* seam.  INERT by default (nothing wrapped, zero overhead)
        # until configure_meta_retries (mount --meta-retries).
        self.resilience = MetaResilience(self)
        self._beat_failures = 0  # session-refresher failure streak
        self._statfs_last = None  # degraded statfs fallback
        self.msg_callbacks: dict[int, Callable] = {}
        self._lock = threading.Lock()
        # batched id allocation (reference base.go:946 freeID batching)
        self._free_inodes = _IDBatch()
        self._free_slices = _IDBatch()
        self._heartbeat: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # blocking-lock wait/wake: local unlocks wake waiters immediately;
        # remote unlocks are still caught by the poll cadence (the
        # reference polls too — redis_lock.go:86-88 sleeps 1ms then 10ms).
        # Per-inode [Condition, generation, n_waiters] triples; generation
        # is the lost-wake guard (a release between the EAGAIN and the
        # wait bumps it, so the waiter returns immediately).
        self._lock_waits: dict[int, list] = {}
        self._lock_waits_mu = threading.Lock()
        self._reload_cbs: list[Callable] = []  # config hot-reload hooks
        # push invalidation (reference pkg/vfs/vfs.go:1228
        # kernel invalidation + openfile invalidation protocol): mutations
        # buffer (kind, ...) events here; the session refresher publishes
        # them through the engine and fetches peers' events, fanning them
        # to on_invalidate subscribers (the VFS drops TTL caches and pokes
        # the kernel dcache). Purely an acceleration of the TTL contract —
        # a lost event still expires at the TTL.
        self._inval_buf: list[tuple] = []
        self._inval_mu = threading.Lock()
        self._inval_cbs: list[Callable] = []
        self._inval_seq = -1  # last peer sequence seen (-1 = from "now")
        # extra Session fields published at new_session time (cache-group
        # membership: cache_group / peer_addr / group_weight).
        # Set BEFORE new_session; peers read them from do_list_sessions.
        self.session_extras: dict = {}

    # -- abstract engine ops (reference base.go:51-125) --------------------
    def do_init(self, fmt: Format, force: bool) -> int: ...
    def do_load(self) -> Optional[bytes]: ...
    def do_new_session(self, info: Session) -> int: ...
    def do_refresh_session(self, sid: int) -> None: ...
    def do_clean_session(self, sid: int) -> None: ...
    def do_list_sessions(self) -> list[Session]: ...
    def do_reset(self) -> None: ...
    def do_new_inodes(self, n: int) -> int: ...
    def do_new_slices(self, n: int) -> int: ...
    def do_lookup(self, parent: int, name: bytes, hint_ino: int = 0) -> tuple[int, int, Attr]:
        """`hint_ino` is the lease cache's last-known child ino (0 = no
        hint): engines may speculatively batch its attr into the same
        round trip as the dentry read, revalidating against the live
        entry — a warm-but-expired lookup is then ONE round trip."""
        ...
    def do_getattr(self, ino: int) -> tuple[int, Attr]: ...
    def do_setattr(self, ctx, ino, flags, attr: Attr) -> tuple[int, Attr]: ...
    def do_mknod(self, ctx, parent, name, typ, mode, cumask, rdev, path,
                 ino: int = 0) -> tuple[int, int, Attr]:
        """``ino`` is a client-preallocated inode id (0 = allocate inside
        the call): the write batcher hands its acked, overlay-visible id
        through so the deferred engine txn commits the same inode the
        client has been using."""
        ...
    def do_unlink(self, ctx, parent, name, skip_trash=False) -> tuple[int, int]:
        """Returns (st, victim_ino); the victim is resolved inside the
        transaction so callers can invalidate caches race-free."""
        ...
    def do_rmdir(self, ctx, parent, name, skip_trash=False) -> int: ...
    def do_rename(self, ctx, psrc, nsrc, pdst, ndst, flags) -> tuple[int, int, Attr]: ...
    def do_link(self, ctx, ino, parent, name) -> tuple[int, Attr]: ...
    def do_readdir(self, ctx, ino, want_attr: bool) -> tuple[int, list[Entry]]: ...
    def do_readlink(self, ino) -> tuple[int, bytes]: ...
    def do_truncate(self, ctx, ino, length) -> tuple[int, Attr]: ...
    def do_fallocate(self, ctx, ino, mode, off, size) -> int: ...
    def do_read_chunk(self, ino, indx) -> tuple[int, list[Slice]]: ...
    def do_write_chunk(self, ino, indx, pos, slc: Slice, length_hint: int, incref: bool = False) -> int: ...
    def do_getxattr(self, ino, name) -> tuple[int, bytes]: ...
    def do_setxattr(self, ino, name, value, flags) -> int: ...
    def do_listxattr(self, ino) -> tuple[int, list[bytes]]: ...
    def do_removexattr(self, ino, name) -> int: ...
    def do_statfs(self) -> tuple[int, int, int, int]: ...
    def do_delete_sustained(self, sid: int, ino: int) -> None: ...
    def do_find_deleted_files(self, limit: int) -> dict[int, int]: ...
    def do_delete_file_data(self, ino: int, length: int) -> None: ...
    def do_list_slices(self) -> dict[int, list[Slice]]: ...
    def do_counter(self, name: str, delta: int = 0) -> int: ...

    # -- content-ref plane (inline ingest dedup) ------------------
    # R{digest} -> (canonical block, size, refcount) plus per-block alias
    # rows, kept by both engines (kv.py H/G keys, sql.py contentref/
    # contentalias tables). Each transition is ONE transaction so a writer
    # eliding a duplicate PUT (content_incref) and a deleter releasing the
    # final reference (content_decref -> "last") serialize instead of
    # racing: the loser of a decref-to-zero race simply misses the row and
    # uploads afresh. The plane is consumed by chunk/ingest.py (write),
    # CachedStore (read-miss alias resolution, delete decref) and
    # cmd/gc.py --dedup (offline backfill + refcount reconciliation).
    def content_incref(self, entries: list[tuple[bytes, int, int, int]]) -> list: ...
    def content_register(self, entries: list[tuple[bytes, int, int, int]]) -> list: ...
    def content_decref(self, pairs: list[tuple[int, int]]) -> list: ...
    def content_resolve(self, sid: int, indx: int) -> Optional[tuple[int, int, int]]: ...
    def scan_content_refs(self): ...
    def scan_content_aliases(self): ...
    def content_set_refs(self, digest: bytes, refs: int) -> None: ...
    def content_delete_aliases(self, pairs: list[tuple[int, int]]) -> None: ...

    # -- hot-content fingerprint persistence --------------------
    # Advisory snapshot of the ingest hot-content cache's (sampled-fp,
    # digest) pairs so a remount starts warm instead of re-hashing the
    # same hot blocks. Purely an optimization surface: engines without
    # support no-op, a stale or lost snapshot only costs hash work, and
    # the loader re-verifies every entry against live content refs before
    # trusting it.
    def set_hot_fingerprints(
        self, rows: list[tuple[bytes, bytes]]
    ) -> None:
        """Replace the persisted hot-content snapshot (fp32, digest32)."""

    def load_hot_fingerprints(self) -> list[tuple[bytes, bytes]]:
        """Return the persisted snapshot, MRU-first; [] when absent."""
        return []

    # -- lifecycle ---------------------------------------------------------
    def name(self) -> str:
        return "base"

    # -- lease cache / op throttle configuration -----------------
    def configure_meta_cache(self, attr_ttl: float = 0.0,
                             entry_ttl: float = 0.0,
                             neg_ttl: Optional[float] = None,
                             maxsize: int = 100_000) -> None:
        """Enable the lease-based attr/dentry cache (--attr-cache-ttl /
        --entry-cache-ttl).  TTL 0 disables a side entirely; an engine
        without the change feed is forced to TTL-0 passthrough — without
        even accelerated invalidation, remote staleness is served from
        the store, never from a lease."""
        if (attr_ttl > 0 or entry_ttl > 0) and not self.supports_inval_feed:
            logger.warning(
                "meta engine %s has no invalidation feed; lease cache "
                "stays in TTL-0 passthrough", self.name())
            attr_ttl = entry_ttl = 0.0
        self.lease = LeaseCache(attr_ttl, entry_ttl, neg_ttl, maxsize)
        # the fault contract may already be armed (re-configure path):
        # the fresh lease must keep its stale-candidate retention
        self.lease.keep_stale = (self.resilience.enabled
                                 and self.resilience.max_stale > 0)

    # -- meta-plane fault contract ------------------------------
    def configure_meta_retries(self, max_attempts: int = 5,
                               deadline: float = 15.0,
                               degraded_max_stale: float = 0.0,
                               attempt_timeout: Optional[float] = None,
                               **breaker_kw) -> None:
        """Arm the meta fault contract (mount ``--meta-retries`` /
        ``--meta-degraded-max-stale``): classified deadline-aware retries
        over the engine ``do_*`` seam, a per-engine circuit breaker with
        probe recovery, stale-lease degraded reads while open, and the
        heal chain (replica floor re-prime, session revive, wbatch
        replay).  ``max_attempts`` <= 0 keeps the contract INERT — the
        engine methods stay untouched, byte-identical to today."""
        if max_attempts <= 0:
            return
        self.resilience.configure(
            max_attempts=max_attempts, deadline=deadline,
            degraded_max_stale=degraded_max_stale,
            attempt_timeout=attempt_timeout, **breaker_kw)
        # expired leases are worth keeping only now that they can be
        # stale-served (cache.py drops them eagerly otherwise)
        self.lease.keep_stale = degraded_max_stale > 0

    def replica_available(self) -> bool:
        """True when the engine can serve guarded read transactions from
        a read replica (the breaker lets those pass while open)."""
        return False

    def engine_heal(self) -> None:
        """Engine hook fired on breaker heal; engines re-prime replica
        state here (redis re-reads the primary epoch floor)."""

    def _on_breaker_open(self) -> None:
        """Engine-connection breaker tripped: tell the engine so guarded
        reads stop dialing the dead primary (replica failover)."""
        client = getattr(self, "client", None)
        if client is not None and hasattr(client, "primary_down"):
            client.primary_down = True
        logger.warning("meta plane degraded: engine breaker open "
                       "(stale-lease reads%s, writes %s)",
                       " + replica failover" if self.replica_available()
                       else "",
                       "absorb into the write batch" if self.wbatch.enabled
                       else "fail fast EIO")

    def _on_meta_heal(self) -> None:
        """Breaker reset: the heal chain.  Order matters — the replica
        floor re-primes FIRST (a re-SYNCing replica must demote to the
        healed primary instead of serving pre-outage state as fresh),
        then the session revives (so the replayed wbatch groups commit
        under a live session), then the queued groups replay."""
        client = getattr(self, "client", None)
        if client is not None and hasattr(client, "primary_down"):
            client.primary_down = False
        try:
            self.engine_heal()
        except Exception as e:
            logger.warning("meta heal: engine hook failed: %s", e)
        self._heal_session()
        try:
            self.wbatch.replay_after_heal()
        except Exception as e:
            logger.warning("meta heal: wbatch replay failed: %s", e)

    def do_session_exists(self, sid: int) -> bool:
        """Engines report whether the session record survived (a primary
        blackout outlives the stale-session GC age for long outages)."""
        return True

    def do_revive_session(self, info: Session) -> None:
        """Re-register a reaped session under its ORIGINAL sid (sids are
        monotonic counter grants, never reused, so reviving cannot
        collide with a session another client registered meanwhile).
        The kv engines' update/refresh writes re-create both records;
        sql overrides with an INSERT."""
        self.do_update_session(info.sid, info)
        self.do_refresh_session(info.sid)

    def _heal_session(self) -> None:
        """After an outage, make sure this client's session record still
        exists — a blackout longer than the stale-session age lets a
        peer's GC reap it, and locks/sustained-inodes/cache-group
        discovery all key off it.  The inode prealloc ranges need no
        repair: they are monotonic counter grants a second client can
        never be handed again."""
        if not self.sid:
            return
        try:
            if self.do_session_exists(self.sid):
                return
            info = new_session_info(**self.session_extras)
            info.sid = self.sid
            self.do_revive_session(info)
            self.do_watch_unlocks()
            logger.warning("meta session %d re-registered after outage "
                           "(record was reaped)", self.sid)
        except Exception as e:
            logger.warning("meta session revive failed: %s", e)

    def _stale_attr(self, ino: int):
        """Degraded-mode attr: an EXPIRED lease within the configured
        staleness ceiling (None outside it / when not degraded)."""
        res = self.resilience
        if not res.degraded or res.max_stale <= 0:
            return None
        return self.lease.get_attr_stale(ino, res.max_stale)

    def configure_op_limit(self, ops_per_sec: float) -> None:
        """Per-tenant meta-op throttling (--meta-op-limit).  0 disables."""
        self.op_limiter = (MetaOpLimiter(ops_per_sec)
                           if ops_per_sec and ops_per_sec > 0 else None)

    # -- checkpoint write plane ---------------------------------
    def configure_write_batch(self, enabled: bool = True,
                              flush_ms: float = 3.0, max_batch: int = 0,
                              inode_prealloc: int = 1024) -> None:
        """Enable group-commit write batching (mount --write-batch /
        --wbatch-flush-ms).  Engines without nesting group transactions
        are forced off — a non-atomic "group" could commit partial state
        on a mid-group failure.  ``inode_prealloc`` widens the client's
        id range so a create burst pays ONE allocation txn for N ids."""
        self.wbatch.close()
        if enabled and not self.supports_group_txn:
            logger.warning(
                "meta engine %s has no group transaction support; write "
                "batching stays off (per-op passthrough)", self.name())
            enabled = False
        self.wbatch = WriteBatcher(self, enabled=enabled, flush_ms=flush_ms,
                                   max_batch=max_batch)
        if enabled:
            self._free_inodes.batch = max(self._free_inodes.batch,
                                          int(inode_prealloc))

    def group_txn(self, fn: Callable[[], int], ops=()) -> int:
        """Run ``fn`` (the write batcher's drain closure) inside ONE
        engine transaction; a nonzero return aborts it atomically.
        ``ops`` is the drained op list — engines may pre-warm the
        transaction's read set from it (kv batches every key the group
        will read into one MGET, so a 32-op group costs ~3 round trips
        instead of one per member).  Engines with ``supports_group_txn``
        override; the base fallback exists only for the forced-off path
        above."""
        return fn()

    def sync_meta(self, ino: int = 0) -> int:
        """fsync/flush barrier for the write batch: after this returns 0
        every acked mutation the call covers is durably committed; a
        deferred failure for ``ino`` surfaces here (sticky until close).
        With an inode the drain is SCOPED (only an implicated file
        drains — an fsync of an untouched file must not shatter other
        writers' groups); ino 0 is the full unmount/flush_all barrier."""
        if not self.wbatch.enabled:
            return 0
        if ino:
            return self.wbatch.fsync_barrier(ino)
        return self.wbatch.barrier()

    def _throttle(self, ctx) -> None:
        """Gate one meta op against the caller's tenant bucket: graceful
        queuing on the calling thread, never an error.  The tenant is the
        ambient QoS tenant when one is scoped (vfs ops tag the request
        uid), else the context uid."""
        lim = self.op_limiter
        if lim is None:
            return
        from ..qos import context as qctx

        amb = qctx.current()
        tenant = amb.tenant if amb is not None else getattr(ctx, "uid", 0)
        lim.acquire(tenant)

    def _attr_cached(self, ino: int) -> tuple[int, Optional[Attr]]:
        """Attr via the open-file and lease caches; a miss falls through
        to the engine and primes the lease.  With the lease cache
        disabled this IS `do_getattr` — the uncached path stays
        byte-identical to a build without the cache layer."""
        if self.wbatch.enabled:
            # this client's own pending creates are authoritative in the
            # overlay until the group commit lands
            a = self.wbatch.attr_overlay(ino)
            if a is not None:
                return 0, a
        if self.lease.enabled:
            attr = self.of.attr(ino)
            if attr is None:
                attr = self.lease.get_attr(ino)
            if attr is not None:
                return 0, attr
        # degraded mode: breaker open — an expired lease
        # within the staleness ceiling serves (stale-served, counted)
        # before any engine dial; past the ceiling the engine call fails
        # fast EIO rather than hanging the FUSE request path
        attr = self._stale_attr(ino)
        if attr is not None:
            return 0, attr
        try:
            st, attr = self.do_getattr(ino)
        except MetaUnavailableError as e:
            return e.errno, Attr()
        if st == 0:
            self.lease.put_attr(ino, attr)
        return st, attr

    def init(self, fmt: Format, force: bool = False) -> int:
        """Create/overwrite the volume format record (reference cmd/format.go)."""
        return self.do_init(fmt, force)

    def load(self, check_version: bool = True) -> Format:
        """Load Format JSON from the engine (reference base.go:317).

        check_version gates old clients off newer volumes (reference
        CheckVersion pkg/meta/config.go): a Format stamped with a higher
        meta_version than this client understands refuses to load.
        """
        data = self.do_load()
        if data is None:
            raise RuntimeError(f"database is not formatted: {self.addr}")
        fmt = Format.from_json(data)
        if check_version and fmt.meta_version > Format.meta_version:
            raise RuntimeError(
                f"volume meta version {fmt.meta_version} is newer than this "
                f"client supports ({Format.meta_version}); upgrade the client"
            )
        self.fmt = fmt
        self._fmt_raw = bytes(data) if isinstance(data, (bytes, bytearray)) else str(data)
        return self.fmt

    def on_reload(self, cb: Callable[[Format], None]) -> None:
        """Register a config hot-reload callback (reference OnReload
        interface.go:445, cmd/mount.go:662): fired from the session
        refresher when another client changes the volume Format (e.g.
        `juicefs-tpu config --trash-days N`)."""
        self._reload_cbs.append(cb)

    def _check_reload(self) -> None:
        data = self.do_load()
        if data is None:
            return
        raw = bytes(data) if isinstance(data, (bytes, bytearray)) else str(data)
        if raw == getattr(self, "_fmt_raw", None):
            return
        self._fmt_raw = raw  # don't re-log the same change every beat
        new_fmt = Format.from_json(data)
        if new_fmt.meta_version > Format.meta_version:
            # same gate as load(): never adopt a format newer than this
            # client understands (from_json drops fields it can't parse)
            logger.error(
                "volume upgraded to meta version %d (client supports %d); "
                "keeping the old config — restart with a newer client",
                new_fmt.meta_version, Format.meta_version,
            )
            return
        self.fmt = new_fmt
        logger.info("volume format reloaded")
        for cb in self._reload_cbs:
            try:
                cb(self.fmt)
            except Exception as e:
                logger.warning("reload callback failed: %s", e)

    def new_session(self, record: bool = True, heartbeat: float = 0.0) -> int:
        """Register a client session (reference base.go:371 NewSession)."""
        if record:
            self.sid = self.do_new_session(new_session_info(**self.session_extras))
            self.do_watch_unlocks()
            if heartbeat > 0:
                self.start_heartbeat(heartbeat)
        return self.sid

    def do_watch_unlocks(self) -> None:
        """Engines with a push channel subscribe to peers' unlock events so
        remote SETLKW waiters wake without polling (reference
        redis_lock.go wakes cross-client through the engine). Default:
        no push channel — the poll cadence covers."""

    def start_heartbeat(self, interval: float) -> None:
        """Refresh an (already set) session id periodically — also used
        after a seamless-upgrade takeover adopts the predecessor's sid
        (which skips new_session, so the unlock watcher is armed here
        too; engines make it idempotent)."""
        self.do_watch_unlocks()
        self._heartbeat = threading.Thread(
            target=self._session_refresher, args=(interval,), daemon=True
        )
        self._heartbeat.start()

    def update_session_info(self) -> None:
        """Re-publish this session's info record (same sid).  A takeover
        successor adopts the predecessor's sid WITHOUT new_session, so
        fields like the cache-group peer_addr would otherwise keep
        advertising the dead predecessor's endpoint forever."""
        if self.sid:
            info = new_session_info(**self.session_extras)
            info.sid = self.sid
            self.do_update_session(self.sid, info)

    def do_update_session(self, sid: int, info: Session) -> None:
        """Engines overwrite the stored session info; default no-op."""

    def close_session(self) -> None:
        self.wbatch.close()  # final drain: acked mutations never drop
        self.resilience.close()  # stop the breaker probe thread
        self._stop.set()
        hb = self._heartbeat
        if hb is not None and hb.is_alive() \
                and hb is not threading.current_thread():
            hb.join(timeout=10.0)  # _stop wakes the refresher immediately
            self._heartbeat = None
        if self.sid:
            self.do_clean_session(self.sid)
            self.sid = 0

    def _session_refresher(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.do_refresh_session(self.sid)
                if self._beat_failures:
                    # first beat after an outage: the session record may
                    # have been reaped while we were dark — revive it
                    # (same sid) before peers treat us as gone
                    self._beat_failures = 0
                    self._heal_session()
                self._check_reload()
                self._exchange_invalidations()
            except Exception as e:  # pragma: no cover - background resilience
                self._beat_failures += 1
                logger.warning("session refresh failed: %s", e)

    # -- push invalidation --------------------------------------------------
    def on_invalidate(self, cb: Callable[[list[tuple]], None]) -> None:
        """Subscribe to peers' change events: cb(events) with events a list
        of ("a", ino) attr / ("e", parent, name) dentry invalidations."""
        self._inval_cbs.append(cb)

    def off_invalidate(self, cb: Callable) -> None:
        """Unsubscribe (a closed VFS must not be poked by future beats)."""
        try:
            self._inval_cbs.remove(cb)
        except ValueError:
            pass

    # shared wire codec for the invalidation journal — one implementation
    # for every engine, so an event-format change cannot desynchronize them
    @staticmethod
    def _encode_inval_events(events: list[tuple]) -> str:
        import base64
        import json as _json

        return _json.dumps([
            [e[0], e[1]] if e[0] == "a"
            else [e[0], e[1], base64.b64encode(e[2]).decode()]
            for e in events
        ])

    @staticmethod
    def _decode_inval_events(raw) -> list[tuple]:
        import base64
        import json as _json

        out: list[tuple] = []
        try:
            for e in _json.loads(raw):
                if e[0] == "a":
                    out.append(("a", e[1]))
                else:
                    out.append(("e", e[1], base64.b64decode(e[2])))
        except (ValueError, IndexError, TypeError):
            pass
        return out

    def _note_change(self, *events: tuple) -> None:
        """Record local mutations for the next heartbeat's publish, and
        apply them to the local lease cache synchronously (write-through:
        every mutating op names its victims here, so read-your-own-writes
        holds regardless of lease TTLs). Publishing is a no-op until a
        session with callbacks-or-peers exists (tools that run without
        sessions pay nothing)."""
        if self.lease.enabled:
            for ev in events:
                if ev[0] == "a":
                    self.lease.invalidate_attr(ev[1])
                else:
                    self.lease.invalidate_entry(ev[1], ev[2])
        if not self.sid:
            return
        with self._inval_mu:
            self._inval_buf.extend(events)
            if len(self._inval_buf) > 10_000:  # runaway guard: TTL still heals
                del self._inval_buf[:5_000]

    def _exchange_invalidations(self) -> None:
        with self._inval_mu:
            batch, self._inval_buf = self._inval_buf, []
        if batch:
            # dedup: a busy writer notes the same ("a", ino) per chunk
            # write; peers would otherwise replay thousands of identical
            # kernel notifies per beat
            batch = list(dict.fromkeys(batch))
        if batch:
            try:
                self.do_publish_invalidations(self.sid, batch)
            except Exception as e:
                logger.warning("publish invalidations: %s", e)
        try:
            seq, events = self.do_fetch_invalidations(self._inval_seq, self.sid)
        except Exception as e:
            logger.warning("fetch invalidations: %s", e)
            return
        self._inval_seq = seq
        if events:
            for ev in events:
                kind = ev[0]
                if kind == "a":
                    self.of.invalidate(ev[1])  # also drops the attr lease
                elif kind == "e" and self.lease.enabled:
                    self.lease.invalidate_entry(ev[1], ev[2])
            for cb in self._inval_cbs:
                try:
                    cb(events)
                except Exception as e:
                    logger.warning("invalidate callback failed: %s", e)

    # engines may override; the default pair makes push invalidation an
    # optional capability (TTL expiry remains the correctness story)
    def do_publish_invalidations(self, sid: int, events: list[tuple]) -> None:
        pass

    def do_fetch_invalidations(self, since: int, exclude_sid: int) -> tuple[int, list[tuple]]:
        return since, []

    def on_msg(self, mtype: int, callback: Callable) -> None:
        """Register DELETE_SLICE / COMPACT_CHUNK callback
        (reference interface.go OnMsg, cmd/mount.go:271 registerMetaMsg)."""
        self.msg_callbacks[mtype] = callback

    def _notify(self, mtype: int, *args) -> None:
        cb = self.msg_callbacks.get(mtype)
        if cb is not None:
            cb(*args)

    def reset(self) -> None:
        self.do_reset()

    # -- permissions -------------------------------------------------------
    def access(self, ctx: Context, ino: int, mask: int, attr: Optional[Attr] = None) -> int:
        """POSIX rwx check (reference base.go Access)."""
        if ctx.uid == 0 or not ctx.check_permission:
            return 0
        if attr is None or not attr.full:
            st, attr = self._attr_cached(ino)
            if st:
                return st
        # extended ACL evaluation (reference base.go:871-880; skipped when
        # the group class is 000, mirroring the kernel's namei.c shortcut)
        if getattr(attr, "access_acl", 0) and attr.mode & 0o070:
            rule = self.do_load_acl(attr.access_acl)
            if rule is not None:
                gids = (ctx.gid,) + tuple(ctx.gids)
                if rule.can_access(ctx.uid, gids, attr.uid, attr.gid, mask):
                    return 0
                return errno.EACCES
        mode = self._access_mode(attr, ctx)
        if mode & mask != mask:
            return errno.EACCES
        return 0

    def do_load_acl(self, aid: int):
        """Interned ACL rule by id; engines without ACL support return None."""
        return None

    # -- blocking-lock wait/wake -------------------------------------------
    # Contended-waiter protocol: snapshot lock_generation(ino) BEFORE the
    # setlk/flock attempt; on EAGAIN call lock_wait(ino, timeout, gen) —
    # it returns as soon as a local unlock on that inode bumps the
    # generation (even if the bump happened before the wait started), or
    # after the poll interval for remote unlocks.

    def lock_generation(self, ino: int) -> int:
        with self._lock_waits_mu:
            entry = self._lock_waits.get(ino)
            if entry is None:
                entry = self._lock_waits[ino] = [threading.Condition(), 0, 0]
            return entry[1]

    def lock_wait(self, ino: int, timeout: float, gen: int = -1) -> None:
        """Park a blocked SETLKW/flock waiter until a local unlock on this
        inode fires (generation != gen) or the poll interval elapses."""
        with self._lock_waits_mu:
            entry = self._lock_waits.get(ino)
            if entry is None:
                entry = self._lock_waits[ino] = [threading.Condition(), 0, 0]
            entry[2] += 1
        cond = entry[0]
        try:
            with cond:
                if gen >= 0 and entry[1] != gen:
                    return  # release already happened: don't sleep
                cond.wait(timeout)
        finally:
            with self._lock_waits_mu:
                entry[2] -= 1
                if entry[2] <= 0:
                    self._lock_waits.pop(ino, None)

    def lock_released(self, ino: int) -> None:
        """Wake this inode's local waiters after an unlock (engines call
        this; waiters re-contend through the normal setlk/flock path, so a
        spurious wake is harmless)."""
        with self._lock_waits_mu:
            entry = self._lock_waits.get(ino)
            if entry is None:
                return
        with entry[0]:
            entry[1] += 1
            entry[0].notify_all()

    # -- POSIX ACLs (reference base.go:2757-2788 SetFacl/GetFacl) ----------
    def set_facl(self, ctx: Context, ino: int, acl_type: int, rule) -> int:
        st = self.do_set_facl(ctx, ino, acl_type, rule)
        if st == 0:
            self.of.invalidate(ino)
            self._note_change(("a", ino))
        return st

    def get_facl(self, ctx: Context, ino: int, acl_type: int):
        """-> (errno, Rule|None); ENODATA when the inode has no such ACL."""
        return self.do_get_facl(ino, acl_type)

    def do_set_facl(self, ctx: Context, ino: int, acl_type: int, rule) -> int:
        return errno.ENOTSUP

    def do_get_facl(self, ino: int, acl_type: int):
        return errno.ENOTSUP, None

    @staticmethod
    def _access_mode(attr: Attr, ctx: Context) -> int:
        if ctx.uid == 0:
            return 7
        if ctx.uid == attr.uid:
            return (attr.mode >> 6) & 7
        if ctx.contains_gid(attr.gid):
            return (attr.mode >> 3) & 7
        return attr.mode & 7

    @staticmethod
    def check_name(name: bytes) -> int:
        if len(name) == 0:
            return errno.EINVAL
        if len(name) > MAX_NAME_LEN:
            return errno.ENAMETOOLONG
        return 0

    # -- namespace ops -----------------------------------------------------
    def lookup(self, ctx: Context, parent: int, name: bytes) -> tuple[int, int, Attr]:
        self._throttle(ctx)
        if name == b"..":
            st, pattr = self._attr_cached(parent)
            if st:
                return st, 0, Attr()
            if pattr.typ != TYPE_DIRECTORY:
                return errno.ENOTDIR, 0, Attr()
            st, gattr = self._attr_cached(pattr.parent)
            return st, pattr.parent, gattr
        if name == b".":
            st, attr = self._attr_cached(parent)
            return st, parent, attr
        st = self.access(ctx, parent, MODE_MASK_X)
        if st:
            return st, 0, Attr()
        if self.wbatch.enabled:
            # pending-create overlay: a batched create is visible to its
            # own client before the group commit lands
            oino = self.wbatch.entry_overlay(parent, name)
            if oino:
                oattr = self.wbatch.attr_overlay(oino)
                if oattr is not None:
                    return 0, oino, oattr
        # lease-cache fast path: a live dentry + attr lease serves the
        # whole lookup with zero engine round trips (the dataloader's
        # stat/open-shuffled-shards hot path)
        hit = self.lease.get_entry(parent, name)
        if hit is not None:
            if hit == LeaseCache.NEGATIVE:
                return errno.ENOENT, 0, Attr()
            st, attr = self._attr_cached(hit)
            if st == 0:
                return 0, hit, attr
            # dangling lease (inode vanished under the dentry): drop and
            # revalidate through the engine
            self.lease.invalidate_entry(parent, name)
        if self.resilience.degraded:
            # degraded lookup: an expired positive dentry
            # within the stale ceiling serves (negatives never stale-
            # serve — a stale ENOENT could hide a real file for the
            # whole outage); a miss falls through to the engine, which
            # either fails over to the replica or fails fast EIO
            sino = self.lease.get_entry_stale(parent, name,
                                              self.resilience.max_stale)
            if sino:
                st, attr = self._attr_cached(sino)
                if st == 0:
                    return 0, sino, attr
        try:
            st, ino, attr = self.do_lookup(
                parent, name, hint_ino=self.lease.entry_hint(parent, name))
        except MetaUnavailableError as e:
            return e.errno, 0, Attr()
        if st:
            if st == errno.ENOENT:
                self.lease.put_negative(parent, name)
            return st, 0, Attr()
        self.lease.put_entry(parent, name, ino)
        self.lease.put_attr(ino, attr)
        return 0, ino, attr

    def resolve(self, ctx: Context, path: str) -> tuple[int, int, Attr]:
        """Walk an absolute path from root (reference pkg/fs path walk)."""
        ino = ROOT_INODE
        st, attr = self._attr_cached(ino)
        if st:
            return st, 0, Attr()
        for part in path.strip("/").split("/"):
            if not part:
                continue
            st, ino, attr = self.lookup(ctx, ino, part.encode())
            if st:
                return st, 0, Attr()
        return 0, ino, attr

    def getattr(self, ctx: Context, ino: int) -> tuple[int, Attr]:
        self._throttle(ctx)
        if self.wbatch.enabled:
            a = self.wbatch.attr_overlay(ino)
            if a is not None:
                return 0, a
            # non-overlay inode with deferred commits: a stat must see
            # the committed state (dependent read = barrier)
            self.wbatch.barrier_if(ino)
        cached = self.of.attr(ino)
        if cached is not None:
            return 0, cached
        cached = self.lease.get_attr(ino)
        if cached is not None:
            return 0, cached
        cached = self._stale_attr(ino)  # degraded: bounded stale serve
        if cached is not None:
            return 0, cached
        try:
            st, attr = self.do_getattr(ino)
        except MetaUnavailableError as e:
            return e.errno, Attr()
        if st == 0:
            # of.update only on a REAL fetch: refreshing the open-file
            # TTL from a lease hit would extend its staleness bound
            # beyond the openfile contract
            self.of.update(ino, attr)
            self.lease.put_attr(ino, attr)
        return st, attr

    def setattr(self, ctx: Context, ino: int, flags: int, attr: Attr) -> tuple[int, Attr]:
        self._throttle(ctx)
        cur = self.wbatch.attr_overlay(ino) if self.wbatch.enabled else None
        if cur is None:
            st, cur = self.do_getattr(ino)
            if st:
                return st, Attr()
        if flags & SET_ATTR_SIZE:
            # FUSE truncate-via-setattr path (reference base.go SetAttr)
            st, out = self.truncate(ctx, ino, attr.length)
            if st:
                return st, Attr()
            flags &= ~SET_ATTR_SIZE
            if flags == 0:
                return 0, out
            cur = out
        if ctx.uid != 0 and ctx.check_permission:
            if flags & SET_ATTR_MODE and ctx.uid != cur.uid:
                return errno.EPERM, Attr()
            if flags & SET_ATTR_UID and (ctx.uid != cur.uid or attr.uid != cur.uid):
                return errno.EPERM, Attr()
            if flags & SET_ATTR_GID:
                if ctx.uid != cur.uid:
                    return errno.EPERM, Attr()
                if attr.gid != cur.gid and not ctx.contains_gid(attr.gid):
                    return errno.EPERM, Attr()
        if self.wbatch.enabled:
            batched = self.wbatch.submit_setattr(ctx, ino, flags, attr)
            if batched is not None:
                # local invalidation at ack (of.invalidate drops the
                # lease too); the peer event publishes at drain
                self.of.invalidate(ino)
                return batched
            # not this client's pending create: a deferred commit on the
            # inode must land before the engine mutates it
            self.wbatch.barrier_if(ino)
        st, out = self.do_setattr(ctx, ino, flags, attr)
        if st == 0:
            self.of.invalidate(ino)
            self._note_change(("a", ino))
        return st, out

    def mknod(
        self,
        ctx: Context,
        parent: int,
        name: bytes,
        typ: int,
        mode: int,
        cumask: int = 0,
        rdev: int = 0,
        path: bytes = b"",
    ) -> tuple[int, int, Attr]:
        self._throttle(ctx)
        st = self.check_name(name)
        if st:
            return st, 0, Attr()
        if typ == TYPE_SYMLINK and len(path) > MAX_SYMLINK_LEN:
            return errno.ENAMETOOLONG, 0, Attr()
        st = self.access(ctx, parent, MODE_MASK_W | MODE_MASK_X)
        if st:
            return st, 0, Attr()
        if self.wbatch.enabled:
            out = self.wbatch.submit_mknod(ctx, parent, name, typ, mode,
                                           cumask, rdev, path)
            if out is not None:
                if out[0] == 0:
                    # LOCAL write-through at ack time: this client's
                    # lease drops the parent dentry/attr (a cached
                    # negative must die the moment its create is acked).
                    # PEER events publish at drain, post-commit — an
                    # ack-time publish could let a peer refetch and
                    # cache pre-commit state no later event heals.
                    if self.lease.enabled:
                        self.lease.invalidate_entry(parent, bytes(name))
                        self.lease.invalidate_attr(parent)
                return out
            self.wbatch.note_passthrough()
            # shed/declined: pending state this op depends on (a queued
            # same-name create, the parent's pending mutations) must land
            # before the engine sees it — passthrough never reorders
            self.wbatch.barrier_if_entry(parent, name)
        out = self.do_mknod(ctx, parent, name, typ, mode, cumask, rdev, path)
        if out[0] == 0:
            self._note_change(("e", parent, bytes(name)), ("a", parent))
        return out

    def mkdir(self, ctx, parent, name, mode, cumask=0) -> tuple[int, int, Attr]:
        return self.mknod(ctx, parent, name, TYPE_DIRECTORY, mode, cumask)

    def create(self, ctx, parent, name, mode, cumask=0, flags=0) -> tuple[int, int, Attr]:
        st, ino, attr = self.mknod(ctx, parent, name, TYPE_FILE, mode, cumask)
        if st == errno.EEXIST and not flags & os.O_EXCL:
            st, ino, attr = self.lookup(ctx, parent, name)
            if st == 0 and attr.typ != TYPE_FILE:
                return errno.EISDIR if attr.typ == TYPE_DIRECTORY else errno.EEXIST, 0, Attr()
        if st == 0:
            self.of.open(ino, attr)
        return st, ino, attr

    def symlink(self, ctx, parent, name, target: bytes) -> tuple[int, int, Attr]:
        return self.mknod(ctx, parent, name, TYPE_SYMLINK, 0o777, 0, 0, target)

    def readlink(self, ctx, ino) -> tuple[int, bytes]:
        if self.wbatch.enabled:
            self.wbatch.barrier_if(ino)  # the symlink may be pending
        return self.do_readlink(ino)

    def unlink(self, ctx, parent, name, skip_trash=False) -> int:
        self._throttle(ctx)
        st = self.check_name(name)
        if st:
            return st
        st = self.access(ctx, parent, MODE_MASK_W | MODE_MASK_X)
        if st:
            return st
        if self.wbatch.enabled:
            # the victim may be a pending create (or sit in a parent with
            # pending creates): dependent cross-inode op = barrier
            self.wbatch.barrier_if_entry(parent, name)
        st, ino = self.do_unlink(ctx, parent, name, skip_trash)
        if st == 0:
            if ino:
                # the victim's nlink/ctime changed: a hardlink sibling
                # must not keep serving its open-file cached attr
                self.of.invalidate(ino)
            # the victim's ("a", ino) rides along so peers drop hardlink
            # siblings' attr leases too, not just the dentry
            self._note_change(("e", parent, bytes(name)), ("a", parent),
                              *((("a", ino),) if ino else ()))
        return st

    def rmdir(self, ctx, parent, name, skip_trash=False) -> int:
        self._throttle(ctx)
        if name == b"." :
            return errno.EINVAL
        if name == b"..":
            return errno.ENOTEMPTY
        st = self.access(ctx, parent, MODE_MASK_W | MODE_MASK_X)
        if st:
            return st
        if self.wbatch.enabled and self.wbatch.has_pending():
            # the doomed dir's emptiness check must see pending creates
            # INSIDE it (victim ino unknown here): conservative full drain
            self.wbatch.barrier()
        st = self.do_rmdir(ctx, parent, name, skip_trash)
        if st == 0:
            self._note_change(("e", parent, bytes(name)), ("a", parent))
        return st

    def rename(self, ctx, psrc, nsrc, pdst, ndst, flags=0) -> tuple[int, int, Attr]:
        self._throttle(ctx)
        st = self.check_name(ndst)
        if st:
            return st, 0, Attr()
        st = self.access(ctx, psrc, MODE_MASK_W | MODE_MASK_X)
        if st:
            return st, 0, Attr()
        st = self.access(ctx, pdst, MODE_MASK_W | MODE_MASK_X)
        if st:
            return st, 0, Attr()
        # a replaced/exchanged destination's open-file cached attr is
        # invalidated by the engine itself (victim resolved inside the
        # rename transaction, so concurrent renames cannot desync it)
        if self.wbatch.enabled:
            # BARRIER op: the rename rides as the TAIL of the
            # drained group — every pending op (the shard's create and
            # slice commits) lands in the SAME engine transaction ahead
            # of it, and concurrent renames coalesce under one leader
            out = self.wbatch.run_sync(
                lambda: self.do_rename(ctx, psrc, nsrc, pdst, ndst, flags),
                parent=psrc, kind="rename",
                args=(psrc, bytes(nsrc), pdst, bytes(ndst)))
            if isinstance(out, int):
                # the drain settled this sync op with a bare errno (the
                # engine raised — e.g. breaker-open EIO during an
                # outage): normalize to the rename result shape
                st, ino, attr = out, 0, Attr()
            else:
                st, ino, attr = out
        else:
            st, ino, attr = self.do_rename(ctx, psrc, nsrc, pdst, ndst, flags)
        if st == 0:
            self.of.invalidate(ino)
            self._note_change(
                ("e", psrc, bytes(nsrc)), ("e", pdst, bytes(ndst)),
                ("a", ino), ("a", psrc), ("a", pdst),
            )
        return st, ino, attr

    def link(self, ctx, ino, parent, name) -> tuple[int, Attr]:
        self._throttle(ctx)
        st = self.check_name(name)
        if st:
            return st, Attr()
        st = self.access(ctx, parent, MODE_MASK_W | MODE_MASK_X)
        if st:
            return st, Attr()
        if self.wbatch.enabled:
            self.wbatch.barrier_if(ino)  # link target may be pending
            self.wbatch.barrier_if_entry(parent, name)
        st, attr = self.do_link(ctx, ino, parent, name)
        if st == 0:
            self.of.invalidate(ino)
            self._note_change(("e", parent, bytes(name)), ("a", ino), ("a", parent))
        return st, attr

    def readdir(self, ctx, ino, want_attr: bool = False) -> tuple[int, list[Entry]]:
        self._throttle(ctx)
        st = self.access(ctx, ino, MODE_MASK_R)
        if st:
            return st, []
        if self.wbatch.enabled:
            # a listing must include this client's pending creates (the
            # dir itself may even BE one): dependent read = barrier
            self.wbatch.barrier_if(ino)
        st, entries = self.do_readdir(ctx, ino, want_attr)
        if st:
            return st, []
        if want_attr and self.lease.enabled:
            # readdirplus primes attr AND dentry leases: the
            # stat-after-list pattern (every dataloader epoch) then
            # serves from the cache — and during a meta outage the
            # dentry lease is what lets a listed name still RESOLVE
            # (the attr alone cannot be reached without it;
            # found live in the blackout mount drive)
            for e in entries:
                if e.attr.full:
                    self.lease.put_attr(e.inode, e.attr)
                    self.lease.put_entry(ino, e.name, e.inode)
        st2, attr = self._attr_cached(ino)
        if st2 == 0:
            entries.insert(0, Entry(inode=ino, name=b".", attr=attr))
            st3, pattr = self._attr_cached(attr.parent or ino)
            entries.insert(
                1, Entry(inode=attr.parent or ino, name=b"..", attr=pattr if st3 == 0 else Attr(typ=TYPE_DIRECTORY))
            )
        return 0, entries

    # -- open-file lifecycle ----------------------------------------------
    def open(self, ctx, ino, flags) -> tuple[int, Attr]:
        self._throttle(ctx)
        # open() is the openfile cache's revalidation point: of.open's
        # content-change detection (mtime/length vs the cached attr)
        # drops stale chunk lists, so it must see a REAL fetch — a
        # lease-served attr here would hide a peer's write for the lease
        # TTL *plus* the openfile expire window.  A pending create in the
        # OVERLAY is exempt: it cannot exist remotely before its group
        # commit, so this client's ack attr is the whole truth.
        attr = self.wbatch.attr_overlay(ino) if self.wbatch.enabled else None
        stale_served = False
        if attr is None:
            if self.wbatch.enabled:
                self.wbatch.barrier_if(ino)
            try:
                st, attr = self.do_getattr(ino)
            except MetaUnavailableError as e:
                # degraded open: the revalidation fetch is
                # impossible while the breaker is open — a bounded stale
                # lease keeps the dataloader's open() path serving (the
                # staleness ceiling the operator chose), else EIO.  The
                # stale attr must NOT re-prime the lease OR the openfile
                # cache: either would re-serve it as fresh, uncounted
                # and past the configured bound.
                attr = self._stale_attr(ino)
                if attr is None:
                    return e.errno, Attr()
                stale_served = True
            else:
                if st:
                    return st, Attr()
                self.lease.put_attr(ino, attr)
        if attr.typ != TYPE_FILE:
            return errno.EPERM, Attr()
        if ctx.check_permission:
            mask = 0
            accmode = flags & os.O_ACCMODE
            if accmode in (os.O_RDONLY, os.O_RDWR):
                mask |= MODE_MASK_R
            if accmode in (os.O_WRONLY, os.O_RDWR):
                mask |= MODE_MASK_W
            st = self.access(ctx, ino, mask, attr)
            if st:
                return st, Attr()
        self.of.open(ino, attr, trusted=not stale_served)
        return 0, attr

    def close(self, ctx, ino) -> int:
        st = 0
        last = self.of.close(ino)
        if self.wbatch.enabled:
            # close is a barrier for THIS inode: drain if it's implicated
            # and surface its sticky deferred error — cleared only on the
            # LAST close (an earlier handle's release, whose error the
            # kernel ignores, must not swallow what a still-open write
            # handle's later fsync has to report)
            st = self.wbatch.close_barrier(ino, last)
        if last:
            # last close: if unlinked while open, data can now be reclaimed
            if self.sid:
                self.do_delete_sustained(self.sid, ino)
        return st

    # -- file data ---------------------------------------------------------
    def new_slice(self) -> int:
        """Allocate a globally-unique slice id (reference base.go NewSlice)."""
        return self._free_slices.next(self.do_new_slices)

    def new_inode(self) -> int:
        return self._free_inodes.next(self.do_new_inodes)

    def read_chunk(self, ino: int, indx: int) -> tuple[int, list[Slice]]:
        if self.wbatch.enabled:
            # deferred slice commits must land before a chunk read (the
            # same client's read-after-flush path): dependent read barrier
            self.wbatch.barrier_if(ino)
        cached = self.of.chunk(ino, indx)
        if cached is not None:
            return 0, cached
        st, slices = self.do_read_chunk(ino, indx)
        if st == 0:
            self.of.cache_chunk(ino, indx, slices)
        return st, slices

    def read_chunks(self, ino: int,
                    indxs: list[int]) -> list[tuple[int, list[Slice]]]:
        """Batched chunk reads: the readahead planner walks a
        whole window in ONE engine round trip instead of one per chunk.
        Open-file-cached chunks are served locally; only the misses hit
        `do_read_chunks` (engines may override with a single txn)."""
        if self.wbatch.enabled:
            self.wbatch.barrier_if(ino)
        out: dict[int, tuple[int, list[Slice]]] = {}
        misses: list[int] = []
        for indx in indxs:
            cached = self.of.chunk(ino, indx)
            if cached is not None:
                out[indx] = (0, cached)
            else:
                misses.append(indx)
        if misses:
            for indx, (st, slices) in zip(
                    misses, self.do_read_chunks(ino, misses)):
                if st == 0:
                    self.of.cache_chunk(ino, indx, slices)
                out[indx] = (st, slices)
        return [out[i] for i in indxs]

    def do_read_chunks(self, ino: int,
                       indxs: list[int]) -> list[tuple[int, list[Slice]]]:
        """Engine hook for batched chunk reads; the default loops
        do_read_chunk (kv overrides with one MGET txn)."""
        return [self.do_read_chunk(ino, i) for i in indxs]

    def write_chunk(self, ino: int, indx: int, pos: int, slc: Slice) -> int:
        if indx < 0 or pos + slc.len > CHUNK_SIZE:
            return errno.EINVAL
        if self.wbatch.enabled:
            st = self.wbatch.submit_write_chunk(ino, indx, pos, slc)
            if st is not None:
                # local invalidation at ack; the peer event publishes at
                # drain, post-commit (see mknod above)
                self.of.invalidate(ino)
                return st
            self.wbatch.note_passthrough()
            # shed: the file's queued create/commits must land before the
            # engine commit, or it would fail ENOENT on a healthy file
            self.wbatch.barrier_if(ino)
        st = self.do_write_chunk(ino, indx, pos, slc, indx * CHUNK_SIZE + pos + slc.len)
        self.of.invalidate(ino)  # cached attr (length/mtime) and chunks are stale
        if st == 0:
            self._note_change(("a", ino))
        return st

    def truncate(self, ctx, ino, length, skip_perm=False) -> tuple[int, Attr]:
        if self.wbatch.enabled:
            self.wbatch.barrier_if(ino)
        if not skip_perm:
            st, attr = self.do_getattr(ino)
            if st:
                return st, Attr()
            if attr.typ == TYPE_DIRECTORY:
                return errno.EISDIR, Attr()  # truncate(2) on a directory
            st = self.access(ctx, ino, MODE_MASK_W, attr)
            if st:
                return st, Attr()
        st, attr = self.do_truncate(ctx, ino, length)
        if st == 0:
            self.of.invalidate(ino)
            self._note_change(("a", ino))
        return st, attr

    def fallocate(self, ctx, ino, mode, off, size) -> int:
        if off < 0 or size <= 0:
            return errno.EINVAL
        if self.wbatch.enabled:
            self.wbatch.barrier_if(ino)
        st = self.do_fallocate(ctx, ino, mode, off, size)
        if st == 0:
            self.of.invalidate(ino)
            self._note_change(("a", ino))
        return st

    def copy_file_range(
        self, ctx, fin, offin, fout, offout, size, flags
    ) -> tuple[int, int]:
        """Server-side copy by sharing slice references
        (reference base.go CopyFileRange)."""
        if flags:
            return errno.EINVAL, 0
        if self.wbatch.enabled:
            self.wbatch.barrier_if(fin, fout)
        st, attr = self.do_getattr(fin)
        if st:
            return st, 0
        if offin >= attr.length:
            return 0, 0
        size = min(size, attr.length - offin)
        copied = 0
        wrote = False

        def _done(st: int):
            if copied or wrote:
                # do_write_chunk was called directly (not via write_chunk):
                # the destination's caches are invalidated on EVERY exit
                # that mutated it, including partial-failure returns
                self.of.invalidate(fout)
                self._note_change(("a", fout))
            return st, copied

        while copied < size:
            indx = (offin + copied) // CHUNK_SIZE
            pos = (offin + copied) % CHUNK_SIZE
            n = min(CHUNK_SIZE - pos, size - copied)
            st, slices = self.do_read_chunk(fin, indx)
            if st:
                return _done(st)
            from .slice import build_slice

            view = build_slice(slices)
            dindx = (offout + copied) // CHUNK_SIZE
            dpos = (offout + copied) % CHUNK_SIZE
            if dpos + n > CHUNK_SIZE:
                n = CHUNK_SIZE - dpos
            cur = pos
            end = pos + n
            for seg in view:
                s0 = max(seg.pos, cur)
                s1 = min(seg.pos + seg.len, end)
                if s1 <= s0:
                    continue
                new = Slice(
                    pos=dpos + (s0 - pos),
                    id=seg.id,
                    size=seg.size,
                    off=seg.off + (s0 - seg.pos),
                    len=s1 - s0,
                )
                # incref: destination shares the source's stored slice
                st = self.do_write_chunk(
                    fout, dindx, new.pos, new,
                    dindx * CHUNK_SIZE + new.pos + new.len, incref=True,
                )
                if st:
                    return _done(st)
                wrote = True
                cur = s1
            if cur < end:  # trailing hole
                hole = Slice(pos=dpos + (cur - pos), id=0, size=end - cur, off=0, len=end - cur)
                st = self.do_write_chunk(fout, dindx, hole.pos, hole, dindx * CHUNK_SIZE + hole.pos + hole.len)
                if st:
                    return _done(st)
                wrote = True
            copied += n
        return _done(0)

    # -- xattr -------------------------------------------------------------
    def getxattr(self, ctx, ino, name: bytes) -> tuple[int, bytes]:
        if self.wbatch.enabled:
            self.wbatch.barrier_if(ino)  # the inode may be a pending create
        return self.do_getxattr(ino, name)

    def setxattr(self, ctx, ino, name: bytes, value: bytes, flags: int = 0) -> int:
        if not name:
            return errno.EINVAL
        if self.wbatch.enabled:
            self.wbatch.barrier_if(ino)
        st = self.do_setxattr(ino, name, value, flags)
        if st == 0:
            self.lease.invalidate_attr(ino)  # ctime moved
        return st

    def listxattr(self, ctx, ino) -> tuple[int, list[bytes]]:
        if self.wbatch.enabled:
            self.wbatch.barrier_if(ino)
        return self.do_listxattr(ino)

    def removexattr(self, ctx, ino, name: bytes) -> int:
        if self.wbatch.enabled:
            self.wbatch.barrier_if(ino)
        st = self.do_removexattr(ino, name)
        if st == 0:
            self.lease.invalidate_attr(ino)
        return st

    # -- admin / tools -----------------------------------------------------
    def statfs(self, ctx) -> tuple[int, int, int, int]:
        """(total_bytes, avail_bytes, used_inodes, avail_inodes)
        (reference base.go StatFS).

        Degraded fallback: statfs is the liveness probe of the
        world around the mount — `df`, shell path walks, and the mount
        WATCHDOG's statvfs loop.  During a meta outage the last-known
        answer serves (usage counters are already approximate), or a
        120s blackout would make the watchdog shoot a mount that is
        successfully serving degraded reads."""
        try:
            out = self.do_statfs()
        except MetaUnavailableError:
            if self._statfs_last is not None:
                return self._statfs_last
            raise
        self._statfs_last = out
        return out

    def summary(self, ctx, ino: int) -> tuple[int, Summary]:
        """du aggregate over a subtree (reference base.go GetSummary)."""
        if self.wbatch.enabled and self.wbatch.has_pending():
            self.wbatch.barrier()  # the walk reads engine state directly
        st, attr = self.do_getattr(ino)
        if st:
            return st, Summary()
        s = Summary()
        self._summarize(ctx, ino, attr, s)
        return 0, s

    def _summarize(self, ctx, ino, attr, s: Summary) -> None:
        # iterative: no Python recursion limit on deep trees
        stack = [(ino, attr)]
        while stack:
            cino, cattr = stack.pop()
            if cattr.typ == TYPE_DIRECTORY:
                s.dirs += 1
                s.size += 4096
                st, entries = self.do_readdir(ctx, cino, True)
                if st:
                    continue
                stack.extend((e.inode, e.attr) for e in entries)
            else:
                s.files += 1
                s.length += cattr.length
                s.size += (cattr.length + 4095) // 4096 * 4096

    @staticmethod
    def _is_ancestor(get_attr, anc: int, start: int) -> bool:
        """True when `anc` is `start` or an ancestor of it, walking parent
        pointers to the root.  `get_attr` is the engine's in-transaction
        attr fetch; the walk stops on orphaned or self-parented nodes.
        Shared by both rename cycle checks (a dir must not move under its
        own subtree, nor be exchanged under one of its descendants)."""
        p = start
        while p and p != ROOT_INODE:
            if p == anc:
                return True
            pa = get_attr(p)
            if pa is None or pa.parent == p:
                break
            p = pa.parent
        return False

    def remove_recursive(self, ctx, parent: int, name: bytes, skip_trash=False) -> tuple[int, int]:
        """rmr: post-order delete, iterative so arbitrarily deep trees cannot
        exhaust the Python stack (reference base.go Remove / cmd rmr)."""
        if self.wbatch.enabled and self.wbatch.has_pending():
            self.wbatch.barrier()  # bulk walk reads engine state directly
        st, ino, attr = self.lookup(ctx, parent, name)
        if st:
            return st, 0
        removed = 0
        if attr.typ != TYPE_DIRECTORY:
            st, vino = self.do_unlink(ctx, parent, name, skip_trash)
            if st == 0:
                if vino:
                    self.of.invalidate(vino)
                self._note_change(("e", parent, bytes(name)), ("a", parent))
            return st, (1 if st == 0 else 0)
        # stack holds (parent, name, ino, expanded); a dir is deleted only
        # after its expanded children have been processed
        stack: list[tuple[int, bytes, int, bool]] = [(parent, name, ino, False)]
        while stack:
            p, n, i, expanded = stack.pop()
            if expanded:
                st = self.do_rmdir(ctx, p, n, skip_trash)
                if st:
                    return st, removed
                self._note_change(("e", p, bytes(n)), ("a", p))
                removed += 1
                continue
            stack.append((p, n, i, True))
            st, entries = self.do_readdir(ctx, i, True)
            if st:
                return st, removed
            for e in entries:
                if e.attr.typ == TYPE_DIRECTORY:
                    stack.append((i, e.name, e.inode, False))
                else:
                    st, vino = self.do_unlink(ctx, i, e.name, skip_trash)
                    if st:
                        return st, removed
                    if vino:
                        self.of.invalidate(vino)
                    self._note_change(("e", i, bytes(e.name)), ("a", i))
                    removed += 1
        return 0, removed

    def get_paths(self, ino: int) -> list[str]:
        """Reverse-resolve inode to path(s) (reference base.go GetPaths)."""
        if ino == ROOT_INODE:
            return ["/"]
        st, attr = self.do_getattr(ino)
        if st:
            return []
        paths: list[str] = []
        if attr.parent:
            st, entries = self.do_readdir(Context(check_permission=False), attr.parent, False)
            if st == 0:
                for e in entries:
                    if e.inode == ino:
                        for p in self.get_paths(attr.parent) or []:
                            paths.append(p.rstrip("/") + "/" + e.name.decode("utf-8", "replace"))
        return paths

    # -- background cleanup ------------------------------------------------
    def cleanup_deleted_files(self, limit: int = 1000) -> int:
        """Reclaim data of files whose last link was removed
        (reference base.go cleanupDeletedFiles / doDeleteFileData)."""
        files = self.do_find_deleted_files(limit)
        for ino, length in files.items():
            self.do_delete_file_data(ino, length)
        return len(files)

    def compact_commit(self, ino: int, indx: int, snapshot: bytes,
                       merged: Slice) -> int:
        """Commit a chunk compaction (vfs/compact.py) — the one engine
        write the background compactor issues, fronted here so the fault
        guard and the wbatch dependent-write barrier cover it
        (meta-resilience-seam: no bare ``do_*`` from vfs/)."""
        if self.wbatch.enabled:
            self.wbatch.barrier_if(ino)
        return self.do_compact_chunk(ino, indx, snapshot, merged)

    def do_compact_chunk(self, ino: int, indx: int, snapshot: bytes,
                         merged: Slice) -> int:
        return errno.ENOTSUP

    def list_slices(self) -> dict[int, list[Slice]]:
        """All live slices keyed by inode, for gc/fsck
        (reference interface.go ListSlices)."""
        return self.do_list_slices()

    def used_space(self) -> int:
        return self.do_counter("usedSpace")

    def used_inodes(self) -> int:
        return self.do_counter("totalInodes")

    def cleanup_trash_before(self, ts: float) -> int:
        """Purge trash subdirectories older than `ts`
        (reference base.go:2281 CleanupTrashBefore)."""
        import calendar

        removed = 0
        st, entries = self.do_readdir(Context(check_permission=False), TRASH_INODE, False)
        if st:
            return 0
        for e in entries:
            if e.name in (b".", b".."):
                continue
            try:
                t = calendar.timegm(time.strptime(e.name.decode(), "%Y-%m-%d-%H"))
            except ValueError:
                continue
            if t < ts:
                st2, n = self.remove_recursive(
                    Context(check_permission=False), TRASH_INODE, e.name, skip_trash=True
                )
                removed += n
        return removed

    def scan_deleted_objects(self) -> tuple[dict[int, int], int]:
        """(pending delfiles, trash entry count) for gc reporting
        (reference base.go:2402 ScanDeletedObject)."""
        delfiles = self.do_find_deleted_files(1 << 30)
        st, s = self.summary(Context(check_permission=False), TRASH_INODE)
        return delfiles, (s.files if st == 0 else 0)


class _IDBatch:
    """Client-side batched allocation of inode/slice ids
    (reference base.go:946 allocateInodes batching of 100/1000).

    ``batch`` is per-instance so the write batcher can widen the inode
    range (preallocation: one allocation txn hands out N ids and
    a create storm stops round-tripping for them)."""

    BATCH = 256

    def __init__(self, batch: int = 0):
        self.batch = int(batch) or self.BATCH
        self._next = 0
        self._end = 0
        self._lock = threading.Lock()

    def next(self, alloc: Callable[[int], int]) -> int:
        with self._lock:
            if self._next >= self._end:
                n = max(1, self.batch)
                start = alloc(n)
                self._next, self._end = start, start + n
            v = self._next
            self._next += 1
            return v
