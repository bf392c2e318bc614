"""Checkpoint write plane: group-commit meta write batching.

Role-match to the reference's batched inode allocation + coalesced
metadata transactions behind ``pkg/meta``: checkpoint saves are hundreds
of clients each doing create -> write -> fsync -> rename-into-place in a
burst, and before this layer every one of those mutations was its own
engine transaction (ROADMAP: "the WRITE path still round-trips per
mutation").  The :class:`WriteBatcher` sits INSIDE :class:`BaseMeta` —
the same seam ``meta/cache.py`` uses for reads — and coalesces the write
side:

  * independent mutations (sibling ``mknod``/``create`` bursts,
    ``write_chunk`` slice commits, ``setattr`` on this client's pending
    creates) queue locally and apply as ONE group-commit engine
    transaction per drain, on every engine with transaction nesting
    (kv: memkv/sqlite3/redis, sql) — one txn per drain, not per op,
    with per-inode ordering preserved by the FIFO queue;
  * inode ids come from a per-client preallocated range
    (``BaseMeta._IDBatch``, widened by ``configure_write_batch``): one
    allocation txn hands out N ids, so a create burst never round-trips
    for ids;
  * a LOCAL OVERLAY makes a batched create immediately visible to its
    own client (lookup/getattr/access serve the pending attr with zero
    engine round trips) before the txn lands;
  * ``flush``/``fsync``/``close``/``rename`` and any dependent
    cross-inode read are BARRIERS that drain the batch.  Synchronous
    barrier ops (rename) ride the SAME drain transaction as the queue
    they flush — concurrent barriers coalesce leader/follower style,
    which is the group commit.  The sticky-error contract mirrors
    ``vfs/writer.py``: an acked fsync means everything it covers is
    durably committed; a deferred mutation that fails at drain surfaces
    at every later barrier for its inode until close — never silently.

Failure/degrade contract (composes with the installed machinery):

  * the drain closure is txn-rerun-pure (reset-first results list; PR
    11's txnwatch doubles it suite-wide);
  * a group in which ANY op fails aborts the whole engine transaction
    and replays each op under its own transaction (per-op statuses,
    per-op discard semantics) — partial group state can never commit;
  * overload (full queue) and ineligible ops (default-ACL inheritance,
    engines without ``group_txn``) degrade to per-op passthrough —
    an advisory seam, never an error;
  * write-through invalidation feeds the LeaseCache: the ack path
    notes the same change events as the engine path, and a drained
    create primes the lease with the authoritative attr.

Disabled (the default) every hook is a single ``bool`` check — the
uncached path stays byte-identical to a build without this layer.
Gated by ``mount --write-batch`` / ``--wbatch-flush-ms``.
"""

from __future__ import annotations

import errno
import threading
import time
from typing import Callable, Optional

from ..metric import global_registry
from ..utils import get_logger, lockwatch
from .resilient import MetaUnavailableError
from .types import (
    Attr,
    CHUNK_SIZE,
    FLAG_IMMUTABLE,
    SET_ATTR_ATIME,
    SET_ATTR_ATIME_NOW,
    SET_ATTR_FLAG,
    SET_ATTR_GID,
    SET_ATTR_MODE,
    SET_ATTR_MTIME,
    SET_ATTR_MTIME_NOW,
    SET_ATTR_UID,
    TYPE_DIRECTORY,
    TYPE_SYMLINK,
)

logger = get_logger("meta.wbatch")

_reg = global_registry()
_BATCHED = _reg.counter(
    "juicefs_meta_wbatch_batched",
    "Write-path mutations accepted into the group-commit batch",
    ("op",),
)
_DRAINED = _reg.counter(
    "juicefs_meta_wbatch_drained",
    "Group-commit engine transactions (one per drain; the mutations/"
    "drained ratio is the amortization factor)",
)
_BARRIER_FLUSHES = _reg.counter(
    "juicefs_meta_wbatch_barrier_flushes",
    "Batch drains triggered by a barrier (fsync/close/rename/dependent "
    "read) rather than the flush timer or a full queue",
)
_OVERLAY_HITS = _reg.counter(
    "juicefs_meta_wbatch_overlay_hits",
    "Reads of this client's own pending creates served from the local "
    "overlay with zero engine round trips",
    ("kind",),
)
_PASSTHROUGH = _reg.counter(
    "juicefs_meta_wbatch_passthrough",
    "Mutations that bypassed the batch while batching was enabled "
    "(overload shed or ineligible op) — the advisory degrade, never an "
    "error",
)

# pre-bound label children: the overlay sits on the hot lookup path
_BATCH_MKNOD = _BATCHED.labels("mknod")
_BATCH_WRITE = _BATCHED.labels("write_chunk")
_BATCH_SETATTR = _BATCHED.labels("setattr")
_OV_ATTR = _OVERLAY_HITS.labels("attr")
_OV_ENTRY = _OVERLAY_HITS.labels("entry")


class _Op:
    """One deferred (or synchronous-barrier) mutation.

    ``run`` invokes the engine ``do_*`` with everything pre-bound (the
    preallocated ino included) and is rerun-pure: inside the group
    transaction the nested engine call joins the enclosing txn, so the
    drain closure stays safe under txn-rerun doubling."""

    __slots__ = ("kind", "ino", "parent", "name", "args", "run", "event",
                 "slot", "ts", "scope")

    def __init__(self, kind: str, ino: int, parent: int, name: bytes,
                 run: Callable, event: Optional[threading.Event] = None,
                 args: tuple = (), scope=None):
        self.kind = kind
        self.ino = ino
        self.parent = parent
        self.name = name
        # engine-consumable read-set hint (e.g. a rename's four names):
        # group_txn pre-warms the txn's reads from these in one batch
        self.args = args
        self.run = run
        self.event = event
        self.slot = None  # sync ops: the engine result, set by the leader
        self.ts = time.monotonic()  # enqueue time (the flusher's age gate)
        # fences only: the inodes this barrier is FOR (None = full
        # barrier).  A degraded drain fails only the scoped ops loudly
        # and requeues the rest for heal replay
        self.scope = scope


def _status_of(r) -> int:
    if isinstance(r, int):
        return r
    if isinstance(r, tuple) and r and isinstance(r[0], int):
        return r[0]
    return 0


class WriteBatcher:
    """Group-commit write batching + pending-create overlay.

    One queue lock (enqueue/overlay bookkeeping, never held across
    engine calls) and one drain-leadership lock (serializes group
    commits; concurrent barriers become followers of the live leader —
    that coalescing IS the group commit)."""

    # a queue past this many ops drains on the submitting thread
    # (bounds ack-to-durable memory); past 4x, submits shed to per-op
    # passthrough instead of blocking — advisory, never an error
    DEFAULT_MAX_BATCH = 256

    def __init__(self, meta, enabled: bool = False, flush_ms: float = 3.0,
                 max_batch: int = 0):
        self.meta = meta
        self.enabled = bool(enabled)
        self.flush_interval = max(0.0005, float(flush_ms) / 1e3)
        self.max_batch = max(8, int(max_batch) or self.DEFAULT_MAX_BATCH)
        self._qlock = threading.Lock()
        self._drain_lock = threading.Lock()
        # adaptive group-commit window: when MORE than one barrier is
        # already queued, the drain leader waits this long before
        # snapshotting so near-simultaneous siblings (other writers'
        # fsync fences, their renames) land in the same engine
        # transaction — classic group commit.  A solo writer never pays
        # it (a single queued barrier skips the wait).
        self.group_window = min(0.004, self.flush_interval / 2)
        self._queue: list[_Op] = []
        # overlay: this client's pending creates, authoritative until the
        # drain commits them (then the engine + lease take over)
        self._ov_attrs: dict[int, Attr] = {}
        self._ov_entries: dict[tuple[int, bytes], int] = {}
        # parent-attr memo for the submit-side checks (cleared per drain:
        # staleness is bounded by the flush window)
        self._parent_memo: dict[int, Attr] = {}
        # last-known parent attrs, NOT cleared at drain: the degraded-
        # mode fallback.  Every ack's write-through correctly
        # invalidates the parent's lease, so at outage onset the absorb
        # path would otherwise have no parent knowledge left to check
        # creates against — this map carries the last successful fetch
        # across the breaker-open window (same trust level as a stale
        # lease: bounded by the outage), and is only consulted degraded.
        self._parent_last: dict[int, Attr] = {}
        # pending-op refcounts for the dependent-read barriers
        self._dirty: dict[int, int] = {}
        self._dirty_parents: dict[int, int] = {}
        # sticky per-inode errors: a deferred op that failed at drain
        # surfaces at every barrier for its ino until close clears it
        self._errors: dict[int, int] = {}
        # local stat mirror of the pinned counters (.status wbatch section)
        self.n_batched = 0
        self.n_drained = 0
        self.n_barrier_flushes = 0
        self.n_passthrough = 0
        self._stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        if self.enabled:
            self._flusher = threading.Thread(
                target=self._flush_loop, daemon=True, name="meta-wbatch-flush")
            self._flusher.start()

    # -- submit side (called from BaseMeta public ops) ---------------------
    def note_passthrough(self) -> None:
        self.n_passthrough += 1
        _PASSTHROUGH.inc()

    def _parent_attr(self, parent: int) -> Optional[Attr]:
        a = self._ov_attrs.get(parent)
        if a is not None:
            _OV_ATTR.inc()
            # an overlay ack is authoritative parent knowledge too —
            # without this a dir created right before the outage would
            # have no degraded fallback once its overlay entry drains
            self._parent_last[parent] = a
            return a
        a = self._parent_memo.get(parent)
        if a is not None:
            return a
        st, a = self.meta._attr_cached(parent)
        if st:
            if self._degraded():
                # breaker open and the lease was (correctly) dropped by
                # an earlier ack's write-through: fall back to the last
                # attr this batcher fetched for the parent, so a create
                # storm keeps absorbing through the outage
                return self._parent_last.get(parent)
            return None
        self._parent_memo[parent] = a
        self._parent_last[parent] = a
        if len(self._parent_last) > 4096:  # id-sweep bound
            self._parent_last.pop(next(iter(self._parent_last)))
        return a

    def submit_mknod(self, ctx, parent: int, name: bytes, typ: int,
                     mode: int, cumask: int, rdev: int, path: bytes):
        """Ack a create locally and defer the engine txn to the next
        drain.  Returns ``(st, ino, attr)`` or None to decline
        (passthrough: overload, or default-ACL inheritance whose mode
        computation belongs to the engine).

        Deferred-check contract: existence against the ENGINE (a
        concurrent peer's create) and quota/ENOSPC are checked at drain;
        a violation surfaces as a sticky error at the next barrier for
        this inode — the writeback analog of ``vfs/writer.py``'s
        contract, documented in ARCHITECTURE "Checkpoint write plane"."""
        if len(self._queue) >= self.max_batch * 4:
            return None
        pattr = self._parent_attr(parent)
        if pattr is None:
            if self._degraded() \
                    or getattr(self.meta.resilience, "enabled", False):
                # with the fault contract armed, a missing parent attr
                # may mean the ENGINE IS DARK, not that the dir is gone:
                # declining routes through passthrough, which surfaces
                # the honest errno (ENOENT from a healthy engine, EIO
                # from an outage) instead of guessing
                return None
            return errno.ENOENT, 0, Attr()
        if pattr.typ != TYPE_DIRECTORY:
            return errno.ENOTDIR, 0, Attr()
        if pattr.flags & FLAG_IMMUTABLE:
            return errno.EPERM, 0, Attr()
        if pattr.default_acl:
            return None  # ACL inheritance: the engine owns that math
        name = bytes(name)
        key = (parent, name)
        ino = self.meta.new_inode()  # preallocated range: no round trip
        now = time.time()
        attr = Attr(typ=typ, mode=(mode & 0o7777) & ~cumask & 0o7777,
                    uid=ctx.uid, gid=ctx.gid, rdev=rdev, parent=parent)
        if typ == TYPE_DIRECTORY:
            attr.nlink = 2
            attr.length = 4096
        elif typ == TYPE_SYMLINK:
            attr.length = len(path)
        if pattr.mode & 0o2000:  # setgid dir inheritance (engine mirror)
            attr.gid = pattr.gid
            if typ == TYPE_DIRECTORY:
                attr.mode |= 0o2000
        attr.touch_atime(now)
        attr.touch_mtime(now)
        meta = self.meta
        op = _Op("mknod", ino, parent, name,
                 lambda: meta.do_mknod(ctx, parent, name, typ, mode,
                                       cumask, rdev, path, ino=ino))
        with self._qlock:
            if key in self._ov_entries:
                return errno.EEXIST, 0, Attr()
            self._overlay_acquire(op, attr)
            self._queue.append(op)
        self.n_batched += 1
        _BATCH_MKNOD.inc()
        self._maybe_kick()
        return 0, ino, attr

    def submit_write_chunk(self, ino: int, indx: int, pos: int,
                           slc) -> Optional[int]:
        """Defer a slice commit; per-inode ordering rides the FIFO queue
        (a commit enqueued after its file's create applies after it in
        the same group transaction)."""
        if len(self._queue) >= self.max_batch * 4:
            return None
        hint = indx * CHUNK_SIZE + pos + slc.len
        meta = self.meta
        op = _Op("write_chunk", ino, 0, b"",
                 lambda: meta.do_write_chunk(ino, indx, pos, slc, hint))
        with self._qlock:
            self._overlay_acquire(op, None)
            self._queue.append(op)
            a = self._ov_attrs.get(ino)
            if a is not None:
                # keep the overlay authoritative for our pending create
                if hint > a.length:
                    a.length = hint
                a.touch_mtime(time.time())
        self.n_batched += 1
        _BATCH_WRITE.inc()
        self._maybe_kick()
        return 0

    def submit_setattr(self, ctx, ino: int, flags: int, new: Attr):
        """Batch a setattr ONLY for this client's own pending creates
        (the overlay attr is authoritative there, so the local result is
        exact); anything else returns None for the engine path."""
        with self._qlock:
            a = self._ov_attrs.get(ino)
            if a is None or len(self._queue) >= self.max_batch * 4:
                return None
            self._apply_setattr_local(a, ctx, flags, new, time.time())
            meta = self.meta
            op = _Op("setattr", ino, 0, b"",
                     lambda: meta.do_setattr(ctx, ino, flags, new))
            self._overlay_acquire(op, None)
            self._queue.append(op)
            out = a
        self.n_batched += 1
        _BATCH_SETATTR.inc()
        self._maybe_kick()
        return 0, out

    @staticmethod
    def _apply_setattr_local(a: Attr, ctx, flags: int, new: Attr,
                             now: float) -> None:
        """Mirror of the engines' do_setattr for ACL-less inodes (overlay
        creates never carry ACLs — submit_mknod declines those parents)."""
        if flags & SET_ATTR_MODE:
            mode = new.mode & 0o7777
            if ctx.uid != 0 and not ctx.contains_gid(a.gid) \
                    and ctx.check_permission:
                mode &= ~0o2000
            a.mode = mode
        if flags & SET_ATTR_UID:
            a.uid = new.uid
        if flags & SET_ATTR_GID:
            a.gid = new.gid
        if flags & SET_ATTR_ATIME:
            a.atime, a.atimensec = new.atime, new.atimensec
        if flags & SET_ATTR_ATIME_NOW:
            a.touch_atime(now)
        if flags & SET_ATTR_MTIME:
            a.mtime, a.mtimensec = new.mtime, new.mtimensec
        if flags & SET_ATTR_MTIME_NOW:
            a.touch_mtime(now)
        if flags & SET_ATTR_FLAG:
            a.flags = new.flags
        a.touch_ctime(now)

    # -- overlay reads (zero engine round trips) ---------------------------
    def attr_overlay(self, ino: int) -> Optional[Attr]:
        a = self._ov_attrs.get(ino)
        if a is not None:
            _OV_ATTR.inc()
        return a

    def entry_overlay(self, parent: int, name: bytes) -> int:
        ino = self._ov_entries.get((parent, bytes(name)), 0)
        if ino:
            _OV_ENTRY.inc()
        return ino

    def has_pending(self) -> bool:
        """Anything acked but not yet committed — the dirty maps cover a
        drain IN FLIGHT (snapshot already out of the queue, commit not
        landed), exactly like barrier()'s own pending check."""
        return bool(self._queue or self._dirty or self._dirty_parents)

    # -- barriers ----------------------------------------------------------
    def barrier(self, ino: int = 0, clear: bool = False, scope=None) -> int:
        """Drain the batch (fsync/flush/close).  Returns the sticky error
        for ``ino`` — an acked mutation that failed at drain keeps
        surfacing here until ``clear`` (close) pops it.

        The barrier enqueues a no-op FENCE with a completion event and
        only becomes drain leader if nobody else settles the fence first:
        concurrent barriers pile up behind the live leader and land in
        ONE group — that pile-up is the group commit.

        The pending check covers the dirty maps, not just the queue: a
        drain IN FLIGHT has already moved its snapshot out of the queue
        but holds the dirty claims until its commit lands — a barrier
        arriving mid-drain must wait that commit out (the fence queues
        behind the live leader), or fsync could ack durability for
        mutations whose group transaction is still uncommitted."""
        if self._queue or self._dirty or self._dirty_parents:
            ev = threading.Event()
            fence = _Op("sync", 0, 0, b"", lambda: 0, event=ev, scope=scope)
            with self._qlock:
                self._queue.append(fence)
            self.n_barrier_flushes += 1
            _BARRIER_FLUSHES.inc()
            self._await_drain(ev)
        if ino:
            if clear:
                return self._errors.pop(ino, 0)
            return self._errors.get(ino, 0)
        return 0

    def barrier_if(self, *inos: int) -> None:
        """Dependent-read barrier: drain when any involved inode has
        pending ops (as target or as parent of pending creates).  The
        fence carries the implicated inodes as its SCOPE, so a drain
        during a breaker-open outage fails only these inodes' ops."""
        if any(i in self._dirty or i in self._dirty_parents for i in inos):
            self.barrier(scope=frozenset(inos))

    def barrier_if_entry(self, parent: int, name: bytes) -> None:
        if (parent, bytes(name)) in self._ov_entries \
                or parent in self._dirty or parent in self._dirty_parents:
            self.barrier(scope=frozenset((parent,)))

    def fsync_barrier(self, ino: int) -> int:
        """fsync/flush for ONE file: drain only when this inode is
        implicated (its own pending/in-flight ops, or as a parent) —
        an fsync of an untouched file must not shatter the groups other
        writers are building — then surface its sticky error (kept until
        the last close)."""
        self.barrier_if(ino)
        return self._errors.get(ino, 0)

    def close_barrier(self, ino: int, last: bool) -> int:
        """Close-time barrier: same scoped drain as fsync_barrier; the
        sticky error clears only on the LAST close (an earlier handle's
        release — whose return the kernel ignores — must not swallow
        what a still-open write handle's fsync has to report)."""
        self.barrier_if(ino)
        if last:
            return self._errors.pop(ino, 0)
        return self._errors.get(ino, 0)

    def run_sync(self, fn: Callable, parent: int = 0, kind: str = "sync",
                 args: tuple = ()):
        """Execute ``fn`` (an engine do_* call, e.g. rename) as the TAIL
        of the current group: every pending op commits ahead of it in
        the SAME engine transaction, and the call returns fn's own
        result synchronously.  Concurrent callers coalesce: whoever
        holds drain leadership commits the followers' ops too."""
        ev = threading.Event()
        op = _Op(kind, 0, parent, b"", fn, event=ev, args=args)
        with self._qlock:
            self._queue.append(op)
        self.n_barrier_flushes += 1
        _BARRIER_FLUSHES.inc()
        self._await_drain(ev)
        if op.slot is None:  # pragma: no cover
            # leadership settles every snapshot in a finally; this path
            # exists only so a logic bug degrades to per-op, not a hang
            logger.error("wbatch sync op was not settled; running direct")
            return fn()
        return op.slot

    # -- drain (group commit) ----------------------------------------------
    def _degraded(self) -> bool:
        """True while the meta engine breaker is open: the
        timer and full-queue kicks stop draining so the queue ABSORBS
        acked writes up to the shed bound — they replay byte-identically
        on heal.  Barriers still drain (and fail loudly, sticky EIO):
        an fsync must never ack durability it cannot have."""
        res = getattr(self.meta, "resilience", None)
        return res is not None and res.degraded

    def replay_after_heal(self) -> None:
        """Heal-chain hook: commit everything the outage queue absorbed.
        The deferred closures are pre-bound (ino, attrs, slices), so the
        replayed groups are byte-identical to what was acked."""
        if self.enabled and self.has_pending():
            n = len(self._queue)
            self.barrier()
            logger.warning("wbatch replayed %d absorbed mutations after "
                           "meta heal", n)

    def _maybe_kick(self) -> None:
        # full batch: drain on the submitting thread — but never BLOCK a
        # producer behind a slow leader (their snapshot excludes our ops
        # anyway); while a drain is in flight the queue may grow toward
        # the 4x shed bound, where submits degrade to passthrough.
        # Degraded (breaker open) the kick is suppressed: draining now
        # would only burn the queue into sticky errors — absorb instead
        if len(self._queue) >= self.max_batch and not self._degraded():
            self._drain(blocking=False)

    def _drain(self, blocking: bool = True) -> None:
        if not self._drain_lock.acquire(blocking=blocking):
            return
        try:
            with lockwatch.permit(
                    "group-commit drain leadership: the engine transaction "
                    "(including its conflict-backoff sleeps) runs under "
                    "this lock by design — followers only ever wait for "
                    "the leader, and no engine code takes wbatch locks, "
                    "so the wait cannot cycle"):
                self._drain_locked()
        finally:
            self._drain_lock.release()

    def _await_drain(self, ev: threading.Event) -> None:
        """Wait until our fence/sync op is settled, becoming drain leader
        only if nobody else settles it first.  A thread whose op was just
        drained by the live leader exits WITHOUT grabbing leadership —
        prematurely draining the handful of ops that arrived during the
        leader's commit would shatter the very groups this plane exists
        to build."""
        while not ev.is_set():
            if not self._drain_lock.acquire(timeout=0.002):
                continue  # leader in flight: it may be settling our op
            try:
                if not ev.is_set():
                    with lockwatch.permit(
                            "group-commit drain leadership (see _drain)"):
                        self._drain_locked()
            finally:
                self._drain_lock.release()

    def _drain_locked(self) -> int:
        with self._qlock:
            pending_barriers = sum(1 for op in self._queue
                                   if op.event is not None)
        if pending_barriers > 1 and self.group_window > 0:
            # several barriers already waiting: hold leadership briefly so
            # their near-simultaneous siblings (the other writers' fsync
            # fences and renames) join THIS snapshot too
            time.sleep(self.group_window)
        degraded = self._degraded()
        with self._qlock:
            ops, self._queue = self._queue, []
            if not degraded:
                # the memo's staleness is normally bounded by the flush
                # window; during an outage it is deliberately KEPT — it
                # is the only parent knowledge the absorb path has left
                # (each ack's write-through drops the lease), and its
                # staleness is bounded by the outage itself
                self._parent_memo.clear()
        if not ops:
            return 0
        if degraded:
            # barrier-driven drain during a breaker-open outage: the
            # engine cannot commit, so the ops this barrier is FOR fail
            # LOUDLY — sticky EIO per inode, sync ops settled with EIO —
            # without burning a retry deadline per op.  Everything
            # OUTSIDE the barrier's scope is REQUEUED (claims held):
            # writer A's fsync must not incinerate writer B's absorbed
            # mutations, which replay byte-identically on heal.  An
            # unscoped fence (flush_all/unmount/rename/rmr) — or a
            # fence-less drain (close()) — fails the whole snapshot.
            fences = [op for op in ops if op.event is not None]
            scope: set = set()
            full = not fences  # close()-time: loud, never a silent drop
            for f in fences:
                if f.scope is None:
                    full = True
                else:
                    scope |= f.scope
            failed, keep = [], []
            for op in ops:
                if op.event is not None or full \
                        or op.ino in scope or op.parent in scope:
                    failed.append(op)
                else:
                    keep.append(op)
            if keep:
                with self._qlock:
                    # prepend: older than anything enqueued mid-drain,
                    # preserving per-inode FIFO order
                    self._queue[:0] = keep
            try:
                for op in failed:
                    if op.event is not None:
                        op.slot = errno.EIO
                    else:
                        self._errors.setdefault(op.ino or op.parent,
                                                errno.EIO)
                        logger.error(
                            "wbatch deferred %s on ino %d failed EIO: meta "
                            "engine breaker open (barrier during outage)",
                            op.kind, op.ino)
            finally:
                self._overlay_release(failed)
            return len(failed)
        results: list = []
        meta = self.meta

        def group() -> int:
            # rerun-pure under the txn-rerun harness: reset-first
            # accumulator, every effect inside flows through the nested
            # engine do_* calls that join this transaction
            del results[:]
            for op in ops:
                r = op.run()
                st = _status_of(r)
                results.append((op, st, r))
                if st:
                    return st  # abort the whole group; replay per-op
            return 0

        try:
            try:
                failed = meta.group_txn(group, ops)
            except Exception as e:
                logger.warning("wbatch group commit failed (%s); replaying "
                               "per-op", e)
                failed = -1
            if failed:
                del results[:]
                unavailable = False
                for op in ops:
                    # per-op replay: each mutation under its own engine
                    # transaction with its own discard semantics.  Once
                    # one replay reports the engine UNAVAILABLE (breaker
                    # open / retries spent), the rest fail EIO without
                    # each burning its own retry deadline
                    if unavailable:
                        results.append((op, errno.EIO, errno.EIO))
                        continue
                    try:
                        r = op.run()
                        st = _status_of(r)
                    except MetaUnavailableError as e:
                        unavailable = True
                        logger.error("wbatch replay %s ino=%d: %s "
                                     "(failing the rest of the group fast)",
                                     op.kind, op.ino, e)
                        st, r = errno.EIO, errno.EIO
                    except Exception as e:
                        logger.error("wbatch replay %s ino=%d: %s",
                                     op.kind, op.ino, e)
                        st, r = errno.EIO, errno.EIO
                    results.append((op, st, r))
            else:
                self.n_drained += 1
                _DRAINED.inc()
            for op, st, r in results:
                if op.event is not None:
                    op.slot = r
                elif st:
                    # sticky: surfaces at this inode's next barrier
                    self._errors.setdefault(op.ino, st)
                    logger.error(
                        "wbatch deferred %s on ino %d failed: errno %d "
                        "(surfaces at the next fsync/close barrier)",
                        op.kind, op.ino, st)
                elif op.kind == "mknod":
                    # peer invalidations publish HERE, post-commit — an
                    # ack-time publish could reach a peer while the group
                    # was still uncommitted, and its refetch would cache
                    # pre-commit state (a negative dentry!) that no later
                    # event heals.  Then the lease write-through: the
                    # drained create's AUTHORITATIVE attr replaces the
                    # overlay (after _note_change's own invalidation, so
                    # the primed entry survives).
                    meta._note_change(("e", op.parent, op.name),
                                      ("a", op.parent))
                    meta.lease.put_entry(op.parent, op.name, op.ino)
                    meta.lease.put_attr(op.ino, r[2])
                elif op.kind in ("write_chunk", "setattr"):
                    meta._note_change(("a", op.ino))
        finally:
            self._overlay_release(ops)
        return len(ops)

    # -- overlay claim pair (registered in tools/analyze claims) -----------
    def _overlay_acquire(self, op: _Op, attr: Optional[Attr]) -> None:
        """Claim overlay/dirty state for a queued op (caller holds
        ``_qlock``); released by the drain consumer in a ``finally``."""
        if op.kind == "mknod" and attr is not None:
            self._ov_attrs[op.ino] = attr
            self._ov_entries[(op.parent, op.name)] = op.ino
        if op.ino:
            self._dirty[op.ino] = self._dirty.get(op.ino, 0) + 1
        if op.parent:
            self._dirty_parents[op.parent] = \
                self._dirty_parents.get(op.parent, 0) + 1

    def _overlay_release(self, ops: list[_Op]) -> None:
        with self._qlock:
            for op in ops:
                if op.event is not None:
                    continue  # sync ops never acquired overlay state
                if op.kind == "mknod":
                    self._ov_attrs.pop(op.ino, None)
                    self._ov_entries.pop((op.parent, op.name), None)
                if op.ino:
                    n = self._dirty.get(op.ino, 0) - 1
                    if n > 0:
                        self._dirty[op.ino] = n
                    else:
                        self._dirty.pop(op.ino, None)
                if op.parent:
                    n = self._dirty_parents.get(op.parent, 0) - 1
                    if n > 0:
                        self._dirty_parents[op.parent] = n
                    else:
                        self._dirty_parents.pop(op.parent, None)
        for op in ops:
            if op.event is not None:
                op.event.set()

    # -- lifecycle ---------------------------------------------------------
    def _flush_loop(self) -> None:
        while not self._stop.wait(self.flush_interval):
            try:
                q = self._queue
                # age gate: the timer exists to bound ack-to-durable
                # latency when NO barrier is driving.  In a barrier-heavy
                # storm the barriers drain continuously, and a flusher
                # that grabbed leadership for every fresh arrival would
                # shatter the very groups the barriers are building.
                if q and time.monotonic() - q[0].ts >= self.flush_interval \
                        and not self._degraded():
                    self._drain(blocking=False)
            except Exception:  # pragma: no cover - background resilience
                logger.exception("wbatch timed flush")

    def close(self) -> None:
        """Stop the flusher and drain what remains — an enabled batcher
        must never drop acked mutations on unmount."""
        self._stop.set()
        t = self._flusher
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=5.0)
            self._flusher = None
        if self.enabled and self._queue:
            self._drain()

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        return {
            "enabled": self.enabled,
            "flush_ms": round(self.flush_interval * 1e3, 3),
            "max_batch": self.max_batch,
            "queued": len(self._queue),
            "overlay_attrs": len(self._ov_attrs),
            "batched": self.n_batched,
            "drained": self.n_drained,
            "barrier_flushes": self.n_barrier_flushes,
            "passthrough": self.n_passthrough,
            "sticky_errors": len(self._errors),
        }
