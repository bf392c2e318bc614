"""Lease-based client-side metadata cache + per-tenant meta-op throttle.

Role-match to NFSv4 delegations / production JuiceFS attr+entry caching:
`getattr`/`lookup` are the ops a training dataloader hammers (hundreds of
workers stat/open shuffled shards each epoch), and before this layer every
one of them was a full round trip to the meta store.  The LeaseCache sits
INSIDE BaseMeta, in front of the `do_*` engine ops, and holds

  * positive attr leases            ino -> Attr, valid for attr_ttl
  * positive dentry leases          (parent, name) -> ino, valid entry_ttl
  * bounded-TTL negative dentries   (parent, name) -> ENOENT, valid neg_ttl
    (a dataloader probing optional index/sidecar files repeats the same
    miss thousands of times per epoch)

Coherence contract (the same one the vfs TTL caches and the kernel attr
cache already follow, now at the meta boundary):

  * local mutations write through: every mutating BaseMeta op names its
    victims via `_note_change` / `OpenFiles.invalidate`, and both paths
    invalidate this cache synchronously — read-your-own-writes always
    holds, byte-identically to the uncached engine.
  * remote mutations are bounded by the lease TTL: a peer's change is
    visible at latest when the lease expires.  The per-volume change feed
    (the `invalSeq` journal the session heartbeat already exchanges)
    accelerates that — peers' events drop leases mid-TTL — but the TTL is
    the correctness story, the feed the optimization.
  * engines WITHOUT the change feed never cache: `configure_meta_cache`
    drops to TTL-0 passthrough so an engine that cannot even bound
    remote staleness serves every read from the store, exactly as today.

Expired dentries are retained (LRU-bounded) as *hints*: `entry_hint`
returns the last-known child ino so the engine can speculatively batch
the child attr into the same round trip as the entry re-read
(`do_lookup(..., hint_ino=)`) — a warm-but-expired lookup revalidates in
ONE round trip instead of three.

`MetaOpLimiter` is the satellite: per-tenant token buckets at the same
boundary (`--meta-op-limit` ops/s).  Throttling is graceful queuing —
the caller waits for tokens, it never sees an error.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

from ..metric import global_registry

_reg = global_registry()
_HITS = _reg.counter(
    "juicefs_meta_cache_hits",
    "Meta reads served from the lease cache with zero engine round trips",
    ("kind",),
)
_MISSES = _reg.counter(
    "juicefs_meta_cache_misses",
    "Meta cache lookups that fell through to the engine",
    ("kind",),
)
_INVALIDATES = _reg.counter(
    "juicefs_meta_cache_invalidates",
    "Lease-cache entries dropped by write-through or peer invalidation",
    ("kind",),
)
_LEASE_EXPIRED = _reg.counter(
    "juicefs_meta_cache_lease_expired",
    "Lease-cache reads that found an entry past its lease TTL",
    ("kind",),
)
_REPLICA_READS = _reg.counter(
    "juicefs_meta_cache_replica_reads",
    "Read-only meta transactions served by a replica connection",
)
_REPLICA_STALE = _reg.counter(
    "juicefs_meta_cache_replica_stale",
    "Replica reads refused because the replica's change-epoch lagged "
    "this client's floor (fell back to the primary)",
)
_STALE_SERVED = _reg.counter(
    "juicefs_meta_stale_served",
    "Expired lease entries served during breaker-open degraded mode "
    "(bounded by --meta-degraded-max-stale)",
)
_THROTTLE_WAITS = _reg.counter(
    "juicefs_meta_throttle_waits",
    "Meta ops that waited for a per-tenant token (--meta-op-limit)",
)
_THROTTLE_WAIT_SECONDS = _reg.counter(
    "juicefs_meta_throttle_wait_seconds",
    "Seconds meta ops spent queued behind the per-tenant op limit",
)

# label children pre-bound once: the cache sits on the hottest meta path,
# and a labels() dict/lock round per hit would be measurable there
_HIT_ATTR, _HIT_ENTRY = _HITS.labels("attr"), _HITS.labels("entry")
_MISS_ATTR, _MISS_ENTRY = _MISSES.labels("attr"), _MISSES.labels("entry")
_INVAL_ATTR = _INVALIDATES.labels("attr")
_INVAL_ENTRY = _INVALIDATES.labels("entry")
_EXP_ATTR = _LEASE_EXPIRED.labels("attr")
_EXP_ENTRY = _LEASE_EXPIRED.labels("entry")


class LeaseCache:
    """LRU-bounded attr + dentry cache with per-entry lease expiry.

    One lock guards both maps; every operation is O(1).  Disabled
    (attr_ttl == entry_ttl == 0) the public methods short-circuit to
    None/no-op, so the uncached code path is byte-identical to a build
    without this layer.
    """

    # dentry sentinel for a cached ENOENT (ino 0 is never a real inode)
    NEGATIVE = 0

    def __init__(self, attr_ttl: float = 0.0, entry_ttl: float = 0.0,
                 neg_ttl: Optional[float] = None, maxsize: int = 100_000):
        self.attr_ttl = max(0.0, float(attr_ttl))
        self.entry_ttl = max(0.0, float(entry_ttl))
        # negative leases default to the shorter of 1s and the entry TTL:
        # a cached ENOENT is the most dangerous staleness (it hides a
        # peer's create), so its bound is tighter than the positive lease
        self.neg_ttl = (min(1.0, self.entry_ttl) if neg_ttl is None
                        else max(0.0, float(neg_ttl)))
        self.maxsize = max(16, int(maxsize))
        self._attrs: OrderedDict = OrderedDict()     # ino -> (attr, expires)
        self._entries: OrderedDict = OrderedDict()   # (p, name) -> (ino, exp)
        self._lock = threading.Lock()
        self.n_stale_served = 0  # degraded-mode serves (.status mirror)
        # retain expired attrs as degraded-mode stale candidates (set by
        # configure_meta_retries when a stale ceiling is armed).  OFF, a
        # build that can never stale-serve drops them eagerly — retained
        # corpses would evict LIVE leases under LRU pressure for nothing
        self.keep_stale = False

    @property
    def enabled(self) -> bool:
        return self.attr_ttl > 0 or self.entry_ttl > 0

    # -- attrs -------------------------------------------------------------
    def get_attr(self, ino: int):
        if self.attr_ttl <= 0:
            return None
        with self._lock:
            item = self._attrs.get(ino)
            if item is None:
                _MISS_ATTR.inc()
                return None
            attr, expires = item
            if time.monotonic() >= expires:
                # expired leases never serve here; with a stale ceiling
                # armed the entry is RETAINED (LRU-bounded) as the
                # degraded-mode candidate get_attr_stale serves while
                # the engine breaker is open
                if not self.keep_stale:
                    del self._attrs[ino]
                _EXP_ATTR.inc()
                _MISS_ATTR.inc()
                return None
            self._attrs.move_to_end(ino)
            _HIT_ATTR.inc()
            return attr

    def put_attr(self, ino: int, attr) -> None:
        if self.attr_ttl <= 0 or not getattr(attr, "full", True):
            return
        with self._lock:
            self._attrs[ino] = (attr, time.monotonic() + self.attr_ttl)
            self._attrs.move_to_end(ino)
            while len(self._attrs) > self.maxsize:
                self._attrs.popitem(last=False)

    def get_attr_stale(self, ino: int, max_stale: float):
        """Degraded-mode attr read: serve a LIVE OR EXPIRED
        lease as long as it has not been expired for more than
        ``max_stale`` seconds.  Only the fault contract calls this, and
        only while the engine breaker is open — every serve is counted
        (the blackout drill's stale-served bound assertion)."""
        if self.attr_ttl <= 0 or max_stale <= 0:
            return None
        with self._lock:
            item = self._attrs.get(ino)
            if item is None:
                return None
            attr, expires = item
            now = time.monotonic()
            if now >= expires + max_stale:
                del self._attrs[ino]  # past the ceiling: no longer useful
                return None
            self._attrs.move_to_end(ino)
            if now >= expires:
                self.n_stale_served += 1
                _STALE_SERVED.inc()
            return attr

    def get_entry_stale(self, parent: int, name: bytes,
                        max_stale: float) -> int:
        """Degraded-mode dentry read: a POSITIVE mapping within the
        staleness ceiling (0 otherwise).  Negative entries never
        stale-serve — a stale ENOENT would hide a real file for the
        whole outage, which is a far worse lie than a stale attr."""
        if self.entry_ttl <= 0 or max_stale <= 0:
            return 0
        with self._lock:
            item = self._entries.get((parent, bytes(name)))
            if item is None:
                return 0
            ino, expires = item
            now = time.monotonic()
            if ino == self.NEGATIVE:
                return 0
            if now >= expires + max_stale:
                # past the ceiling: no longer useful even as a hint for
                # this outage (same cleanup as the attr side)
                del self._entries[(parent, bytes(name))]
                return 0
            if now >= expires:
                self.n_stale_served += 1
                _STALE_SERVED.inc()
            return ino

    def invalidate_attr(self, ino: int) -> None:
        with self._lock:
            if self._attrs.pop(ino, None) is not None:
                _INVAL_ATTR.inc()

    # -- dentries ----------------------------------------------------------
    def get_entry(self, parent: int, name: bytes) -> Optional[int]:
        """Child ino for a live lease, NEGATIVE (0) for a cached ENOENT,
        None on miss/expiry (expired mappings stay behind as hints)."""
        if self.entry_ttl <= 0:
            return None
        key = (parent, bytes(name))
        with self._lock:
            item = self._entries.get(key)
            if item is None:
                _MISS_ENTRY.inc()
                return None
            ino, expires = item
            if time.monotonic() >= expires:
                if ino == self.NEGATIVE:
                    # an expired ENOENT is not a useful hint — drop it
                    del self._entries[key]
                _EXP_ENTRY.inc()
                _MISS_ENTRY.inc()
                return None
            self._entries.move_to_end(key)
            _HIT_ENTRY.inc()
            return ino

    def entry_hint(self, parent: int, name: bytes) -> int:
        """Last-known child ino even when the lease has EXPIRED (0 = no
        hint).  Never consulted as truth — the engine revalidates it
        against the live dentry, it only shapes the read batching."""
        with self._lock:
            item = self._entries.get((parent, bytes(name)))
            return item[0] if item is not None else 0

    def put_entry(self, parent: int, name: bytes, ino: int) -> None:
        if self.entry_ttl <= 0:
            return
        self._put_entry(parent, name, ino, self.entry_ttl)

    def put_negative(self, parent: int, name: bytes) -> None:
        """Cache an ENOENT for the (tighter) negative TTL."""
        if self.entry_ttl <= 0 or self.neg_ttl <= 0:
            return
        self._put_entry(parent, name, self.NEGATIVE, self.neg_ttl)

    def _put_entry(self, parent: int, name: bytes, ino: int, ttl: float) -> None:
        key = (parent, bytes(name))
        with self._lock:
            self._entries[key] = (ino, time.monotonic() + ttl)
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)

    def invalidate_entry(self, parent: int, name: bytes) -> None:
        with self._lock:
            if self._entries.pop((parent, bytes(name)), None) is not None:
                _INVAL_ENTRY.inc()

    # -- admin -------------------------------------------------------------
    def clear(self) -> None:
        with self._lock:
            self._attrs.clear()
            self._entries.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "attr_ttl": self.attr_ttl,
                "entry_ttl": self.entry_ttl,
                "neg_ttl": self.neg_ttl,
                "attrs": len(self._attrs),
                "entries": len(self._entries),
                "stale_served": self.n_stale_served,
            }


class MetaOpLimiter:
    """Per-tenant token buckets over meta ops (`--meta-op-limit`).

    `acquire(tenant)` blocks until the tenant's bucket admits one op —
    graceful queuing, never an error — and bills the throttle counters
    when it actually waited.  Buckets are created on first use and
    LRU-bounded so an id-sweeping workload cannot grow state unboundedly.
    """

    MAX_TENANTS = 4096

    def __init__(self, ops_per_sec: float, burst: Optional[float] = None):
        if ops_per_sec <= 0:
            raise ValueError(f"meta op limit must be positive: {ops_per_sec}")
        self.rate = float(ops_per_sec)
        # burst: an eighth of a second of ops, at least one — deep enough
        # that a stat+open pair never waits at low utilization
        self.burst = float(burst) if burst else max(1.0, self.rate / 8)
        self._buckets: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def _bucket(self, tenant):
        from ..qos.limiter import TokenBucket

        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                b = self._buckets[tenant] = TokenBucket(self.rate, self.burst)
            self._buckets.move_to_end(tenant)
            while len(self._buckets) > self.MAX_TENANTS:
                self._buckets.popitem(last=False)
            return b

    def acquire(self, tenant) -> float:
        waited = self._bucket(tenant).acquire(1.0)
        # gate() returns elapsed wall time even on an immediate grant (a
        # few µs of clock reads) — only a real park bills the counters
        if waited > 1e-3:
            _THROTTLE_WAITS.inc()
            _THROTTLE_WAIT_SECONDS.inc(waited)
        return waited

    def snapshot(self) -> dict:
        with self._lock:
            return {"rate_ops": self.rate, "burst_ops": self.burst,
                    "tenants": len(self._buckets)}
