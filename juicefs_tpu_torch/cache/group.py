"""CacheGroup client: place block keys on the ring, read from peers (a
copy of juicefs_tpu/cache/group.py).

The read path's new rung (chunk/cached_store.py `_load_block`):

    local cache -> staging -> OWNER PEER -> object store (or EIO rung)

Peer reads deliberately BYPASS the object backend's breaker: the whole
point of the tier is that it keeps serving while the backend browns out,
so a peer GET is gated only by that peer's OWN breaker.  Failure
contract: a dead/slow/refusing peer is a TRANSIENT event —
counted, breaker-recorded, fallen through — and a digest-mismatched
payload (membership churn serving the wrong bytes) is rejected before it
can enter the local cache.  The group may degrade, never fail a read.

Membership: `refresh()` rebuilds the ring from the meta engine's live
sessions (the ones publishing a matching `cache_group` + `peer_addr` in
their session info), honoring `group_weight` and skipping sessions whose
heartbeat already expired.  Static peer lists serve tests and fixed
fleets.  Refresh is time-gated on the read path (heartbeat cadence), so
a busy reader pays one session scan per interval, not per miss.
"""

from __future__ import annotations

import http.client
import threading
import time
import zlib
from typing import Optional

from ..metric import global_registry
from ..metric.trace import global_tracer, stage_hist
from ..object.resilient import CircuitBreaker
from ..utils import get_logger
from .ring import HashRing

logger = get_logger("cache.group")

_TR = global_tracer()
_H_PEER = stage_hist("cache", "peer_get")

_reg = global_registry()
_HITS = _reg.counter(
    "juicefs_cache_group_peer_hits",
    "Block reads served by a cache-group peer (no object-store GET)",
)
_MISSES = _reg.counter(
    "juicefs_cache_group_peer_misses",
    "Peer lookups that found no usable copy (fell through to the backend)",
)
_ERRORS = _reg.counter(
    "juicefs_cache_group_peer_errors",
    "Peer fetch failures by class (transient=dead/slow peer, "
    "digest=wrong-block or corrupt payload)",
    ("class",),
)
_RING_SIZE = _reg.gauge(
    "juicefs_cache_group_ring_size",
    "Live members of the cache-group ring",
    ("group",),
)
_PEER_HIST = _reg.histogram(
    "juicefs_cache_group_peer_get_seconds",
    "Peer block GET latency (successful fetches)",
    ("group",),
)
_WARM_HINTS = _reg.counter(
    "juicefs_cache_group_warm_hints",
    "Warm hints sent to ring owners (a non-owned block's prefetch "
    "delegated instead of a redundant local object GET)",
)


class GroupPeer:
    """One remote member: its address plus its own circuit breaker (a
    flapping peer is isolated without touching the others or the
    backend's breaker)."""

    def __init__(self, addr: str, probe_interval: float = 1.0,
                 timeout: float = 2.0):
        self.addr = addr
        self.timeout = timeout
        # per-thread keep-alive connections (the server speaks HTTP/1.1):
        # a reader streaming a file owned by one peer must not pay a TCP
        # handshake per block.  http.client auto-reconnects a connection
        # whose socket the server closed (sock reset to None).
        self._local = threading.local()
        self.breaker = CircuitBreaker(
            backend=f"peer:{addr}", threshold=0.5, min_samples=4,
            probe_interval=probe_interval, probe=self._probe,
            window=15.0,
        )

    def _split(self) -> tuple[str, int]:
        host, _, port = self.addr.rpartition(":")
        return host or "127.0.0.1", int(port)

    def _probe(self) -> bool:
        """Half-open probe: any /ring response means the peer is back."""
        try:
            host, port = self._split()
            conn = http.client.HTTPConnection(host, port, timeout=1.0)
            try:
                conn.request("GET", "/ring")
                return conn.getresponse().status == 200
            finally:
                conn.close()
        except Exception:
            return False

    def _connection(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            host, port = self._split()
            conn = http.client.HTTPConnection(host, port,
                                              timeout=self.timeout)
            self._local.conn = conn
        return conn

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._local.conn = None
            try:
                conn.close()
            except Exception:
                pass

    def get_block(self, key: str) -> Optional[bytes]:
        """Fetch one block; None = clean miss (peer answered 404).
        Anything else non-200, a short body, or a digest mismatch raises."""
        resp = body = None
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request("GET", "/block/" + key)
                resp = conn.getresponse()
                body = resp.read()
                break
            except (http.client.CannotSendRequest, http.client.BadStatusLine,
                    BrokenPipeError, ConnectionResetError):
                # stale keep-alive socket (peer idled us out): one clean
                # retry on a fresh connection, then it IS a peer failure
                self._drop_connection()
                if attempt:
                    raise
            except Exception:
                self._drop_connection()
                raise
        # body fully read: the keep-alive connection stays usable either
        # way, so no close here — the next block reuses it
        if resp.status == 404:
            return None
        if resp.status != 200:
            raise IOError(f"peer {self.addr}: HTTP {resp.status}")
        want = resp.getheader("X-Block-Crc32")
        if want is None or int(want) != zlib.crc32(body):
            raise _DigestMismatch(
                f"peer {self.addr}: digest mismatch for {key}"
            )
        echoed = resp.getheader("X-Block-Key")
        if echoed is not None and echoed != key:
            raise _DigestMismatch(
                f"peer {self.addr}: served {echoed!r} for {key!r}"
            )
        return body

    def warm(self, key: str) -> bool:
        """Ask this peer to warm `key` into ITS cache (no bytes move to
        the caller).  The peer routes the hint through its own PREFETCH
        stage, so it is bounded and sheddable there; 202 = accepted."""
        resp = None
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request("POST", "/warm/" + key,
                             headers={"Content-Length": "0"})
                resp = conn.getresponse()
                resp.read()  # drain: keep the keep-alive socket usable
                break
            except (http.client.CannotSendRequest, http.client.BadStatusLine,
                    BrokenPipeError, ConnectionResetError):
                self._drop_connection()
                if attempt:
                    raise
            except Exception:
                self._drop_connection()
                raise
        return resp.status in (200, 202)

    def close(self) -> None:
        self._drop_connection()
        self.breaker.close()


class _DigestMismatch(IOError):
    """Peer answered with the wrong bytes (stale ring / corrupt copy)."""


class CacheGroup:
    """Ring + peer set + fetch policy for one named cache group."""

    def __init__(self, name: str, self_addr: str = "", meta=None,
                 weight: int = 1, static_peers: Optional[dict[str, int]] = None,
                 refresh_interval: float = 5.0, peer_timeout: float = 2.0,
                 fallback_peers: int = 2, vnodes: int = 64):
        self.name = name
        self.self_addr = self_addr
        self.meta = meta
        self.weight = max(1, weight)
        self.peer_timeout = peer_timeout
        self.fallback_peers = max(1, fallback_peers)
        self.refresh_interval = refresh_interval
        self.ring = HashRing(vnodes=vnodes)
        self._peers: dict[str, GroupPeer] = {}
        self._static = dict(static_peers or {})
        self._mu = threading.Lock()
        self._last_refresh = 0.0
        self._closed = False
        self.refresh()

    # -- membership --------------------------------------------------------
    def _discover(self) -> dict[str, int]:
        """addr -> weight of every live serving member (self included)."""
        members = dict(self._static)
        if self.self_addr:
            members.setdefault(self.self_addr, self.weight)
        if self.meta is not None:
            now = time.time()
            try:
                sessions = self.meta.do_list_sessions()
            except Exception as e:
                logger.warning("cache-group discovery failed: %s", e)
                return members
            for s in sessions:
                if getattr(s, "cache_group", "") != self.name:
                    continue
                addr = getattr(s, "peer_addr", "")
                if not addr:
                    continue  # client-only member: consults, never serves
                expire = getattr(s, "expire", 0.0) or 0.0
                if 0 < expire < now:
                    continue  # heartbeat already stale: reaped from the ring
                members[addr] = max(1, int(getattr(s, "group_weight", 1)))
        return members

    def refresh(self, force: bool = False) -> None:
        """Rebuild the ring from current membership (time-gated unless
        forced); drops vanished peers and closes their breakers."""
        now = time.monotonic()
        with self._mu:
            if self._closed:
                return
            if not force and now - self._last_refresh < self.refresh_interval:
                return
            self._last_refresh = now
        members = self._discover()
        with self._mu:
            if self._closed:
                return
            self.ring.rebuild(members)
            for addr in members:
                if addr != self.self_addr and addr not in self._peers:
                    self._peers[addr] = GroupPeer(
                        addr, timeout=self.peer_timeout)
            for addr in list(self._peers):
                if addr not in members:
                    self._peers.pop(addr).close()
            _RING_SIZE.labels(self.name).set(len(self.ring))

    def owns(self, key: str) -> bool:
        """True when this member is the ring owner of `key` (empty ring:
        everyone owns everything — warmup degrades to fill-all)."""
        owner = self.ring.owner(key)
        return owner is None or owner == self.self_addr

    # -- the read rung ------------------------------------------------------
    def fetch(self, key: str, bsize: int, parent=None) -> Optional[bytes]:
        """Try the owner peer (then ring fallbacks) for one block.
        Returns the verified bytes, or None to fall through to the object
        store.  NEVER raises — a cache group degrades, it does not fail."""
        try:
            return self._fetch(key, bsize, parent)
        except Exception:
            # the never-fail contract is load-bearing (this sits on the
            # read hot path): anything unexpected degrades to the backend
            logger.exception("cache-group fetch %s degraded", key)
            _ERRORS.labels("transient").inc()
            return None

    def _fetch(self, key: str, bsize: int, parent=None) -> Optional[bytes]:
        self.refresh()
        order = self.ring.owners(key, self.fallback_peers)
        tried = False
        with _TR.span("cache", "peer_get", hist=_H_PEER, parent=parent) as sp:
            if sp.active:
                sp.set(key=key, bytes=bsize)
            for addr in order:
                if addr == self.self_addr:
                    continue  # local tiers were already consulted
                with self._mu:
                    peer = self._peers.get(addr)
                if peer is None or not peer.breaker.allow():
                    continue
                tried = True
                t0 = time.perf_counter()
                try:
                    data = peer.get_block(key)
                except _DigestMismatch as e:
                    _ERRORS.labels("digest").inc()
                    peer.breaker.record_failure()
                    logger.warning("%s", e)
                    continue
                except Exception as e:
                    _ERRORS.labels("transient").inc()
                    peer.breaker.record_failure()
                    logger.warning("peer %s GET %s: %s", addr, key, e)
                    continue
                if data is not None and len(data) != bsize:
                    # a well-formed response for a DIFFERENT block size:
                    # stale ring somewhere — same failure class as a
                    # digest mismatch, including for the breaker (a peer
                    # consistently serving wrong blocks must trip it)
                    _ERRORS.labels("digest").inc()
                    peer.breaker.record_failure()
                    continue
                peer.breaker.record_success()
                if data is None:
                    continue  # clean 404: healthy peer, no copy
                _PEER_HIST.labels(self.name).observe(
                    time.perf_counter() - t0)
                _HITS.inc()
                if sp.active:
                    sp.set(peer=addr)
                return data
            if tried or any(a != self.self_addr for a in order):
                # a remote candidate existed (consulted, or skipped by its
                # open breaker) and yielded nothing: that is a peer miss.
                # A self-only ring consults nobody — counting those reads
                # as misses would show a fake 0% hit rate during rollout.
                _MISSES.inc()
        return None

    # -- ring-aware warm placement -------------------------------------------
    def warm(self, key: str) -> bool:
        """Hint the ring owner of `key` to warm it into ITS cache.  Used
        by the prefetch stage for non-owned blocks: the owner pays the
        one object GET for the whole group and later reads take the peer
        rung.  No size travels with the hint — block keys pin their own
        bsize and the owner re-derives it.  Fire-and-forget semantics —
        NEVER raises, never moves bytes to this member; False = no owner
        reachable (the block will simply warm on demand)."""
        try:
            self.refresh()
            owner = self.ring.owner(key)
            if owner is None or owner == self.self_addr:
                return False  # empty ring / self-owned: nothing to hint
            with self._mu:
                peer = self._peers.get(owner)
            if peer is None or not peer.breaker.allow():
                return False
            try:
                ok = peer.warm(key)
            except Exception as e:
                _ERRORS.labels("transient").inc()
                peer.breaker.record_failure()
                logger.warning("peer %s warm %s: %s", owner, key, e)
                return False
            if not ok:
                # the peer answered but refused (5xx/400): that is a sick
                # peer for the warm path — the breaker must see it, or a
                # permanently erroring owner eats one HTTP RTT per
                # non-owned prefetch forever
                _ERRORS.labels("transient").inc()
                peer.breaker.record_failure()
                return False
            peer.breaker.record_success()
            _WARM_HINTS.inc()
            return True
        except Exception:
            logger.exception("cache-group warm %s degraded", key)
            return False

    # -- observability ------------------------------------------------------
    def health(self) -> dict:
        """Cache-group section of `.status` (vfs/internal.py)."""
        with self._mu:
            peers = {a: p.breaker.snapshot() for a, p in self._peers.items()}
        return {
            "group": self.name,
            "self": self.self_addr,
            "ring_size": len(self.ring),
            "members": self.ring.members,
            "peers": peers,
        }

    def close(self) -> None:
        with self._mu:
            self._closed = True
            peers, self._peers = list(self._peers.values()), {}
        for p in peers:
            p.close()
