"""Cache group: peer-to-peer distributed block cache across clients (a
copy of juicefs_tpu/cache; reference analog: JuiceFS enterprise cache
groups, the shape ML data-loading fleets use to hide object-store
latency).

N training workers reading the same dataset used to issue N cold GETs
per block — every client warmed its own disk cache from the object
store.  A cache group turns the fleet's disk caches into one
consistent-hash-partitioned tier:

    read miss -> owner peer (HTTP block GET) -> local cache -> backend

Membership rides the EXISTING meta session/heartbeat machinery: a mount
serving its cache publishes (cache_group, peer_addr, group_weight) in
its session info; every member rebuilds the ring from `do_list_sessions`
on the heartbeat cadence.  No new coordination service.

A cache group may DEGRADE, never fail a read: peer errors are classified
TRANSIENT, each peer has its own circuit breaker, and every miss/error
falls through to the object store (or, while the backend breaker is
open, to the ladder's EIO rung — the peer tier is a new rung ABOVE it).
"""

from .group import CacheGroup, GroupPeer  # noqa: F401
from .ring import HashRing  # noqa: F401
from .server import PeerBlockServer  # noqa: F401
