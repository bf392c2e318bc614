"""Consistent-hash ring with bounded virtual nodes (a copy of
juicefs_tpu/cache/ring.py: the same members, weights and keys place
exactly as there).

Placement substrate for the cache group: each block key maps to one
owner peer, joins/leaves move only ~1/n of the keyspace, and weights
skew ownership toward bigger caches.  Virtual nodes smooth the
partition; the TOTAL vnode count is bounded so a large fleet cannot
make ring rebuilds (every heartbeat) quadratic.

Deterministic by construction — every member hashes the same membership
to the same ring, so owners agree without talking to each other (stale
membership windows are healed by the digest check on peer responses and
the object-store fallthrough, never by coordination).
"""

from __future__ import annotations

import bisect
import hashlib

DEFAULT_VNODES = 64
MAX_TOTAL_VNODES = 4096


def _hash(data: str) -> int:
    # md5 for spread (crc32 clusters badly on short similar keys); the
    # first 8 bytes are plenty of ring resolution
    return int.from_bytes(hashlib.md5(data.encode()).digest()[:8], "big")


class HashRing:
    """Immutable-after-rebuild consistent-hash ring.

    `rebuild({node: weight})` replaces the membership wholesale (the
    discovery loop always has the full view — incremental add/remove
    would just re-implement rebuild with more states to get wrong).
    """

    def __init__(self, vnodes: int = DEFAULT_VNODES,
                 max_total: int = MAX_TOTAL_VNODES):
        self.vnodes = max(1, vnodes)
        self.max_total = max_total
        # (points, owners, members) swapped as ONE tuple: readers run
        # unlocked on the read hot path, so a rebuild must never expose a
        # torn view (new points against old owners -> IndexError)
        self._state: tuple[list[int], list[str], dict[str, int]] = \
            ([], [], {})

    @property
    def _points(self) -> list[int]:
        return self._state[0]

    @property
    def _owners(self) -> list[str]:
        return self._state[1]

    @property
    def members(self) -> dict[str, int]:
        return dict(self._state[2])

    def __len__(self) -> int:
        return len(self._state[2])

    def rebuild(self, nodes: dict[str, int]) -> None:
        nodes = {n: max(1, int(w)) for n, w in nodes.items() if n}
        total_weight = sum(nodes.values())
        per_unit = self.vnodes
        if total_weight * per_unit > self.max_total:
            # bounded: scale everyone down proportionally, floor 1
            per_unit = max(1, self.max_total // max(total_weight, 1))
        points: list[tuple[int, str]] = []
        for node, weight in nodes.items():
            for i in range(per_unit * weight):
                points.append((_hash(f"{node}#{i}"), node))
        points.sort()
        self._state = ([p for p, _ in points], [n for _, n in points], nodes)

    def owner(self, key: str) -> str | None:
        """The peer owning `key`, or None on an empty ring."""
        points, owners, _ = self._state
        if not points:
            return None
        i = bisect.bisect_right(points, _hash(key))
        if i == len(points):
            i = 0
        return owners[i]

    def owners(self, key: str, n: int = 1) -> list[str]:
        """Up to `n` DISTINCT peers for `key`, walking clockwise from the
        owner (replica/fallback order)."""
        points, owners, members = self._state
        if not points or n <= 0:
            return []
        out: list[str] = []
        i = bisect.bisect_right(points, _hash(key))
        for step in range(len(points)):
            node = owners[(i + step) % len(points)]
            if node not in out:
                out.append(node)
                if len(out) >= min(n, len(members)):
                    break
        return out
