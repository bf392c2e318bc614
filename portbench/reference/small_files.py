"""The plan of the small-file cell, in plain Python and NumPy: what each
file holds and the verdict the inline-dedup stage must give it.

One writer writes files of `size` bytes, one after another. In every run
of `dup_every` files exactly one, at a seeded position, is a copy of one
of the `pool` pool files (a seeded one); the others hold content no other
file holds. A content id names what a file holds: pool file j is
-(j + 1), unique content k is k. Its bytes are a window of the run's
seeded random buffer: pool file j at offset j x stride, unique content k
at (pool + k) x stride, so no two contents share their bytes.

The pool files are written first and kept, so a copy's block must be
elided as an alias of its pool file's block, and a unique file's block
must not be. The digests are `jth256.py`'s.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .verdicts import verdicts

U64 = (1 << 64) - 1
PLAN_TAG = 6  # this plan's stream of the seed, apart from the other cells'


class Plan:
    """The content ids one writer writes, in order, from the seed alone."""

    def __init__(self, seed: int, dup_every: int, pool: int):
        s = seed & U64
        self.rng = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, PLAN_TAG])
        self.dup_every = dup_every
        self.pool = pool
        self.next_unique = 0
        self._run: list = []

    def next(self) -> int:
        if not self._run:
            at = int(self.rng.integers(0, self.dup_every))
            pick = int(self.rng.integers(0, self.pool))
            self._run = [-(pick + 1) if i == at else None for i in range(self.dup_every)]
        cid = self._run.pop(0)
        if cid is None:
            cid = self.next_unique
            self.next_unique += 1
        return cid

    def take(self, n: int) -> list[int]:
        return [self.next() for _ in range(n)]


def offset(cid: int, pool: int, stride: int) -> int:
    return (-cid - 1 if cid < 0 else pool + cid) * stride


def content(buf: bytes, cid: int, size: int, pool: int, stride: int) -> bytes:
    """The `size` bytes content `cid` holds."""
    off = offset(cid, pool, stride)
    if off + size > len(buf):
        raise ValueError(f"content {cid} lies past the {len(buf)}-byte buffer")
    return buf[off:off + size]


def aliases(cids: Sequence[int], pool: int) -> list:
    """For each file, the pool file its block must be an alias of, or None
    where it must be stored: the duplicate verdicts of the pool files
    followed by the files, each keyed by its content id."""
    keys = [-(j + 1) for j in range(pool)] + list(cids)
    first = verdicts(keys)[pool:]
    return [f if f < pool else None for f in first]
