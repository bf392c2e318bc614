"""The plan of the indexed-writer cell, in plain Python and NumPy: what
each block the writers upload holds, and the content-index row a complete
index holds for it.

Each of `writers` writers draws its blocks from a stream of its own: in
every run of `dup_every` blocks exactly one, at a seeded position, is one
of the `pool` pool blocks (a seeded one); the others are unique, numbered
writer, writer + writers, ... so that no two writers share one. A content
id names what a block holds: pool block j is -(j + 1), unique block k is
k. Its bytes are a window of the run's seeded random buffer: pool block j
at offset j x stride, unique block k at (pool + k) x stride.

Slice ids are handed out as the writers run, so the run records where
each slice lies in its writer's stream (`placed`: slice id -> (writer,
position of its block 0)); block `indx` of that slice is the stream's
block at position + indx. The pool is written first as one slice of its
own (`pool_sid`), pool block j at indx j. The digests are `jth256.py`'s.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from . import jth256

U64 = (1 << 64) - 1
STREAM_TAG = 2  # the writers' stream of the seed (as the ingest cells' writers)


class Plan:
    """The content ids writer `writer` of `writers` writes, in order, from
    the seed alone."""

    def __init__(self, seed: int, writer: int, writers: int, dup_every: int, pool: int):
        s = seed & U64
        self.rng = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, STREAM_TAG, writer])
        self.dup_every = dup_every
        self.pool = pool
        self.next_unique = writer
        self.step = writers
        self._run: list = []

    def next(self) -> int:
        if not self._run:
            at = int(self.rng.integers(0, self.dup_every))
            pick = int(self.rng.integers(0, self.pool))
            self._run = [-(pick + 1) if i == at else None for i in range(self.dup_every)]
        cid = self._run.pop(0)
        if cid is None:
            cid = self.next_unique
            self.next_unique += self.step
        return cid

    def take(self, n: int) -> list[int]:
        return [self.next() for _ in range(n)]


def content(buf: bytes, cid: int, size: int, pool: int, stride: int) -> bytes:
    """The `size` bytes content `cid` holds."""
    off = (-cid - 1 if cid < 0 else pool + cid) * stride
    if off + size > len(buf):
        raise ValueError(f"content {cid} lies past the {len(buf)}-byte buffer")
    return buf[off:off + size]


def content_ids(seed: int, placed: dict, keys: Iterable[tuple[int, int]], writers: int,
                dup_every: int, pool: int, pool_sid: int | None = None) -> dict:
    """(slice id, indx) -> the content id that block must hold, for each
    of `keys`, by the writers' plans (a block of `pool_sid` by the pool)."""
    keys = list(keys)
    need: dict[int, int] = {}
    for sid, indx in keys:
        if sid != pool_sid:
            w, first = placed[sid]
            need[w] = max(need.get(w, 0), first + indx + 1)
    plans = {w: Plan(seed, w, writers, dup_every, pool).take(n) for w, n in need.items()}
    out = {}
    for sid, indx in keys:
        if sid == pool_sid:
            out[(sid, indx)] = -(indx + 1)
        else:
            w, first = placed[sid]
            out[(sid, indx)] = plans[w][first + indx]
    return out


def rows(buf: bytes, seed: int, placed: dict, keys: Iterable[tuple[int, int]], *,
         writers: int, dup_every: int, pool: int, block_size: int, stride: int,
         pool_sid: int | None = None) -> dict:
    """(slice id, indx) -> (the block's bytes, its JTH-256 digest): the
    row a complete index holds for each of `keys`, with the bytes a read
    must give back."""
    cids = content_ids(seed, placed, keys, writers, dup_every, pool, pool_sid)
    blocks = {k: content(buf, c, block_size, pool, stride) for k, c in cids.items()}
    order = list(blocks)
    digests = jth256.digests([blocks[k] for k in order])
    return {k: (blocks[k], d) for k, d in zip(order, digests)}
