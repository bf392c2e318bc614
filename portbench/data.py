"""Block content made from the run's seed.

A random buffer (1 GiB by default) is drawn on the card with a seeded
`torch.Generator` in one call and copied to the host once. Every block is
a window of it: the 4 pool blocks at the first offsets, unique block k at
the (pool + k)-th. Offsets step by `stride` bytes and are never reused, so
no two windows share content and a run pays no generation cost in its
window. A content id names a window: pool block j is -(j + 1), unique
block k is k.
"""

from __future__ import annotations

import numpy as np

U64 = (1 << 64) - 1


def seed_key(seed: int, *more: int) -> list[int]:
    """A numpy seed sequence entropy list for any whole number."""
    s = seed & U64
    return [s & 0xFFFFFFFF, s >> 32, *more]


def random_buffer(seed: int, nbytes: int, device) -> bytes:
    """`nbytes` random bytes (a multiple of 4) drawn on `device` with a
    generator seeded by `seed`, as one host bytes object."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed & U64)
    words = torch.randint(-(1 << 31), 1 << 31, (nbytes // 4,), dtype=torch.int32,
                          device=device, generator=gen)
    host = words.cpu().numpy()
    del words
    return host.tobytes()


class Contents:
    """Windows of the seeded buffer by content id."""

    def __init__(self, buf: bytes, block_size: int, pool: int, stride: int):
        self.buf = buf
        self.bs = block_size
        self.n_pool = pool
        self.stride = stride
        # duplicates are the same bytes object each time, as a writer that
        # writes one file again hands the same buffer over
        self.pool = [self.window(-(j + 1)) for j in range(pool)]

    def offset(self, cid: int) -> int:
        slot = -cid - 1 if cid < 0 else self.n_pool + cid
        return slot * self.stride

    def window(self, cid: int, size: int | None = None) -> bytes:
        size = self.bs if size is None else size
        off = self.offset(cid)
        if off + size > len(self.buf):
            raise ValueError(f"content {cid} lies past the {len(self.buf)}-byte buffer")
        return self.buf[off:off + size]

    def block(self, cid: int, size: int | None = None) -> bytes:
        """The bytes of content `cid` (a pool block is its shared object)."""
        if cid < 0 and (size is None or size == self.bs):
            return self.pool[-cid - 1]
        return self.window(cid, size)


def volume_plan(seed: int, n_full: int, block_size: int, tail: int,
                dup_share: float, pool: int) -> list[tuple[int, int]]:
    """(content id, size) of each block of a volume: `n_full` full blocks
    of which exactly round(dup_share * n_full), at seeded positions, are
    drawn from the pool, then one ragged tail block of `tail` bytes. A
    fixed count keeps every seed's work the same."""
    rng = np.random.default_rng(seed_key(seed, 1))
    n_dup = round(n_full * dup_share)
    dup_at = set(int(i) for i in rng.permutation(n_full)[:n_dup])
    picks = rng.integers(0, pool, size=n_full)
    plan, k = [], 0
    for i in range(n_full):
        if i in dup_at:
            plan.append((-(int(picks[i]) + 1), block_size))
        else:
            plan.append((k, block_size))
            k += 1
    plan.append((k, tail))
    return plan


def planted_duplicates(blocks: list) -> int:
    """Blocks that repeat an earlier block's object: pool entries are
    reused bytes objects (as chip_smoke.py's plan_blocks counts them)."""
    seen: set[int] = set()
    dups = 0
    for b in blocks:
        dups += id(b) in seen
        seen.add(id(b))
    return dups


class WriterStream:
    """The content ids one writer writes, in order: in every run of
    `dup_every` blocks exactly one, at a seeded position, is a pool block
    (a seeded one of `pool`); the rest are unique blocks numbered
    writer, writer + writers, ... so that writers never share one. The
    ids depend only on the seed and the writer, never on timing."""

    def __init__(self, seed: int, writer: int, writers: int, dup_every: int, pool: int):
        self.rng = np.random.default_rng(seed_key(seed, 2, writer))
        self.next_unique = writer
        self.step = writers
        self.dup_every = dup_every
        self.pool = pool
        self._group: list = []

    def next(self) -> int:
        if not self._group:
            at = int(self.rng.integers(0, self.dup_every))
            pick = int(self.rng.integers(0, self.pool))
            self._group = [-(pick + 1) if i == at else None for i in range(self.dup_every)]
        cid = self._group.pop(0)
        if cid is None:
            cid = self.next_unique
            self.next_unique += self.step
        return cid
