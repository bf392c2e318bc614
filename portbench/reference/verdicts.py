"""Duplicate verdicts by a plain dict: a block is a duplicate when an
earlier block in the same order has the same key (its content id or its
digest), and it belongs to the group of that first block."""

from __future__ import annotations

from typing import Hashable, Sequence


def verdicts(keys: Sequence[Hashable]) -> list[int]:
    """For each block, the index of the first block with its key: its
    own index when it is the first, so `first[i] != i` marks a duplicate."""
    first_of: dict[Hashable, int] = {}
    return [first_of.setdefault(k, i) for i, k in enumerate(keys)]


def duplicate_count(keys: Sequence[Hashable]) -> int:
    """How many blocks repeat a key seen before them."""
    return sum(f != i for i, f in enumerate(verdicts(keys)))
