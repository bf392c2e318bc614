"""Block object naming (a copy of juicefs_tpu/chunk/cached_store.py:119-134).

The layout must stay byte-identical to the reference's: a volume written by
the JAX package is read by the port as it stands. `CachedStore` itself is
still to be ported.
"""

from __future__ import annotations

from typing import Optional


def block_key(sid: int, indx: int, bsize: int) -> str:
    return f"chunks/{sid // 1_000_000}/{sid // 1_000}/{sid}_{indx}_{bsize}"


def parse_block_key(key: str) -> Optional[tuple[int, int, int]]:
    """chunks/a/b/{id}_{indx}_{bsize} -> (id, indx, bsize)"""
    if not key.startswith("chunks/"):
        return None
    base = key.rsplit("/", 1)[-1]
    parts = base.split("_")
    if len(parts) != 3:
        return None
    try:
        return int(parts[0]), int(parts[1]), int(parts[2])
    except ValueError:
        return None
