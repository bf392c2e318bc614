"""Resolve a chunk's overlapping slice list into its visible read view
(reference: pkg/meta/slice.go buildSlice).

A chunk holds slices in write order; later writes shadow earlier ones.
`build_slice` returns non-overlapping segments sorted by position, with
`id == 0` segments representing holes (zeros), exactly covering
[0, max_written). Compaction (pkg/vfs/compact.go) rewrites this view as a
single slice.
"""

from __future__ import annotations

from .types import Slice


def build_slice(slices: list[Slice]) -> list[Slice]:
    if not slices:
        return []
    # newest-first: claim only ranges not yet covered by newer writes
    covered: list[tuple[int, int]] = []  # disjoint, sorted (start, end)
    segments: list[Slice] = []
    for s in reversed(slices):
        start, end = s.pos, s.pos + s.len
        if start >= end:
            continue
        # subtract `covered` from [start, end)
        cur = start
        for cs, ce in covered:
            if ce <= cur:
                continue
            if cs >= end:
                break
            if cs > cur:
                seg_end = min(cs, end)
                segments.append(
                    Slice(pos=cur, id=s.id, size=s.size, off=s.off + (cur - s.pos), len=seg_end - cur)
                )
            cur = max(cur, ce)
            if cur >= end:
                break
        if cur < end:
            segments.append(
                Slice(pos=cur, id=s.id, size=s.size, off=s.off + (cur - s.pos), len=end - cur)
            )
        covered = _merge(covered, (start, end))
    segments.sort(key=lambda x: x.pos)
    # fill interior holes with zero segments
    out: list[Slice] = []
    pos = 0
    for seg in segments:
        if seg.pos > pos:
            out.append(Slice(pos=pos, id=0, size=seg.pos - pos, off=0, len=seg.pos - pos))
        out.append(seg)
        pos = seg.pos + seg.len
    return out


def _merge(intervals: list[tuple[int, int]], new: tuple[int, int]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    ns, ne = new
    placed = False
    for s, e in intervals:
        if e < ns:
            out.append((s, e))
        elif s > ne:
            if not placed:
                out.append((ns, ne))
                placed = True
            out.append((s, e))
        else:
            ns, ne = min(ns, s), max(ne, e)
    if not placed:
        out.append((ns, ne))
    out.sort()
    return out
