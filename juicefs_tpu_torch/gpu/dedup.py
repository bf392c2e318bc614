"""Content-addressed dedup over digest batches: the counterpart of
juicefs_tpu/tpu/dedup.py.

The reference sorts the 8 digest words plus the original index with a
9-key `lax.sort` and propagates group starts with a cummax. In torch the
same verdicts come from `torch.unique(dim=0, return_inverse=True)` (which
sorts rows) and a scatter-min of original indices over the groups.

Output convention (unchanged): for each group of equal digests, the
occurrence with the lowest original index is the representative (kept);
the rest are marked duplicate. first_idx maps every block to its
representative.
"""

from __future__ import annotations

import numpy as np
import torch

from .hash_torch import _as_int64, _as_words, digests_to_numpy, hash_device, resolve_device


def dedup_scan(digests: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """digests (N, 8) integer tensor -> (dup_mask (N,) bool, first_idx (N,)
    int32), both on the digests' device.

    dup_mask[i] is True iff block i's content equals an earlier (lower
    original index) block; first_idx[i] is that representative's index
    (i itself when unique or first occurrence).
    """
    n = digests.shape[0]
    dev = digests.device
    if n == 0:
        return (torch.zeros((0,), dtype=torch.bool, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    groups, inverse = torch.unique(digests, dim=0, return_inverse=True)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    first_of_group = torch.full((groups.shape[0],), n, dtype=torch.int64, device=dev)
    first_of_group = first_of_group.scatter_reduce(0, inverse, idx, "amin")
    first = first_of_group[inverse]
    return first != idx, first.to(torch.int32)


def scan_step(words, lane_counts, lengths, device=None):
    """Full single-device scan step: hash the packed batch, dedup it.

    Counterpart of `scan_step_jax`. Returns numpy (digests (B, 8) uint32,
    dup_mask (B,) bool, first_idx (B,) int32).
    """
    dev = resolve_device(device)
    h = hash_device(_as_words(words, dev), _as_int64(lane_counts, dev),
                    _as_int64(lengths, dev))
    dup, first = dedup_scan(h)
    return digests_to_numpy(h), dup.cpu().numpy(), first.cpu().numpy()


def dedup_digests(digests: list[bytes]):
    """Host-side helper over 32-byte digests (numpy), same output
    convention as dedup_scan (a copy of the reference helper)."""
    n = len(digests)
    dup = np.zeros(n, dtype=bool)
    first = np.arange(n, dtype=np.int32)
    seen: dict[bytes, int] = {}
    for i, d in enumerate(digests):
        j = seen.setdefault(d, i)
        if j != i:
            dup[i] = True
            first[i] = j
    return dup, first
