"""The hash's roofline: the bytes the work needs and the card's peak.

The work of hashing a batch is its blocks' own bytes, read once, and one
32-byte digest a block, written once. Lanes, padding to 64 lanes and any
staging a kernel does of its own are not counted, so every kernel that
does the same hashing is held to the same bound. The hash reads each word
once and does ~9 integer operations on it, below the card's integer rate
at its memory rate, so the bound is memory bandwidth.
"""

from __future__ import annotations

DIGEST_BYTES = 32
# the part of its name by which a device trace shows the program's hash
# kernel: the one-launch `jth256_block_digests` entry that every one-card
# hash batch runs is `(anonymous namespace)::row_chain_kernel<true>`
HASH_KERNEL = "row_chain_kernel"
# published device-memory rate by `torch.cuda.get_device_name`: the H100
# SXM's 3.35 TB/s (NVIDIA's data sheet)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def peak_bytes_per_s(kind: str):
    """The card's published memory rate, or None for a card not listed."""
    return PEAK_BYTES_PER_S.get(kind)


def hash_bytes(raw_bytes: int, blocks: int) -> int:
    """Bytes the hash of `blocks` blocks holding `raw_bytes` must move."""
    return raw_bytes + DIGEST_BYTES * blocks


def is_hash_kernel(name: str) -> bool:
    return HASH_KERNEL in name


def hash_roofline_pct(raw_bytes: int, blocks: int, kernel_s: float, kind: str):
    """Share of the card's peak the hash kernels reached, in %: the least
    time the bytes need at the peak over the kernels' device time. None
    when no kernel ran or the card's peak is not known."""
    peak = peak_bytes_per_s(kind)
    if kernel_s <= 0 or blocks <= 0 or peak is None:
        return None
    return 100.0 * hash_bytes(raw_bytes, blocks) / peak / kernel_s
