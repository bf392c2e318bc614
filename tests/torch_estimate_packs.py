"""Seeded packed batches for the compress estimator's tests, on the CPU and
on the card (this module imports no JAX, so the card tests can use it)."""

import numpy as np
import torch

from juicefs_tpu_torch.gpu.jth256 import pack_blocks

LANE = 1 << 16
TEXT = b"hello world "
TAIL = 3 * LANE + 777  # three whole lanes and a ragged fourth

# (B, M): one 4 MiB block, a 13-block batch (the ingest cell's mean) and a
# full 32-block batch, at fewer lanes a block where the batch is large
SHAPES = [(1, 64), (13, 4), (32, 4)]


def blocks(rng: np.random.Generator, b: int, m: int) -> list:
    """b blocks of at most m lanes: zero, text, random, the 3-lane + 777 B
    tail and a short random block, in turn."""
    full = m * LANE
    kinds = [lambda: bytes(full),
             lambda: (TEXT * (full // len(TEXT) + 1))[:full],
             lambda: rng.bytes(full),
             lambda: rng.bytes(min(TAIL, full)),
             lambda: rng.bytes(int(rng.integers(1, LANE)))]
    return [kinds[i % len(kinds)]() for i in range(b)]


def pack(seed: int, b: int, m: int):
    """Packed words (B, M, 128, 128) uint32 with random words in every lane
    past each block's lane count (the mask must drop them), and the counts
    as int64."""
    words, counts, _lengths = pack_with_lengths(seed, b, m)
    return words, counts


def pack_with_lengths(seed: int, b: int, m: int):
    """`pack`'s words and counts, and the blocks' byte lengths as int64."""
    rng = np.random.default_rng(seed)
    words, counts, lengths = pack_blocks(blocks(rng, b, m), pad_lanes=m)
    words = words.copy()
    for i in range(b):
        dead = words[i, int(counts[i]):]
        dead[...] = rng.integers(0, 1 << 32, size=dead.shape, dtype=np.uint32)
    return words, counts.astype(np.int64), lengths.astype(np.int64)


def short_block_pack(seed: int, b: int, m: int):
    """Words (B, M, 128, 128) uint32 of random lanes (dead ones too), and
    int64 lane counts and lengths for the row chain's one-CTA entries:
    counts m, 0, below m, past m and 1 in turn; odd lengths, one past 2^32
    (the spec mixes a length in mod 2^32)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(b, m, 128, 128), dtype=np.uint32)
    counts = np.array([(m, 0, max(1, m - 1), m + 5, 1)[i % 5] for i in range(b)],
                      dtype=np.int64)
    lengths = np.array([(m * LANE - 1, 777, (1 << 32) + 3 * LANE + 5, 1, 0)[i % 5]
                        for i in range(b)], dtype=np.int64)
    return words, counts, lengths


def np_histogram(words: np.ndarray, counts: np.ndarray, lane_offset: int = 0) -> np.ndarray:
    """Independent numpy histogram of the estimator's sample: lanes
    [lane_offset, lane_offset + M) of each block, counted below its count."""
    b, m = words.shape[:2]
    by = np.ascontiguousarray(words[:, :, ::16, ::16]).reshape(b, m, 64).view(np.uint8)
    out = np.zeros((b, 256), dtype=np.int64)
    for i in range(b):
        live = by[i, : max(0, min(int(counts[i]) - lane_offset, m))].reshape(-1)
        out[i] = np.bincount(live, minlength=256)
    return out


def as_int32(words: np.ndarray) -> torch.Tensor:
    """uint32 words as the int32 tensor the port carries them in."""
    return torch.from_numpy(words.view(np.int32))
