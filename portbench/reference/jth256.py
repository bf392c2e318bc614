"""JTH-256, frozen: a copy of the normative NumPy spec, kept with the
benchmark so that no later change to the program can move the yardstick.

A block is zero-padded to 64 KiB lanes of 128 x 128 little-endian uint32
words; each lane runs a 128-step row chain and a 16-step fold, the lanes
are combined in order, the byte length is mixed in and the result
finalised (murmur3 fmix) into 8 words, serialised uint32-LE: 32 bytes.
`jth256` hashes one block; `hash_packed_np` a packed batch, vectorised
over blocks and lanes; `digests` hashes a list of blocks in batches.
"""

from __future__ import annotations

import binascii
from typing import Iterable, Sequence

import numpy as np

LANE_BYTES = 65536  # one lane = 64 KiB = 128x128 uint32 words
LANE_WORDS = LANE_BYTES // 4
ROWS = 128
COLS = 128
BLOCK_BYTES = 4 << 20  # default max block (pkg/chunk/cached_store.go:39-40)
MAX_LANES = BLOCK_BYTES // LANE_BYTES  # 64
DIGEST_BYTES = 32

P1 = np.uint32(0x9E3779B1)
P2 = np.uint32(0x85EBCA77)
P3 = np.uint32(0xC2B2AE3D)
P4 = np.uint32(0x27D4EB2F)
P5 = np.uint32(0x165667B1)
FM1 = np.uint32(0x85EBCA6B)
FM2 = np.uint32(0xC2B2AE35)
IV = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)

_J128 = np.arange(128, dtype=np.uint32)
_K8 = np.arange(8, dtype=np.uint32)


def _rotl(x: np.ndarray, k: int) -> np.ndarray:
    return ((x << np.uint32(k)) | (x >> np.uint32(32 - k))).astype(np.uint32)


def _fmix(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = (x * FM1).astype(np.uint32)
    x = x ^ (x >> np.uint32(13))
    x = (x * FM2).astype(np.uint32)
    return x ^ (x >> np.uint32(16))


def pack_block(data: bytes) -> np.ndarray:
    """Zero-pad one block to whole lanes -> uint32 words (m, 128, 128)."""
    n = len(data)
    m = max(1, -(-n // LANE_BYTES))
    if n > BLOCK_BYTES:
        raise ValueError(f"block larger than {BLOCK_BYTES}: {n}")
    buf = data if n == m * LANE_BYTES else data + b"\0" * (m * LANE_BYTES - n)
    return np.frombuffer(buf, dtype="<u4").reshape(m, ROWS, COLS)


def jth256(data: bytes) -> bytes:
    """Normative single-block reference (vectorized only across the lane)."""
    w = pack_block(data)
    m = w.shape[0]
    h = IV.copy()
    for lane in range(m):
        li_p1 = np.uint32((lane * 0x9E3779B1) & 0xFFFFFFFF)
        li_p2 = np.uint32((lane * 0x85EBCA77) & 0xFFFFFFFF)
        li_p3 = np.uint32((lane * 0xC2B2AE3D) & 0xFFFFFFFF)
        s = (P5 ^ (_J128 * P1) ^ li_p3).astype(np.uint32)
        for r in range(ROWS):
            s = ((s ^ w[lane, r]) * P1).astype(np.uint32)
            s = (_rotl(s, 13) * P2).astype(np.uint32)
            s = s ^ (s >> np.uint32(15))
        g = s.reshape(16, 8)
        acc = (P4 ^ li_p2 ^ (_K8 * P1)).astype(np.uint32)
        for gi in range(16):
            acc = _rotl(((acc ^ g[gi]) * P3).astype(np.uint32), 11)
            acc = (acc + np.uint32((gi * 0x165667B1) & 0xFFFFFFFF)).astype(np.uint32)
        h = _rotl(((h ^ acc) * P2).astype(np.uint32), 17)
        h = (h + li_p1).astype(np.uint32)
    h = h ^ ((np.uint32(len(data)) + _K8 * P4).astype(np.uint32))
    return _fmix(h).astype("<u4").tobytes()


def digest_hex(digest: bytes) -> str:
    return binascii.hexlify(digest).decode()


# Batched packing and the batch hash, vectorised over blocks and lanes.

def pack_blocks(
    blocks: Sequence[bytes], pad_lanes: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a batch to fixed shape for a single compiled program.

    Returns (words (B, M, 128, 128) uint32, lane_counts (B,) int32,
    lengths (B,) uint32). Blocks shorter than M lanes are zero-padded;
    lane_counts masks the padded lanes out of the combine step, so padding
    never changes a digest.
    """
    counts = [max(1, -(-len(b) // LANE_BYTES)) for b in blocks]
    m = pad_lanes or max(counts, default=1)
    if max(counts, default=1) > m:
        raise ValueError(f"block needs {max(counts)} lanes > pad_lanes={m}")
    out = np.zeros((len(blocks), m, ROWS, COLS), dtype=np.uint32)
    for i, b in enumerate(blocks):
        w = pack_block(b)
        out[i, : w.shape[0]] = w
    lengths = np.array([len(b) for b in blocks], dtype=np.uint32)
    return out, np.array(counts, dtype=np.int32), lengths


def hash_packed_np(
    words: np.ndarray, lane_counts: np.ndarray, lengths: np.ndarray
) -> np.ndarray:
    """Vectorized batch hash: (B, M, 128, 128) -> (B, 8) uint32 digests."""
    b, m = words.shape[0], words.shape[1]
    lanes = np.arange(m, dtype=np.uint32)
    s = np.broadcast_to(
        P5 ^ (_J128 * P1)[None, None, :] ^ (lanes * P3)[None, :, None],
        (b, m, COLS),
    ).astype(np.uint32).copy()
    for r in range(ROWS):
        s = ((s ^ words[:, :, r, :]) * P1).astype(np.uint32)
        s = (_rotl(s, 13) * P2).astype(np.uint32)
        s = s ^ (s >> np.uint32(15))
    g = s.reshape(b, m, 16, 8)
    acc = np.broadcast_to(
        P4 ^ (lanes * P2)[None, :, None] ^ (_K8 * P1)[None, None, :],
        (b, m, 8),
    ).astype(np.uint32).copy()
    for gi in range(16):
        acc = _rotl(((acc ^ g[:, :, gi, :]) * P3).astype(np.uint32), 11)
        acc = (acc + np.uint32((gi * 0x165667B1) & 0xFFFFFFFF)).astype(np.uint32)
    h = np.broadcast_to(IV, (b, 8)).astype(np.uint32).copy()
    for lane in range(m):
        hn = _rotl(((h ^ acc[:, lane, :]) * P2).astype(np.uint32), 17)
        hn = (hn + np.uint32((lane * 0x9E3779B1) & 0xFFFFFFFF)).astype(np.uint32)
        live = (lane_counts > lane)[:, None]
        h = np.where(live, hn, h)
    h = h ^ ((lengths.astype(np.uint32)[:, None] + _K8[None, :] * P4).astype(np.uint32))
    return _fmix(h)


def digests_to_bytes(digests: np.ndarray) -> list[bytes]:
    """(B, 8) uint32 -> list of 32-byte digests (uint32-LE serialization)."""
    d = np.ascontiguousarray(np.asarray(digests), dtype="<u4")
    return [d[i].tobytes() for i in range(d.shape[0])]


def hash_blocks_np(blocks: Iterable[bytes]) -> list[bytes]:
    """Hash a batch of blocks on CPU (numpy). Digest-identical to jth256()."""
    blocks = list(blocks)
    if not blocks:
        return []
    words, counts, lengths = pack_blocks(blocks)
    return digests_to_bytes(hash_packed_np(words, counts, lengths))


def digests(blocks: Sequence[bytes], batch: int = 16) -> list[bytes]:
    """JTH-256 of each block, hashed `batch` blocks at a time (bounded
    memory: a packed batch of 4 MiB blocks is 4 MiB a block)."""
    out: list[bytes] = []
    for i in range(0, len(blocks), batch):
        out.extend(hash_blocks_np(blocks[i:i + batch]))
    return out
