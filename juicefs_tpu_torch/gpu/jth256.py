"""JTH-256: the framework's content hash (the port's copy of the normative
spec in juicefs_tpu/tpu/jth256.py; the two must never drift).

The reference has no content addressing at all — block keys are slice-id
based (pkg/chunk/cached_store.go:73-78) and integrity is CRC32C transfer
checksums only (pkg/object/checksum.go:28-88). JTH-256 ("JuiceFS-TPU tree
hash, 256-bit") is the new content hash powering `gc --dedup`, `fsck
--hash`, and `sync --check-new` content compare. It is designed so that one
definition runs byte-identically as

  * this numpy reference (the normative spec, and the CPU verify path), and
  * the batched torch ops and the CUDA row-chain kernel in hash_torch.py,

which is the acceptance bar set by BASELINE.md (digests must match exactly).

Design rationale (why this shape): a block is at most 4 MiB; it is zero-
padded to 64 KiB *lanes*, and each lane is viewed as a 128x128 matrix of
little-endian uint32 words — exactly one VPU-friendly (8,128)-tileable tile
stack. All mixing is uint32 mul/xor/rotate/shift (ARX + multiply), which the
TPU VPU executes natively and which wraps identically in numpy, JAX, and
Pallas. The only sequential chains are short: a 128-step row scan per lane,
a 16-step fold, and a per-block lane combine (<=64 steps) over tiny 8-word
states; everything else is embarrassingly parallel over (blocks x lanes x
128 columns), which is what lets a scan feed the MXU-era VPU at HBM rate.

Normative definition
--------------------
Constants: P1..P5 are the xxhash32 primes, FM1/FM2 the murmur3 finalizer
multipliers, IV the SHA-256 initial words. All arithmetic is mod 2^32;
rotl(x,k) rotates left.

  lane_compress(W[128][128], lane):             # W = one 64 KiB lane
      s[j]   = P5 ^ (j*P1) ^ (lane*P3)                    j in [0,128)
      repeat for r in [0,128):
          s = (s ^ W[r]) * P1
          s = rotl(s, 13) * P2
          s = s ^ (s >> 15)
      G      = s viewed as [16][8]
      acc[k] = P4 ^ (lane*P2) ^ (k*P1)                    k in [0,8)
      repeat for g in [0,16):
          acc = rotl((acc ^ G[g]) * P3, 11) + g*P5
      return acc                                          # 8 words

  jth256(data):
      n = len(data); m = max(1, ceil(n / 65536))
      pad data with zeros to m*65536 bytes; W = lanes as uint32-LE
      h = IV
      for i in [0,m): h = rotl((h ^ lane_compress(W[i], i)) * P2, 17) + i*P1
      h = h ^ (n + k*P4)                                  k in [0,8)
      h = fmix(h)    # x^=x>>16; x*=FM1; x^=x>>13; x*=FM2; x^=x>>16
      digest = h serialized uint32-LE (32 bytes)

Trailing zeros inside the final lane cannot collide with the unpadded block
because the exact byte length n is mixed before finalization; lane and word
positions are bound by the lane/j/k tweaks in every initial state.
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


# ---------------------------------------------------------------------------
# Batched packing + vectorized numpy batch implementation (the fast CPU path
# used by --hash-backend=cpu and by the byte-identical verification tests).
# ---------------------------------------------------------------------------

def pack_blocks(
    blocks: Sequence[bytes], pad_lanes: int | None = None, multiple: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a batch to fixed shape for a single compiled program.

    Returns (words (B, M, 128, 128) uint32, lane_counts (B,) int32,
    lengths (B,) uint32). M is `pad_lanes`, else the longest block's lanes;
    with `multiple`, M is the longest block's lanes rounded up to a
    multiple of it, and `pad_lanes` only its ceiling. A block longer than
    the ceiling raises. Blocks shorter than M lanes are zero-padded;
    lane_counts masks the padded lanes out of the combine step, so padding
    never changes a digest.
    """
    counts = [max(1, -(-len(b) // LANE_BYTES)) for b in blocks]
    need = max(counts, default=1)
    m = pad_lanes or need
    if multiple:
        fit = -(-need // multiple) * multiple
        m = min(m, fit) if pad_lanes else fit
    if need > m:
        raise ValueError(f"block needs {need} lanes > pad_lanes={m}")
    out = np.zeros((len(blocks), m, ROWS, COLS), dtype=np.uint32)
    for i, b in enumerate(blocks):
        w = pack_block(b)
        out[i, : w.shape[0]] = w
    lengths = np.array([len(b) for b in blocks], dtype=np.uint32)
    return out, np.array(counts, dtype=np.int32), lengths


def pack_into(
    out: np.ndarray, blocks: Sequence[bytes]
) -> tuple[np.ndarray, np.ndarray]:
    """Pack a batch into a caller-owned word buffer, in place.

    `out` is a C-contiguous (N >= B, M, 128, 128) array of 32-bit words
    (the numpy view of a pinned host tensor); out[:B] ends up equal to
    pack_blocks(blocks, pad_lanes=M)[0], byte for byte. Returns
    (lane_counts (B,) int32, lengths (B,) uint32).
    """
    if len(blocks) > out.shape[0]:
        raise ValueError(f"{len(blocks)} blocks > buffer of {out.shape[0]}")
    m = out.shape[1]
    counts = np.empty(len(blocks), dtype=np.int32)
    lengths = np.empty(len(blocks), dtype=np.uint32)
    for i, b in enumerate(blocks):
        n = len(b)
        if n > m * LANE_BYTES:
            raise ValueError(f"block needs {-(-n // LANE_BYTES)} lanes > pad_lanes={m}")
        row = out[i].reshape(-1).view(np.uint8)
        row[:n] = np.frombuffer(b, dtype=np.uint8)
        row[n:] = 0
        counts[i] = max(1, -(-n // LANE_BYTES))
        lengths[i] = n
    return counts, lengths


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
