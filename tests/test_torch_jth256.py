"""The port's copy of the JTH-256 spec equals the JAX package's, bit for bit.

Inputs are made with numpy from a seed and go through both
juicefs_tpu.tpu.jth256 and juicefs_tpu_torch.gpu.jth256. Tolerance: exact.
"""

import sys

import numpy as np
import pytest

import juicefs_tpu.tpu  # noqa: F401  (loads the reference spec module)
from juicefs_tpu_torch.gpu import jth256 as port

ref = sys.modules["juicefs_tpu.tpu.jth256"]

LANE = ref.LANE_BYTES
SIZES = [0, 1, 100, LANE, LANE + 7, 3 * LANE, 4 << 20]


def _blocks(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in sizes]


def test_constants_match():
    for name in ("LANE_BYTES", "LANE_WORDS", "ROWS", "COLS", "BLOCK_BYTES",
                 "MAX_LANES", "DIGEST_BYTES", "P1", "P2", "P3", "P4", "P5",
                 "FM1", "FM2"):
        assert getattr(port, name) == getattr(ref, name), name
    assert np.array_equal(port.IV, ref.IV) and port.IV.dtype == ref.IV.dtype


@pytest.mark.parametrize("size", SIZES)
def test_jth256_matches_reference(size):
    (block,) = _blocks(size, [size])
    got = port.jth256(block)
    assert got == ref.jth256(block)
    assert port.digest_hex(got) == ref.digest_hex(got)


@pytest.mark.parametrize("pad_lanes", [None, 8])
def test_pack_blocks_matches_reference(pad_lanes):
    blocks = _blocks(11, [0, 1, 100, LANE, LANE + 7, 3 * LANE])
    for a, b in zip(port.pack_blocks(blocks, pad_lanes=pad_lanes),
                    ref.pack_blocks(blocks, pad_lanes=pad_lanes)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_pack_blocks_rejects_too_few_lanes():
    blocks = _blocks(12, [3 * LANE])
    with pytest.raises(ValueError):
        port.pack_blocks(blocks, pad_lanes=2)


def test_pack_into_matches_pack_blocks():
    # a reused staging buffer holding stale bytes must come out identical
    blocks = _blocks(13, [LANE + 7, 0, 3 * LANE, 100])
    words, counts, lengths = ref.pack_blocks(blocks, pad_lanes=4)
    buf = np.full((6, 4, 128, 128), -1, dtype=np.int32)
    got_counts, got_lengths = port.pack_into(buf, blocks)
    assert np.array_equal(buf[:4].view(np.uint32), words)
    assert np.array_equal(got_counts, counts)
    assert np.array_equal(got_lengths, lengths)
    with pytest.raises(ValueError):
        port.pack_into(np.zeros((1, 1, 128, 128), np.int32), _blocks(14, [LANE + 1]))


def test_hash_packed_np_matches_reference():
    blocks = _blocks(15, [0, 1, 100, LANE, LANE + 7, 3 * LANE, 5 * LANE + 3])
    words, counts, lengths = ref.pack_blocks(blocks, pad_lanes=8)
    got = port.hash_packed_np(words, counts, lengths)
    want = ref.hash_packed_np(words, counts, lengths)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert port.digests_to_bytes(got) == ref.digests_to_bytes(want)
    assert port.hash_blocks_np(blocks) == ref.hash_blocks_np(blocks)
