"""The hash kernels (the row chain's block-digests and lane-digests
entries, and the combine of a lane-split mesh) against hash_jax, bit for
bit, on the CPU.

The kernels' arithmetic is `jth256_step.cuh`, which the g++ twin
(`kernels.load_twin()`) builds here from the same source nvcc builds on
the card; the wrappers' plain versions (`chain_digests_ref`,
`combine_accs`) are what a CPU tensor runs. Both are held against the JAX
package: the Pallas row chain in interpret mode, `_row_chain_scan` with
`_lane_states(w, lane_offset)` where a lane offset is given, `_lane_accs`,
`_combine_accs` and the whole-batch `hash_packed_pallas` /
`hash_packed_jax`. Inputs come from numpy with a seed. Tolerance: exact
(uint32 words must be identical).
"""

from __future__ import annotations

import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juicefs_tpu.tpu  # noqa: F401  (loads the reference spec module)
from juicefs_tpu.tpu import hash_jax as hj
from juicefs_tpu_torch.gpu import hash_torch as ht
from juicefs_tpu_torch.gpu import kernels, sharding
from juicefs_tpu_torch.gpu.jth256 import hash_packed_np, pack_blocks
from torch_estimate_packs import pack_with_lengths, short_block_pack

ref_spec = sys.modules["juicefs_tpu.tpu.jth256"]
LANE = ref_spec.LANE_BYTES
CPU = torch.device("cpu")

# (lanes, m, tweak), as tests/test_torch_hash.py's CHAIN_CASES
CHAIN_CASES = [(5, 1, 0), (7, 3, 0x9E3779B9), (21, 3, 0), (70, 64, 0xDEADBEEF)]
OFFSETS = [0, 32, 1000, (1 << 32) - 1]


@pytest.fixture(scope="module")
def twin():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no C++ compiler: the CPU twin of the CUDA kernels cannot be built")
    return kernels.load_twin()


def _words(seed, n_lanes):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(n_lanes, 128, 128), dtype=np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int64).astype(np.uint32) if t.dtype == torch.int64 \
        else t.numpy().view(np.uint32)


def _ref_lane_digests(words, m, tweak, loff):
    """The JAX lane digests of flat words (L, 128, 128): the Pallas chain
    in interpret mode at offset 0, else `_row_chain_scan` from
    `_lane_states(w, loff)` over the tweaked words (whole blocks only),
    then `_lane_accs(s, loff)`."""
    n_lanes = words.shape[0]
    if loff == 0:
        s = np.asarray(hj._pallas_row_chain(
            jnp.asarray(words), m, jnp.asarray([tweak], dtype=jnp.uint32), interpret=True))
        # _lane_accs folds lane index li of a (B, M, 128) view: one lane a
        # row keeps lane l's index at l mod m when L is not a multiple of m
        per_lane = [np.asarray(hj._lane_accs(jnp.asarray(s[l][None, None]), l % m))[0, 0]
                    for l in range(n_lanes)] if n_lanes % m else \
            np.asarray(hj._lane_accs(jnp.asarray(s.reshape(-1, m, 128)))).reshape(-1, 8)
        return np.asarray(per_lane, dtype=np.uint32)
    assert n_lanes % m == 0
    w = jnp.asarray((words ^ np.uint32(tweak)).reshape(-1, m, 128, 128))
    s = hj._row_chain_scan(w, hj._lane_states(w, loff))
    return np.asarray(hj._lane_accs(s, loff)).reshape(-1, 8)


@pytest.mark.parametrize("n_lanes,m,tweak", CHAIN_CASES)
def test_twin_lane_digests_match_pallas_and_lane_accs(twin, n_lanes, m, tweak):
    words = _words(n_lanes * 13 + m, n_lanes)
    want = _ref_lane_digests(words, m, tweak, 0)
    got = twin.lane_digests(_t(words), m, tweak)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_lanes, 8)
    assert np.array_equal(_u32(got), want)
    plain = ht.chain_digests_ref(_t(words), m, tweak)
    assert np.array_equal(_u32(plain), want)


@pytest.mark.parametrize("loff", OFFSETS)
@pytest.mark.parametrize("n_lanes,m,tweak", [(5, 1, 0), (6, 3, 0x9E3779B9), (64, 64, 0)])
def test_twin_lane_digests_at_lane_offsets(twin, n_lanes, m, tweak, loff):
    words = _words(n_lanes * 7 + m + loff % 97, n_lanes)
    want = _ref_lane_digests(words, m, tweak, loff)
    assert np.array_equal(_u32(twin.lane_digests(_t(words), m, tweak, loff)), want)
    assert np.array_equal(_u32(ht.chain_digests_ref(_t(words), m, tweak, loff)), want)
    # the wrapper on a CPU tensor is the plain version, by block
    got = ht.lane_digests(_t(words).reshape(-1, m, 128, 128), tweak, loff)
    assert tuple(got.shape) == (n_lanes // m, m, 8)
    assert np.array_equal(_u32(got).reshape(-1, 8), want)


def _combine_inputs(seed, b, m):
    rng = np.random.default_rng(seed)
    accs = rng.integers(0, 1 << 32, size=(b, m, 8), dtype=np.uint32)
    # dead lanes (counts below m), a count of 0 and one past m
    counts = rng.integers(1, m + 1, size=b).astype(np.int32)
    counts[0] = 0
    counts[-1] = m + 3
    lengths = np.array([[0, 1, LANE + 1, 64 * LANE - 1][i % 4] for i in range(b)],
                       dtype=np.uint32)
    return accs, counts, lengths


@pytest.mark.parametrize("m", [1, 3, 64])
def test_twin_combine_matches_combine_accs(twin, m):
    accs, counts, lengths = _combine_inputs(40 + m, 9, m)
    want = np.asarray(hj._combine_accs(jnp.asarray(accs), jnp.asarray(counts),
                                       jnp.asarray(lengths)))
    t_counts = torch.from_numpy(counts.astype(np.int64))
    t_lengths = torch.from_numpy(lengths.astype(np.int64))
    got = twin.combine(_t(accs), t_counts, t_lengths)
    assert got.dtype == torch.int64 and tuple(got.shape) == (9, 8)
    assert np.array_equal(_u32(got), want)
    plain = ht.combine(_t(accs), t_counts, t_lengths)
    assert plain.dtype == torch.int64 and np.array_equal(_u32(plain), want)
    # the plain version takes the int64 digests of lane_accs as well
    wide = torch.from_numpy(accs.astype(np.int64))
    assert np.array_equal(_u32(ht.combine_accs(wide, t_counts, t_lengths)), want)


@pytest.mark.parametrize("pad_lanes,tweak", [(None, 0), (8, 0), (None, 0x1234567)])
def test_twin_and_plain_hash_end_to_end(twin, pad_lanes, tweak):
    rng = np.random.default_rng(60)
    blocks = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
              for n in (0, 1, 100, LANE - 1, LANE, LANE + 7, 3 * LANE, 5 * LANE + 1)]
    words, counts, lengths = ref_spec.pack_blocks(blocks, pad_lanes=pad_lanes)
    b, m = words.shape[:2]
    want = np.asarray(hj.hash_packed_pallas(words, counts, lengths, interpret=True,
                                            tweak=jnp.asarray([tweak], dtype=jnp.uint32)))
    t_counts = torch.from_numpy(counts.astype(np.int64))
    t_lengths = torch.from_numpy(lengths.astype(np.int64))
    d = twin.lane_digests(_t(words.reshape(b * m, 128, 128)), m, tweak)
    got = twin.combine(d.reshape(b, m, 8), t_counts, t_lengths)
    assert np.array_equal(_u32(got), want)
    plain = ht.hash_device(_t(words), t_counts, t_lengths, tweak)
    assert np.array_equal(_u32(plain), want)
    if tweak == 0:
        assert np.array_equal(want, np.asarray(hj.hash_packed_jax(words, counts, lengths)))
        assert ref_spec.digests_to_bytes(want) == [ref_spec.jth256(x) for x in blocks]


def test_cpu_plain_path_sets_modes():
    words, counts, lengths = ref_spec.pack_blocks([b"abc", b"x" * (LANE + 9)])
    ht._LAST_KERNEL_MODE = ht._LAST_FOLD_MODE = None
    before = dict(kernels.LAUNCHES)
    got = ht.hash_packed(words, counts, lengths, device="cpu")
    assert ht.last_kernel_mode() == "torch-cpu" and ht.last_fold_mode() == "torch-cpu"
    assert dict(kernels.LAUNCHES) == before  # no kernel launch on the CPU
    assert np.array_equal(got, np.asarray(hj.hash_packed_jax(words, counts, lengths)))


@pytest.mark.parametrize("n", [8, 4, 2])
def test_sharded_cpu_plane_equals_one_device(n):
    rng = np.random.default_rng(70 + n)
    blocks = [rng.integers(0, 256, size=s, dtype=np.uint8).tobytes()
              for s in (4 * LANE, 1, 3 * LANE + 5, 2 * LANE, LANE - 3)]
    words, counts, lengths = ref_spec.pack_blocks(blocks, pad_lanes=4)
    plane = sharding.ShardPlane([CPU] * n)
    assert plane.mesh is not None
    got = plane.hash_packed(words, counts, lengths)
    want = ht.hash_packed(words, counts, lengths, device="cpu")
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(hj.hash_packed_jax(words, counts, lengths)))


def test_wrappers_validate_input():
    with pytest.raises(ValueError):  # neither cuda nor cpu: never guessed
        ht.chain_digests(torch.empty((2, 128, 128), dtype=torch.int32, device="meta"), 1)
    with pytest.raises(ValueError):
        ht.combine(torch.empty((2, 1, 8), dtype=torch.int32, device="meta"),
                   torch.ones(2, dtype=torch.int64), torch.ones(2, dtype=torch.int64))
    with pytest.raises(ValueError):  # digests must be int32 (B, M, 8)
        ht.combine(torch.zeros((2, 1, 8), dtype=torch.int64),
                   torch.ones(2, dtype=torch.int64), torch.ones(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        ht.combine(torch.zeros((2, 0, 8), dtype=torch.int32),
                   torch.ones(2, dtype=torch.int64), torch.ones(2, dtype=torch.int64))
    with pytest.raises(TypeError):
        ht.chain_digests(torch.zeros((2, 128, 128), dtype=torch.int64), 1)


def test_kernel_entries_have_sources_and_signatures():
    """The live C entries, each in its source with a ctypes signature; the
    row chain's states entry and the estimator's one-card entry are gone."""
    assert set(kernels.ENTRY_SOURCES) == {"jth256_block_digests",
                                          "jth256_block_digests_estimate",
                                          "jth256_block_cta_digests",
                                          "jth256_block_cta_digests_estimate",
                                          "jth256_lane_digests", "jth256_combine",
                                          "compress_histogram", "compress_entropy"}
    assert set(kernels._SIGNATURES) == set(kernels.ENTRY_SOURCES)
    for src in set(kernels.ENTRY_SOURCES.values()):
        with open(f"{kernels.KERNEL_DIR}/{src}.cu") as f:
            text = f.read()
        for entry, s in kernels.ENTRY_SOURCES.items():
            if s == src:
                assert f'extern "C" int {entry}(' in text
        assert 'extern "C" int jth256_row_chain(' not in text
        assert 'extern "C" int compress_estimate(' not in text
    assert set(kernels.LAUNCHES) == {"jth256_row_chain", "jth256_block_digests",
                                     "jth256_block_digests_estimate",
                                     "jth256_lane_digests", "jth256_combine",
                                     "compress_histogram", "compress_entropy",
                                     "jth256_block_cta", "jth256_block_cta_estimate"}


# (B, M): one and three blocks of 1, 2 and 64 lanes
BLOCK_CASES = [(1, 1), (3, 1), (1, 2), (3, 2), (1, 64), (3, 64)]


def _block_inputs(seed, b, m):
    """Packed words (B, M, 128, 128) with dead lanes past the counts and
    lengths 0, 1 and 4 MiB - 1."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(b, m, 128, 128), dtype=np.uint32)
    counts = rng.integers(1, m + 1, size=b).astype(np.int32)
    counts[0] = max(1, m - 1)
    lengths = np.array([(0, 1, 64 * LANE - 1)[i % 3] for i in range(b)], dtype=np.uint32)
    return words, counts, lengths


@pytest.mark.parametrize("tweak", [0, 0x5BD1E995])
@pytest.mark.parametrize("b,m", BLOCK_CASES)
def test_twin_block_digests_match_pallas_and_xla(twin, b, m, tweak):
    """The block entry's arithmetic (lane digests, then the combine of each
    block over its live lanes) and `hash_device` on a CPU tensor equal
    `hash_packed_pallas` in interpret mode and `hash_packed_jax` (over the
    tweaked words), exactly."""
    words, counts, lengths = _block_inputs(80 + 7 * b + m + tweak % 5, b, m)
    want = np.asarray(hj.hash_packed_pallas(words, counts, lengths, interpret=True,
                                            tweak=jnp.asarray([tweak], dtype=jnp.uint32)))
    assert np.array_equal(want, np.asarray(hj.hash_packed_jax(
        words ^ np.uint32(tweak), counts, lengths)))
    t_counts = torch.from_numpy(counts.astype(np.int64))
    t_lengths = torch.from_numpy(lengths.astype(np.int64))
    got = twin.block_digests(_t(words.reshape(b * m, 128, 128)), m, t_counts, t_lengths, tweak)
    assert got.dtype == torch.int64 and tuple(got.shape) == (b, 8)
    assert np.array_equal(_u32(got), want)
    before = dict(kernels.LAUNCHES)
    plain = ht.hash_device(_t(words), t_counts, t_lengths, tweak)
    assert dict(kernels.LAUNCHES) == before  # the plain version: no launch
    assert plain.dtype == torch.int64 and np.array_equal(_u32(plain), want)


# the ingest cells' batch sizes, on each side of the wave boundaries of a
# fixed 32 KiB ring (12 / 13 and 24 / 25 blocks of 64 lanes on an H100);
# the CPU packs them at 16 lanes a block past one block
INGEST_BLOCKS = [1, 12, 13, 24, 25, 32]


@pytest.mark.parametrize("b", INGEST_BLOCKS)
def test_twin_block_entries_at_ingest_batch_sizes(twin, b):
    """Both block entries' arithmetic (twin), which streams each lane in
    the kernel's 8-row chunks, on whole, short and dead-laned blocks with a
    tweak: the digests of the block entry and of the estimating entry equal
    the numpy spec's (`hash_packed_np`) and the JAX package's
    `hash_packed_jax` of the tweaked words, exactly."""
    m = 64 if b == 1 else 16
    words, counts, lengths = pack_with_lengths(400 + b, b, m)
    tweak = 0x5BD1E995
    tweaked = words ^ np.uint32(tweak)
    want = hash_packed_np(tweaked, counts, lengths)
    np.testing.assert_array_equal(np.asarray(hj.hash_packed_jax(
        tweaked, counts.astype(np.int32), lengths.astype(np.uint32))), want)
    tc, tl = torch.from_numpy(counts), torch.from_numpy(lengths)
    flat = _t(words).reshape(b * m, 128, 128)
    np.testing.assert_array_equal(_u32(twin.block_digests(flat, m, tc, tl, tweak)), want)
    np.testing.assert_array_equal(
        _u32(twin.block_digests_estimate(flat, m, tc, tl, tweak)[0]), want)


# An H100's SMs, and the row chain's resident CTAs an SM at each ring depth
# as its shared memory implies: 228 KiB an SM, of which 1 KiB is reserved
# a CTA, taken in 128 B units; a CTA holds the ring (4 KiB a chunk), its
# static shared memory (768 B; 640 B in the lane-digests entry) and, in the
# estimating entry, 1072 B of histogram and entropy scratch; at most 16
# CTAs of 128 threads. These are the tables
# cudaOccupancyMaxActiveBlocksPerMultiprocessor gives on an H100 80GB HBM3.
H100_SMS = 132


def _h100_ctas(static: int, scratch: int) -> dict:
    def cta_bytes(depth):
        return -(-(4096 * depth + static + 1024 + scratch) // 128) * 128

    return {d: min(16, 233472 // cta_bytes(d)) for d in kernels.RING_DEPTHS}


H100_CTAS = {"estimate": _h100_ctas(768, 1072), "block": _h100_ctas(768, 0),
             "lane": _h100_ctas(640, 0)}


@pytest.mark.parametrize("entry", sorted(H100_CTAS))
def test_ring_depth_puts_each_batch_of_up_to_32_blocks_in_one_wave(entry):
    """The rule's ring for every batch of 1-32 blocks of 64 lanes holds
    ceil(lanes / SMs) CTAs an SM, so the launch is one wave; its depth
    never grows with the lane count; a batch past what an SM holds at
    once at the shallowest ring (2112 lanes) takes the large-batch ring."""
    ctas = H100_CTAS[entry]
    depths = []
    for b in range(1, 33):
        n = 64 * b
        depth = kernels.ring_depth(n, H100_SMS, ctas)
        assert ctas[depth] >= -(-n // H100_SMS), (b, depth)
        assert kernels.waves(n, H100_SMS, ctas[depth]) == 1
        depths.append(depth)
    assert depths[0] == max(kernels.RING_DEPTHS)  # one block: the whole lane in flight
    assert depths == sorted(depths, reverse=True)
    most = H100_SMS * ctas[min(kernels.RING_DEPTHS)]
    assert most == 2112
    assert kernels.ring_depth(most, H100_SMS, ctas) == min(kernels.RING_DEPTHS)
    for n in (most + 1, 4096, 16384):
        assert kernels.ring_depth(n, H100_SMS, ctas) == kernels.LARGE_BATCH_DEPTH
        assert kernels.waves(n, H100_SMS, ctas[kernels.LARGE_BATCH_DEPTH]) > 1


def test_ring_depth_on_an_h100():
    """The estimating entry's rings on an H100 at the ingest cells' batch
    sizes: the shallowest that keeps 8 MiB in flight, every lane resident;
    and the waves each size took at the fixed 32 KiB ring (8 chunks) that
    every launch had before."""
    ctas = H100_CTAS["estimate"]
    got = {b: kernels.ring_depth(64 * b, H100_SMS, ctas)
           for b in (1, 2, 4, 8, 12, 13, 16, 24, 25, 32)}
    assert got == {1: 16, 2: 16, 4: 8, 8: 4, 12: 3, 13: 3, 16: 2, 24: 2, 25: 2, 32: 1}
    assert [kernels.waves(64 * b, H100_SMS, ctas[8]) for b in (12, 13, 24, 25, 32)] == \
        [1, 2, 2, 3, 3]


@pytest.mark.parametrize("entry", ["block", "estimate"])
def test_ring_depth_holds_a_block_of_lane_digests(entry):
    """A block entry's ring also holds its block's lane digests (32 B a
    lane) for the last CTA's combine: blocks of 16 MiB (256 lanes) and
    12 MiB (192) need 2 chunks even where the lane count alone would give
    one, blocks of 64 MiB (1024 lanes) 8; the ring stays one wave where
    it can, and blocks past the deepest ring's 2048 lanes get a depth the
    kernel refuses."""
    ctas = H100_CTAS[entry]
    digests = kernels.LANE_DIGEST_BYTES
    assert kernels.ring_depth(2048, H100_SMS, ctas) == 1
    for b, m in ((8, 256), (11, 192)):
        depth = kernels.ring_depth(b * m, H100_SMS, ctas, m * digests)
        assert depth == 2 and depth * kernels.RING_CHUNK_BYTES >= m * digests
        assert kernels.waves(b * m, H100_SMS, ctas[depth]) == 1
    assert kernels.ring_depth(1024, H100_SMS, ctas, 1024 * digests) == 8
    assert kernels.ring_depth(16384, H100_SMS, ctas, 1024 * digests) == \
        kernels.LARGE_BATCH_DEPTH
    assert kernels.ring_depth(4096, H100_SMS, ctas, 4096 * digests) > max(kernels.RING_DEPTHS)


@pytest.mark.parametrize("m", range(1, 65))
def test_block_batches_take_the_one_cta_design_up_to_the_cut(m):
    """A block batch whose pack has m lanes a block takes each block entry's
    one-CTA design up to the cut, 4 lanes (blocks of 256 KiB and less), and
    the cross-CTA entry above it: the one-CTA kernel holds up to 8 lanes
    (8 x 128 threads, the most a CTA has), but from 5 lanes on its one SM's
    stream made it the slower design on the card."""
    assert kernels.CTA_BLOCK_LANES == 4
    for entry, cta in (("jth256_block_digests", "jth256_block_cta_digests"),
                       ("jth256_block_digests_estimate",
                        "jth256_block_cta_digests_estimate")):
        got = kernels.block_entry(entry, m)
        assert got == (cta if m <= 4 else entry)
        assert kernels.is_cta_entry(got) == (m <= 4)
        assert got in kernels.ENTRY_SOURCES and got in kernels._SIGNATURES


# The one-CTA entries' resident CTAs an SM on an H100 as their shared
# memory implies: the ring (m lanes x depth x 8 KiB), 4864 B of static
# shared memory (the mbarriers, states and lane digests of 8 lanes) and,
# estimating, the 1072 B of histogram and entropy scratch; at most 227 KiB
# a CTA (232,448 B, else the CTA cannot hold the ring: 0), 1 KiB reserved
# a CTA of the SM's 228 KiB, 128 B units; at most 2048 threads an SM, a
# CTA m x 128 threads and, estimating up to 7 lanes, its estimate warp's 32.
CTA_STATIC = 4864
CTA_SCRATCH = {"block": 0, "estimate": 1072}


def _h100_cta_ctas(m: int, scratch: int) -> dict:
    threads = 128 * m + (32 if scratch and 128 * m + 32 <= 1024 else 0)
    table = {}
    for d in kernels.CTA_RING_DEPTHS:
        held = m * d * kernels.CTA_CHUNK_BYTES + scratch + CTA_STATIC
        cta = -(-(held + 1024) // 128) * 128
        table[d] = 0 if held > 232448 else min(2048 // threads, 32, 233472 // cta)
    return table


@pytest.mark.parametrize("entry", sorted(CTA_SCRATCH))
@pytest.mark.parametrize("m", range(1, 9))
def test_one_cta_ring_puts_every_batch_of_up_to_32_short_blocks_in_one_wave(entry, m):
    """The ring rule over the one-CTA design's own occupancy table: every
    batch of 1-32 blocks of m lanes is one wave at a ring the CTA holds;
    blocks of up to 3 lanes keep their whole lanes resident (8 chunks),
    4-8 lanes the deepest ring that fits 227 KiB; a batch past what the
    card holds at once takes a ring the CTA holds, never a larger one."""
    ctas = _h100_cta_ctas(m, CTA_SCRATCH[entry])
    for b in range(1, 33):
        depth = kernels.ring_depth(b * m, H100_SMS, ctas, lanes_per_cta=m,
                                   chunk_bytes=kernels.CTA_CHUNK_BYTES)
        assert depth in kernels.CTA_RING_DEPTHS and ctas[depth] >= 1, (b, depth)
        assert m * depth * kernels.CTA_CHUNK_BYTES + CTA_SCRATCH[entry] + CTA_STATIC <= 232448
        assert kernels.waves(b, H100_SMS, ctas[depth]) == 1
        if b == 1:
            assert depth == {1: 8, 2: 8, 3: 8, 4: 6, 5: 5, 6: 4, 7: 3, 8: 3}[m]
    for b in (5000, 100_000):
        depth = kernels.ring_depth(b * m, H100_SMS, ctas, lanes_per_cta=m,
                                   chunk_bytes=kernels.CTA_CHUNK_BYTES)
        assert ctas[depth] >= 1 and kernels.waves(b, H100_SMS, ctas[depth]) > 1


# (B, M) of the one-CTA design: a block alone, two, a small-file batch
# mix and past one wave's worth of short blocks at 1-8 lanes
CTA_CASES = [(1, 1), (2, 1), (13, 1), (1, 2), (2, 2), (13, 2), (1, 3), (13, 3),
             (1, 4), (13, 4), (1, 8), (2, 8), (13, 8)]


@pytest.mark.parametrize("b,m", CTA_CASES)
def test_twin_one_cta_entry_matches_the_block_entries(twin, b, m):
    """The one-CTA design's arithmetic (twin: a block at a time, its live
    lanes alone in 16-row chunks, one histogram a block) gives the block
    entry's digests and the estimating entry's advisories bit for bit, the
    numpy spec's digests of the tweaked words, and the histogram and
    entropy entries' advisories."""
    words, counts, lengths = short_block_pack(500 + 17 * b + m, b, m)
    tc, tl = torch.from_numpy(counts), torch.from_numpy(lengths)
    flat = _t(words).reshape(b * m, 128, 128)
    for tweak in (0, 0x5BD1E995):
        want = hash_packed_np(words ^ np.uint32(tweak), counts, lengths)
        got, adv = twin.block_cta_digests_estimate(flat, m, tc, tl, tweak)
        assert got.dtype == torch.int64 and tuple(got.shape) == (b, 8)
        np.testing.assert_array_equal(_u32(got), want)
        cross, cross_adv = twin.block_digests_estimate(flat, m, tc, tl, tweak)
        assert torch.equal(got, cross) and torch.equal(adv, cross_adv)
        assert torch.equal(got, twin.block_digests(flat, m, tc, tl, tweak))
    hist = twin.estimate_histogram(_t(words), tc)
    assert torch.equal(adv, twin.estimate_entropy(hist))
    assert int(hist[counts == 0].sum()) == 0


def _estimate_packs(seed, m):
    """The one-CTA estimate's inputs at m lanes: a zero, a text, a random,
    a 3-lane + 777 B and a short block, each packed to m lanes with random
    words in the lanes past its count (dead lanes, which no one counts),
    and `short_block_pack`'s counts of m, 0, below m, past m and 1."""
    words, counts, _lengths = pack_with_lengths(seed, 5, m)
    packs = [(words, counts)]
    blocks = [np.random.default_rng(seed).bytes(777)]
    tail, tail_counts, _ = pack_blocks(blocks, pad_lanes=m)
    packs.append((tail.copy(), tail_counts.astype(np.int64)))
    words, counts, _lengths = short_block_pack(seed + 1, 5, m)
    packs.append((words, counts))
    return packs


@pytest.mark.parametrize("m", range(1, 9))
def test_twin_one_cta_estimate_gathers_apart_from_the_chain(twin, m):
    """The one-CTA estimating entry's arithmetic (twin) gathers a block's
    sample apart from the chain (`cest::gather_sample`, all m lanes as
    read) and bins its counted lanes' bytes (`cest::bin_sample`): at 1-8
    lanes, with dead lanes, a 777 B block, counts 0 and past m and a tweak,
    its advisories are the reduce256-order entropy of the plain torch
    histogram (`byte_histogram_ref`) bit for bit, and within 1e-5 of the
    plain torch estimate `entropy_ratio_ref(byte_histogram_ref(...))`; the
    tweak moves the digests, never the advisories."""
    from juicefs_tpu_torch.gpu import compress_batch as cb

    for words, counts in _estimate_packs(900 + m, m):
        b = words.shape[0]
        lengths = torch.full((b,), 777, dtype=torch.int64)
        tc = torch.from_numpy(counts)
        ref_hist = cb.byte_histogram_ref(_t(words), tc)
        want = twin.estimate_entropy(ref_hist.to(torch.int32).contiguous())
        plain = cb.entropy_ratio_ref(ref_hist)
        flat = _t(words).reshape(b * m, 128, 128)
        digests = []
        for tweak in (0, 0x5BD1E995):
            got, adv = twin.block_cta_digests_estimate(flat, m, tc, lengths, tweak)
            assert adv.dtype == torch.float32 and tuple(adv.shape) == (b,)
            assert torch.equal(adv, want), (m, tweak)
            np.testing.assert_allclose(adv.numpy(), plain.numpy(), rtol=0, atol=1e-5)
            digests.append(got)
        assert not torch.equal(digests[0][counts > 0], digests[1][counts > 0])


def test_twin_one_cta_estimate_holds_at_most_8_lanes(twin):
    """The twin, as the kernel, refuses a one-CTA block of more than 8
    lanes (a CTA's 1024 threads)."""
    words, counts, lengths = short_block_pack(3, 1, 9)
    with pytest.raises(RuntimeError, match="at most 8 lanes"):
        twin.block_cta_digests_estimate(_t(words).reshape(9, 128, 128), 9,
                                        torch.from_numpy(counts), torch.from_numpy(lengths), 0)


def test_arrival_counters_are_per_stream_and_grow_zeroed():
    """The block entry's counter workspace: one buffer per (device,
    stream), the same buffer while a batch fits, a new zeroed and larger
    one when it does not."""
    ht._ARRIVALS.clear()
    try:
        a = ht._arrivals(CPU, 11, 5)
        assert a.dtype == torch.int32 and a.numel() >= 5 and not a.any()
        assert ht._arrivals(CPU, 11, a.numel()) is a
        other = ht._arrivals(CPU, 12, 5)
        assert other is not a
        big = ht._arrivals(CPU, 11, a.numel() + 1)
        assert big is not a and big.numel() > a.numel() and not big.any()
        assert ht._arrivals(CPU, 11, 3) is big and ht._arrivals(CPU, 12, 3) is other
    finally:
        ht._ARRIVALS.clear()


def test_hash_device_validates_input():
    ok = torch.zeros((2, 1, 128, 128), dtype=torch.int32)
    ones = torch.ones(2, dtype=torch.int64)
    with pytest.raises(ValueError):  # a flat (L, 128, 128) tensor is not a batch
        ht.hash_device(ok.reshape(2, 128, 128), ones, ones)
    with pytest.raises(ValueError):  # neither cuda nor cpu: never guessed
        ht.hash_device(torch.empty((2, 1, 128, 128), dtype=torch.int32, device="meta"),
                       ones, ones)
    with pytest.raises(ValueError):  # the states entry is gone from the card
        ht.row_chain(torch.empty((2, 128, 128), dtype=torch.int32, device="meta"), 1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the block entry is CUDA C++ with no CPU mode "
                    "(its arithmetic is held above through the g++ twin)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_hash_device_is_one_launch_on_the_card(card):
    """On the card a hash batch is one launch of the block entry, equal to
    the plain version on the same words, and the counters stay zeroed (a
    second launch on the stream gives the same digests)."""
    words, counts, lengths = _block_inputs(97, 3, 64)
    t_counts = torch.from_numpy(counts.astype(np.int64))
    t_lengths = torch.from_numpy(lengths.astype(np.int64))
    want = ht.hash_device(_t(words), t_counts, t_lengths)
    dev_words = _t(words).to(card)
    kernels.reset_launches()
    got = ht.hash_device(dev_words, t_counts.to(card), t_lengths.to(card))
    again = ht.hash_device(dev_words, t_counts.to(card), t_lengths.to(card))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"jth256_row_chain": 2, "jth256_block_digests": 2,
                                "jth256_block_digests_estimate": 0,
                                "jth256_lane_digests": 0, "jth256_combine": 0,
                                "compress_histogram": 0, "compress_entropy": 0,
                                "jth256_block_cta": 0, "jth256_block_cta_estimate": 0}
    assert torch.equal(got.cpu(), want) and torch.equal(again.cpu(), want)


@pytest.mark.cuda
def test_hash_estimate_device_is_one_launch_on_the_card(card):
    """On the card a hash batch with its estimate is one launch of the
    estimating entry, its digests the block entry's and its advisories the
    estimator's, bit for bit, twice in a row on the stream."""
    from juicefs_tpu_torch.gpu import compress_batch as cb

    words, counts, lengths = _block_inputs(98, 3, 64)
    dev_words = _t(words).to(card)
    t_counts = torch.from_numpy(counts.astype(np.int64)).to(card)
    t_lengths = torch.from_numpy(lengths.astype(np.int64)).to(card)
    want = ht.hash_device(dev_words, t_counts, t_lengths)
    want_adv = cb.estimate(dev_words, t_counts)
    kernels.reset_launches()
    for _ in range(2):
        got, adv = ht.hash_estimate_device(dev_words, t_counts, t_lengths)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(adv, want_adv)
    assert kernels.LAUNCHES == {"jth256_row_chain": 2, "jth256_block_digests": 0,
                                "jth256_block_digests_estimate": 2,
                                "jth256_lane_digests": 0, "jth256_combine": 0,
                                "compress_histogram": 0, "compress_entropy": 0,
                                "jth256_block_cta": 0, "jth256_block_cta_estimate": 0}
