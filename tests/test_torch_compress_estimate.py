"""The compress estimator kernels' arithmetic on the CPU: the g++ twin of
juicefs_tpu_torch/gpu/kernels/compress_estimate.cu (its histogram and
entropy entries: the sample, lane mask, binning and entropy, from the same
compress_estimate.cuh) against the port's plain torch estimator, an
independent numpy histogram and the JAX package's `_make_estimator` (XLA
on the CPU); and the twin of the row chain's estimating entry
(jth256_row_chain.cu, `jth256_block_digests_estimate`: the sample binned
as the chain reads it) against the twin's block entry and estimator and
the JAX package's hash and estimator.

Histograms must be exact. The JAX estimator returns advisories only, so
its histogram is held through the plain torch version, which
tests/test_torch_compress.py holds to it. Advisories must be within 1e-5
of the JAX package's: float32 log2 and the order of the sum differ.
"""

import shutil

import numpy as np
import pytest
import torch

from juicefs_tpu.tpu import compress_batch as ref_cb
from juicefs_tpu.tpu import hash_jax as hj
from juicefs_tpu_torch.gpu import compress_batch as cb
from juicefs_tpu_torch.gpu import hash_torch as ht
from juicefs_tpu_torch.gpu import kernels
from torch_estimate_packs import SHAPES, np_histogram, pack, pack_with_lengths
from torch_estimate_packs import as_int32 as _t


@pytest.fixture(scope="module")
def twin():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no C++ compiler: the CPU twin of the CUDA kernels cannot be built")
    return kernels.load_twin()


def _estimate(twin, words, counts):
    """The twin's advisories of whole blocks: the histogram entry, then the
    entropy entry, as a batch's estimate runs on the card."""
    return twin.estimate_entropy(twin.estimate_histogram(words, counts))


@pytest.mark.parametrize("b,m", SHAPES)
def test_twin_histogram_is_exact(twin, b, m):
    """The kernel's histogram (twin) equals the plain torch one and numpy's,
    count for count, with random words in the dead lanes; the plain
    wrapper on a CPU tensor launches nothing."""
    words, counts = pack(11 + b, b, m)
    tc = torch.from_numpy(counts)
    got = twin.estimate_histogram(_t(words), tc)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, 256)
    before = dict(kernels.LAUNCHES)
    plain = cb.byte_histogram(_t(words), tc)
    assert dict(kernels.LAUNCHES) == before
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(got.numpy(), np_histogram(words, counts))
    assert int(got.sum()) == 256 * int(np.minimum(counts, m).sum())


@pytest.mark.parametrize("b,m", SHAPES)
def test_twin_estimate_matches_jax(twin, b, m):
    """The kernel's advisories (twin: the histogram entry then the entropy
    entry, and the entropy entry on the plain histogram) within 1e-5 of the
    JAX package's estimator and of the plain torch version; zero and text
    blocks below 0.5, full random blocks above 0.9; the two histograms give
    the same bits."""
    words, counts = pack(23 + b, b, m)
    tc = torch.from_numpy(counts)
    want = np.asarray(ref_cb._make_estimator()(words, counts.astype(np.int32)))
    got = _estimate(twin, _t(words), tc)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), cb.estimate(_t(words), tc).numpy(),
                               rtol=0, atol=1e-5)
    hist = cb.byte_histogram(_t(words), tc).to(torch.int32)
    assert torch.equal(twin.estimate_entropy(hist), got)
    p = got.tolist()
    assert p[0] < 0.5
    if b > 2:
        assert p[1] < 0.5 and p[2] > 0.9
    assert all(0.0 <= x <= 1.0 for x in p)


# (M, lane offsets the lanes are split at)
SPLITS = [(4, (1,)), (4, (2,)), (4, (1, 2, 3)), (64, (32,)), (64, (16, 32, 48))]


@pytest.mark.parametrize("m,cuts", SPLITS)
def test_twin_histogram_lane_offset_sums_to_whole(twin, m, cuts):
    """Histograms of lane shards, each with its lane offset (the mesh
    path's histogram entry), sum to the whole batch's exactly, as the plain
    torch shards do; each shard masks lanes by their global index."""
    b = 5
    words, counts = pack(41 + m + len(cuts), b, m)
    tc = torch.from_numpy(counts)
    whole = twin.estimate_histogram(_t(words), tc)
    edges = (0, *cuts, m)
    total = torch.zeros_like(whole)
    for lo, hi in zip(edges, edges[1:]):
        part = np.ascontiguousarray(words[:, lo:hi])
        got = twin.estimate_histogram(_t(part), tc, lo)
        np.testing.assert_array_equal(got.numpy(), np_histogram(part, counts, lo))
        np.testing.assert_array_equal(got.numpy(), cb.byte_histogram(_t(part), tc, lo).numpy())
        total += got
    assert torch.equal(total, whole)


def test_twin_empty_and_dead_blocks(twin):
    """A block with no counted lane has an empty histogram and the advisory
    0, as the JAX package gives; lane counts past M count M lanes."""
    words, counts = pack(5, 3, 4)
    counts = np.array([0, 9, 2], dtype=np.int64)
    tc = torch.from_numpy(counts)
    hist = twin.estimate_histogram(_t(words), tc)
    assert int(hist[0].sum()) == 0 and int(hist[1].sum()) == 4 * 256
    np.testing.assert_array_equal(hist.numpy(), np_histogram(words, counts))
    want = np.asarray(ref_cb._make_estimator()(words, counts.astype(np.int32)))
    got = _estimate(twin, _t(words), tc)
    assert float(got[0]) == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_estimator_wrappers_refuse_other_devices():
    """Neither CUDA nor the CPU: raised, never guessed."""
    words = torch.empty((1, 1, 128, 128), dtype=torch.int32, device="meta")
    counts = torch.ones(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cb.estimate(words, counts)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cb.byte_histogram(words, counts)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cb.entropy_ratio(torch.empty((1, 256), device="meta"))


# (B, M): one 4 MiB block, the ingest cells' ~13- and ~25-block batches (at
# fewer lanes a block), and a batch whose M is not a power of two; then the
# ingest cells' batch sizes on each side of the wave boundaries of a fixed
# 32 KiB ring on an H100 (12 / 13 and 24 / 25 blocks of 64 lanes), at 16
# lanes a block
FUSED_SHAPES = [(1, 64), (13, 4), (25, 2), (3, 3),
                (12, 16), (13, 16), (24, 16), (25, 16), (32, 16)]


@pytest.mark.parametrize("tweak", [0, 0x5BD1E995])
@pytest.mark.parametrize("b,m", FUSED_SHAPES)
def test_twin_hash_estimate_matches_block_entry_estimator_and_jax(twin, b, m, tweak):
    """The estimating entry's arithmetic (twin) on whole, short and
    dead-laned blocks: its digests equal the twin's block entry and the JAX
    package's hash of the tweaked words; its advisories equal the twin's
    estimator bit for bit (the tweak does not reach the sample) and the JAX
    package's `_make_estimator` within 1e-5."""
    words, counts, lengths = pack_with_lengths(61 + 3 * b + m, b, m)
    tc, tl = torch.from_numpy(counts), torch.from_numpy(lengths)
    flat = _t(words).reshape(b * m, 128, 128)
    digests, adv = twin.block_digests_estimate(flat, m, tc, tl, tweak)
    assert digests.dtype == torch.int64 and tuple(digests.shape) == (b, 8)
    assert adv.dtype == torch.float32 and tuple(adv.shape) == (b,)
    assert torch.equal(digests, twin.block_digests(flat, m, tc, tl, tweak))
    want = np.asarray(hj.hash_packed_jax(words ^ np.uint32(tweak), counts.astype(np.int32),
                                         lengths.astype(np.uint32)))
    np.testing.assert_array_equal(digests.numpy().astype(np.uint32), want)
    assert torch.equal(adv, _estimate(twin, _t(words), tc))
    ref = np.asarray(ref_cb._make_estimator()(words, counts.astype(np.int32)))
    np.testing.assert_allclose(adv.numpy(), ref, rtol=0, atol=1e-5)
    if tweak:
        assert torch.equal(adv, twin.block_digests_estimate(flat, m, tc, tl, 0)[1])


def test_twin_hash_estimate_counts_no_dead_lane(twin):
    """A block with no counted lane has the advisory 0 and a lane count past
    M counts M lanes, as the estimator's entries give; the dead lanes are
    still hashed (the digests are the block entry's)."""
    words, _counts, lengths = pack_with_lengths(9, 3, 4)
    counts = np.array([0, 9, 2], dtype=np.int64)
    tc, tl = torch.from_numpy(counts), torch.from_numpy(lengths)
    flat = _t(words).reshape(12, 128, 128)
    digests, adv = twin.block_digests_estimate(flat, 4, tc, tl)
    assert float(adv[0]) == 0.0
    assert torch.equal(adv, _estimate(twin, _t(words), tc))
    assert torch.equal(digests, twin.block_digests(flat, 4, tc, tl))


@pytest.mark.parametrize("b,m", FUSED_SHAPES[:2])
def test_hash_estimate_device_plain_on_the_cpu(twin, b, m):
    """`hash_estimate_device` on a CPU tensor runs the plain versions and
    launches nothing: the twin's digests exactly, the plain estimator's
    advisories."""
    words, counts, lengths = pack_with_lengths(71 + b, b, m)
    tw, tc, tl = _t(words), torch.from_numpy(counts), torch.from_numpy(lengths)
    before = dict(kernels.LAUNCHES)
    digests, adv = ht.hash_estimate_device(tw, tc, tl)
    assert dict(kernels.LAUNCHES) == before
    assert digests.dtype == torch.int64 and tuple(digests.shape) == (b, 8)
    assert adv.dtype == torch.float32 and tuple(adv.shape) == (b,)
    flat = tw.reshape(b * m, 128, 128)
    assert torch.equal(digests, twin.block_digests(flat, m, tc, tl))
    assert torch.equal(digests, ht.hash_device(tw, tc, tl))
    assert torch.equal(adv, cb.estimate(tw, tc))
    np.testing.assert_allclose(adv.numpy(), _estimate(twin, tw, tc).numpy(), rtol=0, atol=1e-5)
