"""The compress estimator's kernel (juicefs_tpu_torch/gpu/kernels/
compress_estimate.cu: its histogram and entropy entries) on the card
against the plain torch version on the CPU: histograms exact, advisories
within 1e-5 (float32 log2 and the order of the sum differ); and the row
chain's block entries (jth256_row_chain.cu, `jth256_block_digests` and
`jth256_block_digests_estimate`) against the plain references at the
batch sizes around the ring's wave boundaries and at 1 GiB: digests bit
for bit the numpy spec's (`hash_packed_np`), advisories bit for bit the
histogram and entropy entries' (which share the estimate's arithmetic,
compress_estimate.cuh, and whose histogram is the plain one exactly) and
within 1e-5 of the plain torch estimate; and the ring each launch takes.
Every test needs a CUDA card and skips without one; the kernels'
arithmetic is held on the CPU through their g++ twin
(test_torch_compress_estimate.py, test_torch_hash_fold.py). This file
imports no JAX.
"""
import json
import os

import numpy as np
import pytest
import torch

from juicefs_tpu_torch.gpu import compress_batch as cb
from juicefs_tpu_torch.gpu import hash_torch as ht
from juicefs_tpu_torch.gpu import kernels, sharding
from juicefs_tpu_torch.gpu.jth256 import hash_packed_np, pack_blocks, pack_into
from torch_estimate_packs import SHAPES, blocks, np_histogram, pack, pack_with_lengths
from torch_estimate_packs import as_int32 as _t

ESTIMATE_ENTRIES = ("compress_histogram", "compress_entropy")
HASH_ENTRIES = ("jth256_row_chain", "jth256_block_digests", "jth256_block_digests_estimate",
                "jth256_lane_digests", "jth256_combine")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the estimator kernel is CUDA C++ with no CPU mode "
                    "(its arithmetic is held through the g++ twin)")
    return torch.device("cuda")


def _launches() -> dict:
    return {k: kernels.LAUNCHES[k] for k in ESTIMATE_ENTRIES}


def _card_ops(fn, tmp_path) -> list:
    """(category, name) of every kernel, memcpy and memset the card ran for
    fn(), in order, as a profiler recording card activity alone sees them.
    A spin of the card goes first and only what follows it is returned:
    such a profiler can drop the first operation it would see. A capture
    that holds no card operation at all, not even the spin, saw nothing
    (the card tests met one now and then) and is taken again, up to three
    times; `kernels.LAUNCHES` then counts the last capture's launches."""
    for attempt in range(3):
        if attempt:
            kernels.reset_launches()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100_000)
            fn()
            torch.cuda.synchronize()
        path = os.path.join(tmp_path, f"card{attempt}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        ops = sorted((float(e["ts"]), e.get("cat"), e.get("name")) for e in events
                     if e.get("ph") == "X"
                     and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
        if ops:
            break
    spins = [i for i, (_ts, _cat, name) in enumerate(ops) if "spin_kernel" in name]
    return [(cat, name) for _ts, cat, name in ops[spins[-1] + 1 if spins else 0:]]


@pytest.mark.cuda
@pytest.mark.parametrize("b,m", SHAPES + [(13, 64)])
def test_kernel_matches_plain_on_seeded_packs(card, b, m):
    """Each entry on the card against the plain torch version on the CPU:
    the histogram entry exact (whole blocks and lane shards with their
    offsets), the estimate (histogram, then entropy) within 1e-5, the
    entropy entry on the histogram bit for bit the estimate."""
    words, counts = pack(101 + b + m, b, m)
    cw, cc = _t(words), torch.from_numpy(counts)
    dw, dc = cw.to(card), cc.to(card)
    kernels.reset_launches()
    hist = cb.byte_histogram(dw, dc)
    pred = cb.estimate(dw, dc)
    ent = cb.entropy_ratio(hist)
    torch.cuda.synchronize()
    assert _launches() == {"compress_histogram": 2, "compress_entropy": 2}
    assert torch.equal(hist.cpu(), cb.byte_histogram(cw, cc))
    np.testing.assert_array_equal(hist.cpu().numpy(), np_histogram(words, counts))
    np.testing.assert_allclose(pred.cpu().numpy(), cb.estimate(cw, cc).numpy(),
                               rtol=0, atol=1e-5)
    assert torch.equal(ent, pred)
    half = m // 2 or 1
    parts = [cb.byte_histogram(dw[:, :half].contiguous(), dc, 0)]
    if half < m:
        parts.append(cb.byte_histogram(dw[:, half:].contiguous(), dc, half))
    assert torch.equal(sum(parts), hist)


@pytest.mark.cuda
def test_estimate_is_the_histogram_then_the_entropy_kernel(card, tmp_path):
    """An estimate on the card is one launch of the histogram entry and one
    of the entropy entry, two kernels, with no memset or fill before them
    (the workspace is zeroed once, when it is made)."""
    words, counts = pack(7, 13, 64)
    dw, dc = _t(words).to(card), torch.from_numpy(counts).to(card)
    cb.estimate(dw, dc)  # builds the library and makes the stream's workspace
    kernels.reset_launches()
    ops = _card_ops(lambda: cb.estimate(dw, dc), tmp_path)
    assert _launches() == {"compress_histogram": 1, "compress_entropy": 1}
    assert [cat for cat, _name in ops] == ["kernel", "kernel"], ops
    assert "compress_histogram_kernel" in ops[0][1] and "compress_entropy_kernel" in ops[1][1]


@pytest.mark.cuda
def test_workspace_is_zero_after_each_launch(card):
    """The stream's workspace is zero again after every launch, so a second
    call on the stream agrees bit for bit; a larger batch gets a larger
    workspace, and another stream its own."""
    words, counts = pack(13, 32, 4)
    dw, dc = _t(words).to(card), torch.from_numpy(counts).to(card)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        first = cb.estimate(dw[:1], dc[:1])
        whole = cb.estimate(dw, dc)
        hist = cb.byte_histogram(dw, dc)
        again = cb.estimate(dw, dc)
        torch.cuda.synchronize()
        work, size = ht._ARRIVALS[("compress_histogram", dw.device.index, stream.cuda_stream)]
    assert size >= 32 and work.numel() == size * cb._WORK_WORDS and not work.any()
    assert torch.equal(again, whole) and torch.equal(first, whole[:1])
    assert torch.equal(cb.entropy_ratio(hist), whole)
    default = cb.estimate(dw, dc)
    torch.cuda.synchronize()
    assert torch.equal(default, whole)


def _advised(plane, packed, n):
    """The advisories of the plane's advised hash of a placed pack."""
    with plane.advised() as advice:
        plane.hash_async(*packed)
    return advice[0][:n]


@pytest.mark.cuda
def test_shard_plane_advisories_equal_one_card(card):
    """On ShardPlane([cuda:0] * k) the advised hash's estimate (a histogram
    per shard with its lane offset, their sum, the entropy entry per data
    row) equals the one-card plane's, computed in its hash launch, bit for
    bit."""
    rng = np.random.default_rng(29)
    batch = blocks(rng, 13, 64)
    packed = pack_blocks(batch, pad_lanes=64)
    one = sharding.ShardPlane([card])
    want = _advised(one, one.put_packed(*packed), len(batch))
    for k, (rows, lanes) in ((2, (2, 1)), (4, (2, 2)), (8, (4, 2))):
        plane = sharding.ShardPlane([card] * k)
        sp = plane.put_packed(*packed)
        kernels.reset_launches()
        got = _advised(plane, sp, len(batch))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want.cpu()), k
        assert _launches() == {"compress_histogram": rows * lanes, "compress_entropy": rows}
        assert kernels.LAUNCHES["jth256_block_digests_estimate"] == 0


def _hash_launches() -> dict:
    return {k: kernels.LAUNCHES[k] for k in HASH_ENTRIES + ESTIMATE_ENTRIES}


def _fused(words, counts, lengths, tweak=0):
    return ht.hash_estimate_device(words, counts, lengths, tweak)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m", [(1, 64), (8, 64), (12, 64), (13, 64), (24, 64), (25, 64),
                                 (32, 64), (256, 64), (1, 2), (1, 1), (4, 2), (4, 4)])
def test_estimating_hash_entry_matches_both_entries(card, b, m):
    """Both block entries against the plain references on seeded packs of
    whole, short and dead-laned blocks of 64 lanes, on each side of the
    wave boundaries of a fixed 32 KiB ring (12 / 13 and 24 / 25 blocks)
    and at 1 GiB, and on the packs of 1, 2 and 4 lanes a small-file ingest
    batch takes (sized to its longest block), with and without a tweak:
    the digests of the block entry
    and of the estimating entry bit for bit `hash_packed_np`'s of the
    tweaked words; the advisories bit for bit the histogram and entropy
    entries', whose histogram is the plain one exactly, within 1e-5 of the
    plain torch estimate, and unmoved by the tweak (the estimate samples
    the words as read)."""
    words, counts, lengths = pack_with_lengths(300 + b, b, m)
    dw = _t(words).to(card)
    dc, dl = torch.from_numpy(counts).to(card), torch.from_numpy(lengths).to(card)
    hist = cb.byte_histogram(dw, dc)
    want_a = cb.estimate(dw, dc)
    plain_a = cb.entropy_ratio_ref(cb.byte_histogram_ref(dw, dc))
    for tweak in (0, 0x5BD1E995):
        want_d = hash_packed_np(words ^ np.uint32(tweak), counts, lengths)
        block_d = ht.hash_device(dw, dc, dl, tweak)
        got_d, got_a = _fused(dw, dc, dl, tweak)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(block_d.cpu().numpy().astype(np.uint32), want_d)
        np.testing.assert_array_equal(got_d.cpu().numpy().astype(np.uint32), want_d)
        assert torch.equal(got_a, want_a)
    np.testing.assert_array_equal(hist.cpu().numpy(), np_histogram(words, counts))
    np.testing.assert_allclose(got_a.cpu().numpy(), plain_a.cpu().numpy(), rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m", [(8, 256), (11, 192)])
def test_block_entries_hash_blocks_past_8_mib(card, b, m):
    """Blocks of 16 MiB (8 of them, 2048 lanes) and 12 MiB (11, 2112
    lanes), the sizes at which a ring picked from the lane count alone
    would be one chunk, too small for the block's lane digests that the
    last CTA stages there: both block entries give `hash_packed_np`'s
    digests bit for bit, and the advisories are the histogram and entropy
    entries'. The blocks are packed as gc, fsck and ingest pack them, into
    a buffer of the volume's lanes a block (`pack_into`), with random
    words in the dead lanes."""
    rng = np.random.default_rng(400 + b)
    words = np.zeros((b, m, 128, 128), dtype=np.uint32)
    counts, lengths = (x.astype(np.int64) for x in pack_into(words, blocks(rng, b, m)))
    for i in range(b):
        dead = words[i, int(counts[i]):]
        dead[...] = rng.integers(0, 1 << 32, size=dead.shape, dtype=np.uint32)
    dw = _t(words).to(card)
    dc, dl = torch.from_numpy(counts).to(card), torch.from_numpy(lengths).to(card)
    want_d = hash_packed_np(words, counts, lengths)
    want_a = cb.estimate(dw, dc)
    block_d = ht.hash_device(dw, dc, dl)
    got_d, got_a = _fused(dw, dc, dl)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(block_d.cpu().numpy().astype(np.uint32), want_d)
    np.testing.assert_array_equal(got_d.cpu().numpy().astype(np.uint32), want_d)
    assert torch.equal(got_a, want_a)


@pytest.mark.cuda
def test_estimating_hash_entry_is_one_launch_and_one_kernel(card, tmp_path):
    """A hash batch with its estimate is one launch of the estimating entry
    and one kernel, a `row_chain_kernel` (the name the benchmark's roofline
    reads), with no memset or fill before it."""
    words, counts, lengths = pack_with_lengths(17, 13, 64)
    dw = _t(words).to(card)
    dc, dl = torch.from_numpy(counts).to(card), torch.from_numpy(lengths).to(card)
    _fused(dw, dc, dl)  # builds the library and makes the stream's workspaces
    kernels.reset_launches()
    ops = _card_ops(lambda: _fused(dw, dc, dl), tmp_path)
    want = dict.fromkeys(HASH_ENTRIES + ESTIMATE_ENTRIES, 0)
    want.update(jth256_row_chain=1, jth256_block_digests_estimate=1)
    assert _hash_launches() == want
    assert len(ops) == 1 and ops[0][0] == "kernel", ops
    assert "row_chain_kernel" in ops[0][1]


@pytest.mark.cuda
def test_estimating_hash_entry_workspaces_are_zero_after_each_launch(card):
    """The arrival counters and the count workspace of a stream are zero
    again after every launch, so a second call agrees bit for bit; a larger
    batch gets larger workspaces, and another stream its own. Blocks of 16
    lanes: shorter ones take the one-CTA design, which has neither."""
    words, counts, lengths = pack_with_lengths(19, 32, 16)
    dw = _t(words).to(card)
    dc, dl = torch.from_numpy(counts).to(card), torch.from_numpy(lengths).to(card)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        first = _fused(dw[:1], dc[:1], dl[:1])
        whole = _fused(dw, dc, dl)
        again = _fused(dw, dc, dl)
        torch.cuda.synchronize()
        key = (dw.device.index, stream.cuda_stream)
        arrivals, _ = ht._ARRIVALS[("jth256_block_digests",) + key]
        work, size = ht._ARRIVALS[("jth256_block_digests_estimate",) + key]
    assert size >= 32 and work.numel() == size * 256
    assert not work.any() and not arrivals.any()
    for got, want in zip(again + first, whole + tuple(x[:1] for x in whole)):
        assert torch.equal(got, want)
    default = _fused(dw, dc, dl)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(default, whole))


@pytest.mark.cuda
def test_ring_puts_every_batch_of_up_to_32_blocks_in_one_wave(card):
    """At the ring depth the rule picks for a batch of 1-32 blocks of 64
    lanes, each row-chain entry holds ceil(lanes / SMs) CTAs an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), so every lane is
    resident at once, and either block entry launches at each of those
    sizes."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    entries = ("jth256_lane_digests", "jth256_block_digests", "jth256_block_digests_estimate")
    with torch.cuda.device(card):
        tables = {e: kernels.row_chain_occupancy(e) for e in entries}
    for b in range(1, 33):
        n = 64 * b
        for e in entries:
            depth, waves = ht._ring(e, card, n, 64)
            staged = 0 if e == "jth256_lane_digests" else 64 * kernels.LANE_DIGEST_BYTES
            assert depth == kernels.ring_depth(n, sms, tables[e], staged)
            assert tables[e][depth] >= -(-n // sms) and waves == 1, (b, e, depth)
    words, counts, lengths = pack_with_lengths(5, 32, 64)
    dw = _t(words).to(card)
    dc, dl = torch.from_numpy(counts).to(card), torch.from_numpy(lengths).to(card)
    for b in range(1, 33):
        ht.hash_device(dw[:b], dc[:b], dl[:b])
        _fused(dw[:b], dc[:b], dl[:b])
    torch.cuda.synchronize()


# cest::div_rn against __fdiv_rn: every b in [1, 2^18] (a histogram's
# total: 4096 lanes of 64 sampled words, far past any block) and every
# a <= b, then 2^26 random pairs 1 <= a <= b < 2^32
_DIV_CHECK = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "compress_estimate.cuh"

__global__ void every_pair(unsigned long long* bad, uint32_t b_lo, uint32_t b_hi) {
  const uint32_t b = b_lo + blockIdx.x;
  if (b > b_hi) return;
  unsigned long long n = 0;
  for (uint32_t a = 1 + threadIdx.x; a <= b; a += blockDim.x) {
    const float fa = static_cast<float>(a), fb = static_cast<float>(b);
    n += __float_as_uint(cest::div_rn(fa, fb)) != __float_as_uint(__fdiv_rn(fa, fb));
  }
  if (n) atomicAdd(bad, n);
}

__global__ void random_pairs(unsigned long long* bad) {
  unsigned long long x = (blockIdx.x * 256ull + threadIdx.x + 1) * 0x9E3779B97F4A7C15ull;
  unsigned long long n = 0;
  for (int i = 0; i < 1024; ++i) {
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    const uint32_t b = static_cast<uint32_t>(x >> 32) | 1u, a = static_cast<uint32_t>(x) % b + 1u;
    const float fa = static_cast<float>(a), fb = static_cast<float>(b);
    n += fa <= fb && __float_as_uint(cest::div_rn(fa, fb)) != __float_as_uint(__fdiv_rn(fa, fb));
  }
  if (n) atomicAdd(bad, n);
}

extern "C" int div_rn_mismatches(unsigned long long* bad, unsigned int top) {
  for (uint32_t lo = 1; lo <= top; lo += 65536) every_pair<<<65536, 256>>>(bad, lo, top);
  random_pairs<<<256, 256>>>(bad);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


@pytest.mark.cuda
def test_div_rn_is_fdiv_rn_on_every_histogram_ratio(card, tmp_path):
    """The estimate's count / total (cest::div_rn, __fdiv_rn's fast path
    without its slow-path call) gives __fdiv_rn's bits for every total up
    to 2^18 and every count up to it, and for random pairs up to 2^32: the
    advisories keep their bits."""
    import ctypes
    import subprocess

    src, so = tmp_path / "div_check.cu", tmp_path / "libdiv_check.so"
    src.write_text(_DIV_CHECK)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.KERNEL_DIR, "-o",
                    str(so), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).div_rn_mismatches
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_uint], ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int64, device=card)
    torch.cuda.synchronize()
    assert fn(bad.data_ptr(), 1 << 18) == 0
    assert int(bad.item()) == 0
