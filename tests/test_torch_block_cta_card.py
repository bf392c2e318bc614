"""The row chain's one-CTA block entries (jth256_row_chain.cu,
`jth256_block_cta_digests` and `jth256_block_cta_digests_estimate`: a block
of up to 8 lanes in one CTA, which the wrappers send blocks of at most
`kernels.CTA_BLOCK_LANES` lanes) on the card: the digests bit for bit the
numpy spec's (`hash_packed_np`) and the cross-CTA block entry's, the
advisories bit for bit the cross-CTA estimating entry's and the histogram
and entropy entries'; which batches take them (`kernels.block_entry`) and
how they are counted; the ring each launch takes. Every test needs a CUDA
card and skips without one; the design's arithmetic is held on the CPU
through the g++ twin (test_torch_hash_fold.py). This file imports no JAX.
"""
import json
import os

import numpy as np
import pytest
import torch

from juicefs_tpu_torch.gpu import compress_batch as cb
from juicefs_tpu_torch.gpu import hash_torch as ht
from juicefs_tpu_torch.gpu import kernels
from juicefs_tpu_torch.gpu.jth256 import hash_packed_np
from torch_estimate_packs import as_int32 as _t
from torch_estimate_packs import pack_with_lengths, short_block_pack


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the one-CTA entries are CUDA C++ with no CPU mode "
                    "(their arithmetic is held through the g++ twin)")
    return torch.device("cuda")


def _on(card, words, counts, lengths):
    return (_t(words).to(card), torch.from_numpy(counts).to(card),
            torch.from_numpy(lengths).to(card))


def _cta(entry, dw, dc, dl, tweak):
    """The one-CTA design of the block entry `entry` called directly, at
    any lane count it holds: digests, and for the estimating entry the
    advisories."""
    b, m = dw.shape[0], dw.shape[1]
    dev = dw.device
    cta = kernels.CTA_ENTRIES[entry]
    out = torch.empty((b, 8), dtype=torch.int64, device=dev)
    args, got = [dw.data_ptr(), dc.data_ptr(), dl.data_ptr(), out.data_ptr()], out
    if entry == "jth256_block_digests_estimate":
        adv = torch.empty((b,), dtype=torch.float32, device=dev)
        args.append(adv.data_ptr())
        got = (out, adv)
    depth, _waves = ht._ring(cta, dev, b * m, m)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = kernels.function(cta)(*args, b, m, tweak, depth, stream)
    assert rc == 0, rc
    return got


def _cross(entry, dw, dc, dl, tweak):
    """The cross-CTA block entry `entry` called directly (the wrapper sends
    short blocks to the one-CTA design): digests, and for the estimating
    entry the advisories."""
    b, m = dw.shape[0], dw.shape[1]
    dev = dw.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    lane_out = torch.empty((b * m, 8), dtype=torch.int32, device=dev)
    out = torch.empty((b, 8), dtype=torch.int64, device=dev)
    args = [dw.data_ptr(), lane_out.data_ptr(), dc.data_ptr(), dl.data_ptr(),
            ht._arrivals(dev, stream, b).data_ptr(), out.data_ptr()]
    got = out
    if entry == "jth256_block_digests_estimate":
        adv = torch.empty((b,), dtype=torch.float32, device=dev)
        args += [ht.zeroed_workspace(entry, dev, stream, b, 256).data_ptr(), adv.data_ptr()]
        got = (out, adv)
    depth, _waves = ht._ring(entry, dev, b * m, m)
    rc = kernels.function(entry)(*args, b, m, tweak, depth, stream)
    assert rc == 0, rc
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 13, 100])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
def test_one_cta_entries_match_the_spec_and_the_cross_cta_entries(card, m, b):
    """Blocks of 1-8 lanes, lane counts of m, 0, below m and past m, odd
    lengths (one past 2^32), with and without a tweak: the one-CTA entries,
    called directly, give digests bit for bit `hash_packed_np`'s of the
    tweaked words and the cross-CTA entries', advisories bit for bit the
    cross-CTA estimating entry's and the histogram and entropy entries';
    the wrappers give the same in one launch each, counted under
    jth256_block_cta beside the entries' own keys up to the cut."""
    words, counts, lengths = short_block_pack(700 + 11 * m + b, b, m)
    dw, dc, dl = _on(card, words, counts, lengths)
    want_a = cb.estimate(dw, dc)
    for tweak in (0, 0x5BD1E995):
        want_d = hash_packed_np(words ^ np.uint32(tweak), counts, lengths)
        kernels.reset_launches()
        got_d = ht.hash_device(dw, dc, dl, tweak)
        est_d, est_a = ht.hash_estimate_device(dw, dc, dl, tweak)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == {"jth256_row_chain": 2, "jth256_block_digests": 1,
                                    "jth256_block_digests_estimate": 1,
                                    "jth256_lane_digests": 0, "jth256_combine": 0,
                                    "compress_histogram": 0, "compress_entropy": 0,
                                    "jth256_block_cta": 2 if m <= kernels.CTA_BLOCK_LANES
                                    else 0,
                                    "jth256_block_cta_estimate":
                                        1 if m <= kernels.CTA_BLOCK_LANES else 0}
        cta_d = _cta("jth256_block_digests", dw, dc, dl, tweak)
        cta_e, cta_a = _cta("jth256_block_digests_estimate", dw, dc, dl, tweak)
        cross_d = _cross("jth256_block_digests", dw, dc, dl, tweak)
        cross_e, cross_a = _cross("jth256_block_digests_estimate", dw, dc, dl, tweak)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(cta_d.cpu().numpy().astype(np.uint32), want_d)
        for d in (cta_e, cross_d, cross_e, got_d, est_d):
            assert torch.equal(d, cta_d)
        for a in (cross_a, want_a, est_a):
            assert torch.equal(a, cta_a)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 4, 5, 8, 16, 64])
def test_engagement_counter_rises_only_up_to_the_cut(card, m):
    """A batch of m-lane blocks counts under jth256_block_cta (and the
    gauge juicefs_torch_kernel_launches{kernel="jth256_block_cta"}) only
    for m <= CTA_BLOCK_LANES; jth256_row_chain and the entry's own key
    count every launch either way, and the digests are the spec's."""
    from juicefs_tpu_torch.metric import global_registry

    words, counts, lengths = short_block_pack(800 + m, 3, m)
    dw, dc, dl = _on(card, words, counts, lengths)
    kernels.reset_launches()
    got = ht.hash_device(dw, dc, dl)
    _d, _a = ht.hash_estimate_device(dw, dc, dl)
    torch.cuda.synchronize()
    cta = 2 if m <= kernels.CTA_BLOCK_LANES else 0
    assert kernels.LAUNCHES["jth256_block_cta"] == cta
    assert kernels.LAUNCHES["jth256_row_chain"] == 2
    assert kernels.LAUNCHES["jth256_block_digests"] == 1
    assert kernels.LAUNCHES["jth256_block_digests_estimate"] == 1
    gauge = global_registry()._metrics["juicefs_torch_kernel_launches"].render()
    assert f'juicefs_torch_kernel_launches{{kernel="jth256_block_cta"}} {cta}' in gauge
    np.testing.assert_array_equal(got.cpu().numpy().astype(np.uint32),
                                  hash_packed_np(words, counts, lengths))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 4, 5, 8])
def test_estimate_counter_counts_each_estimating_one_cta_launch(card, m):
    """jth256_block_cta_estimate (and its gauge) rises once for each
    estimating launch that takes the one-CTA design (the estimate on a
    warp of its own), never for the plain one-CTA entry's launches, and
    never past the cut, where both block entries keep the cross-CTA
    design."""
    from juicefs_tpu_torch.metric import global_registry

    words, counts, lengths = short_block_pack(850 + m, 4, m)
    dw, dc, dl = _on(card, words, counts, lengths)
    taken = m <= kernels.CTA_BLOCK_LANES
    kernels.reset_launches()
    for _ in range(3):
        ht.hash_device(dw, dc, dl)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["jth256_block_cta_estimate"] == 0
    assert kernels.LAUNCHES["jth256_block_cta"] == (3 if taken else 0)
    for i in range(1, 3):
        ht.hash_estimate_device(dw, dc, dl)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["jth256_block_cta_estimate"] == (i if taken else 0)
    assert kernels.LAUNCHES["jth256_block_digests_estimate"] == 2
    gauge = global_registry()._metrics["juicefs_torch_kernel_launches"].render()
    want = 2 if taken else 0
    assert f'juicefs_torch_kernel_launches{{kernel="jth256_block_cta_estimate"}} {want}' in gauge


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3, 4, 7, 8])
def test_one_cta_estimate_on_zero_text_and_random_blocks(card, m):
    """The one-CTA estimating entry, called directly, on a zero, a text, a
    random, a 3-lane + 777 B and a short block with random dead lanes (the
    estimate warp's binning adds a warp's run of equal bytes at once; 8
    lanes bin on the lanes' threads): digests and advisories bit for bit
    the cross-CTA estimating entry's, advisories the histogram and entropy
    entries'."""
    words, counts, lengths = pack_with_lengths(870 + m, 10, m)
    dw, dc, dl = _on(card, words, counts, lengths)
    want_a = cb.estimate(dw, dc)
    for tweak in (0, 0x5BD1E995):
        cta_d, cta_a = _cta("jth256_block_digests_estimate", dw, dc, dl, tweak)
        cross_d, cross_a = _cross("jth256_block_digests_estimate", dw, dc, dl, tweak)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(cta_d.cpu().numpy().astype(np.uint32),
                                      hash_packed_np(words ^ np.uint32(tweak), counts, lengths))
        assert torch.equal(cta_d, cross_d)
        assert torch.equal(cta_a, cross_a) and torch.equal(cta_a, want_a)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 13, 100])
def test_eight_lane_blocks_estimate_on_the_lanes_threads(card, b):
    """At 8 lanes a CTA has no room for the estimate warp (8 x 128 + 32 >
    1024 threads): the lanes' threads gather and bin the sample before
    their first chunk and warps 1-3 run the entropy after the chains. With
    dead lanes (counts 8, 0, 7, 13 and 1) the entry's digests and
    advisories are bit for bit the cross-CTA estimating entry's, and its
    advisories the histogram and entropy entries'."""
    words, counts, lengths = short_block_pack(880 + b, b, 8)
    dw, dc, dl = _on(card, words, counts, lengths)
    want_a = cb.estimate(dw, dc)
    for tweak in (0, 0x5BD1E995):
        cta_d, cta_a = _cta("jth256_block_digests_estimate", dw, dc, dl, tweak)
        cross_d, cross_a = _cross("jth256_block_digests_estimate", dw, dc, dl, tweak)
        torch.cuda.synchronize()
        assert torch.equal(cta_d, cross_d)
        assert torch.equal(cta_a, cross_a) and torch.equal(cta_a, want_a)


@pytest.mark.cuda
def test_one_cta_launch_is_one_row_chain_kernel_with_no_workspace(card, tmp_path):
    """A small-file hash batch (one block of 2 lanes) with its estimate is
    one kernel whose name holds `row_chain_kernel` (the name the
    benchmark's roofline reads), with no memset or fill before it, and
    makes no arrival counters or count workspace on its stream."""
    words, counts, lengths = short_block_pack(31, 1, 2)
    dw, dc, dl = _on(card, words, counts, lengths)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ht.hash_estimate_device(dw, dc, dl)  # builds the library
        ops = []
        for attempt in range(3):  # a capture that saw nothing is taken again
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(100_000)
                ht.hash_estimate_device(dw, dc, dl)
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
    spins = [i for i, op in enumerate(ops) if "spin_kernel" in op[2]]
    ops = ops[spins[-1] + 1 if spins else 0:]
    assert [cat for _ts, cat, _name in ops] == ["kernel"], ops
    assert "row_chain_kernel" in ops[0][2]
    key = (dw.device.index, stream.cuda_stream)
    assert ("jth256_block_digests",) + key not in ht._ARRIVALS
    assert ("jth256_block_digests_estimate",) + key not in ht._ARRIVALS


@pytest.mark.cuda
def test_one_cta_ring_puts_every_batch_of_up_to_32_short_blocks_in_one_wave(card):
    """At the ring the rule picks from the one-CTA entries' own occupancy
    tables (cudaOccupancyMaxActiveBlocksPerMultiprocessor over m x 128
    threads), every batch of 1-32 blocks of 1-8 lanes (all the kernel
    holds; the wrappers send it up to 4) is one wave at a ring
    the CTA holds; a block of up to 3 lanes keeps its lanes whole (8
    chunks); and both entries launch at each size."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for entry in kernels.CTA_ENTRIES.values():
        for m in range(1, 9):
            with torch.cuda.device(card):
                table = kernels.row_chain_occupancy(entry, m)
            assert set(table) == set(kernels.CTA_RING_DEPTHS) and table[1] >= 1
            for b in range(1, 33):
                depth, waves = ht._ring(entry, card, b * m, m)
                assert depth == kernels.ring_depth(b * m, sms, table, lanes_per_cta=m,
                                                   chunk_bytes=kernels.CTA_CHUNK_BYTES)
                assert table[depth] >= -(-b // sms) and waves == 1, (entry, m, b, depth)
                if b == 1 and m <= 3:
                    assert depth == max(kernels.CTA_RING_DEPTHS)
    words, counts, lengths = short_block_pack(5, 32, 2)
    dw, dc, dl = _on(card, words, counts, lengths)
    for b in range(1, 33):
        ht.hash_device(dw[:b], dc[:b], dl[:b])
        ht.hash_estimate_device(dw[:b], dc[:b], dl[:b])
    torch.cuda.synchronize()
