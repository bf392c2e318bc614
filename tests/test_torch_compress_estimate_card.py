"""The compress estimator's kernel (juicefs_tpu_torch/gpu/kernels/
compress_estimate.cu) on the card against the plain torch version on the
CPU: histograms exact, advisories within 1e-5 (float32 log2 and the order
of the sum differ). Every test needs a CUDA card and skips without one;
the kernel's arithmetic is held on the CPU through its g++ twin
(test_torch_compress_estimate.py). This file imports no JAX.
"""

import json
import os

import numpy as np
import pytest
import torch

from juicefs_tpu_torch.gpu import compress_batch as cb
from juicefs_tpu_torch.gpu import hash_torch as ht
from juicefs_tpu_torch.gpu import kernels, sharding
from juicefs_tpu_torch.gpu.jth256 import pack_blocks
from torch_estimate_packs import SHAPES, blocks, np_histogram, pack
from torch_estimate_packs import as_int32 as _t

ESTIMATE_ENTRIES = ("compress_estimate", "compress_histogram", "compress_entropy")


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
    such a profiler can drop the first operation it would see."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100_000)
        fn()
        torch.cuda.synchronize()
    path = os.path.join(tmp_path, "card.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ops = sorted((float(e["ts"]), e.get("cat"), e.get("name")) for e in events
                 if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    spins = [i for i, (_ts, _cat, name) in enumerate(ops) if "spin_kernel" in name]
    return [(cat, name) for _ts, cat, name in ops[spins[-1] + 1 if spins else 0:]]


@pytest.mark.cuda
@pytest.mark.parametrize("b,m", SHAPES + [(13, 64)])
def test_kernel_matches_plain_on_seeded_packs(card, b, m):
    """Each entry on the card against the plain torch version on the CPU:
    the histogram entry exact (whole blocks and lane shards with their
    offsets), the fused entry within 1e-5, the entropy entry bit for bit
    the fused one."""
    words, counts = pack(101 + b + m, b, m)
    cw, cc = _t(words), torch.from_numpy(counts)
    dw, dc = cw.to(card), cc.to(card)
    kernels.reset_launches()
    hist = cb.byte_histogram(dw, dc)
    pred = cb.estimate(dw, dc)
    ent = cb.entropy_ratio(hist)
    torch.cuda.synchronize()
    assert _launches() == {"compress_estimate": 1, "compress_histogram": 1,
                           "compress_entropy": 1}
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
def test_one_launch_and_one_card_kernel_per_estimate(card, tmp_path):
    """An estimate on the card is one launch of the fused entry and one
    kernel, with no memset or fill before it (the workspace is zeroed once,
    when it is made)."""
    words, counts = pack(7, 13, 64)
    dw, dc = _t(words).to(card), torch.from_numpy(counts).to(card)
    cb.estimate(dw, dc)  # builds the library and makes the stream's workspace
    kernels.reset_launches()
    ops = _card_ops(lambda: cb.estimate(dw, dc), tmp_path)
    assert _launches() == {"compress_estimate": 1, "compress_histogram": 0,
                           "compress_entropy": 0}
    assert len(ops) == 1 and ops[0][0] == "kernel", ops
    assert "compress_estimate_kernel" in ops[0][1]


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
        work, size = ht._ARRIVALS[("compress_estimate", dw.device.index, stream.cuda_stream)]
    assert size >= 32 and work.numel() == size * cb._WORK_WORDS and not work.any()
    assert torch.equal(again, whole) and torch.equal(first, whole[:1])
    assert torch.equal(cb.entropy_ratio(hist), whole)
    default = cb.estimate(dw, dc)
    torch.cuda.synchronize()
    assert torch.equal(default, whole)


@pytest.mark.cuda
def test_shard_plane_advisories_equal_one_card(card):
    """On ShardPlane([cuda:0] * k) the estimate (a histogram per shard with
    its lane offset, their sum, the entropy entry per data row) equals the
    one-card plane's bit for bit."""
    rng = np.random.default_rng(29)
    batch = blocks(rng, 13, 64)
    packed = pack_blocks(batch, pad_lanes=64)
    one = sharding.ShardPlane([card])
    sp = one.put_packed(*packed)
    want = one.make_estimator()(sp[0], sp[1])[: len(batch)]
    for k, (rows, lanes) in ((2, (2, 1)), (4, (2, 2)), (8, (4, 2))):
        plane = sharding.ShardPlane([card] * k)
        sp = plane.put_packed(*packed)
        kernels.reset_launches()
        got = plane.make_estimator()(sp[0], sp[1])[: len(batch)]
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want.cpu()), k
        assert _launches() == {"compress_estimate": 0, "compress_histogram": rows * lanes,
                               "compress_entropy": rows}
