"""The port's compress plane (juicefs_tpu_torch/gpu/compress_batch.py) against
the JAX package's (juicefs_tpu/tpu/compress_batch.py).

Inputs come from a seeded numpy generator. Encoded bytes must be identical
(liblz4 on both sides, fan-out and serial paths); the estimator's
predictions must be within 1e-5 of the reference's jitted
`_make_estimator` (XLA on the CPU) and its byte histograms exact.
"""

import logging

import numpy as np
import pytest
import torch

from juicefs_tpu.compress import LZ4Compressor as RefLZ4
from juicefs_tpu.qos import IOClass as RefIOClass
from juicefs_tpu.qos import Scheduler as RefScheduler
from juicefs_tpu.tpu import compress_batch as ref_cb
from juicefs_tpu.tpu.jth256 import pack_blocks
from juicefs_tpu_torch.compress import LZ4Compressor, NoneCompressor
from juicefs_tpu_torch.gpu import compress_batch as cb
from juicefs_tpu_torch.gpu.sharding import ShardPlane
from juicefs_tpu_torch.qos import IOClass, Scheduler

LANE = 1 << 16
RNG = np.random.default_rng(2024)
TEXT = b"hello world "


def _rand(n: int) -> bytes:
    return RNG.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def _text(n: int) -> bytes:
    return (TEXT * (n // len(TEXT) + 1))[:n]


RAGGED = [
    b"",
    b"\x42",
    TEXT * 37,
    _rand(4 << 20),
    RNG.integers(0, 4, size=1 << 20, dtype=np.uint8).tobytes(),
    b"\x00" * (4 << 20),
    bytearray(_rand(65537)),
]

# (pad_lanes M, blocks): ragged lane counts, zero / text / random blocks
ESTIMATE_CASES = {
    "m1": (1, [_rand(LANE), bytes(LANE), _text(LANE), _rand(100), b""]),
    "m4-ragged": (4, [_rand(4 * LANE), _rand(LANE + 7), bytes(3 * LANE),
                      _text(2 * LANE - 1), _rand(1)]),
    "m64": (64, [_rand(64 * LANE), bytes(64 * LANE), _text(64 * LANE),
                 _rand(5 * LANE + 3)]),
}


def _tensors(packed):
    """A packed triple as the tensors `HashPipeline.shard_packed` hands on."""
    words, counts, lengths = packed
    return (torch.from_numpy(words.view(np.int32)), torch.from_numpy(counts.astype(np.int64)),
            torch.from_numpy(lengths.astype(np.int64)))


@pytest.fixture
def scheds():
    ref, port = RefScheduler(), Scheduler()
    yield ref, port
    ref.close()
    port.close()


def _np_histogram(words: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Independent numpy histogram of the estimator's sample."""
    b, m = words.shape[:2]
    sub = np.ascontiguousarray(words[:, :, ::16, ::16]).reshape(b, m, 64)
    by = sub.view(np.uint8).reshape(b, m, 256)
    out = np.zeros((b, 256), dtype=np.float32)
    for i in range(b):
        live = by[i, : min(int(counts[i]), m)].reshape(-1)
        out[i] = np.bincount(live, minlength=256)
    return out


@pytest.mark.parametrize("case", sorted(ESTIMATE_CASES))
def test_estimate_matches_reference_estimator(case):
    m, blocks = ESTIMATE_CASES[case]
    words, counts, _lengths = pack_blocks(blocks, pad_lanes=m)
    want = np.asarray(ref_cb._make_estimator()(words, counts))
    tw = torch.from_numpy(words.view(np.int32))
    tc = torch.from_numpy(counts.astype(np.int64))
    hist = cb.byte_histogram(tw, tc)
    got = cb.estimate(tw, tc)
    assert got.dtype == torch.float32 and got.shape == (len(blocks),)
    np.testing.assert_array_equal(hist.numpy(), _np_histogram(words, counts))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert np.isfinite(got.numpy()).all()


def test_estimate_ranks_zero_text_random():
    m, blocks = ESTIMATE_CASES["m64"]
    words, counts, _ = pack_blocks(blocks, pad_lanes=m)
    pred = cb.estimate(torch.from_numpy(words.view(np.int32)),
                       torch.from_numpy(counts.astype(np.int64))).tolist()
    assert pred[0] > 0.95  # a random 4 MiB block: 16384 sampled bytes
    assert pred[3] > 0.85  # 6 random lanes sample only 1536 bytes
    assert pred[1] < 0.5 and pred[2] < 0.5    # zeros, repeated text


@pytest.mark.parametrize("lanes,min_blocks", [(3, 2), (3, 1 << 30)],
                         ids=["fanout", "serial"])
def test_compress_blocks_byte_identical_to_reference(scheds, lanes, min_blocks):
    ref_s, port_s = scheds
    ref = ref_cb.CompressPlane(RefLZ4(), ref_cb.CompressBatchConfig(
        backend="cpu", lanes=lanes, min_fanout_blocks=min_blocks), scheduler=ref_s)
    port = cb.CompressPlane(LZ4Compressor(), cb.CompressBatchConfig(
        backend="cpu", lanes=lanes, min_fanout_blocks=min_blocks), scheduler=port_s)
    try:
        want = ref.compress_blocks(RAGGED)
        got = port.compress_blocks(RAGGED)
        assert got == want
        for blk, enc in zip(RAGGED, got):
            assert port.compressor.decompress(enc, len(blk)) == bytes(blk)
        st, rst = port.stats(), ref.stats()
        for k in ("algorithm", "lanes", "blocks", "batches", "bytes_in",
                  "bytes_out", "ratio", "degraded", "estimated"):
            assert st[k] == rst[k], k
    finally:
        ref.close()
        port.close()


def test_cuda_plane_estimates_like_reference_xla_plane(scheds):
    """The cuda backend (plain torch path on the CPU) encodes the same bytes
    as the reference's xla backend and records the advisories that an
    advised hash of the shared pack computes (`ShardPlane.hash_async`),
    which equal the reference's `_make_estimator`."""
    ref_s, port_s = scheds
    ref = ref_cb.CompressPlane(RefLZ4(), ref_cb.CompressBatchConfig(backend="xla"),
                               scheduler=ref_s)
    port = cb.CompressPlane(LZ4Compressor(), cb.CompressBatchConfig(backend="xla"),
                            scheduler=port_s, device="cpu")
    try:
        assert port.backend == "cuda" and port.device == torch.device("cpu")
        assert port.estimating
        blocks = [_rand(1 << 20), bytes(1 << 20), _text(1 << 20)]
        packed = pack_blocks(blocks, pad_lanes=16)
        plane = ShardPlane([torch.device("cpu")])
        with plane.advised() as advice:
            plane.hash_async(*_tensors(packed))
        (adv,) = advice
        want = np.asarray(ref_cb._make_estimator()(packed[0], packed[1]))
        np.testing.assert_allclose(adv.numpy(), want, rtol=0, atol=1e-5)
        port.estimate_packed(adv)
        assert port.compress_blocks(blocks) == ref.compress_blocks(blocks, packed=packed)
        assert port.estimated == ref.estimated == 3
        np.testing.assert_allclose(port.last_estimate, ref.last_estimate, atol=1e-4)
        assert port.stats()["degraded"] == 0
    finally:
        ref.close()
        port.close()


def test_cuda_plane_without_card_raises(scheds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cb.CompressPlane(LZ4Compressor(), cb.CompressBatchConfig(backend="cuda"),
                         scheduler=scheds[1])
    assert cb.CompressBatchConfig().backend == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cb.CompressPlane(LZ4Compressor(), scheduler=scheds[1])  # the default


def test_unknown_backend_rejected(scheds):
    with pytest.raises(ValueError, match="unknown"):
        cb.CompressPlane(LZ4Compressor(), cb.CompressBatchConfig(backend="rocm"),
                         scheduler=scheds[1])


def test_estimator_failure_is_logged_and_counted(scheds, caplog):
    """A failed estimate is logged at WARNING and counted once, the plane
    stops estimating, and encoding goes on as before."""
    plane = cb.CompressPlane(LZ4Compressor(), cb.CompressBatchConfig(backend="cuda"),
                             scheduler=scheds[1], device="cpu")
    assert plane.estimating
    blocks = [_rand(LANE), _rand(LANE)]
    with caplog.at_level(logging.WARNING):
        plane.estimate_failed(RuntimeError("device lost"))
    assert plane.compress_blocks(blocks) == [plane.compressor.compress(b) for b in blocks]
    assert plane.degraded == 1 and plane.estimated == 0 and not plane.estimating
    assert "compress estimate degraded: device lost" in caplog.text
    assert plane.stats()["degraded"] == 1
    plane.close()


def test_estimate_packed_records_the_advisories(scheds):
    """`estimate_packed` records a batch's host advisories: one estimated
    block each, the last batch's rounded to 4 places, across batches."""
    plane = cb.CompressPlane(LZ4Compressor(), scheduler=scheds[1], device="cpu")
    blocks = [_rand(LANE), bytes(LANE), _text(LANE)]
    words, counts, _ = _tensors(pack_blocks(blocks, pad_lanes=1))
    adv = cb.estimate(words, counts)
    plane.estimate_packed(adv[:2])
    assert plane.estimated == 2
    plane.estimate_packed(adv)
    assert plane.estimated == 5 and plane.degraded == 0
    assert plane.last_estimate == [round(float(p), 4) for p in adv]
    assert plane.last_estimate[0] > plane.last_estimate[2] > plane.last_estimate[1] == 0.0
    assert plane.stats()["estimated"] == 5 and "estimated_in_hash" not in plane.stats()
    plane.close()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_queue_full_degrades_to_serial_encode(pkg):
    """A saturated slice lane degrades the batch to the serial encode in
    both packages, byte-identical and counted."""
    mod, sched_cls, cls, comp = (
        (ref_cb, RefScheduler, RefIOClass, RefLZ4) if pkg == "ref"
        else (cb, Scheduler, IOClass, LZ4Compressor))
    sched = sched_cls(bounds={cls.INGEST: 0}, bound_wait=0.0)
    try:
        plane = mod.CompressPlane(comp(), mod.CompressBatchConfig(backend="cpu", lanes=2),
                                  scheduler=sched)
        blocks = RAGGED[3:5] * 3
        assert plane.compress_blocks(blocks) == [RefLZ4().compress(b) for b in blocks]
        assert plane.degraded == len(blocks)
    finally:
        sched.close()


def test_none_compressor_passthrough(scheds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plane = cb.CompressPlane(NoneCompressor(), scheduler=scheds[1])  # no device work
    assert plane.backend == "cuda" and plane.device is None
    assert not plane.active and plane.stats()["algorithm"] == "none"
    assert plane.compress_blocks([b"abc", b""]) == [b"abc", b""]
    assert plane.compress_one(b"xyz") == b"xyz"
