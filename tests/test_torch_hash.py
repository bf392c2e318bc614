"""hash_torch (the port's batched JTH-256) against hash_jax, bit for bit.

The JAX side runs as the JAX package's own tests run it on the CPU: the
Pallas row chain in interpret mode and the XLA path. Inputs come from
numpy with a seed. Tolerance: exact (uint32 words must be identical).
"""

import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juicefs_tpu.tpu  # noqa: F401  (loads the reference spec module)
from juicefs_tpu.tpu import hash_jax as hj
from juicefs_tpu_torch.gpu import hash_torch as ht
from juicefs_tpu_torch.gpu import kernels
from juicefs_tpu_torch.gpu.pipeline import HashPipeline, PipelineConfig

ref_spec = sys.modules["juicefs_tpu.tpu.jth256"]
LANE = ref_spec.LANE_BYTES

# (lanes, m, tweak): lane counts that are not multiples of the TPU
# kernel's 16-lane group, m in {1, 3, 64}, zero and nonzero tweaks
CHAIN_CASES = [(5, 1, 0), (7, 3, 0x9E3779B9), (21, 3, 0), (70, 64, 0xDEADBEEF)]


def _words(seed, n_lanes):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(n_lanes, 128, 128), dtype=np.uint32)


def _pallas_chain(words, m, tweak):
    return np.asarray(hj._pallas_row_chain(
        jnp.asarray(words), m, jnp.asarray([tweak], dtype=jnp.uint32),
        interpret=True))


def _blocks(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in sizes]


@pytest.mark.parametrize("n_lanes,m,tweak", CHAIN_CASES)
def test_row_chain_ref_matches_pallas_interpret(n_lanes, m, tweak):
    words = _words(n_lanes * 31 + m, n_lanes)
    got = ht.row_chain_ref(torch.from_numpy(words.view(np.int32)), m, tweak)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_lanes, 128)
    assert np.array_equal(got.numpy().view(np.uint32), _pallas_chain(words, m, tweak))


def test_row_chain_on_cpu_runs_plain_version():
    words = torch.from_numpy(_words(1, 9).view(np.int32))
    ht._LAST_KERNEL_MODE = None
    before = kernels.LAUNCHES["jth256_row_chain"]
    got = ht.row_chain(words, 3, 7)
    assert ht.last_kernel_mode() == "torch-cpu"
    assert kernels.LAUNCHES["jth256_row_chain"] == before  # no kernel launch
    assert torch.equal(got, ht.row_chain_ref(words, 3, 7))


def test_row_chain_validates_input():
    ok = torch.zeros((2, 128, 128), dtype=torch.int32)
    with pytest.raises(TypeError):
        ht.row_chain(ok.to(torch.int64), 1)
    with pytest.raises(ValueError):
        ht.row_chain(torch.zeros((2, 128, 64), dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        ht.row_chain(ok.transpose(1, 2), 1)
    with pytest.raises(ValueError):
        ht.row_chain(ok, 0)
    with pytest.raises(ValueError):  # neither cuda nor cpu: never guessed
        ht.row_chain(torch.empty((2, 128, 128), dtype=torch.int32, device="meta"), 1)


@pytest.mark.parametrize("pad_lanes,tweak", [(None, 0), (8, 0), (None, 0x1234567)])
def test_hash_packed_matches_xla_and_pallas(pad_lanes, tweak):
    blocks = _blocks(3, [0, 1, 100, LANE - 1, LANE, LANE + 7, 3 * LANE, 5 * LANE + 1])
    words, counts, lengths = ref_spec.pack_blocks(blocks, pad_lanes=pad_lanes)
    got = ht.hash_packed(words, counts, lengths, device="cpu", tweak=tweak)
    pallas = np.asarray(hj.hash_packed_pallas(
        words, counts, lengths, interpret=True,
        tweak=jnp.asarray([tweak], dtype=jnp.uint32)))
    assert got.dtype == np.uint32 and np.array_equal(got, pallas)
    if tweak == 0:
        assert np.array_equal(got, np.asarray(hj.hash_packed_jax(words, counts, lengths)))
        assert ref_spec.digests_to_bytes(got) == [ref_spec.jth256(b) for b in blocks]


def test_hash_packed_accepts_tensors():
    blocks = _blocks(4, [10, LANE + 5])
    words, counts, lengths = ref_spec.pack_blocks(blocks)
    want = ht.hash_packed(words, counts, lengths, device="cpu")
    got = ht.hash_packed(torch.from_numpy(words.view(np.int32)),
                         torch.from_numpy(counts), torch.from_numpy(lengths.astype(np.int64)),
                         device="cpu")
    assert np.array_equal(got, want)


def test_fold_ops_match_reference():
    rng = np.random.default_rng(5)
    s = rng.integers(0, 1 << 32, size=(3, 4, 128), dtype=np.uint32)
    counts = np.array([1, 4, 2], dtype=np.int32)
    lengths = np.array([7, 4 * LANE, LANE + 1], dtype=np.uint32)
    acc = ht.lane_accs(torch.from_numpy(s.view(np.int32)))
    want_acc = np.asarray(hj._lane_accs(jnp.asarray(s)))
    assert np.array_equal(acc.numpy().astype(np.uint32), want_acc)
    h = ht.combine_accs(acc, torch.from_numpy(counts),
                        torch.from_numpy(lengths.astype(np.int64)))
    want_h = np.asarray(hj._combine_accs(jnp.asarray(want_acc), jnp.asarray(counts),
                                         jnp.asarray(lengths)))
    assert np.array_equal(h.numpy().astype(np.uint32), want_h)
    x = rng.integers(0, 1 << 32, size=(64,), dtype=np.uint32)
    assert np.array_equal(ht.fmix(torch.from_numpy(x.astype(np.int64))).numpy().astype(np.uint32),
                          np.asarray(hj._fmix(jnp.asarray(x))))


def test_verify_backend_and_mode_on_cpu():
    ht._LAST_KERNEL_MODE = None
    assert ht.verify_backend(device="cpu")
    assert ht.last_kernel_mode() == "torch-cpu"
    blocks = _blocks(6, [1, LANE + 3])
    assert ht.hash_blocks(blocks, device="cpu") == [ref_spec.jth256(b) for b in blocks]
    assert ht.hash_blocks([], device="cpu") == []
    fn = ht.make_hash_fn("cuda", device="cpu")
    words, counts, lengths = ref_spec.pack_blocks(blocks)
    assert np.array_equal(fn(words, counts, lengths), ht.hash_packed(words, counts, lengths, device="cpu"))
    with pytest.raises(ValueError):
        ht.make_hash_fn("pallas")


def test_no_gpu_means_raise_never_cpu(monkeypatch):
    """device=None is the card: without one every entry point raises and
    nothing runs on the CPU (the reference's silent degrade is not kept)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ht._LAST_KERNEL_MODE = None
    words, counts, lengths = ref_spec.pack_blocks(_blocks(7, [100]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ht.hash_packed(words, counts, lengths)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ht.verify_backend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HashPipeline(PipelineConfig(backend="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HashPipeline()  # cuda is the default backend
    assert ht.last_kernel_mode() is None


def test_cpu_twin_of_kernel_arithmetic():
    """The per-lane arithmetic the CUDA kernel runs (jth256_step.cuh),
    built with g++ into a CPU extension, equals the Pallas kernel."""
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no C++ compiler: the CPU twin of the CUDA kernel cannot be built")
    twin = kernels.load_twin()
    for n_lanes, m, tweak in CHAIN_CASES:
        words = _words(n_lanes * 17 + m, n_lanes)
        got = twin.row_chain(torch.from_numpy(words.view(np.int32)), m, tweak)
        assert np.array_equal(got.numpy().view(np.uint32), _pallas_chain(words, m, tweak))
