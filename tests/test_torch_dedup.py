"""gpu/dedup.py (torch) against tpu/dedup.py (JAX): identical verdicts.

Digest batches come from numpy with a seed; dup_mask and first_idx must be
identical (exact), and scan_step's digests bit-identical.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juicefs_tpu.tpu  # noqa: F401  (loads the reference spec module)
from juicefs_tpu.tpu.dedup import dedup_digests as ref_dedup_digests
from juicefs_tpu.tpu.dedup import dedup_scan_jax, scan_step_jax
from juicefs_tpu_torch.gpu.dedup import dedup_digests, dedup_scan, scan_step

ref_spec = sys.modules["juicefs_tpu.tpu.jth256"]
LANE = ref_spec.LANE_BYTES


def _digest_case(name):
    rng = np.random.default_rng(17 + CASES.index(name))
    if name == "empty":
        return np.zeros((0, 8), dtype=np.uint32)
    if name == "one":
        return rng.integers(0, 1 << 32, size=(1, 8), dtype=np.uint32)
    if name == "unique":
        return rng.integers(0, 1 << 32, size=(33, 8), dtype=np.uint32)
    if name == "all_same":
        return np.tile(rng.integers(0, 1 << 32, size=(1, 8), dtype=np.uint32), (9, 1))
    # random digests with planted duplicates, including rows that differ
    # only in their last word (a sort on fewer keys would merge them)
    uniq = rng.integers(0, 1 << 32, size=(12, 8), dtype=np.uint32)
    near = uniq[3].copy()
    near[7] ^= 1
    pick = rng.integers(0, len(uniq), size=60)
    d = np.concatenate([uniq[pick], near[None], uniq[3:4]])
    return d[rng.permutation(len(d))]


CASES = ["empty", "one", "unique", "all_same", "planted"]


@pytest.mark.parametrize("case", CASES)
def test_dedup_scan_matches_jax(case):
    d = _digest_case(case)
    dup, first = dedup_scan(torch.from_numpy(d.astype(np.int64)))
    rdup, rfirst = dedup_scan_jax(jnp.asarray(d))
    assert dup.dtype == torch.bool and first.dtype == torch.int32
    assert np.array_equal(dup.numpy(), np.asarray(rdup))
    assert np.array_equal(first.numpy(), np.asarray(rfirst))
    hdup, hfirst = dedup_digests(ref_spec.digests_to_bytes(d))
    assert np.array_equal(hdup, np.asarray(rdup)) and np.array_equal(hfirst, np.asarray(rfirst))


@pytest.mark.parametrize("case", CASES)
def test_dedup_digests_matches_reference(case):
    digests = ref_spec.digests_to_bytes(_digest_case(case))
    for a, b in zip(dedup_digests(digests), ref_dedup_digests(digests)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _batch(seed, layout):
    rng = np.random.default_rng(seed)
    uniq = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            for n in (0, 100, LANE + 7, 3 * LANE)]
    return [uniq[i] for i in layout]


@pytest.mark.parametrize("layout", [[1], [0, 1, 2, 3], [2, 2, 2], [1, 2, 1, 3, 2, 1, 0, 0]])
def test_scan_step_matches_jax(layout):
    blocks = _batch(len(layout), layout)
    words, counts, lengths = ref_spec.pack_blocks(blocks)
    d, dup, first = scan_step(words, counts, lengths, device="cpu")
    rd, rdup, rfirst = scan_step_jax(words, counts, lengths)
    assert d.dtype == np.uint32 and np.array_equal(d, np.asarray(rd))
    assert np.array_equal(dup, np.asarray(rdup))
    assert np.array_equal(first, np.asarray(rfirst))
