"""The port's native C++ core (juicefs_tpu_torch/native) against the JAX
package's: the same digests and checksums on the sizes of test_native.py,
and the library built under build/native/, not beside its source."""

import os

import numpy as np
import pytest

from juicefs_tpu import native as ref
from juicefs_tpu.tpu.jth256 import LANE_BYTES, jth256
from juicefs_tpu_torch import native

CRC_SIZES = (0, 1, 7, 8, 9, 100, 4096, 1 << 20)
HASH_SIZES = (0, 1, 63, 4096, LANE_BYTES - 1, LANE_BYTES, LANE_BYTES + 1,
              3 * LANE_BYTES + 17)


def _data(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


def test_library_builds_under_build_native():
    assert native.available()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(native.REPO_ROOT, "build", "native")
    assert os.path.exists(path)
    src_dir = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


@pytest.mark.parametrize("n", CRC_SIZES)
def test_crc32c_matches_reference(n):
    data = _data(n, n)
    assert native.crc32c(data) == ref.crc32c(data) == native.crc32c_py(data)
    assert native.crc32c(data, 0x1234) == ref.crc32c(data, 0x1234)


@pytest.mark.parametrize("n", HASH_SIZES)
def test_jth256_matches_reference(n):
    data = _data(1000 + n, n)
    assert native.jth256(data) == ref.jth256(data) == jth256(data)


@pytest.mark.parametrize("threads", [1, 4])
def test_jth256_batch_matches_reference(threads):
    blocks = [_data(2, s) for s in (100, LANE_BYTES, 2 * LANE_BYTES + 5, 0, 7)]
    blocks.append(bytearray(_data(3, LANE_BYTES + 9)))  # writable buffers too
    want = ref.jth256_batch(blocks, threads=threads)
    assert native.jth256_batch(blocks, threads=threads) == want
    assert want == [jth256(bytes(b)) for b in blocks]


def test_fallbacks_match_library(monkeypatch):
    """With no library (no compiler), the pure-Python fallbacks give the
    same answers."""
    data = _data(4, 3 * LANE_BYTES + 17)
    want = (native.crc32c(data), native.jth256(data), native.jth256_batch([data, b"x"]))
    monkeypatch.setattr(native, "_load", lambda: None)
    assert (native.crc32c(data), native.jth256(data),
            native.jth256_batch([data, b"x"])) == want
