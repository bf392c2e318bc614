"""`correct` comes out false for the control and for each fault a cell
can have: the timed path broken underneath, the rest of a run as it is.

One card, so no cell has an exchange between chips to leave out."""

import contextlib

import numpy as np
import pytest
import torch

from tiny import CELLS, tiny_run
from juicefs_tpu_torch.gpu.sharding import ShardPlane
from portbench.control import controlled


@contextlib.contextmanager
def patched_hash(fn):
    orig = ShardPlane.hash_async

    def hash_async(self, words, lane_counts, lengths):
        return fn(orig(self, words, lane_counts, lengths))

    ShardPlane.hash_async = hash_async
    try:
        yield
    finally:
        ShardPlane.hash_async = orig


def altered(h):
    """A digest altered where it is produced: one bit of the first block's."""
    h = h.clone()
    h[0, 0] ^= 1
    return h


def half(h):
    """Half of the batch left out: digests for the first half only."""
    return h[: max(1, (h.shape[0] + 1) // 2)] if h.shape[0] > 1 else h[:0]


@contextlib.contextmanager
def unchanged(cell, monkeypatch):
    """A step that returns its state unchanged: a gc pass that backfills no
    index row, or a write whose PUT stores nothing."""
    if cell.startswith("gc-"):
        from juicefs_tpu_torch.meta.kv import KVMeta

        monkeypatch.setattr(KVMeta, "set_block_digests", lambda self, entries: None)
    else:
        from juicefs_tpu_torch.object.mem import MemStorage

        monkeypatch.setattr(MemStorage, "put", lambda self, key, data: None)
    yield


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, cpu_plane):
    with controlled():
        r = tiny_run(cell)
    assert not r["correct"]
    assert r["checks"]["digest_errors"]["value"] > 0


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, cpu_plane, monkeypatch):
    if fault == "unchanged":
        ctx = unchanged(cell, monkeypatch)
    else:
        ctx = patched_hash(altered if fault == "altered" else half)
    with ctx:
        r = tiny_run(cell)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("ingest-")])
def test_every_block_passed_through_is_not_correct(cell, cpu_plane, monkeypatch):
    """A program whose ingest stage refuses every block (none hashed,
    looked up or elided, each uploaded plain) is faster and must not pass."""
    from juicefs_tpu_torch.gpu.pipeline import HashBatcher

    monkeypatch.setattr(HashBatcher, "submit", lambda self, item: False)
    r = tiny_run(cell)
    assert not r["correct"]
    assert r["checks"]["passthrough_pct"]["value"] > 90


def test_first_lane_control_differs_from_the_hash():
    from portbench.control import first_lane_digests
    from portbench.reference import jth256 as ref

    rng = np.random.default_rng(3)
    blocks = [rng.bytes(4 << 20), rng.bytes(65536), rng.bytes(100)]
    words, counts, lengths = ref.pack_blocks(blocks, pad_lanes=64)
    got = ref.digests_to_bytes(first_lane_digests(torch.from_numpy(words.view(np.int32)),
                                                  torch.from_numpy(lengths.astype(np.int64))))
    assert got[0] != ref.jth256(blocks[0])
    assert got[0] == ref.jth256(blocks[0][:65536])
    assert got[1:] == [ref.jth256(b) for b in blocks[1:]]
