"""Traffic data made from the seed: the plan's planted count, unique
windows, and the writers' fixed duplicate share."""

import numpy as np

from portbench import data
from portbench.reference import jth256 as ref

BIG_SEED = 2**33 + 12345


def test_plan_planted_count_is_exact():
    bs = 1 << 16
    buf = np.random.default_rng(1).bytes(8 << 20)
    for seed in (0, 7, BIG_SEED):
        plan = data.volume_plan(seed, 100, bs, 777, 0.25, 4)
        contents = data.Contents(buf, bs, 4, 4100)
        blocks = [contents.block(cid, size) for cid, size in plan]
        n_dup = sum(cid < 0 for cid, _ in plan)
        assert n_dup == 25 and len(plan) == 101 and plan[-1][1] == 777
        used = len({cid for cid, _ in plan if cid < 0})
        assert data.planted_duplicates(blocks) == n_dup - used
        # the same count by content: pool blocks are the only repeats
        assert len({ref.jth256(b) for b in blocks}) == len(blocks) - (n_dup - used)


def test_windows_are_unique_and_seeded():
    a = data.random_buffer(BIG_SEED, 1 << 20, "cpu")
    assert a == data.random_buffer(BIG_SEED, 1 << 20, "cpu")
    assert a != data.random_buffer(BIG_SEED + 1, 1 << 20, "cpu")
    contents = data.Contents(a, 65536, 4, 4100)
    ids = list(range(-4, 0)) + list(range(100))
    windows = [contents.window(c) for c in ids]
    assert len(set(windows)) == len(windows)
    assert len({contents.offset(c) for c in ids}) == len(ids)
    assert contents.block(-1) is contents.block(-1)


def test_writer_streams_fixed_share_and_disjoint():
    streams = [data.WriterStream(BIG_SEED, w, 4, 4, 4) for w in range(4)]
    ids = [[s.next() for _ in range(400)] for s in streams]
    for seq in ids:
        for g in range(0, 400, 4):
            assert sum(c < 0 for c in seq[g:g + 4]) == 1
    uniques = [c for seq in ids for c in seq if c >= 0]
    assert len(uniques) == len(set(uniques)) == 1200
    again = data.WriterStream(BIG_SEED, 2, 4, 4, 4)
    assert [again.next() for _ in range(400)] == ids[2]
