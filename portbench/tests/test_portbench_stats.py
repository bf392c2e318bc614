"""The arithmetic of the numbers: the p95 over all slices, the idle share
of a synthetic trace, and the roofline's byte count."""

import pytest

from portbench import devtrace, roofline
from portbench.stats import gaps, p95, union_length


def test_p95_takes_every_slice_and_sees_a_stall():
    lat = [0.010] * 100
    assert p95(lat) == 0.010
    stalled = lat[:]
    for i in range(6):  # a stall that held up 6 of 100 commits
        stalled[40 + i] = 0.5
    assert p95(stalled) == 0.5
    assert p95(list(range(1, 21))) == 19


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert union_length(iv, 0, 10) == 3 + 1 + 1
    assert gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert gaps([], 0, 1) == [(0, 1)]


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def test_summarise_idle_share_on_a_synthetic_trace():
    events = [
        _ev("user_annotation", devtrace.WINDOW, 1000, 1000),
        _ev("kernel", "void (anonymous namespace)::row_chain_kernel<true>(unsigned int const*)",
            1100, 100),
        _ev("gpu_memcpy", "Memcpy HtoD", 1150, 150),    # overlaps the kernel
        _ev("kernel", "other_kernel(int)", 1800, 400),  # runs past the window
        _ev("kernel", "early(int)", 900, 50),           # before the window
        _ev("cpu_op", "aten::copy_", 1400, 300),
        _ev("user_annotation", "portbench.gc.dedup_scan", 1000, 1000),
    ]
    s = devtrace.summarise(events, "NVIDIA H100 80GB HBM3", 0.001)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((200 + 200) * 1e-6)
    assert s["hash_kernel_s"] == pytest.approx(100e-6)
    assert s["device_events"] == 3
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["void (anonymous namespace)::row_chain_kernel<true>"] == pytest.approx(100e-6)
    gap = s["breakdown"]["idle_gaps"]
    assert gap[0] == ["aten::copy_", pytest.approx(500e-6)]  # 1300..1800, innermost op
    assert sum(g for _n, g in gap) == pytest.approx(600e-6)


def test_roofline_bytes_do_not_depend_on_lanes_or_padding():
    # one 4 MiB block and 64 blocks of 64 KiB: the same bytes, whatever the
    # lanes; a short block counts its own length, not its padded lanes
    assert roofline.hash_bytes(4 << 20, 1) == (4 << 20) + 32
    assert roofline.hash_bytes(64 * 65536, 64) == 64 * 65536 + 64 * 32
    assert roofline.hash_bytes(777, 1) == 777 + 32
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.peak_bytes_per_s(kind) == 3.35e12
    share = roofline.hash_roofline_pct(32 << 22, 32, 0.0508e-3, kind)
    assert share == pytest.approx(100 * ((32 << 22) + 32 * 32) / 3.35e12 / 0.0508e-3)
    assert roofline.hash_roofline_pct(1, 1, 0.0, kind) is None
    # another card has another peak: no share rather than a wrong one
    assert roofline.hash_roofline_pct(32 << 22, 32, 0.0508e-3, "NVIDIA H100 PCIe") is None
    assert roofline.is_hash_kernel("void (anonymous namespace)::row_chain_kernel<true>(x)")
    assert not roofline.is_hash_kernel("at::native::reduce_kernel")
    assert not roofline.is_hash_kernel("void (anonymous namespace)::combine_kernel(x)")


def test_card_seconds_of_an_untraced_window():
    """The card clock's busy time is the union of every kernel, copy and
    memset; its kernel time the union of the kernels alone; host events
    count for neither."""
    events = [_ev("gpu_memcpy", "Memcpy HtoD", 0, 4), _ev("kernel", "k1", 3, 2),
              _ev("kernel", "k2", 4, 2), _ev("gpu_memset", "Memset", 10, 1),
              _ev("cuda_runtime", "cudaLaunchKernel", 0, 50)]
    assert devtrace.card_seconds(events) == {"busy": 7e-6, "kernels": 3e-6}
    with pytest.raises(RuntimeError):
        devtrace.card_seconds([_ev("gpu_memcpy", "Memcpy HtoD", 0, 4)])
