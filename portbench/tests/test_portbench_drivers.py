"""Both drivers, every cell, at a tiny size on the CPU: through the port's
plain torch path on a CPU sharding plane, and with the `cpu` backend."""

import pytest

from tiny import CELLS, one_writer, tiny_run

# the port's cpu backend: the host hash, the host compress plane
CPU_BACKEND = {
    "gc-cold.plain-4m": {"config": {"flags": ["--dedup", "--threads", "10",
                                              "--hash-backend", "cpu",
                                              "--compress-backend", "cpu"]}},
    "gc-incr.plain-4m": {"config": {"flags": ["--dedup", "--threads", "10",
                                              "--hash-backend", "cpu",
                                              "--compress-backend", "cpu"]}},
    "ingest-4w.dedup-4m-lz4": {"config": {"hash_backend": "cpu", "flags": [
        "--inline-dedup", "--no-dedup-bypass", "--compress-backend", "cpu"]}},
}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_cpu_plane(cell, cpu_plane):
    for trace in (False, True):
        r = tiny_run(cell, trace=trace)
        assert r["correct"], r["checks"]
        assert r["failed"] == 0 and r["attempted"] > 0
        names = set(r["metrics"])
        if trace:
            assert ("gc_meta_share" in names) == cell.startswith("gc-")
            assert ("ingest_blocks_per_batch" in names) == cell.startswith("ingest-")
            assert ("write_p95_ms.profiled" in names) == cell.startswith("ingest-")
            assert ("scan_gibs.profiled" in names) == cell.startswith("gc-")
            # no device trace on the CPU: its metrics are left out, never 0
            assert not any(n.startswith(("jth256_roofline", "device_idle")) for n in names)
        else:
            # no card, no device trace: the card's ms per GiB is left out,
            # and the host's rates go under unbounded, never 0
            assert names == {"setup_s"}
            assert all(m["value"] > 0 for m in r["metrics"].values())
            want = ({"scan_gibs"} if cell.startswith("gc-")
                    else {"write_gibs", "write_p95_ms"})
            assert set(r["unbounded"]) == want
            assert all(m["value"] > 0 for m in r["unbounded"].values())
        assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_with_the_cpu_backend(cell):
    r = tiny_run(cell, overrides=CPU_BACKEND[cell])
    assert r["correct"], r["checks"]


def test_ingest_one_block_batches(cpu_plane):
    """One writer of 1 MiB writes hands its blocks to the ingest stage one
    at a time, as it completes each; four writers of whole blocks fill
    batches."""
    cell = "ingest-4w.dedup-4m-lz4"
    one = tiny_run(cell, trace=True, overrides=one_writer())
    assert one["correct"], one["checks"]
    four = tiny_run(cell, trace=True)
    assert one["metrics"]["ingest_blocks_per_batch"]["value"] < 2
    assert (four["metrics"]["ingest_blocks_per_batch"]["value"]
            > one["metrics"]["ingest_blocks_per_batch"]["value"])


def test_passed_through_blocks_are_judged_as_such(cpu_plane, monkeypatch):
    """A full ingest queue passes blocks through, unhashed and not elided,
    by the port's overload contract: each check of the outputs judges
    them as such, and their share is held to its own limit, so a program
    that passes a third of its blocks through is not correct."""
    from juicefs_tpu_torch.gpu.pipeline import HashBatcher

    orig = HashBatcher.submit
    calls = {"n": 0}

    def submit(self, item):
        calls["n"] += 1
        return False if calls["n"] % 3 == 0 else orig(self, item)

    monkeypatch.setattr(HashBatcher, "submit", submit)
    r = tiny_run("ingest-4w.dedup-4m-lz4", overrides=one_writer())
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert calls["n"] >= 3
    assert 20 < checks.pop("passthrough_pct") < 40
    assert not r["correct"]
    assert set(checks.values()) == {0}, checks
