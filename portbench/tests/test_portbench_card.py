"""On a card: one short run of each kind of cell through the command, and
the control, which has to come out not correct. Run with
`python -m pytest portbench/tests -q -m cuda` on a host with a CUDA card."""

import json
import os
import subprocess
import sys

import pytest

from portbench.run import ROOT


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")


def command(module, *args):
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=900,
                         env={**os.environ, "PYTHONPATH": ROOT})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cell,trace", [("gc-cold.plain-4m", "1"),
                                        ("ingest-4w.dedup-4m-lz4", "0")])
def test_cell_on_the_card(cell, trace):
    need_card()
    out = command("portbench.run", "--workload", cell, "--seed", str(2**33 + 1),
                  "--seconds", "3", "--trace", trace)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace == "1":
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert 0 < r["metrics"]["jth256_roofline.scan"]["value"] <= 105
    else:
        # the card's kernel time over the untraced window, per GiB
        # written, bounded; its busy time and the host's rate beside it
        assert r["metrics"]["write_kernel_ms_per_gib"]["value"] > 0
        assert (r["unbounded"]["write_card_ms_per_gib"]["value"]
                > r["metrics"]["write_kernel_ms_per_gib"]["value"])
        assert r["unbounded"]["write_gibs"]["value"] > 0


@pytest.mark.cuda
def test_control_on_the_card():
    need_card()
    out = command("portbench.control", "--workload", "gc-cold.plain-4m", "--seeds", "5",
                  "--seconds", "2")
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert not r["correct"] and r["checks"]["digest_errors"]["value"] > 0
