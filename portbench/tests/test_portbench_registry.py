"""A cell, traffic mix and per-layer metric are found by name: adding one
is adding files and entries, with no edit to a file that is there."""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

from portbench.run import ROOT, applies, load_metric, resolve

PORTBENCH = pathlib.Path(ROOT, "portbench")


def digests(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_every_declared_piece_is_found_by_name():
    bench = json.loads(pathlib.Path(ROOT, "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        _b, _c, entry, config, traffic = resolve(ROOT, cell["name"])
        assert config["name"] == cell["config"] == entry["name"]
        assert (PORTBENCH / "drivers" / f"{traffic['driver']}.py").exists()
        names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]
                 if applies(m, cell["name"])]
        assert "setup_s" in names and len(names) >= 3
    for m in bench["per_layer"]:
        assert callable(load_metric(m["name"]))


def test_a_dropped_in_traffic_and_metric_need_no_edit(tmp_path):
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(pathlib.Path(ROOT, "BENCHMARK.json").read_text())
    before = digests(tmp_path / "portbench")
    # a new mix for an existing driver, a new metric reader, and entries
    traffic = json.loads((PORTBENCH / "traffic" / "gc-cold.json").read_text())
    traffic["reset"] = "fifth"
    (tmp_path / "portbench" / "traffic" / "gc-new.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench" / "metrics" / "passes_seen.py").write_text(
        "def read(rec):\n    return float(len(rec['window']['passes']))\n")
    bench["workloads"].append({"name": "gc-new.plain-4m", "config": "plain-4m",
                               "traffic": "gc-new", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "passes_seen", "unit": "passes", "better": "higher",
                               "source": "program_counter", "layer": "cmd.gc",
                               "moves": "scan_card_ms_per_gib", "workloads": ["gc-new.plain-4m"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digests(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
    code = (
        "import json\n"
        "from portbench.run import resolve, load_driver, load_metric, applies\n"
        "b, cell, e, cfg, tr = resolve('.', 'gc-new.plain-4m')\n"
        "drv = load_driver(tr['driver'])\n"
        "names = [m['name'] for m in b['per_layer'] if applies(m, cell['name'])]\n"
        "v = load_metric('passes_seen')({'window': {'passes': [1, 2, 3]}})\n"
        "print(json.dumps([tr['reset'], drv.__name__, names, v]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    reset, driver, names, value = json.loads(out.stdout.strip().splitlines()[-1])
    assert reset == "fifth" and driver == "portbench.drivers.gc_passes"
    assert "passes_seen" in names and value == 3.0
