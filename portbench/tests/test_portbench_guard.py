"""No JAX in what the benchmark loads, and no result without a card."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from portbench.run import FORBIDDEN, ROOT, forbidden_modules


def test_guard_compares_whole_top_level_names():
    names = ["juicefs_tpu_torch", "juicefs_tpu_torch.gpu.pipeline", "numpy", "jaxtyping",
             "jax_extra", "flaxen"]
    assert forbidden_modules(names) == []
    assert forbidden_modules(names + ["jax.numpy", "juicefs_tpu.meta", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "juicefs_tpu"]


def test_no_portbench_source_imports_jax():
    for path in pathlib.Path(ROOT, "portbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(cwd)
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this test checks a host without one")
    out = run(ROOT, "--workload", "gc-cold.plain-4m", "--seed", str(2**33),
              "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(pathlib.Path(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(pathlib.Path(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path, "--workload", "ingest-4w.dedup-4m-lz4", "--seed", "3",
              "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
