"""The repo's checked contracts, run over the port (juicefs_tpu_torch).

- The analyzer (`tools.analyze`): every AST pass over the port's files,
  each `SourceFile` rebuilt with its path mapped from `juicefs_tpu_torch/`
  to `juicefs_tpu/`, since the seam, degrade and claim rules match only
  paths under `juicefs_tpu/`. Zero unsuppressed findings; a run with the
  seam files taken away proves that the path-gated rules saw the package
  (a plain `--root juicefs_tpu_torch` run skips them without a word).
- The metric registry: `lint_registry` and `lint_pinned` over the port's
  registry, populated from the port's counterparts of the modules the
  reference's pass imports, with the shard series pinned under the port's
  names and the kernel-launch gauge pinned beside them.
- The runtime watchdogs: a set of the port's concurrent suites run in one
  subprocess under the port's lockwatch and txnwatch, installed before any
  port module is imported; a guard plugin collects every violation.

The tools stay as they are: the mapping and the pins live here.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from juicefs_tpu_torch import metric as port_metric
from tools.analyze import SourceFile, analyze, load_files
from tools.analyze.passes import degrade, metrics, seams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "juicefs_tpu_torch"
REF = "juicefs_tpu"

# the files whose absence each path-gated rule reports once it has seen
# the package (tools/analyze/passes/seams.py, degrade.py)
GATED = {
    "ingest-seam": "chunk/cached_store.py",
    "compress-seam": "chunk/cached_store.py",
    "meta-cache-seam": "meta/base.py",
    "prefetch-seam": "vfs/reader.py",
    "wbatch-seam": "meta/wbatch.py",
    "meta-resilience-seam": "meta/resilient.py",
    "gateway-seam": "gateway/serve.py",
    "tpu-shard-seam": "chunk/ingest.py",
}

# the port's shard series (the reference pins juicefs_tpu_shard_*; the
# port renamed them on purpose) and its kernel-launch gauge
TORCH_SHARD_PREFIX = "juicefs_torch_shard_"
TORCH_SHARD_EXPECTED = {"juicefs_torch_shard_devices", "juicefs_torch_shard_h2d_batches",
                        "juicefs_torch_shard_degraded"}
TORCH_KERNEL_PREFIX = "juicefs_torch_kernel_"
TORCH_KERNEL_EXPECTED = {"juicefs_torch_kernel_launches"}

# the port's concurrent suites run under its watchdogs (~40 s here)
WATCHED_SUITES = ("test_torch_vfs.py", "test_torch_reader.py", "test_torch_cache_group.py",
                  "test_torch_qos_resilient.py", "test_torch_meta.py")


def _mapped(files: list[SourceFile]) -> list[SourceFile]:
    return [SourceFile(sf.path, REF + "/" + sf.rel.split("/", 1)[1], sf.text) for sf in files]


def _unmapped(rel: str) -> str:
    return PORT + rel[len(REF):] if rel.startswith(REF + "/") else rel


@pytest.fixture(scope="module")
def port_files():
    files = load_files(os.path.join(REPO, PORT))
    assert files and all(sf.rel.startswith(PORT + "/") for sf in files)
    return files


def test_analyzer_finds_nothing_in_the_port(port_files):
    report = analyze(files=_mapped(port_files), runtime=False)
    rendered = [f"{_unmapped(f.file)}:{f.line} {f.rule}: {f.message}"
                for f in report.findings]
    assert rendered == [], "\n".join(rendered)
    assert [f"{_unmapped(s.file)}:{s.comment_line}" for s in report.stale] == []


def _rules_that_saw_the_package(files: list[SourceFile]) -> set[str]:
    """The path-gated rules that report the seam files missing once they
    are taken away, which they do only after seeing the package."""
    dropped = {REF + "/" + f for f in GATED.values()} | {PORT + "/" + f for f in GATED.values()}
    kept = [sf for sf in files if sf.rel not in dropped]
    found = seams.run(kept) + degrade.run(kept)
    return {f.rule for f in found if f.line == 0 and f.rule in GATED}


def test_path_gated_rules_see_the_mapped_port(port_files):
    seen = _rules_that_saw_the_package(_mapped(port_files))
    assert seen, "no path-gated rule saw the port"
    assert seen == set(GATED)
    # unmapped, the same files slip past every one of them
    assert _rules_that_saw_the_package(port_files) == set()


def test_qos_seam_holds_for_the_kernel_builds(port_files):
    """build_all starts one nvcc process per source side by side; it
    creates no ThreadPoolExecutor outside qos/."""
    found = seams.run_qos_seam(_mapped(port_files))
    assert found == []
    kernels = next(sf for sf in port_files if sf.rel == f"{PORT}/gpu/kernels/__init__.py")
    assert "ThreadPoolExecutor" not in kernels.text


def test_build_all_runs_the_builds_side_by_side(tmp_path, monkeypatch):
    """A stand-in nvcc that marks its start and waits (up to 10 s) until
    every build has started before it writes an empty library: build_all
    finishes only if all builds run at once; each is timed and loaded, a
    second call loads them as built, and a failed build raises with
    nvcc's output and leaves no library behind."""
    from juicefs_tpu_torch.gpu import kernels

    names = sorted(set(kernels.ENTRY_SOURCES.values()))
    marks = tmp_path / "started"
    marks.mkdir()
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    "out=''; prev=''\n"
                    "for a in \"$@\"; do [ \"$prev\" = -o ] && out=$a; prev=$a; done\n"
                    f"touch {marks}/$$\n"
                    "i=0\n"
                    f"while [ $(ls {marks} | wc -l) -lt {len(names)} ] && [ $i -lt 200 ]; do\n"
                    "  sleep 0.05; i=$((i + 1)); done\n"
                    f"[ $(ls {marks} | wc -l) -ge {len(names)} ] || {{ echo 'ran alone'; exit 4; }}\n"
                    "[ -n \"$FAIL_NVCC\" ] && { echo 'error: stand-in failure'; exit 3; }\n"
                    "exec gcc -shared -fPIC -x c /dev/null -o \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "BUILD_SECONDS", {})
    took = kernels.build_all()
    assert len(names) >= 2 and sorted(took) == names
    assert len(os.listdir(marks)) == len(names)
    assert sorted(kernels._libs) == names
    assert kernels.build_all() == took  # loaded as built: nothing rebuilt

    for f in os.listdir(marks):
        os.unlink(marks / f)
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build2"))
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setenv("FAIL_NVCC", "1")
    with pytest.raises(RuntimeError, match="stand-in failure"):
        kernels.build_all()
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "build2"))


@pytest.fixture(scope="module")
def port_registry():
    import juicefs_tpu_torch.cache.group  # noqa: F401
    import juicefs_tpu_torch.cache.server  # noqa: F401
    import juicefs_tpu_torch.chunk.bypass  # noqa: F401
    import juicefs_tpu_torch.chunk.cached_store  # noqa: F401
    import juicefs_tpu_torch.chunk.disk_cache  # noqa: F401
    import juicefs_tpu_torch.chunk.ingest  # noqa: F401
    import juicefs_tpu_torch.chunk.mem_cache  # noqa: F401
    import juicefs_tpu_torch.chunk.parallel  # noqa: F401
    import juicefs_tpu_torch.chunk.prefetch  # noqa: F401
    import juicefs_tpu_torch.chunk.singleflight  # noqa: F401
    import juicefs_tpu_torch.gateway.serve  # noqa: F401
    import juicefs_tpu_torch.gpu.compress_batch  # noqa: F401
    import juicefs_tpu_torch.gpu.kernels  # noqa: F401
    import juicefs_tpu_torch.gpu.pipeline  # noqa: F401
    import juicefs_tpu_torch.gpu.sharding  # noqa: F401
    import juicefs_tpu_torch.meta.cache  # noqa: F401
    import juicefs_tpu_torch.meta.resilient  # noqa: F401
    import juicefs_tpu_torch.meta.wbatch  # noqa: F401
    import juicefs_tpu_torch.metric.trace  # noqa: F401
    import juicefs_tpu_torch.object.metered  # noqa: F401
    import juicefs_tpu_torch.object.resilient  # noqa: F401
    import juicefs_tpu_torch.object.sharding  # noqa: F401
    import juicefs_tpu_torch.qos.limiter  # noqa: F401
    import juicefs_tpu_torch.qos.scheduler  # noqa: F401
    import juicefs_tpu_torch.vfs.reader  # noqa: F401

    port_metric.register_process_metrics()
    return port_metric.global_registry()


def test_port_registry_lints_clean(port_registry):
    assert metrics.lint_registry(port_registry) == []


PINS = [
    (metrics.CACHE_GROUP_PREFIX, metrics.CACHE_GROUP_EXPECTED, "cache-group"),
    (metrics.INGEST_PREFIX, metrics.INGEST_EXPECTED, "ingest"),
    (metrics.QOS_PREFIX, metrics.QOS_EXPECTED, "qos"),
    (metrics.COMPRESS_PREFIX, metrics.COMPRESS_EXPECTED, "compress"),
    (metrics.META_CACHE_PREFIX, metrics.META_CACHE_EXPECTED, "meta-cache"),
    (metrics.META_THROTTLE_PREFIX, metrics.META_THROTTLE_EXPECTED, "meta-throttle"),
    (metrics.META_FAULT_PREFIX, metrics.META_FAULT_EXPECTED, "meta-fault"),
    (metrics.META_BREAKER_PREFIX, metrics.META_BREAKER_EXPECTED, "meta-breaker"),
    (metrics.META_STALE_PREFIX, metrics.META_STALE_EXPECTED, "meta-stale"),
    (metrics.META_WBATCH_PREFIX, metrics.META_WBATCH_EXPECTED, "meta-wbatch"),
    (metrics.PREFETCH_PREFIX, metrics.PREFETCH_EXPECTED, "prefetch"),
    (metrics.READAHEAD_PREFIX, metrics.READAHEAD_EXPECTED, "readahead"),
    (metrics.GATEWAY_PREFIX, metrics.GATEWAY_EXPECTED, "gateway"),
    (TORCH_SHARD_PREFIX, TORCH_SHARD_EXPECTED, "torch-shard"),
    (TORCH_KERNEL_PREFIX, TORCH_KERNEL_EXPECTED, "torch-kernel"),
    # the reference's shard names: nothing of the port squats under them
    (metrics.TPU_SHARD_PREFIX, set(), "tpu-shard"),
]


@pytest.mark.parametrize("prefix,expected,what", PINS, ids=[p[2] for p in PINS])
def test_port_registry_holds_the_pins(port_registry, prefix, expected, what):
    assert metrics.lint_pinned(prefix, expected, what, registry=port_registry) == []


def test_every_reference_pin_is_pinned_for_the_port():
    pinned = {p[0] for p in PINS}
    reference = {getattr(metrics, n) for n in dir(metrics) if n.endswith("_PREFIX")}
    assert reference <= pinned


_WATCHDOG_RUN = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
from juicefs_tpu_torch.utils import lockwatch, txnwatch
assert lockwatch.install() and txnwatch.install()
import pytest


class Guard:
    '''Collects every lockwatch and txnwatch violation, by test.'''

    def __init__(self):
        self.found = []

    def pytest_runtest_setup(self, item):
        self.before = (len(lockwatch.violations()), len(txnwatch.violations()))

    def pytest_runtest_teardown(self, item):
        locks, txns = self.before
        for v in lockwatch.violations()[locks:]:
            self.found.append({{"test": item.nodeid, "kind": v["kind"],
                               "detail": v["detail"]}})
        for v in txnwatch.violations()[txns:]:
            self.found.append({{"test": item.nodeid, "kind": "txn " + v["engine"],
                               "detail": f"{{v['closure']}}: {{v['detail']}}"}})


guard = Guard()
rc = pytest.main([*{suites!r}, "-q", "--noconftest", "-p", "no:cacheprovider",
                  "-p", "no:xdist", "-p", "no:randomly"], plugins=[guard])
print("WATCHDOG " + json.dumps({{"rc": int(rc), "violations": guard.found,
                                "lock_edges": len(lockwatch.state().edges),
                                "txns_doubled": txnwatch.state().doubled}}))
"""


def test_port_suites_run_clean_under_the_port_watchdogs():
    """The chosen suites, in one process whose port modules were all
    imported after the port's lockwatch and txnwatch were installed
    (the suite's conftest is not loaded, so the reference's watchdogs
    stay out of the way): rc 0, no violation, and both watchdogs saw
    work."""
    suites = [os.path.join(REPO, "tests", s) for s in WATCHED_SUITES]
    env = dict(os.environ, JUICEFS_LOCK_WATCHDOG="1", JUICEFS_TXN_RERUN="1",
               JAX_PLATFORMS="cpu")
    env.pop("PYTEST_XDIST_WORKER", None)
    out = subprocess.run([sys.executable, "-c", _WATCHDOG_RUN.format(repo=REPO, suites=suites)],
                         capture_output=True, text=True, env=env, timeout=240, cwd=REPO)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("WATCHDOG ")]
    assert lines, out.stdout[-3000:] + out.stderr[-3000:]
    doc = json.loads(lines[-1][len("WATCHDOG "):])
    assert doc["violations"] == [], json.dumps(doc["violations"], indent=1)
    assert doc["rc"] == 0, out.stdout[-5000:]
    # both watchdogs really watched: nested port locks and doubled txns
    assert doc["lock_edges"] > 0 and doc["txns_doubled"] > 0, doc
