"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in `BENCHMARK.json` at the checkout's
root. Its configuration file (`configs/<config>.json`) and its traffic
file (`traffic/<traffic>.json`, which names the driver,
`drivers/<driver>.py`) are read by name; each per-layer metric the cell
reports is the function `read(rec)` of `metrics/<metric>.py`.

A run: requires as many CUDA cards as the cell asks for (no result and a
non-zero exit otherwise; nothing falls back to the CPU), makes the
traffic's data from the seed, builds the volume, lets the driver warm up
every shape it uses (all of it counted in `setup_s`, from process start
to the first timed operation), measures for `--seconds`, then checks the
window's outputs against the plain reference in `portbench/reference/`.
With `--trace 0` the metrics are the cell's end-to-end metrics: those
on the host's clock as the driver measured them, and those from the
device trace as the card's time over the whole window (busy, or in
kernels, by a profiler that records card activity alone) per GiB of the
window's work; whatever else was measured goes under `unbounded`, with
no bound (the scan and write rates and the writers' commit p95, which
the host spreads more than any bound allowed holds). With `--trace 1` the metrics are its
per-layer metrics, read over the same window with a device trace of its
middle. The last line of standard output is one JSON object; the numbers
compared for `correct` end standard error and the result line
(`checks`). A run whose process holds `jax`, `jaxlib`, `flax`
or `juicefs_tpu` after the window exits non-zero with no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "juicefs_tpu")
GIB = 1 << 30


class RunError(Exception):
    """A run that must end with no result line."""


class Context:
    """What a driver sees of one run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `juicefs_tpu_torch` passes."""
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def resolve(root: str, workload: str):
    """(benchmark, cell, configuration entry, configuration, traffic) of
    `workload`, each file found by the name BENCHMARK.json gives."""
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise RunError(f"{path} not found")
    bench = load_json(path)
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"unknown workload {workload!r} (have {sorted(cells)})")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    return bench, cell, entry, config, traffic


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_driver(name: str):
    if not os.path.exists(os.path.join(HERE, "drivers", f"{name}.py")):
        raise RunError(f"no driver {name!r} in {os.path.join(HERE, 'drivers')}")
    return importlib.import_module(f"portbench.drivers.{name}")


def load_metric(name: str):
    """The reader `read(rec)` of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise RunError(f"no reader for per-layer metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "__").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card(chips: int) -> dict:
    """The cards this run uses; raises when there are fewer than `chips`."""
    import torch

    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is False: this benchmark runs on "
                       "CUDA cards only and never on the CPU")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards; {torch.cuda.device_count()} "
                       "visible")
    power = "unknown"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
        if out:
            power = out[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "power_limit": power}


def stage_delta(before: dict, after: dict) -> dict:
    out = {}
    for name, a in after.items():
        b = before.get(name, {"count": 0, "sum_seconds": 0.0})
        if a["count"] != b["count"]:
            out[name] = {"count": a["count"] - b["count"],
                         "seconds": a["sum_seconds"] - b["sum_seconds"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: str = ROOT, require_cuda: bool = True, overrides: dict | None = None,
             sample: int | None = None, card_clock: bool = True) -> tuple[dict, list]:
    """One run of `workload`. Returns (result line, compared numbers as
    (name, value, limit)). `overrides` replaces keys of the configuration
    and traffic files ({"config": {...}, "traffic": {...}}) and `sample`
    the number of outputs compared: both for tests at a small size, as is
    `require_cuda=False`, which skips the look for a card. With
    `card_clock=False` (the control, whose hash runs on the host) the
    untraced window's card time is not taken and its metrics are left out."""
    err = sys.stderr
    bench, cell, _entry, config, traffic = resolve(root, workload)
    config = {**config, **((overrides or {}).get("config", {}))}
    traffic = {**traffic, **((overrides or {}).get("traffic", {}))}
    driver = load_driver(traffic["driver"])
    e2e = [m for m in bench["end_to_end"] if applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if applies(m, workload)]
    readers = {m["name"]: load_metric(m["name"]) for m in per_layer} if trace else {}

    import torch

    if require_cuda:
        device = card(cell["chips"])
        gen_device = "cuda"
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 0, "power_limit": "none"}
        gen_device = "cpu"
    from . import data
    from .devtrace import CardClock, DeviceTrace, counters

    from juicefs_tpu_torch.metric.trace import stage_metrics_snapshot

    workdir = tempfile.mkdtemp(prefix="portbench-")
    state = None
    try:
        t_data = time.perf_counter()
        buffer = data.random_buffer(seed, traffic["buffer_mib"] << 20, gen_device)
        if require_cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ctx = Context(seed=seed, seconds=seconds, config=config, traffic=traffic,
                      workdir=workdir, buffer=buffer, sample=sample, err=err)
        t_volume = time.perf_counter()
        state = driver.setup(ctx)
        print(f"set-up: imports and card {t_data - T_PROCESS:.3f} s, data "
              f"{t_volume - t_data:.3f} s, volume and warm-up "
              f"{time.perf_counter() - t_volume:.3f} s", file=err)
        dtrace = DeviceTrace(trace and require_cuda, workdir, device["kind"])
        clock = CardClock(card_clock and not trace and require_cuda
                          and any(m["source"] == "device_trace" for m in e2e), workdir)
        stages0, count0 = stage_metrics_snapshot(), counters()
        setup_s = time.perf_counter() - T_PROCESS
        clock.begin()
        dtrace.begin()
        try:
            win = driver.window(state, ctx, dtrace)
        finally:
            dtrace.end()
            clock.end()
        stages = stage_delta(stages0, stage_metrics_snapshot())
        print("window: " + json.dumps({k: v for k, v in win.items() if k != "passes"})
              + " stages " + json.dumps(stages), file=err)
        if "passes" in win:
            print("pass seconds: " + json.dumps([p["seconds"] for p in win["passes"]]),
                  file=err)
        count1 = counters()
        if require_cuda:
            torch.cuda.synchronize()
            device["memory_peak_bytes"] = int(max(
                torch.cuda.max_memory_allocated(i) for i in range(cell["chips"])))
        else:
            device["memory_peak_bytes"] = 0
        checks = driver.check(state, ctx)
    finally:
        if state is not None:
            driver.close(state)
        shutil.rmtree(workdir, ignore_errors=True)

    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package loaded: {found}")
    result = {"correct": all(v <= lim for _n, v, lim in checks),
              "attempted": win["attempted"], "failed": win["failed"]}
    metrics, unbounded = {}, {}
    if trace:
        rec = {"kind": device["kind"], "window": win, "stages": stages,
               "counters": {k: count1[k] - count0[k] for k in count1},
               "trace": dtrace.summary}
        for m in per_layer:
            value = readers[m["name"]](rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # the driver's numbers on the host's clock, then the card's
        # milliseconds (busy, or in kernels) per GiB of the work each
        # device metric names
        values = dict(win["metrics"], setup_s={"value": setup_s, "unit": "s"})
        if clock.seconds is not None:
            values.update({name: {"value": clock.seconds[of] * 1e3 / (nbytes / GIB),
                                  "unit": "ms/GiB"}
                           for name, (of, nbytes) in win["card_work"].items()})
        for m in e2e:
            if m["source"] == "device_trace" and not clock.enabled:
                continue  # no card clock: left out, never 0
            if m["name"] not in values:
                raise RunError(f"the driver reported no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]]["value"], "unit": m["unit"]}
        unbounded = {n: v for n, v in values.items() if n not in metrics}
    result["metrics"] = metrics
    result["device"] = device
    if trace and dtrace.summary is not None:
        device["busy_s"] = dtrace.summary["busy_s"]
        device["window_s"] = dtrace.summary["window_s"]
        result["breakdown"] = dtrace.summary["breakdown"]
    if not trace and unbounded:
        # numbers of the untraced window that users see but no bound can
        # hold (their runs spread more than the widest bound allowed)
        result["unbounded"] = unbounded
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every build and kernel cache of the run stays inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    try:
        result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        print("portbench: the run failed; no result", file=sys.stderr)
        return 1
    for name, value, limit in checks:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
