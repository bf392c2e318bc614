"""Adaptive elision bypass (a copy of juicefs_tpu/chunk/bypass.py): sample
the live dedup hit rate and stop paying for hash+lookup when duplicate
density is low.

Inline dedup (chunk/ingest.py) is a pure win when duplicates exist but
a regression on a zero-duplicate workload: every block pays hashing, a
content-ref lookup, and the batch-barrier latency with nothing ever
elided. The governor makes the stage self-tuning:

    SAMPLE   every block runs the full dedup path; each outcome
             (hit=elided / miss) lands in a sliding window. Startup
             state — a dup-heavy workload must never lose its early
             elisions to a warm-up bypass.
    BYPASS   entered when the window holds >= min_samples outcomes and
             the hit rate sits below `low_water`: blocks skip
             hash/lookup entirely and go straight to the plain upload
             pool (zero dedup overhead, the dup-0.0 workload's fast
             path). Every `probe_every`-th block is a PROBE: it still
             uploads directly (zero added latency) but its dup-ness is
             shadow-sampled against the ingest stage's hot-content
             cache (sampled fp + memcmp — no hash, no meta txn), so
             the window keeps learning and a workload that turns
             dup-heavy is noticed.
    (back)   probes pushing the windowed hit rate to `high_water`
             re-enter SAMPLE. The low/high hysteresis gap keeps a
             boundary workload from flapping.

The window is outcome-count based, not wall-clock: dup density is a
property of the byte stream, so the sampler should follow the stream's
position, not the wall. Thread-safe; `admit()` is a couple of integer
ops on the write path.
"""

from __future__ import annotations

import threading
from collections import deque

from ..metric import global_registry

_reg = global_registry()
_BYPASSED = _reg.counter(
    "juicefs_ingest_bypass",
    "Blocks skipping hash+lookup entirely (adaptive elision bypass: "
    "sampled dup density below the low-water mark)",
)
_PROBES = _reg.counter(
    "juicefs_ingest_bypass_probes",
    "Bypassed blocks shadow-sampled for duplicate density (hot-content "
    "memcmp probes; they upload directly like any bypassed block)",
)


class ElisionGovernor:
    """admit() -> DEDUP (run the full dedup path), BYPASS (skip it), or
    PROBE (skip it, but shadow-sample this block's dup-ness cheaply —
    hot-content memcmp, no hash/meta — so the window keeps learning).
    record(hit) feeds sampled outcomes back. All verdicts are truthy
    strings; only DEDUP routes a block through hash+lookup."""

    DEDUP = "dedup"
    BYPASS = "bypass"
    PROBE = "probe"

    def __init__(self, window: int = 64, min_samples: int = 16,
                 low_water: float = 0.05, high_water: float = 0.15,
                 probe_every: int = 16):
        if not 0.0 <= low_water <= high_water <= 1.0:
            raise ValueError("need 0 <= low_water <= high_water <= 1")
        self.window = max(4, int(window))
        self.min_samples = max(1, int(min_samples))
        self.low_water = low_water
        self.high_water = high_water
        self.probe_every = max(2, int(probe_every))
        self._lock = threading.Lock()
        self._outcomes: deque[bool] = deque(maxlen=self.window)
        self._hits = 0  # hits currently inside the window
        self._bypassing = False
        self._since_probe = 0
        # stats mirror (bench/tests/.status)
        self.sampled = 0
        self.bypassed = 0
        self.probes = 0
        self.transitions = 0

    # -- write-path side ---------------------------------------------------
    def admit(self) -> str:
        with self._lock:
            if not self._bypassing:
                return self.DEDUP
            self._since_probe += 1
            if self._since_probe >= self.probe_every:
                self._since_probe = 0
                self.probes += 1
                self.bypassed += 1
                _PROBES.inc()
                _BYPASSED.inc()
                return self.PROBE
            self.bypassed += 1
        _BYPASSED.inc()
        return self.BYPASS

    def record(self, hit: bool) -> None:
        """One sampled dedup outcome (called for every block that ran the
        dedup path — SAMPLE-state traffic and BYPASS-state probes)."""
        with self._lock:
            self.sampled += 1
            if len(self._outcomes) == self.window and self._outcomes[0]:
                self._hits -= 1  # the evicted outcome leaves the window
            self._outcomes.append(hit)
            if hit:
                self._hits += 1
            n = len(self._outcomes)
            if n < self.min_samples:
                return
            rate = self._hits / n
            if not self._bypassing and rate < self.low_water:
                self._bypassing = True
                self._since_probe = 0
                self.transitions += 1
            elif self._bypassing and rate >= self.high_water:
                self._bypassing = False
                self.transitions += 1

    # -- observability -----------------------------------------------------
    @property
    def bypassing(self) -> bool:
        return self._bypassing

    def hit_rate(self) -> float:
        with self._lock:
            n = len(self._outcomes)
            return self._hits / n if n else 0.0

    def stats(self) -> dict:
        with self._lock:
            n = len(self._outcomes)
            return {
                "state": "bypass" if self._bypassing else "sample",
                "window": n,
                "hit_rate": round(self._hits / n, 4) if n else 0.0,
                "sampled": self.sampled,
                "bypassed": self.bypassed,
                "probes": self.probes,
                "transitions": self.transitions,
            }
