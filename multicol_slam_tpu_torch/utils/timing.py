"""Per-stage timing registry.

Port of ``multicol_slam_tpu/utils/timing.py`` (the reference's per-frame
vectors of extraction / initial-pose / local-map times, cTracking.h:
119-121, printed as median and mean at exit). Times are host wall clock;
a stage that should include the device's work synchronizes inside it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


class StageTimers:
    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[stage].append(time.perf_counter() - t0)

    def record(self, stage: str, seconds: float):
        self.samples[stage].append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for stage, xs in self.samples.items():
            a = np.asarray(xs)
            out[stage] = dict(
                n=len(a), mean_ms=float(a.mean() * 1e3),
                median_ms=float(np.median(a) * 1e3),
                p90_ms=float(np.percentile(a, 90) * 1e3),
                total_s=float(a.sum()))
        return out

    def report(self) -> str:
        lines = [f"{'stage':<28}{'n':>6}{'median ms':>12}{'mean ms':>10}"
                 f"{'p90 ms':>10}"]
        for stage, s in sorted(self.summary().items()):
            lines.append(f"{stage:<28}{s['n']:>6}{s['median_ms']:>12.2f}"
                         f"{s['mean_ms']:>10.2f}{s['p90_ms']:>10.2f}")
        return "\n".join(lines)

    def clear(self):
        self.samples.clear()
