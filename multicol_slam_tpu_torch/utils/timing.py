"""Per-stage timing registry and the port's spans.

``StageTimers`` ports ``multicol_slam_tpu/utils/timing.py`` (the
reference's per-frame vectors of extraction / initial-pose / local-map
times, cTracking.h:119-121, printed as median and mean at exit). Times
are host wall clock; a stage that should include the device's work
synchronizes inside it.

``span(name, **ids)`` marks a stage of the port (a mapping pass and its
stages, the loop closer's insertion, the tracker's stages, a graph's
capture). It is on exactly while a ``torch.profiler`` profile runs: then
it appends a ``Span`` record (name, thread, ``perf_counter_ns`` start and
end, the index of the innermost open span of its thread, its ids) to a
list in memory, and opens ``torch.profiler.record_function(name)``, so the
profiler's timeline shows the stage. Off, it reads one flag and returns a
shared no-op context. ``spans()`` returns the records, ``clear_spans()``
drops them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import profiler as _profiler


@dataclasses.dataclass
class Span:
    name: str
    thread: str
    start_ns: int
    end_ns: int        # -1 while the span is open
    parent: int        # index in ``spans()`` of the enclosing span, -1 at the top
    ids: dict


_records: list[Span] = []
_records_lock = threading.Lock()
_open = threading.local()       # per thread: the indices of its open spans
_OFF = contextlib.nullcontext()


class _On:
    __slots__ = ("name", "ids", "rec", "stack", "range")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.rec = Span(self.name, threading.current_thread().name, time.perf_counter_ns(), -1,
                        stack[-1] if stack else -1, self.ids)
        with _records_lock:
            stack.append(len(_records))
            _records.append(self.rec)
        self.stack = stack
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return self.rec

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.rec.end_ns = time.perf_counter_ns()
        self.stack.pop()
        return False


def span(name: str, **ids):
    """A context manager over one stage: recorded while a
    ``torch.profiler`` profile runs, a shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, ids)


def spans() -> list[Span]:
    """The records of every span opened since the last ``clear_spans``,
    in the order they opened."""
    with _records_lock:
        return list(_records)


def clear_spans():
    with _records_lock:
        _records.clear()


class StageTimers:
    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def time(self, stage: str):
        """Time the block as ``stage``; under the profiler also the span
        ``tracker.<stage>``."""
        with span("tracker." + stage):
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
