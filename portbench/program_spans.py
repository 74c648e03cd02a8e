"""The program's own spans, read after the traced slice and put on the
device trace's clock.

``multicol_slam_tpu_torch.utils.timing`` records a span only while a
profile runs, so its ``spans()`` are the traced slice's: name, thread,
``perf_counter_ns`` start and end, parent, ids. The trace's clock is the
profiler's, not ``perf_counter``. The program opens ``local_mapping.pass``
inside the mapper's call that the benchmark's own span of that name
wraps, so the two lists pair in order, their starts microseconds apart:
the offset between the clocks is the median difference of the paired
starts, and it holds when every pair's start and end lie within
``TOLERANCE_S`` of it.

A program that keeps no spans of its own (an older one) gives no records,
and every reader of them gives nothing.
"""

from __future__ import annotations

import bisect
import statistics

PASS = "local_mapping.pass"
TOLERANCE_S = 2e-4


def records():
    """The program's span records, or None where it keeps none."""
    try:
        from multicol_slam_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "spans", None)
    return None if read is None else read()


def seconds(rec) -> tuple[float, float]:
    """A record's (start, end) on its own clock, in seconds."""
    return rec.start_ns * 1e-9, rec.end_ns * 1e-9


def per_pass_ms(recs, names) -> float | None:
    """Mean ms a mapping pass of the spans named ``names``: their summed
    time over the number of ``local_mapping.pass`` spans."""
    if recs is None:
        return None
    passes = sum(r.name == PASS for r in recs)
    if not passes:
        return None
    return sum(r.end_ns - r.start_ns for r in recs if r.name in names) * 1e-6 / passes


def mean_ms(recs, name: str) -> float | None:
    """Mean ms of the spans called ``name``."""
    d = [r.end_ns - r.start_ns for r in recs or () if r.name == name]
    return sum(d) * 1e-6 / len(d) if d else None


def alignment(recs, trace) -> tuple[float, float] | None:
    """(offset s, largest residual s): the trace's clock less the
    program's, from the paired ``local_mapping.pass`` spans; None when
    the counts differ, there are none, or a residual passes
    ``TOLERANCE_S``."""
    if recs is None or trace is None:
        return None
    ours = sorted(seconds(r) for r in recs if r.name == PASS)
    theirs = [(t0, t1) for t0, t1, n in trace.spans if n == PASS]
    if not ours or len(ours) != len(theirs):
        return None
    offset = statistics.median(b[0] - a[0] for a, b in zip(ours, theirs))
    residual = max(max(abs(b[0] - a[0] - offset), abs(b[1] - a[1] - offset))
                   for a, b in zip(ours, theirs))
    return None if residual > TOLERANCE_S else (offset, residual)


def idle_pct(recs, trace, name: str) -> float | None:
    """100 x the time inside the spans called ``name`` in which the card
    ran no kernel, copy or set, over those spans' time, on the trace's
    clock; None without an alignment or such spans."""
    aligned = alignment(recs, trace)
    if aligned is None:
        return None
    spans = [(a + aligned[0], b + aligned[0])
             for a, b in (seconds(r) for r in recs if r.name == name)]
    total = sum(b - a for a, b in spans)
    if total <= 0:
        return None
    busy = trace.busy()          # sorted, disjoint
    starts = [a for a, _ in busy]
    covered = 0.0
    for t0, t1 in spans:
        i = max(bisect.bisect_right(starts, t0) - 1, 0)
        while i < len(busy) and busy[i][0] < t1:
            covered += max(0.0, min(busy[i][1], t1) - max(busy[i][0], t0))
            i += 1
    return 100.0 * (1.0 - covered / total)
