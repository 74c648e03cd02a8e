"""The traced slice: host spans around the program's layers and the
device's activity from ``torch.profiler``.

Spans are ``record_function`` ranges that the benchmark puts around calls
into each layer (the program has none of its own); the device's activity
is every kernel, copy and set of the profiler's trace. From them: the
device's busy seconds (the union of its activity), the time of each
kernel by name, and each idle gap of the device named by the innermost
span the host was in when the gap began.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

SPAN = "portbench:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _wrap(fn, name):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with torch.profiler.record_function(SPAN + name):
            return fn(*args, **kwargs)
    return spanned


@contextlib.contextmanager
def spans(targets):
    """Wrap each (object, attribute, span name) for the block."""
    saved = []
    for obj, attr, name in targets:
        if obj is None:
            continue
        had = attr in vars(obj)
        saved.append((obj, attr, had, vars(obj).get(attr)))
        setattr(obj, attr, _wrap(getattr(obj, attr), name))
    try:
        yield
    finally:
        for obj, attr, had, old in reversed(saved):
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)


def kernel_name(name: str) -> str:
    """A demangled kernel's function name: ``void ns::f<1>(...)`` ->
    ``ns::f<1>`` (an anonymous namespace kept as ``(anon)``)."""
    name = name.replace("(anonymous namespace)", "(anon)")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and not name.startswith("(anon)", i):
            cut = i
            break
    return re.sub(r"^void\s+", "", name[:cut].strip()) or "?"


class Trace:
    """The profiler's events over one slice, as intervals in seconds."""

    def __init__(self, events):
        """``events``: a Chrome trace's ``traceEvents``."""
        self.device = []      # (start s, end s, name, category)
        self.spans = []       # (start s, end s, name)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0, t1 = float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append((t0, t1, e["name"], cat))
            elif cat == "user_annotation" and e["name"].startswith(SPAN):
                self.spans.append((t0, t1, e["name"][len(SPAN):]))
        self.device.sort()
        self.spans.sort()

    @classmethod
    def of(cls, prof) -> "Trace":
        """The trace of a finished ``torch.profiler.profile``, through its
        Chrome export (a temporary file under TMPDIR)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                return cls(json.load(f)["traceEvents"])
        finally:
            os.remove(path)

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device's activity, merged intervals."""
        out = []
        for t0, t1, _, _ in self.device:
            if out and t0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t1)
            else:
                out.append([t0, t1])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.busy())

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose function name matches."""
        rx = re.compile(pattern)
        return sum(t1 - t0 for t0, t1, n, cat in self.device
                   if cat == "kernel" and rx.search(kernel_name(n)))

    def device_ops(self, top: int = 10) -> list:
        by = defaultdict(float)
        for t0, t1, n, cat in self.device:
            by[kernel_name(n) if cat == "kernel" else cat] += t1 - t0
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, t_start: float, t_end: float, top: int = 10) -> list:
        """The device's idle seconds inside [t_start, t_end], summed by the
        innermost span the host was in when each gap began (``host``
        outside every span)."""
        by = defaultdict(float)
        gaps, edge = [], t_start
        for t0, t1 in self.busy() + [(t_end, t_end)]:
            if t0 > edge:
                gaps.append((edge, min(t0, t_end)))
            edge = max(edge, t1)
            if edge >= t_end:
                break
        open_, i = [], 0
        for g0, g1 in gaps:
            while i < len(self.spans) and self.spans[i][0] <= g0:
                open_.append(self.spans[i])
                i += 1
            open_ = [s for s in open_ if s[1] > g0]
            by[open_[-1][2] if open_ else "host"] += g1 - g0
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def span_interval(self, name: str) -> tuple[float, float]:
        """The first span of that name, (start, end) in seconds."""
        for t0, t1, n in self.spans:
            if n == name:
                return t0, t1
        raise LookupError(f"no span {name!r} in the trace")
