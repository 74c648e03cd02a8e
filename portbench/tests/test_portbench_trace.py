"""The traced slice's arithmetic: the device's busy union, idle gaps named
by the innermost span, kernel time by name, and the per-layer readers."""

import pytest

from portbench import run, spec, trace


def _events():
    us = lambda s: s * 1e6
    k = lambda name, t0, t1, cat="kernel": {"ph": "X", "cat": cat, "name": name,
                                             "ts": us(t0), "dur": us(t1 - t0)}
    span = lambda name, t0, t1: k(trace.SPAN + name, t0, t1, "user_annotation")
    return [span("slice", 0.0, 10.0), span("tracker.chunk", 0.5, 2.0),
            span("local_mapping.pass", 3.0, 9.0),
            k("void cell_flags<16, 9>(Table, unsigned char*)", 1.0, 1.5),
            k("void tile_maxima<16>(Table, unsigned char const*, float*, int*)", 1.4, 1.8),
            k("void describe<true>(Pyramid, int const*)", 1.8, 2.0),
            k("Memcpy HtoD", 2.5, 3.0, "gpu_memcpy"),
            k("sgemm", 8.0, 9.0), {"ph": "i", "name": "marker", "ts": 0}]


def test_busy_union_and_kernel_time():
    tr = trace.Trace(_events())
    assert tr.busy() == [(1.0, 2.0), (2.5, 3.0), (8.0, 9.0)]
    assert tr.busy_s() == pytest.approx(2.5)
    assert tr.kernel_s(r"(^|::)(cell_flags|tile_maxima)(<|$)") == pytest.approx(0.9)
    assert tr.kernel_s(r"(^|::)describe<") == pytest.approx(0.2)
    assert tr.span_interval("slice") == (0.0, 10.0)
    names = [n for n, _ in tr.device_ops()]
    assert names[:2] == ["sgemm", "cell_flags<16, 9>"] and "gpu_memcpy" in names


def test_idle_gaps_by_innermost_span():
    tr = trace.Trace(_events())
    gaps = dict(tr.idle_gaps(0.0, 10.0))
    # 0-1 in slice (tracker.chunk opens at 0.5, after the gap began), 2-2.5 in
    # slice (the chunk span ended at 2.0), 3-8 in the mapping pass, 9-10 in slice
    assert gaps == pytest.approx({"slice": 2.5, "local_mapping.pass": 5.0})
    assert sum(gaps.values()) + tr.busy_s() == pytest.approx(10.0)


def test_readers():
    before = {"timers": {"working_chunk": [1.0], "working_fused": [0.004]},
              "frame_path": ["chunk"] * 8, "mapping_ms": [300.0], "captures": 5,
              "chunk_scans": []}
    after = {"timers": {"working_chunk": [1.0, 0.016, 0.016], "working_fused": [0.004, 0.005]},
             "frame_path": ["chunk"] * 8 + ["chunk"] * 15 + ["fused"], "mapping_ms": [300.0, 100.0, 200.0],
             "captures": 6, "chunk_scans": []}
    tr = trace.Trace(_events())
    ctx = run.Context(before, after, tr, 10.0, 2.5, lambda kind: 1e-3)
    assert spec.reader("chunk_frame_ms")(ctx) == pytest.approx(32.0 / 15)
    assert spec.reader("working_ms.live")(ctx) == pytest.approx(5.0)
    assert spec.reader("mapping_ms.batch")(ctx) == pytest.approx(150.0)
    assert spec.reader("mapping_ms.live")(ctx) == pytest.approx(150.0)
    assert spec.reader("captures_in_window")(ctx) == 1
    assert spec.reader("device_idle_pct")(ctx) == pytest.approx(75.0)
    assert spec.reader("fast_detect_roofline")(ctx) == pytest.approx(100 * 1e-3 / 0.9)
    assert spec.reader("orb_describe_roofline")(ctx) == pytest.approx(100 * 1e-3 / 0.2)


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = {"timers": {}, "frame_path": [], "mapping_ms": [], "captures": 0, "chunk_scans": []}
    ctx = run.Context(empty, empty, trace.Trace([]), 1.0, 0.0, lambda kind: 1e-3)
    for name in ("chunk_frame_ms", "working_ms.live", "mapping_ms.batch",
                 "fast_detect_roofline", "orb_describe_roofline"):
        assert spec.reader(name)(ctx) is None
