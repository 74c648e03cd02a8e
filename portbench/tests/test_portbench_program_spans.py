"""The program's spans on the trace's clock (``program_spans``) and the
per-layer readers of them, on a synthetic log and trace whose clocks are
5.000025 s apart."""

from collections import namedtuple

import pytest

from portbench import program_spans, run, spec, trace

Rec = namedtuple("Rec", "name thread start_ns end_ns parent ids")
OFFSET = 5.000025
READERS = ("mapping_points_ms", "mapping_ba_ms", "mapping_kf_cull_ms", "mapping_ba_idle_pct",
           "loop_insert_ms")


def _log():
    """Two passes (1.0-1.3 s, 2.0-2.25 s) with their stages, and two
    insertions, on the program's clock."""
    out = []

    def add(name, t0, t1, kf):
        out.append(Rec(name, "MainThread", round(t0 * 1e9), round(t1 * 1e9), -1, {"kf": kf}))

    for kf, (t0, edges) in enumerate([(1.0, [0.01, 0.02, 0.06, 0.08, 0.12, 0.28, 0.30]),
                                      (2.0, [0.01, 0.02, 0.04, 0.06, 0.10, 0.20, 0.25])]):
        add("local_mapping.pass", t0, t0 + edges[-1], kf)
        prev = 0.0
        for stage, e in zip(["point_stats", "cull_points", "new_points", "cross_camera",
                             "fuse", "ba", "cull_keyframes"], edges):
            add("local_mapping." + stage, t0 + prev, t0 + e, kf)
            prev = e
        add("loop_closing.insert", t0 + edges[-1], t0 + edges[-1] + (0.04, 0.02)[kf], kf)
    return out


def _trace(passes=((1.0, 1.3, 2e-5, 3e-5), (2.0, 2.25, 3e-5, 4e-5))):
    """The benchmark's pass spans (the program's moved by 5 s and a few
    microseconds) and three kernels, one across the first BA's start."""
    us = lambda s: s * 1e6
    ev = lambda name, t0, t1, cat: {"ph": "X", "cat": cat, "name": name, "ts": us(t0),
                                    "dur": us(t1 - t0)}
    events = [ev(trace.SPAN + "local_mapping.pass", a + 5 + da, b + 5 + db, "user_annotation")
              for a, b, da, db in passes]
    events += [ev("k", 6.11, 6.13, "kernel"), ev("k", 6.15, 6.20, "kernel"),
               ev("Memcpy HtoD", 7.12, 7.15, "gpu_memcpy")]
    return trace.Trace(events)


def _ctx(tr):
    empty = {"timers": {}, "frame_path": [], "mapping_ms": [], "captures": 0, "chunk_scans": []}
    return run.Context(empty, empty, tr, 10.0, 0.0, lambda kind: 0.0)


def test_the_alignment_recovers_the_offset():
    offset, residual = program_spans.alignment(_log(), _trace())
    assert offset == pytest.approx(OFFSET, abs=1e-9)
    assert residual == pytest.approx(1.5e-5, abs=1e-9)


def test_the_readers_give_the_hand_computed_values(monkeypatch):
    monkeypatch.setattr(program_spans, "records", _log)
    got = {name: spec.reader(name)(_ctx(_trace())) for name in READERS}
    # the BA spans on the trace's clock: 6.120025-6.280025 and 7.100025-7.200025;
    # busy inside them: 6.120025-6.13, 6.15-6.20 and 7.12-7.15
    busy = (6.13 - 6.120025) + 0.05 + 0.03
    assert got == pytest.approx({
        "mapping_points_ms": (120 + 100) / 2, "mapping_ba_ms": (160 + 100) / 2,
        "mapping_kf_cull_ms": (20 + 50) / 2, "mapping_ba_idle_pct": 100 * (1 - busy / 0.26),
        "loop_insert_ms": (40 + 20) / 2})


@pytest.mark.parametrize("passes", [
    ((1.0, 1.3, 2e-5, 3e-5),),                                  # a pass the program lacks
    ((1.0, 1.3, 2e-5, 3e-5), (2.0, 2.25, 3e-5, 2.6e-4)),        # an end 0.235 ms off
    ((1.0, 1.3, 2e-5, 3e-5), (2.0, 2.25, 5e-4, 4e-5)),          # a start 0.5 ms off
])
def test_a_count_mismatch_or_a_residual_over_the_tolerance_gives_nothing(monkeypatch, passes):
    monkeypatch.setattr(program_spans, "records", _log)
    tr = _trace(passes)
    assert program_spans.alignment(_log(), tr) is None
    assert spec.reader("mapping_ba_idle_pct")(_ctx(tr)) is None


def test_a_program_without_spans_gives_nothing(monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: None)
    for name in READERS:
        assert spec.reader(name)(_ctx(_trace())) is None


def test_the_program_records_nothing_outside_a_profile():
    from multicol_slam_tpu_torch.utils import timing
    timing.clear_spans()
    with timing.span("local_mapping.pass", kf=0):
        pass
    assert program_spans.records() == []
