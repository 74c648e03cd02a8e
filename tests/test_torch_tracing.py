"""The port's spans (``multicol_slam_tpu_torch/utils/timing.py``) on the CPU.

Off (no ``torch.profiler`` profile running) a span records nothing while
``StageTimers`` keeps its durations. Under the profiler a span records its
name, thread, times, parent and ids, and opens a ``record_function`` range
of the same name. The system run bootstraps ``MultiColSLAM`` on frames
0-8 of ``bench_trajectory`` (two mapping passes) with no profile running,
then tracks frame 9 and runs one more mapping pass of the newest keyframe
under the profiler.
"""

import json
import threading

import pytest
import torch

from multicol_slam_tpu_torch.models import system as tsys
from multicol_slam_tpu_torch.utils import timing

import _torchutil as U

BOOTSTRAP = 9        # frames 0-8: the bootstrap at frame 8 maps keyframes 0 and 1
PASS_STAGES = ["point_stats", "cull_points", "new_points", "cross_camera", "fuse", "ba",
               "cull_keyframes"]
BA_STAGES = ["ba.assemble", "ba.solve", "ba.apply"]


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    _, frames = U.bench_frames(BOOTSTRAP + 1)
    timing.clear_spans()
    slam = tsys.MultiColSLAM(rig=U.full_torch_rig(), device="cpu")
    try:
        for i in range(BOOTSTRAP):
            slam.track(frames[i], i / 25.0)
        off = dict(spans=timing.spans(), passes=len(slam.mapping_ms),
                   timers={k: len(v) for k, v in slam.tracker.timers.samples.items()})
        kf = slam.tracker.last_kf_id
        with _profile() as prof:
            slam.track(frames[BOOTSTRAP], BOOTSTRAP / 25.0)
            slam.mapper.process_keyframe(kf)
        on = timing.spans()
    finally:
        timing.clear_spans()
        slam.shutdown()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return dict(off=off, on=on, kf=kf, events=events)


def _only(records, name):
    found = [(i, r) for i, r in enumerate(records) if r.name == name]
    assert len(found) == 1, (name, len(found))
    return found[0]


def test_off_records_nothing_while_stage_timers_record(run):
    off = run["off"]
    assert off["passes"] == 2 and off["spans"] == []
    assert off["timers"].get("feature_extraction", 0) >= BOOTSTRAP


def test_the_pass_and_the_frame_are_recorded_with_their_ids(run):
    recs = run["on"]
    _, pass_ = _only(recs, "local_mapping.pass")
    assert pass_.ids == {"kf": run["kf"]} and pass_.parent == -1
    assert pass_.thread == threading.current_thread().name
    i, frame = _only(recs, "system.track")
    assert frame.ids == {"frame": BOOTSTRAP} and frame.parent == -1
    # the tracker's stages of the frame, through StageTimers, under it
    stages = [r for r in recs if r.name.startswith("tracker.") and r.parent == i]
    assert "tracker.feature_extraction" in {r.name for r in stages}
    assert all(r.end_ns >= r.start_ns >= 0 for r in recs)


@pytest.mark.parametrize("stage", PASS_STAGES + BA_STAGES)
def test_each_stage_is_a_child_of_the_pass(run, stage):
    recs = run["on"]
    parent_name = "local_mapping.ba" if stage.startswith("ba.") else "local_mapping.pass"
    p, parent = _only(recs, parent_name)
    _, rec = _only(recs, "local_mapping." + stage)
    assert rec.parent == p and rec.ids == {"kf": run["kf"]} and rec.thread == parent.thread
    assert parent.start_ns <= rec.start_ns <= rec.end_ns <= parent.end_ns


def test_the_children_cover_the_pass(run):
    recs = run["on"]
    p, pass_ = _only(recs, "local_mapping.pass")
    children = [r for r in recs if r.parent == p]
    assert sorted(r.name for r in children) == sorted("local_mapping." + s for s in PASS_STAGES)
    covered = sum(r.end_ns - r.start_ns for r in children)
    assert 0.9 * (pass_.end_ns - pass_.start_ns) <= covered <= pass_.end_ns - pass_.start_ns


def test_the_profilers_events_hold_the_same_names(run):
    names = {e["name"] for e in run["events"] if e.get("cat") == "user_annotation"}
    assert {r.name for r in run["on"]} <= names


def test_off_a_span_is_one_shared_no_op():
    timing.clear_spans()
    a, b = timing.span("a"), timing.span("b", kf=1)
    assert a is b
    with a:
        pass
    assert timing.spans() == []


def test_parents_are_the_innermost_open_span_of_the_same_thread():
    timing.clear_spans()

    def worker():
        with timing.span("worker.outer"):
            with timing.span("worker.inner", frame=3):
                pass

    try:
        with _profile():
            with timing.span("main.outer", kf=1):
                t = threading.Thread(target=worker, name="tracing-worker")
                t.start()
                t.join()
                with timing.span("main.inner"):
                    pass
        recs = timing.spans()
    finally:
        timing.clear_spans()
    by = {r.name: (i, r) for i, r in enumerate(recs)}
    assert by["main.outer"][1].parent == -1 and by["worker.outer"][1].parent == -1
    assert by["main.inner"][1].parent == by["main.outer"][0]
    assert by["worker.inner"][1].parent == by["worker.outer"][0]
    assert by["worker.inner"][1].thread == "tracing-worker"
    assert by["worker.inner"][1].ids == {"frame": 3}
    assert by["main.outer"][1].ids == {"kf": 1}


def test_stage_timers_open_the_tracker_span():
    timing.clear_spans()
    timers = timing.StageTimers()
    try:
        with timers.time("quiet"):
            pass
        with _profile():
            with timers.time("traced"):
                pass
        recs = timing.spans()
    finally:
        timing.clear_spans()
    assert [r.name for r in recs] == ["tracker.traced"]
    assert {k: len(v) for k, v in timers.samples.items()} == {"quiet": 1, "traced": 1}
