"""The port's bench (``multicol_slam_tpu_torch/bench.py``) on the CPU, at
its ``--small`` size: the whole bench ends with one JSON line in
``bench.py``'s form (``metric``, ``value``, ``unit``, ``vs_baseline``,
``extra``) whose ``extra`` carries every stage's block with its keys; the
headline times the tracker's own scan body through
``working_scan_chunk``; a scan that loses tracking raises (no
fallback); without a card the bench refuses to run unless given
``--device cpu``. No JAX (``tests/test_torch_isolation.py`` imports the
module with the rest of the port)."""

import contextlib
import io
import json
import sys

import pytest
import torch

from multicol_slam_tpu_torch import bench
from multicol_slam_tpu_torch.models import tracking

SYSTEM_KEYS = {"frames", "chunk", "system_fps", "frame_ms", "working_frac",
               "working_frac_eval", "ate_m", "n_keyframes", "n_points", "mapping_ms",
               "mapping_passes", "keyframes_refused", "passes_interrupted", "frame_paths",
               "graphs", "pools_mib", "stage_s",
               # the slowest pass's split, the card's idle share and the
               # run's captures (the async mapper's capture stall)
               "slowest_pass_split_ms", "device_idle_share", "utilization_samples",
               "captures"}
STAGE_KEYS = {
    "headline": {"scan_frames", "reps", "scan_ms", "ms_per_frame", "inliers_median",
                 "map_keyframes", "map_points", "local_map_bucket", "scan_body", "stage_s"},
    "full_system": SYSTEM_KEYS,
    "full_system_chunked": SYSTEM_KEYS | {"chunk_scan"},
    "extraction_rate": {"mkeypoints_per_sec", "kps_per_frame", "ms_per_frame", "frames",
                        "reps", "stage_s"},
    "ba_rate": {"iters_per_sec", "iter_ms", "n_obs", "shape", "reps", "stage_s"},
    "chi2_parity": {"ba_chi2_ratio", "ba_chi2_final", "n_obs", "stage_s"},
    "eight_cam": {"fps", "ms_per_frame", "cams", "frames", "reps", "inliers_median",
                  "stage_s"},
    "dynamic_scene": {"frames", "working_frac", "ate_m", "n_culled", "false_loop", "stage_s"},
    "mdbrief": {"fps", "ms_per_frame", "cams", "frames", "reps", "inliers_median",
                "stage_s"},
    "cpu_compare": {"device_ms", "cpu_ms", "speedup_vs_cpu", "cpu_threads", "frames",
                    "stage_s"},
}


@pytest.fixture(scope="module")
def small_run():
    """(the last JSON line of ``main(["--device", "cpu", "--small"])``, the
    body passed to every ``working_scan_chunk`` call, the systems made)."""
    torch.set_num_threads(4)
    bodies, systems = [], []
    scan, make = tracking.working_scan_chunk, bench.make_system

    def spy_scan(*a, **k):
        bodies.append(k.get("body"))
        return scan(*a, **k)

    def spy_make(dev, **kw):
        systems.append(make(dev, **kw))
        return systems[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(tracking, "working_scan_chunk", spy_scan)
    mp.setattr(bench, "make_system", spy_make)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            bench.main(["--device", "cpu", "--small"])
    finally:
        mp.undo()
    return json.loads(out.getvalue().strip().splitlines()[-1]), bodies, systems


def test_the_last_line_has_the_bench_form(small_run):
    line, _, _ = small_run
    assert line["metric"] == "3cam_tracking_fps" and line["unit"] == "frames/sec"
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(line["value"] / 25.0)
    extra = line["extra"]
    assert extra["device"] == "cpu"
    for stage, keys in STAGE_KEYS.items():
        assert set(extra[stage]) == keys, (stage, set(extra[stage]) ^ keys)
    assert set(extra["chi2_parity"]) and extra["chi2_parity"]["ba_chi2_ratio"] < 1.01
    assert extra["eight_cam"]["cams"] == 8 and extra["mdbrief"]["cams"] == 3
    assert {"captures", "capture_s", "replays", "graphs_held", "pools_mib",
            "by_fn"} <= set(extra["graphs"])
    assert {"hamming_nn", "hamming_nn_radius"} <= set(extra["kernel_launches"])
    assert extra["bench_s"] > 0


def test_the_headline_times_the_trackers_own_scan_body(small_run):
    line, bodies, systems = small_run
    assert line["extra"]["headline"]["scan_body"] == "working_scan_body"
    assert bodies and all(any(b is s.tracker._scan_body for s in systems) for b in bodies)
    assert all(b is tracking.working_scan_body for b in bodies)      # eager on the CPU


def test_a_scan_that_loses_tracking_raises(monkeypatch):
    """The headline's scan (the bench's own ``scan``, not the tracker's
    chunks while the map is built) made to lose every inlier: the stage
    raises, and nothing stands in for it."""
    scan = tracking.working_scan_chunk

    def lost(*a, **k):
        carry, ys = scan(*a, **k)
        if sys._getframe(1).f_code.co_name == "scan":
            ys = dict(ys, n_in2=torch.zeros_like(ys["n_in2"]))
        return carry, ys

    monkeypatch.setattr(tracking, "working_scan_chunk", lost)
    with pytest.raises(RuntimeError, match="lost tracking"):
        bench.production_tracker(torch.device("cpu"), **bench.SIZES["small"]["headline"])


def test_the_bench_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])
