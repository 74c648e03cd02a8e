"""The tools to view a run and the command line, on the port:

- the viewer (utils/viz.py, the cViewer / cMapPublisher /
  cMultiFramePublisher equivalents) on a port system: ``refresh`` draws
  ``live_map.png`` and ``live_frame.png`` from copies with no failure,
  ``attach_viewer`` runs the loop beside ``track`` and ``shutdown`` stops
  it, and a drawing without matplotlib raises and says so;
- the command line (``python -m multicol_slam_tpu_torch.cli``, the
  counterpart of tools/run_slam.py) on the CPU: 16 synthetic frames at
  the in-repo rig's full width with async mapping, the trajectory,
  ``map.npz`` and ``map.png`` written, the ATE printed, the map loading
  back, and the written trajectory scored by
  ``python -m multicol_slam_tpu_torch.evaluate`` against the ground truth
  to the ATE the command line printed;
- the Lafida reader on a small dataset written here.

The map drawn is the JAX package's map of the organic loop episode
(tests/data/organic_loop_jax_map.npz), loaded into a port system.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch import cli
from multicol_slam_tpu_torch.models.system import MultiColSLAM
from multicol_slam_tpu_torch.utils import checkpoint, config_io, synthetic, viz
from multicol_slam_tpu_torch.utils.trajectory import save_tum

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "organic_loop_jax_map.npz")
N_CLI = 16


@pytest.fixture(scope="module")
def system():
    """A port system on the CPU holding the fixture's map, its tracker
    WORKING with a trajectory and the frame publisher's snapshot of one
    frame."""
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, device="cpu",
                        settings=config_io.SlamSettings(n_features=300, n_levels=4))
    slam.map, _ = checkpoint.load_map(FIXTURE, device="cpu")
    frame = synthetic.make_renderer(slam.rig)(torch.eye(4)).round().to(torch.uint8)
    feats = slam.extract(frame)
    cur_pt = np.full(tuple(feats.valid.shape), -1, np.int32)
    cur_pt[0, :50] = 1
    tr = slam.tracker
    tr.all_poses.extend(np.stack([np.eye(4)] * 3) + np.arange(3)[:, None, None] * 0.01)
    slam.last_frame = (frame, feats, cur_pt, "WORKING")
    return slam


def test_viewer_refresh_draws_from_copies(system, tmp_path):
    v = viz.Viewer(system, out_dir=str(tmp_path), period_s=60.0)
    assert system.keep_last_frame
    assert v.refresh() and v.refresh()
    assert (v.n_refreshes, v.n_failures) == (2, 0)
    for name in ("live_map.png", "live_frame.png"):
        assert os.path.getsize(tmp_path / name) > 10_000
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp.png")]
    view = viz.map_view(system.map)
    assert len(view["points"]) == system.map.n_points() > 1000
    assert len(view["poses"]) == system.map.n_keyframes() and view["edges"]
    view["points"][:] = 0          # a copy: the map is untouched
    assert np.abs(system.map.pt_pos[system.map.pt_valid]).sum() > 0


def test_viewer_counts_a_failed_refresh(system, tmp_path):
    v = viz.Viewer(system, out_dir=str(tmp_path / "missing" / "dir"), period_s=60.0)
    assert not v.refresh()
    assert (v.n_refreshes, v.n_failures) == (0, 1)


def test_attached_viewer_runs_beside_tracking(tmp_path):
    from multicol_slam_tpu_torch.ops.rig import scale_rig
    rig = scale_rig(config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0], 0.25)
    slam = MultiColSLAM(rig=rig, enable_loop_closing=False, async_mapping=True)
    render = synthetic.make_renderer(rig)
    v = slam.attach_viewer(str(tmp_path), period_s=0.05)
    try:
        for i in range(3):
            slam.track(render(torch.eye(4)).round().to(torch.uint8), i / 25.0)
        deadline = 200
        while v.n_refreshes < 2 and deadline:
            v._stop.wait(0.05)
            deadline -= 1
    finally:
        slam.shutdown()
    assert not v._thread.is_alive() and slam._viewer is None
    assert v.n_refreshes >= 2 and v.n_failures == 0
    assert slam.last_frame[3] == slam.state.name
    assert os.path.exists(tmp_path / "live_frame.png")


def test_drawing_without_matplotlib_says_so(system, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not viz.have_matplotlib()
    with pytest.raises(RuntimeError, match="matplotlib"):
        viz.draw_map(system.map, system.rig, path=str(tmp_path / "m.png"))


def test_cli_on_the_cpu(tmp_path):
    out_dir = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "multicol_slam_tpu_torch.cli", "--calib",
         config_io.SYNTH_RIG_DIR, "--synthetic", str(N_CLI), "--async-mapping",
         "--device", "cpu", "--out-dir", str(out_dir)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert res.returncode == 0, res.stderr
    ate = float(re.search(r"ATE RMSE vs ground truth: ([0-9.]+) m", res.stdout).group(1))
    assert ate < 0.05, res.stdout
    for name in ("MKFTrajectory.txt", "map.npz", "map.png"):
        assert os.path.getsize(out_dir / name) > 0
    m, _ = checkpoint.load_map(str(out_dir / "map.npz"), device="cpu")
    assert m.n_keyframes() >= 2 and m.n_points() > 100

    gt = cli.synthetic_trajectory(N_CLI)
    fps = config_io.SlamSettings().fps
    save_tum(str(tmp_path / "gt.txt"), np.arange(N_CLI) / fps, gt)
    ev = subprocess.run([sys.executable, "-m", "multicol_slam_tpu_torch.evaluate",
                         str(out_dir / "MKFTrajectory.txt"), str(tmp_path / "gt.txt")],
                        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert ev.returncode == 0, ev.stderr
    rec = json.loads(ev.stdout.strip().splitlines()[-1])
    n_tracked = len(np.loadtxt(out_dir / "MKFTrajectory.txt"))
    assert rec["n_associated"] == n_tracked > 3 and rec["n_gt"] == N_CLI
    # the trajectory file rounds to 1e-6: the same ATE as the run's
    assert abs(rec["ate_rmse_m"] - ate) < 1e-4, (rec, ate)


def test_lafida_reader(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 3, 12, 16), dtype=np.uint8)
    lines = []
    for t in range(2):
        names = []
        for c in range(3):
            name = f"cam{c}_{t}.png"
            Image.fromarray(imgs[t, c]).save(tmp_path / name)
            names.append(name)
        lines.append(f"{t / 25.0} " + " ".join(names))
    (tmp_path / "images_and_timestamps.txt").write_text("\n".join(lines) + "\n")
    got = list(cli.load_lafida(str(tmp_path), 1, -1))
    assert [ts for _, ts in got] == [0.0, 0.04]
    for t, (frame, _) in enumerate(got):
        assert frame.dtype == np.float32
        np.testing.assert_array_equal(frame, imgs[t].astype(np.float32))
    assert len(list(cli.load_lafida(str(tmp_path), 2, -1))) == 1
