"""The reference at a small size: the frozen plain extraction chain equals
the program's extraction, the pose and landmark arithmetic reads 0 on
exact answers, and the judge fails a number past its limit."""

import numpy as np
import pytest
import torch

from portbench import run, spec, world
from portbench.reference import extract as rx
from portbench.reference import trajectory, work


@pytest.fixture(scope="module", params=["lafida3_orb", "lafida3_mdbrief"])
def setup(request):
    cfg_dir = spec.load_config(request.param, f"{spec.HERE}/configs/{request.param}/config.json")
    rig = world.Rig(cfg_dir.dir, "cpu")
    lat = world.lattice(3, "cpu")
    M = torch.eye(4)[None]
    img = torch.round(world.make_renderer(rig, lat)(M)).to(torch.uint8)[0]
    cfg = rx.config_from_settings(world.load_opencv_yaml(cfg_dir.settings_path))
    masks = rx.extraction_masks(rig.cams, cfg)
    return cfg_dir, rig, img, cfg, masks, rx.make_plain_extractor(cfg, rig.cams, masks)


def test_reference_equals_the_programs_extraction(setup):
    """On the CPU the program's extractor takes its kernels' plain
    versions, which the card holds equal to the kernels."""
    from multicol_slam_tpu_torch.models.system import MultiColSLAM

    cfg_dir, rig, img, cfg, masks, plain = setup
    slam = MultiColSLAM(calib_dir=cfg_dir.dir, settings_path=cfg_dir.settings_path,
                        device="cpu", enable_loop_closing=False)
    got = slam._extract_padded(img)
    want = plain(img)
    assert all(v == 0 for v in rx.mismatches(got, want).values())
    assert int(want.valid.sum()) > 0.9 * want.valid.numel()


def test_a_flipped_bit_is_a_mismatch(setup):
    *_, plain = setup
    f = plain(setup[2])
    bad = f._replace(desc=f.desc ^ torch.tensor(4, dtype=torch.int32))
    assert rx.mismatches(bad, f)["desc"] == f.desc.numel()


def test_work_counts_are_positive_and_bounded(setup):
    _, _, img, cfg, masks, plain = setup
    mt = [torch.from_numpy(m > 0) for m in masks]
    db, do = work.detect_frame(plain, cfg, mt, img)
    sb, so = work.describe_frame(plain, cfg, plain(img))
    assert db > 3 * 754 * 480 * 5 * 0.9 and do > 0 and sb > 0 and so > 0
    # both bounds under 50 us a frame: the kernels' measured 10-90 us are above them
    assert 0 < work.least_seconds(db, do) < 50e-6 and 0 < work.least_seconds(sb, so) < 50e-6


def test_pose_errors_vanish_under_a_similarity():
    rng = np.random.default_rng(0)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = rng.normal(size=(20, 3))
    ang = rng.uniform(0, 2 * np.pi, 20)
    gt[:, 0, 0], gt[:, 0, 2], gt[:, 2, 0], gt[:, 2, 2] = (np.cos(ang), np.sin(ang),
                                                          -np.sin(ang), np.cos(ang))
    S = np.eye(4)
    S[:3, :3] = world.cayley2hom(np.array([0.1, -0.2, 0.3, 0, 0, 0]))[:3, :3]
    S[:3, 3] = [1.0, 2.0, -0.5]
    est = np.einsum("ij,njk->nik", S, gt)
    est[:, :3, 3] *= 0.7
    e = trajectory.pose_errors(est, gt)
    assert e["pos_m"].max() < 1e-9 and e["rot_deg"].max() < 1e-5
    est[5, :3, 3] += 0.7 * 0.1
    e = trajectory.pose_errors(est, gt)
    assert e["pos_m"][5] > 0.05


def test_judge_fails_past_a_limit_and_on_a_missing_number():
    lim = {"a": {"max": 0}, "b": {"max": 2.0}}
    assert run.judge(lim, {"a": 0, "b": 2.0})[0]
    assert not run.judge(lim, {"a": 1, "b": 0.0})[0]
    assert not run.judge(lim, {"a": 0})[0]
