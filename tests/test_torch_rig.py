"""The in-repo synthetic rig, calibration IO, camera model, rig and SE3
helpers of the port against the JAX package.

Both loaders read multicol_slam_tpu_torch/data/synth_rig3 (written by
tools/make_synth_rig.py) and must give the same rig. Geometry runs in
float64 (golden values); the comparison bound is 1e-9 relative.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.ops import camera as jcam
from multicol_slam_tpu.ops import geometry as jgeo
from multicol_slam_tpu.ops import rig as jrig
from multicol_slam_tpu.utils import config_io as jcio
from multicol_slam_tpu_torch.ops import camera as tcam
from multicol_slam_tpu_torch.ops import geometry as tgeo
from multicol_slam_tpu_torch.ops import rig as trig
from multicol_slam_tpu_torch.utils import config_io as tcio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}


def _same_rig(j, t, rtol=0.0):
    np.testing.assert_allclose(t.M_c.numpy(), np.asarray(j.M_c), rtol=rtol)
    for f in tcam.CameraModel._fields:
        np.testing.assert_allclose(getattr(t.cams, f).numpy(),
                                   np.asarray(getattr(j.cams, f)),
                                   rtol=rtol, err_msg=f)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_both_loaders_give_the_same_rig(dt):
    np_dt, t_dt = DTYPES[dt]
    j, j_masks = jcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=np_dt)
    t, t_masks = tcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=t_dt)
    assert t.M_c.dtype == t_dt and t.n_cams == 3
    _same_rig(j, t)
    assert len(j_masks) == len(t_masks)
    for a, b in zip(j_masks, t_masks):
        np.testing.assert_array_equal(a, b)
    for c in range(3):
        name = f"InteriorOrientationFisheye{c}.yaml"
        assert (tcio.load_opencv_yaml(os.path.join(tcio.SYNTH_RIG_DIR, name))
                == jcio.load_opencv_yaml(os.path.join(tcio.SYNTH_RIG_DIR, name)))
    # the rig as specified: 754x480, centred, 120 deg apart on a 10 cm ring
    np.testing.assert_allclose(t.cams.width.numpy(), 754)
    np.testing.assert_allclose(t.cams.height.numpy(), 480)
    np.testing.assert_allclose(t.cams.u0.numpy(), 377, atol=1)
    np.testing.assert_allclose(t.cams.v0.numpy(), 240, atol=1)
    assert (t.cams.poly[:, 0] < 0).all() and (t.cams.mirror == 1).all()
    np.testing.assert_allclose(t.M_c[:, :3, 3].norm(dim=-1).numpy(), 0.1,
                               rtol=1e-6)
    fwd = t.M_c[:, :3, 2].numpy()               # optical axes in the body
    cos = fwd @ fwd.T
    np.testing.assert_allclose(cos[np.triu_indices(3, 1)], -0.5, atol=1e-6)


def test_scale_rig_matches_jax():
    j, _ = jcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=np.float32)
    t, _ = tcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=torch.float32)
    _same_rig(jrig.scale_rig(j, 0.5), trig.scale_rig(t, 0.5))


def test_round_trip_inside_mask_under_005_px():
    """world_to_img(img_to_world(uv)) == uv to 0.05 px at every pixel
    inside the mirror mask (measured max 0.005 px), and the mask edge
    sits about 95 degrees off-axis."""
    rig, masks = tcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=torch.float32)
    h, w = 480, 754
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    uv = torch.stack([uu, vv], -1).reshape(-1, 2)
    inside = torch.from_numpy(masks[0].reshape(3, -1) > 0)
    rays = tcam.img_to_world(rig.cams.expand(1), uv[None])     # (3, HW, 3)
    back = tcam.world_to_img(rig.cams.expand(1), rays)
    err = (back - uv).norm(dim=-1)
    assert err[inside].max() < 0.05, err[inside].max()
    off_axis = torch.rad2deg(torch.acos(rays[..., 2].clamp(-1, 1)))
    assert 93.0 < off_axis[inside].max() < 97.0


def test_projection_matches_jax():
    rng = np.random.default_rng(0)
    j, _ = jcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=np.float64)
    t, _ = tcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=torch.float64)
    uv = rng.uniform([0, 0], [754, 480], (3, 500, 2))
    X = rng.normal(0, 2, (3, 500, 3))
    t_rays = tcam.img_to_world(t.cams.expand(1), torch.from_numpy(uv))
    t_px = tcam.world_to_img(t.cams.expand(1), torch.from_numpy(X))
    for c in range(3):
        cam = jax.tree.map(lambda a: jnp.asarray(a[c]), j.cams)
        np.testing.assert_allclose(t_rays[c].numpy(),
                                   np.asarray(jcam.img_to_world(cam, uv[c])),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(t_px[c].numpy(),
                                   np.asarray(jcam.world_to_img(cam, X[c])),
                                   rtol=1e-9)


def test_geometry_matches_jax():
    rng = np.random.default_rng(1)
    c6 = rng.normal(0, 0.3, (7, 6))
    t = torch.from_numpy(c6)
    M = tgeo.cayley2hom(t)
    pairs = [
        (tgeo.cayley2rot(t[:, :3]), jgeo.cayley2rot(c6[:, :3])),
        (M, jgeo.cayley2hom(c6)),
        (tgeo.hom2cayley(M), jgeo.hom2cayley(np.asarray(M))),
        (tgeo.rot2cayley(M[:, :3, :3]), jgeo.rot2cayley(np.asarray(M[:, :3, :3]))),
        (tgeo.inv_se3(M), jgeo.inv_se3(np.asarray(M))),
        (tgeo.inv3x3(M[:, :3, :3] + 0.5), jgeo.inv3x3(np.asarray(M[:, :3, :3]) + 0.5)),
        (tgeo.horner(t, t[:, :1] * 3), jgeo.horner(c6, c6[:, :1] * 3)),
        (trig.mt_mc(M[0], M[1:]), jrig.mt_mc(np.asarray(M[0]), np.asarray(M[1:]))),
    ]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-12, err_msg=str(i))
    np.testing.assert_allclose(tgeo.hom2cayley(M).numpy(), c6, rtol=1e-9)
    j, _ = jcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=np.float64)
    r, _ = tcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=torch.float64)
    np.testing.assert_allclose(r.M_c_min.numpy(), np.asarray(j.M_c_min),
                               rtol=1e-9, atol=1e-12)


def test_extraction_masks_and_settings_match_jax():
    for lvls, scale in [(8, 1.2), (4, 1.2)]:
        for u0, v0, w, h in [(376.8, 240.3, 754, 480), (188.4, 120.15, 377, 240)]:
            for a, b in zip(jcam.make_extraction_masks(u0, v0, w, h, lvls, scale),
                            tcam.make_extraction_masks(u0, v0, w, h, lvls, scale)):
                np.testing.assert_array_equal(a, b)
    assert (dataclasses.asdict(tcio.SlamSettings())
            == dataclasses.asdict(jcio.SlamSettings()))


def test_make_synth_rig_writes_the_committed_files(tmp_path):
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "make_synth_rig.py"),
                    str(tmp_path)], check=True)
    names = sorted(os.listdir(tcio.SYNTH_RIG_DIR))
    assert names == sorted(os.listdir(tmp_path))
    for name in names:
        with open(os.path.join(tcio.SYNTH_RIG_DIR, name)) as f, \
                open(os.path.join(tmp_path, name)) as g:
            assert f.read() == g.read(), name
