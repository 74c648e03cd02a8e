"""The stretch configuration's eight-camera surround rig in the port,
against the JAX package (the counterpart of tests/test_eight_camera.py,
whose fixture loads the absent Lafida calibration): eight copies of the
in-repo rig's camera 0 on a 0.3 m ring, yawed 45 degrees apart about y,
built by both packages from the same numpy arrays.

Bars, with what was measured on the CPU:
  - the ring: ``M_c`` and every camera field equal in both packages;
  - the six rig helpers against their JAX counterparts in float64 within
    1e-9 relative (measured at most 8.5e-15), the z > 0 flags equal, and
    the ring sees almost every direction (each of 64 points in front of
    some camera: at least 90%);
  - extraction, matching and the pose LM at full width (8 x 754x480,
    120 features, 3 levels; tests/test_eight_camera.py's
    ``test_extraction_and_tracking_8cam``): identical keypoints, levels,
    validity and descriptors, identical frame-to-frame matches, more than
    8 x 25 of them (measured 465), the float32 pose within 1 cm of
    ground truth (measured 1.3 mm) and within 1e-5 of the JAX package's
    (measured 5.8e-8), the same inlier count, more than 60% of the
    matches (measured 432 of 465);
  - the system on the ring (``MultiColSLAM`` with loop closing off, 8 x
    377x240, 250 features, 3 levels, tests/test_eight_camera.py's room and
    tour) over frames 0-4, through the bootstrap and one WORKING frame: both packages
    initialize on the same frame with the same leading camera (the port's
    RANSAC draws the JAX package's minimal sets), the same frame paths
    and keyframes, every returned pose within 5 mm and 0.1 degree of the
    JAX package's (measured 0.33 mm, 0.0025 degree; init on frame 3
    from the pair (2, 3), leading camera 1), map points within 3%.
    Frames 0-4 take about 45 s of the file's 70 s here.
The whole tour (26 frames) runs at full width on the card
(``chip_smoke.py`` phase 12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.models import extractor as jext
from multicol_slam_tpu.models import initializer as jinit
from multicol_slam_tpu.models import matcher as jmatch
from multicol_slam_tpu.models import optimizer as jopt
from multicol_slam_tpu.models import system as jsys
from multicol_slam_tpu.models.tracking import project_slots as j_project_slots
from multicol_slam_tpu.ops import camera as jcam
from multicol_slam_tpu.ops import rig as jrig
from multicol_slam_tpu.utils import config_io as jcio
from multicol_slam_tpu_torch.models import extractor as text
from multicol_slam_tpu_torch.models import initializer as tinit
from multicol_slam_tpu_torch.models import matcher as tmatch
from multicol_slam_tpu_torch.models import optimizer as topt
from multicol_slam_tpu_torch.models import system as tsys
from multicol_slam_tpu_torch.models.tracking import project_slots as t_project_slots
from multicol_slam_tpu_torch.ops import camera as tcam
from multicol_slam_tpu_torch.ops import geometry as tgeo
from multicol_slam_tpu_torch.ops import ransac as tr
from multicol_slam_tpu_torch.ops import rig as trig
from multicol_slam_tpu_torch.utils import config_io as tcio
from multicol_slam_tpu_torch.utils import synthetic as tsyn

import _torchutil as U

N_CAMS = 8
SYS_LAST = 4        # the system runs frames 0..SYS_LAST (init at frame 3)
DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}


def ring_cayley(np_dt=np.float32):
    """(8, 6) minimal extrinsics of tests/test_eight_camera.py's ring."""
    mc = np.zeros((N_CAMS, 6))
    for c in range(N_CAMS):
        ang = 2 * np.pi * c / N_CAMS
        mc[c, 1] = np.tan(ang / 2.0)
        mc[c, 3] = 0.3 * np.sin(ang)
        mc[c, 5] = 0.3 * np.cos(ang)
    return mc.astype(np_dt)


def rings(np_dt=np.float32):
    """(JAX ring, port ring) from the same numpy arrays."""
    t_dt = DTYPES["f64" if np_dt == np.float64 else "f32"][1]
    mc = ring_cayley(np_dt)
    jbase, _ = jcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=np_dt)
    j = jrig.rig_from_cayley(mc, jcam.stack_cameras(
        [jax.tree.map(lambda x: x[0], jbase.cams)] * N_CAMS))
    tbase, _ = tcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=t_dt)
    t = trig.rig_from_cayley(torch.from_numpy(mc), tcam.stack_cameras(
        [tbase.cams.index(0)] * N_CAMS))
    return j, t


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_ring_matches_jax(dt):
    j, t = rings(DTYPES[dt][0])
    assert t.n_cams == N_CAMS and t.M_c.dtype == DTYPES[dt][1]
    np.testing.assert_array_equal(t.M_c.numpy(), np.asarray(j.M_c))
    for f in tcam.CameraModel._fields:
        np.testing.assert_array_equal(getattr(t.cams, f).numpy(), np.asarray(getattr(j.cams, f)),
                                      err_msg=f)
    # 45 degrees apart about y on a 0.3 m ring, every camera looking outwards
    np.testing.assert_allclose(t.M_c[:, :3, 3].norm(dim=-1).numpy(), 0.3, rtol=1e-6)
    axes = t.M_c[:, :3, 2].numpy()
    np.testing.assert_allclose((axes * np.roll(axes, -1, 0)).sum(-1), np.cos(np.pi / 4),
                               rtol=1e-6)


HELPERS = ["world_to_cam_frame", "world_to_img_rig", "img_to_world_rig", "rays_to_body",
           "cam_centers_world", "make_rig"]


@pytest.mark.parametrize("name", HELPERS)
def test_rig_helper_matches_jax(name):
    j, t = rings(np.float64)
    jj = jax.tree.map(jnp.asarray, j)
    rng = np.random.default_rng(0)
    M_t = tgeo.cayley2hom(torch.from_numpy(np.r_[rng.normal(0, 0.1, 3), rng.normal(0, 0.5, 3)]))
    jM = jnp.asarray(M_t.numpy())
    X = rng.standard_normal((64, 3)) * 3
    uv = rng.uniform([50, 50], [700, 430], (N_CAMS, 5, 7, 2))
    rays = rng.standard_normal((N_CAMS, 40, 3))
    if name == "world_to_cam_frame":
        pairs = [(trig.world_to_cam_frame(M_t, t.M_c, torch.from_numpy(X.reshape(4, 16, 3))),
                  jrig.world_to_cam_frame(jM, jj.M_c, X.reshape(4, 16, 3)))]
    elif name == "world_to_img_rig":
        (uv_t, ok_t), (uv_j, ok_j) = (trig.world_to_img_rig(t, M_t, torch.from_numpy(X)),
                                      jrig.world_to_img_rig(jj, jM, X))
        assert uv_t.shape == (N_CAMS, 64, 2)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        # tests/test_eight_camera.py::test_rig_projection_roundtrip: a
        # surround ring has almost every point in front of some camera
        assert ok_t.numpy().any(0).mean() > 0.9
        pairs = [(uv_t, uv_j)]
    elif name == "img_to_world_rig":
        pairs = [(trig.img_to_world_rig(t, torch.from_numpy(uv)), jrig.img_to_world_rig(jj, uv))]
    elif name == "rays_to_body":
        pairs = [(trig.rays_to_body(t, torch.from_numpy(rays)), jrig.rays_to_body(jj, rays))]
    elif name == "cam_centers_world":
        pairs = [(trig.cam_centers_world(M_t, t.M_c), jrig.cam_centers_world(jM, jj.M_c))]
    else:
        cams_t = [t.cams.index(c) for c in range(N_CAMS)]
        cams_j = [jax.tree.map(lambda a: a[c], j.cams) for c in range(N_CAMS)]
        mt = trig.make_rig([t.M_c[c] for c in range(N_CAMS)], cams_t)
        mj = jrig.make_rig([j.M_c[c] for c in range(N_CAMS)], cams_j)
        pairs = [(mt.M_c, mj.M_c)] + [(getattr(mt.cams, f), getattr(mj.cams, f))
                                      for f in tcam.CameraModel._fields]
    for a, b in pairs:
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def extraction():
    """Both packages' extractors (120 features, 3 levels) on the full-width
    ring's frames at the origin and at tests/test_eight_camera.py's small
    step, rendered once by the port as uint8."""
    j, t = rings()
    u0, v0 = float(t.cams.u0[0]), float(t.cams.v0[0])
    masks = [np.stack([tcam.make_extraction_masks(u0, v0, 754, 480, 3, 1.2)[lvl]] * N_CAMS)
             for lvl in range(3)]
    gt1 = np.eye(4)
    gt1[:3, 3] = [0.04, 0.01, 0.02]
    render = tsyn.make_renderer(t)
    imgs = torch.round(render(torch.tensor(np.stack([np.eye(4), gt1]),
                                           dtype=torch.float32))).to(torch.uint8)
    assert imgs.shape == (2, N_CAMS, 480, 754)
    tx = text.make_extractor(text.ExtractorConfig(n_features=120, n_levels=3), t.cams,
                             masks, (480, 754))
    with U.f32():
        jx = jext.make_extractor(jext.ExtractorConfig(n_features=120, n_levels=3), j.cams,
                                 masks, (480, 754))
        jf = [jx(jnp.asarray(imgs[i].numpy())) for i in range(2)]
        jf = [jax.tree.map(np.asarray, f) for f in jf]
    tf = [tx(imgs[i]) for i in range(2)]
    return j, t, jf, tf, gt1


def test_extraction_and_tracking_8cam(extraction):
    j, t, jf, tf, gt1 = extraction
    for a, b in zip(tf, jf):
        assert a.xy.shape == (N_CAMS, 120, 2)
        for f in ("xy", "level", "valid"):
            np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f), err_msg=f)
        np.testing.assert_array_equal(a.desc.numpy().view(np.uint32), b.desc)
    assert int(tf[0].valid.sum()) > N_CAMS * 60

    # the first frame's rays to the room's walls: ground-truth points for
    # each slot, projected into the second frame by the per-slot projection
    T = trig.mt_mc(torch.eye(4), t.M_c)
    rays_w = torch.einsum("nij,nkj->nki", T[:, :3, :3], tf[0].ray)
    dist = tsyn._ray_box_exit(T[:, None, :3, 3], rays_w)
    pts = T[:, None, :3, 3] + dist[..., None] * rays_w
    uv_pred, ok = t_project_slots(t, torch.zeros(6), pts)
    m = tmatch.match_frame_to_frame(tf[1], tf[0], tf[0].valid, torch.zeros_like(tf[1].valid),
                                    uv_pred, ok, tmatch.MatchParams(desc_bytes=32), th=15.0)
    with U.f32():
        juv, jok = j_project_slots(jax.tree.map(jnp.asarray, j), jnp.zeros(6),
                                   jnp.asarray(pts.numpy()))
        np.testing.assert_allclose(uv_pred.numpy(), np.asarray(juv), rtol=0, atol=1e-3)
        jm = jmatch.match_frame_to_frame(
            U.jax_features(tf[1]), U.jax_features(tf[0]), jnp.asarray(tf[0].valid.numpy()),
            jnp.zeros((N_CAMS, 120), bool), juv, jok, jmatch.MatchParams(desc_bytes=32),
            th=15.0)
    m = m.numpy()
    np.testing.assert_array_equal(m, np.asarray(jm))
    n_match = int((m >= 0).sum())
    assert n_match > N_CAMS * 25, f"only {n_match} matches on the ring rig"

    # the pose LM over the matches, both packages in float32
    cam, slot = np.nonzero(m >= 0)
    K = len(cam)
    xy1 = tf[1].xy.numpy()
    uv = xy1[cam, m[cam, slot]]
    X = pts.numpy()[cam, slot]
    arrays = dict(uv=uv, kf=np.zeros(K, np.int32), cam=cam.astype(np.int32),
                  pt=np.arange(K, dtype=np.int32), inv_sigma2=np.ones(K, np.float32),
                  valid=np.ones(K, bool))
    mt, inl, n_in, _ = topt.pose_optimization(
        t, torch.zeros(6), topt.BAObservations(**{k: torch.from_numpy(v) for k, v in
                                                   arrays.items()}), torch.from_numpy(X))
    with U.f32():
        jmt, _, jn, _ = jopt.pose_optimization(
            jax.tree.map(jnp.asarray, j), jnp.zeros(6, jnp.float32),
            jopt.BAObservations(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            jnp.asarray(X))
    M_est = tgeo.cayley2hom(mt.double()).numpy()
    np.testing.assert_allclose(M_est[:3, 3], gt1[:3, 3], atol=0.01)
    np.testing.assert_allclose(mt.numpy(), np.asarray(jmt), rtol=0, atol=1e-5)
    assert int(n_in) == int(jn) and int(n_in) > 0.6 * K


def _tour():
    """tests/test_eight_camera.py's tour: 10 lateral frames at 0.08 m, then
    a 17-frame arc of radius 0.6 from the last of them (26 poses)."""
    lat = tsyn.lateral_trajectory(10, step=0.08, yaw_rate=0.0)
    arc = tsyn.smooth_trajectory(17, radius=0.6)
    return np.concatenate([lat, np.einsum("ij,njk->nik", lat[-1], arc[1:])])


def test_system_on_the_ring_matches_jax(monkeypatch):
    j, t = rings()
    j, t = jrig.scale_rig(j, 0.5), trig.scale_rig(t, 0.5)
    gt = _tour()[:SYS_LAST + 1]
    render = tsyn.make_renderer(t, room_half=2.5)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32))).to(torch.uint8)
    leads = {"jax": [], "port": []}
    for mod, key in ((jinit, "jax"), (tinit, "port")):
        f = mod.pick_leading_camera
        monkeypatch.setattr(mod, "pick_leading_camera",
                            lambda cand, rig, _f=f, _k=key: _record(leads[_k], _f(cand, rig)))
    monkeypatch.setattr(tr, "sample_minimal_sets", U.JaxMinimalSets(n_cams=N_CAMS))
    kw = dict(capacity_pts=20000, capacity_kfs=64, enable_loop_closing=False)

    port = tsys.MultiColSLAM(settings=tcio.SlamSettings(n_features=250, n_levels=3, fps=8.0),
                             rig=t, **kw)
    assert port.device.type == "cpu" and port.rig.n_cams == N_CAMS
    p_poses = [port.track(frames[i], i / 8.0) for i in range(len(gt))]
    with U.f32():
        jslam = jsys.MultiColSLAM(settings=jcio.SlamSettings(n_features=250, n_levels=3,
                                                             fps=8.0), rig=j, **kw)
        j_poses = [jslam.track(jnp.asarray(frames[i].numpy()), i / 8.0) for i in range(len(gt))]
        j_poses = [None if M is None else np.asarray(M, np.float64) for M in j_poses]
        jslam.shutdown()
    port.shutdown()

    assert leads["port"] and leads["port"][0][0] == leads["jax"][0][0]
    assert port.tracker.frame_path == jslam.tracker.frame_path
    tracked = [i for i, M in enumerate(p_poses) if M is not None]
    assert tracked and tracked == [i for i, M in enumerate(j_poses) if M is not None]
    assert tracked[0] < SYS_LAST, "the ring did not bootstrap"
    kf_frames = lambda m: sorted(m.kf_frame_id[m.keyframe_ids()].tolist())
    assert kf_frames(port.map) == kf_frames(jslam.map)
    worst = max(U.pose_error_hom(np.asarray(p_poses[i], np.float64), j_poses[i])
                for i in tracked)
    assert worst[0] < 5e-3 and worst[1] < 0.1, worst
    n_p, n_j = port.map.n_points(), jslam.map.n_points()
    assert abs(n_p - n_j) <= 0.03 * n_j, (n_p, n_j)


def _record(out, res):
    if res is not None:
        out.append(res)
    return res
