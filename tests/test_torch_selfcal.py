"""The port's self-calibrating MultiCol BA (free rig extrinsics) and its
intrinsics refinement against the JAX package, on the recipe of
tests/test_optimizer.py's TestSelfCalibration / TestIntrinsicsRefinement
with the in-repo rig at full width (754x480) in place of Lafida: points in
a 1.5-5 m shell seen from 4 keyframes (2 fixed) or 2, cameras 1 and 2
perturbed by that test's offsets, u0 +1.5 px and v0 -1.0 px.

Bars, with what was measured on the CPU:
  - ``to_vector17`` / ``with_vector17``: equal to the JAX package's bit
    for bit, the round trip exact, the source model's ``inv_poly`` not
    written;
  - the written-out pose, point, extrinsic and intrinsics Jacobians against
    ``torch.func.jacfwd`` and against the JAX package's ``jax.jacfwd`` of
    ``_project_residual``, in float64: within 1e-9 of the largest entry
    (measured at most 2.2e-15 against jacfwd, 1.8e-15 against JAX);
  - self-calibrating BA against the JAX package: float64 poses,
    extrinsics and points within 1e-9, chi2 within 1e-9 relative
    (measured 1.1e-16, 1.3e-16, 2.0e-11, 1.5e-14); float32 poses and
    extrinsics within 1e-5, the points seen at least twice within 1e-4 m,
    every observation's chi2 within 1e-6 (measured 5.2e-8, 2.4e-7,
    6.4e-6, 4.7e-9). A point seen once is free along its ray: there the
    two packages' float32 steps part by up to 3 cm (a 1.2 cm and a 3.0 cm
    walk from the truth), so only its residual is compared;
  - ``refine_intrinsics`` against the JAX package (noise-free
    measurements, so the cost falls to the rounding floor): float64
    17-vectors within 1e-9 relative to max(1, |entry|), cost within 1e-12
    (measured 2.8e-11; both costs 4.15e-18); float32 u0, v0 within 1e-3 px, cost
    within 1e-5 (measured 0 px; costs 3.4e-7 and 4.0e-7). The float32
    inverse-polynomial tail is poorly determined and parts by up to 20%
    of an entry, so only u0 and v0 are compared there;
  - the JAX test's own bars on the port: camera 0 unchanged exactly,
    cameras 1-2 within 5e-4 of the truth, u0 and v0 within 0.05 px;
  - ``bundle_adjustment(free_mc=True)`` returns the self-calibrating
    BA's poses, points and chi2;
  - a camera that no observation reaches keeps lambda alone on its block:
    its extrinsics do not move and everything stays finite, in both
    packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from multicol_slam_tpu.models import optimizer as jopt
from multicol_slam_tpu.ops import rig as jrig
from multicol_slam_tpu.utils import config_io as jcio
from multicol_slam_tpu_torch.models import optimizer as topt
from multicol_slam_tpu_torch.ops import rig as trig
from multicol_slam_tpu_torch.ops.camera import world_to_img
from multicol_slam_tpu_torch.ops.geometry import cayley2hom, inv_se3
from multicol_slam_tpu_torch.utils import config_io as tcio
from multicol_slam_tpu_torch.utils import convert

from test_optimizer import build_ba_problem, gen_world_points

DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}
# tests/test_optimizer.py's offsets of cameras 1 and 2
OFFSET = {1: np.array([0.002, -0.002, 0.002, 0.004, -0.004, 0.004]),
          2: np.array([-0.002, 0.002, 0.001, -0.004, 0.004, 0.002])}
MT_4 = np.stack([np.zeros(6), np.array([0.02, 0.01, -0.01, 0.3, 0.05, 0.1]),
                 np.array([-0.01, 0.03, 0.02, 0.5, -0.1, 0.3]),
                 np.array([0.03, -0.02, 0.01, 0.2, 0.3, -0.2])])


def _rig(np_dt=np.float64):
    return jcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=np_dt)[0]


def _t(a, dt=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dt) if dt is not None and t.is_floating_point() else t


def _t_problem(obs, pt_obs, fixed_kf, P, dt):
    return topt.BAProblem(
        obs=topt.BAObservations(*(_t(a, dt) for a in obs)), pt_obs=_t(pt_obs),
        fixed_kf=torch.tensor(fixed_kf), fixed_pt=torch.zeros(P, dtype=torch.bool))


def _j_problem(obs, pt_obs, fixed_kf, P, np_dt):
    cast = lambda a: jnp.asarray(np.asarray(a).astype(np_dt)) \
        if np.asarray(a).dtype.kind == "f" else jnp.asarray(a)
    return jopt.BAProblem(obs=jopt.BAObservations(*(cast(a) for a in obs)),
                          pt_obs=jnp.asarray(pt_obs), fixed_kf=jnp.asarray(fixed_kf),
                          fixed_pt=jnp.zeros(P, bool))


def _selfcal_case():
    """The recipe of TestSelfCalibration: (rig, truth's extrinsics, the
    perturbed extrinsics, mt_all, X, obs, pt_obs, fixed_kf)."""
    rig = _rig()
    rng = np.random.default_rng(7)
    X = gen_world_points(rng, 150)
    obs, pt_obs = build_ba_problem(rig, MT_4, X, rng)
    mc_true = np.asarray(rig.M_c_min)
    mc_pert = mc_true.copy()
    for c, off in OFFSET.items():
        mc_pert[c] += off
    return rig, mc_true, mc_pert, MT_4, X, obs, np.asarray(pt_obs), [True, True, False, False]


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_vector17_matches_jax(dt):
    np_dt, t_dt = DTYPES[dt]
    j = jax.tree.map(jnp.asarray, _rig(np_dt).cams)
    t = convert.rig_from_numpy(_rig(np_dt)).cams
    v = t.to_vector17()
    assert v.shape == (3, 17) and v.dtype == t_dt
    np.testing.assert_array_equal(v.numpy(), np.asarray(j.to_vector17()))
    # the round trip is exact
    back = t.with_vector17(v)
    for f in t._fields:
        assert torch.equal(getattr(back, f), getattr(t, f)), f
    # a new vector: every field as the JAX package sets it, the source
    # model's inv_poly untouched
    v2 = v + torch.linspace(0.5, 2.0, 17, dtype=t_dt)
    before = t.inv_poly.clone()
    got = t.with_vector17(v2)
    want = j.with_vector17(jnp.asarray(v2.numpy()))
    for f in t._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert torch.equal(t.inv_poly, before)
    assert got.inv_poly.data_ptr() != t.inv_poly.data_ptr()
    assert torch.equal(got.to_vector17(), v2)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_convert_carries_the_calibration_vectors(dt):
    """A JAX rig carried across by ``convert.rig_from_numpy`` (its camera
    fields copied bit for bit, ``M_c`` too) gives the same 17-vectors and
    the same minimal extrinsics in both packages: the vectors exactly,
    ``M_c_min`` (derived from ``M_c`` in each package, whose 3x3 products
    round differently) within two ulps (measured one)."""
    np_dt, t_dt = DTYPES[dt]
    mc = np.asarray(_rig(np_dt).M_c_min) + np.linspace(0.0, 0.01, 18).reshape(3, 6)
    jr = jrig.rig_from_cayley(mc.astype(np_dt), _rig(np_dt).cams)
    t = convert.rig_from_numpy(jr)
    assert t.M_c.dtype == t_dt
    np.testing.assert_array_equal(
        t.cams.to_vector17().numpy(), np.asarray(jax.tree.map(jnp.asarray, jr.cams).to_vector17()))
    want = np.asarray(jr.M_c_min)
    eps = np.finfo(np_dt).eps
    np.testing.assert_allclose(t.M_c_min.numpy(), want, rtol=2 * eps,
                               atol=2 * eps * np.abs(want).max())


def _jacobian_case(K=64):
    """K observations of points in front of random cameras of the rig
    from a random pose, in float64: (torch rig, JAX rig, cam, mt, mc (K, 6),
    X (K, 3), uv (K, 2))."""
    rng = np.random.default_rng(11)
    jr = _rig()
    rig = convert.rig_from_numpy(jr)
    cam = torch.from_numpy(rng.integers(0, 3, K))
    mt = torch.from_numpy(np.r_[rng.normal(0, 0.05, 3), rng.normal(0, 0.3, 3)])
    mc = rig.M_c_min[cam] + torch.from_numpy(rng.normal(0, 0.01, (K, 6)))
    M = cayley2hom(mt) @ cayley2hom(mc)
    Xc = torch.from_numpy(rng.normal(0, 1.0, (K, 3)) + [0, 0, 3])
    X = torch.einsum("kij,kj->ki", M[:, :3, :3], Xc) + M[:, :3, 3]
    uv = torch.from_numpy(rng.uniform([100, 100], [650, 380], (K, 2)))
    return rig, jr, cam, mt, mc, X, uv


def _residual(mt, mc, X, cams, uv):
    T = inv_se3(cayley2hom(mt) @ cayley2hom(mc))
    return uv - world_to_img(cams, torch.einsum("kij,kj->ki", T[:, :3, :3], X) + T[:, :3, 3])


def _per_row(J, K):
    """(K, 2, K, n) forward-mode Jacobian of a per-row map -> (K, 2, n)."""
    return J[torch.arange(K), :, torch.arange(K)]


@pytest.mark.parametrize("which", ["pose", "point", "extrinsic", "intrinsics"])
def test_jacobians_match_autodiff_and_jax(which):
    rig, jr, cam, mt, mc, X, uv = _jacobian_case()
    K = X.shape[0]
    cams = rig.cams.index(cam)
    T = inv_se3(cayley2hom(mt) @ cayley2hom(mc))
    Xc = torch.einsum("kij,kj->ki", T[:, :3, :3], X) + T[:, :3, 3]
    if which == "pose":
        got = topt.pose_jacobian(mt, cayley2hom(mc), X, cams)
        want = jacfwd(lambda a: _residual(a, mc, X, cams, uv))(mt)
    elif which == "point":
        got = topt.point_jacobian(T, Xc, cams)
        want = _per_row(jacfwd(lambda a: _residual(mt, mc, a, cams, uv))(X), K)
    elif which == "extrinsic":
        got = topt.extrinsic_jacobian(mt, mc, X, cams)
        want = _per_row(jacfwd(lambda a: _residual(mt, a, X, cams, uv))(mc), K)
    else:
        v = cams.to_vector17()
        got = topt.intrinsics_jacobian(Xc, cams)
        want = _per_row(jacfwd(lambda a: _residual(mt, mc, X, cams.with_vector17(a), uv))(v), K)
    assert got.shape == want.shape == (K, 2, {"point": 3, "intrinsics": 17}.get(which, 6))
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-9 * scale

    # the JAX package's jax.jacfwd of _project_residual, one observation at a time
    jcams = jax.tree.map(jnp.asarray, jr.cams)
    n = lambda t: jnp.asarray(t.numpy())

    def one(c, mt_, mc_, X_, uv_):
        cam1 = jax.tree.map(lambda a: a[c], jcams)
        f = {"pose": lambda a: jopt._project_residual(a, mc_, X_, cam1, uv_),
             "point": lambda a: jopt._project_residual(mt_, mc_, a, cam1, uv_),
             "extrinsic": lambda a: jopt._project_residual(mt_, a, X_, cam1, uv_),
             "intrinsics": lambda a: jopt._project_residual(
                 mt_, mc_, X_, cam1.with_vector17(a), uv_)}[which]
        at = {"pose": mt_, "point": X_, "extrinsic": mc_,
              "intrinsics": cam1.to_vector17()}[which]
        return jax.jacfwd(f)(at)

    jwant = jax.vmap(one, in_axes=(0, None, 0, 0, 0))(n(cam), n(mt), n(mc), n(X), n(uv))
    assert float(np.abs(got.numpy() - np.asarray(jwant)).max()) <= 1e-9 * scale


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_self_calibrating_ba_matches_jax(dt):
    np_dt, t_dt = DTYPES[dt]
    jr, mc_true, mc_pert, mt_all, X, obs, pt_obs, fixed_kf = _selfcal_case()
    P = X.shape[0]
    cams = _rig(np_dt).cams
    rig_t = trig.rig_from_cayley(torch.from_numpy(mc_pert.astype(np_dt)),
                                 convert.rig_from_numpy(_rig(np_dt)).cams)
    mt, Xr, mc, chi2 = topt.self_calibrating_bundle_adjustment(
        rig_t, _t(mt_all, t_dt), _t(X, t_dt), _t_problem(obs, pt_obs, fixed_kf, P, t_dt),
        iters=12)
    assert mt.dtype == mc.dtype == t_dt
    with jax.enable_x64(dt == "f64"):
        rig_j = jax.tree.map(jnp.asarray, jrig.rig_from_cayley(mc_pert.astype(np_dt), cams))
        jmt, jX, jmc, jchi2 = (np.asarray(a) for a in jopt.self_calibrating_bundle_adjustment(
            rig_j, jnp.asarray(mt_all.astype(np_dt)), jnp.asarray(X.astype(np_dt)),
            _j_problem(obs, pt_obs, fixed_kf, P, np_dt), iters=12))
        assert jmc.dtype == np_dt
    mt, Xr, mc, chi2 = mt.numpy(), Xr.numpy(), mc.numpy(), chi2.numpy()
    valid = np.asarray(obs.valid)

    if dt == "f64":
        for a, b in ((mt, jmt), (mc, jmc), (Xr, jX)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
        np.testing.assert_allclose(chi2, jchi2, rtol=1e-9, atol=1e-12)
    else:
        # a point seen once is free along its ray, where each package's
        # float32 steps wander on their own; its residual is compared
        seen = np.bincount(np.asarray(obs.pt)[valid], minlength=P)
        np.testing.assert_allclose(mt, jmt, rtol=0, atol=1e-5)
        np.testing.assert_allclose(mc, jmc, rtol=0, atol=1e-5)
        np.testing.assert_allclose(Xr[seen >= 2], jX[seen >= 2], rtol=0, atol=1e-4)
        np.testing.assert_allclose(chi2[valid], jchi2[valid], rtol=0, atol=1e-6)
    # the JAX test's bars, on the port: camera 0 is the gauge, cameras 1
    # and 2 pulled back to the truth
    np.testing.assert_array_equal(mc[0], rig_t.M_c_min[0].numpy())
    np.testing.assert_allclose(mc[1], mc_true[1], rtol=0, atol=5e-4)
    np.testing.assert_allclose(mc[2], mc_true[2], rtol=0, atol=5e-4)
    np.testing.assert_array_equal(mt[:2], mt_all[:2].astype(np_dt))


def test_free_mc_routes_to_the_self_calibrating_ba():
    jr, _, mc_pert, mt_all, X, obs, pt_obs, fixed_kf = _selfcal_case()
    P = X.shape[0]
    rig_t = trig.rig_from_cayley(torch.from_numpy(mc_pert), convert.rig_from_numpy(jr).cams)
    prob = _t_problem(obs, pt_obs, fixed_kf, P, torch.float64)
    args = (rig_t, _t(mt_all), _t(X), prob)
    mt, Xr, chi2 = topt.bundle_adjustment(*args, iters=3, free_mc=True)
    smt, sX, smc, schi2 = topt.self_calibrating_bundle_adjustment(*args, iters=3)
    assert torch.equal(mt, smt) and torch.equal(Xr, sX) and torch.equal(chi2, schi2)
    # and not to the fixed-rig BA, which cannot move the cameras' error
    fmt = topt.bundle_adjustment(*args, iters=3)[0]
    assert not torch.equal(fmt, mt)
    jmt, jX, jchi2 = jopt.bundle_adjustment(
        jax.tree.map(jnp.asarray, jrig.rig_from_cayley(mc_pert, jr.cams)),
        jnp.asarray(mt_all), jnp.asarray(X), _j_problem(obs, pt_obs, fixed_kf, P, np.float64),
        iters=3, free_mc=True)
    np.testing.assert_allclose(mt.numpy(), np.asarray(jmt), rtol=0, atol=1e-9)
    np.testing.assert_allclose(Xr.numpy(), np.asarray(jX), rtol=0, atol=1e-9)


def test_camera_without_observations_keeps_lambda_alone():
    """Camera 2 loses every observation: its block of the reduced system
    holds lambda I alone, so its extrinsics stay where they were and the
    solve stays finite, in both packages."""
    jr, mc_true, mc_pert, mt_all, X, obs, pt_obs, fixed_kf = _selfcal_case()
    P = X.shape[0]
    valid = np.asarray(obs.valid) & (np.asarray(obs.cam) != 2)
    obs = obs._replace(valid=jnp.asarray(valid))
    rig_t = trig.rig_from_cayley(torch.from_numpy(mc_pert), convert.rig_from_numpy(jr).cams)
    mt, Xr, mc, chi2 = topt.self_calibrating_bundle_adjustment(
        rig_t, _t(mt_all), _t(X), _t_problem(obs, pt_obs, fixed_kf, P, torch.float64), iters=6)
    jmt, jX, jmc, _ = jopt.self_calibrating_bundle_adjustment(
        jax.tree.map(jnp.asarray, jrig.rig_from_cayley(mc_pert, jr.cams)), jnp.asarray(mt_all),
        jnp.asarray(X), _j_problem(obs, pt_obs, fixed_kf, P, np.float64), iters=6)
    for t in (mt, Xr, mc, chi2):
        assert torch.isfinite(t).all()
    assert torch.equal(mc[2], rig_t.M_c_min[2]) and torch.equal(mc[0], rig_t.M_c_min[0])
    np.testing.assert_array_equal(np.asarray(jmc)[2], mc[2].numpy())
    np.testing.assert_allclose(mc.numpy(), np.asarray(jmc), rtol=0, atol=1e-9)
    np.testing.assert_allclose(mt.numpy(), np.asarray(jmt), rtol=0, atol=1e-9)
    # camera 1 still comes back
    np.testing.assert_allclose(mc[1].numpy(), mc_true[1], rtol=0, atol=5e-4)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_refine_intrinsics_matches_jax(dt):
    np_dt, t_dt = DTYPES[dt]
    jr = _rig()
    rng = np.random.default_rng(9)
    X = gen_world_points(rng, 200)
    mt_all = MT_4[:2]
    obs, _ = build_ba_problem(jr, mt_all, X, rng)
    jr = _rig(np_dt)
    jcams = jax.tree.map(jnp.asarray, jr.cams)
    v_true = np.asarray(jcams.to_vector17())
    v_pert = v_true.copy()
    v_pert[:, 3] += 1.5
    v_pert[:, 4] -= 1.0
    cams_t = convert.rig_from_numpy(jr).cams
    rig_t = trig.Rig(M_c=torch.from_numpy(np.asarray(jr.M_c)),
                     cams=cams_t.with_vector17(torch.from_numpy(v_pert)))
    cams_r, v17, cost = topt.refine_intrinsics(
        rig_t, _t(mt_all, t_dt), _t(X, t_dt),
        topt.BAObservations(*(_t(a, t_dt) for a in obs)), iters=10)
    assert v17.dtype == t_dt and torch.equal(cams_r.to_vector17(), v17)
    with jax.enable_x64(dt == "f64"):
        rig_j = jrig.Rig(M_c=jnp.asarray(jr.M_c),
                         cams=jcams.with_vector17(jnp.asarray(v_pert)))
        _, jv17, jcost = jopt.refine_intrinsics(
            rig_j, jnp.asarray(mt_all.astype(np_dt)), jnp.asarray(X.astype(np_dt)),
            jopt.BAObservations(*(jnp.asarray(np.asarray(a).astype(np_dt))
                                  if np.asarray(a).dtype.kind == "f" else a for a in obs)),
            iters=10)
        jv17, jcost = np.asarray(jv17), float(jcost)
    v17 = v17.numpy()
    if dt == "f64":
        scale = np.maximum(np.abs(jv17), 1.0)
        assert np.abs((v17 - jv17) / scale).max() <= 1e-9
        assert abs(float(cost) - jcost) <= 1e-12
    else:
        np.testing.assert_allclose(v17[:, 3:5], jv17[:, 3:5], rtol=0, atol=1e-3)
        assert abs(float(cost) - jcost) <= 1e-5
    # the JAX test's bars, on the port
    np.testing.assert_allclose(v17[:, 3], v_true[:, 3], rtol=0, atol=0.05)
    np.testing.assert_allclose(v17[:, 4], v_true[:, 4], rtol=0, atol=0.05)
