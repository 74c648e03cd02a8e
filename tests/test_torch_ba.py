"""The port's sparse-Schur bundle adjustment against the JAX package's on one
problem: the JAX package's synthetic map-scale BA problem (6 keyframe
poses along an arc, 200 points, up to 4 observations each, 0.5 px noise)
through the half-resolution rig, started from perturbed poses and points,
keyframe 0 fixed as the gauge, one point fixed, Huber 1.345 * 2 and 5
iterations as the local mapper runs it.

Bars, with what was measured on the CPU:
  - float64: poses within 1e-9, points within 1e-8, chi2 within 1e-9
    relative (measured 4.9e-15, 1.1e-11, 5.5e-14): the closed-form
    Jacobians equal forward-mode autodiff and the accept / reject
    decisions agree;
  - float32: poses within 2e-4, points within 1e-2 m, final robust cost
    within 1e-3 relative (measured 1.7e-5, 2.7e-3 on the worst of 200
    points, 8.5e-7);
  - both: the robust cost falls below 15% of the start (measured 206.2
    from 1974.1) and the fixed pose and point do not move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.models import optimizer as jopt
from multicol_slam_tpu.ops import rig as jrig
from multicol_slam_tpu.utils import config_io as jcio
from multicol_slam_tpu.utils import synthetic as jsyn
from multicol_slam_tpu_torch.models import optimizer as topt
from multicol_slam_tpu_torch.utils import config_io as tcio
from multicol_slam_tpu_torch.utils import convert

import _torchutil as U


def _problem(np_dt):
    full, _ = jcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=np_dt)
    rig = jrig.scale_rig(full, U.SCALE)
    with jax.enable_x64(True):
        mt, X, uv, kf, cam, pt, valid, pt_obs = jsyn.make_ba_problem(
            jax.tree.map(jnp.asarray, rig), 6, 200, max_obs_per_pt=4, seed=0)
    rng = np.random.default_rng(1)
    mt0 = mt + np.r_[rng.normal(0, 0.003, (6, 3)).T, rng.normal(0, 0.02, (6, 3)).T].T
    mt0[0] = mt[0]
    X0 = X + rng.normal(0, 0.03, X.shape)
    fixed_kf = np.zeros(6, bool)
    fixed_kf[0] = True
    fixed_pt = np.zeros(200, bool)
    fixed_pt[7] = True
    inv_sigma2 = np.ones(len(uv))
    arrays = dict(uv=uv, kf=kf, cam=cam, pt=pt, inv_sigma2=inv_sigma2, valid=valid)
    return rig, mt0, X0, arrays, pt_obs, fixed_kf, fixed_pt


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_bundle_adjustment_matches_jax(dtype):
    np_dt, t_dt = (np.float64, torch.float64) if dtype == "f64" else (np.float32, torch.float32)
    rig, mt0, X0, arrays, pt_obs, fixed_kf, fixed_pt = _problem(np_dt)
    cast = lambda a: a.astype(np_dt) if a.dtype.kind == "f" else a
    arrays = {k: cast(np.asarray(v)) for k, v in arrays.items()}
    mt0, X0 = mt0.astype(np_dt), X0.astype(np_dt)

    prob = topt.BAProblem(
        obs=topt.BAObservations(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
        pt_obs=torch.from_numpy(pt_obs), fixed_kf=torch.from_numpy(fixed_kf),
        fixed_pt=torch.from_numpy(fixed_pt))
    mt, X, chi2 = topt.bundle_adjustment(
        convert.rig_from_numpy(rig), torch.from_numpy(mt0), torch.from_numpy(X0), prob,
        huber=topt.HUBER_LOCAL, iters=5)
    assert mt.dtype == t_dt
    with jax.enable_x64(dtype == "f64"):
        jprob = jopt.BAProblem(
            obs=jopt.BAObservations(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            pt_obs=jnp.asarray(pt_obs), fixed_kf=jnp.asarray(fixed_kf),
            fixed_pt=jnp.asarray(fixed_pt))
        jmt, jX, jchi2 = jopt.bundle_adjustment(
            jax.tree.map(jnp.asarray, rig), jnp.asarray(mt0), jnp.asarray(X0), jprob,
            huber=jopt.HUBER_LOCAL, iters=5)
        assert jmt.dtype == np_dt
    jmt, jX, jchi2 = (np.asarray(a) for a in (jmt, jX, jchi2))
    mt, X, chi2 = mt.numpy(), X.numpy(), chi2.numpy()

    def cost(c2):
        h = topt.HUBER_LOCAL
        e = np.sqrt(c2.astype(np.float64))
        return np.where(arrays["valid"], np.where(e <= h, e * e, 2 * h * e - h * h), 0).sum()

    if dtype == "f64":
        np.testing.assert_allclose(mt, jmt, rtol=0, atol=1e-9)
        np.testing.assert_allclose(X, jX, rtol=0, atol=1e-8)
        np.testing.assert_allclose(chi2, jchi2, rtol=1e-9, atol=1e-12)
    else:
        np.testing.assert_allclose(mt, jmt, rtol=0, atol=2e-4)
        np.testing.assert_allclose(X, jX, rtol=0, atol=1e-2)
        assert abs(cost(chi2) - cost(jchi2)) <= 1e-3 * cost(jchi2)
    # the adjustment did its job, and the gauge held
    rig_t = convert.rig_from_numpy(rig)
    start = topt.bundle_adjustment(rig_t, torch.from_numpy(mt0), torch.from_numpy(X0),
                                   prob, huber=topt.HUBER_LOCAL, iters=0)[2].numpy()
    assert cost(chi2) < 0.15 * cost(start)
    np.testing.assert_array_equal(mt[0], mt0[0])
    np.testing.assert_array_equal(X[7], X0[7])


def test_point_jacobian_matches_autodiff():
    """The written-out point Jacobian against forward-mode autodiff of the
    residual, in float64: within 1e-12 relative."""
    from torch.func import jacfwd

    from multicol_slam_tpu_torch.ops.camera import world_to_img
    from multicol_slam_tpu_torch.ops.geometry import cayley2hom, inv_se3

    rig = convert.rig_from_numpy(_problem(np.float64)[0])
    rng = np.random.default_rng(3)
    K = 64
    cam = torch.from_numpy(rng.integers(0, 3, K))
    cams = rig.cams.index(cam)
    mt = torch.from_numpy(np.r_[rng.normal(0, 0.05, 3), rng.normal(0, 0.3, 3)])
    T = inv_se3(cayley2hom(mt) @ rig.M_c[cam])
    X = torch.from_numpy(rng.normal(0, 2, (K, 3)) + [0, 0, 4])

    def residual(X):
        Xc = torch.einsum("kij,kj->ki", T[:, :3, :3], X) + T[:, :3, 3]
        return -world_to_img(cams, Xc)

    want = jacfwd(residual)(X)                       # (K, 2, K, 3)
    want = want[torch.arange(K), :, torch.arange(K)]  # per-row blocks
    Xc = torch.einsum("kij,kj->ki", T[:, :3, :3], X) + T[:, :3, 3]
    got = topt.point_jacobian(T, Xc, cams)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
