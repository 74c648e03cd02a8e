"""The port's Sim3 primitives and loop-closing optimizers against the JAX
package on the same numpy inputs: sim3_exp / sim3_log / compose /
inverse / apply / horn_alignment, ``optimize_sim3`` on a synthetic
two-keyframe scene through the in-repo rig, and
``optimize_essential_graph`` on a drifted chain with a loop edge.

Bars, with what was measured on the CPU:
  - exp, log, compose, inverse, apply and to_se3 within 1e-10 in float64
    and 1e-5 in float32 (measured at most 4.4e-15 and 4.8e-7), and the
    log inverts the exp to the same bars;
  - Horn's alignment within 1e-10 in float64 (measured 5.2e-14) and 1e-4
    in float32 (measured 2.3e-5: the float32 eigenvector of the 4x4
    matrix is off by about eps / gap in each package), on non-degenerate
    point sets only: on a degenerate set (a repeated largest eigenvalue)
    the backends' eigh may return different eigenvectors of the
    eigenspace, and q, -q give the same rotation;
  - optimize_sim3 (float32): the same inlier mask, S12 within 1e-4
    (measured 1.6e-5 with free scale, 1.5e-8 with the scale held);
  - optimize_essential_graph: logs within 1e-9 in float64 and 2e-4 in
    float32 (measured 5.3e-13 and 7.4e-5 with free scale, 6.7e-16 and
    3.6e-7 with the scale held).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.models import sim3_opt as jso
from multicol_slam_tpu.ops import sim3 as js3
from multicol_slam_tpu_torch.models import sim3_opt as tso
from multicol_slam_tpu_torch.ops import camera as tcam
from multicol_slam_tpu_torch.ops import sim3 as ts3

import _torchutil as U

DT = {"f64": (np.float64, 1e-10), "f32": (np.float32, 1e-5)}


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def _pair(S_j, S_t, atol):
    for a, b in zip(S_j, S_t):
        _close(a, b.numpy(), atol)


def _vecs(seed, n, dt):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 7)) * np.array([0.6] * 3 + [1.0] * 3 + [0.3])
    v[0] = 0.0                         # identity
    v[1, :3] = 1e-7                    # small-angle series
    v[2, 6] = 1e-7                     # small-scale series
    v[3, :3] = 0.0
    return v.astype(dt)


@pytest.mark.parametrize("dtype", list(DT))
def test_exp_log_compose_inverse_match_jax(dtype):
    dt, atol = DT[dtype]
    v = _vecs(0, 16, dt)
    w = _vecs(1, 16, dt)
    X = np.random.default_rng(2).normal(size=(16, 3)).astype(dt)
    with jax.enable_x64(dtype == "f64"):
        Sj = js3.sim3_exp(jnp.asarray(v))
        Tj = js3.sim3_exp(jnp.asarray(w))
        want = dict(exp=Sj, log=js3.sim3_log(Sj), comp=Sj.compose(Tj), inv=Sj.inverse(),
                    app=Sj.apply(jnp.asarray(X)), se3=Sj.to_se3(),
                    loop=js3.sim3_log(Sj.compose(Tj).compose(Sj.inverse())))
    St = ts3.sim3_exp(torch.from_numpy(v))
    Tt = ts3.sim3_exp(torch.from_numpy(w))
    _pair(want["exp"], St, atol)
    _close(want["log"], ts3.sim3_log(St).numpy(), atol)
    _pair(want["comp"], St.compose(Tt), atol)
    _pair(want["inv"], St.inverse(), atol)
    _close(want["app"], St.apply(torch.from_numpy(X)).numpy(), atol)
    _close(want["se3"], St.to_se3().numpy(), atol)
    _close(want["loop"], ts3.sim3_log(St.compose(Tt).compose(St.inverse())).numpy(), atol)
    # the log inverts the exp
    _close(ts3.sim3_log(St).numpy(), v, atol)


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_alignment_matches_jax(dtype, fix_scale):
    dt, atol = DT[dtype]
    rng = np.random.default_rng(3)
    P2 = rng.normal(size=(32, 3, 3)) * np.array([1.0, 2.0, 3.0])   # 32 batched sets
    S = js3.sim3_exp(jnp.asarray(_vecs(4, 32, np.float64)))
    P1 = np.asarray(S.apply(jnp.asarray(P2).transpose(1, 0, 2))).transpose(1, 0, 2)
    P1 = P1 + rng.normal(size=P1.shape) * 0.01
    P1, P2 = P1.astype(dt), P2.astype(dt)
    with jax.enable_x64(dtype == "f64"):
        want = js3.horn_alignment(jnp.asarray(P1), jnp.asarray(P2), fix_scale=fix_scale)
    got = ts3.horn_alignment(torch.from_numpy(P1), torch.from_numpy(P2), fix_scale=fix_scale)
    # float32 eigh of the 4x4 matrix: each package's eigenvector is off by
    # about eps / gap, so the two differ by more than the primitives' 1e-5
    _pair(want, got, atol if dtype == "f64" else 1e-4)


def _sim3_scene(seed):
    """Pairs of one landmark seen by keyframe 1 (body frame X1, through
    camera c at uv1) and keyframe 2 (X2 = S12^-1 X1), with 1 px noise and a
    tenth of the rows corrupted; a perturbed initial S12."""
    rig = U.torch_rig()
    rng = np.random.default_rng(seed)
    n = 60
    h, w = U.image_hw()
    cams = rng.integers(0, 3, n)
    uv = np.stack([rng.uniform(0.3 * w, 0.7 * w, n), rng.uniform(0.3 * h, 0.7 * h, n)], 1)
    ray = tcam.img_to_world(rig.cams.index(torch.from_numpy(cams)),
                            torch.from_numpy(uv.astype(np.float32))).numpy()
    Xc = ray * rng.uniform(2.0, 6.0, (n, 1))
    Mc = rig.M_c.numpy().astype(np.float64)
    X1 = np.einsum("nij,nj->ni", Mc[cams, :3, :3], Xc) + Mc[cams, :3, 3]
    S12 = ts3.sim3_exp(torch.tensor([0.05, -0.1, 0.08, 0.3, -0.2, 0.1, 0.0], dtype=torch.float64))
    X2 = S12.inverse().apply(torch.from_numpy(X1)).numpy()
    S_true = ts3.Sim3(*(t.float() for t in S12))
    obs = tso.Sim3Obs(
        X1=torch.from_numpy(X1.astype(np.float32)), X2=torch.from_numpy(X2.astype(np.float32)),
        uv1=torch.zeros(n, 2), uv2=torch.zeros(n, 2), cam1=torch.from_numpy(cams.astype(np.int32)),
        cam2=torch.from_numpy(cams.astype(np.int32)), inv_sigma2_1=torch.ones(n),
        inv_sigma2_2=torch.ones(n), valid=torch.from_numpy(rng.random(n) < 0.95))
    r1, r2 = tso.sim3_residuals(rig, S_true, obs)
    bad = rng.random(n) < 0.1
    uv1 = (-r1).numpy() + rng.normal(size=(n, 2)) + bad[:, None] * 40.0
    uv2 = (-r2).numpy() + rng.normal(size=(n, 2))
    lv = rng.integers(0, 3, (2, n))
    obs = obs._replace(uv1=torch.from_numpy(uv1.astype(np.float32)),
                       uv2=torch.from_numpy(uv2.astype(np.float32)),
                       inv_sigma2_1=torch.from_numpy((1.2 ** (-2.0 * lv[0])).astype(np.float32)),
                       inv_sigma2_2=torch.from_numpy((1.2 ** (-2.0 * lv[1])).astype(np.float32)))
    S0 = ts3.sim3_exp(torch.tensor([0.02, 0.01, -0.02, 0.05, 0.03, -0.04, 0.02])).compose(S_true)
    return rig, obs, S0


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_jax(fix_scale):
    rig, obs, S0 = _sim3_scene(5)
    S, inl, n_in = tso.optimize_sim3(rig, S0, obs, iters=10, fix_scale=fix_scale)
    with U.f32():
        Sj, inl_j, n_j = jso.optimize_sim3(
            U.jax_rig(), js3.Sim3(*(jnp.asarray(t.numpy()) for t in S0)),
            jso.Sim3Obs(*(jnp.asarray(t.numpy()) for t in obs)), iters=10,
            fix_scale=fix_scale)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_j))
    assert int(n_in) == int(n_j) >= 40
    _pair(Sj, S, 1e-4)
    if fix_scale:
        assert abs(float(S.s) - float(S0.s)) < 1e-6


def _graph(seed, N=8):
    """A drifted chain of N world->keyframe Sim3 logs with spanning edges
    measured from the drifted poses and one loop edge (N-1, 0) from the
    true ones; keyframe 0 fixed; 3 padding edges."""
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(N, 7)) * np.array([0.2] * 3 + [1.0] * 3 + [0.0])
    drift = true + np.cumsum(rng.normal(size=(N, 7)) * 0.01, 0) * np.array([1.0] * 6 + [0.0])
    drift[0] = true[0]
    S_d = js3.sim3_exp(jnp.asarray(drift))
    S_t = js3.sim3_exp(jnp.asarray(true))
    ei = list(range(N - 1)) + [N - 1, 0, 0, 0]
    ej = list(range(1, N)) + [0, 0, 0, 0]
    idx = lambda S, i: js3.Sim3(S.s[i], S.R[i], S.t[i])
    meas = [np.asarray(js3.sim3_log(idx(S_d, a).compose(idx(S_d, b).inverse())))
            for a, b in zip(ei[:N - 1], ej[:N - 1])]
    meas.append(np.asarray(js3.sim3_log(idx(S_t, N - 1).compose(idx(S_t, 0).inverse()))))
    meas += [np.zeros(7)] * 3
    valid = np.arange(len(ei)) < N
    fixed = np.zeros(N, bool)
    fixed[0] = True
    return drift, np.asarray(ei), np.asarray(ej), np.stack(meas), valid, fixed


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_essential_graph_matches_jax(dtype, fix_scale):
    dt = np.float64 if dtype == "f64" else np.float32
    atol = 1e-9 if dtype == "f64" else 2e-4
    with jax.enable_x64(True):
        drift, ei, ej, meas, valid, fixed = _graph(6)
    drift, meas = drift.astype(dt), meas.astype(dt)
    with jax.enable_x64(dtype == "f64"):
        want = jso.optimize_essential_graph(
            jnp.asarray(drift), jso.EssentialGraph(
                jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32), jnp.asarray(meas),
                jnp.asarray(valid), jnp.asarray(fixed)), iters=20, fix_scale=fix_scale)
    got = tso.optimize_essential_graph(
        torch.from_numpy(drift), tso.EssentialGraph(
            torch.from_numpy(ei), torch.from_numpy(ej), torch.from_numpy(meas),
            torch.from_numpy(valid), torch.from_numpy(fixed)), iters=20, fix_scale=fix_scale)
    _close(want, got.numpy(), atol)
    # the loop pulled the drifted chain: the last vertex moved
    assert np.abs(got.numpy()[-1] - drift[-1]).max() > 1e-3
