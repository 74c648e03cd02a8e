"""The loop closer's written-out Jacobians against ``torch.func.jacfwd``
(kept here, in the test only): OptimizeSim3's residual Jacobian
(``sim3_opt.sim3_linearize``) and the essential graph's edge Jacobians
(``sim3_opt.edge_linearize``), and the tangents of ``ops/sim3.py`` and
``ops/geometry.py`` they are built from; each linearization's residuals
are bit for bit the residual functions' own.

The Jacobians are taken where the value switches between a closed form
and its series: theta < 1e-5 in ``_sim3_W_coeffs``, |sigma| < 1e-5, both
at once, theta <= 1e-6 in ``rot2rodrigues``, and edges whose residual is
below 1e-6 rad (an essential graph near convergence, where the log's
small-angle branch is the common case). Forward-mode autodiff
differentiates the branch that is selected, and so does the written-out
form.

Bars: 1e-10 in float64 (measured at most 1.4e-13 on the Sim3 pairs'
pixel Jacobians, 1.3e-15 on the tangents and the edges); in float32, 1e-3
on the pixel Jacobians (entries up to 2.0e2 px; measured 7.6e-5) and 1e-5
on the tangents and the edges (measured 6.9e-7). No JAX.
"""

import numpy as np
import pytest
import torch
from torch.func import jacfwd

from multicol_slam_tpu_torch.models import sim3_opt as tso
from multicol_slam_tpu_torch.ops import camera as tcam
from multicol_slam_tpu_torch.ops import geometry as geo
from multicol_slam_tpu_torch.ops import sim3 as ts3
from multicol_slam_tpu_torch.utils import config_io

# dtype, tolerance on the tangents and edges, on the pixel Jacobians
DT = {"f64": (torch.float64, 1e-10, 1e-10), "f32": (torch.float32, 1e-5, 1e-3)}


def _vecs(dt):
    """7-vectors [omega, upsilon, sigma] at every branch of the Sim3 maps:
    general, theta < 1e-5, |sigma| < 1e-5, both, theta = 0, sigma = 0, and
    each side of both thresholds."""
    rng = np.random.default_rng(3)
    v = rng.normal(size=(12, 7)) * np.array([0.6] * 3 + [1.0] * 3 + [0.3])
    v[1, :3] = 1e-7                    # the SO3 series
    v[2, 6] = 1e-7                     # sigma's series
    v[3, :3], v[3, 6] = 2e-6, -3e-6    # both
    v[4, :3] = 0.0                     # theta = 0
    v[5, 6] = 0.0                      # sigma = 0
    v[6, :3] = [6e-6, 0.0, 0.0]        # theta below 1e-5, Rodrigues' closed form
    v[7, :3] = [2e-5, 0.0, 0.0]        # theta just above 1e-5
    v[8, 6] = 2e-5                     # sigma just above 1e-5
    v[9, :3] = [0.0, 3e-7, 0.0]        # Rodrigues' series (theta^2 < 1e-16 is 1e-8 rad)
    return torch.tensor(v, dtype=dt)


# jacfwd's references take a (1, n) operand: in torch 2.13 forward-mode AD
# gives a 0-dim slice times a Python scalar a float64 tangent


def _flat(S):
    return torch.cat([S.s[..., None], S.R.flatten(-2), S.t], -1)


@pytest.mark.parametrize("dtype", list(DT))
def test_exp_inverse_log_tangents(dtype):
    dt, atol, _ = DT[dtype]
    eye = torch.eye(7, dtype=dt)
    S0 = ts3.sim3_exp(torch.tensor([0.1, -0.2, 0.3, 0.5, -0.4, 0.2, 0.05], dtype=dt))
    for v in _vecs(dt):
        S, dS = ts3.sim3_exp_jvp(v, eye)
        assert torch.equal(_flat(S), _flat(ts3.sim3_exp(v)))
        want = jacfwd(lambda x: _flat(ts3.sim3_exp(x[None]))[0])(v)
        torch.testing.assert_close(_flat(dS).T, want, rtol=0, atol=atol)
        Si, dSi = ts3.inverse_jvp(S, dS)
        want = jacfwd(lambda x: _flat(ts3.sim3_exp(x[None]).inverse())[0])(v)
        torch.testing.assert_close(_flat(dSi).T, want, rtol=0, atol=atol)
        # the log of exp(x) o S0 o exp(v) along x at 0: every branch of the
        # log through v's own
        Sv = S0.compose(S)
        E, dE = ts3.sim3_exp_jvp(torch.zeros(7, dtype=dt), eye)
        val, dlog = ts3.sim3_log_jvp(*ts3.compose_jvp(E, dE, Sv, None))
        assert torch.equal(val, ts3.sim3_log(E.compose(Sv)))
        want = jacfwd(lambda x: ts3.sim3_log(ts3.sim3_exp(x[None]).compose(Sv))[0])(
            torch.zeros(7, dtype=dt))
        torch.testing.assert_close(dlog.T, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", list(DT))
def test_rodrigues_tangents_at_their_branches(dtype):
    dt, atol, _ = DT[dtype]
    eye = torch.eye(3, dtype=dt)
    for w in _vecs(dt)[:, :3]:
        R, dR = geo.rodrigues2rot_jvp(w, eye)
        assert torch.equal(R, geo.rodrigues2rot(w))
        want = jacfwd(lambda x: geo.rodrigues2rot(x[None])[0])(w)   # (3, 3, 3)
        torch.testing.assert_close(dR.permute(1, 2, 0), want, rtol=0, atol=atol)
        assert torch.isfinite(dR).all()
        # the log's tangent along a rotation's: R exp(x) at x = 0
        w2, dw2 = geo.rot2rodrigues_jvp(R, R @ geo.skew(eye))
        assert torch.equal(w2, geo.rot2rodrigues(R))
        want = jacfwd(lambda x: geo.rot2rodrigues(R @ geo.rodrigues2rot(x[None]))[0])(
            torch.zeros(3, dtype=dt))
        torch.testing.assert_close(dw2.T, want, rtol=0, atol=atol)
        assert torch.isfinite(dw2).all()


def _rig(dt):
    rig = config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0]
    cast = lambda t: t.to(dt) if torch.is_floating_point(t) else t
    return rig._replace(M_c=cast(rig.M_c), cams=type(rig.cams)(*(cast(t) for t in rig.cams)))


def _pairs(dt, n=40, seed=5):
    """Pairs of one landmark in two keyframes' body frames (X2 = S12^-1
    X1), each in front of a random camera, with 1 px noise on its
    observations; a fifth of the rows invalid."""
    rig = _rig(torch.float64)
    rng = np.random.default_rng(seed)
    h, w = float(rig.cams.height[0]), float(rig.cams.width[0])
    cams = rng.integers(0, rig.n_cams, n)
    uv = np.stack([rng.uniform(0.3 * w, 0.7 * w, n), rng.uniform(0.3 * h, 0.7 * h, n)], 1)
    ray = tcam.img_to_world(rig.cams.index(torch.from_numpy(cams)), torch.from_numpy(uv))
    Xc = ray.numpy() * rng.uniform(2.0, 6.0, (n, 1))
    Mc = rig.M_c.numpy()
    X1 = np.einsum("nij,nj->ni", Mc[cams, :3, :3], Xc) + Mc[cams, :3, 3]
    S12 = ts3.sim3_exp(torch.tensor([0.05, -0.1, 0.08, 0.3, -0.2, 0.1, 0.02],
                                    dtype=torch.float64))
    X2 = S12.inverse().apply(torch.from_numpy(X1)).numpy()
    t = lambda a: torch.tensor(a, dtype=dt)
    ci = torch.from_numpy(cams.astype(np.int32))
    return tso.Sim3Obs(X1=t(X1), X2=t(X2), uv1=t(uv + rng.normal(size=(n, 2))),
                       uv2=t(uv + rng.normal(size=(n, 2))), cam1=ci, cam2=ci,
                       inv_sigma2_1=t(1.2 ** (-2.0 * rng.integers(0, 3, n))),
                       inv_sigma2_2=t(1.2 ** (-2.0 * rng.integers(0, 3, n))),
                       valid=torch.from_numpy(rng.random(n) < 0.8)), \
        ts3.Sim3(*(x.to(dt) for x in S12))


@pytest.mark.parametrize("dtype", list(DT))
def test_optimize_sim3_jacobian_against_jacfwd(dtype):
    """d r / d v7 at exp(v7) o S12_init, v7 at every branch point and at
    the iterate's own scale, against jacfwd of the residuals."""
    dt, _, atol = DT[dtype]
    rig = _rig(dt)
    obs, S12 = _pairs(dt)
    S0 = ts3.sim3_exp(torch.tensor([0.02, 0.01, -0.02, 0.05, 0.03, -0.04, 0.02],
                                   dtype=dt)).compose(S12)
    for v7 in torch.cat([_vecs(dt) * 0.05, _vecs(dt)[:6] * 1e-3]):
        def flat_res(v):
            r1, r2 = tso.sim3_residuals(rig, ts3.sim3_exp(v[None]).compose(S0), obs)
            return torch.cat([r1[0], r2[0]], 0)
        want = jacfwd(flat_res)(v7)                                # (2K, 2, 7)
        (r1, r2), (J1, J2) = tso.sim3_linearize(rig, v7, S0, obs)
        assert torch.equal(torch.cat([r1, r2], 0), flat_res(v7))
        got = torch.cat([J1, J2], 0)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


def edge_residuals(vi, vj, m):
    """The essential graph's edge residual, as the JAX package writes it."""
    return ts3.sim3_log(ts3.sim3_exp(m).compose(ts3.sim3_exp(vj))
                        .compose(ts3.sim3_exp(vi).inverse()))


def _edges(dt, E=48, seed=9):
    """Edge endpoints and measurements: random ones, and ones near
    convergence (the measurement is the endpoints' own relative Sim3 up
    to a residual below 1e-6 rad), endpoints at the branch points too."""
    rng = np.random.default_rng(seed)
    vi = rng.normal(size=(E, 7)) * np.array([0.5] * 3 + [1.0] * 3 + [0.2])
    vj = rng.normal(size=(E, 7)) * np.array([0.5] * 3 + [1.0] * 3 + [0.2])
    special = _vecs(torch.float64).numpy()
    vi[:len(special)] = special
    vj[len(special):2 * len(special)] = special
    vi, vj = torch.tensor(vi), torch.tensor(vj)
    Si, Sj = ts3.sim3_exp(vi), ts3.sim3_exp(vj)
    m = ts3.sim3_log(Si.compose(Sj.inverse()))
    near = torch.arange(E) % 2 == 0
    off = torch.tensor(rng.normal(size=(E, 7))) * torch.where(
        torch.arange(E)[:, None] % 4 == 0, 3e-7, 0.05)
    m = m + torch.where(near[:, None], off * (torch.arange(E)[:, None] % 4 == 0), off)
    return vi.to(dt), vj.to(dt), m.to(dt)


@pytest.mark.parametrize("dtype", list(DT))
def test_edge_jacobians_against_jacfwd(dtype):
    dt, atol, _ = DT[dtype]
    vi, vj, m = _edges(dt)
    E = vi.shape[0]
    r, Ji, Jj = tso.edge_linearize(torch.cat([vi, vj]), torch.arange(E), torch.arange(E, 2 * E),
                                   ts3.sim3_exp(m))
    assert torch.equal(r, edge_residuals(vi, vj, m))
    theta = r[:, :3].norm(dim=-1)
    assert (theta < 1e-6).sum() >= 8 and (theta > 1e-2).sum() >= 8   # both regimes
    assert torch.isfinite(Ji).all() and torch.isfinite(Jj).all()
    res = lambda a, b, c: edge_residuals(a[None], b[None], c[None])[0]
    for e in range(vi.shape[0]):
        wi, wj = jacfwd(res, argnums=(0, 1))(vi[e], vj[e], m[e])
        torch.testing.assert_close(Ji[e], wi, rtol=0, atol=atol)
        torch.testing.assert_close(Jj[e], wj, rtol=0, atol=atol)


def test_sim3_opt_imports_no_forward_mode_autodiff():
    import inspect
    src = inspect.getsource(tso)
    assert "torch.func" not in src and "jacfwd(" not in src and "vmap(" not in src
