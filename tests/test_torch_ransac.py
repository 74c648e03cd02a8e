"""The port's essential-matrix RANSAC against the JAX package, on the same
bearing pairs (a synthetic two-view scene with 20% gross outliers): the
8-point and 5-point solvers, the decomposition with the cheirality vote,
and ``ransac_essential`` with the minimal sets the JAX package sampled
injected into the port's ``sample_minimal_sets``.

Bars, with what was measured on the CPU:
  - 8-point E equal up to sign within 2e-3 in float32 (measured 4.6e-4:
    the null vector of A^T A carries the square of A's condition number,
    so float32 eigh results differ at that level between backends) and
    1e-9 in float64;
  - 5-point: the same lanes converge, E within 1e-4 on them, in float64
    (the port solves the Newton iterations in float64 for float32 inputs
    too; see ransac.py); in float32 both packages miss the float64 root
    by errors of the same size;
  - decomposition: the cheirality vote picks the same (R, t) within 1e-5
    (the four candidates come in an SVD-dependent order);
  - RANSAC: identical inlier mask and count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.ops import ransac as jr
from multicol_slam_tpu_torch.ops import ransac as tr
from multicol_slam_tpu_torch.ops import se3_np

import _torchutil as U


def _scene(seed: int, n: int = 300, out_frac: float = 0.2):
    """Bearing pairs of n points seen from two views (camera 2's pose in
    camera 1's frame: small rotation, 0.3 m baseline), some replaced by
    random rays; and a validity mask."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0.0, 0.0, 5.0])
    R = se3_np.cayley2rot(np.array([0.02, -0.03, 0.01]))
    t = np.array([0.3, 0.05, 0.02])
    v1 = X / np.linalg.norm(X, axis=1, keepdims=True)
    X2 = (X - t) @ R
    v2 = X2 / np.linalg.norm(X2, axis=1, keepdims=True)
    out = rng.random(n) < out_frac
    v2[out] = rng.normal(size=(int(out.sum()), 3))
    v2 /= np.linalg.norm(v2, axis=1, keepdims=True)
    valid = rng.random(n) < 0.9
    return v1.astype(np.float32), v2.astype(np.float32), valid, ~out


def _same_up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    s = np.sign((a * b).sum())
    np.testing.assert_allclose(a, s * b, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_essential_8pt_matches_jax(dtype):
    v1, v2, valid, inl = _scene(0)
    sel = valid & inl
    np_dt, t_dt = (np.float64, torch.float64) if dtype == "f64" else (np.float32, torch.float32)
    a, b = v1[sel].astype(np_dt), v2[sel].astype(np_dt)
    got = tr.essential_8pt(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == t_dt
    with jax.enable_x64(dtype == "f64"):
        want = jr.essential_8pt(jnp.asarray(a), jnp.asarray(b))
    _same_up_to_sign(got.numpy(), want, 2e-3 if dtype == "f32" else 1e-9)


def _seed_lanes(n_samples, dt):
    cays = np.array([s[0] for s in jr.ESSENTIAL_SEEDS], dt)
    ts = np.array([s[1] for s in jr.ESSENTIAL_SEEDS], dt)
    ts /= np.linalg.norm(ts, axis=-1, keepdims=True)
    return np.tile(cays, (n_samples, 1)), np.tile(ts, (n_samples, 1))


def test_essential_5pt_matches_jax():
    v1, v2, valid, inl = _scene(1, out_frac=0.0)
    rng = np.random.default_rng(2)
    idx = rng.integers(0, len(v1), (16, 5))
    cays, ts = _seed_lanes(16, np.float64)
    lanes = lambda v: np.repeat(v[idx].astype(np.float64), len(jr.ESSENTIAL_SEEDS), 0)
    E, res = tr.essential_5pt(*(torch.from_numpy(a) for a in
                                (lanes(v1), lanes(v2), cays, ts)))
    with jax.enable_x64(True):
        jE, jres = jax.vmap(jr.essential_5pt)(
            *(jnp.asarray(a) for a in (lanes(v1), lanes(v2), cays, ts)))
    tol = 250 * np.finfo(np.float32).eps
    ok, jok = res.numpy() <= tol, np.asarray(jres) <= tol
    np.testing.assert_array_equal(ok, jok)
    assert ok.sum() >= 16               # most samples have a converged seed
    for i in np.nonzero(ok)[0]:
        _same_up_to_sign(E[i].numpy(), np.asarray(jE[i]), 1e-4)


def _unit_e(E):
    """E (..., 3, 3) as float64 rows of 9, unit norm, largest entry positive."""
    E = np.asarray(E, np.float64).reshape(-1, 9)
    E = E / np.linalg.norm(E, axis=1, keepdims=True)
    return E * np.sign(np.take_along_axis(E, np.abs(E).argmax(1)[:, None], 1))


def test_essential_5pt_float32_root_error_is_the_jax_packages():
    """Why ransac_essential solves in float64: in float32 the root of a
    small-baseline minimal sample moves by rounding, in both packages
    alike. Newton's fixed point is F = 0 whatever the Jacobian, so the
    root's error comes from evaluating F in float32, whose order of
    operations differs between torch and XLA. Over 1000 bootstrap-like
    samples (3-8 cm baseline, points 2-8 m; 566 lanes where all three
    solves reach the same root), both float32 solvers miss the float64
    root by the same size of error (measured on the CPU: median 6.4e-6
    port against 6.2e-6 JAX, p90 2.4e-5 against 2.2e-5, worst lane
    2.7e-4 against 1.1e-4), and either may be the farther on a given
    lane (the port on 54%), as on the bootstrap pair of PERF.md (0.0044
    against 0.0016)."""
    rng = np.random.default_rng(0)
    L = 1000
    X = rng.uniform(-3, 3, (L, 5, 3))
    X[..., 2] = rng.uniform(2, 8, (L, 5))
    t = rng.normal(size=(L, 3))
    t *= rng.uniform(0.03, 0.08, (L, 1)) / np.linalg.norm(t, axis=1, keepdims=True)
    R = se3_np.cayley2rot(rng.normal(size=(L, 3)) * 0.01)
    X2 = np.einsum("lij,lnj->lni", R, X) + t[:, None]
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)
    v1 = unit(unit(X) + rng.normal(size=X.shape) * 2e-4)
    v2 = unit(unit(X2) + rng.normal(size=X.shape) * 2e-4)
    cay0, t0 = np.zeros((L, 3)), np.tile([1.0, 0.0, 0.0], (L, 1))
    args = (v1, v2, cay0, t0)
    E64, r64 = tr.essential_5pt(*(torch.from_numpy(a) for a in args))
    E32, r32 = tr.essential_5pt(*(torch.from_numpy(a.astype(np.float32)) for a in args))
    with U.f32():
        jE, jr32 = jax.jit(jax.vmap(jr.essential_5pt))(
            *(jnp.asarray(a, jnp.float32) for a in args))
    tol = 250 * np.finfo(np.float32).eps
    root = _unit_e(E64)
    d_port = np.linalg.norm(_unit_e(E32) - root, axis=1)
    d_jax = np.linalg.norm(_unit_e(jE) - root, axis=1)
    same = ((r64.numpy() < 1e-10) & (r32.numpy() < tol) & (np.asarray(jr32) < tol)
            & (d_port < 0.05) & (d_jax < 0.05))
    assert same.sum() > 300
    for q in (50, 90):
        p, j = np.percentile(d_port[same], q), np.percentile(d_jax[same], q)
        assert p < 1e-4 and j < 1e-4           # rounding, not a wrong root
        assert 0.5 < p / j < 2.0
    assert 0.3 < (d_port[same] > d_jax[same]).mean() < 0.7


def test_decompose_and_cheirality_pick_the_same_pose():
    v1, v2, valid, inl = _scene(3)
    sel = valid & inl
    E = tr.essential_8pt(torch.from_numpy(v1[sel]), torch.from_numpy(v2[sel]))
    Rs, ts = tr.decompose_essential(E)
    counts, Xs = tr.cheirality_counts(Rs, ts, torch.from_numpy(v1),
                                      torch.from_numpy(v2), torch.from_numpy(sel))
    with U.f32():
        jRs, jts = jr.decompose_essential(jnp.asarray(E.numpy()))
        jcounts, jXs = jr.cheirality_counts(jRs, jts, jnp.asarray(v1),
                                            jnp.asarray(v2), jnp.asarray(sel))
    b, jb = int(torch.argmax(counts)), int(np.argmax(np.asarray(jcounts)))
    assert int(counts[b]) == int(np.asarray(jcounts)[jb]) > 0.9 * sel.sum()
    np.testing.assert_allclose(Rs[b].numpy(), np.asarray(jRs[jb]), atol=1e-5)
    np.testing.assert_allclose(ts[b].numpy(), np.asarray(jts[jb]), atol=1e-5)
    np.testing.assert_allclose(Xs[b].numpy()[sel], np.asarray(jXs[jb])[sel],
                               rtol=1e-3, atol=1e-3)
    assert sorted(counts.tolist()) == sorted(np.asarray(jcounts).tolist())


@pytest.mark.parametrize("seed", [0, 4])
def test_ransac_essential_with_injected_sets(monkeypatch, seed):
    v1, v2, valid, inl = _scene(seed)
    key = jax.random.PRNGKey(seed)
    with U.f32():
        jE, j_inl, j_n = jr.ransac_essential(key, jnp.asarray(v1), jnp.asarray(v2),
                                             jnp.asarray(valid))
        idx = jax.jit(lambda k, w: jr.sample_minimal_sets(k, 256, 5, len(v1), w))(
            key, jnp.asarray(valid.astype(np.float32)))
    idx = torch.from_numpy(np.asarray(idx).astype(np.int64))
    monkeypatch.setattr(tr, "sample_minimal_sets", lambda *a, **k: idx)
    E, got_inl, n = tr.ransac_essential(torch.Generator(), torch.from_numpy(v1),
                                        torch.from_numpy(v2), torch.from_numpy(valid))
    np.testing.assert_array_equal(got_inl.numpy(), np.asarray(j_inl))
    assert int(n) == int(j_n) >= 0.9 * (valid & inl).sum()


def test_sampling_draws_only_valid_points():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 17, 40]] = True
    idx = tr.sample_minimal_sets(torch.Generator().manual_seed(0), 64, 5, 50,
                                 valid.float())
    assert idx.shape == (64, 5)
    assert set(idx.unique().tolist()) <= {3, 17, 40}
