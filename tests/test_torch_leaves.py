"""The JAX package's leaf functions, port against the JAX package on the
same numpy inputs: the torch two-view helpers of ``ops/geometry.py``
(``essential_from_relpose``, ``essential_from_poses``,
``check_dist_epipolar_line``, ``rot2quat``), ``camera.is_in_mirror_mask``,
``hamming_matrix_exact`` / ``hamming_matrix_masked_exact`` / ``to_pm1``,
``gated_nn_match(mutual=True)``,
``pyramid.box_filter``, ``brief.ic_angle``, ``Features.n_cams`` /
``k_per_cam``, ``config_io.load_interior_orientation``,
``ransac_essential(sample_size=8)``, ``ransac_gpnp(sample_size=6)`` and
``bundle_adjustment(early_stop=False)``.

Bars: integer and boolean outputs exact; float outputs within 1e-12 in
float64 (the golden cases) and 1e-5 relative in float32 (the production
ones), unless a test states otherwise. ``ransac_essential``'s draws come
from ``torch.Generator``, not ``jax.random``, so its 8-point hypotheses
are held on a clean, well-conditioned scene (every valid pair an inlier):
the same inlier set as the JAX package's and E equal up to sign and scale
within 1e-3 in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.models import extractor as jext
from multicol_slam_tpu.models import optimizer as jopt
from multicol_slam_tpu.ops import brief as jbrief
from multicol_slam_tpu.ops import camera as jcam
from multicol_slam_tpu.ops import geometry as jgeo
from multicol_slam_tpu.ops import hamming as jham
from multicol_slam_tpu.ops import pyramid as jpyr
from multicol_slam_tpu.ops import ransac as jransac
from multicol_slam_tpu.utils import config_io as jcio
from multicol_slam_tpu_torch.models import extractor as text
from multicol_slam_tpu_torch.models import optimizer as topt
from multicol_slam_tpu_torch.ops import brief as tbrief
from multicol_slam_tpu_torch.ops import camera as tcam
from multicol_slam_tpu_torch.ops import geometry as tgeo
from multicol_slam_tpu_torch.ops import hamming as tham
from multicol_slam_tpu_torch.ops import pyramid as tpyr
from multicol_slam_tpu_torch.ops import ransac as transac
from multicol_slam_tpu_torch.ops import se3_np
from multicol_slam_tpu_torch.utils import config_io as tcio
from multicol_slam_tpu_torch.utils import synthetic as tsyn

TOL = {"f64": (np.float64, torch.float64, dict(rtol=0, atol=1e-12)),
       "f32": (np.float32, torch.float32, dict(rtol=1e-5, atol=1e-6))}


def _poses(rng, n):
    """n random world-to-camera poses (n, 4, 4) in float64."""
    T = np.stack([se3_np.cayley2hom(np.r_[rng.normal(0, 0.4, 3), rng.normal(0, 1, 3)])
                  for _ in range(n)])
    return T


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_essentials_match_jax(dtype):
    npd, td, tol = TOL[dtype]
    rng = np.random.default_rng(0)
    T1, T2 = _poses(rng, 6).astype(npd), _poses(rng, 6).astype(npd)
    want = np.asarray(jgeo.essential_from_poses(jnp.asarray(T1), jnp.asarray(T2)))
    got = tgeo.essential_from_poses(torch.from_numpy(T1), torch.from_numpy(T2))
    assert got.dtype == td
    np.testing.assert_allclose(got.numpy(), want, **tol)
    R, t = T1[:, :3, :3], T1[:, :3, 3]
    np.testing.assert_allclose(
        tgeo.essential_from_relpose(torch.from_numpy(R), torch.from_numpy(t)).numpy(),
        np.asarray(jgeo.essential_from_relpose(jnp.asarray(R), jnp.asarray(t))), **tol)
    # the numpy helper the port already had agrees too
    np.testing.assert_allclose(se3_np.essential_from_poses(T1[0], T2[0]), want[0],
                               rtol=0, atol=1e-5 if dtype == "f32" else 1e-12)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_epipolar_gate_matches_jax(dtype):
    """Rays of true correspondences pass, random pairs mostly do not; the
    boolean is the JAX package's on every pair but those within rounding
    of the threshold (none here)."""
    npd, _, _ = TOL[dtype]
    rng = np.random.default_rng(1)
    T1, T2 = _poses(rng, 2)
    X = rng.uniform(-2, 2, (400, 3)) + [0, 0, 6]
    x1 = X @ T1[:3, :3].T + T1[:3, 3]
    x2 = X @ T2[:3, :3].T + T2[:3, 3]
    r1 = x1 / np.linalg.norm(x1, axis=1, keepdims=True)
    r2 = x2 / np.linalg.norm(x2, axis=1, keepdims=True)
    r2[200:] = rng.normal(size=(200, 3))
    r2[200:] /= np.linalg.norm(r2[200:], axis=1, keepdims=True)
    E = se3_np.essential_from_poses(T1, T2)
    args = [a.astype(npd) for a in (r1, r2, E)]
    for th in (1e-2, 1e-4):
        want = np.asarray(jgeo.check_dist_epipolar_line(*map(jnp.asarray, args), th))
        got = tgeo.check_dist_epipolar_line(*map(torch.from_numpy, args), th)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
    assert want[:200].all() and want[200:].mean() < 0.5


def _rotations(rng):
    """Rotations whose quaternions take each of Shepperd's four branches:
    small ones (trace > 0) and turns near pi about x, y and z."""
    Rs = [se3_np.cayley2rot(rng.normal(0, 0.3, 3)) for _ in range(4)]
    for axis in range(3):
        w = rng.normal(0, 0.2, 3)
        w[axis] = 3.0
        theta = np.linalg.norm(w)
        k = se3_np.skew(w / theta)
        Rs.append(np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * k @ k)
    return np.stack(Rs)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_rot2quat_matches_jax(dtype):
    npd, td, tol = TOL[dtype]
    R = _rotations(np.random.default_rng(2)).astype(npd)
    tr = np.trace(R, axis1=1, axis2=2)
    assert (tr > 0).any() and (tr <= 0).sum() == 3
    want = np.asarray(jgeo.rot2quat(jnp.asarray(R)))
    got = tgeo.rot2quat(torch.from_numpy(R))
    assert got.shape == (7, 4) and got.dtype == td
    np.testing.assert_allclose(got.numpy(), want, **tol)
    np.testing.assert_allclose(got[0].double().numpy(), se3_np.rot2quat(R[0]), rtol=0,
                               atol=1e-6 if dtype == "f32" else 1e-12)


def test_is_in_mirror_mask_matches_jax():
    """Round half to even, the open bounds and the mask, exactly."""
    rng = np.random.default_rng(3)
    mask = (rng.random((30, 40)) < 0.7).astype(np.uint8) * 255
    uv = np.concatenate([rng.uniform(-3, 43, (500, 2)),
                         [[0.5, 5], [1.5, 5], [2.5, 5], [39.5, 5], [5, 29.5], [5, 0.5],
                          [40, 5], [5, 30], [-0.5, 5], [1, 1]]]).astype(np.float32)
    want = np.asarray(jcam.is_in_mirror_mask(jnp.asarray(mask), jnp.asarray(uv)))
    got = tcam.is_in_mirror_mask(torch.from_numpy(mask), torch.from_numpy(uv))
    assert got.dtype == torch.bool and got.shape == (510,)
    np.testing.assert_array_equal(got.numpy(), want)
    got2 = tcam.is_in_mirror_mask(torch.from_numpy(mask), torch.from_numpy(uv).reshape(51, 10, 2))
    np.testing.assert_array_equal(got2.numpy().reshape(-1), want)


@pytest.mark.parametrize("words", [1, 8])
def test_exact_hamming_matches_jax(words):
    rng = np.random.default_rng(4)
    a, b, ma, mb = (rng.integers(0, 2 ** 32, (n, words), dtype=np.uint32)
                    for n in (17, 23, 17, 23))
    b[:5] = a[:5]                       # distance 0 rows
    t = lambda x: torch.from_numpy(x.view(np.int32))
    want = np.asarray(jham.hamming_matrix_exact(jnp.asarray(a), jnp.asarray(b)))
    got = tham.hamming_matrix_exact(t(a), t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tham.hamming_matrix(t(a), t(b)).numpy(), want)
    want_m = np.asarray(jham.hamming_matrix_masked_exact(*map(jnp.asarray, (a, b, ma, mb))))
    got_m = tham.hamming_matrix_masked_exact(t(a), t(b), t(ma), t(mb))
    assert got_m.dtype == torch.int32
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(tham.hamming_matrix_masked(t(a), t(b), t(ma), t(mb)).numpy(),
                                  want_m)
    np.testing.assert_array_equal(tham.to_pm1(t(a)).numpy(),
                                  np.asarray(jham.to_pm1(jnp.asarray(a)), np.float32))


@pytest.mark.parametrize("shape", [(32, 40), (3, 20, 27)])
def test_box_filter_matches_jax(shape):
    """The whole-image filter, and inside its border the patch blur the
    extractor uses."""
    img = np.random.default_rng(5).uniform(0, 255, shape).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jpyr.box_filter(jnp.asarray(img), 5))
    got = tpyr.box_filter(torch.from_numpy(img), 5)
    assert got.shape == img.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    n = min(shape[-2:])                 # a square patch at the corner
    patch = torch.from_numpy(img.reshape((-1,) + shape[-2:])[:, :n, :n].copy())
    inner = tbrief.blur_patches_valid(patch, 5)
    full = got.reshape((-1,) + shape[-2:])[:, 2:n - 2, 2:n - 2]
    np.testing.assert_allclose(inner.numpy(), full.numpy(), rtol=1e-6, atol=1e-4)


def test_ic_angle_and_feature_sizes_match_jax():
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 255, (2, 80, 90)).astype(np.float32)
    yx = rng.integers(16, 64, (2, 12, 2)).astype(np.int32)
    with jax.enable_x64(False):
        want = np.stack([np.asarray(jbrief.ic_angle(jnp.asarray(img[c]), jnp.asarray(yx[c])))
                         for c in range(2)])
    got = tbrief.ic_angle(torch.from_numpy(img), torch.from_numpy(yx))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    z = lambda *s: np.zeros(s, np.float32)
    jf = jext.Features(*(jnp.asarray(z(3, 7, *tail)) for tail in
                         ((2,), (), (), (), (3,), (8,), (8,), ())))
    tf = text.Features(*(torch.zeros(3, 7, *tail) for tail in
                         ((2,), (), (), (), (3,), (8,), (8,), ())))
    assert (tf.n_cams, tf.k_per_cam) == (jf.n_cams, jf.k_per_cam) == (3, 7)


@pytest.mark.parametrize("cam", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_load_interior_orientation_matches_jax(cam, dtype):
    path = f"{tcio.SYNTH_RIG_DIR}/InteriorOrientationFisheye{cam}.yaml"
    npd, td, _ = TOL[dtype]
    jc, jflag = jcio.load_interior_orientation(path, npd)
    tc, tflag = tcio.load_interior_orientation(path, td)
    assert jflag == tflag
    for name, a, b in zip(tc._fields, jc, tc):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        assert b.dtype == td, name


def _clean_scene(n=200):
    """Bearing pairs of a well-conditioned two-view scene (0.4 m baseline,
    points 3-7 m away over a wide field) with no outliers; a tenth of the
    pairs invalid."""
    rng = np.random.default_rng(8)
    X = rng.uniform(-3, 3, (n, 3)) + [0, 0, 5]
    R = se3_np.cayley2rot(np.array([0.03, -0.05, 0.02]))
    t = np.array([0.35, -0.1, 0.15])
    v1 = X / np.linalg.norm(X, axis=1, keepdims=True)
    X2 = (X - t) @ R
    v2 = X2 / np.linalg.norm(X2, axis=1, keepdims=True)
    valid = rng.random(n) < 0.9
    return v1.astype(np.float32), v2.astype(np.float32), valid


def test_ransac_essential_eight_point_matches_jax():
    v1, v2, valid = _clean_scene()
    with jax.enable_x64(False):
        jE, j_inl, j_n = jransac.ransac_essential(jax.random.PRNGKey(0), jnp.asarray(v1),
                                                  jnp.asarray(v2), jnp.asarray(valid),
                                                  sample_size=8, n_hyps=64)
    E, inl, n = transac.ransac_essential(torch.Generator().manual_seed(0),
                                         torch.from_numpy(v1), torch.from_numpy(v2),
                                         torch.from_numpy(valid), sample_size=8, n_hyps=64)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(j_inl))
    assert int(n) == int(j_n) == int(valid.sum())
    a, b = E.numpy(), np.asarray(jE)
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    np.testing.assert_allclose(a, np.sign((a * b).sum()) * b, rtol=0, atol=1e-3)


def test_ransac_essential_eight_point_hypotheses(monkeypatch):
    """The 8-point hypotheses themselves, on the JAX package's draws: the
    same winner's inlier set when the refit is kept out (one hypothesis
    scores best)."""
    v1, v2, valid = _clean_scene(60)
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(False):
        idx = jax.jit(lambda k, w: jransac.sample_minimal_sets(k, 16, 8, len(v1), w))(
            key, jnp.asarray(valid.astype(np.float32)))
        jE, j_inl, j_n = jransac.ransac_essential(key, jnp.asarray(v1), jnp.asarray(v2),
                                                  jnp.asarray(valid), sample_size=8,
                                                  n_hyps=16)
    idx = torch.from_numpy(np.asarray(idx).astype(np.int64))
    monkeypatch.setattr(transac, "sample_minimal_sets", lambda *a, **k: idx)
    E, inl, n = transac.ransac_essential(torch.Generator(), torch.from_numpy(v1),
                                         torch.from_numpy(v2), torch.from_numpy(valid),
                                         sample_size=8, n_hyps=16)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(j_inl))
    assert int(n) == int(j_n)


def _ba_problem(lib):
    """make_ba_problem (6 keyframes, 150 points) with perturbed poses and
    points in float64, in either package."""
    jr, _ = jcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=np.float64)
    rig = tcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=torch.float64)[0]
    mt, X, uv, kf, cam, pt, valid, pt_obs = tsyn.make_ba_problem(rig, 6, 150,
                                                                max_obs_per_pt=4, seed=2)
    rng = np.random.default_rng(9)
    mt0 = mt + rng.normal(0, 0.004, mt.shape)
    mt0[0] = mt[0]
    X0 = X + rng.normal(0, 0.02, X.shape)
    fixed_pt = (pt_obs < len(uv) - 1).sum(1) < 2
    if lib == "jax":
        to = jnp.asarray
        obs = jopt.BAObservations(to(uv), to(kf), to(cam), to(pt), to(np.ones(len(kf))),
                                  to(valid))
        return (jax.tree.map(jnp.asarray, jr), to(mt0), to(X0),
                jopt.BAProblem(obs, to(pt_obs), to(np.arange(6) == 0), to(fixed_pt)))
    to = torch.as_tensor
    obs = topt.BAObservations(to(uv), to(kf), to(cam), to(pt), to(np.ones(len(kf))), to(valid))
    return rig, to(mt0), to(X0), topt.BAProblem(obs, to(pt_obs), to(np.arange(6) == 0),
                                                to(fixed_pt))


@pytest.mark.parametrize("early_stop", [True, False])
def test_bundle_adjustment_early_stop_matches_jax(early_stop):
    """``early_stop=False`` runs every iteration, in both packages: from
    the same start the two land within 1e-8 of each other; with it on, the
    loop stops at the gain test, at another point."""
    iters = 12
    jrig, jmt, jX, jprob = _ba_problem("jax")
    want = jopt.bundle_adjustment(jrig, jmt, jX, jprob, iters=iters, early_stop=early_stop)
    rig, mt, X, prob = _ba_problem("torch")
    got = topt.bundle_adjustment(rig, mt, X, prob, iters=iters, early_stop=early_stop)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-8)
    other = topt.bundle_adjustment(rig, mt, X, prob, iters=iters, early_stop=not early_stop)
    assert not torch.equal(other[1], got[1])


def test_ransac_gpnp_dlt_hypotheses_match_jax(monkeypatch):
    """``ransac_gpnp(sample_size=6)``: one DLT a sample in place of GP3P,
    on the JAX package's draws, in float64: the same inlier set and pose
    within 1e-8."""
    from test_torch_reloc import _scene as reloc_scene

    T, o, d, X, valid, inl = reloc_scene(4, n=100, noise=1e-4)
    key = jax.random.PRNGKey(11)
    w = jnp.asarray(valid.astype(np.float32))
    idx = jax.jit(lambda k, w: jransac.sample_minimal_sets(k, 64, 6, len(X), w))(key, w)
    want_T, want_inl, want_n = jransac.ransac_gpnp(
        key, *(jnp.asarray(a) for a in (o, d, X)), jnp.asarray(valid), n_hyps=64,
        sample_size=6)
    idx = torch.from_numpy(np.asarray(idx).astype(np.int64))
    monkeypatch.setattr(transac, "sample_minimal_sets", lambda *a, **k: idx)
    got_T, got_inl, got_n = transac.ransac_gpnp(
        torch.Generator(), *(torch.from_numpy(a) for a in (o, d, X)), torch.from_numpy(valid),
        n_hyps=64, sample_size=6)
    np.testing.assert_array_equal(got_inl.numpy(), np.asarray(want_inl))
    assert int(got_n) == int(want_n) >= 0.9 * (inl & valid).sum()
    np.testing.assert_allclose(got_T.numpy(), np.asarray(want_T), rtol=0, atol=1e-8)
    assert np.abs(got_T.numpy() - T).max() < 1e-3


@pytest.mark.parametrize("nn_ratio", [None, 0.9])
def test_gated_nn_match_mutual_matches_jax(nn_ratio):
    """``gated_nn_match(mutual=True)``, the cross-check: exact, with ties
    (duplicate columns) and fully gated rows and columns."""
    rng = np.random.default_rng(12)
    dist = rng.integers(0, 40, (30, 25)).astype(np.int32)
    dist[:, 20:] = dist[:, 15:20]
    valid = rng.random((30, 25)) < 0.6
    valid[::7] = False
    valid[:, 3] = False
    want = jham.gated_nn_match(jnp.asarray(dist), jnp.asarray(valid), max_dist=30,
                               nn_ratio=nn_ratio, mutual=True)
    got = tham.gated_nn_match(torch.from_numpy(dist), torch.from_numpy(valid), max_dist=30,
                              nn_ratio=nn_ratio, mutual=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    one_way = tham.gated_nn_match(torch.from_numpy(dist), torch.from_numpy(valid), max_dist=30,
                                  nn_ratio=nn_ratio)[0]
    assert (got[0] >= 0).sum() < (one_way >= 0).sum()
