"""Relocalization's pieces, port against the JAX package: the GP3P and
DLT absolute-pose solvers and their RANSAC on a synthetic rig scene, the
relocalization projection search and the two SearchByBoW sites on the
port's extraction of half-width frames of the in-repo rig.

Bars, with what was measured on the CPU:
  - ``gp3p`` per lane: the same converged lanes (residual <= 1e-4) and
    their poses within 1e-9 in float64 (measured 1.8e-13);
  - ``gpnp_dlt``: the pose within 1e-8 in float64 (measured 9.3e-15);
  - ``ransac_gpnp`` in float32 with the JAX package's 3-point samples
    injected (``_torchutil.JaxMinimalSets``): the identical inlier mask,
    the pose within 2e-3 (measured 1.5e-7; the DLT refit's 12x12 normal
    equations in float32 carry the square of the design's condition
    number) and within 5 mm of the truth (measured 3.5e-5 m);
  - ``reloc_projection_match`` and both SearchByBoW sites (keyframe
    against keyframe: landmark slots on both sides; keyframe against a
    frame: landmark slots against valid features; both gated to equal
    depth-1 vocabulary nodes): identical indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.models import matcher as jm
from multicol_slam_tpu.models import vocabulary as jv
from multicol_slam_tpu.ops import hamming as jh
from multicol_slam_tpu.ops import ransac as jr
from multicol_slam_tpu_torch.kernels import hamming_nn as knn
from multicol_slam_tpu_torch.models import matcher as tm
from multicol_slam_tpu_torch.models import tracking as ttrk
from multicol_slam_tpu_torch.models import vocabulary as tv
from multicol_slam_tpu_torch.ops import ransac as tr
from multicol_slam_tpu_torch.ops import se3_np
from multicol_slam_tpu_torch.ops.geometry import hom2cayley
from multicol_slam_tpu_torch.utils import convert
from multicol_slam_tpu_torch.utils import synthetic as tsyn

import _torchutil as U


def _scene(seed, n=120, out_frac=0.25, noise=0.0):
    """Body-frame rays of n world points from the rig's camera centres at
    a true world->body pose; a quarter replaced by random rays."""
    rng = np.random.default_rng(seed)
    Mc = U.torch_rig().M_c.double().numpy()
    T = se3_np.cayley2hom(np.array([0.05, -0.1, 0.2, 0.4, -0.3, 0.2]))
    cams = rng.integers(0, 3, n)
    o = Mc[cams, :3, 3]
    q = o + rng.normal(size=(n, 3)) * 2.0            # body-frame points
    X = (q - T[:3, 3]) @ T[:3, :3]                    # world points
    d = q - o + rng.normal(size=(n, 3)) * noise
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    out = rng.random(n) < out_frac
    d[out] = rng.normal(size=(int(out.sum()), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    valid = rng.random(n) < 0.95
    return T, o, d, X, valid, ~out


def test_gp3p_matches_jax():
    T, o, d, X, _, inl = _scene(0)
    rng = np.random.default_rng(1)
    idx = rng.choice(np.nonzero(inl)[0], (16, 3))
    seeds = np.repeat(np.array(tr.DEPTH_SEEDS), 3).reshape(-1, 3)
    lanes = lambda a: np.repeat(a[idx], len(seeds), 0)        # (16 * 4, 3, 3)
    d0 = np.tile(seeds, (16, 1))
    got_T, got_r = tr.gp3p(*(torch.from_numpy(lanes(a)) for a in (o, d, X)),
                           torch.from_numpy(d0))
    with jax.enable_x64(True):
        want_T, want_r = jax.vmap(jr.gp3p)(*(jnp.asarray(lanes(a)) for a in (o, d, X)),
                                           jnp.asarray(d0))
    conv = np.asarray(want_r) <= 1e-4
    np.testing.assert_array_equal(got_r.numpy() <= 1e-4, conv)
    assert conv.sum() >= 16
    np.testing.assert_allclose(got_T.numpy()[conv], np.asarray(want_T)[conv], atol=1e-9)
    # a converged lane is the true pose or another root of the octic
    assert min(np.abs(got_T.numpy()[c] - T).max() for c in np.nonzero(conv)[0]) < 1e-8


def test_gpnp_dlt_matches_jax():
    T, o, d, X, _, inl = _scene(2, noise=1e-3)
    sel = np.nonzero(inl)[0][:12]
    got = tr.gpnp_dlt(*(torch.from_numpy(a[sel]) for a in (o, d, X))).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jr.gpnp_dlt(*(jnp.asarray(a[sel]) for a in (o, d, X))))
    np.testing.assert_allclose(got, want, atol=1e-8)
    assert np.abs(got - T).max() < 0.05


def test_ransac_gpnp_matches_jax(monkeypatch):
    T, o, d, X, valid, inl = _scene(3, n=128, noise=2e-4)
    f32 = lambda a: a.astype(np.float32)
    monkeypatch.setattr(tr, "sample_minimal_sets", U.JaxMinimalSets(seed=5))
    gen = torch.Generator().manual_seed(0)
    got_T, got_inl, got_n = tr.ransac_gpnp(gen, *(torch.from_numpy(f32(a)) for a in (o, d, X)),
                                           torch.from_numpy(valid), n_hyps=256)
    _, key = jax.random.split(jax.random.PRNGKey(5))
    with U.f32():
        want_T, want_inl, want_n = jr.ransac_gpnp(
            key, *(jnp.asarray(f32(a)) for a in (o, d, X)), jnp.asarray(valid),
            n_hyps=256, sample_size=3)
    np.testing.assert_array_equal(got_inl.numpy(), np.asarray(want_inl))
    assert int(got_n) == int(want_n) >= 0.9 * (inl & valid).sum()
    np.testing.assert_allclose(got_T.numpy(), np.asarray(want_T), atol=2e-3)
    assert np.abs(got_T.numpy()[:3, 3] - T[:3, 3]).max() < 5e-3


@pytest.mark.parametrize("masked", [False, True])
def test_reloc_projection_match_matches_jax(masked):
    gt, imgs = U.frames(2)
    _, tx = U.extractors()
    last, cur = tx(imgs[0]), tx(imgs[1])
    rig = U.torch_rig()
    st = tsyn.gt_bootstrap(rig, torch.tensor(gt[0], dtype=torch.float32), last,
                           U.N_LEVELS, U.SCALE_FACTOR)
    # a pose 2 cm off the truth, as a relocalization's refined pose
    M = gt[1].copy()
    M[:3, 3] += [0.02, -0.01, 0.0]
    uv, ok, lvl, _ = ttrk.frustum_check(rig, hom2cayley(torch.tensor(M, dtype=torch.float32)),
                                        st["X"], st["normal"], st["mind"], st["maxd"],
                                        n_levels=U.N_LEVELS, scale_factor=U.SCALE_FACTOR,
                                        dist_slack=4.0)
    rng = np.random.default_rng(6)
    ok = ok & st["cand_base"][None] & torch.from_numpy(rng.random(ok.shape[1]) < 0.7)
    has = torch.from_numpy(rng.random(cur.valid.shape) < 0.3)
    pt_mask = st["pt_mask"]
    if masked:
        m = rng.integers(0, 2 ** 32, pt_mask.shape, dtype=np.uint32)
        pt_mask = torch.from_numpy((m | rng.integers(0, 2 ** 32, m.shape, dtype=np.uint32))
                                   .view(np.int32))
        cur = cur._replace(desc_mask=torch.from_numpy(
            rng.integers(0, 2 ** 32, cur.desc.shape, dtype=np.uint32).view(np.int32)))
    orb = 50 if masked else 100
    got = tm.reloc_projection_match(cur, has, st["pt_desc"], pt_mask, uv, ok, lvl,
                                    tm.MatchParams(masked=masked), th=10.0, orb_dist=orb)
    with U.f32():
        want = jm.reloc_projection_match(
            U.jax_features(cur), U.to_jax(has), U.to_jax_u32(st["pt_desc"]),
            U.to_jax_u32(pt_mask), U.to_jax(uv), U.to_jax(ok), U.to_jax(lvl),
            jm.MatchParams(masked=masked), th=10.0, orb_dist=orb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() > 50
    # only free slots are matched
    c, p = np.nonzero(got.numpy() >= 0)
    assert not has.numpy()[c, got.numpy()[c, p]].any()


def _bow_dense_jax(d1, ok1, n1, d2, ok2, n2, th_low):
    """The JAX package's SearchByBoW body (loop_closing.py:267-274)."""
    dist = jh.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2))
    gate = jnp.asarray(ok1)[:, None] & jnp.asarray(ok2)[None, :]
    gate &= jnp.asarray(n1)[:, None] == jnp.asarray(n2)[None, :]
    match, best = jh.gated_nn_match(dist, gate, max_dist=th_low, nn_ratio=0.75)
    return np.asarray(jh.resolve_duplicate_targets(match, best, d2.shape[0]))


@pytest.mark.parametrize("site", ["keyframe", "frame"])
def test_search_by_bow_matches_the_jax_dense_path(site):
    _, imgs = U.frames(2)
    _, tx = U.extractors()
    f0, f1 = tx(imgs[0]), tx(imgs[1])
    W = f0.desc.shape[-1]
    flat = lambda f: (f.desc.reshape(-1, W), f.valid.reshape(-1))
    (d0, v0), (d1, v1) = flat(f0), flat(f1)
    voc = tv.train_vocabulary(d0.numpy()[v0.numpy()], k=8, levels=3, seed=3)
    n0 = tv.transform_words(voc, d0, v0, levelsup=voc.levels - 1)[1]
    n1 = tv.transform_words(voc, d1, v1, levelsup=voc.levels - 1)[1]
    rng = np.random.default_rng(8)
    has0 = v0 & torch.from_numpy(rng.random(v0.shape) < 0.6)     # landmark slots
    ok1 = v1 & torch.from_numpy(rng.random(v1.shape) < 0.6) if site == "keyframe" else v1
    before = knn.hamming_nn_radius.launches
    got = tm.search_by_bow(d0, has0, n0, d1, ok1, n1, tm.MatchParams())
    assert knn.hamming_nn_radius.launches == before       # CPU: the plain version
    with U.f32():
        want = _bow_dense_jax(d0.numpy().view(np.uint32), has0.numpy(), n0.numpy(),
                              d1.numpy().view(np.uint32), ok1.numpy(), n1.numpy(),
                              jm.MatchParams().th_low)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).sum() > 50
    # the node gate holds for every match
    sel = got.numpy() >= 0
    np.testing.assert_array_equal(n0.numpy()[sel], n1.numpy()[got.numpy()[sel]])
    # and the JAX vocabulary gives the same nodes
    jvoc = jv.Vocabulary(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                            for k, v in convert.vocabulary_to_numpy(voc).items()})
    np.testing.assert_array_equal(
        np.asarray(jv.transform_words(jvoc, jnp.asarray(d1.numpy().view(np.uint32)),
                                      jnp.asarray(v1.numpy()), levelsup=2)[1]), n1.numpy())
