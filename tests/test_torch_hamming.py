"""The port's Hamming core and gated nearest-neighbour wrapper against the
JAX package.

``hamming_nn_reference`` (the plain version the wrapper takes for CPU
tensors) must equal the Pallas kernels of
multicol_slam_tpu/ops/pallas/hamming_nn.py, run in interpret mode as
tests/test_pallas_hamming.py runs them, on the same five cases: random,
fully gated rows, fuse, masked, masked-exact. Every comparison here is
on integers and is exact.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.ops import hamming as jhm
from multicol_slam_tpu_torch.kernels import hamming_nn as knn
from multicol_slam_tpu_torch.ops import hamming as thm

from _torchutil import f32


def _interpret():
    from jax.experimental.pallas import tpu as pltpu
    if jax.default_backend() == "tpu":
        return contextlib.nullcontext()
    return pltpu.force_tpu_interpret_mode()


def _words(rng, shape):
    """Random packed words: (uint32 for JAX, int32 bit patterns for the port)."""
    u = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    return jnp.asarray(u), torch.from_numpy(u.view(np.int32).copy())


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _pallas(q, db, gate, qm=None, dbm=None):
    from multicol_slam_tpu.ops.pallas import hamming_nn as pnn
    with f32(), _interpret():
        if qm is None:
            return pnn.fused_hamming_nn(q, db, gate)
        return pnn.fused_hamming_nn_masked(q, qm, db, dbm, gate)


def test_pack_unpack_match_jax():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (5, 7, 256)).astype(np.uint8)
    with f32():
        j = np.asarray(jhm.pack_bits_u32(jnp.asarray(bits)))
    t = thm.pack_bits_u32(torch.from_numpy(bits))
    np.testing.assert_array_equal(t.numpy().view(np.uint32), j)
    np.testing.assert_array_equal(thm.unpack_bits_u32(t).numpy(), bits)


@pytest.mark.parametrize("masked", [False, True])
def test_distance_matrix_matches_integer_reference(masked):
    rng = np.random.default_rng(4)
    ja, ta = _words(rng, (2, 40, 8))
    jb, tb = _words(rng, (2, 56, 8))
    jma, tma = _words(rng, (2, 40, 8))
    jmb, tmb = _words(rng, (2, 56, 8))
    for c in range(2):
        if masked:
            want = jhm.hamming_matrix_masked_exact(ja[c], jb[c], jma[c], jmb[c])
            got = thm.hamming_matrix_masked(ta, tb, tma, tmb)[c]
        else:
            want = jhm.hamming_matrix_exact(ja[c], jb[c])
            got = thm.hamming_matrix(ta, tb)[c]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_argmin2_ratio_and_duplicates_match_jax():
    """Distances from a small range, so ties and duplicate targets are
    common: ties go to the lowest index in both packages."""
    rng = np.random.default_rng(5)
    C, N, M = 3, 64, 48
    dist = rng.integers(0, 6, (C, N, M)).astype(np.int32)
    gate = rng.random((C, N, M)) < 0.3
    gate[:, :5] = False                        # fully gated rows
    t_idx, t_best, t_sec = thm.masked_argmin2(torch.from_numpy(dist),
                                              torch.from_numpy(gate))
    t_match, t_bd = thm.gated_nn_match(torch.from_numpy(dist),
                                       torch.from_numpy(gate),
                                       max_dist=3, nn_ratio=0.9)
    t_res = thm.resolve_duplicate_targets(t_match, t_bd, M)
    with f32():
        for c in range(C):
            d, g = jnp.asarray(dist[c]), jnp.asarray(gate[c])
            _assert_same((t_idx[c], t_best[c], t_sec[c]),
                         jhm.masked_argmin2(d, g))
            j_match, j_bd = jhm.gated_nn_match(d, g, max_dist=3, nn_ratio=0.9)
            _assert_same((t_match[c], t_bd[c]), (j_match, j_bd))
            np.testing.assert_array_equal(
                t_res[c].numpy(),
                np.asarray(jhm.resolve_duplicate_targets(j_match, j_bd, M)))
    assert (t_res >= 0).sum() < (t_match >= 0).sum()   # duplicates existed


def test_reference_matches_pallas_random():
    rng = np.random.default_rng(0)
    N, M = 256, 512
    jq, tq = _words(rng, (N, 8))
    jdb, tdb = _words(rng, (M, 8))
    gate = rng.random((N, M)) < 0.7
    want = _pallas(jq, jdb, jnp.asarray(gate))
    got = knn.hamming_nn_reference(tq[None], tdb[None],
                                   torch.from_numpy(gate)[None])
    _assert_same([g[0] for g in got], want)


def test_reference_matches_pallas_fully_gated_rows():
    rng = np.random.default_rng(1)
    jq, tq = _words(rng, (128, 8))
    jdb, tdb = _words(rng, (256, 8))
    gate = np.zeros((128, 256), bool)
    gate[:64] = True
    want = _pallas(jq, jdb, jnp.asarray(gate))
    got = knn.hamming_nn(tq[None], tdb[None], torch.from_numpy(gate)[None])
    _assert_same([g[0] for g in got], want)
    assert (got[0][0, 64:] == -1).all() and (got[0][0, :64] >= 0).all()
    assert (got[1][0, 64:] == thm.INVALID).all()


def test_fuse_through_wrapper_matches_pallas_fuse():
    """The JAX fuse pass routed through its Pallas kernel, against the
    same gate reduced by the port's wrapper for both cameras in one call."""
    from multicol_slam_tpu.models import matcher as jm
    from multicol_slam_tpu.models.extractor import Features as JFeatures

    rng = np.random.default_rng(2)
    C, K, P, W = 2, 300, 256, 8
    xy = rng.uniform(0, 700, (C, K, 2)).astype(np.float32)
    level = rng.integers(0, 4, (C, K)).astype(np.int32)
    valid = rng.random((C, K)) < 0.9
    jdesc, tdesc = _words(rng, (C, K, W))
    uv = rng.uniform(0, 700, (C, P, 2)).astype(np.float32)
    # half the points are noisy copies of camera 0's keypoints, placed
    # near them, so the TH_LOW gate passes real matches
    src = rng.choice(K, P // 2, replace=False)
    flips = (rng.random((P // 2, W, 32)) < 0.05).astype(np.uint64)
    noise = (flips << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    pd = rng.integers(0, 2 ** 32, (P, W), dtype=np.uint32)
    pd[:P // 2] = np.asarray(jdesc)[0, src] ^ noise
    uv[0, :P // 2] = xy[0, src] + rng.normal(0, 5, (P // 2, 2))
    jpd, tpd = jnp.asarray(pd), torch.from_numpy(pd.view(np.int32).copy())
    ok = rng.random((C, P)) < 0.8
    plvl = rng.integers(0, 4, (C, P)).astype(np.int32)
    params = jm.MatchParams(desc_bytes=32)
    feats = JFeatures(
        xy=jnp.asarray(xy), level=jnp.asarray(level),
        angle=jnp.zeros((C, K)), response=jnp.zeros((C, K)),
        ray=jnp.zeros((C, K, 3)), desc=jdesc,
        desc_mask=jnp.full((C, K, W), 0xFFFFFFFF, jnp.uint32),
        valid=jnp.asarray(valid))
    with f32(), _interpret():
        want = np.asarray(jm.fuse_candidates_fused(
            feats, jnp.zeros((C, K), bool), jpd,
            jnp.full((P, W), 0xFFFFFFFF, jnp.uint32), jnp.asarray(uv),
            jnp.asarray(ok), jnp.asarray(plvl), params, th=30.0))

    t_xy, t_uv = torch.from_numpy(xy), torch.from_numpy(uv)
    t_lvl, t_plvl = torch.from_numpy(level), torch.from_numpy(plvl)
    radius = 30.0 * 1.2 ** t_plvl.to(torch.float32)
    gate = ((t_xy[:, None] - t_uv[:, :, None]) ** 2).sum(-1) <= (radius ** 2)[..., None]
    gate &= ((t_lvl[:, None] >= t_plvl[..., None] - 1)
             & (t_lvl[:, None] <= t_plvl[..., None] + 1))
    gate &= torch.from_numpy(valid)[:, None] & torch.from_numpy(ok)[..., None]
    idx, best, second = knn.hamming_nn(tpd.expand(C, P, W).contiguous(),
                                       tdesc, gate)
    got = thm.resolve_duplicate_targets(
        thm.nn_accept(idx, best, second, params.th_low), best, K)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 20          # the case exercises real matches


def test_reference_matches_pallas_masked():
    rng = np.random.default_rng(7)
    N, M = 256, 512
    jq, tq = _words(rng, (N, 8))
    jqm, tqm = _words(rng, (N, 8))
    jdb, tdb = _words(rng, (M, 8))
    jdbm, tdbm = _words(rng, (M, 8))
    gate = rng.random((N, M)) < 0.7
    want = _pallas(jq, jdb, jnp.asarray(gate), jqm, jdbm)
    got = knn.hamming_nn_reference(tq[None], tdb[None],
                                   torch.from_numpy(gate)[None],
                                   tqm[None], tdbm[None])
    _assert_same([g[0] for g in got], want)


def test_reference_masked_exact_vs_integer_reference():
    """The masked plain version against argmin2 over the JAX package's
    exact XOR+popcount masked distance."""
    rng = np.random.default_rng(11)
    ja, ta = _words(rng, (64, 8))
    jb, tb = _words(rng, (96, 8))
    jma, tma = _words(rng, (64, 8))
    jmb, tmb = _words(rng, (96, 8))
    gate = rng.random((64, 96)) < 0.5
    with f32():
        d = jhm.hamming_matrix_masked_exact(ja, jb, jma, jmb)
        w_idx, w_best, w_sec = jhm.masked_argmin2(d, jnp.asarray(gate))
        w_idx = jnp.where(w_best >= jhm.INVALID, -1, w_idx)
    got = knn.hamming_nn_reference(ta[None], tb[None],
                                   torch.from_numpy(gate)[None],
                                   tma[None], tmb[None])
    _assert_same([g[0] for g in got], (w_idx, w_best, w_sec))


@pytest.mark.parametrize("bad", ["dtype", "shape", "one_mask", "gate_dtype"])
def test_wrapper_rejects_bad_inputs(bad):
    q = torch.zeros((2, 4, 8), dtype=torch.int32)
    db = torch.zeros((2, 5, 8), dtype=torch.int32)
    gate = torch.ones((2, 4, 5), dtype=torch.bool)
    args = dict(dtype=(q.to(torch.int64), db, gate),
                shape=(q, db[:, :, :4], gate),
                one_mask=(q, db, gate, q),
                gate_dtype=(q, db, gate.to(torch.float32)))[bad]
    with pytest.raises((TypeError, ValueError)):
        knn.hamming_nn(*args)
