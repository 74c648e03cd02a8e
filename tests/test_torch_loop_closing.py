"""Loop closing, port against the JAX package, on one map carried across.

The map is built in the JAX package from the port's extraction of
half-width frames of the in-repo rig at their true poses: era A has
keyframes at frames 0, 3, 6 and 9, era B returns over frames 6, 3 and 1.
Every valid feature's landmark is its wall point; a keyframe's feature
takes a landmark of the previous keyframe's era within 1 cm (era B's
first keyframe takes era A's), else a new one, so era B re-observes
era A's places through its own landmarks, as after drift. The port gets
the map through ``convert.map_from_numpy`` and the vocabulary (trained by
the JAX package on keyframe 0) through ``convert.vocabulary_from_numpy``.

Bars, with what was measured on the CPU:
  - SearchByBoW between keyframes and against a frame: identical pairs;
  - ComputeSim3 with the JAX package's RANSAC draws injected
    (``loop_closing.sample_sim3_sets``) and the correction stubbed: the
    same best hypothesis within 1e-4 and the refined S12 within 1e-3 of
    the JAX package's (measured 0 and 6.5e-6), near the keyframes'
    true relative pose (scale within 0.05, rotation within 0.05);
  - the guided SearchBySim3 pairs and the neighbourhood support count at
    the true S12: identical;
  - CorrectLoop on era B drifted by the Sim3 of tests/test_loop_closing.py
    (fuse off): every keyframe pose within 2e-4 and every point within
    5e-4 m of the JAX package's (measured 1.5e-5 and 3.1e-5);
  - the 14-keyframe out-and-back chain of tests/test_loop_closing.py:
    poses within 1e-3 of the JAX package's (measured 7.6e-6), and the
    port repairs the mid keyframe 3x, the mean 5x and the points 3x;
  - DetectLoop over the seven keyframes in order, then forget_keyframe
    and set_vocabulary: identical candidates, consistency groups, BoW
    vectors, inverted file and nodes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multicol_slam_tpu.models import keyframe_database as jkdb
from multicol_slam_tpu.models import loop_closing as jlc
from multicol_slam_tpu.models import map as jmap
from multicol_slam_tpu.models import matcher as jmt
from multicol_slam_tpu.models import sim3_opt as jso
from multicol_slam_tpu.models import vocabulary as jv
from multicol_slam_tpu.ops import sim3 as js3
from multicol_slam_tpu_torch.models import keyframe_database as tkdb
from multicol_slam_tpu_torch.models import loop_closing as tlc
from multicol_slam_tpu_torch.models import matcher as tmt
from multicol_slam_tpu_torch.models import sim3_opt as tso
from multicol_slam_tpu_torch.ops import se3_np
from multicol_slam_tpu_torch.ops import sim3 as ts3
from multicol_slam_tpu_torch.utils import convert
from multicol_slam_tpu_torch.utils import synthetic as tsyn

import _torchutil as U

ERAS = [(0, "A"), (3, "A"), (6, "A"), (9, "A"), (6, "B"), (3, "B"), (1, "B")]
DRIFT = [0.01, -0.01, 0.02, 0.05, 0.08, -0.05, 0.0]   # tests/test_loop_closing.py


@functools.lru_cache(maxsize=None)
def _frames():
    gt, imgs = U.frames(10)
    _, tx = U.extractors()
    return gt, {f: tx(imgs[f]) for f in sorted({f for f, _ in ERAS} | {4})}


def _build_jax_map():
    """The two-era map in a JAX MapStore; returns (map, eras of points)."""
    gt, feats = _frames()
    rig = U.torch_rig()
    C, K = feats[0].valid.shape
    m = jmap.MapStore(capacity_pts=8000, capacity_kfs=16, n_cams=C, k_per_cam=K)
    era_of: dict[int, str] = {}
    prev, prev_era = None, None
    for f, era in ERAS:
        ft = feats[f]
        X = tsyn.wall_points(rig, torch.tensor(gt[f], dtype=torch.float32), ft.ray)[0].numpy()
        kf = m.alloc_keyframe(se3_np.hom2cayley(gt[f]), U.jax_features(ft), f)
        cand = np.zeros(0, np.int64)
        if prev is not None:
            arr = m.kf_pt[prev]
            cand = np.unique(arr[arr >= 0])
            # era B's first keyframe bridges: it takes era A's landmarks
            want = prev_era if era != prev_era else era
            cand = np.asarray([p for p in cand if era_of[int(p)] == want], np.int64)
        used = set()
        valid = ft.valid.numpy()
        for c in range(C):
            for s in np.nonzero(valid[c])[0]:
                p = -1
                if len(cand):
                    d = np.linalg.norm(m.pt_pos[cand] - X[c, s], axis=1)
                    for j in np.argsort(d, kind="stable"):
                        if d[j] > 0.01:
                            break
                        if int(cand[j]) not in used:
                            p = int(cand[j])
                            break
                if p < 0:
                    p = int(m.alloc_points(1)[0])
                    m.pt_pos[p] = X[c, s]
                    m.pt_first_kf[p] = kf
                    era_of[p] = era
                used.add(p)
                m.add_observation(p, kf, c, int(s))
        m.update_spanning_tree(kf)
        prev, prev_era = kf, era
    Mc = rig.M_c.double().numpy()
    m.update_point_stats(m.point_ids(), Mc, U.SCALE_FACTOR, U.N_LEVELS)
    return m, era_of


@functools.lru_cache(maxsize=None)
def _jax_voc():
    _, feats = _frames()
    f = feats[0]
    d = f.desc.reshape(-1, f.desc.shape[-1]).numpy().view(np.uint32)
    return jv.train_vocabulary(d[f.valid.reshape(-1).numpy()], k=8, levels=3, seed=3)


def _closers(prep=None):
    """(JAX closer, port closer, eras of points) on one map; ``prep``
    edits the JAX map before the port gets its copy."""
    jm, era_of = _build_jax_map()
    if prep is not None:
        prep(jm)
    tm = convert.map_from_numpy(jm)
    jrig = jax.tree.map(jnp.asarray, U.jax_rig())
    kw = dict(scale_factor=U.SCALE_FACTOR, n_levels=U.N_LEVELS)
    j = jlc.LoopCloser(jrig, jm, _jax_voc(), jkdb.KeyFrameDatabase(), jmt.MatchParams(), **kw)
    t = tlc.LoopCloser(U.torch_rig(), tm, convert.vocabulary_from_numpy(_jax_voc()),
                       tkdb.KeyFrameDatabase(), tmt.MatchParams(), **kw)
    return j, t, era_of


def test_bow_pairs_identical():
    j, t, _ = _closers()
    n_kf = len(ERAS)
    for a, b in [(0, 1), (0, n_kf - 1), (2, n_kf - 3)]:
        with U.f32():
            want = j._matched_point_pairs(a, b)
        got = t._matched_point_pairs(a, b)
        assert got == want and len(got) >= 15
    # era B's last keyframe re-observes keyframe 0's place through its own
    # landmarks
    loop = t._matched_point_pairs(0, n_kf - 1)
    assert sum(p1 != p2 for p1, p2, *_ in loop) >= 15
    _, feats = _frames()
    with U.f32():
        want = j.bow_match_frame(1, U.jax_features(feats[4]))
    assert t.bow_match_frame(1, feats[4]) == want and len(want) >= 15


def _jax_draws(seed=7):
    """The JAX LoopCloser's Sim3 RANSAC draws (PRNGKey(7), split per call)."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(gen, n_hyps, n):
        with jax.enable_x64(False):       # the draws depend on the int width
            state["key"], k = jax.random.split(state["key"])
            idx = jax.random.randint(k, (n_hyps, 3), 0, n)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))
    return draw


def _true_s12(m, kf1, kf2, module):
    """kf2 body -> kf1 body at the map's poses, as the module's Sim3."""
    M1, M2 = (se3_np.cayley2hom(m.kf_pose[k]) for k in (kf1, kf2))
    T = (np.linalg.inv(M1) @ M2).astype(np.float32)
    if module is ts3:
        return ts3.sim3_from_se3(torch.from_numpy(T))
    return js3.sim3_from_se3(jnp.asarray(T))


def test_compute_sim3_matches_jax(monkeypatch):
    j, t, _ = _closers()
    kf, cand = len(ERAS) - 1, 0
    seen = {"jax": [], "port": []}
    for name, mod, closer in (("jax", jso, j), ("port", tso, t)):
        f = mod.optimize_sim3

        def rec(rig, S0, obs, *a, _f=f, _n=name, **k):
            out = _f(rig, S0, obs, *a, **k)
            seen[_n].append((S0, out[0], int(out[2])))
            return out
        monkeypatch.setattr(mod, "optimize_sim3", rec)
        monkeypatch.setattr(closer, "_correct_loop",
                            lambda a, b, S, _n=name: seen[_n].append(("S12", S)))
    monkeypatch.setattr(tlc, "sample_sim3_sets", _jax_draws())
    with U.f32():
        ok_j = j._compute_sim3_and_correct(kf, cand)
    ok_t = t._compute_sim3_and_correct(kf, cand)
    assert ok_j and ok_t
    assert len(seen["jax"]) == len(seen["port"]) >= 2
    (S0_j, _, n_j), (S0_t, _, n_t) = seen["jax"][0], seen["port"][0]
    for a, b in zip(S0_j, S0_t):       # the same best hypothesis
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    assert n_t == n_j
    S_j, S_t = seen["jax"][-1][1], seen["port"][-1][1]
    for a, b in zip(S_j, S_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)
    true = _true_s12(t.map, kf, cand, ts3)
    assert abs(float(S_t.s) - 1.0) < 0.05
    np.testing.assert_allclose(S_t.R.numpy(), true.R.numpy(), atol=0.05)


def test_guided_pairs_and_support_identical():
    j, t, _ = _closers()
    kf, cand = len(ERAS) - 1, 0
    have = {(a, b) for a, b, *_ in t._matched_point_pairs(kf, cand)}
    with U.f32():
        S_j = _true_s12(j.map, kf, cand, js3)
        want = j._guided_sim3_pairs(kf, cand, S_j, have)
        want_n = j._count_neighborhood_support(kf, cand, S_j)
    S_t = _true_s12(t.map, kf, cand, ts3)
    assert t._guided_sim3_pairs(kf, cand, S_t, have) == want and len(want) >= 3
    assert t._count_neighborhood_support(kf, cand, S_t) == want_n
    # each guided pair's reverse measurement is p2's own observation
    for p1, p2, c1, s1, c2, s2 in want:
        assert (cand, c2, s2) in t.map.pt_obs[p2]


def _drift(m):
    """Every keyframe but the anchor and every point misplaced by DRIFT, as
    tests/test_loop_closing.py injects it (Scw o D, D^-1 x): relative poses
    and pose-point consistency stay exact. Returns the true loop S12 as a
    float32 4x4."""
    kfs = m.keyframe_ids().tolist()
    T = np.linalg.inv(se3_np.cayley2hom(m.kf_pose[kfs[-1]])) @ se3_np.cayley2hom(m.kf_pose[0])
    with jax.enable_x64(True):
        D = js3.sim3_exp(jnp.asarray(DRIFT))
        for k in kfs[1:]:
            M = se3_np.cayley2hom(m.kf_pose[k])
            S = js3.sim3_from_se3(jnp.asarray(np.linalg.inv(M))).compose(D)
            m.kf_pose[k] = se3_np.hom2cayley(np.linalg.inv(np.asarray(S.to_se3())))
        pts = m.point_ids()
        m.pt_pos[pts] = np.asarray(D.inverse().apply(jnp.asarray(m.pt_pos[pts], jnp.float64)),
                                   np.float32)
    m.loop_T = T.astype(np.float32)


def test_correct_loop_matches_jax():
    j, t, _ = _closers(prep=_drift)
    kf, cand = len(ERAS) - 1, 0
    T = j.map.loop_T
    with U.f32():
        j._correct_loop(kf, cand, js3.sim3_from_se3(jnp.asarray(T)))
    t._correct_loop(kf, cand, ts3.sim3_from_se3(torch.from_numpy(T)))
    valid = t.map.kf_valid
    np.testing.assert_allclose(t.map.kf_pose[valid], j.map.kf_pose[valid], atol=2e-4)
    pts = t.map.point_ids()
    np.testing.assert_array_equal(pts, j.map.point_ids())
    np.testing.assert_allclose(t.map.pt_pos[pts], j.map.pt_pos[pts], atol=5e-4)
    assert t.map.kf_loop_edges[kf] == j.map.kf_loop_edges[kf] == {cand}


def _chain_maps():
    """tests/test_loop_closing.py's 14-keyframe out-and-back chain in a JAX
    MapStore, and its copy for the port."""
    from test_loop_closing import TestEssentialGraphDistribution
    with jax.enable_x64(True):
        m, M_true, M_drift, X_true, ids = TestEssentialGraphDistribution()._build_drifted_map()
    return m, convert.map_from_numpy(m), M_true, M_drift, X_true, ids


def test_chain_graph_matches_jax():
    jm, tm, M_true, M_drift, X_true, ids = _chain_maps()
    N = M_true.shape[0]
    jrig = jax.tree.map(jnp.asarray, U.jax_rig())
    j = jlc.LoopCloser(jrig, jm, _jax_voc(), jkdb.KeyFrameDatabase(), jmt.MatchParams())
    t = tlc.LoopCloser(U.torch_rig(), tm, convert.vocabulary_from_numpy(_jax_voc()),
                       tkdb.KeyFrameDatabase(), tmt.MatchParams())
    T = (np.linalg.inv(M_true[N - 1]) @ M_true[0]).astype(np.float32)
    with U.f32():
        j._correct_loop(N - 1, 0, js3.sim3_from_se3(jnp.asarray(T)))
    t._correct_loop(N - 1, 0, ts3.sim3_from_se3(torch.from_numpy(T)))
    np.testing.assert_allclose(tm.kf_pose[:N], jm.kf_pose[:N], atol=1e-3)
    pos = np.stack([se3_np.cayley2hom(tm.kf_pose[k])[:3, 3] for k in range(N)])
    err_after = np.linalg.norm(pos - M_true[:, :3, 3], axis=1)
    err_before = np.linalg.norm(M_drift[:, :3, 3] - M_true[:, :3, 3], axis=1)
    mid = N // 2
    assert err_after[mid] < err_before[mid] / 3.0
    assert err_after.mean() < err_before.mean() / 5.0
    G = len(ids) // N
    A = np.stack([M_drift[g] @ np.linalg.inv(M_true[g]) for g in range(N)])
    X_drift = np.einsum("gij,gpj->gpi", A[:, :3, :3], X_true.reshape(N, G, 3)) + A[:, None, :3, 3]
    pt_before = np.linalg.norm(X_drift.reshape(-1, 3) - X_true, axis=1).mean()
    pt_after = np.linalg.norm(tm.pt_pos[ids] - X_true, axis=1).mean()
    assert pt_after < pt_before / 3.0



def test_detection_and_database_upkeep_match_jax(monkeypatch):
    """DetectLoop over the keyframes in order (the correction stubbed
    out): the same candidates, consistency groups and database at every
    keyframe; then forget_keyframe and set_vocabulary leave the same
    state in both packages."""
    j, t, _ = _closers()
    seen = {"jax": [], "port": []}
    for name, closer in (("jax", j), ("port", t)):
        monkeypatch.setattr(closer, "_compute_sim3_and_correct",
                            lambda kf, cand, _n=name: seen[_n].append((kf, cand)) or False)
    groups = []
    for kf in range(len(ERAS)):
        with U.f32():
            assert not j.insert_keyframe(kf)
        assert not t.insert_keyframe(kf)
        assert t.consistent_groups == j.consistent_groups
        assert t.db.kf_bow == j.db.kf_bow
        groups += t.consistent_groups
    assert seen["port"] == seen["jax"]
    # era B re-observes era A's places: a candidate group forms (measured:
    # keyframe 5 finds keyframe 1, once, so nothing reaches ComputeSim3)
    assert groups
    for closer in (j, t):
        closer.forget_keyframe(2)
    assert t.consistent_groups == j.consistent_groups
    assert dict(t.db.inverted) == dict(j.db.inverted) and 2 not in t.db.kf_bow
    _, feats = _frames()
    d = feats[4].desc.reshape(-1, feats[4].desc.shape[-1]).numpy().view(np.uint32)
    voc = jv.train_vocabulary(d[feats[4].valid.reshape(-1).numpy()], k=6, levels=3, seed=5)
    with U.f32():
        j.set_vocabulary(voc)
    t.set_vocabulary(convert.vocabulary_from_numpy(voc))
    assert t.db.kf_bow == j.db.kf_bow and len(t.db.kf_bow) == len(ERAS) - 1
    for kf in t.db.kf_bow:
        np.testing.assert_array_equal(t.kf_nodes[kf], j.kf_nodes[kf])
