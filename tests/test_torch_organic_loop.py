"""The organic loop closure, port against the JAX package, replayed on the
JAX package's own map at the revisit.

``tests/data/organic_loop_jax_map.npz`` (2,962,224 bytes) was written by
``tools/organic_loop.py --package jax --seeds 3 --save-fixture`` (the
baffle episode on the in-repo rig at 754x480 at the tool's drift, on the
CPU; of seeds 42 and 1-3 the JAX package fired the wide loop at 2 and 3,
and met every bar of tests/test_organic_loop.py at 3 in both of its runs,
at 2 in one run of two: PERF.md, section 6): the JAX map just
before the ``insert_keyframe`` call whose detection led to the wide loop
correction, its pools trimmed to the live rows, and in ``extra`` the
loop closer's state at that moment (the retrained vocabulary, the
keyframe database's keyframes, the consistency groups, ``last_loop_kf``,
the query keyframe and frame, the Sim3 RANSAC key). The map is loaded
into both packages (each package's ``load_map``), the loop closers are
rebuilt from ``extra``, the port's Sim3 RANSAC takes the JAX package's
draws from the saved key, and both replay ``insert_keyframe`` on the query
keyframe: DetectLoop, ComputeSim3 and CorrectLoop with its fuse on.

Bars, with what was measured on the CPU:
  - the loop fires in both;
  - DetectLoop's candidates and the consistency groups identical;
  - the accepted candidate identical;
  - S12 within 1e-3 of the JAX package's (measured 1.8e-7);
  - CorrectLoop's keyframe poses within 2e-4 and points within 5e-4 m
    (measured 1.4e-5 and 1.4e-5 m);
  - the pairs fuse merged (``pt_replaced``) identical but for at most
    MAX_MERGE_DIFF (measured: all 53 identical; one pair apart on a
    fixture of another drift), and the port's fuse on the JAX package's
    fuse inputs identical to the JAX package's (measured identical): the
    float order of the correction moves the fuse's inputs by about 1e-5,
    which can move a candidate across the search radius.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.models import keyframe_database as jkdb
from multicol_slam_tpu.models import local_mapping as jlm
from multicol_slam_tpu.models import loop_closing as jlc
from multicol_slam_tpu.models import matcher as jmt
from multicol_slam_tpu.models import vocabulary as jv
from multicol_slam_tpu.utils import checkpoint as jckpt
from multicol_slam_tpu_torch.models import keyframe_database as tkdb
from multicol_slam_tpu_torch.models import local_mapping as tlm
from multicol_slam_tpu_torch.models import loop_closing as tlc
from multicol_slam_tpu_torch.models import matcher as tmt
from multicol_slam_tpu_torch.models import vocabulary as tv
from multicol_slam_tpu_torch.utils import checkpoint as tckpt
from multicol_slam_tpu_torch.utils import convert, episode

import _torchutil as U

MAX_MERGE_DIFF = 2      # see test_fuse_merges_the_same_points

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "organic_loop_jax_map.npz")


def _vocabulary(v):
    """The fixture's vocabulary as numpy arrays of the JAX package's dtypes."""
    return dict(centroids=np.asarray(v["centroids"], np.uint32),
                children=np.asarray(v["children"], np.int32),
                word_of_node=np.asarray(v["word_of_node"], np.int32),
                weights=np.asarray(v["weights"], np.float32),
                k=v["k"], levels=v["levels"], n_words_=v["n_words_"])


def _closer(module, kdb, lm, voc_mod, rig, m, voc, extra):
    """A loop closer as MultiColSLAM builds it (fuse through the local
    mapper, scale held), its state set from the fixture's ``extra``."""
    settings = episode.SETTINGS
    params = (jmt if module is jlc else tmt).MatchParams()
    mapper = lm.LocalMapper(rig, m, params, scale_factor=U.SCALE_FACTOR,
                            n_levels=settings["n_levels"])
    lc = module.LoopCloser(rig, m, voc, kdb.KeyFrameDatabase(), params, fix_scale=True,
                           fuser=mapper, scale_factor=U.SCALE_FACTOR,
                           n_levels=settings["n_levels"])
    for kf in extra["db_kfs"]:
        lc.db.add(kf, voc_mod.bow_vector(lc.voc, lc._bow_of_kf(kf)[0]))
    lc.consistent_groups = [(set(g), c) for g, c in extra["consistent_groups"]]
    lc.last_loop_kf = extra["last_loop_kf"]
    return lc


def _jax_draws(key):
    """The JAX LoopCloser's Sim3 RANSAC draws from ``key`` on (split per
    call)."""
    state = {"key": jnp.asarray(key, jnp.uint32)}

    def draw(gen, n_hyps, n):
        with jax.enable_x64(False):
            state["key"], k = jax.random.split(state["key"])
            idx = jax.random.randint(k, (n_hyps, 3), 0, n)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))
    return draw


def _replay(lc, lm, seen):
    """insert_keyframe on the query keyframe, recording DetectLoop's
    candidates and groups, CorrectLoop's pair and S12, and the arguments
    and result of its fuse (the last ``fuse_targets_batch`` call)."""
    detect, correct, fuse = lc._detect_loop, lc._correct_loop, lm.fuse_targets_batch

    def rec_fuse(*a, **k):
        out = fuse(*a, **k)
        seen["fuse"] = (a, k, np.asarray(out.cpu() if torch.is_tensor(out) else out))
        return out

    def rec_detect(kf, bow):
        out = detect(kf, bow)
        seen["candidates"].append(list(out))
        seen["groups"].append(sorted((sorted(g), c) for g, c in lc.consistent_groups))
        return out

    def rec_correct(kf, loop_kf, S12):
        seen["pair"] = (kf, loop_kf)
        seen["S12"] = [np.asarray(a.detach().cpu() if torch.is_tensor(a) else a, np.float64)
                       for a in (S12.s, S12.R, S12.t)]
        return correct(kf, loop_kf, S12)

    lc._detect_loop, lc._correct_loop = rec_detect, rec_correct
    lm.fuse_targets_batch = rec_fuse
    replaced = dict(lc.map.pt_replaced)
    try:
        seen["fired"] = lc.insert_keyframe(seen["query"])
    finally:
        lm.fuse_targets_batch = fuse
    seen["merged"] = {a: b for a, b in lc.map.pt_replaced.items() if a not in replaced}


@pytest.fixture(scope="module")
def replayed():
    jm, extra = jckpt.load_map(FIXTURE)
    tm, _ = tckpt.load_map(FIXTURE, device="cpu")
    voc = _vocabulary(extra["vocabulary"])
    with U.f32():
        jvoc = jv.Vocabulary(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                for k, v in voc.items()})
        j = _closer(jlc, jkdb, jlm, jv, jax.tree.map(jnp.asarray, U.full_jax_rig()), jm,
                    jvoc, extra)
        j.key = jnp.asarray(extra["jax_key"], jnp.uint32)
    t = _closer(tlc, tkdb, tlm, tv, U.full_torch_rig(), tm,
                convert.vocabulary_from_numpy(voc), extra)
    seen = {n: dict(query=extra["query_kf"], candidates=[], groups=[]) for n in ("jax", "port")}
    with U.f32():
        _replay(j, jlm, seen["jax"])
    draws = tlc.sample_sim3_sets
    tlc.sample_sim3_sets = _jax_draws(extra["jax_key"])
    try:
        _replay(t, tlm, seen["port"])
    finally:
        tlc.sample_sim3_sets = draws
    return jm, tm, seen


def test_the_loop_fires_in_both(replayed):
    _, _, seen = replayed
    assert seen["jax"]["fired"] and seen["port"]["fired"]


def test_detect_loop_identical(replayed):
    _, _, seen = replayed
    assert seen["port"]["candidates"] == seen["jax"]["candidates"]
    assert seen["port"]["candidates"][0]
    assert seen["port"]["groups"] == seen["jax"]["groups"]


def test_the_accepted_candidate_and_s12(replayed):
    jm, _, seen = replayed
    assert seen["port"]["pair"] == seen["jax"]["pair"]
    kf, loop_kf = seen["port"]["pair"]
    assert jm.kf_frame_id[kf] > jm.kf_frame_id[loop_kf] + 20
    for a, b in zip(seen["port"]["S12"], seen["jax"]["S12"]):
        np.testing.assert_allclose(a, b, atol=1e-3)


def test_correct_loop_moves_the_map_alike(replayed):
    """Every keyframe pose, and every landmark both maps keep, alike; the
    landmarks only one keeps are the ones fuse merged differently."""
    jm, tm, seen = replayed
    valid = tm.kf_valid
    np.testing.assert_array_equal(valid, jm.kf_valid)
    np.testing.assert_allclose(tm.kf_pose[valid], jm.kf_pose[valid], atol=2e-4)
    pts = np.intersect1d(tm.point_ids(), jm.point_ids())
    np.testing.assert_allclose(tm.pt_pos[pts], jm.pt_pos[pts], atol=5e-4)
    one_side = set(np.setxor1d(tm.point_ids(), jm.point_ids()).tolist())
    mj, mt = seen["jax"]["merged"], seen["port"]["merged"]
    assert one_side <= {a for a in set(mj) ^ set(mt)}
    kf, loop_kf = seen["port"]["pair"]
    assert loop_kf in tm.kf_loop_edges[kf] and loop_kf in jm.kf_loop_edges[kf]


def test_fuse_merges_the_same_points(replayed):
    """The merges of CorrectLoop's SearchAndFuse agree but for at most
    MAX_MERGE_DIFF pairs: the fuse's inputs (the corrected poses and
    landmarks) differ by about 1e-5 between the packages' float orders,
    which can move a candidate across the search radius or the level
    window;
    on the JAX package's own fuse inputs the port's fuse returns the JAX
    package's matches exactly."""
    _, _, seen = replayed
    mj, mt = seen["jax"]["merged"], seen["port"]["merged"]
    diff = {a for a in set(mj) | set(mt) if mj.get(a) != mt.get(a)}
    assert len(diff) <= MAX_MERGE_DIFF and len(mj) >= 5, (mj, mt)
    a, k, want = seen["jax"]["fuse"]
    args = [U.full_torch_rig()] + [
        convert.features_from_numpy(x) if i == 1 else
        torch.from_numpy(np.array(np.asarray(x))).view(torch.int32)
        if np.asarray(x).dtype == np.uint32 else torch.from_numpy(np.array(np.asarray(x)))
        for i, x in enumerate(a[1:11])] + list(a[11:])
    args[11] = seen["port"]["fuse"][0][11]           # the port's MatchParams
    got = tlm.fuse_targets_batch(*args, **k).numpy()
    np.testing.assert_array_equal(got, want)
