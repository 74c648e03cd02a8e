"""The port's vocabulary and keyframe database against the JAX package:
the same descriptors (the port's extraction of two half-width frames of
the in-repo rig) train both trees, descend both, and feed both databases.

Bars (all exact; measured exact on the CPU):
  - ``train_vocabulary``: centroids, child table, word table and idf
    weights bit-identical, with and without per-document idf;
  - ``transform_words``: identical words and nodes at every ``levelsup``,
    with invalid rows;
  - ``bow_vector`` equal entries, ``bow_score_l1`` equal;
  - ``KeyFrameDatabase``: identical loop and relocalization candidates on
    one map carried across with ``convert.map_from_numpy``, before and
    after an erase;
  - the npz format and a DBoW2 OpenCV-YAML file (written by the test from
    a trained tree) load to the same tree in both packages, and the YAML
    tree describes words as the trained one does.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.models import keyframe_database as jkdb
from multicol_slam_tpu.models import map as jmap
from multicol_slam_tpu.models import vocabulary as jv
from multicol_slam_tpu_torch.models import keyframe_database as tkdb
from multicol_slam_tpu_torch.models import vocabulary as tv
from multicol_slam_tpu_torch.utils import convert

import _torchutil as U


@functools.lru_cache(maxsize=None)
def _descs():
    """(frame 0's valid descriptors, frame 1's descriptors (all slots) and
    validity) as uint32 numpy."""
    _, frames = U.frames(2)
    _, tx = U.extractors()
    out = []
    for i in range(2):
        f = tx(frames[i])
        d = f.desc.reshape(-1, f.desc.shape[-1]).numpy().view(np.uint32)
        out.append((d, f.valid.reshape(-1).numpy()))
    return out[0][0][out[0][1]], out[1][0], out[1][1]


def _same_tree(j, t):
    np.testing.assert_array_equal(np.asarray(j.centroids),
                                  t.centroids.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(j.children), t.children.numpy())
    np.testing.assert_array_equal(np.asarray(j.word_of_node), t.word_of_node.numpy())
    np.testing.assert_array_equal(np.asarray(j.weights), t.weights.numpy())
    assert (j.k, j.levels, j.n_words) == (t.k, t.levels, t.n_words)


@pytest.mark.parametrize("docs", [False, True])
def test_train_vocabulary_is_bit_identical(docs):
    d0, _, _ = _descs()
    doc_ids = (np.arange(len(d0)) % 7) if docs else None
    j = jv.train_vocabulary(d0, k=8, levels=3, seed=3, doc_ids=doc_ids)
    t = tv.train_vocabulary(d0, k=8, levels=3, seed=3, doc_ids=doc_ids)
    _same_tree(j, t)
    assert t.n_words > 100


@functools.lru_cache(maxsize=None)
def _trees():
    d0, _, _ = _descs()
    j = jv.train_vocabulary(d0, k=8, levels=3, seed=3)
    return j, convert.vocabulary_from_numpy(j)


@pytest.mark.parametrize("levelsup", [0, 1, 2, 5])
def test_transform_words_identical(levelsup):
    j, t = _trees()
    _, d1, v1 = _descs()
    v1 = v1.copy()
    v1[::9] = False
    wj, nj = jv.transform_words(j, jnp.asarray(d1), jnp.asarray(v1), levelsup=levelsup)
    wt, nt = tv.transform_words(t, torch.from_numpy(d1.view(np.int32)),
                                torch.from_numpy(v1), levelsup=levelsup)
    np.testing.assert_array_equal(np.asarray(wj), wt.numpy())
    np.testing.assert_array_equal(np.asarray(nj), nt.numpy())
    assert (wt.numpy()[~v1] == -1).all() and (wt.numpy()[v1] >= 0).all()


def test_bow_vector_and_score_equal():
    j, t = _trees()
    d0, d1, v1 = _descs()
    wj = np.asarray(jv.transform_words(j, jnp.asarray(d1), jnp.asarray(v1))[0])
    w0 = np.asarray(jv.transform_words(j, jnp.asarray(d0),
                                       jnp.ones(len(d0), bool))[0])
    bj, bt = jv.bow_vector(j, wj), tv.bow_vector(t, wj)
    assert bj == bt and len(bt) > 50
    b0 = tv.bow_vector(t, w0)
    assert jv.bow_score_l1(bj, jv.bow_vector(j, w0)) == tv.bow_score_l1(bt, b0)
    assert 0.0 < tv.bow_score_l1(bt, b0) < 1.0
    assert tv.bow_score_l1(bt, bt) == pytest.approx(1.0)


def _db_map():
    """A JAX MapStore of 12 keyframes whose points make a covisibility
    chain (neighbours share 40 points, next-but-one 20), and each
    keyframe's BoW of 60 words drawn around its place (keyframes 0-1 and
    10-11 share a place)."""
    rng = np.random.default_rng(0)
    n_kf = 12
    m = jmap.MapStore(capacity_pts=2000, capacity_kfs=16, n_cams=1, k_per_cam=200)
    for k in range(n_kf):
        m.alloc_keyframe(np.zeros(6), None, k)
    for k in range(n_kf - 1):
        for share, other in ((40, k + 1), (20, k + 2)):
            if other >= n_kf:
                continue
            ids = m.alloc_points(share)
            base = (other - k) * 60
            for i, p in enumerate(ids):
                m.add_observation(int(p), k, 0, base + i + (k % 2) * 40)
                m.add_observation(int(p), other, 0, i)
    place = [k % 10 for k in range(n_kf)]
    words = [np.concatenate([rng.integers(0, 300, 40) + 300 * place[k],
                             rng.integers(0, 3000, 20)]) for k in range(n_kf)]
    return m, words


def test_keyframe_database_candidates_identical():
    j, t = _trees()
    jm, words = _db_map()
    tm = convert.map_from_numpy(jm)
    # a vocabulary with 3000 words of unit weight for the hand-made BoWs
    voc_j = j._replace(n_words_=3000, weights=jnp.ones(3000, jnp.float32))
    voc_t = t._replace(n_words_=3000, weights=torch.ones(3000))
    dbs = (jkdb.KeyFrameDatabase(), tkdb.KeyFrameDatabase())
    bows = [jv.bow_vector(voc_j, w) for w in words]
    assert bows == [tv.bow_vector(voc_t, w) for w in words]
    for k in range(10):
        for db in dbs:
            db.add(k, bows[k])
    for erase in (None, 4):
        if erase is not None:
            for db in dbs:
                db.erase(erase)
        for k in (10, 11):
            conn_j, conn_t = set(jm.connected_keyframes(k)), set(tm.connected_keyframes(k))
            assert conn_j == conn_t
            lj = dbs[0].detect_loop_candidates(k, bows[k], 0.01, jm, conn_j)
            lt = dbs[1].detect_loop_candidates(k, bows[k], 0.01, tm, conn_t)
            assert lj == lt and lt
            assert dbs[0].detect_reloc_candidates(bows[k], jm) == \
                dbs[1].detect_reloc_candidates(bows[k], tm)
        assert dbs[0].detect_reloc_candidates(bows[10], jm)
    for db in dbs:
        db.clear()
        assert not db.kf_bow and not db.inverted


def test_npz_round_trip_between_packages(tmp_path):
    j, t = _trees()
    p = str(tmp_path / "voc_port.npz")
    tv.save_vocabulary(t, p)
    _same_tree(jv.load_vocabulary(p), tv.load_vocabulary(p))
    _same_tree(j, tv.load_vocabulary(p))
    q = str(tmp_path / "voc_jax.npz")
    jv.save_vocabulary(j, q)
    _same_tree(j, tv.load_vocabulary(q))


def _write_dbow2_yaml(voc, path):
    """The trained tree in DBoW2's OpenCV-YAML layout (nodeId, parentId,
    weight, descriptor bytes), leaves carrying the idf weights. DBoW2 ids
    are contiguous, so the created nodes are renumbered in id order (which
    keeps children and words in the same order)."""
    cents = voc.centroids.numpy().view(np.uint32)
    children = voc.children.numpy()
    word_of_node = voc.word_of_node.numpy()
    weights = voc.weights.numpy()
    made = np.concatenate([[0], np.sort(children[children >= 0])])
    new_id = {int(n): i for i, n in enumerate(made)}
    lines = ["%YAML:1.0", "vocabulary:", f"   k: {voc.k}", f"   L: {voc.levels}",
             "   scoringType: 0", "   weightingType: 0", "   nodes:"]
    for parent in made:
        for child in children[parent]:
            if child < 0:
                continue
            w = word_of_node[child]
            wt = float(weights[w]) if w >= 0 else 0.0
            desc = " ".join(str(b) for b in cents[child].view(np.uint8))
            lines.append(f"      - {{ nodeId:{new_id[int(child)]}, "
                         f"parentId:{new_id[int(parent)]}, "
                         f"weight:{wt!r}, descriptor:\"{desc}\" }}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_dbow2_yaml_loads_the_same_tree(tmp_path):
    j, t = _trees()
    p = str(tmp_path / "voc.yml")
    _write_dbow2_yaml(t, p)
    lj, lt = jv.load_dbow2_yaml(p), tv.load_dbow2_yaml(p)
    _same_tree(lj, lt)
    np.testing.assert_array_equal(lt.weights.numpy(), t.weights.numpy())
    assert lt.n_words == t.n_words
    _, d1, v1 = _descs()
    dt, vt = torch.from_numpy(d1.view(np.int32)), torch.from_numpy(v1)
    w_l, n_l = tv.transform_words(lt, dt, vt)
    w_t, n_t = tv.transform_words(t, dt, vt)
    assert torch.equal(w_l, w_t)
    # the same nodes, under the file's contiguous numbering
    made = np.concatenate([[0], np.sort(t.children.numpy()[t.children.numpy() >= 0])])
    np.testing.assert_array_equal(np.searchsorted(made, n_t.numpy()), n_l.numpy())
