"""The port's MapStore against the JAX package's on one replayed sequence of
operations (keyframes and points allocated past both pools' capacity,
observations added, erased and merged, points and a keyframe removed,
point statistics refreshed), and the MapStore converters both ways.

Bar: identical arrays after every step, the distinctive descriptors
(min-median Hamming, the JAX package's native runtime on its side) and
the covisibility counts included; identical query results.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from multicol_slam_tpu.models import extractor as jext
from multicol_slam_tpu.models import map as jmap
from multicol_slam_tpu_torch.models import map as tmap
from multicol_slam_tpu_torch.ops import se3_np
from multicol_slam_tpu_torch.utils import convert

C, K, W = 2, 12, 8


def _features(rng):
    """Random keyframe features as numpy (JAX package dtypes)."""
    return dict(
        xy=rng.uniform(0, 300, (C, K, 2)).astype(np.float32),
        level=rng.integers(0, 4, (C, K)).astype(np.int32),
        angle=rng.uniform(-3, 3, (C, K)).astype(np.float32),
        response=rng.uniform(0, 1, (C, K)).astype(np.float32),
        ray=rng.normal(size=(C, K, 3)).astype(np.float32),
        # few distinct words, so distinctive-descriptor ties occur
        desc=rng.choice(rng.integers(0, 2 ** 32, (5, W), dtype=np.uint32).ravel(),
                        (C, K, W)),
        desc_mask=np.full((C, K, W), 0xFFFFFFFF, np.uint32),
        valid=np.ones((C, K), bool))


def _pair():
    kw = dict(capacity_pts=16, capacity_kfs=2, n_cams=C, k_per_cam=K, desc_words=W)
    return jmap.MapStore(**kw), tmap.MapStore(**kw)


def _assert_same(jm, tm):
    a, b = convert.map_to_numpy(convert.map_from_numpy(jm)), convert.map_to_numpy(tm)
    for k in a:
        if k == "kf_features":
            assert [f is None for f in a[k]] == [f is None for f in b[k]]
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k
    np.testing.assert_array_equal(jm.obs_rows(), tm.obs_rows())
    for kf in range(jm._next_kf):
        assert jm.covisibility_weights(kf) == tm.covisibility_weights(kf)
        assert jm.covisible_keyframes(kf, min_weight=2) == \
            tm.covisible_keyframes(kf, min_weight=2)
        assert jm.connected_keyframes(kf) == tm.connected_keyframes(kf)


def _replay(jm, tm, rng, check=True):
    """The operation sequence, applied to both maps."""
    Mc = np.stack([se3_np.cayley2hom(np.r_[rng.normal(0, 0.2, 3), rng.normal(0, 0.1, 3)])
                   for _ in range(C)])

    def both(fn):
        fn(jm)
        fn(tm)
        if check:
            _assert_same(jm, tm)

    for i in range(5):
        f = _features(rng)
        pose = np.r_[rng.normal(0, 0.05, 3), rng.normal(0, 0.5, 3)]
        jf = jext.Features(**{k: jnp.asarray(v) for k, v in f.items()})
        tf = convert.features_from_numpy(jext.Features(**f))
        jm.alloc_keyframe(pose, jf, 10 * i)
        tm.alloc_keyframe(pose, tf, 10 * i)
    ids = rng.permutation(40)
    both(lambda m: m.alloc_points(40))
    pos = rng.uniform(-3, 3, (40, 3)).astype(np.float32) + [0, 0, 5]
    both(lambda m: m.pt_pos.__setitem__(slice(0, 40), pos))
    # each point seen by 2-4 (keyframe, camera) pairs, free slots only
    free = {(kf, c): list(rng.permutation(K)) for kf in range(5) for c in range(C)}
    plan = []
    for p in ids:
        for kf in rng.choice(5, rng.integers(2, 5), replace=False):
            c = int(rng.integers(0, C))
            if free[(kf, c)]:
                plan.append((int(p), int(kf), c, int(free[(kf, c)].pop())))
    for obs in plan:
        both(lambda m: m.add_observation(*obs))
    both(lambda m: m.update_point_stats(np.arange(40), Mc, 1.2, 4))
    for kf in range(5):
        both(lambda m: m.update_spanning_tree(kf))
    for obs in plan[::7]:
        both(lambda m: m.erase_observation(*obs))
    for old, new in [(3, 7), (11, 2), (7, 19), (25, 19)]:
        both(lambda m: m.replace_point(old, new))
    both(lambda m: m.remove_point(30))
    both(lambda m: m.update_point_stats(np.arange(40), Mc, 1.2, 4))
    both(lambda m: m.remove_keyframe(3))
    both(lambda m: m.alloc_points(5))
    ids = np.array([[3, 7, 11, -1], [25, 30, 0, 2]], np.int32)
    np.testing.assert_array_equal(jm.resolve_points(ids), tm.resolve_points(ids))
    assert jm.n_points() == tm.n_points() and jm.n_keyframes() == tm.n_keyframes()


def test_replayed_operations_give_identical_maps():
    jm, tm = _pair()
    _replay(jm, tm, np.random.default_rng(0))
    assert tm.capacity_pts > 16 and tm.capacity_kfs > 2      # both pools grew
    assert len(tm._covis) > 0 and (tm.pt_desc[:40] != 0).any()


@pytest.mark.parametrize("seed", [1, 2])
def test_distinctive_descriptors_match_the_native_runtime(seed):
    from multicol_slam_tpu import runtime

    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 12, 400)
    off = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
    words = rng.integers(0, 2 ** 32, (int(cnt.sum()), W), dtype=np.uint32)
    words[::3] = words[0]                    # duplicates: median ties
    np.testing.assert_array_equal(tmap.distinctive_descriptors_batch(words, off),
                                  runtime.distinctive_descriptors_batch(words, off))


def test_map_converters_round_trip():
    jm, tm = _pair()
    _replay(jm, tm, np.random.default_rng(5), check=False)
    # JAX -> port -> numpy -> a fresh JAX MapStore: nothing changes
    back = convert.map_to_numpy(convert.map_from_numpy(jm))
    jm2 = jmap.MapStore(**{k: back[k] for k in convert._MAP_SIZES})
    for k, v in back.items():
        if k == "kf_features":
            v = [None if f is None else jext.Features(**{n: jnp.asarray(a) for n, a in f.items()})
                 for f in v]
        setattr(jm2, k, v)
    _assert_same(jm2, tm)
    for kf in jm.keyframe_ids():
        for a, b in zip(jm.kf_host(int(kf)), jm2.kf_host(int(kf))):
            np.testing.assert_array_equal(a, b)
    # the copies share no state with their source
    tm2 = convert.map_from_numpy(convert.map_to_numpy(tm))
    p = int(tm.point_ids()[0])
    n_obs = len(tm.pt_obs[p])
    tm2.remove_point(p)
    assert tm.pt_valid[p] and len(tm.pt_obs[p]) == n_obs > 0
    assert not tm2.pt_valid[p] and p not in tm2.pt_obs
