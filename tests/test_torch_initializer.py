"""The port's bootstrap against the JAX package's at full width: frames 0
and 8 of ``bench_trajectory`` through the port's init extractor (2x
features, FAST 5; the extractor tests hold it bit-identical to the JAX
package's), the mutual level-0 matcher, then ``initialize_device`` with the
JAX package's RANSAC minimal sets injected, and the leading camera.

Bars, with what was measured on the CPU:
  - mutual matches identical, in both directions of the search;
  - per camera: identical ``good`` masks and counts (66, 39, 33), median
    norms within 1e-5 (the averaged middle pair, as ``jnp.nanmedian``;
    measured 1.3e-6), the chosen R12 and t12 within 5e-4 (measured 6.9e-6
    and 5.0e-5) and the good points within 1 cm (measured 1.9 mm): the
    port's 5-point Newton runs in float64, the JAX package's in float32;
  - the same leading camera and slots, anchoring poses within 1e-4
    (measured 9.5e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multicol_slam_tpu.models import initializer as jinit
from multicol_slam_tpu.models import matcher as jm
from multicol_slam_tpu_torch.models import initializer as tinit
from multicol_slam_tpu_torch.models import matcher as tm
from multicol_slam_tpu_torch.models import system as tsys
from multicol_slam_tpu_torch.ops import ransac as tr

import _torchutil as U

REF, CUR = 0, 8


def _features():
    gt, imgs = U.bench_frames(CUR + 1)
    slam = tsys.MultiColSLAM(rig=U.full_torch_rig(), enable_loop_closing=False)
    return slam._extract_init_padded(imgs[REF]), slam._extract_init_padded(imgs[CUR])


def test_mutual_matcher_matches_jax():
    f0, f1 = _features()
    for a, b in ((f0, f1), (f1, f0)):
        got = tm.search_for_initialization(a, b, tm.MatchParams())
        with U.f32():
            want = jm.search_for_initialization(U.jax_features(a), U.jax_features(b),
                                                jm.MatchParams())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got >= 0).sum() > 100


def test_nanmedian_averages_the_middle_pair():
    x = torch.tensor([3.0, float("nan"), 1.0, 2.0, 10.0, float("nan")])
    assert float(tinit.nanmedian(x)) == 2.5
    assert float(tinit.nanmedian(x[:4])) == 2.0
    assert torch.isnan(tinit.nanmedian(torch.full((3,), float("nan"))))
    with U.f32():
        assert float(jnp.nanmedian(jnp.asarray(x.numpy()))) == 2.5


def test_initialize_device_matches_jax(monkeypatch):
    f0, f1 = _features()
    with U.f32():
        jc = jinit.initialize_device(jax.random.split(jax.random.PRNGKey(42))[1],
                                     jax.tree.map(jnp.asarray, U.full_jax_rig()),
                                     U.jax_features(f0), U.jax_features(f1),
                                     jm.MatchParams())
        jc = jinit.InitCandidate(*(np.asarray(a) for a in jc))
        jres = jinit.pick_leading_camera(jc, U.full_jax_rig())
    monkeypatch.setattr(tr, "sample_minimal_sets", U.JaxMinimalSets())
    tc = tinit.initialize_device(torch.Generator(), U.full_torch_rig(), f0, f1,
                                 tm.MatchParams())
    tc = tinit.InitCandidate(*(t.numpy() for t in tc))
    np.testing.assert_array_equal(tc.match_idx, jc.match_idx)
    np.testing.assert_array_equal(tc.good, jc.good)
    np.testing.assert_array_equal(tc.n_good, jc.n_good)
    np.testing.assert_allclose(tc.median_norm, jc.median_norm, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.R12, jc.R12, rtol=0, atol=5e-4)
    np.testing.assert_allclose(tc.t12, jc.t12, rtol=0, atol=5e-4)
    for c in range(3):
        g = jc.good[c]
        np.testing.assert_allclose(tc.X[c][g], jc.X[c][g], rtol=0, atol=0.01)

    res = tinit.pick_leading_camera(tc, U.full_torch_rig())
    assert jres is not None and res is not None
    assert res.lead_cam == jres.lead_cam
    np.testing.assert_array_equal(res.ref_slots, jres.ref_slots)
    np.testing.assert_array_equal(res.cur_slots, jres.cur_slots)
    np.testing.assert_allclose(res.mt_ref, jres.mt_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.mt_cur, jres.mt_cur, rtol=0, atol=1e-4)
    assert res.n_matches == jres.n_matches > 60

