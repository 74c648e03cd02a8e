"""The WORKING frame, end to end, port against the JAX package: extraction,
motion-model matching and pose LM, frustum check, local-map matching and
pose LM (``working_track_step``), and the chunked form with the slot roll
between frames (``working_scan_chunk``), on the same uint8 frames and the
same map, lifted from frame 0's keypoints at the true pose.

Bars (the slice's first bars in brackets), with what was measured on the CPU:
  - match indices identical on >= 99.5% of rows [98%]; measured 100%;
  - n_in and n_matches within 1% [2%]; measured identical;
  - final pose within 1e-4 m and 0.01 deg of the JAX pose [1e-3 m,
    0.05 deg]; measured at most 3.3e-7 m and 2.7e-6 deg;
  - the frustum check identical except within 1e-3 px of the image or
    mirror-mask edge; measured identical.
The LM iteration counts are not compared: in float32 they are decided
by rounding (see test_torch_optimizer.py).
"""

import numpy as np
import torch

from multicol_slam_tpu.models import matcher as jm
from multicol_slam_tpu.models import tracking as jtrk
from multicol_slam_tpu_torch.models import matcher as tm
from multicol_slam_tpu_torch.models import tracking as ttrk
from multicol_slam_tpu_torch.ops.geometry import cayley2hom
from multicol_slam_tpu_torch.utils import synthetic as tsyn

import _torchutil as U

MAP_KEYS = ("X", "normal", "mind", "maxd", "cand_base")


def _state():
    gt, imgs = U.frames(3)
    _, tx = U.extractors()
    st = tsyn.gt_bootstrap(U.torch_rig(), torch.tensor(gt[0], dtype=torch.float32),
                           tx(imgs[0]), U.N_LEVELS, U.SCALE_FACTOR)
    return gt, imgs, st


def _agree(a, b, frac=0.995):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert (a == b).mean() >= frac, (a != b).sum()


def _close_count(a, b, rel=0.01):
    assert abs(int(a) - int(b)) <= rel * max(int(b), 1), (int(a), int(b))


def _close_pose(mt, j_mt):
    t, r = U.pose_error(mt, j_mt)
    assert t <= 1e-4 and r <= 0.01, (t, r)


def test_frustum_check_matches_jax():
    gt, _, st = _state()
    mt = torch.tensor([0.01, 0.02, -0.01, 0.05, 0.0, -0.03])
    args = [st[k] for k in ("X", "normal", "mind", "maxd")]
    uv, ok, lvl, vcos = ttrk.frustum_check(U.torch_rig(), mt, *args,
                                           n_levels=U.N_LEVELS,
                                           scale_factor=U.SCALE_FACTOR)
    with U.f32():
        j = jtrk.frustum_check(U.jax_rig(), U.to_jax(mt), *(U.to_jax(a) for a in args),
                               n_levels=U.N_LEVELS, scale_factor=U.SCALE_FACTOR)
    np.testing.assert_allclose(uv.numpy(), np.asarray(j[0]), atol=1e-3)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(lvl.numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(vcos.numpy(), np.asarray(j[3]), atol=1e-6)
    assert ok.sum() > 500


def test_working_track_step_matches_jax():
    gt, imgs, st = _state()
    C, K = st["slot_has0"].shape
    cap = st["X"].shape[0]
    lp = st["slot_lp0"].numpy()
    lp_slot = np.full((cap, C), -1, np.int32)
    for c in range(C):
        ks = np.nonzero(lp[c] >= 0)[0]
        lp_slot[lp[c, ks], c] = ks
    lp_slot = torch.from_numpy(lp_slot)
    jx, tx = U.extractors()
    rest = [st[k] for k in MAP_KEYS] + [st["pt_desc"], st["pt_mask"]]
    out = ttrk.working_track_step(
        tx, U.torch_rig(), imgs[1], st["mt0"], st["slot_X0"], st["slot_has0"],
        st["last"], lp_slot, *rest, tm.MatchParams(), th_motion=U.TH_MOTION,
        th_local=U.TH_LOCAL, n_levels=U.N_LEVELS, scale_factor=U.SCALE_FACTOR)
    with U.f32():
        j = jtrk.working_track_step(
            jx, U.jax_rig(), U.to_jax(imgs[1]), U.to_jax(st["mt0"]),
            U.to_jax(st["slot_X0"]), U.to_jax(st["slot_has0"]),
            U.jax_features(st["last"]), U.to_jax(lp_slot),
            *(U.to_jax(a) for a in rest[:5]), U.to_jax_u32(st["pt_desc"]),
            U.to_jax_u32(st["pt_mask"]), jm.MatchParams(), th_motion=U.TH_MOTION,
            th_local=U.TH_LOCAL, n_levels=U.N_LEVELS,
            scale_factor=U.SCALE_FACTOR)
    (cur, m1, mt1, inl1, n_in1, n_m1, _, fr_ok, m2, mt2, inl_s, inl_n,
     n_in2, _) = out
    np.testing.assert_array_equal(cur.xy.numpy(), np.asarray(j[0].xy))
    _agree(m1, j[1])
    _close_pose(mt1, j[2])
    _agree(inl1, j[3])
    _close_count(n_in1, j[4])
    _close_count(n_m1, j[5])
    _agree(fr_ok, j[7])
    _agree(m2, j[8])
    _close_pose(mt2, j[9])
    _agree(inl_s, j[10])
    _agree(inl_n, j[11])
    _close_count(n_in2, j[12])
    assert int(n_in2) >= 15 and int(n_m1) > 100
    t, r = U.pose_error_hom(cayley2hom(mt2.double()).numpy(), gt[1])
    assert t < 0.05 and r < 1.0, (t, r)       # test_e2e_slice.py's bar


def test_working_scan_chunk_matches_jax():
    gt, imgs, st = _state()
    jx, tx = U.extractors()
    B = 2
    map_t = [st[k] for k in MAP_KEYS] + [st["pt_desc"], st["pt_mask"]]
    carry, ys = ttrk.working_scan_chunk(
        tx, U.torch_rig(), imgs[1:1 + B], st["mt0"], st["V0"], st["last"],
        st["slot_X0"], st["slot_lp0"], st["slot_has0"], *map_t,
        tm.MatchParams(), th_motion=U.TH_MOTION, th_local=U.TH_LOCAL,
        n_levels=U.N_LEVELS, scale_factor=U.SCALE_FACTOR)
    with U.f32():
        j_carry, j_ys = jtrk.working_scan_chunk(
            jx, U.jax_rig(), U.to_jax(imgs[1:1 + B]), U.to_jax(st["mt0"]),
            U.to_jax(st["V0"]), U.jax_features(st["last"]),
            *(U.to_jax(st[k]) for k in ("slot_X0", "slot_lp0", "slot_has0")),
            *(U.to_jax(a) for a in map_t[:5]), U.to_jax_u32(st["pt_desc"]),
            U.to_jax_u32(st["pt_mask"]), jm.MatchParams(), th_motion=U.TH_MOTION,
            th_local=U.TH_LOCAL, n_levels=U.N_LEVELS,
            scale_factor=U.SCALE_FACTOR)
        j_ys = {k: np.asarray(v) for k, v in j_ys.items() if k != "feats"}
    for k in ("lp", "has", "vis"):
        _agree(ys[k], j_ys[k])
    for b in range(B):
        for k in ("n_in1", "n_m1", "n_in2"):
            _close_count(ys[k][b], j_ys[k][b])
        _close_pose(ys["mt"][b], j_ys["mt"][b])
        t, r = U.pose_error_hom(cayley2hom(ys["mt"][b].double()).numpy(), gt[b + 1])
        assert t < 0.05 and r < 1.0 and int(ys["n_in2"][b]) >= 15
    _agree(carry[2], j_carry[2])                    # slot_lp after frame B
    np.testing.assert_allclose(carry[5].numpy(), np.asarray(j_carry[5]), atol=1e-4)
