"""The port's two main-path matchers against the JAX package, fed identical
Features (extracted by the port, converted to the JAX package's types)
and identical projections. Both searches reduce through the Hamming-NN
wrapper, which on CPU tensors is the plain version; the outputs are
integer slot indices and must be identical, unmasked (ORB) and masked
(mdBRIEF distance, random stability masks).
"""

import numpy as np
import pytest
import torch

from multicol_slam_tpu.models import matcher as jm
from multicol_slam_tpu_torch.kernels import hamming_nn as knn
from multicol_slam_tpu_torch.models import matcher as tm
from multicol_slam_tpu_torch.models import tracking as ttrk
from multicol_slam_tpu_torch.ops.camera import world_to_img
from multicol_slam_tpu_torch.ops.geometry import hom2cayley
from multicol_slam_tpu_torch.utils import synthetic as tsyn

import _torchutil as U


def _random_masks(shape, rng):
    """Packed stability masks with about 3 bits in 4 set."""
    m = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    m |= rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    return torch.from_numpy(m.view(np.int32).copy())


def _setup(masked: bool):
    gt, imgs = U.frames(2)
    _, tx = U.extractors()
    last, cur = tx(imgs[0]), tx(imgs[1])
    if masked:
        rng = np.random.default_rng(9)
        last = last._replace(desc_mask=_random_masks(last.desc.shape, rng))
        cur = cur._replace(desc_mask=_random_masks(cur.desc.shape, rng))
    st = tsyn.gt_bootstrap(U.torch_rig(), torch.tensor(gt[0], dtype=torch.float32),
                           last, U.N_LEVELS, U.SCALE_FACTOR)
    return gt, last, cur, st


@pytest.mark.parametrize("masked", [False, True])
def test_match_frame_to_frame_matches_jax(masked):
    gt, last, cur, st = _setup(masked)
    rig = U.torch_rig()
    mt1 = hom2cayley(torch.tensor(gt[1], dtype=torch.float32))
    _, T = ttrk._cam_frame(rig, mt1)
    Xc = torch.einsum("cij,ckj->cki", T[:, :3, :3], st["slot_X0"]) + T[:, None, :3, 3]
    uv = world_to_img(rig.cams.expand(1), Xc)
    ok = Xc[..., 2] > 0
    has = st["slot_has0"]
    free = torch.zeros_like(cur.valid)
    params_t = tm.MatchParams(masked=masked)
    before = knn.hamming_nn.launches
    got = tm.match_frame_to_frame(cur, last, has, free, uv, ok, params_t,
                                  th=U.TH_MOTION)
    assert knn.hamming_nn.launches == before       # CPU: the plain version
    with U.f32():
        want = jm.match_frame_to_frame(
            U.jax_features(cur), U.jax_features(last), U.to_jax(has),
            U.to_jax(free), U.to_jax(uv), U.to_jax(ok),
            jm.MatchParams(masked=masked), th=U.TH_MOTION)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() > (100 if masked else 300)   # real matches


@pytest.mark.parametrize("masked", [False, True])
def test_match_local_map_matches_jax(masked):
    gt, last, cur, st = _setup(masked)
    rig = U.torch_rig()
    mt1 = hom2cayley(torch.tensor(gt[1], dtype=torch.float32))
    uv, ok, lvl, vcos = ttrk.frustum_check(rig, mt1, st["X"], st["normal"],
                                           st["mind"], st["maxd"],
                                           n_levels=U.N_LEVELS,
                                           scale_factor=U.SCALE_FACTOR)
    ok = ok & st["cand_base"][None]
    # a third of the frame's slots already carry a point
    has = torch.from_numpy(np.random.default_rng(3).random(cur.valid.shape) < 0.3)
    pt_mask = st["pt_mask"]
    if masked:
        pt_mask = _random_masks(pt_mask.shape, np.random.default_rng(4))
    params_t = tm.MatchParams(masked=masked)
    got = tm.match_local_map(cur, has, st["pt_desc"], pt_mask, uv, ok, lvl,
                             vcos, params_t, th=U.TH_LOCAL)
    with U.f32():
        want = jm.match_local_map(
            U.jax_features(cur), U.to_jax(has), U.to_jax_u32(st["pt_desc"]),
            U.to_jax_u32(pt_mask), U.to_jax(uv), U.to_jax(ok), U.to_jax(lvl),
            U.to_jax(vcos), jm.MatchParams(masked=masked), th=U.TH_LOCAL)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() > (100 if masked else 200)
