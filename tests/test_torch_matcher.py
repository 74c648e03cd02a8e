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


def _two_views():
    """Frames 0 and 1 extracted by the port, their true poses, and the
    per-camera essentials E12 between them (world-to-camera convention)."""
    from multicol_slam_tpu_torch.ops import se3_np
    gt, imgs = U.frames(2)
    _, tx = U.extractors()
    f0, f1 = tx(imgs[0]), tx(imgs[1])
    Mc = U.torch_rig().M_c.double().numpy()
    T = [np.stack([np.linalg.inv(g @ m) for m in Mc]) for g in gt[:2]]
    E = se3_np.essential_from_poses(T[0], T[1]).astype(np.float32)
    return gt, f0, f1, torch.from_numpy(E)


@pytest.mark.parametrize("use_low_th", [False, True])
def test_window_search_matches_jax(use_low_th):
    _, f0, f1, _ = _two_views()
    sel = torch.from_numpy(np.random.default_rng(1).random(f0.valid.shape) < 0.7)
    got = tm.window_search(f0, f1, sel, tm.MatchParams(), window=200.0,
                           nn_ratio=0.9, use_low_th=use_low_th)
    with U.f32():
        want = jm.window_search(U.jax_features(f0), U.jax_features(f1), U.to_jax(sel),
                                jm.MatchParams(), window=200.0, nn_ratio=0.9,
                                use_low_th=use_low_th)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() > 150


def test_search_for_triangulation_matches_jax():
    _, f0, f1, E = _two_views()
    rng = np.random.default_rng(2)
    free0 = torch.from_numpy(rng.random(f0.valid.shape) < 0.6)
    free1 = torch.from_numpy(rng.random(f1.valid.shape) < 0.6)
    got = tm.search_for_triangulation(f0, free0, f1, free1, E, tm.MatchParams())
    with U.f32():
        want = jm.search_for_triangulation(U.jax_features(f0), U.to_jax(free0),
                                           U.jax_features(f1), U.to_jax(free1),
                                           U.to_jax(E), jm.MatchParams())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() > 50


@pytest.mark.parametrize("loose_desc", [False, True])
def test_fuse_candidates_matches_jax(loose_desc):
    gt, last, cur, st = _setup(False)
    rig = U.torch_rig()
    mt1 = hom2cayley(torch.tensor(gt[1], dtype=torch.float32))
    uv, ok, lvl, _ = ttrk.frustum_check(rig, mt1, st["X"], st["normal"], st["mind"],
                                        st["maxd"], n_levels=U.N_LEVELS,
                                        scale_factor=U.SCALE_FACTOR)
    ok = ok & st["cand_base"][None]
    has = torch.from_numpy(np.random.default_rng(3).random(cur.valid.shape) < 0.3)
    got = tm.fuse_candidates(cur, has, st["pt_desc"], st["pt_mask"], uv, ok, lvl,
                             tm.MatchParams(), th=3.0, loose_desc=loose_desc)
    with U.f32():
        want = jm.fuse_candidates(U.jax_features(cur), U.to_jax(has),
                                  U.to_jax_u32(st["pt_desc"]), U.to_jax_u32(st["pt_mask"]),
                                  U.to_jax(uv), U.to_jax(ok), U.to_jax(lvl),
                                  jm.MatchParams(), th=3.0, loose_desc=loose_desc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() > 200


def test_search_for_initialization_is_mutual_and_matches_jax():
    _, f0, f1, _ = _two_views()
    got = tm.search_for_initialization(f0, f1, tm.MatchParams())
    with U.f32():
        want = jm.search_for_initialization(U.jax_features(f0), U.jax_features(f1),
                                            jm.MatchParams())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() > 50        # level 0 only, at half width
    # mutual: each match is also the best row of its column
    back = tm.search_for_initialization(f1, f0, tm.MatchParams())
    c, r = np.nonzero(got.numpy() >= 0)
    assert (back.numpy()[c, got.numpy()[c, r]] == r).mean() > 0.95


def _pair_at_distance(d: int):
    """One query and one candidate, level 0, same place, same ray, whose
    descriptors differ in d bits."""
    q = np.zeros(256, np.int8)
    q[:d] = 1
    pack = lambda bits: __import__(
        "multicol_slam_tpu_torch.ops.hamming", fromlist=["x"]).pack_bits_u32(
        torch.from_numpy(bits)[None, None])

    def feats(bits):
        return tm.Features(
            xy=torch.full((1, 1, 2), 100.0), level=torch.zeros((1, 1), dtype=torch.int32),
            angle=torch.zeros((1, 1)), response=torch.ones((1, 1)),
            ray=torch.tensor([[[0.0, 0.0, 1.0]]]), desc=pack(bits),
            desc_mask=torch.full((1, 1, 8), -1, dtype=torch.int32),
            valid=torch.ones((1, 1), dtype=torch.bool))
    return feats(np.zeros(256, np.int8)), feats(q)


@pytest.mark.parametrize("d", [60, 80, 100])
def test_th_low_modes_use_th_low(d):
    """TH_LOW = 64 and TH_HIGH = 96 for 32-byte ORB: a pair at distance 80
    passes the TH_HIGH window search and fails the TH_LOW searches (the
    threshold used to be TH_HIGH everywhere)."""
    p = tm.MatchParams()
    a, b = _pair_at_distance(d)
    yes = torch.ones((1, 1), dtype=torch.bool)
    # identical rays satisfy any E = [t]x R: the epipolar gate passes
    E = torch.tensor([[[0.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]]])
    init = int(tm.search_for_initialization(a, b, p)[0, 0])
    tri = int(tm.search_for_triangulation(a, yes, b, yes, E, p)[0, 0])
    win_low = int(tm.window_search(a, b, yes, p, use_low_th=True)[0, 0])
    win_high = int(tm.window_search(a, b, yes, p)[0, 0])
    assert (init, tri, win_low) == ((0, 0, 0) if d <= p.th_low else (-1, -1, -1))
    assert win_high == (0 if d <= p.th_high else -1)


def _tiny_inputs(search):
    """Arguments of one search at C = 2 cameras, K = 6 slots, P = 5 points."""
    rng = np.random.default_rng(0)
    C, K, P = 2, 6, 5

    def feats():
        return tm.Features(
            xy=torch.from_numpy(rng.uniform(0, 20, (C, K, 2)).astype(np.float32)),
            level=torch.zeros((C, K), dtype=torch.int32), angle=torch.zeros((C, K)),
            response=torch.ones((C, K)), ray=torch.tensor([0.0, 0.0, 1.0]).expand(C, K, 3),
            desc=torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (C, K, 8), dtype=np.int32)),
            desc_mask=torch.full((C, K, 8), -1, dtype=torch.int32),
            valid=torch.ones((C, K), dtype=torch.bool))

    f1, f2 = feats(), feats()
    yes = torch.ones((C, K), dtype=torch.bool)
    pts = (torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (P, 8), dtype=np.int32)),
           torch.full((P, 8), -1, dtype=torch.int32),
           torch.from_numpy(rng.uniform(0, 20, (C, P, 2)).astype(np.float32)),
           torch.ones((C, P), dtype=torch.bool))
    lvl, vcos = torch.zeros((C, P), dtype=torch.int32), torch.ones((C, P))
    p = tm.MatchParams()
    return {"match_frame_to_frame": (f1, f2, yes, ~yes, f2.xy, yes, p),
            "match_local_map": (f1, ~yes) + pts + (lvl, vcos, p),
            "window_search": (f1, f2, yes, p),
            "search_for_initialization": (f1, f2, p),
            "fuse_candidates": (f1, ~yes) + pts + (lvl, p),
            "search_for_triangulation": (f1, yes, f2, yes, torch.eye(3).expand(C, 3, 3), p),
            }[search]


@pytest.mark.parametrize("search,entry,calls", [
    ("match_frame_to_frame", "hamming_nn_radius", 1),
    ("match_local_map", "hamming_nn_radius", 1),
    ("window_search", "hamming_nn_radius", 1),
    ("search_for_initialization", "hamming_nn_radius", 2),
    ("fuse_candidates", "hamming_nn_radius", 1),
    ("search_for_triangulation", "hamming_nn", 1),
])
def test_each_search_calls_its_kernel_entry(search, entry, calls, monkeypatch):
    """The window-gated searches build no dense gate: they call entry A
    (the mutual check of initialization a second time); the epipolar
    triangulation search calls entry B with its (C, K, K) gate."""
    seen = []
    for name in ("hamming_nn", "hamming_nn_radius"):
        orig = getattr(tm, name)
        monkeypatch.setattr(tm, name, lambda *a, _n=name, _f=orig: seen.append(_n) or _f(*a))
    out = getattr(tm, search)(*_tiny_inputs(search))
    assert seen == [entry] * calls
    assert out.shape == (2, 5 if search in ("match_local_map", "fuse_candidates") else 6)
