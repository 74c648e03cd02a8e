"""Local mapping's four graphed units (``models/local_mapping.py``):
``triangulation_batch``, ``cross_camera_batch``, ``fuse_targets_batch``
and the local ``bundle_adjustment``, each run as a CUDA graph by
``LocalMapper`` on the card and eagerly on the CPU.

On the CPU, on the inputs the units received in a real run (the system at
full width over frames 0-8 of ``bench_trajectory``: the two bootstrap
keyframes' mapping passes):
  - a host-read audit of the four units (``_graphutil.HostReads``, held to
    ``_graphutil.ALLOWED``);
  - through the capture stand-in (``_graphutil.StandIn``): each graphed
    unit, at its warm-up and at a replay, equals its eager self bit for bit
    (the BA too: its block sums run in a fixed order); one
    capture per key, a new one when the BA's bucket changes;
  - a BA problem padded to the next bucket of its observation, point and
    keyframe axes gives the same result bit for bit. Padding a point's
    observation axis widens the batched product of each row of the Schur
    complement, and MKL rounds another width another way: that padding
    is held to 1e-5 in every pose entry and 5e-5 m on every point
    (measured 4.8e-7 and 4.5e-6). The padding runs use one CPU thread:
    torch's elementwise kernels split a tensor among threads in chunks
    whose vector tails (atan2's scalar path) fall on other rows as the
    padded length changes, and MKL splits a long product's sum among
    threads.

``tests/test_torch_local_mapping.py`` runs a whole pass through the
stand-in graphs against the JAX package. On the card (``@pytest.mark.cuda``,
skipped here) each graphed unit equals its eager self bit for bit, and
``LocalMapper`` holds graphs in its own pool. No JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_mapping_graphs.py
"""

import functools

import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch.models import local_mapping as lm
from multicol_slam_tpu_torch.models import optimizer as opt
from multicol_slam_tpu_torch.utils import graphs

from _graphutil import ALLOWED, HostReads, StandIn

UNITS = ("_triangulate", "_cross_camera", "_fuse", "_bundle_adjust")
FNS = {"_triangulate": lm.triangulation_batch, "_cross_camera": lm.cross_camera_batch,
       "_fuse": lm.fuse_targets_batch, "_bundle_adjust": opt.bundle_adjustment}


@functools.lru_cache(maxsize=None)
def recorded():
    """unit -> [(args, kwargs)] of every call the system's mapper made
    over frames 0-8 at full width on the CPU."""
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io, synthetic

    torch.set_num_threads(2)
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, device="cpu",
                        enable_loop_closing=False)
    calls = {u: [] for u in UNITS}
    for u in UNITS:
        fn = getattr(slam.mapper, u)
        assert fn is FNS[u]                    # eager on the CPU

        def rec(*a, _u=u, _fn=fn, **k):
            calls[_u].append((a, k))
            return _fn(*a, **k)
        setattr(slam.mapper, u, rec)
    gt = synthetic.bench_trajectory(9)
    render = synthetic.make_renderer(slam.rig)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32))).to(torch.uint8)
    for i in range(9):
        slam.track(frames[i], i / 25.0)
    assert all(calls[u] for u in UNITS), {u: len(c) for u, c in calls.items()}
    return calls


def leaves(tree):
    out = []
    graphs._flatten(tree, out)
    return out


def assert_identical(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y), (x, y)


def test_mapping_units_read_nothing_on_the_host():
    calls = recorded()
    with HostReads() as mode:
        for u in UNITS:
            a, k = calls[u][0]
            FNS[u](*a, **k)
    found = {(f, fn) for f, fn, _ in mode.reads}
    assert found <= ALLOWED, {k: n for k, n in mode.reads.items() if k[:2] not in ALLOWED}


def test_mapper_units_eager_on_the_cpu():
    from multicol_slam_tpu_torch.utils import config_io
    rig = config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0]
    from multicol_slam_tpu_torch.models.map import MapStore
    from multicol_slam_tpu_torch.models.matcher import MatchParams
    mapper = lm.LocalMapper(rig, MapStore(capacity_pts=16, capacity_kfs=4, n_cams=3,
                                          k_per_cam=8, desc_words=8), MatchParams())
    assert all(getattr(mapper, u) is FNS[u] for u in UNITS)


def test_graphed_units_equal_eager(monkeypatch):
    """Each unit through the stand-in: its warm-up and a replay on the same
    inputs, then a replay on another call's inputs where one has the same
    key, each identical to the eager function's output."""
    stand = StandIn(monkeypatch)
    calls = recorded()
    pool = graphs.Pool("mapper")
    for u in UNITS:
        g = graphs.jit(FNS[u], pool)
        for a, k in calls[u][:1] * 2 + calls[u][1:3]:
            assert_identical(g(*a, **k), FNS[u](*a, **k))
        assert g.replays >= 1 and g.captures == len(g)
    assert stand.captures >= 4 and stand.replays >= 4


def pad_ba(problem, mt0, X0, K, P, N, Mo):
    """The BA problem padded to K observation rows (invalid, appended before
    nothing moves: the old pad row stays the pt_obs pad target), P points
    (fixed), N keyframes (fixed) and Mo observation columns a point."""
    obs = problem.obs
    k0, p0, n0, m0 = obs.uv.shape[0], X0.shape[0], mt0.shape[0], problem.pt_obs.shape[1]
    cat = lambda t, n, fill: torch.cat([t, torch.full((n,) + t.shape[1:], fill,
                                                      dtype=t.dtype)])
    obs = opt.BAObservations(uv=cat(obs.uv, K - k0, 0.0), kf=cat(obs.kf, K - k0, 0),
                             cam=cat(obs.cam, K - k0, 0), pt=cat(obs.pt, K - k0, 0),
                             inv_sigma2=cat(obs.inv_sigma2, K - k0, 1.0),
                             valid=cat(obs.valid, K - k0, False))
    pt_obs = cat(problem.pt_obs, P - p0, k0 - 1)
    pt_obs = torch.cat([pt_obs, torch.full((P, Mo - m0), k0 - 1, dtype=pt_obs.dtype)], 1)
    return (opt.BAProblem(obs=obs, pt_obs=pt_obs, fixed_kf=cat(problem.fixed_kf, N - n0, True),
                          fixed_pt=cat(problem.fixed_pt, P - p0, True)),
            cat(mt0, N - n0, 0.0), cat(X0, P - p0, 1.0))


@functools.lru_cache(maxsize=None)
def synthetic_ba():
    """make_ba_problem's 6 keyframes x 300 points on the in-repo rig,
    perturbed, padded to the local BA's smallest buckets."""
    from multicol_slam_tpu_torch.utils import config_io, synthetic
    rig = config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0]
    mt, X, uv, kf, cam, pt, valid, pt_obs = synthetic.make_ba_problem(rig, 6, 300)
    rng = np.random.default_rng(1)
    mt0 = mt + rng.standard_normal(mt.shape) * 0.01
    mt0[0] = mt[0]
    X0 = X + rng.standard_normal(X.shape) * 0.05
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt)
    problem = opt.BAProblem(
        obs=opt.BAObservations(uv=t(uv, torch.float32), kf=t(kf), cam=t(cam), pt=t(pt),
                               inv_sigma2=torch.ones(len(uv)), valid=t(valid)),
        pt_obs=t(pt_obs), fixed_kf=t(np.arange(6) == 0), fixed_pt=torch.zeros(300, dtype=bool))
    base = (lm.coarse_bucket(len(uv) - 1, 2048) + 1, lm.coarse_bucket(300, 1024),
            lm.coarse_bucket(6, 16), lm.coarse_bucket(pt_obs.shape[1], 8))
    return rig, problem, t(mt0, torch.float32), t(X0, torch.float32), base


def run_padded(K, P, N, Mo):
    rig, problem, mt0, X0, _ = synthetic_ba()
    prob, m, x = pad_ba(problem, mt0, X0, K, P, N, Mo)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mt, X, chi2 = opt.bundle_adjustment(rig, m, x, prob, huber=opt.HUBER_LOCAL, iters=5)
    finally:
        torch.set_num_threads(threads)
    k = problem.obs.uv.shape[0] - 1
    return mt[:6], X[:300], chi2[:k]


@pytest.mark.parametrize("axis", ["observations", "points", "keyframes", "all three"])
def test_padded_ba_problem_bit_for_bit(axis):
    K, P, N, Mo = synthetic_ba()[4]
    want = run_padded(K, P, N, Mo)
    grow = {"observations": (4 * (K - 1) + 1, P, N, Mo), "points": (K, 4 * P, N, Mo),
            "keyframes": (K, P, 4 * N, Mo), "all three": (4 * (K - 1) + 1, 4 * P, 4 * N, Mo)}
    for g, w in zip(run_padded(*grow[axis]), want):
        assert torch.equal(g, w), axis


def test_padded_observations_a_point():
    K, P, N, Mo = synthetic_ba()[4]
    want = run_padded(K, P, N, Mo)
    mt, X, _ = run_padded(K, P, N, 4 * Mo)
    np.testing.assert_allclose(mt.numpy(), want[0].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(X.numpy(), want[1].numpy(), rtol=0, atol=5e-5)


def test_a_new_capture_when_the_ba_bucket_changes(monkeypatch):
    stand = StandIn(monkeypatch)
    rig, problem, mt0, X0, (K, P, N, Mo) = synthetic_ba()
    g = graphs.jit(opt.bundle_adjustment, graphs.Pool("mapper"))
    kw = dict(huber=opt.HUBER_LOCAL, iters=5)
    small = pad_ba(problem, mt0, X0, K, P, N, Mo)
    g(rig, small[1], small[2], small[0], **kw)
    g(rig, small[1] + 1e-4, small[2], small[0], **kw)
    assert stand.captures == 1 and stand.replays == 1 and len(g) == 1
    big = pad_ba(problem, mt0, X0, 4 * (K - 1) + 1, P, N, Mo)
    g(rig, big[1], big[2], big[0], **kw)
    assert stand.captures == 2 and len(g) == 2
    g(rig, big[1], big[2], big[0], **dict(kw, iters=10))     # a static argument
    assert stand.captures == 3


def test_segment_sums_equal_index_add():
    """The BA's sums on the card (``optimizer._segments``,
    ``_segment_sum``), run here on the CPU: each target's rows in row
    order, the rows outside ``live`` (exact zeros) left out, equal bit for
    bit to the CPU's ``index_add_`` over every row."""
    g = torch.Generator().manual_seed(0)
    K, n = 5000, 40
    idx = torch.randint(0, n, (K,), generator=g)
    live = torch.rand(K, generator=g) < 0.4
    idx[~live] = 0                           # padding rows all point at target 0
    vals = torch.randn(K, 6, 6, generator=g) * live[:, None, None]
    want = torch.zeros(n, 6, 6).index_add_(0, idx, vals)
    got = opt._segment_sum(opt._segments(idx, n, live), vals, n)
    assert torch.equal(got, want)


def test_ba_through_segment_sums(monkeypatch):
    """The whole BA with every sum taken as on the card, on the CPU: the
    per-row sums of the Schur complement then add to it one row of
    observations at a time, where ``index_add_`` adds each row in place,
    so the result is held to 1e-5 in every pose entry and 1e-4 m."""
    rig, problem, mt0, X0, (K, P, N, Mo) = synthetic_ba()
    prob, m, x = pad_ba(problem, mt0, X0, K, P, N, Mo)
    kw = dict(huber=opt.HUBER_LOCAL, iters=5)
    want = opt.bundle_adjustment(rig, m, x, prob, **kw)
    init = opt.RowSum.__init__

    def on_segments(self, idx, n, live):
        init(self, idx, n, live)
        self.seg = opt._segments(idx, n, live)

    monkeypatch.setattr(opt.RowSum, "__init__", on_segments)
    got = opt.bundle_adjustment(rig, m, x, prob, **kw)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=0, atol=1e-4)


def test_coarse_bucket():
    assert [lm.coarse_bucket(n, 16) for n in (1, 16, 17, 64, 65, 300)] == [16, 16, 64, 64,
                                                                           256, 1024]


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the Hamming-NN kernel")
    return torch.device("cuda", 0)


def to_card(tree, dev):
    if torch.is_tensor(tree):
        return tree.to(dev)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_card(x, dev) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_card(x, dev) for x in tree)
    if isinstance(tree, dict):
        return {k: to_card(v, dev) for k, v in tree.items()}
    return tree


@pytest.mark.cuda
def test_mapper_holds_graphs_on_the_card(card):
    from multicol_slam_tpu_torch.models.map import MapStore
    from multicol_slam_tpu_torch.models.matcher import MatchParams
    from multicol_slam_tpu_torch.utils import config_io
    rig = config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0].to(card)
    mapper = lm.LocalMapper(rig, MapStore(capacity_pts=16, capacity_kfs=4, n_cams=3,
                                          k_per_cam=8, desc_words=8), MatchParams())
    units = [getattr(mapper, u) for u in UNITS]
    assert all(isinstance(g, graphs.jit) for g in units)
    assert len({id(g.pool) for g in units}) == 1 and units[0].pool is not graphs.SHARED


@pytest.mark.cuda
def test_graphed_units_equal_eager_on_the_card(card):
    calls = recorded()
    pool = graphs.Pool("mapper")
    for u in UNITS:
        g = graphs.jit(FNS[u], pool)
        for a, k in calls[u][:2]:
            a, k = to_card((a, k), card)
            for _ in range(2):                    # the warm-up or a replay, then a replay
                got = g(*a, **k)
                want = FNS[u](*a, **k)
                torch.cuda.synchronize()
                assert_identical(got, want)
        assert g.replays >= 2
