"""The JAX package's last jitted units as CUDA graphs: the self-calibrating
BA and ``refine_intrinsics`` (``optimizer.CALIBRATION``'s pool, also
reached through ``bundle_adjustment(free_mc=True)``), the sharded BA's
shard and root units (``parallel/ba_sharding.py``, the caller's pool) and
the WORKING step and chunk-scan body in ``Tracker.capture_ahead``.

On the CPU:
  - a host-read audit (``_graphutil.HostReads``) of the four functions a
    graph holds: no read, so each can be captured;
  - the ordered sums (``optimizer.RowSum``'s CUDA path, forced on the CPU)
    against ``index_add_`` in both self-calibrating optimizers on
    ``test_torch_selfcal.py``'s problem in float64: ``refine_intrinsics``
    bit for bit (one sum a target, the same order), the self-calibrating
    BA within 1e-12 (its Schur fold adds each row's sums to the running
    total, ``index_add_`` each term), but for the points one observation
    sees, free along their ray, within 1e-10;
  - through the capture stand-in (``_graphutil.StandIn``, with
    ``graphs.graphed`` true on the CPU): a second call of a key replays
    without capturing, equal to the plain function bit for bit; a second
    ``run_global_ba`` on a copy of the same map replays in the pool that
    was passed, the map written as the plain run writes it;
    ``capture_ahead`` on the bootstrap frame takes the WORKING step's and
    the scan body's keys, so the first fused frame replays the step, and
    leaves ``gen`` where it was.

On the card (``cuda``, skipped here): each of the three functions'
graphs against its eager call bit for bit, float32 and float64, and two
eager calls of the self-calibrating BA on one input identical. No JAX at
import:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_calib_graphs.py
"""

import functools

import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch.models import optimizer as opt
from multicol_slam_tpu_torch.models import tracking
from multicol_slam_tpu_torch.ops.rig import Rig, rig_from_cayley
from multicol_slam_tpu_torch.parallel import ba_sharding as bs
from multicol_slam_tpu_torch.utils import config_io, graphs, synthetic

from _graphutil import ALLOWED, HostReads, StandIn

N_KF, N_PT = 6, 160
OFFSET = [0.002, -0.002, 0.002, 0.004, -0.004, 0.004]


def _problem(dt=torch.float64, device="cpu"):
    """(rig with cameras 1-2 perturbed, the rig, mt0, X0, BAProblem): the
    port's ``make_ba_problem`` on the in-repo rig, the first two
    keyframes fixed, points one observation sees fixed."""
    rig = config_io.load_mcs(config_io.SYNTH_RIG_DIR, dtype=dt)[0]
    mt, X, uv, kf, cam, pt, valid, pt_obs = synthetic.make_ba_problem(
        rig, N_KF, N_PT, max_obs_per_pt=5, seed=3)
    rng = np.random.default_rng(1)
    mt0 = mt + rng.normal(0, 0.003, mt.shape)
    mt0[0] = mt[0]
    X0 = X + rng.normal(0, 0.02, X.shape)
    t = lambda a: torch.as_tensor(a, dtype=dt if np.asarray(a).dtype.kind == "f" else None,
                                  device=device)
    obs = opt.BAObservations(uv=t(uv), kf=t(kf), cam=t(cam), pt=t(pt),
                             inv_sigma2=torch.ones(len(kf), dtype=dt, device=device),
                             valid=t(valid))
    prob = opt.BAProblem(obs, t(pt_obs), torch.arange(N_KF, device=device) < 2,
                         t((pt_obs < len(uv) - 1).sum(1) < 2))
    rig = rig.to(device)
    off = torch.zeros(rig.n_cams, 6, dtype=dt, device=device)
    off[1:] = torch.tensor(OFFSET, dtype=dt, device=device)
    return rig_from_cayley(rig.M_c_min + off, rig.cams), rig, t(mt0), t(X0), prob


def _intrinsics_rig(rig):
    v = rig.cams.to_vector17().clone()
    v[:, 3] += 1.5
    v[:, 4] -= 1.0
    return Rig(M_c=rig.M_c, cams=rig.cams.with_vector17(v))


def _calls(dt=torch.float64, device="cpu"):
    """name -> (function, args, kwargs): the three graphed entries."""
    rig_p, rig, mt0, X0, prob = _problem(dt, device)
    return {"self_calibrating_bundle_adjustment": (
                opt.self_calibrating_bundle_adjustment, (rig_p, mt0, X0, prob), dict(iters=4)),
            "bundle_adjustment(free_mc=True)": (
                opt.bundle_adjustment, (rig_p, mt0, X0, prob), dict(iters=3, free_mc=True)),
            "refine_intrinsics": (
                opt.refine_intrinsics, (_intrinsics_rig(rig), mt0, X0, prob.obs),
                dict(iters=5))}


def _flat(tree):
    out = []
    graphs._flatten(tree, out)
    return out


def _identical(a, b):
    a, b = _flat(a), _flat(b)
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                    for x, y in zip(a, b))


def _shard_calls(D=2):
    """The sharded units' calls of one LM (its first, middle and last
    root step), recorded from the plain run on the CPU."""
    _, rig, mt0, X0, prob = _problem(torch.float32)
    devs = ["cpu"] * D
    shards = bs.shard_obs(bs.pad_obs_to_multiple(prob.obs, D), devs)
    calls = {"shard_linearize": [], "sharded_lm_step": []}
    real = bs.sharded_units(bs.mesh_devices(devs), None)

    def recording(name, fn):
        def run(*a):
            calls[name].append(a)
            return fn(*a)
        return run

    units = (recording("shard_linearize", real[0]), recording("sharded_lm_step", real[1]))
    orig = bs.sharded_units
    bs.sharded_units = lambda devices, pool: units
    try:
        bs.make_sharded_ba(devs, rig, N_KF, N_PT, iters=2)(
            mt0, X0, shards, prob.pt_obs, prob.fixed_kf, prob.fixed_pt)
    finally:
        bs.sharded_units = orig
    return calls


@pytest.mark.parametrize("name", ["self_calibrating_bundle_adjustment", "refine_intrinsics",
                                  "shard_linearize", "sharded_lm_step"])
def test_graphed_units_read_nothing_on_the_host(name):
    if name.startswith("shard"):
        calls = _shard_calls()[name]
        fn = getattr(bs, name)
    else:
        fn, a, k = _calls(torch.float32)[name]
        fn, calls = fn.fn, [a + (k,)]
    with HostReads() as mode:
        for a in calls:
            kw = a[-1] if isinstance(a[-1], dict) else {}
            fn(*(a[:-1] if kw else a), **kw)
    found = {(f, fn_) for f, fn_, _ in mode.reads}
    assert found <= ALLOWED, dict(mode.reads)
    assert len(calls) >= (3 if name == "sharded_lm_step" else 1)


@functools.lru_cache(maxsize=None)
def _selfcal_case():
    """test_torch_selfcal.py's problem (the JAX package builds it), once."""
    from test_torch_selfcal import _selfcal_case
    return _selfcal_case()


class _Ordered(opt.RowSum):
    """``RowSum`` with its CUDA path (a stable sort made once,
    ``segment_reduce`` a target) on every device."""

    def __init__(self, idx, n, live):
        self.idx, self.n = idx.long(), n
        self.seg = opt._segments(idx, n, live)


@pytest.mark.parametrize("which", ["self_calibrating_bundle_adjustment", "refine_intrinsics"])
def test_ordered_sums_match_index_add_on_the_selfcal_problem(which, monkeypatch):
    """test_torch_selfcal.py's problem (JAX builds it) in float64: the
    ordered sums against ``index_add_``'s. ``refine_intrinsics`` sums each
    camera's rows once, in row order either way: bit for bit. The
    self-calibrating BA folds the Schur complement a row of ``pt_obs`` at
    a time into the running total, which ``index_add_`` does a term at a
    time: within 1e-12 (relative to max(1, |entry|)), the points seen once
    within 1e-10."""
    from test_torch_selfcal import _rig, _t, _t_problem
    from multicol_slam_tpu_torch.utils import convert

    jr, mc_true, mc_pert, mt_all, X, obs, pt_obs, fixed_kf = _selfcal_case()
    cams = convert.rig_from_numpy(_rig()).cams
    if which == "refine_intrinsics":
        rig = _intrinsics_rig(Rig(M_c=torch.from_numpy(np.asarray(jr.M_c)), cams=cams))
        args, kw = (rig, _t(mt_all), _t(X), opt.BAObservations(*(_t(a) for a in obs))), \
            dict(iters=8)
    else:
        rig = rig_from_cayley(torch.from_numpy(mc_pert), cams)
        args, kw = (rig, _t(mt_all), _t(X),
                    _t_problem(obs, pt_obs, fixed_kf, X.shape[0], torch.float64)), \
            dict(iters=8)
    fn = getattr(opt, which).fn
    plain = fn(*args, **kw)
    monkeypatch.setattr(opt, "RowSum", _Ordered)
    ordered = fn(*args, **kw)
    flat_p, flat_o = _flat(plain), _flat(ordered)
    assert len(flat_p) == len(flat_o)
    if which == "refine_intrinsics":
        assert _identical(plain, ordered)
        return
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp(min=1.0)).reshape(len(a), -1).amax(1)
    seen = np.bincount(np.asarray(obs.pt)[np.asarray(obs.valid)], minlength=X.shape[0])
    for name, a, b in zip(("mt", "X", "mc", "chi2"), plain, ordered):
        err = rel(a, b)
        if name == "X":
            # a point one observation sees is free along its ray (lambda
            # alone damps it): the 1e-16 the fold's order moves the
            # reduced system by grows by its block's condition number
            # there (measured 5.4e-12 on the 4 such points of 150)
            assert float(err[torch.from_numpy(seen == 1)].max()) <= 1e-10
            err = err[torch.from_numpy(seen >= 2)]
        assert float(err.max()) <= 1e-12, (name, float(err.max()))
    # the calibration moved: the comparison is not of the start
    assert not torch.equal(ordered[2], rig.M_c_min)


@pytest.fixture
def stand_in(monkeypatch):
    """The capture stand-in, with every CPU tensor taken as a card's."""
    stand = StandIn(monkeypatch)
    monkeypatch.setattr(graphs, "graphed", lambda device: True)
    return stand


@pytest.mark.parametrize("name", ["self_calibrating_bundle_adjustment",
                                  "bundle_adjustment(free_mc=True)", "refine_intrinsics"])
def test_a_second_call_of_a_key_replays(name, stand_in):
    """The entry itself takes its graph (``graphs.graphed``): the first
    call warms up and captures, the second replays; both equal the plain
    function bit for bit. The BA with ``free_mc`` reaches the
    self-calibrating BA's graph."""
    fn, a, k = _calls()[name]
    unit = opt.self_calibrating_bundle_adjustment if "free_mc" in name else fn
    assert unit.graph.pool is opt.CALIBRATION
    unit.graph.clear()          # the key is this test's alone
    captures, replays = unit.graph.captures, unit.graph.replays
    first = fn(*a, **k)
    second = fn(*a, **k)
    assert unit.graph.captures == captures + 1 and unit.graph.replays == replays + 1
    plain = (fn.fn(*a, **k) if unit is fn else
             tuple(unit.fn(*a, iters=k["iters"])[i] for i in (0, 1, 3)))
    assert _identical(first, plain) and _identical(second, plain)


def test_a_second_global_ba_replays_in_the_pool_passed(stand_in):
    """run_global_ba over a mesh of two (CPU) devices with a pool: the
    first call captures the shard unit and the root's three keys (start,
    step, last) in that pool, a second call on a copy of the same map
    replays them all; both write the map the plain units write."""
    from test_torch_ba_sharding import _slam_map
    from multicol_slam_tpu_torch.models import global_ba

    rig = config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0]
    pool = graphs.Pool("test")
    run = lambda mm: global_ba.run_global_ba(rig, mm, [0], 1.2, iters=3,
                                              devices=["cpu", "cpu"], pool=pool)
    maps = [_slam_map(None)[0] for _ in range(3)]
    c1 = run(maps[0])
    units = [pool.jit(bs.shard_linearize), pool.jit(bs.sharded_lm_step)]
    assert [u.captures for u in units] == [1, 3] and all(u.pool is pool for u in units)
    replays = [u.replays for u in units]
    c2 = run(maps[1])
    assert [u.captures for u in units] == [1, 3]
    # two shards a linearization, four linearizations (the start, three
    # candidates); the root once each
    assert [u.replays - r for u, r in zip(units, replays)] == [8, 4]
    graphs_on = graphs.graphed
    try:
        graphs.graphed = lambda device: False
        c3 = run(maps[2])
    finally:
        graphs.graphed = graphs_on
    assert c1 == c2 == c3
    for a in maps[1:]:
        assert np.array_equal(a.kf_pose, maps[0].kf_pose)
        assert np.array_equal(a.pt_pos, maps[0].pt_pos)


def test_capture_ahead_takes_the_working_step(stand_in, monkeypatch):
    """A CPU system (loop closing off) whose pose LM, WORKING step and
    scan body are graphs (the stand-in), fed frames 0, 8, 9 and 10 of
    ``bench_trajectory``: the second bootstraps (on frame 0 as the
    reference), and its capture_ahead captures the WORKING step and the
    scan body and leaves ``gen`` where it was; the next frame takes the
    velocity path, the one after it is the first fused frame, which
    replays the step: neither unit captures late."""
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from test_torch_tracker_graphs import _fns

    torch.set_num_threads(2)
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, device="cpu",
                        enable_loop_closing=False)
    tr = slam.tracker
    fns = _fns(tr)
    for u in ("_pose_opt", "_working_step", "_scan_body"):
        setattr(tr, u, graphs.jit(fns[u]))
    states = []
    ahead = tr.capture_ahead

    def capture_ahead(images):
        states.append(tr.gen.get_state())
        ahead(images)
        states.append(tr.gen.get_state())

    monkeypatch.setattr(tr, "capture_ahead", capture_ahead)
    gt = synthetic.bench_trajectory(16)[[0, 8, 9, 10]]
    render = synthetic.make_renderer(slam.rig)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32))).to(torch.uint8)
    for i, frame in enumerate(frames):
        slam.track(frame, i / 25.0)
    assert tr.frame_path == ["init", "init", "velocity", "fused"], tr.frame_path
    assert len(states) == 2 and torch.equal(states[0], states[1])
    assert set(tr.captured_ahead) == {"_pose_opt", "_working_step", "_scan_body"}, \
        tr.captured_ahead
    assert tr._working_step.captures == 1 and tr._working_step.replays == 1
    late = {unit for _, unit, _ in tr.late_captures}
    assert not late & {"_working_step", "_scan_body"}, tr.late_captures


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphs are CUDA graphs")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["self_calibrating_bundle_adjustment",
                                  "bundle_adjustment(free_mc=True)", "refine_intrinsics"])
def test_graphs_equal_eager_on_the_card(name, dt, card):
    fn, a, k = _calls(dt, card)[name]
    unit = opt.self_calibrating_bundle_adjustment if "free_mc" in name else fn
    eager = (unit.fn(*a, **k) if unit is fn else
             tuple(unit.fn(*a, iters=k["iters"])[i] for i in (0, 1, 3)))
    first = fn(*a, **k)
    replays = unit.graph.replays
    second = fn(*a, **k)
    torch.cuda.synchronize()
    assert unit.graph.replays == replays + 1
    assert all(t.device.type == "cuda" for t in _flat(second))
    assert _identical(first, eager) and _identical(second, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_two_eager_selfcal_calls_are_identical_on_the_card(dt, card):
    fn, a, k = _calls(dt, card)["self_calibrating_bundle_adjustment"]
    one, two = fn.fn(*a, **k), fn.fn(*a, **k)
    assert _identical(one, two)
    assert not torch.equal(one[2], a[0].M_c_min)
