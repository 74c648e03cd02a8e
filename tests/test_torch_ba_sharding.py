"""Sharded bundle adjustment, port against the JAX package:
``parallel/ba_sharding.py`` on a list of eight CPU devices against
``multicol_slam_tpu/parallel/ba_sharding.py`` on conftest.py's eight
virtual CPU devices, ``synthetic.make_ba_problem`` against the JAX one, and
``global_ba.run_global_ba``'s routing.

All BA comparisons run in float64 on the in-repo rig at full width, on
``make_ba_problem(rig, 4, 120, max_obs_per_pt=4)`` (both packages' copies
give the same problem) with the poses moved 3 mrad / 2 cm and the points
2 cm off the truth, keyframe 0 the gauge and the points that one
observation sees (5 of 120) fixed: such a point has no depth, its step
along it is lambda's alone, and there float64 rounding (the written-out
Jacobians and ``jax.jacfwd`` give blocks 1e-16 apart, relative) grows by
the block's condition number, 3e7, to 1.3e-10 m. Bars: one sharded step at
D = 8 within 1e-10 of the JAX package's (tests/test_sharding.py:84-85);
the full LM at D = 1, 2, 3 and 8 (the 447 rows split into 3 evenly; 2
and 8 pad them) within 1e-8 of the port's single-device
``bundle_adjustment`` and of the JAX ``make_sharded_ba``
(tests/test_sharding.py:193-194), its robust cost under the expected
chi2 of the 0.5 px noise (a fifth of the start's); ``make_ba_problem``'s
index tables exact and uv within 1e-9 px.

The routing: ``run_global_ba`` shards when its mesh has more than one
device. With ``global_ba.default_mesh`` monkeypatched to eight CPU
devices, the loop closer's post-loop BA reaches ``make_sharded_ba`` and
at least halves the keyframe drift of tests/test_sharding.py's map, as
the JAX test requires, once the map's scale is taken out: on this rig the
BA optimum of that map lies 1.2% off the true scale, in the JAX package's
single-device global BA as in the port, so the raw drift grows there. Both
branches return the summed raw chi2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from multicol_slam_tpu.models import optimizer as jopt
from multicol_slam_tpu.parallel import ba_sharding as jbs
from multicol_slam_tpu.utils import config_io as jcio
from multicol_slam_tpu.utils import synthetic as jsyn
from multicol_slam_tpu_torch.models import global_ba as tgba
from multicol_slam_tpu_torch.models import keyframe_database as tkdb
from multicol_slam_tpu_torch.models import loop_closing as tlc
from multicol_slam_tpu_torch.models import matcher as tmt
from multicol_slam_tpu_torch.models import optimizer as topt
from multicol_slam_tpu_torch.models import vocabulary as tv
from multicol_slam_tpu_torch.parallel import ba_sharding as tbs
from multicol_slam_tpu_torch.utils import config_io as tcio
from multicol_slam_tpu_torch.utils import convert
from multicol_slam_tpu_torch.utils import synthetic as tsyn

from test_sharding import _populate_slam_map

N_KF, N_PT, M_OBS = 4, 120, 4
ITERS = 6
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def rigs():
    """(JAX rig, port rig), the in-repo rig in float64."""
    jr, _ = jcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=np.float64)
    return jax.tree.map(jnp.asarray, jr), tcio.load_mcs(tcio.SYNTH_RIG_DIR,
                                                       dtype=torch.float64)[0]


@pytest.fixture(scope="module")
def problem(rigs):
    """The problem as numpy arrays: (mt0, X0, uv, kf, cam, pt, valid,
    pt_obs, fixed_kf, fixed_pt, truth)."""
    mt, X, uv, kf, cam, pt, valid, pt_obs = tsyn.make_ba_problem(
        rigs[1], N_KF, N_PT, max_obs_per_pt=M_OBS, seed=0)
    rng = np.random.default_rng(1)
    mt0 = mt + np.r_[rng.normal(0, 0.003, (N_KF, 3)).T, rng.normal(0, 0.02, (N_KF, 3)).T].T
    mt0[0] = mt[0]
    X0 = X + rng.normal(0, 0.02, X.shape)
    fixed_kf = np.arange(N_KF) == 0
    # a point seen once has no depth: held fixed, as a map never holds one
    fixed_pt = (pt_obs < len(uv) - 1).sum(1) < 2
    return dict(mt0=mt0, X0=X0, uv=uv, kf=kf, cam=cam, pt=pt, valid=valid, pt_obs=pt_obs,
                fixed_kf=fixed_kf, fixed_pt=fixed_pt, truth=(mt, X))


def _obs(p, lib):
    """The observation table in either package (inv_sigma2 ones)."""
    cls = jopt.BAObservations if lib == "jax" else topt.BAObservations
    to = jnp.asarray if lib == "jax" else torch.as_tensor
    return cls(uv=to(p["uv"]), kf=to(p["kf"]), cam=to(p["cam"]), pt=to(p["pt"]),
               inv_sigma2=to(np.ones(len(p["kf"]))), valid=to(p["valid"]))


def _args(p, lib):
    to = jnp.asarray if lib == "jax" else torch.as_tensor
    return to(p["pt_obs"]), to(p["fixed_kf"]), to(p["fixed_pt"])


def _jax_mesh(d):
    return Mesh(np.array(jax.devices()[:d]), (jbs.OBS_AXIS,))


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_pad_obs_to_multiple_matches_jax(problem, n_shards):
    j = jbs.pad_obs_to_multiple(_obs(problem, "jax"), n_shards)
    t = tbs.pad_obs_to_multiple(_obs(problem, "torch"), n_shards)
    assert t.uv.shape[0] % n_shards == 0
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype


def test_shard_obs_splits_in_block_order(problem):
    obs = tbs.pad_obs_to_multiple(_obs(problem, "torch"), 8)
    shards = tbs.shard_obs(obs, CPU8)
    assert len(shards) == 8
    for field, a in zip(obs._fields, obs):
        assert torch.equal(torch.cat([getattr(s, field) for s in shards]), a)
    d = next(d for d in range(3, 64) if obs.uv.shape[0] % d)
    with pytest.raises(ValueError, match="pad them"):
        tbs.shard_obs(obs, ["cpu"] * d)


def test_a_mesh_of_mixed_device_types_raises(rigs):
    with pytest.raises(ValueError, match="one device type"):
        tbs.make_sharded_ba(["cpu", "meta"], rigs[1], N_KF, N_PT)
    with pytest.raises(ValueError, match="at least one device"):
        tbs.make_sharded_ba_step([], rigs[1], N_KF, N_PT)


def test_a_shard_off_its_device_raises(rigs, problem):
    obs = tbs.pad_obs_to_multiple(_obs(problem, "torch"), 2)
    shards = tbs.shard_obs(obs, ["cpu", "cpu"])
    shards[1] = topt.BAObservations(*(t.to("meta") for t in shards[1]))
    ba = tbs.make_sharded_ba(["cpu", "cpu"], rigs[1], N_KF, N_PT, iters=1)
    with pytest.raises(ValueError, match="its device is cpu"):
        ba(torch.as_tensor(problem["mt0"]), torch.as_tensor(problem["X0"]), shards,
           *_args(problem, "torch"))


def test_sharded_step_matches_jax(rigs, problem):
    """One damped Schur step at D = 8, lambda 1e-4."""
    jobs = jbs.pad_obs_to_multiple(_obs(problem, "jax"), 8)
    jstep = jbs.make_sharded_ba_step(_jax_mesh(8), rigs[0], N_KF, N_PT)
    jmt, jX, jcost = jstep(jnp.asarray(problem["mt0"]), jnp.asarray(problem["X0"]), jobs,
                           *_args(problem, "jax"), jnp.float64(1e-4))
    tobs = tbs.shard_obs(tbs.pad_obs_to_multiple(_obs(problem, "torch"), 8), CPU8)
    tstep = tbs.make_sharded_ba_step(CPU8, rigs[1], N_KF, N_PT)
    tmt, tX, tcost = tstep(torch.as_tensor(problem["mt0"]), torch.as_tensor(problem["X0"]),
                           tobs, *_args(problem, "torch"), 1e-4)
    np.testing.assert_allclose(tmt.numpy(), np.asarray(jmt), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-12)
    assert not np.allclose(tmt.numpy(), problem["mt0"])


@pytest.fixture(scope="module")
def single(rigs, problem):
    """The port's single-device bundle_adjustment: (mt, X, start cost)."""
    prob = topt.BAProblem(_obs(problem, "torch"), *_args(problem, "torch"))
    mt, X, _ = topt.bundle_adjustment(rigs[1], torch.as_tensor(problem["mt0"]),
                                      torch.as_tensor(problem["X0"]), prob, iters=ITERS)
    _, cost_of = topt.make_ba_blocks(rigs[1], prob.obs, prob.fixed_kf, prob.fixed_pt,
                                     N_KF, N_PT, topt.HUBER_GLOBAL)
    return mt, X, float(cost_of(torch.as_tensor(problem["mt0"]),
                                torch.as_tensor(problem["X0"]))[0])


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_sharded_ba_matches_single_device_and_jax(rigs, problem, single, n_shards):
    devs = ["cpu"] * n_shards
    tobs = tbs.shard_obs(tbs.pad_obs_to_multiple(_obs(problem, "torch"), n_shards), devs)
    ba = tbs.make_sharded_ba(devs, rigs[1], N_KF, N_PT, iters=ITERS)
    mt, X, cost = ba(torch.as_tensor(problem["mt0"]), torch.as_tensor(problem["X0"]), tobs,
                     *_args(problem, "torch"))
    jba = jbs.make_sharded_ba(_jax_mesh(n_shards), rigs[0], N_KF, N_PT, iters=ITERS)
    jmt, jX, jcost = jba(jnp.asarray(problem["mt0"]), jnp.asarray(problem["X0"]),
                         jbs.pad_obs_to_multiple(_obs(problem, "jax"), n_shards),
                         *_args(problem, "jax"))
    smt, sX, start = single
    for got, want in ((mt, smt.numpy()), (X, sX.numpy()), (mt, np.asarray(jmt)),
                      (X, np.asarray(jX))):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-8)
    # converged: at the noise floor, the expected chi2 of 0.5 px noise
    floor = 2 * 0.5 ** 2 * int(problem["valid"].sum())
    assert float(cost) < floor < 0.2 * start, (float(cost), floor, start)
    assert torch.equal(mt[0], torch.as_tensor(problem["mt0"][0]))


@pytest.mark.parametrize("n_kf,n_pt,max_obs,seed", [(4, 120, 4, 0), (9, 400, 6, 5)])
def test_make_ba_problem_matches_jax(rigs, n_kf, n_pt, max_obs, seed):
    want = jsyn.make_ba_problem(rigs[0], n_kf, n_pt, max_obs_per_pt=max_obs, seed=seed)
    got = tsyn.make_ba_problem(rigs[1], n_kf, n_pt, max_obs_per_pt=max_obs, seed=seed)
    for i, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if i == 2:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-9)
        else:
            np.testing.assert_array_equal(b, a)
    uv, valid, pt_obs = got[2], got[6], got[7]
    assert not valid[-1] and valid[:-1].all() and (pt_obs <= len(uv) - 1).all()
    assert ((pt_obs < len(uv) - 1).sum(1) <= max_obs).all()


def _vocabulary():
    rng = np.random.default_rng(7)
    return tv.train_vocabulary(rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint32), k=4,
                               levels=2)


def _slam_map(rigs):
    """tests/test_sharding.py's drifted map (its helper, on the in-repo
    rig) in the port: (map, true poses)."""
    jr, _ = jcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=np.float64)
    jm, mt_true, _, _ = _populate_slam_map(jr)
    return convert.map_from_numpy(jm), mt_true


def _drift(m, mt_true, scaled=False):
    """Each keyframe's distance from its true position; ``scaled``: after
    the least-squares scale about keyframe 0, which this rig observes
    only weakly (its cameras sit 0.1 m from its centre)."""
    est, true = np.stack([m.kf_pose[k][3:] for k in range(4)]), mt_true[:, 3:]
    d, t = est - est[0], true - true[0]
    if scaled:
        d = d * (d * t).sum() / (d * d).sum()
    return np.linalg.norm(d + est[0] - true, axis=1)


def test_loop_closer_global_ba_routes_sharded(rigs, monkeypatch):
    """The counterpart of tests/test_sharding.py::
    test_loop_closer_global_ba_routes_sharded: with a default mesh of eight
    CPU devices the loop closer's post-loop BA goes through
    make_sharded_ba and repairs the drifted map."""
    rig = tcio.load_mcs(tcio.SYNTH_RIG_DIR)[0]
    m, mt_true = _slam_map(rigs)
    m0 = _slam_map(rigs)[0]
    before = _drift(m, mt_true)
    calls = []
    orig = tbs.make_sharded_ba

    def spy(devices, *a, **k):
        calls.append(list(devices))
        return orig(devices, *a, **k)

    monkeypatch.setattr(tbs, "make_sharded_ba", spy)
    monkeypatch.setattr(tgba, "default_mesh", lambda r: [torch.device("cpu")] * 8)
    closer = tlc.LoopCloser(rig, m, _vocabulary(), tkdb.KeyFrameDatabase(),
                            tmt.MatchParams(), global_ba_iters=8)
    closer._global_ba(0)
    assert calls == [[torch.device("cpu")] * 8]
    after = _drift(m, mt_true)
    assert after[0] == before[0] == 0.0
    # the JAX test's bar, with the scale taken out: on this rig the BA
    # optimum of this map lies 1.2% off the true scale in both packages, so
    # the raw drift grows (mean 7.6 mm -> 15.9 mm; with the scale out 7.7
    # mm -> 1.3 mm; the JAX package's own single-device global BA lands
    # within 3 um of the port's)
    before_s, after_s = _drift(m0, mt_true, True), _drift(m, mt_true, True)
    assert after_s[1:].mean() < before_s[1:].mean() / 2.0, (before_s, after_s, before, after)


def test_both_branches_return_the_summed_chi2(rigs, monkeypatch):
    """run_global_ba returns the valid observations' raw chi2 from either
    branch: with no iteration both give the same number, which is not the
    robust cost; after eight iterations both halve the drift (scale taken
    out) and agree to float32 rounding."""
    rig = tcio.load_mcs(tcio.SYNTH_RIG_DIR)[0]
    robust = []
    orig = tbs.make_sharded_ba

    def keep_cost(*a, **k):
        ba = orig(*a, **k)

        def run(*args):
            out = ba(*args)
            robust.append(float(out[2]))
            return out
        return run

    monkeypatch.setattr(tbs, "make_sharded_ba", keep_cost)
    out = {}
    for iters in (0, 8):
        for mesh in (None, CPU8):
            m, mt_true = _slam_map(rigs)
            before = _drift(m, mt_true, True)
            out[iters, mesh is None] = tgba.run_global_ba(rig, m, [0], 1.2, iters=iters,
                                                          devices=mesh)
            after = _drift(m, mt_true, True)
            if iters:
                assert after[1:].mean() < before[1:].mean() / 2.0, (before, after)
            else:
                np.testing.assert_allclose(after, before, rtol=0, atol=1e-7)
    np.testing.assert_allclose(out[0, False], out[0, True], rtol=1e-8)
    assert abs(robust[0] - out[0, False]) > 1e-3 * out[0, False], (robust, out)
    np.testing.assert_allclose(out[8, False], out[8, True], rtol=1e-3)
    assert out[8, True] < 0.5 * out[0, True]


def test_the_default_mesh_is_the_jax_packages():
    rig = tcio.load_mcs(tcio.SYNTH_RIG_DIR)[0]
    assert tgba.default_mesh(rig) == [torch.device("cpu")]
    assert tgba.default_mesh(rig.to("meta")) == [torch.device("meta")]
