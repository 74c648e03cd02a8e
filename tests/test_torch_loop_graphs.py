"""The loop closer's four graphed units (``models/loop_closing.py``):
``sim3_opt.optimize_sim3``, ``sim3_opt.optimize_essential_graph``,
``matcher.fuse_candidates`` (guided SearchBySim3 and the neighbourhood
support) and the post-loop global ``bundle_adjustment``, each run as a
CUDA graph by ``LoopCloser`` on the card and eagerly on the CPU.

On the CPU, on the inputs the units received in a real loop closure (the
organic episode's firing ``insert_keyframe``, replayed on
``tests/data/organic_loop_jax_map.npz`` by the port alone, with one
iteration of the post-loop global BA, about 7 s of the CPU a call):
  - a host-read audit of the four units (``_graphutil.HostReads``, held to
    ``_graphutil.ALLOWED``);
  - through the capture stand-in (``_graphutil.StandIn``): each graphed
    unit, at its warm-up, at a replay and at a later key's first call (no
    warm-up: one replay), equals its eager self bit for bit;
  - the padded Sim3 pairs and essential graph against the same problems
    unpadded: OptimizeSim3's S12 within 1e-6 (measured 2.0e-8 unpadded,
    0 padded to the next bucket), the same inliers; the graph's logs
    within 1e-6 (measured 2.4e-7; 35 keyframes padded to 64, 192 edges to
    256): the padding adds exact zeros, but a longer sum or a larger
    dense solve rounds another way;
  - a second loop at the same buckets replays every unit's graph and
    captures none;
  - the closer's units are the modules' functions on the CPU;
  - the async mapper's repair: a later key of a graphed unit captures with
    no warm-up and its first call returns one replay's outputs, identical
    to the eager function's; the local BA's next observation bucket,
    and of a point's observation lists, captured after the bootstrap
    passes under async mapping (``LocalMapper.capture_ahead``), on a
    problem padded inertly (``pad_ba_problem``), replay when the map
    reaches them.

On the card (``@pytest.mark.cuda``, skipped here) each graphed unit,
warm-up, replay and a later key's first call, equals its eager self bit
for bit, and the system's closer holds its graphs in the mapper's pool
with the mapper's graphed BA. No JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_loop_graphs.py
"""

import copy
import functools
import os

import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch.models import keyframe_database as kdb
from multicol_slam_tpu_torch.models import local_mapping as lm
from multicol_slam_tpu_torch.models import loop_closing as lc_mod
from multicol_slam_tpu_torch.models import matcher, sim3_opt
from multicol_slam_tpu_torch.models import optimizer as opt
from multicol_slam_tpu_torch.models import vocabulary as voc_mod
from multicol_slam_tpu_torch.utils import checkpoint, config_io, convert, episode, graphs

from _graphutil import ALLOWED, HostReads, StandIn

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "organic_loop_jax_map.npz")
UNITS = tuple(lc_mod.UNITS)
FNS = {name: getattr(mod, name) for name, mod in lc_mod.UNITS.items()}


def closer(device="cpu"):
    """The fixture's map and a loop closer as MultiColSLAM builds it (fuse
    through a local mapper, scale held, its pool and graphed BA the
    mapper's), with the post-loop global BA on, its state at the firing
    keyframe. Returns (closer, query keyframe)."""
    m, extra = checkpoint.load_map(FIXTURE, device=device)
    rig = config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0].to(device)
    v = extra["vocabulary"]
    voc = convert.vocabulary_from_numpy(dict(
        centroids=np.asarray(v["centroids"], np.uint32),
        children=np.asarray(v["children"], np.int32),
        word_of_node=np.asarray(v["word_of_node"], np.int32),
        weights=np.asarray(v["weights"], np.float32),
        k=v["k"], levels=v["levels"], n_words_=v["n_words_"]))
    params = matcher.MatchParams()
    n_levels = episode.SETTINGS["n_levels"]
    mapper = lm.LocalMapper(rig, m, params, scale_factor=1.2, n_levels=n_levels)
    lc = lc_mod.LoopCloser(rig, m, voc, kdb.KeyFrameDatabase(), params, fix_scale=True,
                           fuser=mapper, scale_factor=1.2, n_levels=n_levels,
                           global_ba_iters=1, pool=mapper.pool,
                           bundle_adjust=mapper._bundle_adjust)
    for kf in extra["db_kfs"]:
        lc.db.add(kf, voc_mod.bow_vector(lc.voc, lc._bow_of_kf(kf)[0]))
    lc.consistent_groups = [(set(g), c) for g, c in extra["consistent_groups"]]
    lc.last_loop_kf = extra["last_loop_kf"]
    return lc, extra["query_kf"]


def recording(lc, calls):
    """Record every call of the closer's units: (args, kwargs, output)."""
    unit = lc.unit

    def recorded(name):
        fn = unit(name)

        def rec(*a, **k):
            out = fn(*a, **k)
            calls.setdefault(name, []).append((copy.deepcopy((a, k)), out))
            return out
        return rec
    lc.unit = recorded


@functools.lru_cache(maxsize=None)
def recorded():
    """unit -> [((args, kwargs), output)] of every call the closer made
    while it fired the loop, on the CPU."""
    torch.set_num_threads(2)
    lc, query = closer()
    calls: dict = {}
    recording(lc, calls)
    assert lc.insert_keyframe(query)
    assert set(calls) == set(UNITS), sorted(calls)
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


def test_loop_units_read_nothing_on_the_host():
    calls = recorded()
    with HostReads() as mode:
        for u in UNITS:
            (a, k), _ = calls[u][0]
            FNS[u](*a, **k)
    found = {(f, fn) for f, fn, _ in mode.reads}
    assert found <= ALLOWED, {k: n for k, n in mode.reads.items() if k[:2] not in ALLOWED}


def system_closer(tmp_path, device):
    """A MultiColSLAM's loop closer, built from the fixture's vocabulary
    saved to a file."""
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    lc, _ = closer()
    path = str(tmp_path / "voc.npz")
    voc_mod.save_vocabulary(lc.voc, path)
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, vocabulary_path=path,
                        device=device)
    slam._ensure_loop_closer(0)
    return slam


def test_closer_units_plain_on_the_cpu(tmp_path):
    slam = system_closer(tmp_path, "cpu")
    for lc in (closer()[0], slam.loop_closer):
        assert lc.graphs == {}
        assert all(lc.unit(u) is FNS[u] for u in UNITS)
    assert slam._global_adjust is opt.bundle_adjustment


def test_graphed_loop_units_equal_eager(monkeypatch):
    """Each unit through the stand-in: its warm-up, a replay on the same
    inputs, then the unit's other recorded calls (a replay, or a later
    key's first call), each identical to what the closer got from the
    eager function on the same inputs."""
    stand = StandIn(monkeypatch)
    calls = recorded()
    pool = graphs.Pool("mapper")
    for u in UNITS:
        g = graphs.jit(FNS[u], pool)
        for (a, k), out in calls[u][:1] + calls[u][:3]:
            assert_identical(g(*a, **k), out)
        assert g.replays >= 1 and g.captures == len(g)
    assert stand.warm_ups == len(UNITS) and stand.replays >= len(UNITS)


def sim3_call(padded_to=None):
    """The recorded first OptimizeSim3 call, its pairs cut to the valid
    rows (``padded_to`` None) or padded as the closer pads to ``padded_to``
    rows."""
    (a, k), _ = recorded()["optimize_sim3"][0]
    rig, S0, obs = a
    n = int(obs.valid.sum())
    assert bool(obs.valid[:n].all()) and obs.valid.shape[0] > n
    rows = torch.arange(n) if padded_to is None else torch.cat(
        [torch.arange(n), torch.zeros(padded_to - n, dtype=torch.long)])
    cut = sim3_opt.Sim3Obs(*(t[rows] for t in obs))
    return rig, S0, cut._replace(valid=torch.arange(len(rows)) < n), k, n


@pytest.mark.parametrize("rows", [None, 1024])
def test_padded_sim3_pairs_against_unpadded(rows):
    """The closer's pairs padded to its bucket against the same pairs
    unpadded and padded to the next bucket: S12 within 1e-6, the real
    rows' inliers identical."""
    rig, S0, obs, k, n = sim3_call(rows)
    (_, _), (S_pad, inl_pad, n_pad) = recorded()["optimize_sim3"][0]
    S, inl, n_in = sim3_opt.optimize_sim3(rig, S0, obs, **k)
    for x, y in zip(S, S_pad):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
    assert torch.equal(inl[:n], inl_pad[:n]) and int(n_in) == int(n_pad)
    assert not inl[n:].any() and not inl_pad[n:].any()


def test_padded_essential_graph_against_unpadded():
    """The closer's essential graph padded to its buckets against the same
    graph with its padding cut off: every keyframe's log within 1e-6."""
    (a, k), out = recorded()["optimize_essential_graph"][0]
    logs, graph = a
    E = int(graph.valid.sum())
    assert bool(graph.valid[:E].all()) and graph.valid.shape[0] > E
    N = int(torch.maximum(graph.edge_i[:E], graph.edge_j[:E]).max()) + 1
    assert logs.shape[0] > N and bool(graph.fixed[N:].all())
    cut = sim3_opt.EssentialGraph(graph.edge_i[:E], graph.edge_j[:E], graph.meas[:E],
                                  graph.valid[:E], graph.fixed[:N])
    got = sim3_opt.optimize_essential_graph(logs[:N], cut, **k)
    torch.testing.assert_close(got, out[:N], rtol=0, atol=1e-6)
    assert torch.equal(out[N:], logs[N:])            # padded keyframes stay fixed


def test_a_second_loop_at_the_same_buckets_replays(monkeypatch):
    """The loop fired twice from the same state through the stand-in's
    graphs (the global BA off: ``test_torch_mapping_graphs.py`` holds the
    BA's graphs): the first captures each unit's keys, the second replays
    every call and captures nothing, and both move the map alike."""
    stand = StandIn(monkeypatch)
    pool = graphs.Pool("mapper")
    units = {u: graphs.jit(FNS[u], pool) for u in UNITS if u != "bundle_adjustment"}
    maps = []
    for _ in range(2):
        lc, query = closer()
        lc.graphs = dict(units)
        lc.global_ba_iters = 0
        assert lc.insert_keyframe(query)
        maps.append(lc.map)
        if len(maps) == 1:
            captures = {u: g.captures for u, g in units.items()}
            replays = {u: g.replays for u, g in units.items()}
            n_calls = {u: len(c) for u, c in recorded().items() if u != "bundle_adjustment"}
            assert all(c >= 1 for c in captures.values()) and stand.warm_ups == len(units)
    assert {u: g.captures for u, g in units.items()} == captures
    assert {u: g.replays - replays[u] for u, g in units.items()} == n_calls
    np.testing.assert_array_equal(maps[0].kf_pose, maps[1].kf_pose)
    np.testing.assert_array_equal(maps[0].pt_pos, maps[1].pt_pos)


def test_a_later_key_first_call_equals_eager(monkeypatch):
    """A later key of a unit already captured on the pool and device
    captures with no warm-up and returns the outputs of one replay,
    identical to the eager function's: OptimizeSim3 on the pairs padded to
    the next bucket."""
    stand = StandIn(monkeypatch)
    (a, k), out = recorded()["optimize_sim3"][0]
    g = graphs.jit(sim3_opt.optimize_sim3, graphs.Pool("mapper"))
    assert_identical(g(*a, **k), out)
    rig, S0, obs, k2, _ = sim3_call(4 * a[2].valid.shape[0])
    assert stand.warm_ups == 1 and stand.captures == 1 and stand.replays == 0
    got = g(rig, S0, obs, **k2)
    assert stand.warm_ups == 1 and stand.captures == 2 and stand.replays == 1
    assert g.replays == 0
    assert_identical(got, sim3_opt.optimize_sim3(rig, S0, obs, **k2))


def test_padded_problem_is_inert():
    """pad_ba_problem to the next observation bucket: the BA bit for bit
    the unpadded one (one CPU thread); to the next bucket of a point's
    observations too, within test_torch_mapping_graphs.py's bars for that
    axis (1e-5 in every pose entry, 5e-5 m)."""
    import test_torch_mapping_graphs as mg
    rig, problem, mt0, X0, (K, P, N, Mo) = mg.synthetic_ba()
    prob, m, x = mg.pad_ba(problem, mt0, X0, K, P, N, Mo)
    rows = lm.pad_ba_problem(prob, 4 * (K - 1) + 1, Mo)
    both = lm.pad_ba_problem(prob, 4 * (K - 1) + 1, 4 * Mo)
    assert rows.obs.uv.shape[0] == 4 * (K - 1) + 1 and not rows.obs.valid[K:].any()
    assert both.pt_obs.shape[1] == 4 * Mo and bool((both.pt_obs[:, Mo:] == K - 1).all())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        kw = dict(huber=opt.HUBER_LOCAL, iters=5)
        want = opt.bundle_adjustment(rig, m, x, prob, **kw)
        got = opt.bundle_adjustment(rig, m, x, rows, **kw)
        got2 = opt.bundle_adjustment(rig, m, x, both, **kw)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2][:K], want[2])
    torch.testing.assert_close(got2[0], want[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(got2[1], want[1], rtol=0, atol=5e-5)


def test_capture_ahead_captures_the_next_observation_bucket(monkeypatch):
    import test_torch_mapping_graphs as mg
    from multicol_slam_tpu_torch.models.map import MapStore
    stand = StandIn(monkeypatch)
    rig, problem, mt0, X0, (K, P, N, Mo) = mg.synthetic_ba()
    prob, m, x = mg.pad_ba(problem, mt0, X0, K, P, N, Mo)
    mapper = lm.LocalMapper(rig, MapStore(capacity_pts=16, capacity_kfs=4, n_cams=3,
                                          k_per_cam=8, desc_words=8), matcher.MatchParams())
    mapper.capture_ahead()                       # on the CPU: nothing to capture
    assert stand.captures == 0
    mapper.pool = graphs.Pool("mapper")
    mapper._bundle_adjust = graphs.jit(opt.bundle_adjustment, mapper.pool)
    kw = dict(huber=opt.HUBER_LOCAL, iters=mapper.ba_iters)
    mapper._bundle_adjust(rig, m, x, prob, **kw)             # the bootstrap's pass
    mapper._last_ba = (prob, m.numpy(), x.numpy())
    mapper.capture_ahead()
    assert stand.captures == 4 and stand.warm_ups == 1
    for k, mo in ((4 * (K - 1) + 1, Mo), (K, 4 * Mo), (4 * (K - 1) + 1, 4 * Mo)):
        big = lm.pad_ba_problem(prob, k, mo)
        got = mapper._bundle_adjust(rig, m, x, big, **kw)
        assert_identical(got, opt.bundle_adjustment(rig, m, x, big, **kw))
    assert stand.captures == 4 and mapper._bundle_adjust.replays == 3


@pytest.mark.parametrize("async_mapping", [False, True])
def test_the_bootstrap_captures_ahead_under_async_mapping(async_mapping, monkeypatch):
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, device="cpu",
                        async_mapping=async_mapping, enable_loop_closing=False)
    try:
        calls = []
        monkeypatch.setattr(slam, "_process_kf", lambda kf: calls.append(kf))
        monkeypatch.setattr(slam.mapper, "capture_ahead", lambda: calls.append("ahead"))
        slam._process_init_kfs(0, 1)
        assert calls == ([0, 1, "ahead"] if async_mapping else [0, 1])
    finally:
        slam.shutdown()


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
def test_system_closer_holds_graphs_in_the_mappers_pool(card, tmp_path):
    slam = system_closer(tmp_path, card)
    lc, mapper = slam.loop_closer, slam.mapper
    assert all(isinstance(lc.graphs[u], graphs.jit) for u in UNITS)
    assert all(lc.graphs[u].pool is mapper.pool for u in UNITS)
    assert lc.graphs["bundle_adjustment"] is mapper._bundle_adjust
    assert isinstance(slam._global_adjust, graphs.jit)
    assert slam._global_adjust.pool is graphs.SHARED


@pytest.mark.cuda
def test_graphed_loop_units_equal_eager_on_the_card(card):
    calls = recorded()
    pool = graphs.Pool("mapper")
    for u in UNITS:
        g = graphs.jit(FNS[u], pool)
        for (a, k), _ in calls[u][:2]:
            a, k = to_card((a, k), card)
            for _ in range(2):                    # the first call, then a replay
                got = g(*a, **k)
                want = FNS[u](*a, **k)
                torch.cuda.synchronize()
                assert_identical(got, want)
        assert g.replays >= len(calls[u][:2])


@pytest.mark.cuda
def test_a_later_key_first_call_equals_eager_on_the_card(card):
    (a, k), _ = recorded()["optimize_sim3"][0]
    g = graphs.jit(sim3_opt.optimize_sim3, graphs.Pool("mapper"))
    a, k = to_card((a, k), card)
    assert_identical(g(*a, **k), sim3_opt.optimize_sim3(*a, **k))
    rig, S0, obs, k2, _ = to_card(sim3_call(4 * a[2].valid.shape[0]), card)
    got = g(rig, S0, obs, **k2)
    torch.cuda.synchronize()
    assert g.captures == 2 and g.replays == 0
    assert_identical(got, sim3_opt.optimize_sim3(rig, S0, obs, **k2))


@pytest.mark.cuda
def test_capture_ahead_replays_equal_eager_on_the_card(card):
    import test_torch_mapping_graphs as mg
    from multicol_slam_tpu_torch.models.map import MapStore
    rig, problem, mt0, X0, (K, P, N, Mo) = mg.synthetic_ba()
    prob, m, x = to_card(mg.pad_ba(problem, mt0, X0, K, P, N, Mo), card)
    rig = rig.to(card)
    mapper = lm.LocalMapper(rig, MapStore(capacity_pts=16, capacity_kfs=4, n_cams=3,
                                          k_per_cam=8, desc_words=8), matcher.MatchParams())
    kw = dict(huber=opt.HUBER_LOCAL, iters=mapper.ba_iters)
    mapper._bundle_adjust(rig, m, x, prob, **kw)
    mapper._last_ba = (prob, m.cpu().numpy(), x.cpu().numpy())
    mapper.capture_ahead()
    g = mapper._bundle_adjust
    assert g.captures == 4 and g.replays == 0
    big = lm.pad_ba_problem(prob, 4 * (K - 1) + 1, 4 * Mo)
    got = g(rig, m, x, big, **kw)
    want = opt.bundle_adjustment(rig, m, x, big, **kw)
    torch.cuda.synchronize()
    assert g.captures == 4 and g.replays == 1
    assert_identical(got, want)
