"""The tracker's units off the fused path (``models/tracking.py``): the
standalone extraction, ``motion_track_step``, ``extract_motion_track_step``,
``window_search``, ``pose_optimization``, ``local_map_track_step``, the
relocalization's projection round, ``initializer.initialize_device`` and
``ransac.ransac_gpnp`` (drawing from the tracker's generator) and the BoW
transform of a frame, each a CUDA graph of the tracker's pool on the card
and eager on the CPU.

On the CPU, on the inputs the units received in a real run (the system at
full width over frames 0-19 of ``bench_trajectory``, a relocalization
forced on frame 18, and the units the run did not reach called once on
its last frame's state):
  - a host-read audit of every unit (``_graphutil.HostReads``, held to
    ``_graphutil.ALLOWED``), the per-device constants made before it;
  - through the capture stand-in (``_graphutil.StandIn``): each graphed
    unit, at its warm-up and at a replay, equals its eager self bit for
    bit, and a RANSAC unit leaves the generator where the eager call does;
  - the pose LM, the GP3P RANSAC and the projection round padded to the
    frame's C * K rows against the power-of-two buckets they padded to
    before: within 1e-6, the same inliers and matches, GP3P drawing the
    same sets from the same generator state;
  - ``Tracker.capture_ahead`` captures every unit a relocalization, the
    frame after the bootstrap and the first fused frame run (the WORKING
    step and the chunk scan's body too), and leaves the generator's state
    unchanged;
  - the relocalization transforms the frame once for SearchByBoW, not
    once per candidate keyframe, with the same triples;
  - ``graphs.jit`` refuses a generator on another device than the
    tensors.

No JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracker_graphs.py
"""

import functools

import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch.models import initializer, matcher, tracking
from multicol_slam_tpu_torch.models import optimizer as opt
from multicol_slam_tpu_torch.models.vocabulary import transform_words
from multicol_slam_tpu_torch.ops import ransac
from multicol_slam_tpu_torch.utils import graphs

from _graphutil import ALLOWED, HostReads, StandIn

FRAMES = 20
RELOC_AT = 18
PER_UNIT = 3


def _fns(tr):
    """Each tracker unit's eager function."""
    return {"_working_step": tracking.working_track_step,
            "_scan_body": tracking.working_scan_body,
            "_extract_unit": tr.extract, "_extract_init_unit": tr.extract_init,
            "_motion_step": tracking.motion_track_step,
            "_extract_motion_step": tracking.extract_motion_track_step,
            "_window_search": matcher.window_search,
            "_pose_opt": opt.pose_optimization,
            "_local_map_step": tracking.local_map_track_step,
            "_reloc_projection": tracking.reloc_projection_round,
            "_init_device": initializer.initialize_device,
            "_gpnp": ransac.ransac_gpnp, "bow_transform": transform_words}


NEW_UNITS = ("_extract_unit", "_extract_init_unit", "_motion_step", "_extract_motion_step",
             "_window_search", "_pose_opt", "_local_map_step", "_reloc_projection",
             "_init_device", "_gpnp", "bow_transform")


def _gen_of(a):
    return next((x for x in a if isinstance(x, torch.Generator)), None)


@functools.lru_cache(maxsize=None)
def recorded():
    """(system, unit -> [(args, kwargs, generator state before)], the
    BoW transform's calls by frame, the frames). The system runs at full
    width on the CPU over frames 0-19 with a relocalization forced on
    frame 18; the units the run did not reach are called once on its
    last frame's state."""
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io, synthetic

    torch.set_num_threads(2)
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, device="cpu")
    tr = slam.tracker
    fns = _fns(tr)
    assert all(tr.units()[u] is fns[u] for u in tracking.UNIT_NAMES)   # eager on the CPU
    calls = {u: [] for u in NEW_UNITS}
    transforms = []

    for u in NEW_UNITS:
        def rec(*a, _u=u, _fn=getattr(tr, u), **k):
            if _u == "bow_transform":
                transforms.append((tr.frame_id, k.get("levelsup")))
            if len(calls[_u]) < PER_UNIT:
                gen = _gen_of(a)
                calls[_u].append((a, k, None if gen is None else gen.get_state()))
            return _fn(*a, **k)
        setattr(tr, u, rec)
    gt = synthetic.bench_trajectory(FRAMES)
    render = synthetic.make_renderer(slam.rig)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32))).to(torch.uint8)
    for i in range(FRAMES):
        if i == RELOC_AT:
            tr.force_reloc = True
        slam.track(frames[i], i / 25.0)
    assert tr.frame_path[RELOC_AT] == "reloc", tr.frame_path

    # the units this run did not reach, once each on its last frame
    pts, has = tr._gather_last_slot_points()
    mt_pred = tr._to_dev(tr.last_mt.astype(np.float32))
    if not calls["_motion_step"]:
        tr._motion_step(tr.rig, mt_pred, tr._to_dev(pts), tr._to_dev(has), tr.cur_feats,
                        tr.last_feats, tr._to_dev(tr.cur_pt >= 0), tr.params,
                        th=tr.cfg.motion_th)
    if not calls["_extract_motion_step"]:
        tr._extract_motion_step(tr.extract, tr.rig, frames[FRAMES - 1], mt_pred,
                                tr._to_dev(pts), tr._to_dev(has), tr.last_feats, tr.params,
                                th=tr.cfg.motion_th)
    if not calls["_reloc_projection"]:
        kf = int(slam.map.keyframe_ids()[-1])
        arr = slam.map.kf_pt[kf]
        tr._reloc_projection(*tr._projection_inputs(np.unique(arr[arr >= 0])))
    missing = [u for u in NEW_UNITS if not calls[u]]
    assert not missing, missing
    return slam, calls, transforms, frames


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


def test_units_eager_on_the_cpu():
    slam, _, _, _ = recorded()
    assert not any(isinstance(u, graphs.jit) for u in slam.tracker.units().values())
    assert slam.loop_closer.kf_transform is None


def test_units_read_nothing_on_the_host():
    slam, calls, _, _ = recorded()
    fns = _fns(slam.tracker)
    with HostReads() as mode:
        for u in NEW_UNITS:
            a, k, state = calls[u][0]
            if state is not None:
                _gen_of(a).set_state(state)
            fns[u](*a, **k)
    found = {(f, fn) for f, fn, _ in mode.reads}
    assert found <= ALLOWED, {k: n for k, n in mode.reads.items() if k[:2] not in ALLOWED}


def test_graphed_units_equal_eager(monkeypatch):
    """Each unit through the stand-in, on every recorded call and then the
    first again (a replay): outputs identical to the eager function's, and
    the generator where the eager call leaves it."""
    stand = StandIn(monkeypatch)
    slam, calls, _, _ = recorded()
    fns = _fns(slam.tracker)
    for u in NEW_UNITS:
        g = graphs.jit(fns[u])
        for a, k, state in calls[u] + calls[u][:1]:
            gen = _gen_of(a)
            if gen is not None:
                gen.set_state(state)
            want = fns[u](*a, **k)
            want_state = None if gen is None else gen.get_state()
            if gen is not None:
                gen.set_state(state)
            assert_identical(g(*a, **k), want)
            if gen is not None:
                assert torch.equal(gen.get_state(), want_state), u
        assert g.replays >= 1 and g.captures == len(g), u
        if u in ("_init_device", "_gpnp"):
            assert [gen.device.type for gen in g.generators] == ["cpu"]
    assert stand.captures >= len(NEW_UNITS) and stand.replays >= len(NEW_UNITS)


def _rows(t, n):
    return t[:n]


def test_padding_to_the_frame_slots_matches_the_buckets():
    """The pose LM, GP3P and the projection round at C * K rows against
    the power-of-two buckets of the same rows (bucket(n, 128))."""
    slam, calls, _, _ = recorded()
    tr = slam.tracker
    C, K = tr.cur_pt.shape
    for a, k, _ in calls["_pose_opt"]:
        rig, mt0, obs, X = a
        assert obs.uv.shape[0] == C * K
        n = int(obs.valid.sum())
        b = tracking.bucket(n, 128)
        small = opt.BAObservations(*(_rows(t, b) for t in obs))
        mt_a, inl_a, n_a, _ = opt.pose_optimization(rig, mt0, obs, X, **k)
        mt_b, inl_b, n_b, _ = opt.pose_optimization(rig, mt0, small, _rows(X, b), **k)
        assert torch.allclose(mt_a, mt_b, atol=1e-6, rtol=0)
        assert torch.equal(inl_a[:n], inl_b[:n]) and int(n_a) == int(n_b)
    for a, k, state in calls["_gpnp"]:
        gen, origins, dirs, X, valid = a
        assert X.shape[0] == C * K
        n = int(valid.sum())
        b = tracking.bucket(n, 128)
        gen.set_state(state)
        T_a, inl_a, n_a = ransac.ransac_gpnp(gen, origins, dirs, X, valid, **k)
        gen.set_state(state)
        T_b, inl_b, n_b = ransac.ransac_gpnp(gen, *(_rows(t, b) for t in (origins, dirs, X,
                                                                          valid)), **k)
        assert torch.allclose(T_a, T_b, atol=1e-6, rtol=0)
        assert torch.equal(inl_a[:n], inl_b[:n]) and int(n_a) == int(n_b)
    for a, k, _ in calls["_reloc_projection"]:
        (rig, mt, X, normal, mind, maxd, cand_ok, cur, has, desc, dmask, params, th,
         orb_dist, n_levels, sf) = a
        assert X.shape[0] == C * K
        P = int(cand_ok.sum())
        b = tracking.bucket(P, 128)
        m_a = tracking.reloc_projection_round(*a, **k)
        m_b = tracking.reloc_projection_round(
            rig, mt, *(_rows(t, b) for t in (X, normal, mind, maxd, cand_ok)), cur, has,
            _rows(desc, b), _rows(dmask, b), params, th, orb_dist, n_levels, sf)
        assert torch.equal(m_a[:, :P], m_b[:, :P])


def test_capture_ahead_captures_the_keys_and_keeps_the_generator(monkeypatch):
    """The tracker's units made graphs (the stand-in), capture_ahead on the
    run's last frame: every unit a relocalization, the frame after the
    bootstrap and the first fused frame call is captured, and ``gen`` is
    where it was."""
    StandIn(monkeypatch)
    slam, _, _, frames = recorded()
    tr = slam.tracker
    fns = _fns(tr)
    for u in tracking.UNIT_NAMES:
        monkeypatch.setattr(tr, u, graphs.jit(fns[u]))
    monkeypatch.setattr(tr, "captured_ahead", [])
    monkeypatch.setattr(tr, "_snap_cache", None)
    before = tr.gen.get_state()
    tr.capture_ahead(frames[FRAMES - 1])
    assert torch.equal(tr.gen.get_state(), before)
    assert set(tr.captured_ahead) == {"_extract_unit", "_window_search", "_pose_opt",
                                      "_gpnp", "_reloc_projection", "_local_map_step",
                                      "bow_transform", "_working_step",
                                      "_scan_body"}, tr.captured_ahead
    assert tr.bow_transform.captures == 2 and tr._local_map_step.captures == 2
    n = sum(u.captures for u in tr.units().values())
    tr.capture_ahead(frames[FRAMES - 1])          # once a run
    assert sum(u.captures for u in tr.units().values()) == n


def test_relocalization_transforms_the_frame_once():
    """The forced relocalization transforms the frame once for the
    candidates and once for SearchByBoW (not once per candidate keyframe),
    and the cached nodes give the triples a fresh transform gives."""
    slam, _, transforms, _ = recorded()
    lc, tr = slam.loop_closer, slam.tracker
    at = [lv for f, lv in transforms if f == RELOC_AT]
    assert sorted(at, key=str) == sorted([None, lc.voc.levels - 1], key=str), transforms
    feats = tr.cur_feats
    kfs = slam.map.keyframe_ids()[-4:].tolist()
    cached = [lc.bow_match_frame(kf, feats) for kf in kfs]
    fresh = []
    for kf in kfs:
        lc._frame_nodes = None
        fresh.append(lc.bow_match_frame(kf, feats))
    assert cached == fresh and any(cached)


def test_generator_on_another_device_raises():
    g = graphs.jit(lambda gen, x: x + torch.rand(x.shape, generator=gen, device=x.device))
    with pytest.raises(ValueError, match="generator"):
        g(torch.Generator(device="cpu"), torch.zeros(3, device="meta"))
