"""The port's CUDA graphs (``utils/graphs.py``) and what they capture.

On the CPU:
  - a host-read audit: ``working_track_step`` and one step of
    ``working_scan_body`` run at the in-repo rig's full width (754x480,
    the default ``SlamSettings``, the system's padded extractor) for 2
    frames under a ``TorchFunctionMode`` that records every read of a
    tensor on the host, every data-dependent shape and every tensor made
    from host data; any of these inside a captured step would break the
    capture on the card. The reads are held to ``ALLOWED``, a commented
    list of sites that read no tensor derived from an input;
  - the wrapper's bookkeeping through ``StandIn``, a capture stand-in of
    this file only: its "capture" runs the function once on the static
    buffers and keeps the outputs, its "replay" runs it again and writes
    the results into those outputs, as a graph's replay does. One capture
    per key, a new one when the local map's bucket or a static argument
    changes; each call's own result; an output kept from one call
    unchanged by the next; launch counts that add up per replay;
  - through the stand-in, the graphed ``working_track_step`` and the
    graphed scan body equal the eager ones bit for bit, and the graphed
    step the JAX package's to ``tests/test_torch_slice.py``'s bars.

On the card (``@pytest.mark.cuda``, skipped here): the graphed step
equals the eager step bit for bit over 3 frames, and the graphed scan
body over a chunk of 4. These import no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs.py
"""

import functools
from collections import Counter

import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch.models import tracking
from multicol_slam_tpu_torch.models.extractor import Features
from multicol_slam_tpu_torch.utils import graphs

from _graphutil import ALLOWED, HostReads, StandIn  # noqa: F401


@functools.lru_cache(maxsize=None)
def full_width():
    """(system, ground truth, uint8 frames (4, C, 480, 754), the
    gt_bootstrap state from frame 0): the system's own padded extractor
    at the default SlamSettings, on the CPU."""
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io, synthetic

    torch.set_num_threads(2)
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, device="cpu",
                        enable_loop_closing=False)
    gt = synthetic.smooth_trajectory(100, radius=0.6)[:4]
    render = synthetic.make_renderer(slam.rig)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32))).to(torch.uint8)
    s = slam.settings
    st = synthetic.gt_bootstrap(slam.rig, torch.tensor(gt[0], dtype=torch.float32),
                                slam._extract_padded(frames[0]), s.n_levels,
                                s.scale_factor)
    return slam, gt, frames, st


def lp_slot_of(st):
    """The (cap, C) snapshot-index -> slot table of gt_bootstrap's slots."""
    C, K = st["slot_has0"].shape
    lp = st["slot_lp0"].cpu().numpy()
    out = np.full((st["X"].shape[0], C), -1, np.int32)
    for c in range(C):
        ks = np.nonzero(lp[c] >= 0)[0]
        out[lp[c, ks], c] = ks
    return torch.from_numpy(out).to(st["slot_lp0"].device)


def step_args(slam, st, img):
    s, tcfg = slam.settings, slam.tracker.cfg
    return ((slam._extract_padded, slam.rig, img, st["mt0"], st["slot_X0"],
             st["slot_has0"], st["last"], lp_slot_of(st), st["X"], st["normal"],
             st["mind"], st["maxd"], st["cand_base"], st["pt_desc"], st["pt_mask"],
             slam.tracker.params),
            dict(th_motion=tcfg.motion_th, th_local=tcfg.local_map_th,
                 n_levels=s.n_levels, scale_factor=s.scale_factor))


def body_args(slam, st, img):
    s, tcfg = slam.settings, slam.tracker.cfg
    carry = (st["last"], st["slot_X0"], st["slot_lp0"], st["slot_has0"], st["mt0"],
             st["V0"])
    return ((slam._extract_padded, slam.rig, img, carry, st["X"], st["normal"],
             st["mind"], st["maxd"], st["cand_base"], st["pt_desc"], st["pt_mask"],
             slam.tracker.params),
            dict(th_motion=tcfg.motion_th, th_local=tcfg.local_map_th,
                 n_levels=s.n_levels, scale_factor=s.scale_factor))


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


# -- the host-read audit -------------------------------------------------------

def test_captured_steps_read_nothing_on_the_host():
    slam, _, frames, st = full_width()
    with HostReads() as mode:
        for b in (1, 2):
            a, kw = step_args(slam, st, frames[b])
            tracking.working_track_step(*a, **kw)
            a, kw = body_args(slam, st, frames[b])
            tracking.working_scan_body(*a, **kw)
    found = {(f, fn) for f, fn, _ in mode.reads}
    assert ("models/tracking.py", "frustum_check", "item") in mode.reads
    assert found <= ALLOWED, {k: n for k, n in mode.reads.items() if k[:2] not in ALLOWED}


def test_audit_sees_a_host_read():
    """The audit's own check: a read of a value, a boolean mask and a
    tensor from a list inside the package are each recorded."""
    from multicol_slam_tpu_torch.ops import geometry
    x = torch.arange(6, dtype=torch.float32)
    with HostReads() as mode:
        geometry.cayley2hom(x).sum().item()
    assert not mode.reads
    with HostReads() as mode:
        tracking.fetch(x)          # .cpu() inside the package
    assert ("models/tracking.py", "fetch", "cpu") in mode.reads


# -- the wrapper's bookkeeping through a capture stand-in ----------------------

LAUNCHES = Counter()


def toy(x, feats: Features, scale: float, n: int):
    """A function with one "kernel" launch, reported as the wrappers do."""
    graphs.on_launch(lambda: LAUNCHES.update(["toy"]))
    y = x * scale + n
    return {"y": y, "feats": feats._replace(xy=feats.xy + y.sum())}


def toy_feats(k, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g)
    return Features(xy=r(3, k, 2), level=torch.zeros(3, k, dtype=torch.int32),
                    angle=r(3, k), response=r(3, k), ray=r(3, k, 3),
                    desc=torch.zeros(3, k, 8, dtype=torch.int32),
                    desc_mask=torch.full((3, k, 8), -1, dtype=torch.int32),
                    valid=torch.ones(3, k, dtype=torch.bool))


def test_one_capture_per_key(monkeypatch):
    stand = StandIn(monkeypatch)
    f = graphs.jit(toy)
    x = torch.ones(256)
    f(x, toy_feats(8, 0), 2.0, 1)
    f(x + 1, toy_feats(8, 1), 2.0, 1)
    f(x + 2, toy_feats(8, 2), 2.0, 1)
    assert stand.captures == 1 and stand.replays == 2 and len(f) == 1
    f(torch.ones(512), toy_feats(8, 0), 2.0, 1)        # a new bucket
    f(x, toy_feats(8, 0), 3.0, 1)                      # a static argument
    f(x, toy_feats(8, 0), 2.0, 2)
    f(x, toy_feats(16, 0), 2.0, 1)                     # a NamedTuple leaf's shape
    f(x.double(), toy_feats(8, 0), 2.0, 1)             # a dtype
    assert stand.captures == 6 and len(f) == 6
    f(torch.ones(512) * 5, toy_feats(8, 3), 2.0, 1)
    # one warm-up, the first key's; each later key captured at once and
    # its first call replayed the graph
    assert stand.captures == 6 and f.replays == 3
    assert stand.warm_ups == 1 and stand.replays == 3 + 5


def test_each_call_returns_its_own_result_and_kept_outputs_stay(monkeypatch):
    StandIn(monkeypatch)
    f = graphs.jit(toy)
    want = [toy(torch.full((256,), float(i)), toy_feats(8, i), 2.0, 1) for i in range(3)]
    got = [f(torch.full((256,), float(i)), toy_feats(8, i), 2.0, 1) for i in range(3)]
    for g, w in zip(got, want):          # each call's own, kept over later calls
        assert_identical(g, w)
    entry = next(iter(f._graphs.values()))
    for out in leaves(got[2]):           # copies, not the graph's own outputs
        assert all(out.data_ptr() != o.data_ptr() for o in entry.outputs)


def test_launch_counts_add_up_per_replay(monkeypatch):
    StandIn(monkeypatch)
    f = graphs.jit(toy)
    LAUNCHES.clear()
    for i in range(5):
        f(torch.full((256,), float(i)), toy_feats(8, i), 2.0, 1)
        assert LAUNCHES["toy"] == i + 1     # the warm-up, then one per replay
    f(torch.ones(512), toy_feats(8, 0), 2.0, 1)
    assert LAUNCHES["toy"] == 6
    assert not graphs.capturing()


def test_a_failed_capture_raises_naming_the_function(monkeypatch):
    def broken(run, device, pool):
        raise RuntimeError("operation not permitted when stream is capturing")
    monkeypatch.setattr(graphs, "_warm_up", lambda run, device, pool: run())
    monkeypatch.setattr(graphs, "_capture", broken)
    f = graphs.jit(toy)
    with pytest.raises(RuntimeError, match="capture of toy failed"):
        f(torch.ones(4), toy_feats(8, 0), 2.0, 1)
    assert len(f) == 0 and not graphs.capturing()


def test_captures_on_two_threads_run_one_at_a_time(monkeypatch):
    """Two threads' first calls at once (the tracker and the async mapper):
    their warm-ups may overlap, their captures do not, and the cyclic
    garbage collector is off inside each capture and on again after."""
    import gc
    import threading
    import time

    stand = StandIn(monkeypatch)
    inner, state = stand.capture, dict(now=0, most=0, gc_on=[])
    lock = threading.Lock()

    def slow_capture(run, device, pool):
        with lock:
            state["now"] += 1
            state["most"] = max(state["most"], state["now"])
        state["gc_on"].append(gc.isenabled())
        time.sleep(0.2)
        try:
            return inner(run, device, pool)
        finally:
            with lock:
                state["now"] -= 1

    monkeypatch.setattr(graphs, "_capture", slow_capture)
    threads = [threading.Thread(target=graphs.jit(toy), args=(torch.ones(4 * (i + 1)),
                                                             toy_feats(8, i), 2.0, 1))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert stand.captures == 2 and state["most"] == 1
    assert state["gc_on"] == [False, False] and gc.isenabled()


def test_cpu_tensors_raise_without_a_stand_in():
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        graphs.jit(toy)(torch.ones(4), toy_feats(8, 0), 2.0, 1)


def test_tracker_graphs_only_on_the_card():
    slam, *_ = full_width()
    assert slam.tracker._working_step is tracking.working_track_step
    assert slam.tracker._scan_body is tracking.working_scan_body


def test_graphed_step_and_scan_body_equal_eager(monkeypatch):
    """Through the stand-in: the graphed step over frames 1-3 (frame 1
    the warm-up, 2-3 replays) and the graphed scan body over the chunk
    of frames 1-3 equal the eager functions bit for bit; a map padded to
    the next bucket captures again."""
    stand = StandIn(monkeypatch)
    slam, _, frames, st = full_width()
    step = graphs.jit(tracking.working_track_step)
    for b in (1, 2, 3):
        a, kw = step_args(slam, st, frames[b])
        assert_identical(step(*a, **kw), tracking.working_track_step(*a, **kw))
    assert stand.captures == 1 and stand.replays == 2
    cap = st["X"].shape[0]
    pad = lambda t, fill: torch.cat([t, torch.full((cap,) + t.shape[1:], fill, dtype=t.dtype)])
    big = dict(st, X=pad(st["X"], 0.0), normal=pad(st["normal"], 0.0),
               mind=pad(st["mind"], 0.0), maxd=pad(st["maxd"], 1.0),
               cand_base=pad(st["cand_base"], False), pt_desc=pad(st["pt_desc"], 0),
               pt_mask=pad(st["pt_mask"], 0))
    a, kw = step_args(slam, big, frames[1])
    assert_identical(step(*a, **kw)[1:7], tracking.working_track_step(*a, **kw)[1:7])
    # the padded map's key: no warm-up, its first call one replay
    assert stand.captures == 2 and stand.warm_ups == 1 and stand.replays == 3

    body = graphs.jit(tracking.working_scan_body)
    a, kw = body_args(slam, st, None)
    run = lambda b: tracking.working_scan_chunk(
        a[0], a[1], frames[1:4], st["mt0"], st["V0"], st["last"], st["slot_X0"],
        st["slot_lp0"], st["slot_has0"], *a[4:], body=b, **kw)
    assert_identical(run(body), run(tracking.working_scan_body))
    assert stand.captures == 3 and stand.replays == 5


def test_graphed_step_matches_jax(monkeypatch):
    """The slice through its graph: the graphed step (the stand-in, frame
    2 a replay) against the JAX package's jitted working_track_step on
    the same frames and map, at tests/test_torch_slice.py's bars."""
    pytest.importorskip("jax")
    import _torchutil as U
    from multicol_slam_tpu.models import matcher as jm
    from multicol_slam_tpu.models import tracking as jtrk
    from multicol_slam_tpu_torch.models import matcher as tm
    from multicol_slam_tpu_torch.utils import synthetic as tsyn

    StandIn(monkeypatch)
    gt, imgs = U.frames(3)
    jx, tx = U.extractors()
    st = tsyn.gt_bootstrap(U.torch_rig(), torch.tensor(gt[0], dtype=torch.float32),
                           tx(imgs[0]), U.N_LEVELS, U.SCALE_FACTOR)
    rest = [st[k] for k in ("X", "normal", "mind", "maxd", "cand_base", "pt_desc", "pt_mask")]
    step = graphs.jit(tracking.working_track_step)
    kw = dict(th_motion=U.TH_MOTION, th_local=U.TH_LOCAL, n_levels=U.N_LEVELS,
              scale_factor=U.SCALE_FACTOR)
    for b in (1, 2):
        out = step(tx, U.torch_rig(), imgs[b], st["mt0"], st["slot_X0"], st["slot_has0"],
                   st["last"], lp_slot_of(st), *rest, tm.MatchParams(), **kw)
    with U.f32():
        j = jtrk.working_track_step(
            jx, U.jax_rig(), U.to_jax(imgs[2]), U.to_jax(st["mt0"]),
            U.to_jax(st["slot_X0"]), U.to_jax(st["slot_has0"]),
            U.jax_features(st["last"]), U.to_jax(lp_slot_of(st)),
            *(U.to_jax(t) for t in rest[:5]), U.to_jax_u32(st["pt_desc"]),
            U.to_jax_u32(st["pt_mask"]), jm.MatchParams(), **kw)
    np.testing.assert_array_equal(out[0].xy.numpy(), np.asarray(j[0].xy))
    for i in (1, 3, 7, 8, 10, 11):
        assert (out[i].numpy() == np.asarray(j[i])).mean() >= 0.995, i
    for i in (4, 5, 12):
        assert abs(int(out[i]) - int(j[i])) <= 0.01 * max(int(j[i]), 1), i
    for i in (2, 9):
        t, r = U.pose_error(out[i], j[i])
        assert t <= 1e-4 and r <= 0.01, (i, t, r)


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the Hamming-NN kernel")
    return torch.device("cuda", 0)


def card_setup(dev):
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io, synthetic

    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, device=dev,
                        enable_loop_closing=False)
    gt = synthetic.smooth_trajectory(100, radius=0.6)[:5]
    render = synthetic.make_renderer(slam.rig)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev)))
    frames = frames.to(torch.uint8)
    s = slam.settings
    st = synthetic.gt_bootstrap(slam.rig, torch.tensor(gt[0], dtype=torch.float32,
                                                       device=dev),
                                slam._extract_padded(frames[0]), s.n_levels,
                                s.scale_factor)
    return slam, frames, st


@pytest.mark.cuda
def test_graphed_step_equals_eager_on_the_card(card):
    slam, frames, st = card_setup(card)
    step = graphs.jit(tracking.working_track_step)
    for b in (1, 2, 3):
        a, kw = step_args(slam, st, frames[b])
        got = step(*a, **kw)
        want = tracking.working_track_step(*a, **kw)
        torch.cuda.synchronize()
        assert_identical(got, want)
    assert len(step) == 1


@pytest.mark.cuda
def test_graphed_scan_body_equals_eager_on_the_card(card):
    slam, frames, st = card_setup(card)
    a, kw = body_args(slam, st, None)
    run = lambda b: tracking.working_scan_chunk(
        a[0], a[1], frames[1:5], st["mt0"], st["V0"], st["last"], st["slot_X0"],
        st["slot_lp0"], st["slot_has0"], *a[4:], body=b, **kw)
    body = graphs.jit(tracking.working_scan_body)
    got = run(body)
    want = run(tracking.working_scan_body)
    torch.cuda.synchronize()
    assert_identical(got, want)
    assert len(body) == 1
