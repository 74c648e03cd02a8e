"""The port's bench: the counterpart of the JAX package's ``bench.py``.

    python3 -m multicol_slam_tpu_torch.bench                 # on the card
    python3 -m multicol_slam_tpu_torch.bench --device cpu --small

It prints, last, one JSON line in ``bench.py``'s form (``bench.py:
1067-1077``): ``metric`` (``3cam_tracking_fps``), ``value``, ``unit``,
``vs_baseline`` (the value over 25 fps, the reference's real-time rate)
and ``extra``. On the card it runs by default and raises without one;
``--device cpu`` runs every stage on the CPU, and ``--small`` cuts every
stage to a size the CPU finishes in a few minutes (the tests' size; the
numbers then say how fast the CPU is, not the card).

The headline is ``bench.py:495-699``'s protocol: ``MultiColSLAM`` at the
default settings builds a map over ``bench_trajectory(n_build + n_scan
+ 2, radius=0.8)`` through ``track_batch`` chunks of 8, the tracker's
slots, pose and velocity are snapshotted at the first WORKING frame
after ``snap_at``, the map is frozen as the local-map snapshot, and
``n_reps`` x ``n_scan`` frames go through the tracker's own graphed
``working_scan_body`` (``Tracker._scan_body``, via
``working_scan_chunk``), timed between two CUDA events around the whole
loop after one untimed rep that warms and captures. The scan starts at
the frame after the snapshot (``bench.py`` snapshots at the end of the
chunk that passes ``snap_at`` and scans from ``snap_at + 1``, up to 7
frames before it). Fewer than 90% of the
scanned frames at ``min_inliers_local`` raise: the JAX bench falls back to
a kernel stand-in there (``bench.py:1163-1171``), this bench does not.

``extra`` holds one block per stage, each the port's counterpart of a
``bench.py`` stage: ``full_system`` (90 frames, async mapping,
``bench.py:138-312``: ms a frame by kind, mapping passes, the WORKING
share, ATE, keyframes refused and passes interrupted, and the captures
and replays of every graphed function over the run),
``full_system_chunked`` (96 frames, ``chunk=8``, plus the chunk scan's ms
a frame, steady chunks apart from those that captured),
``extraction_rate`` (``:899-931``), ``ba_rate`` (``:933-977``, 16
keyframes x 2048 points, the BA graphed as local mapping graphs it),
``chi2_parity`` (``:816-897``), ``eight_cam`` (``:483-493``),
``dynamic_scene`` (``:425-481``), ``mdbrief`` (``:979-987``) and
``cpu_compare`` (``:769-814``, the CPU side in a subprocess), then the
card's name and power limit, ``graphs.stats()``, the kernel's launches by
entry and the script's seconds. ``eight_cam`` and ``mdbrief`` time
``bench_hot_loop``'s frame step (extraction, motion-model match against
the scene points of the previous frame, pose LM), as those stages do in
``bench.py``.

Not ported: ``_link_probe`` and ``bench_dispatch_rtt`` (the health of a
remote TPU link), the epsilon cache-busting of timed reps (a remote
client's dedup), ``bench_pallas_threshold`` (the ``PALLAS_MIN_CANDIDATES``
routing, which the port does not have) and ``bench_hot_loop`` as the
headline's fallback. No stage's failure is caught and no stage is skipped
for time: a stage that fails ends the bench with a non-zero exit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter

import numpy as np
import torch

BASELINE_FPS = 25.0     # the reference's real-time rate (BASELINE.md)

# stage sizes: the JAX bench's, and a CPU-sized cut of each
SIZES = {
    "full": dict(headline=dict(n_build=40, snap_at=24, n_scan=20, n_reps=4),
                 full_system=90, chunked=96, extraction=dict(n_frames=8, n_reps=2),
                 ba=dict(n_kf=16, n_pt=2048, n_reps=3), chi2=dict(n_kf=6, n_pt=400),
                 hot=dict(n_frames=12, n_reps=2), dynamic=36,
                 compare=dict(n_frames=6, n_timed=4), probe=dict(n_frames=4, n_timed=1)),
    "small": dict(headline=dict(n_build=16, snap_at=10, n_scan=2, n_reps=1),
                  full_system=12, chunked=16, extraction=dict(n_frames=2, n_reps=1),
                  ba=dict(n_kf=3, n_pt=64, n_reps=1), chi2=dict(n_kf=3, n_pt=60),
                  hot=dict(n_frames=3, n_reps=1), dynamic=10,
                  compare=dict(n_frames=2, n_timed=1), probe=dict(n_frames=2, n_timed=1)),
}
MDBRIEF = dict(use_mdbrief=True, learn_masks=True)   # bench.py's mdbrief stage
RING_CAMS, RING_RADIUS = 8, 0.3                       # bench.py's _ring_rig
DISTRACTORS = [dict(center=(1.1, 0.1, 1.0), velocity=(-0.05, 0.0, -0.03), radius=0.25),
               dict(center=(-1.2, -0.2, 0.7), velocity=(0.07, 0.01, 0.0), radius=0.2),
               dict(center=(0.2, 0.4, -1.2), velocity=(0.0, -0.02, 0.06), radius=0.28)]


# -- timing ----------------------------------------------------------------------

def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def timed_ms(fn, dev):
    """(fn(), ms): between two CUDA events on the card (host enqueue
    included, the device's work ended), the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _sync(dev)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def host_ms(fn, dev):
    """(fn(), host ms around it, the device's work ended)."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def spread(xs) -> dict | None:
    """Median, p90, max and count of a list of ms, or None when empty."""
    if not xs:
        return None
    return dict(median=float(statistics.median(xs)), p90=float(np.percentile(xs, 90)),
                max=float(max(xs)), n=len(xs))


def graphed(fn, dev):
    """``graphs.jit(fn)`` on the card, ``fn`` on the CPU (the tracker's
    and the mapper's rule)."""
    from .utils import graphs
    return graphs.jit(fn) if dev.type == "cuda" else fn


class Utilization:
    """The card's busy share over a ``with`` block: ``nvidia-smi``'s
    ``utilization.gpu`` (the share of its sample period in which a kernel
    ran) read every 100 ms by a subprocess, averaged. ``busy`` is None on
    the CPU or without a sample."""

    def __init__(self, dev):
        self.dev, self.proc, self.busy, self.samples = dev, None, None, 0

    def __enter__(self):
        if self.dev.type == "cuda":
            idx = self.dev.index if self.dev.index is not None else torch.cuda.current_device()
            self.proc = subprocess.Popen(
                ["nvidia-smi", "-i", str(idx), "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            return
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        xs = [float(x) for x in out.split() if x.replace(".", "", 1).isdigit()]
        self.samples = len(xs)
        self.busy = sum(xs) / (100.0 * len(xs)) if xs else None


def pass_split(passes) -> dict | None:
    """The slowest mapping pass after the first, its wall ms split into
    five parts that add up to it: ``warm_up`` and ``capture`` (the first
    calls of graphed units, ``graphs.thread_seconds``), ``capture_wait``
    (waiting for another thread's capture), ``interpreter_lock`` (the rest
    of the thread's time off the CPU: the gap between its wall and CPU
    time, waiting for Python's interpreter lock) and ``rest`` (its CPU
    time outside warm-ups and captures). ``*_off_cpu``: the time off the
    CPU inside warm-ups and captures."""
    if len(passes) < 2:
        return None
    p = max(passes[1:], key=lambda q: q["wall"])
    ms = {k: v * 1e3 for k, v in p.items() if isinstance(v, float)}
    warm_off = ms["warm_up"] - ms["warm_up_cpu"]
    cap_off = ms["capture"] - ms["capture_cpu"]
    lock = ms["wall"] - ms["cpu"] - ms["capture_wait"] - warm_off - cap_off
    return dict(pass_index=passes.index(p), thread=p["thread"], wall=ms["wall"],
                cpu=ms["cpu"], warm_up=ms["warm_up"], capture=ms["capture"],
                capture_wait=ms["capture_wait"], interpreter_lock=lock,
                rest=ms["wall"] - ms["warm_up"] - ms["capture"] - ms["capture_wait"] - lock,
                warm_up_off_cpu=warm_off, capture_off_cpu=cap_off)


# -- inputs ----------------------------------------------------------------------

def render_frames(rig, gt, dev, **kw):
    """uint8 frames (B, C, H, W) of the poses gt, rendered on dev in chunks
    of 24 (the JAX bench's chunked renders)."""
    from .utils import synthetic
    render = synthetic.make_renderer(rig, **{k: v for k, v in kw.items() if k != "time"})
    out = []
    for s in range(0, len(gt), 24):
        M = torch.tensor(gt[s:s + 24], dtype=torch.float32, device=dev)
        extra = {}
        if "time" in kw:
            extra["time"] = kw["time"][s:s + 24]
        out.append(torch.round(render(M, **extra)).to(torch.uint8))
    return torch.cat(out)


def make_system(dev, **kw):
    from .models.system import MultiColSLAM
    from .utils import config_io
    kw.setdefault("calib_dir", config_io.SYNTH_RIG_DIR if "rig" not in kw else None)
    return MultiColSLAM(device=dev, **kw)


# -- the headline ------------------------------------------------------------------

def production_tracker(dev, n_build, snap_at, n_scan, n_reps):
    """The headline (bench.py:495-699): fps of the tracker's graphed scan
    body over a map the system built. Returns (fps, diagnostics)."""
    from .models import tracking
    from .models.tracking import TrackState, bucket, to_device
    from .utils import synthetic

    slam = make_system(dev, capacity_pts=30000, capacity_kfs=128)
    tr, cfg = slam.tracker, slam.tracker.cfg
    n_total = n_build + n_scan + 2
    gt = synthetic.bench_trajectory(n_total, radius=0.8)
    frames = render_frames(slam.rig, gt, dev)
    snap, t = None, 0
    while t < n_build:
        # chunks of 8 up to frame snap_at, then frame by frame to the
        # snapshot, then chunks again
        n = min(8, n_build - t) if snap is not None or t <= snap_at - 8 else \
            max(snap_at + 1 - t, 1)
        if n == 8:
            slam.track_batch(frames[t:t + n], [x / 25.0 for x in range(t, t + n)], chunk=8)
        else:
            for j in range(t, t + n):
                slam.track(frames[j], j / 25.0)
        t += n
        if (snap is None and t > snap_at and tr.state == TrackState.WORKING
                and tr.velocity is not None):
            snap = (t - 1, tr.cur_pt.copy(), tr.cur_mt.copy(), tr.velocity.copy(),
                    tr.cur_feats)
    if snap is None:
        slam.shutdown()
        raise RuntimeError("headline: the system never reached steady WORKING tracking "
                           f"after frame {snap_at}")
    snap_at, snap_pt, snap_mt, snap_V, snap_feats = snap
    m = slam.map

    # the final map frozen as the local-map snapshot
    ids = np.nonzero(m.pt_valid)[0]
    P = len(ids)
    cap = bucket(P, 256)
    pad = lambda a, fill=0: to_device(np.concatenate(
        [a, np.full((cap - P,) + a.shape[1:], fill, a.dtype)], 0), dev)
    maps = (pad(m.pt_pos[ids]), pad(m.pt_normal[ids]), pad(m.pt_min_dist[ids]),
            pad(m.pt_max_dist[ids], 1.0), to_device(np.arange(cap) < P, dev),
            pad(m.pt_desc[ids]), pad(m.pt_desc_mask[ids]))
    # the snapshot's slots -> positions in the final map (merges followed)
    snap_pt = m.resolve_points(snap_pt)
    C, K = snap_pt.shape
    alive = np.zeros((C, K), bool)
    has0 = snap_pt >= 0
    alive[has0] = m.pt_valid[snap_pt[has0]]
    slot_X0 = np.zeros((C, K, 3), np.float32)
    slot_X0[alive] = m.pt_pos[snap_pt[alive]]
    id_to_lp = np.full(m.pt_pos.shape[0], -1, np.int32)
    id_to_lp[ids] = np.arange(P, dtype=np.int32)
    slot_lp0 = np.full((C, K), -1, np.int32)
    slot_lp0[alive] = id_to_lp[snap_pt[alive]]
    n_kf, n_pts = m.n_keyframes(), m.n_points()
    slam.shutdown()

    stacked = frames[snap_at + 1:snap_at + 1 + n_scan]
    carry0 = (to_device(snap_mt, dev, torch.float32), to_device(snap_V, dev, torch.float32),
              snap_feats, to_device(slot_X0, dev), to_device(slot_lp0, dev),
              to_device(alive, dev))

    def scan():
        return tracking.working_scan_chunk(
            tr.extract, slam.rig, stacked, *carry0, *maps, tr.params,
            th_motion=cfg.motion_th, th_local=cfg.local_map_th, n_levels=cfg.n_levels,
            scale_factor=cfg.scale_factor, body=tr._scan_body)

    _, ys = scan()                       # warms and captures; checked, not timed
    n_ins = ys["n_in2"].cpu().numpy()
    if int((n_ins >= cfg.min_inliers_local).sum()) < int(0.9 * n_scan):
        raise RuntimeError(f"headline: the scan lost tracking (local-map inliers {n_ins.tolist()}, "
                           f"want >= {cfg.min_inliers_local} on 90% of {n_scan} frames)")
    outs, ms = timed_ms(lambda: [scan()[1]["n_in2"] for _ in range(n_reps)], dev)
    for o in outs:
        o.cpu()
    fps = n_reps * n_scan / (ms / 1e3)
    return fps, dict(scan_frames=n_scan, reps=n_reps, scan_ms=ms,
                     ms_per_frame=ms / (n_reps * n_scan),
                     inliers_median=int(np.median(n_ins)), map_keyframes=n_kf,
                     map_points=n_pts, local_map_bucket=int(cap),
                     scan_body=getattr(tr._scan_body, "name",
                                       getattr(tr._scan_body, "__qualname__", "")))


# -- the full system ---------------------------------------------------------------

def _graph_counts():
    from .utils import graphs
    return {k: dict(v) for k, v in graphs.stats()["by_fn"].items()}


def _ba_key(capture: dict) -> dict:
    """The (keyframes, points, observation rows, observations a point) key
    of a logged bundle_adjustment capture (its mt0, X0, obs.uv and pt_obs
    shapes), else nothing."""
    if capture["fn"] != "bundle_adjustment":
        return {}
    two = [s for s in capture["shapes"] if len(s) == 2]
    n_pt = next((s[0] for s in two if s[1] == 3), None)
    return dict(ba_key=[next((s[0] for s in two if s[1] == 6), None), n_pt,
                        next((s[0] for s in two if s[1] == 2), None),
                        next((s[1] for s in two if s[0] == n_pt and s[1] != 3), None)])


def full_system(dev, n_frames, chunk=1):
    """The whole pipeline with async mapping (bench.py:138-312): frames by
    kind (init, WORKING, keyframe: a keyframe was inserted) with ms as
    median, p90 and max; mapping passes (the first apart); the WORKING
    share, ATE, keyframes and points; keyframes refused while the mapper
    was busy and passes interrupted before their BA; each graphed
    function's captures and replays over the run. ``chunk`` > 1 feeds
    ``track_batch`` chunks (the frames of a chunk share its mean ms) and
    reports the chunk scan apart: steady chunks, and chunks whose scan
    captured a graph."""
    from .models.tracking import TrackState
    from .utils import graphs, synthetic
    from .utils.trajectory import ate_rmse

    slam = make_system(dev, capacity_pts=30000, capacity_kfs=128, async_mapping=True)
    count = Counter()
    refuse, ba = slam.tracker.interrupt_ba_fn, slam.mapper._local_bundle_adjustment

    def refused():
        count["refused"] += 1
        return refuse()

    def counted_ba(kf):
        count["ba"] += 1
        return ba(kf)

    process, passes = slam.mapper.process_keyframe, []

    def split_pass(kf):
        g0, c0, t0 = graphs.thread_seconds(), time.thread_time(), time.perf_counter()
        try:
            return process(kf)
        finally:
            wall, cpu, g1 = time.perf_counter() - t0, time.thread_time() - c0, \
                graphs.thread_seconds()
            passes.append(dict(thread=threading.current_thread().name, wall=wall, cpu=cpu,
                               **{k: g1[k] - g0[k] for k in g1}))

    slam.tracker.interrupt_ba_fn = refused
    slam.mapper._local_bundle_adjustment = counted_ba
    slam.mapper.process_keyframe = split_pass
    gt = synthetic.bench_trajectory(n_frames, radius=0.8)
    frames = render_frames(slam.rig, gt, dev)
    before, n_log = _graph_counts(), len(graphs.stats()["log"])
    kinds, times, est, used = [], [], [], []
    t_start = time.perf_counter()
    t = 0
    with Utilization(dev) as util:       # the run, the mapper's last pass included
        try:
            while t < n_frames:
                was_working = slam.state == TrackState.WORKING
                n_kf = slam.map.n_keyframes()
                if chunk > 1 and n_frames - t >= chunk:
                    Ms, ms = host_ms(lambda: slam.track_batch(
                        frames[t:t + chunk], [x / 25.0 for x in range(t, t + chunk)],
                        chunk=chunk), dev)
                else:
                    Ms, ms = host_ms(lambda: [slam.track(frames[t], t / 25.0)], dev)
                kind = ("init" if not was_working else
                        "keyframe" if slam.map.n_keyframes() > n_kf else "working")
                for j, M in enumerate(Ms):
                    times.append(ms / len(Ms))
                    kinds.append(kind)
                    if M is not None:
                        est.append(np.asarray(M, np.float64)[:3, 3])
                        used.append(t + j)
                t += len(Ms)
            total_s = time.perf_counter() - t_start
        finally:
            slam.shutdown()
    after = _graph_counts()
    map_ms = list(slam.mapping_ms)
    ate = (float(ate_rmse(np.stack(est), gt[used, :3, 3])) if len(est) > 3 else None)
    out = dict(
        frames=n_frames, chunk=chunk, system_fps=n_frames / total_s,
        frame_ms={k: spread([x for x, kd in zip(times, kinds) if kd == k])
                  for k in ("init", "working", "keyframe")},
        working_frac=len(est) / n_frames,
        working_frac_eval=len(est) / max(n_frames - used[0], 1) if used else 0.0,
        ate_m=ate, n_keyframes=slam.map.n_keyframes(), n_points=slam.map.n_points(),
        mapping_ms=dict(first=map_ms[0] if map_ms else None, rest=spread(map_ms[1:])),
        mapping_passes=len(map_ms), keyframes_refused=count["refused"],
        slowest_pass_split_ms=pass_split(passes),
        device_idle_share=None if util.busy is None else 1.0 - util.busy,
        utilization_samples=util.samples,
        passes_interrupted=len(map_ms) - count["ba"],
        frame_paths=dict(Counter(slam.tracker.frame_path)),
        graphs={k: dict(captures=v["captures"] - before.get(k, {}).get("captures", 0),
                        replays=v["replays"] - before.get(k, {}).get("replays", 0))
                for k, v in after.items()},
        pools_mib={k: v / 2 ** 20 for k, v in graphs.stats()["pools"].items()},
        # the run's captures: function, capturing thread, warm-up, seconds,
        # and the local BA's key (keyframes, points, observation rows,
        # observations a point)
        captures=[dict(fn=c["fn"], thread=c["thread"], warm_up=c["warm_up"],
                       seconds=c["seconds"], **_ba_key(c)) for c in graphs.stats()["log"][n_log:]])
    if chunk > 1:
        scans = slam.tracker.chunk_scans
        steady = [(b, s) for b, s, cap in scans if not cap]
        first = [(b, s) for b, s, cap in scans if cap]
        per_frame = lambda xs: (sum(s for _, s in xs) * 1e3 / sum(b for b, _ in xs)
                                if xs else None)
        out["chunk_scan"] = dict(steady_ms_per_frame=per_frame(steady),
                                 first_ms_per_frame=per_frame(first),
                                 steady_chunks=len(steady), capturing_chunks=len(first))
    return out


# -- the other stages --------------------------------------------------------------------

def extraction_rate(dev, n_frames, n_reps):
    """Keypoints a second of the system's extractor at the default
    settings (bench.py:899-931), graphed on the card, over n_frames
    frames of smooth_trajectory, n_reps timed passes after a warm one."""
    from .utils import synthetic
    slam = make_system(dev, enable_loop_closing=False)
    frames = render_frames(slam.rig, synthetic.smooth_trajectory(100, radius=0.6)[:n_frames],
                           dev)
    extract = graphed(slam.extract, dev)
    counts = [extract(f).valid.sum() for f in frames]
    ts = []
    for _ in range(n_reps):
        counts, ms = timed_ms(lambda: [extract(f).valid.sum() for f in frames], dev)
        ts.append(ms)
    ms = statistics.median(ts)
    kps = float(sum(int(c) for c in counts))
    return dict(mkeypoints_per_sec=kps / (ms / 1e3) / 1e6, kps_per_frame=kps / n_frames,
                ms_per_frame=ms / n_frames, frames=n_frames, reps=n_reps)


def _ba_problem(rig, n_kf, n_pt, dev):
    from .models import optimizer as opt
    from .utils import synthetic
    mt, X, uv, kf, cam, pt, valid, pt_obs = synthetic.make_ba_problem(rig, n_kf, n_pt)
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    obs = opt.BAObservations(uv=t(uv, torch.float32), kf=t(kf), cam=t(cam), pt=t(pt),
                             inv_sigma2=torch.ones(len(uv), device=dev), valid=t(valid))
    problem = opt.BAProblem(obs=obs, pt_obs=t(pt_obs),
                            fixed_kf=t(np.arange(n_kf) == 0),
                            fixed_pt=torch.zeros(n_pt, dtype=torch.bool, device=dev))
    rng = np.random.default_rng(1)
    mt0 = mt + rng.standard_normal(mt.shape) * 0.01
    mt0[0] = mt[0]
    X0 = X + rng.standard_normal(X.shape) * 0.05
    return problem, t(mt0, torch.float32), t(X0, torch.float32), len(uv) - 1


def ba_rate(dev, n_kf, n_pt, n_reps):
    """Schur LM iterations a second at local-BA scale (bench.py:933-977):
    make_ba_problem's n_kf keyframes x n_pt points, 10 iterations with
    early stopping off, the BA graphed on the card as local mapping
    graphs it; the median of n_reps timed calls after a warm one."""
    from .models import optimizer as opt
    from .utils import config_io
    rig = config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0].to(dev)
    problem, mt0, X0, n_obs = _ba_problem(rig, n_kf, n_pt, dev)
    iters = 10
    ba = graphed(opt.bundle_adjustment, dev)
    run = lambda: ba(rig, mt0, X0, problem, iters=iters, early_stop=False)[2]
    run()
    ts = [timed_ms(run, dev)[1] for _ in range(n_reps)]
    per_iter = statistics.median(ts) / iters
    return dict(iters_per_sec=1e3 / per_iter, iter_ms=per_iter, n_obs=n_obs,
                shape=f"{n_kf}kf x {n_pt}pt", reps=n_reps)


def chi2_parity(dev, n_kf, n_pt):
    """The g2o-parity proxy (bench.py:816-897): a float64 BA from perturbed
    poses and points against the robust cost at the ground truth polished
    by the same BA; the ratio of final chi2 sums."""
    from .models import optimizer as opt
    from .ops.camera import world_to_img
    from .ops.geometry import cayley2hom, inv_se3
    from .ops.rig import mt_mc
    from .utils import config_io

    rig = config_io.load_mcs(config_io.SYNTH_RIG_DIR, dtype=torch.float64)[0].to(dev)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n_pt, 3))
    X = X / np.linalg.norm(X, axis=1, keepdims=True) * rng.uniform(2.0, 5.0, (n_pt, 1))
    mt_all = np.stack([np.zeros(6)] + [np.concatenate([rng.standard_normal(3) * 0.02,
                                                       rng.standard_normal(3) * 0.3])
                                       for _ in range(n_kf - 1)])
    rows = []
    w = rig.cams.width.cpu().numpy()
    h = rig.cams.height.cpu().numpy()
    for kf, mt in enumerate(mt_all):
        T = inv_se3(mt_mc(cayley2hom(torch.tensor(mt, device=dev)), rig.M_c)).cpu().numpy()
        for c in range(rig.n_cams):
            Xc = X @ T[c, :3, :3].T + T[c, :3, 3]
            uv = world_to_img(rig.cams.index(c), torch.tensor(Xc, device=dev)).cpu().numpy()
            ok = ((Xc[:, 2] > 0.3) & (uv[:, 0] > 40) & (uv[:, 0] < w[c] - 40)
                  & (uv[:, 1] > 40) & (uv[:, 1] < h[c] - 40))
            for p in np.nonzero(ok)[0]:
                rows.append((uv[p] + rng.normal(0, 0.5, 2), kf, c, p))
    K = len(rows)
    uv = np.zeros((K + 1, 2))
    kf_i, cam_i, pt_i = (np.zeros(K + 1, np.int32) for _ in range(3))
    valid = np.zeros(K + 1, bool)
    lists = [[] for _ in range(n_pt)]
    for i, (m, f, c, p) in enumerate(rows):
        uv[i], kf_i[i], cam_i[i], pt_i[i], valid[i] = m, f, c, p, True
        lists[p].append(i)
    pt_obs = np.full((n_pt, max(max(len(x) for x in lists), 1)), K, np.int32)
    for p, lst in enumerate(lists):
        pt_obs[p, :len(lst)] = lst
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)
    obs = opt.BAObservations(uv=t(uv), kf=t(kf_i), cam=t(cam_i), pt=t(pt_i),
                             inv_sigma2=torch.ones(K + 1, dtype=torch.float64, device=dev),
                             valid=t(valid))
    problem = opt.BAProblem(obs=obs, pt_obs=t(pt_obs), fixed_kf=t(np.arange(n_kf) == 0),
                            fixed_pt=torch.zeros(n_pt, dtype=torch.bool, device=dev))

    def total_chi2(mt0, X0, iters):
        chi2 = opt.bundle_adjustment(rig, t(mt0), t(X0), problem, iters=iters)[2]
        return float(chi2[t(valid)].sum())

    chi2_opt = total_chi2(mt_all, X, 8)
    mt0 = mt_all + rng.standard_normal(mt_all.shape) * 0.01
    mt0[0] = mt_all[0]
    X0 = X + rng.standard_normal(X.shape) * 0.05
    chi2_ba = total_chi2(mt0, X0, 20)
    return dict(ba_chi2_ratio=chi2_ba / chi2_opt, ba_chi2_final=chi2_ba, n_obs=K)


def ring_rig(dev):
    """bench.py's _ring_rig: eight copies of the in-repo rig's camera 0 on
    a 0.3 m ring, yawed 45 degrees apart."""
    from .ops.camera import stack_cameras
    from .ops.rig import rig_from_cayley
    from .utils import config_io
    base = config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0].to(dev)
    mc = np.zeros((RING_CAMS, 6))
    for c in range(RING_CAMS):
        ang = 2 * np.pi * c / RING_CAMS
        mc[c, 1] = np.tan(ang / 2.0)
        mc[c, 3] = RING_RADIUS * np.sin(ang)
        mc[c, 5] = RING_RADIUS * np.cos(ang)
    return rig_from_cayley(torch.tensor(mc, dtype=torch.float32, device=dev),
                           stack_cameras([base.cams.index(0)] * RING_CAMS))


def _scene_points(rig, mt, feats):
    """Where each feature's ray at pose mt leaves the room (the renderer's
    ROOM_HALF cube): the next frame's stand-in landmarks."""
    from .ops.geometry import cayley2hom
    from .ops.rig import mt_mc
    from .utils.synthetic import ROOM_HALF
    T = mt_mc(cayley2hom(mt), rig.M_c)
    o = T[:, None, :3, 3]
    d = torch.einsum("nij,nkj->nki", T[:, :3, :3], feats.ray)
    d = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    t = ((torch.sign(d) * ROOM_HALF - o) / d).min(-1).values
    return o + t[..., None] * d


def hot_loop(dev, n_frames, n_reps, rig=None, settings=None):
    """bench_hot_loop's frame step (bench.py:315-422) through the port:
    the system's extractor, the motion-model match of the last frame's
    scene points projected at the last pose, and the pose LM
    (``extract_motion_track_step``, graphed on the card), then the new
    scene points; frames per second over n_reps passes of n_frames - 1
    frames of smooth_trajectory after a warm pass."""
    from .models import tracking
    from .ops.geometry import hom2cayley
    from .utils import synthetic
    kw = dict(rig=rig) if rig is not None else {}
    slam = make_system(dev, settings=settings, enable_loop_closing=False, **kw)
    rig = slam.rig
    gt = synthetic.smooth_trajectory(100, radius=0.6)[:n_frames]
    frames = render_frames(rig, gt, dev)
    step = graphed(tracking.extract_motion_track_step, dev)
    params = slam.tracker.params

    def one_pass():
        last = slam.extract(frames[0])
        mt = hom2cayley(torch.tensor(gt[0], dtype=torch.float32, device=dev))
        pts = _scene_points(rig, mt, last)
        n_in = []
        for f in frames[1:]:
            out = step(slam.extract, rig, f, mt, pts, last.valid, last, params, th=15.0)
            last, mt = out[0], out[2]
            n_in.append(out[4])
            pts = _scene_points(rig, mt, last)
        return torch.stack(n_in)

    n_in = one_pass().cpu()
    ms = [timed_ms(one_pass, dev)[1] for _ in range(n_reps)]
    per_frame = statistics.median(ms) / (n_frames - 1)
    return dict(fps=1e3 / per_frame, ms_per_frame=per_frame, cams=rig.n_cams,
                frames=n_frames - 1, reps=n_reps, inliers_median=float(n_in.median()))


def dynamic_scene(dev, n_frames):
    """The pipeline with three moving textured spheres (bench.py:425-481),
    async mapping: the WORKING share from the first tracked frame, ATE,
    landmarks culled and whether a loop fired."""
    from .utils import synthetic
    from .utils.trajectory import ate_rmse
    slam = make_system(dev, capacity_pts=30000, capacity_kfs=128, async_mapping=True)
    gt = synthetic.bench_trajectory(n_frames, radius=0.8)
    frames = render_frames(slam.rig, gt, dev, distractors=DISTRACTORS,
                           time=torch.arange(n_frames, dtype=torch.float32))
    est, used = [], []
    try:
        for t in range(n_frames):
            M = slam.track(frames[t], t / 25.0)
            if M is not None:
                est.append(np.asarray(M, np.float64)[:3, 3])
                used.append(t)
    finally:
        slam.shutdown()
    m, lc = slam.map, slam.loop_closer
    return dict(frames=n_frames,
                working_frac=len(est) / max(n_frames - used[0], 1) if used else 0.0,
                ate_m=float(ate_rmse(np.stack(est), gt[used, :3, 3])) if len(est) > 3 else None,
                n_culled=int((~m.pt_valid[:m._next_pt]).sum()),
                false_loop=bool(lc is not None and lc.last_loop_kf >= 0))


def extract_match_ms(dev, n_frames, n_timed):
    """ms a frame of extraction + the frame-to-frame match (bench.py:
    706-767) at the default settings, graphed on the card: the median of
    n_timed passes over n_frames - 1 frames after a warm pass."""
    from .models import matcher
    from .utils import synthetic
    slam = make_system(dev, enable_loop_closing=False)
    frames = render_frames(slam.rig, synthetic.smooth_trajectory(100, radius=0.6)[:n_frames],
                           dev)
    params = slam.tracker.params
    extract = slam.extract

    def step(images, last):
        feats = extract(images)
        m = matcher.match_frame_to_frame(feats, last, last.valid,
                                         torch.zeros_like(feats.valid), feats.xy,
                                         feats.valid, params, th=15.0)
        return feats, (m >= 0).sum()

    run = graphed(step, dev)

    def one_pass():
        last = extract(frames[0])
        found = []
        for f in frames[1:]:
            last, n = run(f, last)
            found.append(n)
        return torch.stack(found)

    one_pass().cpu()
    ms = [timed_ms(one_pass, dev)[1] for _ in range(n_timed)]
    return statistics.median(ms) / (n_frames - 1)


def cpu_compare(dev, n_frames, n_timed, probe):
    """Extraction and matching on dev against the port on the CPU
    (bench.py:769-814); the CPU side runs in a subprocess
    (``--cpu-probe``), every core of the host."""
    dev_ms = extract_match_ms(dev, n_frames, n_timed)
    cmd = [sys.executable, "-m", "multicol_slam_tpu_torch.bench", "--cpu-probe",
           "--probe-frames", str(probe["n_frames"]), "--probe-timed", str(probe["n_timed"])]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(cmd, capture_output=True, text=True, check=True, cwd=root,
                         timeout=1800)
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    return dict(device_ms=dev_ms, cpu_ms=probe["cpu_ms"],
                speedup_vs_cpu=probe["cpu_ms"] / dev_ms, cpu_threads=probe["threads"],
                frames=n_frames - 1)


# -- the whole bench ------------------------------------------------------------------

def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()


def run(dev, sizes) -> dict:
    """Every stage in turn; returns the result line's object."""
    from .kernels import hamming_nn as knn
    from .utils import graphs

    t_start = time.perf_counter()
    extra = dict(device=str(dev))
    if dev.type == "cuda":
        extra["card"] = card_line()
        extra["kind"] = torch.cuda.get_device_name(dev)
        t0 = time.perf_counter()
        knn.load_library()
        extra["kernel_build_s"] = time.perf_counter() - t0
    knn.hamming_nn.launches = knn.hamming_nn_radius.launches = 0

    def stage(name, fn, *a, **kw):
        t0 = time.perf_counter()
        extra[name] = fn(dev, *a, **kw)
        extra[name]["stage_s"] = time.perf_counter() - t0
        print(f"# bench: {name} done in {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
        return extra[name]

    t0 = time.perf_counter()
    fps, diag = production_tracker(dev, **sizes["headline"])
    extra["headline"] = dict(diag, stage_s=time.perf_counter() - t0)
    stage("full_system", full_system, sizes["full_system"])
    stage("full_system_chunked", full_system, sizes["chunked"], chunk=8)
    stage("extraction_rate", extraction_rate, **sizes["extraction"])
    stage("ba_rate", ba_rate, **sizes["ba"])
    stage("chi2_parity", chi2_parity, **sizes["chi2"])
    stage("eight_cam", hot_loop, rig=ring_rig(dev), **sizes["hot"])
    stage("dynamic_scene", dynamic_scene, sizes["dynamic"])
    from .utils import config_io
    stage("mdbrief", hot_loop, settings=config_io.SlamSettings(**MDBRIEF), **sizes["hot"])
    stage("cpu_compare", cpu_compare, **sizes["compare"], probe=sizes["probe"])

    st = graphs.stats()
    extra["graphs"] = dict(captures=st["captures"], capture_s=st["capture_s"],
                           replays=st["replays"], graphs_held=st["graphs_held"],
                           pools_mib={k: v / 2 ** 20 for k, v in st["pools"].items()},
                           by_fn=st["by_fn"])
    extra["kernel_launches"] = dict(
        route="cuda", source="multicol_slam_tpu_torch/csrc/hamming_nn.cu",
        hamming_nn=knn.hamming_nn.launches, hamming_nn_radius=knn.hamming_nn_radius.launches)
    extra["bench_s"] = time.perf_counter() - t_start
    return {"metric": "3cam_tracking_fps", "value": fps, "unit": "frames/sec",
            "vs_baseline": fps / BASELINE_FPS, "extra": extra}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--small", action="store_true",
                    help="every stage at a size the CPU finishes in minutes")
    ap.add_argument("--cpu-probe", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--probe-frames", type=int, default=4, help=argparse.SUPPRESS)
    ap.add_argument("--probe-timed", type=int, default=1, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_probe:
        ms = extract_match_ms(torch.device("cpu"), args.probe_frames, args.probe_timed)
        print(json.dumps({"cpu_ms": ms, "threads": torch.get_num_threads()}))
        return
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (pass --device cpu to run on the CPU)")
    line = run(dev, SIZES["small" if args.small else "full"])
    if "card" in line["extra"]:
        print(line["extra"]["card"])
    print(json.dumps(line))


if __name__ == "__main__":
    main()
