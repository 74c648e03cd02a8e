#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multicol_slam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the Hamming-NN kernel from multicol_slam_tpu_torch/csrc with
     nvcc, timed;
  3. both entries of the kernel against their plain PyTorch versions on
     the card, both variants: the dense-gate entry (hamming_nn) at the
     WORKING frame's shapes and ragged ones, with fully gated rows and
     duplicate minima; the window-gated entry (hamming_nn_radius) on the
     adversarial cases of tests/_radius_cases.py (points exactly on the
     radius, both edges of the level window, fully gated rows, duplicate
     minima, queries shared by every camera, 4, 8 and 16 words). Exact
     equality;
  4. the WORKING frame (extraction, motion-model tracking, local-map
     tracking) at the default SlamSettings: the in-repo 3-camera rig at
     754x480, 8 levels x 1.2, 400 features per camera, against a map lifted
     from frame 0 at the true pose, over 16 frames rendered on the card.
     Every frame must keep >= 15 local-map inliers and stay within 5 cm
     and 1 degree of ground truth, and the main path must launch the
     window-gated entry twice per frame and the dense-gate entry never;
  5. the first frames of that run against the port's CPU path (the plain
     Hamming-NN versions) on the same frames and map;
  6. the system from the first frame: MultiColSLAM(calib_dir=...) with no
     device named, so on the card, at the default SlamSettings on the same
     rig, fed 40 frames of synthetic.bench_trajectory rendered on the card,
     with no ground-truth map: bootstrap (mutual matching, 5-point
     RANSAC), the Tracker state machine, keyframes mapped synchronously
     (triangulation, cross-camera points, fuse, Schur local BA). It must
     initialize within 20 frames, stay WORKING on >= 90% of the frames
     after that, create and map >= 3 keyframes, reach an ATE (Sim3-aligned)
     of at most 5 cm, and launch the kernel at every call site of the
     system's path: the window-gated entry at initialization and its
     mutual check, the previous-frame window search, motion-model and
     local-map tracking and fuse; the dense-gate entry at triangulation
     and cross-camera triangulation. Each site's entry must equal its plain
     version exactly on the site's recorded inputs. Per-frame times by kind
     and per-pass mapping times are printed beside the card's name and
     power limit.

For each call site (phases 4 and 6) the script times, on the card: the
entry's device time per launch (CUDA-graph replay, so no host enqueue in
it), one call between two events as earlier versions timed (host enqueue
included), the plain version, and at the window-gated sites the path the
site ran before the in-kernel gate (the torch gate build plus the
dense-gate entry). It computes each site's bound from the inputs (bytes
over 3.35 TB/s, float operations over 67 TFLOP/s, popcounts over 16 per
clock per SM at 1.98 GHz on 132 SMs) and its gate density.

Prints the card line, a JSON line of the kernels (one entry per call
site), and last {"ok": true, "device": {...}}. Without a GPU it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

B = 16                 # frames of the main run
B_REF = 2              # frames checked against the CPU path
MAX_T_ERR = 0.05       # m, the bar of tests/test_e2e_slice.py
MAX_R_ERR = 1.0        # degrees
SYS_FRAMES = 40        # frames of the system run (phase 6)
SYS_INIT_BY = 20       # it must initialize within this many frames
SYS_WORKING_FRAC = 0.9
SYS_MIN_KFS = 3
SYS_MAX_ATE = 0.05     # m, Sim3-aligned
# the kernel's call sites: the function on the call stack that names each
SITES = {"search_for_initialization": "init", "_track_previous_frame": "window_search",
         "_motion_track_core": "motion", "_local_map_core": "local_map",
         "triangulation_batch": "triangulation", "cross_camera_batch": "cross_camera",
         "fuse_targets_batch": "fuse"}
SYS_SITES = {"init": "radius", "init_mutual": "radius", "window_search": "radius",
             "motion": "radius", "local_map": "radius", "triangulation": "dense",
             "cross_camera": "dense", "fuse": "radius"}
ENTRY = {"radius": "hamming_nn_radius", "dense": "hamming_nn"}
SOURCE = "multicol_slam_tpu_torch/csrc/hamming_nn.cu"
REPLACES = "multicol_slam_tpu/ops/pallas/hamming_nn.py:146"
REPLACES_MASKED = "multicol_slam_tpu/ops/pallas/hamming_nn.py:206"
LIBRARY = ("none: torch has no popcount, and no call reduces to a gated best, "
           "second-best and argmin")
HBM_BYTES_S = 3.35e12          # H100 SXM device memory
F32_OPS_S = 67e12              # H100 SXM float32 outside the tensor cores
POPC_S = 16 * 132 * 1.98e9     # popcounts per clock per SM x SMs x boost clock


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Median time of one fn() call between two CUDA events, host enqueue
    included (how the kernel's first version was timed)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, rounds: int = 7) -> float:
    """Median device time of one fn(): reps calls captured in one CUDA
    graph, the graph replayed between two events, divided by reps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def random_case(C, N, M, dev, gen):
    """Random words with duplicate minima (the second half of db repeats
    the first, and queries copy db rows) and fully gated rows (every
    fifth row)."""
    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             dtype=torch.int64, device=dev).to(torch.int32)
    q, db = words(C, N, 8), words(C, M, 8)
    half = M // 2
    db[:, half:2 * half] = db[:, :half]
    n_copy = min(N, half)
    q[:, :n_copy] = db[:, :n_copy]
    gate = torch.rand((C, N, M), generator=gen, device=dev) < 0.3
    gate[:, :n_copy, :half] = True
    gate[:, ::5] = False
    return q, db, gate, words(C, N, 8), words(C, M, 8)


def compare(knn, kind, args) -> int:
    """An entry against its plain version on the same tensors; returns max
    |diff| (0)."""
    got = getattr(knn, ENTRY[kind])(*args)
    want = getattr(knn, ENTRY[kind] + "_reference")(*args)
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    if err:
        fail(f"{ENTRY[kind]} differs from its plain version at {tuple(args[0].shape)} x "
             f"{tuple(args[1].shape)} ({len(args)} arguments): max |diff| {err}")
    return err


def radius_cases():
    """tests/_radius_cases.py: entry A's adversarial inputs, made with
    numpy from a seed."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import _radius_cases
    return _radius_cases


def radius_args(case, dev, masked):
    """A case of tests/_radius_cases.py as entry A's arguments on dev."""
    words = lambda a: torch.from_numpy(a.view(np.int32).copy()).to(dev)
    args = [words(case["q"]), words(case["db"])] + [
        torch.from_numpy(case[k]).to(dev) for k in ("q_uv", "q_r2", "q_lvl_lo", "q_lvl_hi",
                                                 "q_ok", "db_xy", "db_lvl", "db_ok")]
    return args + ([words(case["q_mask"]), words(case["db_mask"])] if masked else [])


def split(kind, args):
    """(q, db, gate fields or gate, masks) of an entry's arguments."""
    n = 10 if kind == "radius" else 3
    return args[0], args[1], args[2:n], args[n:]


def gate_counts(knn, kind, args):
    """(pairs the gate allows, pairs whose distance test runs, all pairs)."""
    _, _, fields, _ = split(kind, args)
    if kind == "dense":
        gate = fields[0].bool()
        return int(gate.sum()), 0, gate.numel()
    q_uv, q_r2, lo, hi, q_ok, db_xy, db_lvl, db_ok = fields
    lvl = db_lvl[:, None, :]
    cand = (lvl >= lo[..., None]) & (lvl <= hi[..., None]) & q_ok[..., None] & db_ok[:, None]
    gate = knn.radius_gate(*fields)
    return int(gate.sum()), int(cand.sum()), gate.numel()


def bound(knn, kind, args):
    """(bound ms, 'bytes' or 'operations', gate density): the least time
    for this call's work on an H100 SXM. Bytes: every input read once and
    the outputs written once. Operations: popcounts for the pairs the gate
    allows, and for entry A the five float operations of the distance test
    for the pairs that pass the validity and level tests."""
    q, db, fields, masks = split(kind, args)
    C, N = db.shape[0], q.shape[1]
    n_gate, n_cand, n_all = gate_counts(knn, kind, args)
    nbytes = sum(t.numel() * t.element_size() for t in [q, db, *fields, *masks]) + 12 * C * N
    popc = n_gate * q.shape[2] * (2 if masks else 1)
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(popc / POPC_S, 5 * n_cand / F32_OPS_S)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            n_gate / n_all)


def previous_path(knn, args):
    """What a window-gated site ran before the in-kernel gate: the dense
    gate built by the torch expressions, queries copied to every camera,
    then the dense-gate entry."""
    q, db, fields, masks = split("radius", args)
    wide = lambda t: t.expand((db.shape[0],) + tuple(t.shape[1:])).contiguous()
    masks = (wide(masks[0]), masks[1]) if masks else ()
    return knn.hamming_nn(wide(q), db, knn.radius_gate(*fields).contiguous(), *masks)


def site_entry(knn, site, kind, args, launches, card):
    """Compare, time and bound one call site's recorded inputs; returns
    its entry of the kernels line."""
    entry = getattr(knn, ENTRY[kind])
    plain = getattr(knn, ENTRY[kind] + "_reference")
    err = compare(knn, kind, args)
    ms = device_ms(lambda: entry(*args))
    call = cuda_ms(lambda: entry(*args))
    plain_ms = device_ms(lambda: plain(*args))
    prev = device_ms(lambda: previous_path(knn, args)) if kind == "radius" else None
    bound_ms, bound_by, density = bound(knn, kind, args)
    q, db, _, masks = split(kind, args)
    print(f"{ENTRY[kind]} at {site}: q {tuple(q.shape)} db {tuple(db.shape)}, {launches} "
          f"launches, gate density {density:.6f}: device {ms * 1e3:.2f} us a launch "
          f"(bound {bound_ms * 1e3:.3f} us, {bound_by}), one call {call * 1e3:.2f} us, plain "
          f"{plain_ms * 1e3:.2f} us" + (f", previous path {prev * 1e3:.2f} us" if prev else "")
          + f" ({card})")
    if prev is not None and not ms < prev:
        print(f"note: at {site} the entry ({ms:.5f} ms) is not below the previous path "
              f"({prev:.5f} ms)")
    return {"name": f"{ENTRY[kind]}@{site}", "entry": "A" if kind == "radius" else "B",
            "route": "cuda", "source": SOURCE,
            "replaces": REPLACES_MASKED if masks else REPLACES,
            "launches": launches, "max_abs_err": err, "ms": ms, "call_ms": call,
            "plain_ms": plain_ms, "prev_path_ms": prev, "bound_ms": bound_ms,
            "bound_us": bound_ms * 1e3, "bound_by": bound_by, "library_ms": None,
            "library": LIBRARY, "gate_density": density,
            "shape": [list(q.shape), list(db.shape)]}


class SiteSpy:
    """Stands in for the matcher module's two kernel entries: names each
    launch's call site, counts it and keeps each site's first inputs; the
    wrappers still launch and count."""

    def __init__(self, knn, matcher):
        self.knn, self.matcher = knn, matcher
        self.launches, self.args = Counter(), {}

    def _call(self, kind, args):
        site = call_site()
        if site == "init" and self.launches["init"] > self.launches["init_mutual"]:
            site = "init_mutual"           # the swapped second launch
        self.launches[site] += 1
        self.args.setdefault(site, (kind, args))
        return getattr(self.knn, ENTRY[kind])(*args)

    def __enter__(self):
        self.matcher.hamming_nn = lambda *a: self._call("dense", a)
        self.matcher.hamming_nn_radius = lambda *a: self._call("radius", a)
        return self

    def __exit__(self, *exc):
        self.matcher.hamming_nn = self.knn.hamming_nn
        self.matcher.hamming_nn_radius = self.knn.hamming_nn_radius


def call_site() -> str:
    """The call site of the current Hamming-NN call."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name in SITES:
            return SITES[f.f_code.co_name]
        f = f.f_back
    fail("a Hamming-NN entry was called from an unknown call site")


def reset_launches(knn):
    knn.hamming_nn.launches = 0
    knn.hamming_nn_radius.launches = 0


def make_slice(settings, rig):
    """The extractor and match parameters MultiColSLAM builds from
    SlamSettings (system.py), for the WORKING frame."""
    from multicol_slam_tpu_torch.models import extractor, matcher
    from multicol_slam_tpu_torch.ops.camera import make_extraction_masks
    from multicol_slam_tpu_torch.ops.pyramid import level_sizes

    s = settings
    w, h = int(rig.cams.width[0]), int(rig.cams.height[0])
    masks = []
    for c in range(rig.n_cams):
        if float(rig.cams.mirror[c]) > 0.5:
            masks.append(make_extraction_masks(float(rig.cams.u0[c]),
                                               float(rig.cams.v0[c]), w, h,
                                               s.n_levels, s.scale_factor))
        else:
            masks.append([np.full(sz, 255, np.uint8) for sz in
                          level_sizes(h, w, s.n_levels, s.scale_factor)])
    masks_lvl = [np.stack([m[lvl] for m in masks]) for lvl in range(s.n_levels)]
    cfg = extractor.ExtractorConfig(
        n_features=s.n_features, scale_factor=s.scale_factor,
        n_levels=s.n_levels, fast_th=s.fast_th, desc_bytes=s.desc_size,
        use_harris=s.score_harris)
    extract = extractor.make_extractor(cfg, rig.cams, masks_lvl, (h, w))
    params = matcher.MatchParams(desc_bytes=s.desc_size,
                                 masked=s.use_mdbrief and s.learn_masks,
                                 scale_factor=s.scale_factor)
    return extract, params


def run_chunk(extract, rig, frames, st, params, settings, tcfg):
    from multicol_slam_tpu_torch.models import tracking
    return tracking.working_scan_chunk(
        extract, rig, frames, st["mt0"], st["V0"], st["last"], st["slot_X0"],
        st["slot_lp0"], st["slot_has0"], st["X"], st["normal"], st["mind"],
        st["maxd"], st["cand_base"], st["pt_desc"], st["pt_mask"], params,
        th_motion=tcfg.motion_th, th_local=tcfg.local_map_th,
        n_levels=settings.n_levels, scale_factor=settings.scale_factor)


def percentiles(xs):
    return (f"median {statistics.median(xs):.3f} p90 {float(np.percentile(xs, 90)):.3f} "
            f"(n={len(xs)})") if xs else "none"


def system_phase(dev, knn, card):
    """Phase 6: MultiColSLAM.track from the first frame. Returns the kernel
    JSON entries of the system path's call sites."""
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.models.tracking import TrackState
    from multicol_slam_tpu_torch.utils import config_io, synthetic
    from multicol_slam_tpu_torch.utils.trajectory import ate_rmse

    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, enable_loop_closing=False)
    if slam.rig.M_c.device != dev:
        fail(f"MultiColSLAM with no device runs on {slam.rig.M_c.device}, not {dev}")
    gt = synthetic.bench_trajectory(SYS_FRAMES)
    render = synthetic.make_renderer(slam.rig)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev)))
    frames = frames.to(torch.uint8)

    # the main path, counted: every launch goes through the wrappers; the
    # spy names its call site and keeps each site's first inputs
    kinds, times, init_frame = [], [], None
    reset_launches(knn)
    with SiteSpy(knn, matcher) as spy:
        for i in range(SYS_FRAMES):
            was_working = slam.state == TrackState.WORKING
            n_passes = len(slam.mapping_ms)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M = slam.track(frames[i], i / 25.0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if M is not None and init_frame is None:
                init_frame = i
            kinds.append("init" if not was_working else
                         "keyframe" if len(slam.mapping_ms) > n_passes else "working")
    launches = {k: getattr(knn, ENTRY[k]).launches for k in ENTRY}
    for kind in ENTRY:
        by_site = sum(n for s, n in spy.launches.items() if SYS_SITES.get(s) == kind)
        if by_site != launches[kind]:
            fail(f"call-site launches {dict(spy.launches)} do not add up to "
                 f"{ENTRY[kind]}'s {launches[kind]}")

    tr = slam.tracker
    m = slam.map
    print(f"system: init at frame {init_frame}, {m.n_keyframes()} keyframes "
          f"({len(slam.mapping_ms)} mapping passes), {m.n_points()} points, "
          f"frame paths {dict(Counter(tr.frame_path))}")
    if init_frame is None or init_frame >= SYS_INIT_BY:
        fail(f"the system did not initialize within {SYS_INIT_BY} frames")
    after = SYS_FRAMES - init_frame - 1
    n_work = len(tr.all_poses) - 1
    if n_work < SYS_WORKING_FRAC * after:
        fail(f"WORKING on {n_work} of the {after} frames after init")
    if len(slam.mapping_ms) < SYS_MIN_KFS or m.n_keyframes() < SYS_MIN_KFS:
        fail(f"{m.n_keyframes()} keyframes, {len(slam.mapping_ms)} mapped; "
             f"want >= {SYS_MIN_KFS}")
    poses = np.stack(tr.all_poses)
    if not np.isfinite(poses).all():
        fail("non-finite poses")
    k = len(poses)
    ate = ate_rmse(poses[:, :3, 3], gt[SYS_FRAMES - k:, :3, 3])
    print(f"system ATE (Sim3-aligned, {k} frames) {ate:.5f} m")
    if ate > SYS_MAX_ATE:
        fail(f"ATE {ate:.4f} m above {SYS_MAX_ATE} m")
    for kind in ("init", "working", "keyframe"):
        xs = [t for t, kd in zip(times, kinds) if kd == kind]
        print(f"system frame ms, {kind}: {percentiles(xs)} ({card})")
    print(f"system mapping_ms per pass: "
          f"{[round(x, 3) for x in slam.mapping_ms]} ({card})")
    print(f"system launches {launches} by call site: {dict(spy.launches)}")

    entries = []
    for site, kind in SYS_SITES.items():
        if not spy.launches[site]:
            fail(f"the kernel was not launched at call site {site}")
        got_kind, args = spy.args[site]
        if got_kind != kind:
            fail(f"call site {site} used {ENTRY[got_kind]}, want {ENTRY[kind]}")
        entries.append(site_entry(knn, site, kind, args, spy.launches[site], card))
    return entries


def cayley_to_hom(mt):
    from multicol_slam_tpu_torch.ops.geometry import cayley2hom
    return cayley2hom(mt.detach().double().cpu()).numpy()


def pose_errors(mt, gt):
    """(translation m, rotation deg) of pose mt (6,) against gt (4, 4)."""
    M = cayley_to_hom(mt)
    t = float(np.linalg.norm(M[:3, 3] - gt[:3, 3]))
    c = (np.trace(M[:3, :3].T @ gt[:3, :3]) - 1.0) / 2.0
    return t, float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on an NVIDIA GPU only")
    from multicol_slam_tpu_torch.kernels import hamming_nn as knn
    from multicol_slam_tpu_torch.models import matcher, tracking
    from multicol_slam_tpu_torch.utils import config_io, synthetic

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    knn.load_library()
    print(f"kernel build s {time.perf_counter() - t0:.3f} ({card})")

    # -- 3. both entries against plain: random and adversarial inputs -------
    gen = torch.Generator(device=dev).manual_seed(0)
    for C, N, M in [(3, 400, 400), (3, 2048, 400), (2, 1, 1), (2, 1, 257),
                    (2, 129, 1), (2, 129, 257)]:
        q, db, gate, qm, dbm = random_case(C, N, M, dev, gen)
        for masks in [(), (qm, dbm)]:
            compare(knn, "dense", (q, db, gate) + masks)
        print(f"hamming_nn == plain at C={C} N={N} M={M}, both variants")
    rc = radius_cases()
    for name in rc.CASES:
        case = rc.radius_case(name, seed=len(name))
        for masked in (False, True):
            compare(knn, "radius", radius_args(case, dev, masked))
        print(f"hamming_nn_radius == plain on case {name}, both variants")

    # -- 4. the WORKING frame at the default configuration ------------------
    settings = config_io.SlamSettings()
    tcfg = tracking.TrackerConfig()
    rig_cpu, _ = config_io.load_mcs(config_io.SYNTH_RIG_DIR)
    rig = rig_cpu.to(dev)
    extract, params = make_slice(settings, rig_cpu)
    gt = synthetic.smooth_trajectory(100, radius=0.6)[:B + 1]
    render = synthetic.make_renderer(rig)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev)))
    frames = frames.to(torch.uint8)
    st = synthetic.gt_bootstrap(rig, torch.tensor(gt[0], dtype=torch.float32, device=dev),
                                extract(frames[0]), settings.n_levels,
                                settings.scale_factor)
    C, K = st["slot_has0"].shape
    print(f"slice: {C} cameras {tuple(frames.shape[-2:])}, {settings.n_levels} levels, "
          f"K={K} slots/camera, map P={st['P']} padded to {st['X'].shape[0]}")

    # warm-up frame
    run_chunk(extract, rig, frames[1:2], st, params, settings, tcfg)
    torch.cuda.synchronize()
    # the main path, counted: one chunk over B frames
    reset_launches(knn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SiteSpy(knn, matcher) as spy:
        carry, ys = run_chunk(extract, rig, frames[1:], st, params, settings, tcfg)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    launches = knn.hamming_nn_radius.launches
    if launches != 2 * B or knn.hamming_nn.launches:
        fail(f"hamming_nn_radius launched {launches} times and hamming_nn "
             f"{knn.hamming_nn.launches} over {B} frames, want {2 * B} and 0")
    wf_entries = [site_entry(knn, f"working_{site}", *spy.args[site], spy.launches[site], card)
                  for site in ("motion", "local_map")]
    # the masked (mdBRIEF) variant, off the default path: the local-map
    # inputs with random stability masks, printed only
    args = spy.args["local_map"][1]
    site_entry(knn, "working_local_map_masked", "radius",
               args + tuple(torch.randint(-2 ** 31, 2 ** 31, args[i].shape, generator=gen,
                                          dtype=torch.int64, device=dev).to(torch.int32)
                            for i in (0, 1)), 0, card)

    n_in2 = ys["n_in2"].tolist()
    errs = [pose_errors(ys["mt"][b], gt[b + 1]) for b in range(B)]
    for b in range(B):
        print(f"frame {b + 1}: n_m1 {int(ys['n_m1'][b])} n_in1 {int(ys['n_in1'][b])} "
              f"n_in2 {n_in2[b]} t_err {errs[b][0]:.5f} m r_err {errs[b][1]:.4f} deg")
    if not torch.isfinite(ys["mt"]).all() or ys["mt"].shape != (B, 6):
        fail(f"poses of shape {tuple(ys['mt'].shape)}, finite "
             f"{bool(torch.isfinite(ys['mt']).all())}")
    if min(n_in2) < tcfg.min_inliers_local:
        fail(f"local-map inliers {n_in2}: below {tcfg.min_inliers_local}")
    worst_t = max(e[0] for e in errs)
    worst_r = max(e[1] for e in errs)
    if worst_t > MAX_T_ERR or worst_r > MAX_R_ERR:
        fail(f"pose error {worst_t:.4f} m / {worst_r:.3f} deg beyond "
             f"{MAX_T_ERR} m / {MAX_R_ERR} deg")

    # per-frame latency: the same frames one chunk of one frame at a time
    frame_ms = []
    state = dict(st)
    for b in range(B):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, y = run_chunk(extract, rig, frames[b + 1:b + 2], state, params,
                         settings, tcfg)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        state.update(last=c[0], slot_X0=c[1], slot_lp0=c[2], slot_has0=c[3],
                     mt0=c[4], V0=c[5])
    d_t, d_r = pose_errors(ys["mt"][B - 1], cayley_to_hom(c[4]))
    p90 = float(np.percentile(frame_ms, 90))
    print(f"WORKING frame ms, one frame per call: median "
          f"{statistics.median(frame_ms):.3f} p90 {p90:.3f}; one {B}-frame "
          f"chunk: {chunk_s * 1e3 / B:.3f} ms/frame ({card})")
    print(f"frame {B}: frame-by-frame vs chunk pose diff {d_t:.2e} m {d_r:.2e} deg")

    # -- 5. the first frames against the port's CPU path --------------------
    extract_cpu, _ = make_slice(settings, rig_cpu)
    st_cpu = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in st.items()}
    st_cpu["last"] = type(st["last"])(*(t.cpu() for t in st["last"]))
    _, ys_cpu = run_chunk(extract_cpu, rig_cpu, frames[1:1 + B_REF].cpu(), st_cpu,
                          params, settings, tcfg)
    for b in range(B_REF):
        t_d, r_d = pose_errors(ys["mt"][b], cayley_to_hom(ys_cpu["mt"][b]))
        agree = (ys["lp"][b].cpu() == ys_cpu["lp"][b]).float().mean().item()
        a, r = int(ys["n_in2"][b]), int(ys_cpu["n_in2"][b])
        print(f"frame {b + 1} card vs CPU: pose diff {t_d:.2e} m {r_d:.2e} deg, "
              f"slot agreement {agree:.4f}, n_in2 {a} vs {r}")
        if t_d > 1e-3 or r_d > 0.05 or agree < 0.98 or abs(a - r) > 0.02 * r:
            fail(f"frame {b + 1}: the card's run disagrees with the CPU path")

    # -- 6. the system from the first frame ---------------------------------
    sys_entries = system_phase(dev, knn, card)

    print(json.dumps({"kernels": wf_entries + sys_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
