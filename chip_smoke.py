#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multicol_slam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the Hamming-NN kernel from multicol_slam_tpu_torch/csrc with
     nvcc, timed;
  3. the kernel against its plain PyTorch version on the card, both
     variants, at the WORKING frame's shapes and ragged ones, with fully
     gated rows and duplicate minima: exact equality; median times from
     CUDA events;
  4. the WORKING frame (extraction, motion-model tracking, local-map
     tracking) at the default SlamSettings: the in-repo 3-camera rig at
     754x480, 8 levels x 1.2, 400 features per camera, against a map lifted
     from frame 0 at the true pose, over 16 frames rendered on the card.
     Every frame must keep >= 15 local-map inliers and stay within 5 cm
     and 1 degree of ground truth, and the main path must launch the
     kernel twice per frame;
  5. the first frames of that run against the port's CPU path (the plain
     Hamming-NN version) on the same frames and map.

Prints the card line, a JSON line of the kernels, and last
{"ok": true, "device": {...}}. Without a GPU it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B = 16                 # frames of the main run
B_REF = 2              # frames checked against the CPU path
MAX_T_ERR = 0.05       # m, the bar of tests/test_e2e_slice.py
MAX_R_ERR = 1.0        # degrees


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Median device time of fn() over reps launches, from CUDA events."""
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


def compare(knn, q, db, gate, masks=()) -> int:
    """Kernel against plain on the same tensors; returns max |diff| (0)."""
    got = knn.hamming_nn(q, db, gate, *masks)
    want = knn.hamming_nn_reference(q, db, gate, *masks)
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    if err:
        fail(f"hamming_nn differs from its plain version at {tuple(q.shape)} x "
             f"{tuple(db.shape)} masked={bool(masks)}: max |diff| {err}")
    return err


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

    # -- 3. kernel against plain on random inputs ---------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0
    masked_times = None
    for C, N, M in [(3, 400, 400), (3, 2048, 400), (2, 1, 1), (2, 1, 257),
                    (2, 129, 1), (2, 129, 257)]:
        q, db, gate, qm, dbm = random_case(C, N, M, dev, gen)
        for masks in [(), (qm, dbm)]:
            max_err = max(max_err, compare(knn, q, db, gate, masks))
        if (C, N, M) == (3, 2048, 400):
            masked_times = (cuda_ms(lambda: knn.hamming_nn(q, db, gate, qm, dbm)),
                            cuda_ms(lambda: knn.hamming_nn_reference(q, db, gate, qm, dbm)))
        print(f"hamming_nn == plain at C={C} N={N} M={M}, both variants")

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

    # warm-up frame, recording the wrapper's real inputs for phase 3b
    seen = []

    def spy(*args):
        seen.append(args)
        return knn.hamming_nn(*args)

    matcher.hamming_nn = spy
    try:
        run_chunk(extract, rig, frames[1:2], st, params, settings, tcfg)
    finally:
        matcher.hamming_nn = knn.hamming_nn
    torch.cuda.synchronize()
    timing = {}
    for name, args in zip(("motion", "local_map"), seen):
        q, db, gate, q_mask, db_mask = args
        masks = () if q_mask is None else (q_mask, db_mask)
        max_err = max(max_err, compare(knn, q, db, gate, masks))
        timing[name] = (cuda_ms(lambda: knn.hamming_nn(*args)),
                        cuda_ms(lambda: knn.hamming_nn_reference(*args)))
        print(f"hamming_nn on the main path's {name} inputs: q {tuple(q.shape)} "
              f"db {tuple(db.shape)} gate density {gate.float().mean().item():.5f}: "
              f"kernel {timing[name][0]:.4f} ms, plain {timing[name][1]:.4f} ms ({card})")
    print(f"hamming_nn masked at (3, 2048, 400) random: kernel {masked_times[0]:.4f} ms, "
          f"plain {masked_times[1]:.4f} ms ({card})")

    # the main path, counted: one chunk over B frames
    knn.hamming_nn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, ys = run_chunk(extract, rig, frames[1:], st, params, settings, tcfg)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    launches = knn.hamming_nn.launches
    if launches != 2 * B:
        fail(f"hamming_nn launched {launches} times over {B} frames, want {2 * B}")

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

    fused, local = timing["motion"], timing["local_map"]
    print(json.dumps({"kernels": [{
        "name": "hamming_nn",
        "route": "cuda",
        "source": "multicol_slam_tpu_torch/csrc/hamming_nn.cu",
        "replaces": "multicol_slam_tpu/ops/pallas/hamming_nn.py:146",
        "replaces_masked": "multicol_slam_tpu/ops/pallas/hamming_nn.py:206",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": fused[0] + local[0],
        "plain_ms": fused[1] + local[1],
        "ms_motion": fused[0], "plain_ms_motion": fused[1],
        "ms_local_map": local[0], "plain_ms_local_map": local[1],
        "ms_masked": masked_times[0], "plain_ms_masked": masked_times[1],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
