#!/usr/bin/env python3
"""Where the time of the port's system path goes, stage by stage.

    python3 tools/measure_system.py                 # on the card, from the repo root
    python3 tools/measure_system.py --mdbrief       # mdBRIEF + learned masks, AGAST 7_12
    python3 tools/measure_system.py --device cpu --frames 12 --profile-frames 1

Runs ``MultiColSLAM.track`` as ``chip_smoke.py`` phase 6 does (default
SlamSettings, or with ``--mdbrief`` phase 9's extractor options; the
in-repo rig at 754x480, ``bench_trajectory`` frames rendered on the
device, synchronous mapping) and prints:

- per-frame wall time by kind (init / working / keyframe with its mapping
  pass), median and p90, and the tracker's stage timers;
- each local-mapping stage's wall time per pass (a device sync before and
  after each stage, so the stages add up to the pass), with the first
  pass of the process apart: it carries the solvers' first use;
- over ``--profile-frames`` WORKING frames after the run, under
  ``torch.profiler``: the summed device time, the profiled wall time,
  the busy share of that profiled window, the device operations (kernels
  and copies) a frame, and the busiest operators.
  As many frames just before them run unprofiled, so the unprofiled
  busy share (device time over unprofiled wall) is an estimate from two
  adjacent windows, not one reading. (The system holds CUDA streams and
  graphs, so it cannot be copied to run one window twice.)
- on the card, the extraction alone by sub-stage over those frames, the
  kernels' path against the plain chain (``chip_smoke.extraction_split``:
  device us and operations a frame, eager).

The last line is one JSON object with every number printed. Times are
host wall clock around work that ends in a device sync; they vary between
machines, so compare only within one run.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter, defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MAP_STAGES = ("_update_point_stats_for_kf", "_cull_map_points", "_create_new_map_points",
              "_create_cross_camera_points", "_fuse_in_neighbors",
              "_local_bundle_adjustment", "_cull_keyframes")


def stats(xs):
    if not xs:
        return None
    return {"n": len(xs), "median": statistics.median(xs),
            "p90": float(np.percentile(xs, 90)), "min": min(xs), "max": max(xs)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--profile-frames", type=int, default=4)
    ap.add_argument("--mdbrief", action="store_true",
                    help="mdBRIEF with learned masks over AGAST 7_12 corners")
    args = ap.parse_args()

    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.models.tracking import TrackState
    from multicol_slam_tpu_torch.utils import config_io, synthetic

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("measure_system: no CUDA device (pass --device cpu)")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    card = "cpu"
    if cuda:
        card = subprocess.run(["nvidia-smi", "-i", str(dev.index or 0),
                               "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    opts = dict(use_mdbrief=True, learn_masks=True, use_agast=True,
                fast_agast_type=2) if args.mdbrief else {}
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, enable_loop_closing=False,
                        device=dev, settings=config_io.SlamSettings(**opts))
    n_all = args.frames + 2 * args.profile_frames
    gt = synthetic.bench_trajectory(n_all)
    render = synthetic.make_renderer(slam.rig)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev)))
    frames = frames.to(torch.uint8)

    # each mapping stage timed with a sync on both sides
    stage_ms: dict[str, list[float]] = defaultdict(list)
    mapper = slam.mapper
    for name in MAP_STAGES:
        fn = getattr(mapper, name)

        def timed(kf, _fn=fn, _name=name):
            sync()
            t0 = time.perf_counter()
            out = _fn(kf)
            sync()
            stage_ms[_name].append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(mapper, name, timed)

    kinds, times, init_frame = [], [], None
    for i in range(args.frames):
        was_working = slam.state == TrackState.WORKING
        n_passes = len(slam.mapping_ms)
        sync()
        t0 = time.perf_counter()
        M = slam.track(frames[i], i / 25.0)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        if M is not None and init_frame is None:
            init_frame = i
        kinds.append("init" if not was_working else
                     "keyframe" if len(slam.mapping_ms) > n_passes else "working")
    tr = slam.tracker
    out = {"card": card, "settings": opts, "frames": args.frames,
           "init_frame": init_frame,
           "keyframes": slam.map.n_keyframes(), "points": slam.map.n_points(),
           "frame_paths": dict(Counter(tr.frame_path)),
           "frame_ms": {k: stats([t for t, kd in zip(times, kinds) if kd == k])
                        for k in ("init", "working", "keyframe")},
           "mapping_pass_ms": list(slam.mapping_ms),
           "first_pass_ms": {s: v[0] for s, v in stage_ms.items()},
           "later_pass_ms": {s: stats(v[1:]) for s, v in stage_ms.items()},
           "tracker_stage_ms": tr.timers.summary()}

    # the WORKING frames past the run: a window unprofiled, then the next
    # as many profiled
    plain = range(args.frames, args.frames + args.profile_frames)
    window = range(args.frames + args.profile_frames, n_all)
    for name in MAP_STAGES:
        delattr(mapper, name)        # the stage timers end with the run
    if args.profile_frames and slam.state == TrackState.WORKING:
        sync()
        t0 = time.perf_counter()
        for i in plain:
            slam.track(frames[i], i / 25.0)
        sync()
        plain_wall = (time.perf_counter() - t0) * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        n_mapped = len(slam.mapping_ms)
        with torch.profiler.profile(activities=acts) as prof:
            sync()
            t0 = time.perf_counter()
            for i in window:
                slam.track(frames[i], i / 25.0)
            sync()
            prof_wall = (time.perf_counter() - t0) * 1e3
        ka = prof.key_averages()
        attr = "self_device_time_total" if hasattr(ka[0], "self_device_time_total") \
            else "self_cuda_time_total"
        # an operator's self device time is its kernels' time, and the
        # kernels are listed too: sum the device events only, rank operators
        on_dev = [e for e in ka if e.device_type != torch.autograd.DeviceType.CPU]
        ops = [e for e in ka if e.device_type == torch.autograd.DeviceType.CPU]
        dev_ms = sum(getattr(e, attr) for e in on_dev) / 1e3
        top = sorted(ops, key=lambda e: getattr(e, attr), reverse=True)[:8]
        out["profile"] = {
            "frames": len(window), "paths": slam.tracker.frame_path[-len(window):],
            "mapping_passes": len(slam.mapping_ms) - n_mapped,
            "device_ms": dev_ms, "profiled_wall_ms": prof_wall,
            "device_ops_per_frame": sum(e.count for e in on_dev) / len(window),
            "busy_share_profiled": dev_ms / prof_wall,
            "unprofiled_wall_ms": plain_wall,
            "busy_share_unprofiled_estimate": dev_ms / plain_wall,
            "top_ops": [{"name": e.key, "calls": e.count,
                         "device_ms": getattr(e, attr) / 1e3} for e in top]}

    if cuda and args.profile_frames:
        import chip_smoke
        from multicol_slam_tpu_torch.ops.pyramid import level_sizes

        s = slam.settings
        sizes = level_sizes(frames.shape[-2], frames.shape[-1], s.n_levels, s.scale_factor)
        out["extraction_split"] = {}
        for label, fn in (("kernels", slam.extract), ("plain", slam.extract.plain)):
            us, ops = chip_smoke.extraction_split(fn, frames[-args.profile_frames:], sizes,
                                                  args.profile_frames)
            out["extraction_split"][label] = {"device_us": us, "device_ops": ops}
            print(f"extraction by sub-stage, {label}: device us {us}; operations {ops}")

    for k, v in out["frame_ms"].items():
        print(f"frame ms, {k}: {v}")
    print(f"mapping passes ms: {[round(x, 3) for x in out['mapping_pass_ms']]}")
    for s in MAP_STAGES:
        print(f"  {s}: first pass {out['first_pass_ms'].get(s)}, "
              f"later passes {out['later_pass_ms'].get(s)}")
    print(tr.timers.report())
    if "profile" in out:
        p = out["profile"]
        print(f"profiled {p['frames']} frames {p['paths']}: device {p['device_ms']:.3f} ms "
              f"in {p['profiled_wall_ms']:.3f} ms profiled wall (busy "
              f"{p['busy_share_profiled']:.4f}); unprofiled wall {p['unprofiled_wall_ms']:.3f} ms "
              f"(busy estimate {p['busy_share_unprofiled_estimate']:.4f}); "
              f"{p['device_ops_per_frame']:.1f} device operations a frame")
        for e in p["top_ops"]:
            print(f"  {e['name']}: {e['calls']} calls, {e['device_ms']:.3f} device ms")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
