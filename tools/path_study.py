#!/usr/bin/env python3
"""The tracker's frames by path, on the card: ms a frame for each path the
tracker takes (``Tracker.frame_path``: ``init``, ``velocity``,
``reloc_recent``, ``reloc``, ``fused``, ...) and ms a call of each unit
off the fused path, for one or more trees of the port, one process a
tree, in the order given (compare two trees in turns: parent, change,
change, parent).

The run is ``chip_smoke.py``'s phases 6 and 7: ``MultiColSLAM`` at its
defaults over 40 frames of ``bench_trajectory``, then a kidnap to frame
20, the same kidnap with the BoW hooks unset, and a relocalization forced
on frames 40-42. Each frame is timed on the host clock to a sync of the
tracker's stream; each unit (the tracker's methods ``_try_initialize``,
``_track_previous_frame``, ``_optimize_current_pose``,
``_track_local_map``, ``_reloc_project_candidate``, ``_relocalize``, the
GP3P RANSAC, the bootstrap's ``initialize_device``, the BoW hooks) the
same way, each call ended by a sync. A tree whose tracker graphs its
units (``Tracker._gpnp``) is timed through those; an older tree through
the module functions it calls eagerly.

    python3 tools/path_study.py --trees _scratch/parent . . _scratch/parent

Prints each run's medians beside the card's name and power limit; the
last line is one JSON object, a list of runs. Each run also gives the
bootstrap frame and the first fused frame after it (index and ms), the
ATE over the 40 frames, and what the capture-ahead captured and what
captured after it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FRAMES = 40
RELOC_FRAMES = 3
KIDNAP_FRAME = 20


def card() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()


class Clock:
    """ms of each call of the wrapped callables, each ended by a sync of
    the calling thread's stream."""

    def __init__(self):
        self.ms: dict = {}

    def wrap(self, label, f):
        import torch

        def timed(*a, **k):
            torch.cuda.current_stream().synchronize()
            t0 = time.perf_counter()
            out = f(*a, **k)
            torch.cuda.current_stream().synchronize()
            self.ms.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
            return out
        return timed


def run(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from multicol_slam_tpu_torch.models import tracking
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io, graphs, synthetic
    from multicol_slam_tpu_torch.utils.trajectory import ate_rmse

    if not torch.cuda.is_available():
        raise SystemExit("path_study: no CUDA device")
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR)
    tr = slam.tracker
    clock = Clock()
    for name in ("_try_initialize", "_track_previous_frame", "_optimize_current_pose",
                 "_track_local_map", "_reloc_project_candidate", "_relocalize"):
        setattr(tr, name, clock.wrap(name, getattr(tr, name)))
    graphed = hasattr(tr, "_gpnp")
    if graphed:
        tr._gpnp = clock.wrap("ransac_gpnp", tr._gpnp)
        tr._init_device = clock.wrap("initialize_device", tr._init_device)
    else:
        tracking.ransac.ransac_gpnp = clock.wrap("ransac_gpnp", tracking.ransac.ransac_gpnp)
        tracking.initializer.initialize_device = clock.wrap(
            "initialize_device", tracking.initializer.initialize_device)

    gt = synthetic.bench_trajectory(FRAMES + RELOC_FRAMES)
    render = synthetic.make_renderer(slam.rig)
    dev = slam.rig.M_c.device
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev)))
    frames = frames.to(torch.uint8)
    by_path: dict = {}
    frame_ms = []

    def track(img, t):
        torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        out = slam.track(img, t)
        torch.cuda.current_stream().synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        by_path.setdefault(tr.frame_path[-1], []).append(ms)
        frame_ms.append((tr.frame_path[-1], round(ms, 3)))
        return out

    for i in range(FRAMES):
        track(frames[i], i / 25.0)
    # the bootstrap frame (the last init frame), the first fused frame
    # after it, and the ATE over the tracked frames, as phase 6 takes it
    paths = [p for p, _ in frame_ms]
    boot = max(i for i, p in enumerate(paths) if p == "init")
    fused = paths.index("fused", boot) if "fused" in paths[boot:] else None
    poses = np.stack(tr.all_poses)
    ate = ate_rmse(poses[:, :3, 3], gt[FRAMES - len(poses):FRAMES, :3, 3])
    ahead = dict(captured=list(getattr(tr, "captured_ahead", [])),
                 late=[list(c) for c in getattr(tr, "late_captures", [])])
    if tr.reloc_candidates_fn is not None:
        tr.reloc_candidates_fn = clock.wrap("reloc_candidates", tr.reloc_candidates_fn)
        tr.reloc_bow_match_fn = clock.wrap("bow_match_frame", tr.reloc_bow_match_fn)
    t = FRAMES / 25.0
    tr.force_reloc = True                         # a kidnap to frame KIDNAP_FRAME
    kidnap = track(frames[KIDNAP_FRAME], t) is not None
    hooks = tr.reloc_candidates_fn, tr.reloc_bow_match_fn
    tr.reloc_candidates_fn = tr.reloc_bow_match_fn = None
    tr.force_reloc = True                         # the same with no BoW hooks
    kidnap_window = track(frames[KIDNAP_FRAME], t + 0.5 / 25.0) is not None
    tr.reloc_candidates_fn, tr.reloc_bow_match_fn = hooks
    tr.force_reloc = True                         # a forced relocalization
    forced = [track(frames[i], (i + 1) / 25.0) is not None
              for i in range(FRAMES, FRAMES + RELOC_FRAMES)]
    med = lambda xs: round(statistics.median(xs), 3) if xs else None
    st = graphs.stats()
    return dict(
        tree=tree, graphed_units=graphed, device=torch.cuda.get_device_name(0),
        frame_ms_by_path={k: dict(median=med(v), n=len(v), all=[round(x, 3) for x in v])
                          for k, v in by_path.items()},
        unit_ms={k: dict(median=med(v), n=len(v), first=round(v[0], 3),
                         all=[round(x, 3) for x in v]) for k, v in clock.ms.items()},
        extraction_ms=med(tr.timers.samples.get("feature_extraction", [])),
        frames=frame_ms, bootstrap=[boot, frame_ms[boot][1]],
        first_fused=None if fused is None else [fused, frame_ms[fused][1]],
        ate_m=round(float(ate), 6), capture_ahead=ahead,
        kidnap=kidnap, kidnap_no_hooks=kidnap_window, forced=forced,
        keyframes=int(slam.map.n_keyframes()),
        captures={k: (v["captures"], v["replays"]) for k, v in st["by_fn"].items()},
        ok=bool(np.all(forced)) and kidnap and kidnap_window)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=[ROOT],
                    help="trees of the port, one process each, in this order")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(run(args.one)))
        return
    name = card()
    runs = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"path_study: the run of {tree} failed")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(r)
        paths = {k: (v["median"], v["n"]) for k, v in r["frame_ms_by_path"].items()}
        units = {k: (v["median"], v["first"], v["n"]) for k, v in r["unit_ms"].items()}
        print(f"{tree} (graphed units {r['graphed_units']}): frame ms by path "
              f"(median, n) {paths}; unit ms (median, first, n) {units}; extraction "
              f"median {r['extraction_ms']}; relocalized {r['kidnap']} {r['kidnap_no_hooks']} "
              f"{r['forced']}; the bootstrap frame (index, ms) {r['bootstrap']}, the first "
              f"fused frame {r['first_fused']}, ATE {r['ate_m']} m; the capture-ahead "
              f"{r['capture_ahead']} ({name})")
    print(name)
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
