#!/usr/bin/env python3
"""The readings that a cell's limits for ``correct`` are set from.

    python3 portbench/controls.py --workload orb3.laps_batch --seeds 11 12 13 --seconds 20

On the card, a run of the cell a seed (set-up and the window as
``run.py`` makes them, the outputs checked as it checks them), and on
the same outputs:

- ``sound``: the program's numbers (the lower readings);
- ``control``: the reference put in the program's place at the nearest
  precision below the configuration's float32, TF32 (the pyramid's
  resampling products), its features judged against the float32
  reference's;
- ``stale``: a step that returns its state unchanged (every pose of the
  window the window's first);
- ``half``: half of each call left out (every second frame without a
  pose);
- ``moved``: an answer altered where it is produced (one pose in five
  moved 20 cm);
- ``turned``: the same, one pose in five turned 5 degrees about the
  body's vertical axis;
- ``landmarks``: each landmark pushed 20% farther from the centre of the
  window's poses (the lap's centre).

Each is judged against the cell's limits as a run is (``run.judge``).
The benchmark's own runs do not run this. One JSON line a seed: each
variant's numbers and its ``correct``.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import run, spec  # noqa: E402

FAULT_MOVE_M = 0.2
FAULT_TURN_DEG = 5.0
FAULT_PUSH = 1.2


def move(p, metres=FAULT_MOVE_M):
    """Pose p (4, 4) with its position moved ``metres`` along each axis."""
    q = np.array(p, np.float64)
    q[:3, 3] += metres
    return q


def turn(p, degrees=FAULT_TURN_DEG):
    """Pose p (4, 4) turned ``degrees`` about the body's vertical axis."""
    a = np.radians(degrees)
    c, s = np.cos(a), np.sin(a)
    q = np.array(p, np.float64)
    q[:3, :3] = q[:3, :3] @ np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return q


def push(points, centre, factor=FAULT_PUSH):
    """Landmarks (N, 3) pushed ``factor`` times as far from ``centre``."""
    return centre + factor * (np.asarray(points, np.float64) - centre)


def faults(r) -> dict:
    """Each fault's numbers on run ``r``'s outputs, and the control's."""
    import torch

    frames = r.window.frames()
    got = [(g, p) for g, p in frames if p is not None]
    first = got[0][1] if got else None
    stale = [(g, None if p is None else first) for g, p in frames]
    half = [(g, None if i % 2 else p) for i, (g, p) in enumerate(frames)]

    def every_fifth(fault):
        return [(g, fault(p) if p is not None and i % 5 == 0 else p)
                for i, (g, p) in enumerate(frames)]
    centre = np.mean([np.asarray(p)[:3, 3] for _, p in got], 0)

    def tf32(g):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return r.plain(r.traffic.frames[int(r.traffic.index(g))])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    return {"sound": r.values(), "control": r.values(features=tf32),
            "stale": r.values(poses=stale), "half": r.values(poses=half),
            "moved": r.values(poses=every_fifth(move)),
            "turned": r.values(poses=every_fifth(turn)),
            "landmarks": r.values(points=push(r.points, centre))}


def landmark_spread(r) -> dict:
    """The map's size and the quartiles and 90th percentile (cm) of its
    landmarks' distances to the walls after the window's alignment: where
    in the map a median reading comes from."""
    from portbench import world
    from portbench.reference import trajectory

    got = [(g, p) for g, p in r.window.frames() if p is not None]
    if len(got) < 3 or not len(r.points):
        return {}
    err = trajectory.pose_errors(np.stack([np.asarray(p, np.float64) for _, p in got]),
                                 r.traffic.pose(np.array([g for g, _ in got])))
    X = (err["scale"] * (err["R"] @ r.points.T)).T + err["t"]
    d = world.surface_distance(X) * 100
    return {"points": len(d), "window_frames": len(got), "scale": err["scale"],
            "cm_q": [float(x) for x in np.percentile(d, [25, 50, 75, 90])]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings of a cell's numbers under its control "
                                             "and faults.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("controls: no CUDA card", file=sys.stderr)
        return 2
    bench = spec.Benchmark(run.ROOT)
    cell = bench.cell(args.workload)
    limits = spec.limits(cell["name"])
    for seed in args.seeds:
        r = run.Run(bench, cell, seed, args.seconds, False, torch.device("cuda:0"))
        out = {}
        for name, values in faults(r).items():
            values.pop("keyframes_checked", None)
            correct, _ = run.judge(limits, values)
            out[name] = dict(values, correct=correct)
            print(f"{args.workload} seed {seed} {name}: correct {correct}", file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "landmarks_spread": landmark_spread(r)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
