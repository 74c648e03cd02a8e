#!/usr/bin/env python3
"""Two measures of the pose LM that ``chip_smoke.py`` does not take.

    python3 tools/pose_lm_study.py --reloc      # on the card
    python3 tools/pose_lm_study.py --orders     # on the CPU, no card

``--reloc`` runs ``MultiColSLAM`` at its defaults over 40 frames of
``bench_trajectory``, then forces relocalizations on frames 40-42 with
the tracker's units eager, for each pose LM variant in the order build,
plain, plain, build (``build``: ``optimizer.pose_optimization`` as the
tree has it; ``plain``: its plain PyTorch version,
``pose_optimization_reference``): ``_relocalize``'s device us by stage
(the pose LM, GP3P, SearchByBoW, the BoW candidates, the projection round
and the local-map re-match) and in all, medians over a variant's six
relocalizations. Prints the card's name and power limit; the last line
is one JSON object.

``--orders`` runs on the CPU: the plain version's iterations in float64
and float32 on ``tests/_poseutil.py``'s problems (seeds 0-7), with the
rows in their order and reversed, which sums the same terms in another
order. (``chip_smoke.py`` phase 18 measures the same on the card, on
every recorded call.)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, ROOT)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--orders", action="store_true")
    mode.add_argument("--reloc", action="store_true")
    a = p.parse_args(argv)
    if a.orders:
        return orders()

    import torch

    from multicol_slam_tpu_torch.kernels import hamming_nn as knn
    from multicol_slam_tpu_torch.kernels import small_eig

    if not torch.cuda.is_available():
        raise SystemExit("pose_lm_study: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    knn.load_library()
    small_eig.load_library()
    reloc(card)


def reloc(card: str) -> None:
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from multicol_slam_tpu_torch.models import optimizer, tracking
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io, graphs, synthetic

    frames_n = 40
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR)
    tr = slam.tracker
    gt = synthetic.bench_trajectory(frames_n + 3)
    render = synthetic.make_renderer(slam.rig)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32,
                                             device=slam.rig.M_c.device))).to(torch.uint8)
    for i in range(frames_n):
        slam.track(frames[i], i / 25.0)
    held = {u: getattr(tr, u) for u in tracking.UNIT_NAMES}
    for u, g in held.items():
        if isinstance(g, graphs.jit):
            setattr(tr, u, g.fn)
    targets = [(tr, "reloc_candidates_fn", "bow"), (tr, "_reloc_matches", "search_by_bow"),
               (tr, "_gpnp", "gp3p"), (tr, "_pose_opt", "pose_lm"),
               (tr, "_reloc_project_candidate", "projection"),
               (tr, "_track_local_map", "local_map"), (tr, "_relocalize", "total")]
    fns = {"build": optimizer.pose_optimization,
           "plain": optimizer.pose_optimization_reference}
    runs = {k: [] for k in fns}
    t = frames_n
    for label in ("build", "plain", "plain", "build"):
        tr._pose_opt = fns[label]
        for i in range(frames_n, frames_n + 3):
            tr.force_reloc = True
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                    cs.Ranges(*targets):
                ok = slam.track(frames[i], t / 25.0) is not None
                torch.cuda.synchronize()
            t += 1
            us, ops, total, n_ops, _ = cs.stage_device(prof, "total")
            runs[label].append(dict(us=us, ops=ops, ok=ok, path=tr.frame_path[-1]))
    for u, g in held.items():
        setattr(tr, u, g)
    report = {}
    for label, rs in runs.items():
        stages = sorted({k for r in rs for k in r["us"]})
        med = {k: round(statistics.median(r["us"].get(k, 0.0) for r in rs), 3) for k in stages}
        ops = {k: statistics.median(r["ops"].get(k, 0) for r in rs) for k in stages}
        report[label] = dict(device_us=med, device_ops=ops, relocalized=[r["ok"] for r in rs],
                             paths=[r["path"] for r in rs])
        print(f"_relocalize with the {label} pose LM ({len(rs)} forced, eager units, medians): "
              f"device us by stage {med}, device operations {ops}, relocalized "
              f"{report[label]['relocalized']} ({card})")
    print(card)
    print(json.dumps({"card": card, "reloc": report}))


def orders() -> None:
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _poseutil import in_dtype, problem, rig
    from multicol_slam_tpu_torch.models import optimizer

    rows = []
    for seed in range(8):
        for dtype in (torch.float64, torch.float32):
            obs, X, mt0 = in_dtype(*problem(seed)[:3], dtype)
            flip = optimizer.BAObservations(*(t.flip(0) for t in obs))
            a = optimizer.pose_optimization_reference(rig(dtype), mt0, obs, X)
            b = optimizer.pose_optimization_reference(rig(dtype), mt0, flip, X)
            rows.append(dict(seed=seed, dtype=str(dtype), iterations=int(a[3]),
                             reversed=int(b[3]),
                             pose_diff=float((a[0] - b[0]).abs().max())))
            print(rows[-1])
    print(json.dumps({"orders": rows}))


if __name__ == "__main__":
    main()
