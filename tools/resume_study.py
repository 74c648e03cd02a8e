#!/usr/bin/env python3
"""Where a resume from a checkpoint of the organic episode's map can be
judged: runs of the port's episode side by side, each map checkpointed
after several frames, each checkpoint resumed.

    python3 tools/resume_study.py                          # 8 runs of seed 42, on the card
    python3 tools/resume_study.py --runs 1 --device cpu --frames 16 --at 14

Each run is ``utils/episode.py``'s episode at ``--seed`` in a process of
its own (on the card the runs differ by the float order of the card's
scatters). After each frame of ``--at`` its map is saved with
``utils/checkpoint.py``; when the run ends each checkpoint is loaded into
a fresh MultiColSLAM (loop closing off, as phase 10 of chip_smoke.py
resumes), the tracker set LOST and the two frames after it fed. For each
returned pose the error (m, degrees) against ground truth's step is
printed from three keyframes of the saved map: ``nearest`` (the one
nearest the checkpoint's frame in ground truth), ``newest`` (the last
made) and ``reference`` (``episode.reference_keyframe``: the one sharing
the most landmarks with the relocalized frame), each with the frame it
was made at. A run also prints the wide loop it fired, if any. One line
a run, ``RUN <i> <json>``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def judge(m, gt, at, t, M, tracker):
    """{reference rule: (keyframe's frame, m, degrees)} for pose M of frame t."""
    from multicol_slam_tpu_torch.utils import episode

    kfs = [k for k in m.keyframe_ids().tolist() if m.kf_frame_id[k] <= at]
    fids = m.kf_frame_id[kfs]
    rules = {"nearest": kfs[int(np.argmin(np.linalg.norm(gt[fids, :3, 3] - gt[at, :3, 3],
                                                         axis=1)))],
             "newest": kfs[int(np.argmax(fids))],
             "reference": episode.reference_keyframe(tracker, m, at)}
    return {name: (int(m.kf_frame_id[kf]),
                   *(round(e, 4) for e in episode.step_error(m, gt, kf, t, M)))
            for name, kf in rules.items() if kf is not None}


def one_run(args, out_dir):
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import checkpoint, config_io, episode

    dev = torch.device(args.device)
    slam, gt, frame, seed_closer, sync = episode.port_system(dev, args.seed)
    paths = {}

    def on_frame(t):
        if t in args.at:
            paths[t] = os.path.join(out_dir, f"run{args.one}_{t}.npz")
            checkpoint.save_map(paths[t], slam.map)
    res = episode.run_episode(slam, frame, gt, seed_closer=seed_closer, sync=sync,
                              log=lambda *a, **k: None, on_frame=on_frame,
                              n_frames=args.frames)
    out = {"wide_fired_frames": res.get("fired_frames") if res["bars"].get("wide") else None,
           "working_share": res["working_share"], "resumes": {}}
    for at, path in paths.items():
        m, _ = checkpoint.load_map(path, device=dev)
        fresh = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, device=dev,
                             settings=config_io.SlamSettings(**episode.SETTINGS),
                             enable_loop_closing=False, **episode.CAPACITY)
        fresh.map = fresh.tracker.map = fresh.mapper.map = m
        tr = fresh.tracker
        tr.state = type(tr.state).LOST
        tr.frame_id = at
        tr.cur_pt = np.full(m.kf_pt.shape[1:3], -1, np.int32)
        rows = []
        for t in (at + 1, at + 2):
            M = fresh.track(frame(t), t / episode.SETTINGS["fps"])
            rows.append(None if M is None else
                        judge(m, gt, at, t, np.asarray(M, np.float64), tr))
        out["resumes"][at] = {"paths": tr.frame_path[-2:], "errors": rows}
    print(f"RUN {args.one} {json.dumps(out)}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--at", type=int, nargs="+", default=[80, 88, 96, 104])
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        one_run(args, args.out)
        return
    if args.device.startswith("cuda"):
        from multicol_slam_tpu_torch.kernels import hamming_nn
        hamming_nn.load_library()          # built once, before the runs start
    out = tempfile.mkdtemp(prefix="resume_study_")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *sys.argv[1:],
                               "--one", str(i), "--out", out], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(args.runs)]
    for i, p in enumerate(procs):
        text, _ = p.communicate()
        lines = [ln for ln in text.splitlines() if ln.startswith("RUN ")]
        print(lines[0] if lines else f"run {i} exited {p.returncode}:\n{text[-3000:]}",
              flush=True)
    print(f"wall {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
