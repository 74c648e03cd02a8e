#!/usr/bin/env python3
"""What async mapping and the chunked path do to the frame time, measured
in turns in one process: the port's MultiColSLAM at the default settings
on the in-repo rig over the first 40 frames of ``bench_trajectory(43)``
(chip_smoke.py phase 6's run), in the order sync, async, async, sync,
per-frame, chunked, chunked, per-frame.

- sync / async: ``track`` per frame with synchronous or async mapping.
  Per run: the WORKING frames' host ms (median, p90), split into frames
  that overlapped a mapping pass on the mapper thread and frames that did
  not, and the keyframe frames' ms.
- per-frame / chunked: synchronous mapping, ``track`` per frame or
  ``track_batch(chunk=8)``. Per chunked run: ms a chunk frame with the
  mapping passes run inside the chunk (synchronous mapping) taken out,
  against the per-frame run's WORKING median; dispatches a steady frame.

Host ms around work that ends in a sync of the tracking thread's stream.

    python3 tools/async_study.py                  # on the card
    python3 tools/async_study.py --device cpu --frames 20

The last line is one JSON object of the medians per run.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch


def pct(xs, q):
    return float(np.percentile(xs, q)) if xs else None


def run(mode, frames, device, sync_fn):
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.models.tracking import TrackState
    from multicol_slam_tpu_torch.utils import config_io

    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, device=device,
                        async_mapping=mode == "async")
    n = len(frames)
    ts = [i / 25.0 for i in range(n)]
    out = dict(mode=mode)
    try:
        if mode == "chunked":
            chunk = []
            track_chunk = slam.tracker.track_chunk

            def timed_chunk(images, stamps):
                n_pass = len(slam.mapping_ms)
                sync_fn()
                t0 = time.perf_counter()
                r = track_chunk(images, stamps)
                sync_fn()
                ms = (time.perf_counter() - t0) * 1e3
                if r is not None:
                    chunk.append((r[0], ms, sum(slam.mapping_ms[n_pass:])))
                return r

            slam.tracker.track_chunk = timed_chunk
            slam.track_batch(frames, ts, chunk=8)
            n_chunk = sum(a for a, _, _ in chunk)
            out.update(chunk_frames=n_chunk,
                       ms_per_chunk_frame=sum(ms - mp for _, ms, mp in chunk) / max(n_chunk, 1),
                       mapping_ms_in_chunks=sum(mp for _, _, mp in chunk))
        else:
            kinds, times, overlap = [], [], []
            for i in range(n):
                was_working = slam.state == TrackState.WORKING
                n_kf = slam.map.n_keyframes()
                busy0 = slam._mapper_busy.is_set()
                sync_fn()
                t0 = time.perf_counter()
                slam.track(frames[i], ts[i])
                sync_fn()
                times.append((time.perf_counter() - t0) * 1e3)
                overlap.append(busy0 or slam._mapper_busy.is_set())
                kinds.append("init" if not was_working else
                             "keyframe" if slam.map.n_keyframes() > n_kf else "working")
            work = [t for t, k in zip(times, kinds) if k == "working"]
            work_ov = [t for t, k, o in zip(times, kinds, overlap) if k == "working" and o]
            work_free = [t for t, k, o in zip(times, kinds, overlap) if k == "working" and not o]
            kf = [t for t, k in zip(times, kinds) if k == "keyframe"]
            out.update(working_median=statistics.median(work), working_p90=pct(work, 90),
                       n_working=len(work), n_overlap=len(work_ov),
                       overlap_median=statistics.median(work_ov) if work_ov else None,
                       free_median=statistics.median(work_free) if work_free else None,
                       keyframe_median=statistics.median(kf) if kf else None)
        out.update(disp_steady=float(np.mean(slam.tracker.dispatches_per_frame[10:])),
                   n_kf=slam.map.n_keyframes(), mapping_ms=[round(x, 3) for x in slam.mapping_ms])
    finally:
        slam.shutdown()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args()
    from multicol_slam_tpu_torch.utils import config_io, synthetic

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu")
        card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip()
        sync_fn = lambda: torch.cuda.current_stream(dev).synchronize()
    else:
        card, sync_fn = "cpu", (lambda: None)
    print(card)
    rig, _ = config_io.load_mcs(config_io.SYNTH_RIG_DIR)
    gt = synthetic.bench_trajectory(43)[:args.frames]
    render = synthetic.make_renderer(rig.to(dev))
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev))).to(torch.uint8)
    results = []
    for mode in ("sync", "async", "async", "sync", "per-frame", "chunked", "chunked",
                 "per-frame"):
        r = run("sync" if mode == "per-frame" else mode, frames, dev, sync_fn)
        r["mode"] = mode
        results.append(r)
        print(json.dumps(r) + f" ({card})", flush=True)
    print(json.dumps({"card": card, "runs": results}))


if __name__ == "__main__":
    main()
