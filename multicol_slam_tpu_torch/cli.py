"""Command line of the port: the reference's ``multi_col_slam_lafida``
executable (Examples/Lafida/mult_col_slam_lafida.cpp), the counterpart of
the JAX package's ``tools/run_slam.py``.

Two inputs:
  --images DIR     a Lafida dataset: DIR/images_and_timestamps.txt with
                   lines ``timestamp img1 img2 img3`` (paths relative to
                   DIR), as LoadImagesAndTimestamps reads it
                   (mult_col_slam_lafida.cpp:167-199); decoding needs cv2
                   or PIL;
  --synthetic N    N frames of ``synthetic_trajectory`` rendered through
                   the calibration; the ATE against ground truth is
                   printed.

Writes MKFTrajectory.txt (TUM rows), map.npz (``utils/checkpoint.py``)
and, where matplotlib is installed, map.png. Runs on the card unless
given ``--device cpu``, and raises without one.

    python -m multicol_slam_tpu_torch.cli --calib multicol_slam_tpu_torch/data/synth_rig3 \\
        --synthetic 24 --async-mapping --out-dir out

``python -m multicol_slam_tpu_torch.evaluate`` scores a written
trajectory against ground truth.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def synthetic_trajectory(n_frames: int) -> np.ndarray:
    """(n_frames, 4, 4) ground truth of ``--synthetic``, the JAX CLI's:
    a lateral translation of 4.5 cm a frame with a slow yaw."""
    from .utils import synthetic
    return synthetic.lateral_trajectory(n_frames, step=0.045)


def load_lafida(images_dir: str, start: int, end: int):
    """Yield (images (C, H, W) float32, timestamp) from a Lafida dataset,
    lines ``start`` (1-based) up to ``end`` (excluded, -1 for all)."""
    try:
        import cv2

        def imread_gray(p):
            img = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
            if img is None:
                raise FileNotFoundError(p)
            return img.astype(np.float32)
    except ImportError:
        try:
            from PIL import Image
        except ImportError as exc:
            raise RuntimeError("--images needs cv2 or PIL to decode the images, and "
                               "neither is installed") from exc

        def imread_gray(p):
            return np.asarray(Image.open(p).convert("L"), np.float32)

    rows = []
    with open(os.path.join(images_dir, "images_and_timestamps.txt")) as f:
        for cnt, line in enumerate(f, start=1):
            if start <= cnt and (end < 0 or cnt < end):
                parts = line.split()
                if len(parts) < 4:
                    break
                rows.append((float(parts[0]),
                             [os.path.join(images_dir, p) for p in parts[1:4]]))
    for ts, paths in rows:
        yield np.stack([imread_gray(p) for p in paths]), ts


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m multicol_slam_tpu_torch.cli",
                                 description="Run MultiCol-SLAM (the PyTorch/CUDA port) "
                                             "on a Lafida dataset or a synthetic sequence.")
    ap.add_argument("--calib", required=True,
                    help="calibration dir (MultiCamSys_Calibration.yaml and the cameras')")
    ap.add_argument("--settings", default=None, help="SLAM settings yaml")
    ap.add_argument("--images", default=None, help="Lafida dataset dir")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N synthetic frames instead of a dataset")
    ap.add_argument("--vocabulary", default=None,
                    help=".npz vocabulary or DBoW2 .yml (trained from the map when omitted)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--async-mapping", action="store_true",
                    help="map in a thread of its own (on the card, a stream of its own)")
    ap.add_argument("--no-loops", action="store_true")
    ap.add_argument("--view", action="store_true",
                    help="live viewer: redraws live_map.png and live_frame.png in --out-dir")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="rescale the calibration (a dataset made at another size)")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    if not args.images and not args.synthetic:
        ap.error("need --images or --synthetic")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    from .models.system import MultiColSLAM
    from .ops.rig import scale_rig
    from .utils import checkpoint, config_io, synthetic, viz
    from .utils.trajectory import ate_rmse

    os.makedirs(args.out_dir, exist_ok=True)
    rig = None
    if args.scale != 1.0:
        rig = scale_rig(config_io.load_mcs(args.calib)[0], args.scale)
    slam = MultiColSLAM(args.calib, settings_path=args.settings,
                        async_mapping=args.async_mapping,
                        enable_loop_closing=not args.no_loops,
                        vocabulary_path=args.vocabulary, rig=rig, device=args.device)
    dev = slam.device
    drawing = viz.have_matplotlib()
    if args.view:
        if drawing:
            slam.attach_viewer(args.out_dir, period_s=1.0)
        else:
            print("--view needs matplotlib, which is not installed: no live view")

    gt = None
    if args.synthetic:
        render = synthetic.make_renderer(slam.rig)
        gt = synthetic_trajectory(args.synthetic)
        frames = ((render(torch.tensor(gt[t], dtype=torch.float32, device=dev)),
                   t / slam.settings.fps) for t in range(args.synthetic))
    else:
        frames = load_lafida(args.images, slam.settings.start_frame,
                             slam.settings.end_frame)

    sync = (lambda: torch.cuda.current_stream(dev).synchronize()) if dev.type == "cuda" \
        else (lambda: None)
    times, est, used = [], [], []
    n = 0
    try:
        for images, ts in frames:
            images = torch.as_tensor(images, device=dev)
            sync()
            t0 = time.perf_counter()
            M = slam.track(images, ts)
            sync()
            times.append(time.perf_counter() - t0)
            if M is not None:
                est.append(M)
                used.append(n)
            n += 1
            if n % 25 == 0:
                print(f"frame {n}: state={slam.state.name} kfs={slam.map.n_keyframes()} "
                      f"pts={slam.map.n_points()}", flush=True)
    finally:
        slam.shutdown()

    traj_path = os.path.join(args.out_dir, "MKFTrajectory.txt")
    slam.save_trajectory(traj_path)
    map_path = os.path.join(args.out_dir, "map.npz")
    checkpoint.save_map(map_path, slam.map)
    outputs = [traj_path, map_path]
    if drawing:
        outputs.append(viz.draw_map(slam.map, slam.rig, trajectory=slam.tracker.all_poses,
                                    path=os.path.join(args.out_dir, "map.png")))
    t = np.asarray(times)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print("-------")
    print(f"processed {n} frames on {name}; median track time {np.median(t) * 1e3:.1f} ms, "
          f"mean {t.mean() * 1e3:.1f} ms")
    print(slam.tracker.timers.report())
    if gt is not None and len(est) > 3:
        ate = ate_rmse(np.stack([M[:3, 3] for M in est]), gt[used, :3, 3])
        print(f"ATE RMSE vs ground truth: {ate:.5f} m over {len(est)} frames")
    print("outputs: " + ", ".join(outputs)
          + ("" if drawing else "; map.png not drawn: matplotlib is not installed"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
