#!/usr/bin/env python3
"""The stretch configuration's eight-camera ring (``chip_smoke.py`` phase
12 (a)), seed by seed, in either package.

    python3 tools/ring_study.py --seeds 42 1 2 3 4 5 6 7              # the port, on the card
    python3 tools/ring_study.py --device cpu --seeds 42               # the port, on the CPU
    python3 tools/ring_study.py --package jax --seeds 42 1 2 3 4      # the JAX package, CPU
    python3 tools/ring_study.py --device cpu --orb --scale 0.5        # tests/test_eight_camera.py's settings

For each RANSAC seed: ``MultiColSLAM`` on the ring at phase 12 (a)'s
settings (mdBRIEF with learned masks, 400 features, 8 levels, fps 8,
full width; ``--orb`` for the default extractor, ``--n-features`` and
``--n-levels`` to change them, ``--scale`` for the image size) over
``chip_smoke.ring_tour()`` in the 2.5 m room, loop closing off: the init
frame, keyframes, points, frames tracked, the Sim3-aligned ATE, each
tracked frame's error after that alignment, and the ratio of each
tracked step's length to ground truth's, which shows the map's scale
after the bootstrap. The port's seed is its tracker's generator seed;
``--package jax`` runs the JAX package (it needs JAX) on the CPU with
``PRNGKey(seed)``, on the same frames. Both packages build the ring from
``chip_smoke.ring_cayley()``. The last line is one JSON object of the
per-seed outcomes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from multicol_slam_tpu_torch.ops.rig import scale_rig  # noqa: E402
from multicol_slam_tpu_torch.utils import config_io, synthetic  # noqa: E402
from multicol_slam_tpu_torch.utils.trajectory import align_umeyama, ate_rmse  # noqa: E402


def port_system(rig, settings, seed):
    from multicol_slam_tpu_torch.models.system import MultiColSLAM

    slam = MultiColSLAM(rig=rig, settings=settings, capacity_pts=20000, capacity_kfs=64,
                        enable_loop_closing=False)
    slam.tracker.gen.manual_seed(seed)
    return slam, lambda f: f


def jax_system(settings, scale, seed):
    """The JAX package's system in float32 on the ring built from the same
    minimal extrinsics, seeded."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from multicol_slam_tpu.models.system import MultiColSLAM
    from multicol_slam_tpu.ops import camera as jcam, rig as jrig
    from multicol_slam_tpu.utils import config_io as jcio

    jax.config.update("jax_platforms", "cpu")
    base, _ = jcio.load_mcs(config_io.SYNTH_RIG_DIR, dtype=np.float32)
    cam0 = jax.tree.map(lambda x: x[0], base.cams)
    ring = jrig.rig_from_cayley(cs.ring_cayley(), jcam.stack_cameras([cam0] * cs.RING_CAMS))
    if scale != 1.0:
        ring = jrig.scale_rig(ring, scale)
    slam = MultiColSLAM(rig=ring, settings=jcio.SlamSettings(**dataclasses.asdict(settings)),
                        capacity_pts=20000, capacity_kfs=64, enable_loop_closing=False)
    slam.tracker.key = jax.random.PRNGKey(seed)
    return slam, lambda f: jnp.asarray(f.cpu().numpy())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42])
    ap.add_argument("--device", default="cuda", help="the port's device (the JAX package: CPU)")
    ap.add_argument("--orb", action="store_true", help="the default extractor, not mdBRIEF")
    ap.add_argument("--n-features", type=int, default=None)
    ap.add_argument("--n-levels", type=int, default=None)
    ap.add_argument("--scale", type=float, default=1.0, help="image size against 754x480")
    args = ap.parse_args()
    dev = torch.device("cpu" if args.package == "jax" else args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu")
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    kw = dict(fps=8.0) if args.orb else dict(cs.RING_SETTINGS)
    kw.update({k: v for k, v in (("n_features", args.n_features),
                                 ("n_levels", args.n_levels)) if v is not None})
    settings = config_io.SlamSettings(**kw)
    rig = cs.ring_rig(dev)
    if args.scale != 1.0:
        rig = scale_rig(rig, args.scale)
    gt = cs.ring_tour()
    frames = synthetic.make_renderer(rig, room_half=cs.RING_ROOM_HALF)(
        torch.tensor(gt, dtype=torch.float32, device=dev))
    frames = torch.round(frames).to(torch.uint8)
    out = {}
    for seed in args.seeds:
        slam, feed = (port_system(rig, settings, seed) if args.package == "port"
                      else jax_system(settings, args.scale, seed))
        est, used = [], []
        for i in range(len(gt)):
            M = slam.track(feed(frames[i]), i / settings.fps)
            if M is not None:
                est.append(np.asarray(M, np.float64)[:3, 3])
                used.append(i)
        slam.shutdown()
        m = slam.map
        res = dict(init=used[0] if used else None, keyframes=int(m.n_keyframes()),
                   points=int(m.n_points()), tracked=len(used))
        if len(used) > 2:
            est, ref = np.stack(est), gt[used, :3, 3]
            s, R, t = align_umeyama(est, ref)
            res.update(
                ate=float(ate_rmse(est, ref)),
                frame_err=np.round(np.linalg.norm((s * (R @ est.T)).T + t - ref, axis=1),
                                   4).tolist(),
                step_ratio=np.round(np.linalg.norm(np.diff(est, axis=0), axis=1)
                                    / np.linalg.norm(np.diff(ref, axis=0), axis=1), 3).tolist())
        out[seed] = res
        print(f"{args.package} seed {seed}: {res}", flush=True)
    print(json.dumps({"package": args.package, "device": str(dev), "settings": kw,
                      "scale": args.scale, "seeds": out}))


if __name__ == "__main__":
    main()
