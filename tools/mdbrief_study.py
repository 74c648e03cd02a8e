#!/usr/bin/env python3
"""A relocalization forced at the reference's own extractor options
(mdBRIEF with learned masks over AGAST 7_12, ``chip_smoke.py`` phase 9),
seed by seed.

    python3 tools/mdbrief_study.py --seeds 42 1 2 3                  # the port, on the card
    python3 tools/mdbrief_study.py --device cpu --seeds 42 1         # the port, on the CPU
    python3 tools/mdbrief_study.py --package jax --seeds 42 1 2 3    # the JAX package, CPU
    python3 tools/mdbrief_study.py --package jax --port-features --seeds 42 1

For each RANSAC seed: the system over the 43 frames of
``bench_trajectory(43)`` at full width with a relocalization forced on
frame ``--reloc-at`` (40 by default, as phase 9): the init frame, the
keyframes, the ATE over frames 0-39, and for that frame and the next two
each frame's path, each returned pose's error against ground truth's
step from the frame before the forced one (``reloc_error``), and each
relocalization's steps (SearchByBoW matches per candidate keyframe, GP3P
inliers, pose LM outcomes). The port's seed is its tracker's generator
seed (42 by default). ``--package jax`` runs the JAX package (it needs
JAX) on the CPU with ``PRNGKey(seed)``; with ``--port-features`` it
extracts nothing of its own and takes the port's CPU extraction of every
frame, handed in by a host callback that finds the frame by its pixels
(the JAX tracker extracts inside its jitted WORKING step), so that the
two packages' steps can be set side by side on the same features.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multicol_slam_tpu_torch.utils import config_io, convert, synthetic  # noqa: E402
from multicol_slam_tpu_torch.utils.trajectory import ate_rmse  # noqa: E402

MDBRIEF = dict(use_mdbrief=True, learn_masks=True, use_agast=True, fast_agast_type=2)
N_FRAMES, N_RELOC = 40, 3


def render(n, dev):
    gt = synthetic.bench_trajectory(n)
    rig, _ = config_io.load_mcs(config_io.SYNTH_RIG_DIR)
    rig = rig.to(dev)
    frames = synthetic.make_renderer(rig)(torch.tensor(gt, dtype=torch.float32, device=dev))
    return gt, rig, torch.round(frames).to(torch.uint8)


def trace_relocalization(tk, ransac_mod, log):
    """Wraps the tracker's SearchByBoW hook, GP3P RANSAC and pose LM (the
    JAX package's and the port's have the same names) so that each call
    appends a line to ``log``. Returns a function that unwraps them."""
    bow, gpnp, lm = tk.reloc_bow_match_fn, ransac_mod.ransac_gpnp, tk._optimize_current_pose

    def bow_fn(kf, feats):
        triples = bow(kf, feats)
        log.append(f"kf {kf} {len(triples)} matches")
        return triples

    def gpnp_fn(*a, **k):
        out = gpnp(*a, **k)
        log.append(f"GP3P {int(out[2])} of {int(a[4].sum())} inliers")
        return out

    def lm_fn(*a):
        ok = lm(*a)
        n = int(((tk.cur_pt >= 0) & ~tk.cur_outlier).sum())
        log.append(f"pose LM {'ok' if ok else 'failed'}, {n} associations")
        return ok

    tk.reloc_bow_match_fn, ransac_mod.ransac_gpnp, tk._optimize_current_pose = bow_fn, gpnp_fn, lm_fn

    def undo():
        tk.reloc_bow_match_fn, ransac_mod.ransac_gpnp = bow, gpnp
        del tk._optimize_current_pose
    return undo


def port_system(rig, seed):
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.ops import ransac
    slam = MultiColSLAM(rig=rig, settings=config_io.SlamSettings(**MDBRIEF))
    slam.tracker.gen.manual_seed(seed)
    return slam, ransac, lambda x: x


def jax_system(rig, seed, frames, port_features):
    """The JAX package's system in float32, seeded; with
    ``port_features`` each frame's features are the port's (CPU)."""
    import jax
    import jax.numpy as jnp
    from multicol_slam_tpu.models import extractor as jext
    from multicol_slam_tpu.models import system as jsys
    from multicol_slam_tpu.ops import ransac
    from multicol_slam_tpu.utils import config_io as jcio
    from multicol_slam_tpu_torch.models.system import MultiColSLAM

    jax.config.update("jax_enable_x64", False)
    slam = jsys.MultiColSLAM(
        rig=jax.tree.map(jnp.asarray, jcio.load_mcs(config_io.SYNTH_RIG_DIR, dtype=np.float32)[0]),
        settings=jcio.SlamSettings(**MDBRIEF))
    slam.tracker.key = jax.random.PRNGKey(seed)
    feed = lambda x: jnp.asarray(x.numpy())
    if not port_features:
        return slam, ransac, feed
    port = MultiColSLAM(rig=rig, settings=config_io.SlamSettings(**MDBRIEF), device="cpu",
                        enable_loop_closing=False)
    index = {f.numpy().tobytes(): i for i, f in enumerate(frames)}
    for name in ("extract", "extract_init"):
        feats = [convert.features_to_numpy(getattr(port, name)(f)) for f in frames]
        shapes = jext.Features(**{k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                  for k, v in feats[0].items()})
        host = lambda images, feats=feats: jext.Features(
            **feats[index[np.asarray(images).tobytes()]])
        setattr(slam, name, lambda images, host=host, shapes=shapes:
                jax.pure_callback(host, shapes, images))
    return slam, ransac, feed


def reloc_error(m, poses, gt, at, i):
    """(m, degrees): frame i's returned pose against ground truth, both
    relative to frame at - 1: its pose in map m when it is a keyframe
    (local BA may have moved it since it was returned), else the pose
    returned for it. None without a pose."""
    from multicol_slam_tpu_torch.ops import se3_np
    if poses[i] is None:
        return None
    kf = [k for k in np.nonzero(np.asarray(m.kf_valid))[0] if int(m.kf_frame_id[k]) == at - 1]
    ref = se3_np.cayley2hom(np.asarray(m.kf_pose[kf[0]], np.float64)) if kf else poses[at - 1]
    est, true = np.linalg.inv(ref) @ poses[i], np.linalg.inv(gt[at - 1]) @ gt[i]
    c = (np.trace(est[:3, :3].T @ true[:3, :3]) - 1.0) / 2.0
    return (round(float(np.linalg.norm(est[:3, 3] - true[:3, 3])), 4),
            round(float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))), 3))


def run(slam, ransac_mod, frames, feed, gt, at):
    """Every frame, a relocalization forced on frame ``at``; that frame
    and the next N_RELOC - 1 traced. Returns (poses, the traced frames'
    errors (``reloc_error``), one log a traced frame)."""
    poses, errs, logs = [], [], []
    for i in range(len(frames)):
        traced = at <= i < at + N_RELOC
        if traced:
            slam.tracker.force_reloc |= i == at
            logs.append([])
            undo = trace_relocalization(slam.tracker, ransac_mod, logs[-1])
        M = slam.track(feed(frames[i]), i / 25.0)
        poses.append(None if M is None else np.asarray(M, np.float64))
        if traced:
            undo()
            errs.append(reloc_error(slam.map, poses, gt, at, i))
    return poses, errs, logs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42])
    ap.add_argument("--device", default="cuda", help="the port's device (the JAX package: CPU)")
    ap.add_argument("--reloc-at", type=int, default=N_FRAMES,
                    help=f"the frame the relocalization is forced on (at most {N_FRAMES})")
    ap.add_argument("--port-features", action="store_true",
                    help="the JAX package on the port's CPU features of every frame")
    args = ap.parse_args()
    dev = torch.device("cpu" if args.package == "jax" else args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu")
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    gt, rig, frames = render(N_FRAMES + N_RELOC, dev)
    for seed in args.seeds:
        slam, ransac_mod, feed = (port_system(rig, seed) if args.package == "port"
                                  else jax_system(rig, seed, frames, args.port_features))
        poses, errs, logs = run(slam, ransac_mod, frames, feed, gt, args.reloc_at)
        tracked = [i for i in range(N_FRAMES) if poses[i] is not None]
        ate = ate_rmse(np.stack([poses[i][:3, 3] for i in tracked]), gt[tracked, :3, 3])
        at = args.reloc_at
        m = slam.map
        kfs = np.asarray(m.kf_frame_id)[np.asarray(m.kf_valid)].tolist()
        name = "jax on the port's features" if args.port_features else args.package
        print(f"{name} seed {seed}: init at frame {tracked[0]}, keyframes {kfs}, ATE "
              f"(Sim3-aligned, {len(tracked)} of frames 0-{N_FRAMES - 1}) {ate:.5f} m; "
              f"relocalization forced on frame {at}: paths "
              f"{slam.tracker.frame_path[at:at + N_RELOC]}, each returned pose's error (m, deg) "
              f"against ground truth's step from frame {at - 1} {errs}", flush=True)
        for j, log in enumerate(logs):
            print(f"  frame {at + j}: {'; '.join(log)}")


if __name__ == "__main__":
    main()
