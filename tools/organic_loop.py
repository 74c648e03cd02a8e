#!/usr/bin/env python3
"""The organic loop-closure episode in the baffle world, in either package.

    python3 tools/organic_loop.py                               # the port, on the card
    python3 tools/organic_loop.py --device cpu --frames 40      # the port, on the CPU
    python3 tools/organic_loop.py --package jax                 # the JAX package, CPU
    python3 tools/organic_loop.py --package jax --seeds 3 --save-fixture tests/data/organic_loop_jax_map.npz
    python3 tools/organic_loop.py --seeds 42 1 2 3 4 5 6 7      # a seed sweep

The episode is ``multicol_slam_tpu_torch/utils/episode.py``'s (the
baffle world and tour, dead reckoning at ``episode.DRIFT``, loop closing
on); the JAX package's system is fed the port's renders, so both
packages see the same pixels. Each frame prints its state, keyframes,
points, ``last_loop_kf`` and wall ms, and each ComputeSim3 attempt its
BoW pairs and verdict. At the end each seed prints the fired pair and
the frames it spans, the pair's relative-pose error against ground truth
before and after the correction, the keyframe ATE before and after, the
WORKING share after initialization, the count and ms of each ComputeSim3
(``_compute_sim3_and_correct`` less its correction) and CorrectLoop
call, whether the bars of tests/test_organic_loop.py:296-352 are met and
whether the loop was repaired (``episode.summary``), and the wall time,
then one JSON line of it all.

A seed sets the tracker's generator (JAX: its PRNG key) and the loop
closer's; seed 42 is the systems' defaults (tracker 42, loop closer 7).
``--save-fixture PATH`` (JAX only) writes the JAX map with the JAX
package's ``checkpoint.save_map``, its pools trimmed to the live rows,
as it stood just before the ``insert_keyframe`` call whose detection led
to the wide correction; ``extra`` holds what the loop closer needs to
replay that call (tests/test_torch_organic_loop.py). The port on the
card is the default; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multicol_slam_tpu_torch.utils import config_io, episode  # noqa: E402


def jax_system(seed):
    """As ``episode.port_system``: the JAX package's MultiColSLAM at the
    episode's settings, in float32 on the CPU, fed the port's CPU renders."""
    import jax
    import jax.numpy as jnp
    from multicol_slam_tpu.models import system as jsys
    from multicol_slam_tpu.utils import config_io as jcio

    jax.config.update("jax_enable_x64", False)
    rig = jcio.load_mcs(config_io.SYNTH_RIG_DIR, dtype=np.float32)[0]
    slam = jsys.MultiColSLAM(rig=jax.tree.map(jnp.asarray, rig),
                             settings=jcio.SlamSettings(**episode.SETTINGS),
                             enable_loop_closing=True, **episode.CAPACITY)
    slam.tracker.key = jax.random.PRNGKey(seed)
    gt, frame = episode.make_frames(config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0])
    seed_closer = None if seed == 42 else (
        lambda lc: setattr(lc, "key", jax.random.PRNGKey(seed)))
    return slam, gt, (lambda t: jnp.asarray(frame(t).numpy())), seed_closer, (lambda: None)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default=None, help="the port's device (default: the card)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42])
    ap.add_argument("--frames", type=int, default=episode.N_FRAMES)
    ap.add_argument("--drift-step", type=float, default=episode.DRIFT["drift_step"])
    ap.add_argument("--yaw-step", type=float, default=episode.DRIFT["yaw_step"])
    ap.add_argument("--yaw-pulse", type=float, default=episode.DRIFT["yaw_pulse"])
    ap.add_argument("--pulse-frames", type=int, nargs=2,
                    default=episode.DRIFT["pulse_frames"])
    ap.add_argument("--save-fixture", default=None, help="JAX only: write the replay fixture")
    args = ap.parse_args()
    if args.save_fixture and args.package != "jax":
        ap.error("--save-fixture writes the JAX package's map: use --package jax")
    drift = dict(drift_step=args.drift_step, yaw_step=args.yaw_step,
                 yaw_pulse=args.yaw_pulse, pulse_frames=tuple(args.pulse_frames))
    save_map = None
    if args.package == "jax":
        from multicol_slam_tpu.utils.checkpoint import save_map
    results = {}
    for seed in args.seeds:
        if args.package == "jax":
            slam, gt, frame, seed_closer, sync = jax_system(seed)
        else:
            slam, gt, frame, seed_closer, sync = episode.port_system(args.device or "cuda",
                                                                     seed)
        res = episode.run_episode(slam, frame, gt, drift=drift, save_map=save_map,
                                  fixture=args.save_fixture, seed_closer=seed_closer,
                                  sync=sync, n_frames=args.frames)
        results[seed] = res
        print(episode.describe(seed, res), flush=True)
    ok = [s for s, r in results.items() if r["ok"]]
    repaired = [s for s, r in results.items() if r["repaired"]]
    print(f"{args.package}: {len(ok)} of {len(results)} seeds fired a wide loop and met "
          f"the bars: {ok}; {len(repaired)} repaired it: {repaired}; drift {drift}")
    print(json.dumps({"package": args.package, "drift": drift,
                      "results": {str(s): r for s, r in results.items()}}))


if __name__ == "__main__":
    main()
