#!/usr/bin/env python3
"""The self-calibrating BA, ``refine_intrinsics`` and the sharded BA on the
card, the parent tree's eager functions against the change's graphs, in
turns in one process.

    python3 tools/ba_graph_study.py --write-parent HEAD~1   # in a git checkout
    python3 tools/ba_graph_study.py                         # on one H100

``--write-parent REV`` unpacks the package of git revision REV under
``kernels/build/study/parent/`` (ignored by git, copied by a chip run).
Without it the study imports that package a second time, under the name
``parent_tree``, beside this tree's, and on the same inputs:

- the sharded BA at map scale (``chip_smoke.py`` phase 13 (c): the JAX
  package's dry run, ``make_ba_problem(rig, 64, 8192, max_obs_per_pt=8)``
  in float32, ``MAP_ITERS`` iterations): at D = 1, 2, 4, 8 shards of the
  one card, the parent's ``make_sharded_ba`` (eager) and the change's
  (graphed), each run once to warm, then timed in turns parent, change,
  change, parent; ms an iteration. Beside them the single path: the
  parent's eager ``bundle_adjustment`` and the change's graph of it
  (``graphs.jit``, as the system's global BA runs it);
- self-calibration on the ring (``chip_smoke.py`` phase 12 (b)): the ring
  system over ``ring_tour()``, its map assembled, cameras 1-7 perturbed;
  ``self_calibrating_bundle_adjustment`` (two keyframes fixed, and one)
  and ``refine_intrinsics``, the parent's eager call and the change's
  graph, each a cold call (the graph's warm-up and capture), then warm
  calls in turns; whether two calls of each end at the same outputs (with
  one keyframe fixed the scale is free, and the parent sums with atomics).

Every number beside the card's name and power limit; the last line is
one JSON object.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, ROOT)
STUDY_DIR = os.path.join(ROOT, "multicol_slam_tpu_torch", "kernels", "build", "study")
PARENT_TREE = os.path.join(STUDY_DIR, "parent")
SHARDS = (1, 2, 4, 8)
TURNS = ("parent", "change", "change", "parent")


def card() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()


def write_parent(rev: str) -> None:
    """The package at git revision rev, unpacked into PARENT_TREE."""
    import shutil

    shutil.rmtree(PARENT_TREE, ignore_errors=True)
    os.makedirs(PARENT_TREE)
    archive = subprocess.run(["git", "-C", ROOT, "archive", rev, "multicol_slam_tpu_torch"],
                             capture_output=True, check=True).stdout
    subprocess.run(["tar", "-x", "-C", PARENT_TREE], input=archive, check=True)
    print(f"wrote {os.path.relpath(PARENT_TREE, ROOT)} from {rev}")


def parent_module(name: str):
    """``multicol_slam_tpu_torch.<name>`` of the parent tree, imported as
    ``parent_tree.<name>``."""
    if "parent_tree" not in sys.modules:
        pkg = os.path.join(PARENT_TREE, "multicol_slam_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            "parent_tree", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
        mod = importlib.util.module_from_spec(spec)
        sys.modules["parent_tree"] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"parent_tree.{name}")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def same(a, b) -> bool:
    import chip_smoke
    return chip_smoke.identical(a, b)


def in_turns(runs: dict) -> dict:
    """label -> [ms of each turn]: runs["parent"] and runs["change"]
    called in the order of TURNS."""
    ms = {k: [] for k in runs}
    for label in TURNS:
        ms[label].append(round(timed(runs[label])[1], 3))
    return ms


def sharded_study(dev, name) -> dict:
    """The map-scale problem of phase 13 (c), parent against change."""
    import chip_smoke
    from multicol_slam_tpu_torch.models import optimizer as opt
    from multicol_slam_tpu_torch.parallel import ba_sharding as bs
    from multicol_slam_tpu_torch.utils import config_io, graphs, synthetic

    p_opt = parent_module("models.optimizer")
    p_bs = parent_module("parallel.ba_sharding")
    rig = config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0].to(dev)
    nk, npt, iters = chip_smoke.MAP_KF, chip_smoke.MAP_PT, chip_smoke.MAP_ITERS
    mt_true, X_true, uv, kf, cam, pt, valid, pt_obs = synthetic.make_ba_problem(
        rig, nk, npt, max_obs_per_pt=chip_smoke.MAP_OBS)
    on = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)
    obs = opt.BAObservations(uv=on(uv, torch.float32), kf=on(kf), cam=on(cam), pt=on(pt),
                             inv_sigma2=torch.ones(len(kf), device=dev), valid=on(valid))
    rng = np.random.default_rng(1)
    mt0 = mt_true + rng.standard_normal(mt_true.shape) * 0.002
    mt0[0] = mt_true[0]
    X0 = X_true + rng.standard_normal(X_true.shape) * 0.01
    fixed_kf = torch.arange(nk, device=dev) == 0
    fixed_pt = torch.zeros(npt, dtype=torch.bool, device=dev)
    mt0, X0, pt_obs = on(mt0, torch.float32), on(X0, torch.float32), on(pt_obs)
    problem = opt.BAProblem(obs, pt_obs, fixed_kf, fixed_pt)
    out = {}
    single = graphs.jit(opt.bundle_adjustment)
    runs = {"parent": lambda: p_opt.bundle_adjustment(rig, mt0, X0, problem, iters=iters),
            "change": lambda: single(rig, mt0, X0, problem, iters=iters)}
    first = {k: timed(f) for k, f in runs.items()}
    ms = in_turns(runs)
    out["single"] = dict(cold_ms=[round(first[k][1], 3) for k in ("parent", "change")],
                         ms_per_iteration={k: [round(t / iters, 3) for t in v]
                                           for k, v in ms.items()},
                         identical=same(first["parent"][0], first["change"][0]))
    print(f"map-scale BA {nk} x {npt}, {iters} iterations, the single path: ms an iteration "
          f"in turns {out['single']['ms_per_iteration']} (parent eager, change graphed); "
          f"outputs identical {out['single']['identical']} ({name})")
    for D in SHARDS:
        devs = [dev] * D
        sh = bs.shard_obs(bs.pad_obs_to_multiple(obs, D), devs)
        p_ba = p_bs.make_sharded_ba(devs, rig, nk, npt, iters=iters)
        c_ba = bs.make_sharded_ba(devs, rig, nk, npt, iters=iters)
        args = (mt0, X0, sh, pt_obs, fixed_kf, fixed_pt)
        runs = {"parent": lambda: p_ba(*args), "change": lambda: c_ba(*args)}
        first = {k: timed(f) for k, f in runs.items()}
        ms = in_turns(runs)
        out[f"D={D}"] = dict(cold_ms=[round(first[k][1], 3) for k in ("parent", "change")],
                             ms_per_iteration={k: [round(t / iters, 3) for t in v]
                                               for k, v in ms.items()},
                             identical=same(first["parent"][0], first["change"][0]))
        print(f"map-scale BA, D={D} on one card: ms an iteration in turns "
              f"{out[f'D={D}']['ms_per_iteration']} (parent eager, change graphed), first "
              f"calls {out[f'D={D}']['cold_ms']} ms; outputs identical "
              f"{out[f'D={D}']['identical']} ({name})")
    return out


def ring_problem(dev):
    """(ring, the perturbed rig, the problem with two keyframes fixed and
    with one, mt0, X0): phase 12 (a)'s system over ring_tour(), its map."""
    import chip_smoke
    from multicol_slam_tpu_torch.models.local_mapping import assemble_ba_problem
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.ops.rig import rig_from_cayley
    from multicol_slam_tpu_torch.utils import config_io, synthetic

    ring = chip_smoke.ring_rig(dev)
    settings = config_io.SlamSettings(**chip_smoke.RING_SETTINGS)
    slam = MultiColSLAM(rig=ring, settings=settings, capacity_pts=20000, capacity_kfs=64,
                        enable_loop_closing=False)
    gt = chip_smoke.ring_tour()
    render = synthetic.make_renderer(ring, room_half=chip_smoke.RING_ROOM_HALF)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev)))
    frames = frames.to(torch.uint8)
    for i in range(len(gt)):
        slam.track(frames[i], i / settings.fps)
    m = slam.map
    kfs = sorted(int(k) for k in m.keyframe_ids())
    problems = []
    for n_fixed in (chip_smoke.SELFCAL_FIXED_KFS, 1):
        fixed = np.arange(len(kfs)) < n_fixed
        problem, mt0, X0, _, _ = assemble_ba_problem(m, kfs, fixed, settings.scale_factor,
                                                     device=dev)
        problems.append(problem)
    off = torch.tensor([chip_smoke.SELFCAL_OFFSET[c % 2] for c in range(chip_smoke.RING_CAMS)],
                       dtype=torch.float32, device=dev)
    off[0] = 0.0
    return (ring, rig_from_cayley(ring.M_c_min + off, ring.cams), problems,
            torch.from_numpy(mt0).to(dev), torch.from_numpy(X0).to(dev), len(kfs))


def selfcal_study(dev, name) -> dict:
    """Phase 12 (b)'s calls, the parent's eager functions against the
    change's graphs."""
    import chip_smoke
    from multicol_slam_tpu_torch.models import optimizer as opt
    from multicol_slam_tpu_torch.ops.rig import Rig

    p_opt = parent_module("models.optimizer")
    ring, rig_pert, (problem, problem1), mt0, X0, n_kf = ring_problem(dev)
    v = ring.cams.to_vector17().clone()
    v[:, 3] += 1.5
    v[:, 4] -= 1.0
    rig_i = Rig(M_c=ring.M_c, cams=ring.cams.with_vector17(v))
    it, it_i = chip_smoke.SELFCAL_ITERS, chip_smoke.INTRINSICS_ITERS
    cases = {
        "self_calibrating_bundle_adjustment": (
            "self_calibrating_bundle_adjustment", (rig_pert, mt0, X0, problem), dict(iters=it)),
        "the same, one keyframe fixed": (
            "self_calibrating_bundle_adjustment", (rig_pert, mt0, X0, problem1),
            dict(iters=it)),
        "refine_intrinsics": ("refine_intrinsics", (rig_i, mt0, X0, problem.obs),
                              dict(iters=it_i))}
    out = {}
    print(f"ring map: {n_kf} keyframes, {int(problem.obs.valid.sum())} observations ({name})")
    for label, (fn, a, k) in cases.items():
        runs = {"parent": lambda: getattr(p_opt, fn)(*a, **k),
                "change": lambda: getattr(opt, fn)(*a, **k)}
        first = {key: timed(f) for key, f in runs.items()}
        second = {key: timed(f)[0] for key, f in runs.items()}
        ms = in_turns(runs)
        out[label] = dict(
            cold_ms={key: round(first[key][1], 3) for key in runs}, warm_ms=ms,
            two_calls_identical={key: same(first[key][0], second[key]) for key in runs},
            parent_equals_change=same(first["parent"][0], first["change"][0]))
        print(f"{label}: cold ms {out[label]['cold_ms']} (parent eager, change graphed: its "
              f"warm-up and capture), warm ms in turns {ms}; two calls identical "
              f"{out[label]['two_calls_identical']}; the parent's first call identical to the "
              f"change's {out[label]['parent_equals_change']} ({name})")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write-parent", metavar="REV")
    args = ap.parse_args(argv)
    if args.write_parent:
        write_parent(args.write_parent)
        return
    if not torch.cuda.is_available():
        raise SystemExit("ba_graph_study: no CUDA device")
    if not os.path.isdir(PARENT_TREE):
        raise SystemExit("ba_graph_study: no parent tree; run `python3 tools/ba_graph_study.py "
                         "--write-parent HEAD~1` in a git checkout")
    dev = torch.device("cuda", 0)
    name = card()
    print(name)
    result = dict(card=name, sharded=sharded_study(dev, name),
                  selfcal=selfcal_study(dev, name))
    print(name)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
