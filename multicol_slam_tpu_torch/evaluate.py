"""Score a saved TUM trajectory against ground truth: ATE and RPE. The
port's counterpart of the JAX package's ``tools/evaluate_trajectory.py``,
with the same JSON keys.

The reference writes TUM trajectories (cSystem::SaveMKFTrajectoryLAFIDA,
cSystem.cpp:260-290) and leaves their evaluation to the TUM benchmark's
scripts; this makes the same evaluation:

  1. associate the estimate's and the ground truth's rows by nearest
     timestamp (at most --max-diff apart, each used once);
  2. ATE: RMSE of the positions after Umeyama alignment (Sim3 by
     default; --no-scale for SE3);
  3. RPE: the relative-pose drift over --rpe-delta frames (translation
     RMSE, rotation RMSE in degrees), free of the global alignment.

    python -m multicol_slam_tpu_torch.evaluate est.txt gt.txt [--max-diff 0.02]
        [--rpe-delta 1] [--no-scale]

Prints one JSON line. Host numpy only: no device is used.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .utils import trajectory as tj


def evaluate(est_path: str, gt_path: str, max_diff: float = 0.02, rpe_delta: int = 1,
             with_scale: bool = True) -> dict:
    """The scores of a TUM trajectory against ground truth; raises
    ValueError below 3 associated rows."""
    t_e, p_e, q_e = tj.load_tum(est_path)
    t_g, p_g, q_g = tj.load_tum(gt_path)
    pairs = tj.associate(t_e, t_g, max_diff=max_diff)
    if len(pairs) < 3:
        raise ValueError(f"only {len(pairs)} associated pairs (need >= 3; try --max-diff)")
    ie = np.array([a for a, _ in pairs])
    ig = np.array([b for _, b in pairs])
    ate = tj.ate_rmse(p_e[ie], p_g[ig], with_scale=with_scale)
    rpe_t, rpe_deg = tj.rpe(tj.tum_to_matrices(p_e[ie], q_e[ie]),
                            tj.tum_to_matrices(p_g[ig], q_g[ig]), delta=rpe_delta)
    return dict(n_est=len(t_e), n_gt=len(t_g), n_associated=len(pairs),
                ate_rmse_m=round(ate, 5), rpe_trans_rmse_m=round(rpe_t, 5),
                rpe_rot_rmse_deg=round(rpe_deg, 4), rpe_delta=rpe_delta,
                alignment="sim3" if with_scale else "se3")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m multicol_slam_tpu_torch.evaluate",
                                 description="ATE and RPE of a TUM trajectory.")
    ap.add_argument("est", help="estimated trajectory (TUM format)")
    ap.add_argument("gt", help="ground-truth trajectory (TUM format)")
    ap.add_argument("--max-diff", type=float, default=0.02,
                    help="largest timestamp gap of an association (s)")
    ap.add_argument("--rpe-delta", type=int, default=1,
                    help="frame delta of the relative pose error")
    ap.add_argument("--no-scale", action="store_true", help="SE3 (no scale) ATE alignment")
    args = ap.parse_args(argv)
    try:
        rec = evaluate(args.est, args.gt, args.max_diff, args.rpe_delta, not args.no_scale)
    except ValueError as exc:
        ap.exit(1, f"{exc}\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
