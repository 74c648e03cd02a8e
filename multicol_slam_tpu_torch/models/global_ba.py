"""Global bundle adjustment (cOptimizer::GlobalBundleAdjustment,
cOptimizer.cpp:57-257): joint LM over every keyframe pose and point with
a caller-chosen gauge.

Port of ``multicol_slam_tpu/models/global_ba.py`` on one device: the
system's ``global_bundle_adjustment`` and the loop closer's post-loop BA
both call ``run_global_ba``, which assembles the problem from the map and
runs the Schur adjuster of ``optimizer.bundle_adjustment``. The JAX
package's sharded branch (an observation table split over a device mesh)
waits for multi-device BA (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..ops.rig import Rig
from . import optimizer as opt
from .local_mapping import assemble_ba_problem
from .tracking import fetch, to_device


def run_global_ba(rig: Rig, m, fixed_ids: Sequence[int], scale_factor: float, *,
                  iters: int = 10, huber: Optional[float] = None) -> float:
    """Assemble and solve the full-map BA on the rig's device and write
    the result back into the MapStore. ``fixed_ids``: keyframes held as
    the gauge (the reference fixes KF0, cOptimizer.cpp:96-99; the loop
    closer fixes the loop keyframe); the lowest id if none of them exists.
    Returns the final chi2 summed over the valid observations (the JAX
    package calls it the robust cost; the Huber weighting is not in it),
    -1.0 for a degenerate problem."""
    if huber is None:
        huber = opt.HUBER_GLOBAL
    kfs = [int(k) for k in m.keyframe_ids().tolist()]
    if len(kfs) < 2:
        return -1.0
    fixed_set = set(int(k) for k in fixed_ids)
    fixed_mask = np.asarray([k in fixed_set for k in kfs])
    if not fixed_mask.any():
        fixed_mask[int(np.argmin(kfs))] = True
    dev = rig.M_c.device
    built = assemble_ba_problem(m, kfs, fixed_mask, scale_factor, device=dev)
    if built is None:
        return -1.0
    problem, mt0, X0, pts, _ = built
    mt, X, chi2, valid = fetch(*opt.bundle_adjustment(
        rig, to_device(mt0, dev), to_device(X0, dev), problem, huber=huber,
        iters=iters), problem.obs.valid)
    for i, k in enumerate(kfs):
        if not fixed_mask[i]:
            m.kf_pose[k] = mt[i]
    m.pt_pos[pts] = X[:len(pts)].astype(np.float32)
    return float(chi2[valid].sum())
