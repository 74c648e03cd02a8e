"""Global bundle adjustment (cOptimizer::GlobalBundleAdjustment,
cOptimizer.cpp:57-257): joint LM over every keyframe pose and point with
a caller-chosen gauge.

Port of ``multicol_slam_tpu/models/global_ba.py``: the system's
``global_bundle_adjustment`` and the loop closer's post-loop BA both call
``run_global_ba``, which assembles the problem from the map and routes it
as the JAX package does: with more than one device in the mesh the
observation table is sharded over it (``parallel/ba_sharding.py``), else
the Schur adjuster of ``optimizer.bundle_adjustment`` runs on the rig's
device. The default mesh is the JAX package's ``jax.devices()``: every
visible card for a rig on a card, the rig's one device otherwise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.rig import Rig
from ..parallel import ba_sharding
from . import optimizer as opt
from .local_mapping import assemble_ba_problem
from .tracking import fetch, to_device


def default_mesh(rig: Rig) -> list[torch.device]:
    """The devices a full-map BA shards over by default: every visible
    CUDA device for a rig on one, else the rig's own device."""
    dev = rig.M_c.device
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def run_global_ba(rig: Rig, m, fixed_ids: Sequence[int], scale_factor: float, *,
                  iters: int = 10, huber: Optional[float] = None,
                  devices: Optional[Sequence] = None) -> float:
    """Assemble and solve the full-map BA and write the result back into
    the MapStore. ``fixed_ids``: keyframes held as the gauge (the
    reference fixes KF0, cOptimizer.cpp:96-99; the loop closer fixes the
    loop keyframe); the lowest id if none of them exists. ``devices``: the
    mesh (``default_mesh(rig)`` if None); with more than one device the
    observations are sharded over it and the reduced system is solved on
    the first. Returns the final chi2 summed over the valid observations, from
    either branch (the JAX package returns the robust cost from its
    sharded branch and this sum from the other; the Huber weighting is
    not in it), -1.0 for a degenerate problem."""
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
    mesh = ba_sharding.mesh_devices(default_mesh(rig) if devices is None else devices)
    if len(mesh) > 1:
        obs = ba_sharding.pad_obs_to_multiple(problem.obs, len(mesh))
        ba = ba_sharding.make_sharded_ba(mesh, rig, mt0.shape[0], X0.shape[0],
                                         iters=iters, huber=huber)
        mt_t, X_t, _ = ba(to_device(mt0, mesh[0]), to_device(X0, mesh[0]),
                          ba_sharding.shard_obs(obs, mesh), problem.pt_obs,
                          problem.fixed_kf, problem.fixed_pt)
        # the chi2 after the LM, as bundle_adjustment computes it
        mt_t, X_t = mt_t.to(dev), X_t.to(dev)
        _, cost_of = opt.make_ba_blocks(rig, problem.obs, problem.fixed_kf,
                                        problem.fixed_pt, mt_t.shape[0], X_t.shape[0], huber)
        chi2_t = cost_of(mt_t, X_t)[1]
    else:
        mt_t, X_t, chi2_t = opt.bundle_adjustment(
            rig, to_device(mt0, dev), to_device(X0, dev), problem, huber=huber,
            iters=iters)
    mt, X, chi2, valid = fetch(mt_t, X_t, chi2_t, problem.obs.valid)
    for i, k in enumerate(kfs):
        if not fixed_mask[i]:
            m.kf_pose[k] = mt[i]
    m.pt_pos[pts] = X[:len(pts)].astype(np.float32)
    return float(chi2[valid].sum())
