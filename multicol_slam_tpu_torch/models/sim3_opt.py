"""Sim3 refinement and the essential-graph optimization
(cOptimizerLoopStuff.cpp).

Port of ``multicol_slam_tpu/models/sim3_opt.py``. OptimizeSim3 (:58-264):
one free Sim3 S12 between two keyframes, bidirectional rig-reprojection
residuals over matched landmark pairs, Huber 1.345 * 4, two LM rounds
with an outlier gate between them. OptimizeEssentialGraph (:267-513): a
Sim3 pose graph over all keyframes with residual log(S_ij S_j S_i^-1)
(g2o_MultiCol_sim3_expmap.h:47-111), solved by Gauss-Newton on the
dense (7N)^2 normal equations. Both run once per loop candidate, not per
frame, so their Jacobians come from ``torch.func.jacfwd`` as the JAX
package's come from ``jax.jacfwd``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..ops.camera import world_to_img
from ..ops.geometry import inv_se3
from ..ops.rig import Rig
from ..ops.sim3 import Sim3, sim3_exp, sim3_log

HUBER_SIM3 = 1.345 * 4.0   # stdSim = 4.0 (cOptimizerLoopStuff.cpp:55)
CHI2_GATE = 9.21           # chi2(2 dof, 99%) per direction (cSim3Solver gate)


class Sim3Obs(NamedTuple):
    """Matched landmark pairs for OptimizeSim3 (K rows)."""

    X1: torch.Tensor           # (K, 3) points in keyframe 1's body frame
    X2: torch.Tensor           # (K, 3) in keyframe 2's body frame
    uv1: torch.Tensor          # (K, 2) the pair's observation in keyframe 1
    uv2: torch.Tensor          # (K, 2) in keyframe 2
    cam1: torch.Tensor         # (K,) camera of obs 1
    cam2: torch.Tensor         # (K,)
    inv_sigma2_1: torch.Tensor
    inv_sigma2_2: torch.Tensor
    valid: torch.Tensor


def sim3_residuals(rig: Rig, S: Sim3, obs: Sim3Obs):
    """(uv1 - proj_1(S X2), uv2 - proj_2(S^-1 X1)), each (..., K, 2), for
    hypotheses S batched over leading dims: each side projects through its
    own camera's extrinsics (the reference's VertexSim3Expmap_Multi
    cam_map1/2)."""
    T = inv_se3(rig.M_c)
    c1, c2 = obs.cam1.long(), obs.cam2.long()
    Si = S.inverse()

    def project(Xb, c):
        Xc = torch.einsum("kij,...kj->...ki", T[c, :3, :3], Xb) + T[c, :3, 3]
        return world_to_img(rig.cams.index(c), Xc)

    x1p = S.s[..., None, None] * torch.einsum("...ij,kj->...ki", S.R, obs.X2) + S.t[..., None, :]
    x2p = Si.s[..., None, None] * torch.einsum("...ij,kj->...ki", Si.R, obs.X1) + Si.t[..., None, :]
    return obs.uv1 - project(x1p, c1), obs.uv2 - project(x2p, c2)


def sim3_chi2(rig: Rig, S: Sim3, obs: Sim3Obs):
    """Unweighted squared reprojection error in each direction (..., K)."""
    r1, r2 = sim3_residuals(rig, S, obs)
    return (r1 * r1).sum(-1), (r2 * r2).sum(-1)


def optimize_sim3(rig: Rig, S12_init: Sim3, obs: Sim3Obs, iters: int = 10,
                  huber: float = HUBER_SIM3, fix_scale: bool = False):
    """LM on the 7-dof S12 (x1_body = S12 x2_body) as exp(v) o S12_init:
    ``iters`` steps, chi2 <= 9.21 in both directions, ``iters`` more steps
    on the survivors. Each step solves the Huber-IRLS normal equations
    damped by lam (x0.5 on a gain, x4 otherwise); ``fix_scale`` zeroes the
    scale row and column. Returns (S12, inlier mask, n_inliers)."""
    dt, dev = obs.X1.dtype, obs.X1.device
    eye7 = torch.eye(7, dtype=dt, device=dev)

    def chi2_pair(v7):
        r1, r2 = sim3_residuals(rig, sim3_exp(v7).compose(S12_init), obs)
        return (r1 * r1).sum(-1) * obs.inv_sigma2_1, (r2 * r2).sum(-1) * obs.inv_sigma2_2

    def rho(c):
        e = torch.sqrt(torch.clamp(c, min=1e-12))
        return torch.where(e <= huber, c, 2 * huber * e - huber * huber)

    def cost_of(v7, active):
        c1, c2 = chi2_pair(v7)
        return torch.where(active, rho(c1) + rho(c2), torch.zeros_like(c1)).sum()

    def step(v7, lam, w_valid):
        w1 = torch.sqrt(obs.inv_sigma2_1 * w_valid)
        w2 = torch.sqrt(obs.inv_sigma2_2 * w_valid)

        def flat_res(v):
            # v[None]: forward-mode AD in torch 2.13 gives a 0-dim slice
            # times a Python scalar a float64 tangent; a (1,) slice does not
            r1, r2 = sim3_residuals(rig, sim3_exp(v[None]).compose(S12_init), obs)
            return torch.cat([r1[0] * w1[:, None], r2[0] * w2[:, None]], 0)

        r = flat_res(v7).reshape(-1)
        J = jacfwd(flat_res)(v7).reshape(-1, 7)
        c1, c2 = chi2_pair(v7)
        e = torch.sqrt(torch.clamp(torch.cat([c1, c2], 0), min=1e-12))
        w_h = torch.where(e <= huber, torch.ones_like(e), huber / e).repeat_interleave(2)
        H = J.T @ (J * w_h[:, None])
        g = J.T @ (r * w_h)
        if fix_scale:
            H = H.clone()
            H[6, :] = 0.0
            H[:, 6] = 0.0
            H[6, 6] = 1.0
            g = g.clone()
            g[6] = 0.0
        return v7 - torch.linalg.solve_ex(H + lam * eye7, g)[0]

    def lm_rounds(v7, active, n):
        w_valid = active.to(dt)
        lam = torch.full((), 1e-4, dtype=dt, device=dev)
        cost = cost_of(v7, active)
        for _ in range(n):
            v_new = step(v7, lam, w_valid)
            cost_new = cost_of(v_new, active)
            accept = cost_new < cost
            v7 = torch.where(accept, v_new, v7)
            cost = torch.where(accept, cost_new, cost)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
        return v7

    # round 1, outlier gate, round 2 (cOptimizerLoopStuff.cpp:208-246)
    v7 = lm_rounds(torch.zeros(7, dtype=dt, device=dev), obs.valid, iters)
    c1, c2 = chi2_pair(v7)
    v7 = lm_rounds(v7, obs.valid & (c1 <= CHI2_GATE) & (c2 <= CHI2_GATE), iters)
    c1, c2 = chi2_pair(v7)
    inlier = obs.valid & (c1 <= CHI2_GATE) & (c2 <= CHI2_GATE)
    return sim3_exp(v7).compose(S12_init), inlier, inlier.sum()


class EssentialGraph(NamedTuple):
    """Pose-graph problem over N keyframes (padded edges)."""

    edge_i: torch.Tensor   # (E,) int
    edge_j: torch.Tensor   # (E,)
    meas: torch.Tensor     # (E, 7) sim3_log of S_meas_ij = S_i S_j^-1 at build
    valid: torch.Tensor    # (E,) bool
    fixed: torch.Tensor    # (N,) bool


def _edge_residual(vi, vj, m):
    # (1, 7) operands: see optimize_sim3's flat_res on 0-dim tangents
    vi, vj, m = vi[None], vj[None], m[None]
    return sim3_log(sim3_exp(m).compose(sim3_exp(vj)).compose(sim3_exp(vi).inverse()))[0]


_edge_jacobians = vmap(jacfwd(_edge_residual, argnums=(0, 1)))


def optimize_essential_graph(S0_log: torch.Tensor, graph: EssentialGraph,
                             iters: int = 20, fix_scale: bool = False) -> torch.Tensor:
    """Gauss-Newton on the Sim3 pose graph. S0_log: (N, 7) sim3_log of
    each keyframe's world-to-keyframe Sim3. The residual of edge (i, j) is
    log(S_meas_ij o S_j o S_i^-1); each step solves the dense (7N)^2
    normal equations damped by 1e-6, with fixed vertices (and, under
    ``fix_scale``, every vertex's scale) held by identity rows, and
    subtracts the step from the logs. Returns the (N, 7) optimized logs.

    ``fix_scale`` is the reference vertex's scale gate
    (g2o_MultiCol_sim3_expmap.h:63-66), which it defines but never enables;
    a metric rig observes scale, and a free one lets a loop discrepancy
    become a scale ramp around the cycle."""
    N = S0_log.shape[0]
    dt, dev = S0_log.dtype, S0_log.device
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    w = graph.valid.to(dt)
    fixed7 = graph.fixed.repeat_interleave(7)
    if fix_scale:
        fixed7 = fixed7 | (torch.arange(7 * N, device=dev) % 7 == 6)
    eye = torch.eye(7 * N, dtype=dt, device=dev)
    hold = fixed7[:, None] | fixed7[None, :]
    logs = S0_log
    for _ in range(iters):
        r = vmap(_edge_residual)(logs[ei], logs[ej], graph.meas) * w[:, None]
        Ji, Jj = _edge_jacobians(logs[ei], logs[ej], graph.meas)
        Ji = Ji * w[:, None, None]
        Jj = Jj * w[:, None, None]
        H = torch.zeros((N * N, 7, 7), dtype=dt, device=dev)
        H.index_add_(0, ei * N + ei, torch.einsum("eri,erj->eij", Ji, Ji))
        H.index_add_(0, ej * N + ej, torch.einsum("eri,erj->eij", Jj, Jj))
        Hij = torch.einsum("eri,erj->eij", Ji, Jj)
        H.index_add_(0, ei * N + ej, Hij)
        H.index_add_(0, ej * N + ei, Hij.transpose(-1, -2))
        g = torch.zeros((N, 7), dtype=dt, device=dev)
        g.index_add_(0, ei, torch.einsum("eri,er->ei", Ji, r))
        g.index_add_(0, ej, torch.einsum("eri,er->ei", Jj, r))
        Hmat = H.reshape(N, N, 7, 7).permute(0, 2, 1, 3).reshape(7 * N, 7 * N)
        Hmat = torch.where(hold, eye, Hmat + 1e-6 * eye)
        gvec = torch.where(fixed7, torch.zeros_like(fixed7, dtype=dt), g.reshape(7 * N))
        logs = logs - torch.linalg.solve_ex(Hmat, gvec)[0].reshape(N, 7)
    return logs
