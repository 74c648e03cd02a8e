"""Sim3 refinement and the essential-graph optimization
(cOptimizerLoopStuff.cpp).

Port of ``multicol_slam_tpu/models/sim3_opt.py``. OptimizeSim3 (:58-264):
one free Sim3 S12 between two keyframes, bidirectional rig-reprojection
residuals over matched landmark pairs, Huber 1.345 * 4, two LM rounds
with an outlier gate between them. OptimizeEssentialGraph (:267-513): a
Sim3 pose graph over all keyframes with residual log(S_ij S_j S_i^-1)
(g2o_MultiCol_sim3_expmap.h:47-111), solved by Gauss-Newton on the
dense (7N)^2 normal equations.

The JAX package differentiates both residuals with ``jax.jacfwd``; here
the Jacobians are written out (``sim3_linearize``, ``edge_linearize``)
from the tangents of ``ops/sim3.py``'s ``*_jvp`` functions and the rig
projection's Jacobian (``optimizer._projection_jacobian``), the same
derivative forward-mode autodiff takes, branch by branch. OptimizeSim3's
iterate is a log v7 against ``S12_init``, so the Jacobian is that of
``sim3_exp`` at v7, not at zero. The essential graph sums its blocks
through ``optimizer.RowSum``: in row order on the CPU and on CUDA alike,
so a CUDA graph's replay equals its eager call. Both functions read no
device tensor on the host, so the loop closer runs them as CUDA graphs
on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.camera import world_to_img
from ..ops.geometry import inv_se3
from ..ops.rig import Rig
from ..ops.sim3 import Sim3, compose_jvp, inverse_jvp, sim3_exp, sim3_exp_jvp, sim3_log_jvp
from .optimizer import RowSum, _projection_jacobian

HUBER_SIM3 = 1.345 * 4.0   # stdSim = 4.0 (cOptimizerLoopStuff.cpp:55)
CHI2_GATE = 9.21           # chi2(2 dof, 99%) per direction (cSim3Solver gate)


class Sim3Obs(NamedTuple):
    """Matched landmark pairs for OptimizeSim3 (K rows; rows with ``valid``
    False weigh nothing)."""

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


def sim3_linearize(rig: Rig, v7: torch.Tensor, S12_init: Sim3, obs: Sim3Obs):
    """``sim3_residuals`` at S = exp(v7) o S12_init (the same values) and
    their Jacobians d r / d v7: ((r1, r2) (K, 2) each, (J1, J2) (K, 2, 7)
    each). Each side's point through S (or S^-1) takes the Sim3's
    tangent, then its camera's extrinsics and the projection's Jacobian."""
    dt, dev = v7.dtype, v7.device
    E, dE = sim3_exp_jvp(v7, torch.eye(7, dtype=dt, device=dev))
    S, dS = compose_jvp(E, dE, S12_init, None)
    Si, dSi = inverse_jvp(S, dS)
    T = inv_se3(rig.M_c)
    c1, c2 = obs.cam1.long(), obs.cam2.long()

    def through(S, dS, X, c, uv):
        # s R X + t and its tangent (K, 7, 3), then the camera frame and
        # the projection
        RX = torch.einsum("ij,kj->ki", S.R, X)
        dx = (dS.s[None, :, None] * RX[:, None, :]
              + S.s * torch.einsum("mij,kj->kmi", dS.R, X) + dS.t[None])
        Tc, cam = T[c], rig.cams.index(c)
        Xc = torch.einsum("kij,kj->ki", Tc[:, :3, :3], S.s * RX + S.t) + Tc[:, :3, 3]
        dXc = torch.einsum("kij,kmj->kmi", Tc[:, :3, :3], dx)
        return (uv - world_to_img(cam, Xc),
                -torch.einsum("kai,kmi->kam", _projection_jacobian(cam, Xc), dXc))

    (r1, J1), (r2, J2) = (through(S, dS, obs.X2, c1, obs.uv1),
                          through(Si, dSi, obs.X1, c2, obs.uv2))
    return (r1, r2), (J1, J2)


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
    free = torch.arange(7, device=dev) != 6

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
        (r1, r2), (J1, J2) = sim3_linearize(rig, v7, S12_init, obs)
        r = torch.cat([r1 * w1[:, None], r2 * w2[:, None]], 0).reshape(-1)
        J = torch.cat([J1 * w1[:, None, None], J2 * w2[:, None, None]], 0).reshape(-1, 7)
        c1 = (r1 * r1).sum(-1) * obs.inv_sigma2_1
        c2 = (r2 * r2).sum(-1) * obs.inv_sigma2_2
        e = torch.sqrt(torch.clamp(torch.cat([c1, c2], 0), min=1e-12))
        w_h = torch.where(e <= huber, torch.ones_like(e), huber / e).repeat_interleave(2)
        H = J.T @ (J * w_h[:, None])
        g = J.T @ (r * w_h)
        if fix_scale:
            # the scale's row and column of the identity, its gradient 0
            # (selected, not set: a graph cannot copy a host scalar)
            H = torch.where(free[:, None] & free[None, :], H, eye7)
            g = torch.where(free, g, torch.zeros_like(g))
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


def edge_linearize(logs: torch.Tensor, ei: torch.Tensor, ej: torch.Tensor, M: Sim3):
    """The edges' residuals r = log(M o exp(v_j) o exp(v_i)^-1) (E, 7)
    over vertex logs (N, 7), edge ends ei, ej (E,) and measurements M =
    sim3_exp(meas) (E), and d r / d v_i and d r / d v_j (E, 7, 7): each
    vertex's exp and its inverse with their 7 tangents once, gathered to
    the edges' ends as one set of 14 directions (the first 7 v_i's, the
    last 7 v_j's), then both compositions and the log. Returns (r, Ji,
    Jj)."""
    N, dt, dev = logs.shape[0], logs.dtype, logs.device
    V, dV = sim3_exp_jvp(logs, torch.eye(7, dtype=dt, device=dev).expand(N, 7, 7))
    Vi, dVi = inverse_jvp(V, dV)

    def ends(S, dS, idx, first):
        # the Sim3s at idx, their tangents in the first or last 7 of 14
        def place(d):
            d, z = d[idx], torch.zeros_like(d[idx])
            return torch.cat([d, z] if first else [z, d], 1)
        return Sim3(S.s[idx], S.R[idx], S.t[idx]), Sim3(place(dS.s), place(dS.R), place(dS.t))

    X, dX = compose_jvp(M, None, *ends(V, dV, ej, False))
    r, dr = sim3_log_jvp(*compose_jvp(X, dX, *ends(Vi, dVi, ei, True)))
    return r, dr[:, :7].transpose(-1, -2), dr[:, 7:].transpose(-1, -2)


def optimize_essential_graph(S0_log: torch.Tensor, graph: EssentialGraph,
                             iters: int = 20, fix_scale: bool = False) -> torch.Tensor:
    """Gauss-Newton on the Sim3 pose graph. S0_log: (N, 7) sim3_log of
    each keyframe's world-to-keyframe Sim3. The residual of edge (i, j) is
    log(S_meas_ij o S_j o S_i^-1); each step solves the dense (7N)^2
    normal equations damped by 1e-6, with fixed vertices (and, under
    ``fix_scale``, every vertex's scale) held by identity rows, and
    subtracts the step from the logs. Returns the (N, 7) optimized logs.
    Padded edges (``valid`` False) add exact zeros; the blocks are summed
    per target in edge order (``RowSum``).

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
    # the four blocks of each edge, then its two gradients, in this order
    live = graph.valid
    by_block = RowSum(torch.cat([ei * N + ei, ej * N + ej, ei * N + ej, ej * N + ei]), N * N,
                      torch.cat([live] * 4))
    by_vertex = RowSum(torch.cat([ei, ej]), N, torch.cat([live] * 2))
    M = sim3_exp(graph.meas)
    logs = S0_log
    for _ in range(iters):
        r, Ji, Jj = edge_linearize(logs, ei, ej, M)
        r = r * w[:, None]
        Ji = Ji * w[:, None, None]
        Jj = Jj * w[:, None, None]
        Hij = torch.einsum("eri,erj->eij", Ji, Jj)
        H = by_block.sum(torch.cat([torch.einsum("eri,erj->eij", Ji, Ji),
                                    torch.einsum("eri,erj->eij", Jj, Jj),
                                    Hij, Hij.transpose(-1, -2)]))
        g = by_vertex.sum(torch.cat([torch.einsum("eri,er->ei", Ji, r),
                                     torch.einsum("eri,er->ei", Jj, r)]))
        Hmat = H.reshape(N, N, 7, 7).permute(0, 2, 1, 3).reshape(7 * N, 7 * N)
        Hmat = torch.where(hold, eye, Hmat + 1e-6 * eye)
        gvec = torch.where(fixed7, torch.zeros_like(fixed7, dtype=dt), g.reshape(7 * N))
        logs = logs - torch.linalg.solve_ex(Hmat, gvec)[0].reshape(N, 7)
    return logs
