"""Pose-only Levenberg-Marquardt against fixed map points, and bundle
adjustment with sparse Schur elimination of the points.

Port of ``BAObservations``, ``pose_optimization``, ``BAProblem`` and
``bundle_adjustment`` of ``multicol_slam_tpu/models/optimizer.py``
(reference cOptimizer.cpp:57-874; ``free_mc`` and the self-calibrating
BA are not ported yet). Pose LM (cOptimizer.cpp:259-458): residual
m - pi_cam((M_t M_c)^-1 X) per observation, Huber
IRLS weights, two LM rounds with a chi2 > delta^2 outlier gate between
them, and gain termination at 1e-6. The JAX package's ``lax.while_loop``
becomes a fixed ``iters``-step loop of masked updates, so the device never
waits for the host: the pose and the iteration count come out the same,
since a round's state freezes, and ``it`` stops growing, once it is done.

The JAX package differentiates the residual with ``jax.jacfwd``; here the
Jacobian is written out (``pose_jacobian``). Eager forward-mode autodiff
(``torch.func.jacfwd``) gives the same matrix but costs tens of small
operations per residual operation on the host, which made the pose LM
the WORKING frame's bottleneck on a GPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.camera import CameraModel, world_to_img
from ..ops.geometry import (cayley2hom, cayley2rot, cayley_rot_grads, horner,
                            inv3x3, inv_se3)
from ..ops.rig import Rig

HUBER_POSE = 1.345 * 2.0         # cOptimizer.cpp:54 stdFrame = 2.0
HUBER_LOCAL = 1.345 * 2.0        # stdRecon = 2.0 (cOptimizer.cpp:54)
HUBER_GLOBAL = 5.991 ** 0.5      # GlobalBundleAdjustment sqrt(5.991)
LM_TAU = 1e-5                    # g2o initial lambda heuristic
GAIN_EPS = 1e-6                  # termination gain threshold


class BAObservations(NamedTuple):
    """Padded observation table. All tensors lead with (K,)."""

    uv: torch.Tensor          # (K, 2) measured pixel (level-0 coords)
    kf: torch.Tensor          # (K,) int32 body-pose index
    cam: torch.Tensor         # (K,) int32 rig camera index
    pt: torch.Tensor          # (K,) int32 point index
    inv_sigma2: torch.Tensor  # (K,) information scale
    valid: torch.Tensor       # (K,) bool


def _projection_jacobian(cam: CameraModel, Xc: torch.Tensor) -> torch.Tensor:
    """d world_to_img / d Xc (K, 2, 3) for camera fields of (K,)."""
    x, y, z = Xc.unbind(-1)
    n2 = x * x + y * y
    n = torch.sqrt(n2)
    n = torch.where(n == 0.0, torch.full_like(n, 1e-14), n)
    theta = torch.atan2(-z, n)
    rho = horner(cam.inv_poly, theta)
    order = torch.arange(1, cam.inv_poly.shape[-1], dtype=Xc.dtype,
                         device=Xc.device)
    drho = horner(cam.inv_poly[..., 1:] * order, theta)
    q = n2 + z * z
    th = torch.stack([z * x / (n * q), z * y / (n * q), -n / q], -1)
    f = rho / n
    n3 = n * n * n
    df = drho[..., None] * th / n[..., None] \
        - rho[..., None] * torch.stack([x, y, torch.zeros_like(z)], -1) / n3[..., None]
    zero = torch.zeros_like(f)
    duu = x[..., None] * df + torch.stack([f, zero, zero], -1)
    dvv = y[..., None] * df + torch.stack([zero, f, zero], -1)
    du = cam.c[..., None] * duu + cam.d[..., None] * dvv
    dv = cam.e[..., None] * duu + dvv
    return torch.stack([du, dv], -2)


def pose_jacobian(mt_min: torch.Tensor, M_c: torch.Tensor, X: torch.Tensor,
                  cam: CameraModel) -> torch.Tensor:
    """d r / d mt_min (K, 2, 6) of r = uv - world_to_img((M_t M_c)^-1 X),
    M_t = cayley2hom(mt_min), per observation: mt_min (6,) or (K, 6),
    M_c (K, 4, 4), X (K, 3), camera fields (K,). With R, t the body pose
    and R_c, t_c the extrinsics, X_c = R_c^T (R^T (X - t) - t_c)."""
    mt = mt_min.expand(X.shape[0], 6)
    R = cayley2rot(mt[:, :3])                                      # (K, 3, 3)
    Rc, tc = M_c[:, :3, :3], M_c[:, :3, 3]
    d = X - mt[:, 3:]
    Xc = torch.einsum("kij,ki->kj", Rc, torch.einsum("ki,kij->kj", d, R) - tc)
    dY = torch.einsum("kmij,ki->kjm", cayley_rot_grads(mt[:, :3]), d)
    dXc = torch.cat([torch.einsum("kij,kim->kjm", Rc, dY),
                     -(R @ Rc).transpose(-1, -2)], -1)             # (K, 3, 6)
    return -(_projection_jacobian(cam, Xc) @ dXc)


def point_jacobian(T_cw: torch.Tensor, Xc: torch.Tensor,
                   cam: CameraModel) -> torch.Tensor:
    """d r / d X (K, 2, 3) of the same residual: -d pi / d X_c . R_cw, with
    T_cw (K, 4, 4) world-to-camera and X_c (K, 3) the camera-frame point."""
    return -(_projection_jacobian(cam, Xc) @ T_cw[:, :3, :3])


def _huber_w(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(e <= delta, torch.ones_like(e), delta / e)


def pose_optimization(rig: Rig, mt_min0: torch.Tensor, obs: BAObservations,
                      X_world: torch.Tensor, *, huber: float = HUBER_POSE,
                      iters1: int = 10, iters2: int = 10):
    """Optimize the body pose (6,) against fixed points X_world (P, 3)
    indexed by obs.pt. Returns (mt_min, inlier mask (K,), n_inliers,
    n_iterations), all tensors on the inputs' device."""
    delta2 = huber * huber
    cam_idx = obs.cam.long()
    cams = rig.cams.index(cam_idx)                          # fields (K,)
    Mc = cayley2hom(rig.M_c_min)[cam_idx]                   # (K, 4, 4)
    X = X_world[obs.pt.long()]                              # (K, 3)

    def residuals(mt_min):
        T = inv_se3(cayley2hom(mt_min) @ Mc)
        Xc = torch.einsum("kij,kj->ki", T[:, :3, :3], X) + T[:, :3, 3]
        return obs.uv - world_to_img(cams, Xc)               # (K, 2)

    def chi2_of(mt_min, w_valid):
        r = residuals(mt_min)
        chi2 = (r * r).sum(-1) * obs.inv_sigma2
        e = torch.sqrt(chi2)
        rho = torch.where(e <= huber, chi2, 2 * huber * e - delta2)
        return chi2, torch.where(w_valid, rho, torch.zeros_like(rho)).sum()

    def hess(mt, w_valid):
        r = residuals(mt)
        J = pose_jacobian(mt, Mc, X, cams)                   # (K, 2, 6)
        chi2 = (r * r).sum(-1) * obs.inv_sigma2
        w = _huber_w(chi2, huber) * obs.inv_sigma2
        w = torch.where(w_valid, w, torch.zeros_like(w))
        H = torch.einsum("kri,k,krj->ij", J, w, J)
        g = torch.einsum("kri,k,kr->i", J, w, r)
        return H, g

    def lm_round(mt, w_valid, iters):
        _, cost = chi2_of(mt, w_valid)
        H0, _ = hess(mt, w_valid)
        lam = LM_TAU * torch.diagonal(H0).max()
        eye = torch.eye(6, dtype=mt.dtype, device=mt.device)
        it = torch.zeros((), dtype=torch.int32, device=mt.device)
        done = torch.zeros((), dtype=torch.bool, device=mt.device)
        for _ in range(iters):
            active = ~done
            H, g = hess(mt, w_valid)
            # solve_ex: no host check of the factorization, like jnp.linalg.solve
            d = torch.linalg.solve_ex(H + lam * eye, g)[0]
            mt_new = mt - d
            _, cost_new = chi2_of(mt_new, w_valid)
            accept = cost_new < cost
            gain = (cost - cost_new) / torch.clamp(cost_new, min=1e-12)
            take = active & accept
            mt = torch.where(take, mt_new, mt)
            cost = torch.where(take, cost_new, cost)
            lam = torch.where(active, torch.where(accept, lam * 0.5, lam * 4.0), lam)
            it = it + active.to(torch.int32)
            done = done | (take & (gain < GAIN_EPS))
        return mt, it

    w_valid = obs.valid
    mt1, it1 = lm_round(mt_min0, w_valid, iters1)
    chi2, _ = chi2_of(mt1, w_valid)
    inlier = w_valid & (chi2 <= delta2)
    mt2, it2 = lm_round(mt1, inlier, iters2)
    chi2b, _ = chi2_of(mt2, w_valid)
    inlier_final = w_valid & (chi2b <= delta2)
    return mt2, inlier_final, inlier_final.sum(), it1 + it2


# ---------------------------------------------------------------------------
# Bundle adjustment with sparse Schur elimination of the points
# ---------------------------------------------------------------------------

class BAProblem(NamedTuple):
    """Static-shape BA problem: the host builds the index tables, the
    device solves. pt_obs (P, M) int32 lists each point's observation
    rows, padded with K-1 (a guaranteed-invalid row)."""

    obs: BAObservations        # K rows; the last is an invalid pad row
    pt_obs: torch.Tensor       # (P, M) int32
    fixed_kf: torch.Tensor     # (N,) bool: poses held constant
    fixed_pt: torch.Tensor     # (P,) bool


def bundle_adjustment(rig: Rig, mt_min0: torch.Tensor, X0: torch.Tensor,
                      problem: BAProblem, *, huber: float = HUBER_GLOBAL,
                      iters: int = 10):
    """Joint LM over body poses (N, 6) and points (P, 3) with Schur
    elimination of the points (cOptimizer GlobalBundleAdjustment /
    LocalBundleAdjustment, cOptimizer.cpp:57-257 and :461-874).

    Port of the JAX package's ``bundle_adjustment`` without ``free_mc``:
    the per-observation Jacobians are written out (``pose_jacobian``,
    ``point_jacobian``) in place of ``jax.jacfwd``; block sums use
    ``index_add_``, whose order is not fixed on CUDA; the ``while_loop``
    becomes ``iters`` masked steps that freeze once an accepted step's
    relative gain falls under GAIN_EPS, so the device never waits for the
    host. Returns (mt_min (N, 6), X (P, 3), per-observation chi2 (K,))."""
    obs = problem.obs
    N, P = mt_min0.shape[0], X0.shape[0]
    dev, dt = X0.device, X0.dtype
    kf, cam, pt = obs.kf.long(), obs.cam.long(), obs.pt.long()
    cams = rig.cams.index(cam)
    Mc = cayley2hom(rig.M_c_min)[cam]                        # (K, 4, 4)
    delta2 = huber * huber
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    pt_obs = problem.pt_obs.long()
    kf_pad = kf[pt_obs]                                      # (P, M)
    ok_pad = obs.valid[pt_obs]
    fixed6 = problem.fixed_kf.repeat_interleave(6)
    fixed_rc = fixed6[:, None] | fixed6[None, :]
    eye6n = torch.eye(6 * N, dtype=dt, device=dev)
    diag = torch.arange(N, device=dev) * (N + 1)
    pair = (kf_pad[:, :, None] * N + kf_pad[:, None, :])     # (P, M, M)

    def project(mt_all, X_all):
        T = inv_se3(cayley2hom(mt_all)[kf] @ Mc)
        Xk = X_all[pt]
        Xc = torch.einsum("kij,kj->ki", T[:, :3, :3], Xk) + T[:, :3, 3]
        return T, Xk, Xc, obs.uv - world_to_img(cams, Xc)

    def cost_of(mt_all, X_all):
        r = project(mt_all, X_all)[3]
        chi2 = (r * r).sum(-1) * obs.inv_sigma2
        e = torch.sqrt(chi2)
        rho = torch.where(e <= huber, chi2, 2 * huber * e - delta2)
        return torch.where(obs.valid, rho, zero).sum(), chi2

    def schur_step(mt_all, X_all, lam):
        T, Xk, Xc, r = project(mt_all, X_all)
        chi2 = (r * r).sum(-1) * obs.inv_sigma2
        w = torch.where(obs.valid, _huber_w(chi2, huber) * obs.inv_sigma2, zero)
        Jp = pose_jacobian(mt_all[kf], Mc, Xk, cams)             # (K, 2, 6)
        Jx = point_jacobian(T, Xc, cams)                         # (K, 2, 3)
        Jp = torch.where(problem.fixed_kf[kf][:, None, None], zero, Jp)
        Jx = torch.where(problem.fixed_pt[pt][:, None, None], zero, Jx)
        wJp = Jp * w[:, None, None]
        wJx = Jx * w[:, None, None]
        Hpp = torch.zeros((N, 6, 6), dtype=dt, device=dev).index_add_(
            0, kf, torch.einsum("kri,krj->kij", wJp, Jp))
        gp = torch.zeros((N, 6), dtype=dt, device=dev).index_add_(
            0, kf, torch.einsum("kri,kr->ki", wJp, r))
        Hxx = torch.zeros((P, 3, 3), dtype=dt, device=dev).index_add_(
            0, pt, torch.einsum("kri,krj->kij", wJx, Jx))
        gx = torch.zeros((P, 3), dtype=dt, device=dev).index_add_(
            0, pt, torch.einsum("kri,kr->ki", wJx, r))
        E = torch.einsum("kri,krj->kij", wJp, Jx)                # (K, 6, 3)

        # C^-1 per point (3x3 closed form, LM damping lam I); fixed
        # points get a zero inverse
        Ci = inv3x3(Hxx + lam * eye3 + eye3 * 1e-12)
        Ci = torch.where(problem.fixed_pt[:, None, None], zero, Ci)
        Epad = torch.where(ok_pad[..., None, None], E[pt_obs], zero)  # (P, M, 6, 3)
        Tm = torch.einsum("pmij,pjk->pmik", Epad, Ci)
        # S = blockdiag(Hpp + lam I) - sum_p T E^T over keyframe pairs,
        # one observation row at a time (peak memory (P, M, 6, 6))
        S = torch.zeros((N * N, 6, 6), dtype=dt, device=dev)
        for mrow in range(Tm.shape[1]):
            contrib = torch.einsum("pik,pnjk->pnij", Tm[:, mrow], Epad)
            S.index_add_(0, pair[:, mrow].reshape(-1), contrib.reshape(-1, 6, 6))
        S = -S
        S[diag] = S[diag] + Hpp + lam * eye6
        Tg = torch.einsum("pmik,pk->pmi", Tm, gx)                # (P, M, 6)
        g_red = gp - torch.zeros((N, 6), dtype=dt, device=dev).index_add_(
            0, kf_pad.reshape(-1), Tg.reshape(-1, 6))
        Smat = S.reshape(N, N, 6, 6).permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
        # fixed poses: identity rows / columns, zero gradient
        Smat = torch.where(fixed_rc, eye6n, Smat)
        gvec = torch.where(fixed6, zero, g_red.reshape(6 * N))
        dp = torch.linalg.solve_ex(Smat, gvec)[0].reshape(N, 6)
        # back-substitute the points: dx = Ci (gx - sum_m E_m^T dp[kf_m])
        Etdp = torch.einsum("pmij,pmi->pmj", Epad, dp[kf_pad])
        dx = torch.einsum("pij,pj->pi", Ci, gx - Etdp.sum(1))
        # r = m - pi, so the step is minus the solve (as in pose_optimization)
        return mt_all - dp, X_all - dx

    mt, X = mt_min0, X0
    cost, _ = cost_of(mt, X)
    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        active = ~done
        mt_new, X_new = schur_step(mt, X, lam)
        cost_new, _ = cost_of(mt_new, X_new)
        accept = cost_new < cost
        gain = (cost - cost_new) / torch.clamp(cost_new, min=1e-12)
        take = active & accept
        mt = torch.where(take, mt_new, mt)
        X = torch.where(take, X_new, X)
        cost = torch.where(take, cost_new, cost)
        lam = torch.where(active, torch.where(accept, lam * 0.5, lam * 4.0), lam)
        done = done | (take & (gain < GAIN_EPS))
    _, chi2 = cost_of(mt, X)
    return mt, X, chi2
