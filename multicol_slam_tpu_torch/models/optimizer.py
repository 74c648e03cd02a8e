"""Pose-only Levenberg-Marquardt against fixed map points.

Port of ``BAObservations`` and ``pose_optimization`` of
``multicol_slam_tpu/models/optimizer.py`` (reference cOptimizer.cpp:
259-458): residual m - pi_cam((M_t M_c)^-1 X) per observation, Huber
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
from ..ops.geometry import cayley2hom, cayley2rot, horner, inv_se3
from ..ops.rig import Rig

HUBER_POSE = 1.345 * 2.0         # cOptimizer.cpp:54 stdFrame = 2.0
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


def _cayley_rot_grads(c: torch.Tensor) -> torch.Tensor:
    """dR/dc_m (3, 3, 3), m first, of R = cayley2rot(c) for c (3,):
    R = N / s with N = (1 - c.c) I + 2 c c^T + 2 [c]x and s = 1 + c.c."""
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    s = 1.0 + (c * c).sum()
    # skew[m] = [e_m]x, whose column j is e_m x e_j
    skew = torch.linalg.cross(eye[:, None, :].expand(3, 3, 3),
                              eye[None, :, :].expand(3, 3, 3)).transpose(1, 2)
    dN = (-2.0 * c[:, None, None] * eye + 2.0 * eye[:, :, None] * c[None, None, :]
          + 2.0 * c[None, :, None] * eye[:, None, :] + 2.0 * skew)
    return (dN - 2.0 * c[:, None, None] * cayley2rot(c)) / s


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
    M_t = cayley2hom(mt_min), per observation: M_c (K, 4, 4), X (K, 3),
    camera fields (K,). With R, t the body pose and R_c, t_c the
    extrinsics, X_c = R_c^T (R^T (X - t) - t_c)."""
    R = cayley2rot(mt_min[:3])
    Rc, tc = M_c[:, :3, :3], M_c[:, :3, 3]
    d = X - mt_min[3:]
    Xc = torch.einsum("kij,ki->kj", Rc, d @ R - tc)
    dY = torch.einsum("mij,ki->kjm", _cayley_rot_grads(mt_min[:3]), d)
    dXc = torch.cat([torch.einsum("kij,kim->kjm", Rc, dY),
                     -(R @ Rc).transpose(-1, -2)], -1)             # (K, 3, 6)
    return -(_projection_jacobian(cam, Xc) @ dXc)


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
