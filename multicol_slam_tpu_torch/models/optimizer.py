"""Pose-only Levenberg-Marquardt against fixed map points, and bundle
adjustment with sparse Schur elimination of the points.

Port of ``multicol_slam_tpu/models/optimizer.py``: ``pose_optimization``,
``bundle_adjustment`` (its two halves, ``make_ba_blocks`` and
``make_schur_solve``, shared with ``parallel/ba_sharding.py``) and the
self-calibrating variants, ``refine_intrinsics`` and
``self_calibrating_bundle_adjustment`` (reference cOptimizer.cpp:57-874,
g2o_MultiCol_vertices_edges.h:41-145). Pose LM (cOptimizer.cpp:259-458):
residual m - pi_cam((M_t M_c)^-1 X) per observation, Huber IRLS weights,
two LM rounds with a chi2 > delta^2 outlier gate between them, and gain
termination at 1e-6. On a CUDA tensor ``pose_optimization`` is one launch
of a hand-written kernel (``kernels/pose_lm.py``, ``csrc/pose_lm.cu``)
that stops each round on the device as the JAX package's
``lax.while_loop`` does, with the same pose and, in float64, the same
iteration count (a float32 round's stop rests on a gain below the
rounding of its cost, so it moves with the order of the sums). Its plain
version, ``pose_optimization_reference`` (the CPU's path), turns the loop
into a fixed ``iters``-step loop of masked updates, so the device never
waits for the host: the pose and the iteration count come out the same,
since a round's state freezes, and ``it`` stops growing, once it is done.

The JAX package differentiates the residual with ``jax.jacfwd``; here the
Jacobians are written out (``pose_jacobian``, ``point_jacobian``,
``extrinsic_jacobian``, ``intrinsics_jacobian``). Eager forward-mode autodiff
(``torch.func.jacfwd``) gives the same matrix but costs tens of small
operations per residual operation on the host, which made the pose LM
the WORKING frame's bottleneck on a GPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import pose_lm
from ..utils import graphs
from ..ops.camera import CameraModel, world_to_img
from ..ops.geometry import (cayley2hom, cayley2rot, cayley_rot_grads, horner,
                            inv3x3, inv_se3)
from ..ops.rig import Rig

HUBER_POSE = 1.345 * 2.0         # cOptimizer.cpp:54 stdFrame = 2.0
HUBER_LOCAL = 1.345 * 2.0        # stdRecon = 2.0 (cOptimizer.cpp:54)
HUBER_GLOBAL = 5.991 ** 0.5      # GlobalBundleAdjustment sqrt(5.991)
LM_TAU = 1e-5                    # g2o initial lambda heuristic
GAIN_EPS = 1e-6                  # termination gain threshold
# the self-calibrating optimizers' CUDA graphs: a pool of their own, since
# the system's BA graphs replay on other threads (the mapper's, the
# tracker's)
CALIBRATION = graphs.Pool("calibration")


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


def extrinsic_jacobian(mt_min: torch.Tensor, mc_min: torch.Tensor, X: torch.Tensor,
                       cam: CameraModel) -> torch.Tensor:
    """d r / d mc_min (K, 2, 6) of the same residual with respect to the
    camera's cayley+t extrinsics mc_min (K, 6): mt_min (6,) or (K, 6), X
    (K, 3), camera fields (K,). With Y = R^T (X - t) the point in the body
    frame, X_c = R_c^T (Y - t_c): the rotation part through
    d R_c / d mc[:3], the translation part -R_c^T."""
    mt = mt_min.expand(X.shape[0], 6)
    R = cayley2rot(mt[:, :3])
    Rc = cayley2rot(mc_min[:, :3])
    e = torch.einsum("ki,kij->kj", X - mt[:, 3:], R) - mc_min[:, 3:]   # Y - t_c
    Xc = torch.einsum("kij,ki->kj", Rc, e)
    dXc = torch.cat([torch.einsum("kmij,ki->kjm", cayley_rot_grads(mc_min[:, :3]), e),
                     -Rc.transpose(-1, -2)], -1)                       # (K, 3, 6)
    return -(_projection_jacobian(cam, Xc) @ dXc)


def intrinsics_jacobian(Xc: torch.Tensor, cam: CameraModel) -> torch.Tensor:
    """d r / d v17 (K, 2, 17) of r = uv - world_to_img(cam, X_c) with
    respect to the camera's ``to_vector17`` [c, d, e, u0, v0,
    inv_poly[:12]], for camera-frame points X_c (K, 3) and camera fields
    (K,). With uu = x/n rho, vv = y/n rho and rho = sum_j inv_poly_j
    theta^j: u = c uu + d vv + u0, v = e uu + vv + v0."""
    x, y, z = Xc.unbind(-1)
    n = torch.sqrt(x * x + y * y)
    n = torch.where(n == 0.0, torch.full_like(n, 1e-14), n)
    theta = torch.atan2(-z, n)
    rho = horner(cam.inv_poly, theta)
    uu, vv = x / n * rho, y / n * rho
    one, zero = torch.ones_like(uu), torch.zeros_like(uu)
    powers = torch.cumprod(torch.cat([one[:, None], theta[:, None].expand(-1, 11)], -1), -1)
    du = torch.cat([torch.stack([uu, vv, zero, one, zero], -1),
                    (cam.c * x / n + cam.d * y / n)[:, None] * powers], -1)
    dv = torch.cat([torch.stack([zero, zero, uu, zero, one], -1),
                    (cam.e * x / n + y / n)[:, None] * powers], -1)
    return -torch.stack([du, dv], -2)


def _huber_w(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(e <= delta, torch.ones_like(e), delta / e)


def _robust_cost(r: torch.Tensor, obs: BAObservations, huber: float):
    """(Huber cost over the valid observations, per-observation chi2)."""
    chi2 = (r * r).sum(-1) * obs.inv_sigma2
    e = torch.sqrt(chi2)
    rho = torch.where(e <= huber, chi2, 2 * huber * e - huber * huber)
    return torch.where(obs.valid, rho, torch.zeros_like(rho)).sum(), chi2


def pose_optimization(rig: Rig, mt_min0: torch.Tensor, obs: BAObservations,
                      X_world: torch.Tensor, *, huber: float = HUBER_POSE,
                      iters1: int = 10, iters2: int = 10):
    """Optimize the body pose (6,) against fixed points X_world (P, 3)
    indexed by obs.pt. Returns (mt_min, inlier mask (K,), n_inliers,
    n_iterations), all tensors on the inputs' device: on a CPU tensor the
    plain version's (``pose_optimization_reference``), on a CUDA tensor
    the pose LM kernel's (``kernels/pose_lm.py``: one launch)."""
    if mt_min0.device.type == "cpu":
        return pose_optimization_reference(rig, mt_min0, obs, X_world, huber=huber,
                                           iters1=iters1, iters2=iters2)
    return pose_lm.pose_lm(rig, mt_min0, obs, X_world, huber=huber, iters1=iters1,
                           iters2=iters2, tau=LM_TAU, gain_eps=GAIN_EPS)


def pose_lm_parts(rig: Rig, obs: BAObservations, X_world: torch.Tensor, huber: float):
    """The plain pose LM's evaluations at a pose ``mt`` (6,) over the rows
    of ``w_valid`` (K,): ``chi2_of(mt, w_valid)`` -> (chi2 (K,), the Huber
    cost), ``hess(mt, w_valid)`` -> (J^T W J (6, 6), J^T W r (6,)) and its
    terms by row, ``rows(mt, w_valid)`` -> (r (K, 2), J (K, 2, 6), the
    Huber weight W (K,), 0 outside ``w_valid``)."""
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

    def rows(mt, w_valid):
        r = residuals(mt)
        J = pose_jacobian(mt, Mc, X, cams)                   # (K, 2, 6)
        chi2 = (r * r).sum(-1) * obs.inv_sigma2
        w = _huber_w(chi2, huber) * obs.inv_sigma2
        return r, J, torch.where(w_valid, w, torch.zeros_like(w))

    def hess(mt, w_valid):
        r, J, w = rows(mt, w_valid)
        H = torch.einsum("kri,k,krj->ij", J, w, J)
        g = torch.einsum("kri,k,kr->i", J, w, r)
        return H, g

    return chi2_of, hess, rows


def pose_optimization_reference(rig: Rig, mt_min0: torch.Tensor, obs: BAObservations,
                                X_world: torch.Tensor, *, huber: float = HUBER_POSE,
                                iters1: int = 10, iters2: int = 10):
    """The plain version of ``pose_optimization`` (its path on the CPU):
    each round a fixed loop of ``iters`` masked updates that freezes once
    the round is done."""
    delta2 = huber * huber
    chi2_of, hess, _ = pose_lm_parts(rig, obs, X_world, huber)

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


SPREAD = 1024   # targets past n that share the rows outside ``live`` (_segments)


def _segments(idx: torch.Tensor, n: int, live: torch.Tensor):
    """(order, lengths): the rows of ``idx`` (K,) sorted by target (a
    stable sort, no host read) and the rows each target receives. Rows
    outside ``live`` go to SPREAD targets past ``n``, dropped after the
    sum: gathered into one target they would make one thread sum them
    all."""
    spread = n + torch.arange(idx.shape[0], device=idx.device) % SPREAD
    tgt = torch.where(live, idx.long(), spread)
    lengths = torch.zeros(n + SPREAD, dtype=torch.long, device=tgt.device).index_add_(
        0, tgt, torch.ones_like(tgt))
    return torch.argsort(tgt, stable=True), lengths


def _segment_sum(seg, vals: torch.Tensor, n: int) -> torch.Tensor:
    """The rows of ``vals`` summed per target of ``_segments``, each
    target's rows one after another in row order (``segment_reduce``: one
    thread a target and column). Returns (n, ...)."""
    order, lengths = seg
    return torch.segment_reduce(vals[order], "sum", lengths=lengths, unsafe=True)[:n]


class RowSum:
    """Rows summed into ``n`` targets by an index table ``idx`` (K,), the
    same sum at every call. On the CPU ``index_add_`` adds the rows one
    after another in row order. On CUDA ``index_add_`` adds with atomics,
    in no fixed order, so a CUDA graph's replay and an eager call would
    differ; there the rows are sorted by target once and each call sums
    each target's rows in that order (``_segment_sum``). Rows outside
    ``live`` (K,) add exact zeros (the padding) and are left out there."""

    def __init__(self, idx: torch.Tensor, n: int, live: torch.Tensor):
        self.idx, self.n = idx.long(), n
        self.seg = _segments(idx, n, live) if self.idx.is_cuda else None

    def add_to(self, out: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        """``out`` (n, ...) plus the sums of ``vals`` (K, ...); on the CPU
        ``out`` is updated in place."""
        if self.seg is None:
            return out.index_add_(0, self.idx, vals)
        return out + _segment_sum(self.seg, vals, self.n)

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        return self.add_to(torch.zeros((self.n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                                       device=vals.device), vals)


def make_ba_blocks(rig: Rig, obs: BAObservations, fixed_kf: torch.Tensor,
                   fixed_pt: torch.Tensor, n_kf: int, n_pt: int, huber: float):
    """The per-observation half of a Schur BA step over one observation
    table (the whole problem's, or one shard's), on its device. Returns
    (blocks, cost_of):

    - ``blocks(mt_all (N, 6), X_all (P, 3))`` -> (Hpp (N, 6, 6), gp (N, 6),
      Hxx (P, 3, 3), gx (P, 3), E (K, 6, 3), robust cost at the input):
      Huber-weighted normal-equation blocks from the written-out
      Jacobians (``pose_jacobian``, ``point_jacobian``), those of fixed
      keyframes and fixed points zeroed, summed per keyframe and per
      point by ``RowSum`` (a fixed order);
    - ``cost_of(mt_all, X_all)`` -> (robust cost, per-observation chi2 (K,)).

    Rows with ``valid`` False weigh nothing."""
    N, P = n_kf, n_pt
    kf, cam, pt = obs.kf.long(), obs.cam.long(), obs.pt.long()
    cams = rig.cams.index(cam)
    Mc = cayley2hom(rig.M_c_min)[cam]                        # (K, 4, 4)
    fix_kf = fixed_kf[kf][:, None, None]
    fix_pt = fixed_pt[pt][:, None, None]
    by_kf, by_pt = RowSum(kf, N, obs.valid), RowSum(pt, P, obs.valid)

    def project(mt_all, X_all):
        T = inv_se3(cayley2hom(mt_all)[kf] @ Mc)
        Xk = X_all[pt]
        Xc = torch.einsum("kij,kj->ki", T[:, :3, :3], Xk) + T[:, :3, 3]
        return T, Xk, Xc, obs.uv - world_to_img(cams, Xc)

    def cost_of(mt_all, X_all):
        return _robust_cost(project(mt_all, X_all)[3], obs, huber)

    def blocks(mt_all, X_all):
        dt, dev = X_all.dtype, X_all.device
        zero = torch.zeros((), dtype=dt, device=dev)
        T, Xk, Xc, r = project(mt_all, X_all)
        cost, chi2 = _robust_cost(r, obs, huber)
        w = torch.where(obs.valid, _huber_w(chi2, huber) * obs.inv_sigma2, zero)
        Jp = pose_jacobian(mt_all[kf], Mc, Xk, cams)             # (K, 2, 6)
        Jx = point_jacobian(T, Xc, cams)                         # (K, 2, 3)
        Jp = torch.where(fix_kf, zero, Jp)
        Jx = torch.where(fix_pt, zero, Jx)
        wJp = Jp * w[:, None, None]
        wJx = Jx * w[:, None, None]
        Hpp = by_kf.sum(torch.einsum("kri,krj->kij", wJp, Jp))
        gp = by_kf.sum(torch.einsum("kri,kr->ki", wJp, r))
        Hxx = by_pt.sum(torch.einsum("kri,krj->kij", wJx, Jx))
        gx = by_pt.sum(torch.einsum("kri,kr->ki", wJx, r))
        E = torch.einsum("kri,krj->kij", wJp, Jx)                # (K, 6, 3)
        return Hpp, gp, Hxx, gx, E, cost

    return blocks, cost_of


def make_schur_solve(kf: torch.Tensor, valid: torch.Tensor, pt_obs: torch.Tensor,
                     fixed_kf: torch.Tensor, fixed_pt: torch.Tensor, n_kf: int):
    """The reduced half of a Schur BA step, on the device of its inputs:
    ``kf``, ``valid`` (K,) of the whole observation table and ``pt_obs``
    (P, M) its rows per point. Returns ``solve(Hpp, gp, Hxx, gx, E, lam)``
    -> (dp (N, 6), dx (P, 3)), the step to subtract from the poses and
    points: each point's damped 3x3 block inverted in closed form (zero
    for fixed points), the reduced camera system S = blockdiag(Hpp + lam
    I) - sum_p E C^-1 E^T folded in one observation row at a time (peak
    memory (P, M, 6, 6), not (P, M, M, 6, 6)), identity rows and columns
    with a zero gradient for fixed keyframes, one dense solve, and the
    points back-substituted. Every sum into keyframes or keyframe pairs is
    a ``RowSum`` (a fixed order), its table made once."""
    N = n_kf
    dev = valid.device
    pt_obs = pt_obs.long()
    kf_pad = kf.long()[pt_obs]                               # (P, M)
    ok_pad = valid[pt_obs]
    fixed6 = fixed_kf.repeat_interleave(6)
    fixed_rc = fixed6[:, None] | fixed6[None, :]
    diag = torch.arange(N, device=dev) * (N + 1)
    pair = (kf_pad[:, :, None] * N + kf_pad[:, None, :])     # (P, M, M)
    by_pair = [RowSum(pair[:, mrow].reshape(-1), N * N,
                      (ok_pad[:, mrow, None] & ok_pad).reshape(-1))
               for mrow in range(pair.shape[1])]
    by_kf = RowSum(kf_pad.reshape(-1), N, ok_pad.reshape(-1))

    def solve(Hpp, gp, Hxx, gx, E, lam):
        dt = Hxx.dtype
        zero = torch.zeros((), dtype=dt, device=dev)
        eye3 = torch.eye(3, dtype=dt, device=dev)
        eye6 = torch.eye(6, dtype=dt, device=dev)
        # C^-1 per point (3x3 closed form, LM damping lam I); fixed
        # points get a zero inverse
        Ci = inv3x3(Hxx + lam * eye3 + eye3 * 1e-12)
        Ci = torch.where(fixed_pt[:, None, None], zero, Ci)
        Epad = torch.where(ok_pad[..., None, None], E[pt_obs], zero)  # (P, M, 6, 3)
        Tm = torch.einsum("pmij,pjk->pmik", Epad, Ci)
        # S = blockdiag(Hpp + lam I) - sum_p T E^T over keyframe pairs,
        # one observation row at a time (peak memory (P, M, 6, 6))
        S = torch.zeros((N * N, 6, 6), dtype=dt, device=dev)
        for mrow, seg in enumerate(by_pair):
            contrib = torch.einsum("pik,pnjk->pnij", Tm[:, mrow], Epad)
            S = seg.add_to(S, contrib.reshape(-1, 6, 6))
        S = -S
        S[diag] = S[diag] + Hpp + lam * eye6
        Tg = torch.einsum("pmik,pk->pmi", Tm, gx)                # (P, M, 6)
        g_red = gp - by_kf.sum(Tg.reshape(-1, 6))
        Smat = S.reshape(N, N, 6, 6).permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
        # fixed poses: identity rows / columns, zero gradient
        Smat = torch.where(fixed_rc, torch.eye(6 * N, dtype=dt, device=dev), Smat)
        gvec = torch.where(fixed6, zero, g_red.reshape(6 * N))
        dp = torch.linalg.solve_ex(Smat, gvec)[0].reshape(N, 6)
        # back-substitute the points: dx = Ci (gx - sum_m E_m^T dp[kf_m])
        Etdp = torch.einsum("pmij,pmi->pmj", Epad, dp[kf_pad])
        dx = torch.einsum("pij,pj->pi", Ci, gx - Etdp.sum(1))
        return dp, dx

    return solve


def lm_accept(cost, cost_new, lam, done, early_stop: bool = True):
    """One step of the BA's accept / reject schedule (cOptimizer.cpp:
    88-92): a step is taken when it lowers the cost, lambda is halved on
    accept and quadrupled on reject, and the loop is done after a taken
    step whose relative gain is under GAIN_EPS (never with ``early_stop``
    False). Once done the state freezes. Returns (take, cost, lam, done)."""
    active = ~done
    accept = cost_new < cost
    gain = (cost - cost_new) / torch.clamp(cost_new, min=1e-12)
    take = active & accept
    cost = torch.where(take, cost_new, cost)
    lam = torch.where(active, torch.where(accept, lam * 0.5, lam * 4.0), lam)
    if early_stop:
        done = done | (take & (gain < GAIN_EPS))
    return take, cost, lam, done


def bundle_adjustment(rig: Rig, mt_min0: torch.Tensor, X0: torch.Tensor,
                      problem: BAProblem, *, huber: float = HUBER_GLOBAL,
                      iters: int = 10, free_mc: bool = False,
                      early_stop: bool = True):
    """Joint LM over body poses (N, 6) and points (P, 3) with Schur
    elimination of the points (cOptimizer GlobalBundleAdjustment /
    LocalBundleAdjustment, cOptimizer.cpp:57-257 and :461-874).

    Port of the JAX package's ``bundle_adjustment``: the per-observation
    Jacobians are written out (``make_ba_blocks``) in place of
    ``jax.jacfwd``; the block sums are ``RowSum``s, in a fixed order on
    the card too, so a CUDA graph of the BA replays its eager result bit
    for bit; the ``while_loop`` becomes ``iters`` masked steps that
    freeze once an accepted step's relative gain falls under GAIN_EPS, so
    the device never waits for the host. ``early_stop=False`` runs every
    one of the ``iters`` steps (a fixed count to time by).
    ``free_mc=True`` frees the rig extrinsics too
    (``self_calibrating_bundle_adjustment``). Returns (mt_min (N, 6),
    X (P, 3), per-observation chi2 (K,))."""
    if free_mc:
        mt, X, _, chi2 = self_calibrating_bundle_adjustment(
            rig, mt_min0, X0, problem, huber=huber, iters=iters)
        return mt, X, chi2
    obs = problem.obs
    N, P = mt_min0.shape[0], X0.shape[0]
    dev, dt = X0.device, X0.dtype
    blocks, cost_of = make_ba_blocks(rig, obs, problem.fixed_kf, problem.fixed_pt,
                                     N, P, huber)
    solve = make_schur_solve(obs.kf, obs.valid, problem.pt_obs, problem.fixed_kf,
                             problem.fixed_pt, N)
    mt, X = mt_min0, X0
    cost, _ = cost_of(mt, X)
    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        Hpp, gp, Hxx, gx, E, _ = blocks(mt, X)
        dp, dx = solve(Hpp, gp, Hxx, gx, E, lam)
        # r = m - pi, so the step is minus the solve (as in pose_optimization)
        mt_new, X_new = mt - dp, X - dx
        take, cost, lam, done = lm_accept(cost, cost_of(mt_new, X_new)[0], lam, done,
                                          early_stop)
        mt = torch.where(take, mt_new, mt)
        X = torch.where(take, X_new, X)
    _, chi2 = cost_of(mt, X)
    return mt, X, chi2


@graphs.compiled(CALIBRATION)
def refine_intrinsics(rig: Rig, mt_all: torch.Tensor, X: torch.Tensor,
                      obs: BAObservations, *, iters: int = 8,
                      huber: float = HUBER_GLOBAL):
    """Refine every camera's 17 omnidirectional intrinsics [c, d, e, u0,
    v0, inv_poly[:12]] (VertexOmniCameraParameters, g2o_MultiCol_vertices_
    edges.h:41-79, additive update) with poses and points held: one 17x17
    damped normal system per camera (cameras do not couple), exactly
    ``iters`` accept / reject steps from lambda 1e-3, the JAX package's
    ``fori_loop``. The per-camera sums are a ``RowSum``. On CUDA tensors a
    CUDA graph of ``CALIBRATION`` (one per key, as ``jax.jit``), on the
    CPU the plain function. Returns (cams', per-camera 17-vectors (C, 17),
    final robust cost), on the inputs' device."""
    dt, dev = X.dtype, X.device
    C = rig.n_cams
    kf, cam, pt = obs.kf.long(), obs.cam.long(), obs.pt.long()
    cams0 = rig.cams
    # poses and points are held: every observation's camera-frame point
    # is computed once
    T = inv_se3(cayley2hom(mt_all)[kf] @ cayley2hom(rig.M_c_min)[cam])
    Xc = torch.einsum("kij,kj->ki", T[:, :3, :3], X[pt]) + T[:, :3, 3]
    eye = torch.eye(17, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    by_cam = RowSum(cam, C, obs.valid)

    def residuals(v17):
        return obs.uv - world_to_img(cams0.with_vector17(v17).index(cam), Xc)

    def step(v17, lam):
        r = residuals(v17)
        chi2 = (r * r).sum(-1) * obs.inv_sigma2
        w = torch.where(obs.valid, _huber_w(chi2, huber) * obs.inv_sigma2, zero)
        J = intrinsics_jacobian(Xc, cams0.with_vector17(v17).index(cam))   # (K, 2, 17)
        wJ = J * w[:, None, None]
        H = by_cam.sum(torch.einsum("kri,krj->kij", wJ, J))
        g = by_cam.sum(torch.einsum("kri,kr->ki", wJ, r))
        return v17 - torch.linalg.solve_ex(H + lam * eye, g)[0]

    v = cams0.to_vector17().to(dt)
    cost = _robust_cost(residuals(v), obs, huber)[0]
    lam = torch.full((), 1e-3, dtype=dt, device=dev)
    for _ in range(iters):
        v_new = step(v, lam)
        cost_new = _robust_cost(residuals(v_new), obs, huber)[0]
        accept = cost_new < cost
        v = torch.where(accept, v_new, v)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
    return cams0.with_vector17(v), v, cost


@graphs.compiled(CALIBRATION)
def self_calibrating_bundle_adjustment(rig: Rig, mt_min0: torch.Tensor,
                                       X0: torch.Tensor, problem: BAProblem, *,
                                       huber: float = HUBER_GLOBAL, iters: int = 10):
    """MultiCol BA with free rig extrinsics: body poses (N, 6), points
    (P, 3) and the extrinsics M_c (C, 6) together (the reference's
    VertexMc_cayley, g2o_MultiCol_vertices_edges.h:83-145, held fixed in
    normal operation).

    The cameras join the reduced system as vertices N..N+C-1; each
    observation couples its keyframe and its camera, so the Schur
    complement gains keyframe <-> camera blocks. Gauge: ``fixed_kf`` and
    camera 0; fixed vertices get identity rows and columns. A camera that
    no valid observation reaches keeps only lambda on its diagonal block
    and does not move, as in the JAX package. Per-point rows of both vertex
    kinds (P, 2M, 6, 3) are folded into the system one row at a time;
    ``iters`` masked LM steps from lambda 1e-4 freeze at the GAIN_EPS
    test, with no host sync. Every sum into vertices, vertex pairs and
    points is a ``RowSum``, its table made once a call (the Schur fold one
    a row of ``pt_obs``). On CUDA tensors a CUDA graph of ``CALIBRATION``
    (one per key, as ``jax.jit``), on the CPU the plain function. Returns
    (mt (N, 6), X (P, 3), mc (C, 6), per-observation chi2 (K,)), on the
    inputs' device."""
    obs = problem.obs
    N, P, C = mt_min0.shape[0], X0.shape[0], rig.n_cams
    NV = N + C
    dev, dt = X0.device, X0.dtype
    kf, cam, pt = obs.kf.long(), obs.cam.long(), obs.pt.long()
    cams = rig.cams.index(cam)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    fixed_cam = torch.arange(C, device=dev) == 0
    fixed_vert = torch.cat([problem.fixed_kf, fixed_cam])
    fixed6 = fixed_vert.repeat_interleave(6)
    fixed_rc = fixed6[:, None] | fixed6[None, :]
    eye6n = torch.eye(6 * NV, dtype=dt, device=dev)
    diag = torch.arange(NV, device=dev) * (NV + 1)
    vert_p, vert_m = kf, N + cam
    pt_obs = problem.pt_obs.long()
    vpad = torch.cat([vert_p[pt_obs], vert_m[pt_obs]], 1)         # (P, 2M)
    ok_pad = obs.valid[pt_obs].repeat(1, 2)
    # the vertex blocks (NV * NV, 6, 6): the diagonal and keyframe <-> camera
    by_block = RowSum(torch.cat([vert_p * NV + vert_p, vert_m * NV + vert_m,
                                 vert_p * NV + vert_m, vert_m * NV + vert_p]), NV * NV,
                      obs.valid.repeat(4))
    by_vert = RowSum(torch.cat([vert_p, vert_m]), NV, obs.valid.repeat(2))
    by_pt = RowSum(pt, P, obs.valid)
    by_pair = [RowSum((vpad[:, mrow, None] * NV + vpad).reshape(-1), NV * NV,
                      (ok_pad[:, mrow, None] & ok_pad).reshape(-1))
               for mrow in range(vpad.shape[1])]
    by_vpad = RowSum(vpad.reshape(-1), NV, ok_pad.reshape(-1))

    def project(mt_all, mc_all, X_all):
        T = inv_se3(cayley2hom(mt_all)[kf] @ cayley2hom(mc_all)[cam])
        Xk = X_all[pt]
        Xc = torch.einsum("kij,kj->ki", T[:, :3, :3], Xk) + T[:, :3, 3]
        return T, Xk, Xc, obs.uv - world_to_img(cams, Xc)

    def cost_of(mt_all, mc_all, X_all):
        return _robust_cost(project(mt_all, mc_all, X_all)[3], obs, huber)

    def schur_step(mt_all, mc_all, X_all, lam):
        T, Xk, Xc, r = project(mt_all, mc_all, X_all)
        chi2 = (r * r).sum(-1) * obs.inv_sigma2
        w = torch.where(obs.valid, _huber_w(chi2, huber) * obs.inv_sigma2, zero)
        Mc = cayley2hom(mc_all)[cam]
        Jp = pose_jacobian(mt_all[kf], Mc, Xk, cams)                 # (K, 2, 6)
        Jm = extrinsic_jacobian(mt_all[kf], mc_all[cam], Xk, cams)   # (K, 2, 6)
        Jx = point_jacobian(T, Xc, cams)                             # (K, 2, 3)
        Jp = torch.where(fixed_vert[vert_p][:, None, None], zero, Jp)
        Jm = torch.where(fixed_vert[vert_m][:, None, None], zero, Jm)
        Jx = torch.where(problem.fixed_pt[pt][:, None, None], zero, Jx)
        wJp, wJm, wJx = (J * w[:, None, None] for J in (Jp, Jm, Jx))

        Hpm = torch.einsum("kri,krj->kij", wJp, Jm)
        H = by_block.sum(torch.cat([torch.einsum("kri,krj->kij", wJp, Jp),
                                    torch.einsum("kri,krj->kij", wJm, Jm),
                                    Hpm, Hpm.transpose(-1, -2)]))
        g = by_vert.sum(torch.cat([torch.einsum("kri,kr->ki", wJp, r),
                                   torch.einsum("kri,kr->ki", wJm, r)]))
        Hxx = by_pt.sum(torch.einsum("kri,krj->kij", wJx, Jx))
        gx = by_pt.sum(torch.einsum("kri,kr->ki", wJx, r))
        Ep = torch.einsum("kri,krj->kij", wJp, Jx)                   # (K, 6, 3)
        Em = torch.einsum("kri,krj->kij", wJm, Jx)

        Ci = inv3x3(Hxx + lam * eye3 + eye3 * 1e-12)
        Ci = torch.where(problem.fixed_pt[:, None, None], zero, Ci)
        Epad = torch.where(ok_pad[..., None, None],
                           torch.cat([Ep[pt_obs], Em[pt_obs]], 1), zero)  # (P, 2M, 6, 3)
        Tm = torch.einsum("pmij,pjk->pmik", Epad, Ci)
        # one row at a time: peak memory (P, 2M, 6, 6), not (P, 2M, 2M, 6, 6)
        S = torch.zeros((NV * NV, 6, 6), dtype=dt, device=dev)
        for mrow, seg in enumerate(by_pair):
            contrib = torch.einsum("pik,pnjk->pnij", Tm[:, mrow], Epad)
            S = seg.add_to(S, contrib.reshape(-1, 6, 6))
        S = H - S
        S[diag] = S[diag] + lam * eye6
        Tg = torch.einsum("pmik,pk->pmi", Tm, gx)
        g_red = g - by_vpad.sum(Tg.reshape(-1, 6))
        Smat = S.reshape(NV, NV, 6, 6).permute(0, 2, 1, 3).reshape(6 * NV, 6 * NV)
        Smat = torch.where(fixed_rc, eye6n, Smat)
        gvec = torch.where(fixed6, zero, g_red.reshape(6 * NV))
        d = torch.linalg.solve_ex(Smat, gvec)[0].reshape(NV, 6)
        Etd = torch.einsum("pmij,pmi->pmj", Epad, d[vpad])
        dx = torch.einsum("pij,pj->pi", Ci, gx - Etd.sum(1))
        return mt_all - d[:N], mc_all - d[N:], X_all - dx

    mt, mc, X = mt_min0, rig.M_c_min.to(dt), X0
    cost, _ = cost_of(mt, mc, X)
    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        mt_n, mc_n, X_n = schur_step(mt, mc, X, lam)
        take, cost, lam, done = lm_accept(cost, cost_of(mt_n, mc_n, X_n)[0], lam, done)
        mt = torch.where(take, mt_n, mt)
        mc = torch.where(take, mc_n, mc)
        X = torch.where(take, X_n, X)
    return mt, X, mc, cost_of(mt, mc, X)[1]
