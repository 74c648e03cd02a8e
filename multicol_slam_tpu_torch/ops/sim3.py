"""Sim(3) primitives: Horn's closed-form alignment and the exp / log maps.

Port of ``multicol_slam_tpu/ops/sim3.py`` (reference cSim3Solver.cpp:
286-371 for Horn's 1987 absolute orientation, g2o_MultiCol_sim3_expmap.h
for the Sim3 vertex whose error is log(Sij Si Sj^-1)). A Sim3 is
(s, R, t) with x' = s R x + t, every field batched over leading dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import inv3x3, rodrigues2rot, rot2rodrigues, skew


def _mv(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", R, x)


class Sim3(NamedTuple):
    s: torch.Tensor   # (...) scale
    R: torch.Tensor   # (..., 3, 3)
    t: torch.Tensor   # (..., 3)

    def apply(self, X: torch.Tensor) -> torch.Tensor:
        return self.s[..., None] * _mv(self.R, X) + self.t

    def compose(self, other: "Sim3") -> "Sim3":
        """self o other: s1 R1 (s2 R2 x + t2) + t1."""
        return Sim3(s=self.s * other.s, R=self.R @ other.R,
                    t=self.s[..., None] * _mv(self.R, other.t) + self.t)

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        si = 1.0 / self.s
        return Sim3(s=si, R=Rt, t=-si[..., None] * _mv(Rt, self.t))

    def to_se3(self) -> torch.Tensor:
        """SE3 with t divided by s (cOptimizerLoopStuff.cpp:480-484)."""
        top = torch.cat([self.R, (self.t / self.s[..., None])[..., None]], -1)
        bottom = torch.eye(4, dtype=top.dtype, device=top.device)[3:]
        return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], -2)


def sim3_identity(dtype=torch.float64, device=None) -> Sim3:
    return Sim3(s=torch.ones((), dtype=dtype, device=device),
                R=torch.eye(3, dtype=dtype, device=device),
                t=torch.zeros(3, dtype=dtype, device=device))


def sim3_from_se3(M: torch.Tensor) -> Sim3:
    return Sim3(s=torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device),
                R=M[..., :3, :3], t=M[..., :3, 3])


# -- exp / log (7-vector [omega(3), upsilon(3), sigma]) ------------------------

def _W(omega: torch.Tensor, sigma: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    theta = torch.sqrt((omega * omega).sum(-1) + 1e-32)
    Om = skew(omega)
    A, B, C = _sim3_W_coeffs(sigma, theta, s)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return A[..., None, None] * Om + B[..., None, None] * (Om @ Om) + C[..., None, None] * eye


def sim3_log(S: Sim3) -> torch.Tensor:
    """Sim3 -> 7-vector [omega, upsilon, sigma] (g2o's sim3 convention)."""
    omega = rot2rodrigues(S.R)
    sigma = torch.log(S.s)
    upsilon = _mv(inv3x3(_W(omega, sigma, S.s)), S.t)
    return torch.cat([omega, upsilon, sigma[..., None]], -1)


def sim3_exp(v: torch.Tensor) -> Sim3:
    """7-vector -> Sim3 (the inverse of sim3_log)."""
    omega, upsilon, sigma = v[..., 0:3], v[..., 3:6], v[..., 6]
    s = torch.exp(sigma)
    return Sim3(s=s, R=rodrigues2rot(omega), t=_mv(_W(omega, sigma, s), upsilon))


def _sim3_W_coeffs(sigma, theta, s):
    """A, B, C of W = A Om + B Om^2 + C I, with the series forms for small
    sigma and theta, every branch computed and one selected."""
    eps = 1e-5
    one = torch.ones_like(sigma)
    sigma2 = sigma * sigma
    th_small = theta < eps
    sg_small = torch.abs(sigma) < eps
    A0 = torch.where(th_small, 0.5 * one,
                     (1.0 - torch.cos(theta)) / torch.clamp(theta * theta, min=eps * eps))
    B0 = torch.where(th_small, one / 6.0,
                     (theta - torch.sin(theta)) / torch.clamp(theta ** 3, min=eps ** 3))
    Cn = (s - 1.0) / torch.where(sg_small, one, sigma)
    An_t0 = (s * sigma - s + 1.0) / torch.where(sg_small, one, sigma2)
    Bn_t0 = (0.5 * sigma2 * s - s + 1.0 + sigma * s) / torch.where(sg_small, one, sigma2 * sigma)
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    t2 = theta * theta
    c = t2 + sigma2
    either = th_small | sg_small
    An = (a * sigma + (1.0 - b) * theta) / torch.where(either, one, theta * c)
    Bn = (Cn - ((b - 1.0) * sigma + a * theta) / torch.where(either, one, c)) / \
        torch.where(th_small, one, t2)
    A = torch.where(sg_small, A0, torch.where(th_small, An_t0, An))
    B = torch.where(sg_small, B0, torch.where(th_small, Bn_t0, Bn))
    C = torch.where(sg_small, one, Cn)
    return A, B, C


# -- Horn's closed-form alignment (cSim3Solver.cpp:286-371) --------------------

def horn_alignment(P1: torch.Tensor, P2: torch.Tensor, fix_scale: bool = False) -> Sim3:
    """Sim3 with x1 = s R x2 + t from point sets (..., M, 3): the
    quaternion is the eigenvector of the largest eigenvalue of Horn's 4x4
    N matrix, the scale the ratio of the sets' spreads.

    q and -q give the same R, so the eigenvector's sign does not matter;
    for a degenerate set (a repeated largest eigenvalue) backends may pick
    different eigenvectors of the eigenspace, and so different rotations."""
    c1 = P1.mean(-2, keepdim=True)
    c2 = P2.mean(-2, keepdim=True)
    Q1, Q2 = P1 - c1, P2 - c2
    M = torch.einsum("...mi,...mj->...ij", Q2, Q1)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    q = torch.linalg.eigh(N)[1][..., :, -1]          # [qw, qx, qy, qz]
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                     2 * (qx * qz + qy * qw)], -1),
        torch.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qx * qw)], -1),
        torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                     1 - 2 * (qx * qx + qy * qy)], -1),
    ], -2)
    if fix_scale:
        s = torch.ones(P1.shape[:-2], dtype=P1.dtype, device=P1.device)
    else:
        n1 = (Q1 * Q1).sum((-1, -2))
        n2 = (Q2 * Q2).sum((-1, -2))
        s = torch.sqrt(n1 / torch.clamp(n2, min=1e-20))
    t = c1[..., 0, :] - s[..., None] * _mv(R, c2[..., 0, :])
    return Sim3(s=s, R=R, t=t)
