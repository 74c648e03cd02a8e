"""Sim(3) primitives: Horn's closed-form alignment and the exp / log maps.

Port of ``multicol_slam_tpu/ops/sim3.py`` (reference cSim3Solver.cpp:
286-371 for Horn's 1987 absolute orientation, g2o_MultiCol_sim3_expmap.h
for the Sim3 vertex whose error is log(Sij Si Sj^-1)). A Sim3 is
(s, R, t) with x' = s R x + t, every field batched over leading dims.

The ``*_jvp`` functions give a value and its derivatives along J tangent
directions, written out (the JAX package takes them with ``jax.jacfwd``):
a tangent of a Sim3 is a ``Sim3`` of derivatives, s (..., J), R (..., J,
3, 3), t (..., J, 3); of a 7-vector (..., J, 7). Where the value selects
between a closed form and its series, the derivative is the selected
branch's, as forward-mode autodiff takes it, and the branch not selected
stays finite.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.small_eig import sym_eig
from .geometry import (inv3x3, rodrigues2rot, rodrigues2rot_jvp, rot2rodrigues,
                       rot2rodrigues_jvp, skew)


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


# -- derivatives ---------------------------------------------------------------

def _quot(n, dn, d, dd):
    """n / d and its derivatives (..., J) from those of n and d, the
    values (..., 1)."""
    q = n / d
    return q, (dn - q * dd) / d


def _sim3_W_coeffs_jvp(sigma, dsigma, theta, dtheta, s, ds):
    """``_sim3_W_coeffs`` and the derivatives of A, B, C (..., J) along
    the tangents of sigma, theta and s (..., J), branch by branch. The
    values are taken as (..., 1), so that they broadcast against the
    tangents, and A, B, C come back so."""
    eps = 1e-5
    sigma, theta, s = sigma[..., None], theta[..., None], s[..., None]
    one = torch.ones_like(sigma)
    zero = torch.zeros_like(dsigma)
    sigma2 = sigma * sigma
    th_small = theta < eps
    sg_small = torch.abs(sigma) < eps
    either = th_small | sg_small
    sn, cs = torch.sin(theta), torch.cos(theta)
    dsg2 = 2.0 * sigma * dsigma
    t2 = theta * theta
    dt2 = 2.0 * theta * dtheta
    # theta -> 0 with sigma -> 0: SO3's series
    A0, dA0 = _quot(1.0 - cs, sn * dtheta, torch.clamp(t2, min=eps * eps),
                    torch.where(t2 >= eps * eps, dt2, zero))
    B0, dB0 = _quot(theta - sn, (1.0 - cs) * dtheta, torch.clamp(theta ** 3, min=eps ** 3),
                    torch.where(theta ** 3 >= eps ** 3, 3.0 * t2 * dtheta, zero))
    A0 = torch.where(th_small, 0.5 * one, A0)
    B0 = torch.where(th_small, one / 6.0, B0)
    dA0 = torch.where(th_small, zero, dA0)
    dB0 = torch.where(th_small, zero, dB0)
    # sigma's closed forms
    Cn, dCn = _quot(s - 1.0, ds, torch.where(sg_small, one, sigma),
                    torch.where(sg_small, zero, dsigma))
    An_t0, dAn_t0 = _quot(s * sigma - s + 1.0, ds * sigma + s * dsigma - ds,
                          torch.where(sg_small, one, sigma2), torch.where(sg_small, zero, dsg2))
    Bn_t0, dBn_t0 = _quot(
        0.5 * sigma2 * s - s + 1.0 + sigma * s,
        0.5 * dsg2 * s + 0.5 * sigma2 * ds - ds + dsigma * s + sigma * ds,
        torch.where(sg_small, one, sigma2 * sigma),
        torch.where(sg_small, zero, 3.0 * sigma2 * dsigma))
    a, b = s * sn, s * cs
    da = ds * sn + (s * cs) * dtheta
    db = ds * cs - (s * sn) * dtheta
    c = t2 + sigma2
    dc = dt2 + dsg2
    An, dAn = _quot(a * sigma + (1.0 - b) * theta,
                    da * sigma + a * dsigma - db * theta + (1.0 - b) * dtheta,
                    torch.where(either, one, theta * c),
                    torch.where(either, zero, dtheta * c + theta * dc))
    f, df = _quot((b - 1.0) * sigma + a * theta,
                  db * sigma + (b - 1.0) * dsigma + da * theta + a * dtheta,
                  torch.where(either, one, c), torch.where(either, zero, dc))
    Bn, dBn = _quot(Cn - f, dCn - df, torch.where(th_small, one, t2),
                    torch.where(th_small, zero, dt2))
    A = torch.where(sg_small, A0, torch.where(th_small, An_t0, An))
    B = torch.where(sg_small, B0, torch.where(th_small, Bn_t0, Bn))
    C = torch.where(sg_small, one, Cn)
    dA = torch.where(sg_small, dA0, torch.where(th_small, dAn_t0, dAn))
    dB = torch.where(sg_small, dB0, torch.where(th_small, dBn_t0, dBn))
    dC = torch.where(sg_small, zero, dCn)
    return (A, B, C), (dA, dB, dC)


def _W_jvp(omega, domega, sigma, dsigma, s, ds):
    """``_W`` (..., 3, 3) and its derivatives (..., J, 3, 3)."""
    theta = torch.sqrt((omega * omega).sum(-1) + 1e-32)
    dtheta = (omega[..., None, :] * domega).sum(-1) / theta[..., None]
    Om, dOm = skew(omega), skew(domega)
    (A, B, C), (dA, dB, dC) = _sim3_W_coeffs_jvp(sigma, dsigma, theta, dtheta, s, ds)
    A, B, C = A[..., None], B[..., None], C[..., None]          # (..., 1, 1)
    dA, dB, dC = dA[..., None, None], dB[..., None, None], dC[..., None, None]
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    Om2 = Om @ Om
    W = A * Om + B * Om2 + C * eye
    Omx, A, B = Om[..., None, :, :], A[..., None], B[..., None]
    dW = (dA * Omx + A * dOm + dB * Om2[..., None, :, :] + B * (dOm @ Omx + Omx @ dOm)
          + dC * eye)
    return W, dW


def sim3_exp_jvp(v: torch.Tensor, dv: torch.Tensor):
    """``sim3_exp(v)`` and its tangent along dv (..., J, 7)."""
    omega, upsilon, sigma = v[..., 0:3], v[..., 3:6], v[..., 6]
    s = torch.exp(sigma)
    ds = s[..., None] * dv[..., 6]
    R, dR = rodrigues2rot_jvp(omega, dv[..., 0:3])
    W, dW = _W_jvp(omega, dv[..., 0:3], sigma, dv[..., 6], s, ds)
    t = _mv(W, upsilon)
    dt = _mv(dW, upsilon[..., None, :]) + _mv(W[..., None, :, :], dv[..., 3:6])
    return Sim3(s=s, R=R, t=t), Sim3(s=ds, R=dR, t=dt)


def compose_jvp(S1: Sim3, d1, S2: Sim3, d2):
    """``S1.compose(S2)`` and its tangent from theirs; a tangent of None is
    a constant's."""
    S = S1.compose(S2)
    parts = []
    if d1 is not None:
        parts.append(Sim3(
            s=d1.s * S2.s[..., None], R=d1.R @ S2.R[..., None, :, :],
            t=d1.s[..., None] * _mv(S1.R, S2.t)[..., None, :]
            + S1.s[..., None, None] * _mv(d1.R, S2.t[..., None, :]) + d1.t))
    if d2 is not None:
        parts.append(Sim3(
            s=S1.s[..., None] * d2.s, R=S1.R[..., None, :, :] @ d2.R,
            t=S1.s[..., None, None] * _mv(S1.R[..., None, :, :], d2.t)))
    dS = parts[0] if len(parts) == 1 else Sim3(*(a + b for a, b in zip(*parts)))
    return S, dS


def inverse_jvp(S: Sim3, dS: Sim3):
    """``S.inverse()`` and its tangent."""
    Si = S.inverse()
    dsi = -dS.s / (S.s * S.s)[..., None]
    dRt = dS.R.transpose(-1, -2)
    Rt = S.R.transpose(-1, -2)[..., None, :, :]
    dti = -(dsi[..., None] * _mv(S.R.transpose(-1, -2), S.t)[..., None, :]
            + Si.s[..., None, None] * (_mv(dRt, S.t[..., None, :]) + _mv(Rt, dS.t)))
    return Si, Sim3(s=dsi, R=dRt, t=dti)


def sim3_log_jvp(S: Sim3, dS: Sim3):
    """``sim3_log(S)`` (..., 7) and its derivatives along dS (..., J, 7)."""
    omega, domega = rot2rodrigues_jvp(S.R, dS.R)
    sigma = torch.log(S.s)
    dsigma = dS.s / S.s[..., None]
    W, dW = _W_jvp(omega, domega, sigma, dsigma, S.s, dS.s)
    Wi = inv3x3(W)
    upsilon = _mv(Wi, S.t)
    # d(W^-1) t + W^-1 dt = W^-1 (dt - dW upsilon)
    dupsilon = _mv(Wi[..., None, :, :], dS.t - _mv(dW, upsilon[..., None, :]))
    return (torch.cat([omega, upsilon, sigma[..., None]], -1),
            torch.cat([domega, dupsilon, dsigma[..., None]], -1))


# -- Horn's closed-form alignment (cSim3Solver.cpp:286-371) --------------------

def horn_alignment(P1: torch.Tensor, P2: torch.Tensor, fix_scale: bool = False) -> Sim3:
    """Sim3 with x1 = s R x2 + t from point sets (..., M, 3): the
    quaternion is the eigenvector of the largest eigenvalue of Horn's 4x4
    N matrix, the scale the ratio of the sets' spreads.

    q and -q give the same R, so the eigenvector's sign does not matter;
    for a degenerate set (a repeated largest eigenvalue) backends may pick
    different eigenvectors of the eigenspace, and so different rotations.
    The eigen-decomposition is ``kernels.small_eig.sym_eig``: on the card a
    kernel that a CUDA graph can capture (GP3P's lanes), on the CPU
    ``torch.linalg.eigh``."""
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
    q = sym_eig(N)[1][..., :, -1]                    # [qw, qx, qy, qz]
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
