"""SE3 / Cayley / polynomial primitives on tensors.

Port of ``multicol_slam_tpu/ops/geometry.py`` (reference misc.h:115-224):
the same formulas in the same evaluation order, batched over leading
dimensions. Poses are 4x4 local-to-world matrices; the minimal 6-vector
is ``[c1 c2 c3 t1 t2 t3]`` with the rotation in Cayley form.
"""

from __future__ import annotations

import torch


def cayley2rot(c: torch.Tensor) -> torch.Tensor:
    """Cayley 3-vector (..., 3) -> rotation (..., 3, 3) (misc.h:137-160)."""
    c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2]
    c1s, c2s, c3s = c1 * c1, c2 * c2, c3 * c3
    scale = 1.0 + c1s + c2s + c3s
    R = torch.stack(
        [
            torch.stack([1.0 + c1s - c2s - c3s, 2.0 * (c1 * c2 - c3),
                         2.0 * (c1 * c3 + c2)], -1),
            torch.stack([2.0 * (c1 * c2 + c3), 1.0 - c1s + c2s - c3s,
                         2.0 * (c2 * c3 - c1)], -1),
            torch.stack([2.0 * (c1 * c3 - c2), 2.0 * (c2 * c3 + c1),
                         1.0 - c1s - c2s + c3s], -1),
        ],
        -2,
    )
    return R / scale[..., None, None]


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse via the adjugate, batched."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], -1),
            torch.stack([c10, c11, c12], -1),
            torch.stack([c20, c21, c22], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def rot2cayley(R: torch.Tensor) -> torch.Tensor:
    """Rotation -> Cayley 3-vector, C = (R-I)(R+I)^-1 (misc.h:169-181)."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    C = (R - eye) @ inv3x3(R + eye)
    return torch.stack([-C[..., 1, 2], C[..., 0, 2], -C[..., 0, 1]], -1)


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    """[0 0 0 1] rows for (..., 3, 4) ``top``, made on its device (a tensor
    built from a Python list would be a host-to-device copy, which waits
    for the device's stream)."""
    eye = torch.eye(4, dtype=top.dtype, device=top.device)
    return eye[3:].expand(top.shape[:-2] + (1, 4))


def cayley2hom(c6: torch.Tensor) -> torch.Tensor:
    """Minimal 6-vector -> 4x4 homogeneous (misc.h:207-224)."""
    R = cayley2rot(c6[..., :3])
    t = c6[..., 3:6]
    top = torch.cat([R, t[..., :, None]], -1)
    return torch.cat([top, _bottom_row(top)], -2)


def hom2cayley(M: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous -> minimal 6-vector (misc.h:188-201)."""
    return torch.cat([rot2cayley(M[..., :3, :3]), M[..., :3, 3]], -1)


def inv_se3(M: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of a 4x4 SE3 matrix (cConverter.h invMat)."""
    R = M[..., :3, :3]
    t = M[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, t)
    top = torch.cat([Rt, ti[..., :, None]], -1)
    return torch.cat([top, _bottom_row(top)], -2)


def horner(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_i coeffs[..., i] * x^i, lowest order first (misc.h:115-122)."""
    res = torch.zeros_like(x) + coeffs[..., -1]
    for i in range(coeffs.shape[-1] - 2, -1, -1):
        res = res * x + coeffs[..., i]
    return res
