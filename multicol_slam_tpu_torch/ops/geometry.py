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


def cayley_rot_grads(c: torch.Tensor) -> torch.Tensor:
    """dR/dc_m (..., 3, 3, 3), m first, of R = cayley2rot(c) for c (..., 3):
    R = N / s with N = (1 - c.c) I + 2 c c^T + 2 [c]x and s = 1 + c.c."""
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    s = 1.0 + (c * c).sum(-1)
    cm = c[..., :, None, None]                  # c_m, broadcast over (i, j)
    dN = (-2.0 * cm * eye + 2.0 * eye[:, :, None] * c[..., None, None, :]
          + 2.0 * c[..., None, :, None] * eye[:, None, :] + 2.0 * skew(eye))
    return (dN - 2.0 * cm * cayley2rot(c)[..., None, :, :]) / s[..., None, None, None]


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


def rodrigues2rot(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation (..., 3, 3) (the exp map, with the
    Taylor forms below 1e-8 rad)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-32)
    K = skew(w)
    K2 = K @ K
    big = theta2 > 1e-16
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def rot2rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3) (the log map)."""
    tr = torch.einsum("...ii->...", R)
    theta = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    big = theta > 1e-6
    s = torch.where(big, theta / (2.0 * torch.sin(torch.where(big, theta, torch.ones_like(theta)))),
                    0.5 * torch.ones_like(theta))
    return v * s[..., None]


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


def skew(t: torch.Tensor) -> torch.Tensor:
    """3-vector (..., 3) -> 3x3 skew matrix (misc.h Skew)."""
    z = torch.zeros_like(t[..., 0])
    return torch.stack(
        [
            torch.stack([z, -t[..., 2], t[..., 1]], -1),
            torch.stack([t[..., 2], z, -t[..., 0]], -1),
            torch.stack([-t[..., 1], t[..., 0], z], -1),
        ],
        -2,
    )


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


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def triangulate_midpoint(t12: torch.Tensor, R12: torch.Tensor,
                         v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Midpoint triangulation of two bearing rays (misc.cpp:26-50): ray
    ``v1`` from camera 1 at the origin, ``v2`` from camera 2 with pose
    (R12, t12) in camera 1's frame. Returns the point in camera 1's
    frame; batched over the leading dims of v1 / v2, with (R12, t12)
    broadcasting against them."""
    f2 = torch.einsum("...ij,...j->...i", R12, v2)
    b0 = _dot(t12, v1)
    b1 = _dot(t12, f2)
    A00 = _dot(v1, v1)
    A10 = _dot(v1, f2)
    A11 = -_dot(f2, f2)
    # A = [[A00, -A10], [A10, A11]]; lambda = A^-1 b (2x2 closed form)
    det = A00 * A11 + A10 * A10
    det = torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    l0 = (A11 * b0 + A10 * b1) / det
    l1 = (-A10 * b0 + A00 * b1) / det
    xm = l0[..., None] * v1
    xn = t12 + l1[..., None] * f2
    return (xm + xn) * 0.5


def essential_from_relpose(R12: torch.Tensor, t12: torch.Tensor) -> torch.Tensor:
    """E = [t12/|t12|]_x R12 (misc.h ComputeE(Trel), misc.cpp:71-85)."""
    tn = t12 / torch.linalg.norm(t12, dim=-1, keepdim=True)
    return skew(tn) @ R12


def essential_from_poses(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """E12 from two world-to-camera poses (4, 4) (misc.cpp:71-85): R12 =
    R1 R2^T, t12 = -R12 t2 + t1 is camera 2's pose in camera 1's frame, so
    ``ray1^T E12 ray2 = 0`` for corresponding rays (use with
    ``epipolar_distance_sq``)."""
    R1, R2 = T1[..., :3, :3], T2[..., :3, :3]
    t1, t2 = T1[..., :3, 3], T2[..., :3, 3]
    R12 = R1 @ R2.transpose(-1, -2)
    t12 = -torch.einsum("...ij,...j->...i", R12, t2) + t1
    return essential_from_relpose(R12, t12)


def epipolar_distance_sq(ray1: torch.Tensor, ray2: torch.Tensor,
                         E12: torch.Tensor) -> torch.Tensor:
    """Squared Sampson-like epipolar distance on bearing rays,
    (ray1^T E12 ray2)^2 / (|E12 ray2|^2 + |E12^T ray1|^2), with the JAX
    package's consistent pairing (see its ``epipolar_distance_sq`` for
    the reference's mixed-pose deviation). +inf where the denominator
    vanishes."""
    Ex2 = torch.einsum("...ij,...j->...i", E12, ray2)
    Etx1 = torch.einsum("...ji,...j->...i", E12, ray1)
    nom = _dot(ray1, Ex2)
    den = _dot(Ex2, Ex2) + _dot(Etx1, Etx1)
    pos = den > 0.0
    return torch.where(pos, nom * nom / torch.where(pos, den, torch.ones_like(den)),
                       torch.full_like(den, float("inf")))


def check_dist_epipolar_line(ray1: torch.Tensor, ray2: torch.Tensor, E12: torch.Tensor,
                             thresh: float = 1e-2) -> torch.Tensor:
    """Boolean epipolar gate of triangulation matching (misc.cpp:53-69)."""
    return epipolar_distance_sq(ray1, ray2, E12) < thresh


def rot2quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> quaternions [qx, qy, qz, qw]
    (..., 4), Shepperd's method (cConverter.h:41-91): the w case where
    the trace is positive, else the case of the largest diagonal entry."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2.0

    s = root(tr + 1.0)
    qw = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s], -1)
    s = root(1.0 + m00 - m11 - m22)
    qx = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s], -1)
    s = root(1.0 + m11 - m00 - m22)
    qy = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s], -1)
    s = root(1.0 + m22 - m00 - m11)
    qz = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s], -1)
    use_w = tr > 0.0
    use_x = ~use_w & (m00 >= m11) & (m00 >= m22)
    use_y = ~use_w & ~use_x & (m11 >= m22)
    q = torch.where(use_w[..., None], qw, torch.where(
        use_x[..., None], qx, torch.where(use_y[..., None], qy, qz)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
