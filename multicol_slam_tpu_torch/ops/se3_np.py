"""Host-side numpy twins of the SE3/Cayley helpers in :mod:`.geometry`.

A copy of ``multicol_slam_tpu/ops/se3_np.py`` (numpy only). The tracking
and mapping host code manipulates single 4x4 poses (motion model,
keyframe bookkeeping, trajectory export); the tensor versions in
``geometry.py`` are written for device work, and calling them from host
code would launch every operation as its own tiny kernel.

Behavioral spec is identical to the reference (misc.h:132-224,
cConverter.h invMat). Keep the two packages' copies in sync.
"""

from __future__ import annotations

import numpy as np


def cayley2rot(c: np.ndarray) -> np.ndarray:
    """Cayley 3-vector -> 3x3 rotation (misc.h:137-160). Batched."""
    c = np.asarray(c, np.float64)
    c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2]
    c1s, c2s, c3s = c1 * c1, c2 * c2, c3 * c3
    scale = 1.0 + c1s + c2s + c3s
    R = np.stack(
        [
            np.stack([1.0 + c1s - c2s - c3s, 2.0 * (c1 * c2 - c3), 2.0 * (c1 * c3 + c2)], -1),
            np.stack([2.0 * (c1 * c2 + c3), 1.0 - c1s + c2s - c3s, 2.0 * (c2 * c3 - c1)], -1),
            np.stack([2.0 * (c1 * c3 - c2), 2.0 * (c2 * c3 + c1), 1.0 - c1s - c2s + c3s], -1),
        ],
        -2,
    )
    return R / scale[..., None, None]


def rot2cayley(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> Cayley 3-vector: C = (R-I)(R+I)^-1 (misc.h:169-181)."""
    R = np.asarray(R, np.float64)
    eye = np.eye(3)
    C = (R - eye) @ np.linalg.inv(R + eye)
    return np.stack([-C[..., 1, 2], C[..., 0, 2], -C[..., 0, 1]], -1)


def cayley2hom(c6: np.ndarray) -> np.ndarray:
    """Minimal 6-vector [cayley(3), t(3)] -> 4x4 homogeneous (misc.h:207-224)."""
    c6 = np.asarray(c6, np.float64)
    R = cayley2rot(c6[..., :3])
    t = c6[..., 3:6]
    M = np.zeros(c6.shape[:-1] + (4, 4))
    M[..., :3, :3] = R
    M[..., :3, 3] = t
    M[..., 3, 3] = 1.0
    return M


def hom2cayley(M: np.ndarray) -> np.ndarray:
    """4x4 homogeneous -> minimal 6-vector (misc.h:188-201)."""
    M = np.asarray(M, np.float64)
    return np.concatenate([rot2cayley(M[..., :3, :3]), M[..., :3, 3]], -1)


def inv_se3(M: np.ndarray) -> np.ndarray:
    """Analytic inverse of a 4x4 SE3 matrix (cConverter.h invMat). Batched."""
    M = np.asarray(M, np.float64)
    R = M[..., :3, :3]
    t = M[..., :3, 3]
    Rt = np.swapaxes(R, -1, -2)
    out = np.zeros_like(M)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, t)
    out[..., 3, 3] = 1.0
    return out


def skew(t: np.ndarray) -> np.ndarray:
    """3-vector -> 3x3 skew matrix (misc.h Skew). Batched."""
    t = np.asarray(t, np.float64)
    z = np.zeros_like(t[..., 0])
    return np.stack(
        [
            np.stack([z, -t[..., 2], t[..., 1]], -1),
            np.stack([t[..., 2], z, -t[..., 0]], -1),
            np.stack([-t[..., 1], t[..., 0], z], -1),
        ],
        -2,
    )


def essential_from_relpose(R12: np.ndarray, t12: np.ndarray) -> np.ndarray:
    """E = [t12/|t12|]_x R12 (misc.cpp:71-85)."""
    t12 = np.asarray(t12, np.float64)
    tn = t12 / np.linalg.norm(t12, axis=-1, keepdims=True)
    return skew(tn) @ np.asarray(R12, np.float64)


def essential_from_poses(T1: np.ndarray, T2: np.ndarray) -> np.ndarray:
    """E12 from two world-to-camera poses (misc.cpp:71-85): R12 = R1 R2^T,
    t12 = -R12 t2 + t1 is camera 2's pose in camera 1's frame, so
    ``ray1^T E12 ray2 = 0`` for corresponding rays."""
    T1 = np.asarray(T1, np.float64)
    T2 = np.asarray(T2, np.float64)
    R1, R2 = T1[..., :3, :3], T2[..., :3, :3]
    t1, t2 = T1[..., :3, 3], T2[..., :3, 3]
    R12 = R1 @ np.swapaxes(R2, -1, -2)
    t12 = -np.einsum("...ij,...j->...i", R12, t2) + t1
    return essential_from_relpose(R12, t12)


def triangulate_midpoint(t12: np.ndarray, R12: np.ndarray,
                         v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Midpoint triangulation of two bearing-ray bundles (misc.cpp:26-50).

    Same math as geometry.triangulate_midpoint; batched over the leading
    dims of v1/v2 with a single (R12, t12).
    """
    t12 = np.asarray(t12, np.float64)
    R12 = np.asarray(R12, np.float64)
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    f2 = v2 @ R12.T
    b0 = v1 @ t12
    b1 = f2 @ t12
    A00 = (v1 * v1).sum(-1)
    A10 = (v1 * f2).sum(-1)
    A11 = -(f2 * f2).sum(-1)
    det = A00 * A11 + A10 * A10
    det = np.where(np.abs(det) < 1e-30, 1e-30, det)
    l0 = (A11 * b0 + A10 * b1) / det
    l1 = (-A10 * b0 + A00 * b1) / det
    xm = l0[..., None] * v1
    xn = t12 + l1[..., None] * f2
    return (xm + xn) * 0.5


def horner(coeffs: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Polynomial evaluation, lowest order first (misc.h:115-122)."""
    coeffs = np.asarray(coeffs, np.float64)
    res = np.zeros_like(x) + coeffs[..., -1]
    for i in range(coeffs.shape[-1] - 2, -1, -1):
        res = res * x + coeffs[..., i]
    return res


def world_to_img(cam, X: np.ndarray) -> np.ndarray:
    """Camera-frame point (..., 3) -> pixel (..., 2)
    (cam_model_omni.cpp:146-161). ``cam`` is a single-camera
    :class:`..ops.camera.CameraModel`; its fields are converted to numpy.
    """
    X = np.asarray(X, np.float64)
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    norm = np.sqrt(x * x + y * y)
    norm = np.where(norm == 0.0, 1e-14, norm)
    theta = np.arctan2(-z, norm)
    rho = horner(np.asarray(cam.inv_poly, np.float64), theta)
    uu = x / norm * rho
    vv = y / norm * rho
    u = uu * float(cam.c) + vv * float(cam.d) + float(cam.u0)
    v = uu * float(cam.e) + vv + float(cam.v0)
    return np.stack([u, v], -1)


def rot2quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion [qx, qy, qz, qw], Shepperd's method.

    Single 3x3 only (trajectory export path, cConverter.h:41-91).
    """
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    if tr > 0.0:
        s = np.sqrt(max(tr + 1.0, 1e-12)) * 2.0
        q = [(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s]
    elif m00 >= m11 and m00 >= m22:
        s = np.sqrt(max(1.0 + m00 - m11 - m22, 1e-12)) * 2.0
        q = [0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s]
    elif m11 >= m22:
        s = np.sqrt(max(1.0 + m11 - m00 - m22, 1e-12)) * 2.0
        q = [(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s]
    else:
        s = np.sqrt(max(1.0 + m22 - m00 - m11, 1e-12)) * 2.0
        q = [(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)
