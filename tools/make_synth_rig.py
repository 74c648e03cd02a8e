"""Write the synthetic 3-camera fisheye rig calibration (numpy only).

Usage:
    python tools/make_synth_rig.py [out_dir]

Default out_dir: multicol_slam_tpu_torch/data/synth_rig3. Writes
``MultiCamSys_Calibration.yaml`` and ``InteriorOrientationFisheye{0,1,2}.yaml``
with the OpenCV-YAML keys that both packages' ``config_io.load_mcs`` parse.

The rig: three 754x480 Scaramuzza cameras yawed 120 degrees apart on a
10 cm ring. The forward polynomial a0..a4 (a0 < 0) is a least-squares fit
of an equidistant fisheye whose mirror-mask radius v0+22 lies 95 degrees
off-axis; the 12-term inverse polynomial is fitted to the forward one by
least squares over the same radii, the way the OCamCalib toolbox derives
it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

WIDTH, HEIGHT = 754, 480
U0, V0 = 376.8, 240.3
AFFINE = dict(c=0.9998, d=0.0002, e=-0.0003)
MASK_ANGLE_DEG = 95.0          # off-axis angle at the mask radius v0 + 22
N_INV = 12
RING_RADIUS = 0.10             # m
N_CAMS = 3


def forward_poly() -> np.ndarray:
    """a0..a4 of z = -f(rho): equidistant angle = rho / f_eq, so the
    ray (sin, cos) gives f(rho) = -rho * cot(rho / f_eq)."""
    r_mask = V0 + 22.0
    f_eq = r_mask / np.deg2rad(MASK_ANGLE_DEG)
    rho = np.linspace(1.0, r_mask + 30.0, 400)
    f = -rho / np.tan(rho / f_eq)
    A = np.stack([rho ** i for i in range(5)], 1)
    return np.linalg.lstsq(A, f, rcond=None)[0]


def inverse_poly(a: np.ndarray) -> np.ndarray:
    """12 coefficients of rho = g(theta), theta = atan2(-z, |xy|) as in
    world_to_img, fitted over the radii the images cover."""
    rho = np.linspace(0.0, np.hypot(WIDTH, HEIGHT) / 2 + 10.0, 2000)
    z = -np.polyval(a[::-1], rho)
    theta = np.arctan2(-z, rho)
    A = np.stack([theta ** i for i in range(N_INV)], 1)
    return np.linalg.lstsq(A, rho, rcond=None)[0]


def _fmt(x: float) -> str:
    return repr(float(x))


def write(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    a = forward_poly()
    inv = inverse_poly(a)
    for c in range(N_CAMS):
        lines = ["%YAML:1.0", "",
                 "# synthetic equidistant-like fisheye, written by "
                 "tools/make_synth_rig.py",
                 f"Camera.Iw: {WIDTH}", f"Camera.Ih: {HEIGHT}",
                 f"Camera.nrpol: {len(a)}", f"Camera.nrinvpol: {len(inv)}"]
        lines += [f"Camera.a{i}: {_fmt(v)}" for i, v in enumerate(a)]
        lines += [f"Camera.pol{i}: {_fmt(v)}" for i, v in enumerate(inv)]
        lines += [f"Camera.c: {AFFINE['c']}", f"Camera.d: {AFFINE['d']}",
                  f"Camera.e: {AFFINE['e']}",
                  f"Camera.u0: {U0}", f"Camera.v0: {V0}",
                  "Camera.mirrorMask: 1"]
        with open(os.path.join(out_dir, f"InteriorOrientationFisheye{c}.yaml"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
    lines = ["%YAML:1.0", "",
             "# cameras yawed 120 deg apart on a 10 cm ring; cayley yaw "
             "tan(ang/2)",
             f"CameraSystem.nrCams: {N_CAMS}"]
    for c in range(N_CAMS):
        ang = 2.0 * np.pi * c / N_CAMS
        m = [0.0, np.tan(ang / 2.0), 0.0,
             RING_RADIUS * np.sin(ang), 0.0, RING_RADIUS * np.cos(ang)]
        lines += [f"CameraSystem.cam{c + 1}_{p + 1}: {_fmt(v)}"
                  for p, v in enumerate(m)]
    with open(os.path.join(out_dir, "MultiCamSys_Calibration.yaml"), "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    default = os.path.join(here, "..", "multicol_slam_tpu_torch", "data",
                           "synth_rig3")
    write(sys.argv[1] if len(sys.argv) > 1 else default)
