"""The pose LM's test problem, without JAX: wall points seen by the
half-resolution in-repo rig (``config_io.load_mcs`` and ``scale_rig``,
equal to the JAX loader's rig converted), measured with pixel noise and
10% gross outliers, started from a perturbed pose. Shared by
``test_torch_optimizer.py`` (against the JAX package) and
``test_torch_pose_lm.py`` (whose card tests run where JAX is absent)."""

import functools

import numpy as np
import torch

from multicol_slam_tpu_torch.models import optimizer as topt
from multicol_slam_tpu_torch.ops.camera import img_to_world, world_to_img
from multicol_slam_tpu_torch.ops.geometry import cayley2hom, inv_se3
from multicol_slam_tpu_torch.ops.rig import mt_mc, scale_rig
from multicol_slam_tpu_torch.utils import config_io as tcio

SCALE = 0.5


@functools.lru_cache(maxsize=None)
def rig(dtype=torch.float32):
    """The in-repo rig at 377x240 in ``dtype``, on the CPU."""
    return scale_rig(tcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=dtype)[0], SCALE)


def problem(seed: int, K: int = 600):
    """(obs, X (K, 3), mt0 (6,), mt_true (6,)) in float32 on the CPU."""
    rng = np.random.default_rng(seed)
    r32 = rig()
    C = r32.n_cams
    mt_true = torch.tensor([0.02, -0.05, 0.01, 0.3, -0.1, 0.2], dtype=torch.float32)
    cam = torch.from_numpy(rng.integers(0, C, K).astype(np.int32))
    # pixels inside the image circle, lifted to 1.5-4 m along their rays
    r = rng.uniform(0, 110, K)
    a = rng.uniform(0, 2 * np.pi, K)
    uv0 = torch.from_numpy(np.stack([188 + r * np.cos(a), 120 + r * np.sin(a)], -1)
                           .astype(np.float32))
    cams = r32.cams.index(cam.long())
    ray = img_to_world(cams, uv0)
    depth = torch.from_numpy(rng.uniform(1.5, 4.0, K).astype(np.float32))
    M = mt_mc(cayley2hom(mt_true), r32.M_c)[cam.long()]          # cam -> world
    Xc = ray * depth[:, None]
    X = torch.einsum("kij,kj->ki", M[:, :3, :3], Xc) + M[:, :3, 3]
    Tc = inv_se3(M)
    uv = world_to_img(cams, torch.einsum("kij,kj->ki", Tc[:, :3, :3], X) + Tc[:, :3, 3])
    lvl = rng.integers(0, 4, K)
    noise = rng.normal(0, 0.7, (K, 2)) * (1.2 ** lvl)[:, None]
    out = rng.random(K) < 0.1
    noise[out] += rng.uniform(15, 30, (int(out.sum()), 2)) * rng.choice([-1, 1], (int(out.sum()), 2))
    obs = topt.BAObservations(
        uv=uv + torch.from_numpy(noise.astype(np.float32)),
        kf=torch.zeros(K, dtype=torch.int32), cam=cam,
        pt=torch.arange(K, dtype=torch.int32),
        inv_sigma2=torch.from_numpy((1.2 ** (-2.0 * lvl)).astype(np.float32)),
        valid=torch.from_numpy(rng.random(K) < 0.95))
    mt0 = mt_true + torch.from_numpy(
        np.r_[rng.normal(0, 0.01, 3), rng.normal(0, 0.03, 3)].astype(np.float32))
    return obs, X, mt0, mt_true


def in_dtype(obs, X, mt0, dtype):
    """The problem's floats in ``dtype``."""
    obs = topt.BAObservations(*(t.to(dtype) if t.is_floating_point() else t for t in obs))
    return obs, X.to(dtype), mt0.to(dtype)
