"""Shared set-up for the PyTorch port's tests (tests/test_torch_*.py).

Every test feeds the same inputs to the JAX package (the reference) and
to ``multicol_slam_tpu_torch``: the in-repo synthetic rig at half
resolution (377x240), 4 pyramid levels and 300 features per camera, the
shape tests/_sysutil.py gives the JAX system tests. The JAX side runs in
float32 under ``jax.enable_x64(False)``, since conftest.py turns x64 on
for the golden geometry tests. Frames are rendered once by the port's
renderer and rounded to uint8, so both packages see the same pixels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multicol_slam_tpu.models import extractor as jext
from multicol_slam_tpu.ops import camera as jcam
from multicol_slam_tpu.ops import rig as jrig
from multicol_slam_tpu.utils import config_io as jcio
from multicol_slam_tpu_torch.models import extractor as text
from multicol_slam_tpu_torch.utils import config_io as tcio
from multicol_slam_tpu_torch.utils import convert
from multicol_slam_tpu_torch.utils import synthetic as tsyn

SCALE = 0.5
N_LEVELS = 4
N_FEATURES = 300
SCALE_FACTOR = 1.2
TH_MOTION = 15.0
TH_LOCAL = 3.0


@functools.lru_cache(maxsize=None)
def jax_rig():
    """The in-repo rig through the JAX loader, scaled to 377x240 (numpy
    float32 fields)."""
    full, _ = jcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=np.float32)
    return jrig.scale_rig(full, SCALE)


@functools.lru_cache(maxsize=None)
def torch_rig():
    return convert.rig_from_numpy(jax_rig())


def image_hw():
    r = jax_rig()
    return int(float(r.cams.height[0])), int(float(r.cams.width[0]))


@functools.lru_cache(maxsize=None)
def masks_by_level():
    """Per level, (C, H_l, W_l) uint8 extraction masks (JAX package)."""
    r = jax_rig()
    h, w = image_hw()
    per_cam = [jcam.make_extraction_masks(float(r.cams.u0[c]),
                                          float(r.cams.v0[c]), w, h,
                                          N_LEVELS, SCALE_FACTOR)
               for c in range(r.n_cams)]
    return [np.stack([m[lvl] for m in per_cam]) for lvl in range(N_LEVELS)]


def _extractor_kwargs():
    # Harris ranking on: the default SlamSettings (score_harris=True)
    return dict(n_features=N_FEATURES, n_levels=N_LEVELS, use_harris=True)


@functools.lru_cache(maxsize=None)
def extractors():
    """(JAX extract, port extract) at the shared configuration."""
    jx = jext.make_extractor(jext.ExtractorConfig(**_extractor_kwargs()),
                             jax_rig().cams, masks_by_level(), image_hw())
    tx = text.make_extractor(text.ExtractorConfig(**_extractor_kwargs()),
                             torch_rig().cams, masks_by_level(), image_hw())
    return jx, tx


@functools.lru_cache(maxsize=None)
def frames(n: int):
    """(ground-truth poses (n, 4, 4), uint8 frames (n, C, H, W)) of the
    first n frames of the 100-frame arc test_e2e_slice.py tracks."""
    gt = tsyn.smooth_trajectory(100, radius=0.6)[:n]
    render = tsyn.make_renderer(torch_rig())
    imgs = render(torch.tensor(gt, dtype=torch.float32))
    return gt, torch.round(imgs).to(torch.uint8)


def jax_features(feats):
    """Port Features -> the JAX package's Features (same bits)."""
    return jext.Features(**{k: jnp.asarray(v) for k, v in
                            convert.features_to_numpy(feats).items()})


def to_jax(t: torch.Tensor):
    """A port tensor as a JAX array of the same dtype."""
    return jnp.asarray(t.detach().cpu().numpy())


def to_jax_u32(t: torch.Tensor):
    """Packed int32 words as the JAX package's uint32."""
    return jnp.asarray(t.detach().cpu().numpy().view(np.uint32))


def pose_error(mt_a, mt_b):
    """(translation m, rotation deg) between two cayley+t 6-vectors."""
    from multicol_slam_tpu_torch.ops.geometry import cayley2hom
    A = cayley2hom(torch.tensor(np.array(mt_a), dtype=torch.float64))
    B = cayley2hom(torch.tensor(np.array(mt_b), dtype=torch.float64))
    return pose_error_hom(A.numpy(), B.numpy())


def pose_error_hom(A, B):
    t = float(np.linalg.norm(A[:3, 3] - B[:3, 3]))
    c = (np.trace(A[:3, :3].T @ B[:3, :3]) - 1.0) / 2.0
    return t, float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def f32():
    """The JAX package in float32 (the production dtype)."""
    return jax.enable_x64(False)
