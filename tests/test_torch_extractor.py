"""The port's extraction (pyramid, FAST, Harris, uniform top-k, ORB) against
the JAX package on the same uint8 frames of the synthetic rig at 377x240,
4 levels, 300 features per camera, Harris ranking on.

Bars, each measured on this configuration:
  - keypoints, levels and validity: identical;
  - descriptor bits: identical (measured 0 mismatched bits over 3 frames x
    900 keypoints). Patches are integer-valued after the blur's rounding,
    so only a .5 tie in ``round`` taken in another order could flip a
    bit; none occurs here;
  - pyramid levels: within 1e-4 gray levels (measured 4.6e-5): the two
    resize matmuls sum in another order than XLA's;
  - Harris response within 1e-5 relative, IC angle within 1e-5 rad,
    bearing rays within 1e-6: float32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multicol_slam_tpu.models import extractor as jext
from multicol_slam_tpu.ops import brief as jbrief
from multicol_slam_tpu.ops import fast as jfast
from multicol_slam_tpu.ops import pyramid as jpyr
from multicol_slam_tpu_torch.models import extractor as text
from multicol_slam_tpu_torch.ops import brief as tbrief
from multicol_slam_tpu_torch.ops import fast as tfast
from multicol_slam_tpu_torch.ops import hamming as thm
from multicol_slam_tpu_torch.ops import pyramid as tpyr
from multicol_slam_tpu_torch.utils import convert

import _torchutil as U


def _image():
    _, imgs = U.frames(2)
    return imgs[1]                                   # (C, H, W) uint8


def test_pyramid_matches_jax():
    img = _image().to(torch.float32)
    got = tpyr.build_pyramid(img, U.N_LEVELS, U.SCALE_FACTOR)
    with U.f32():
        want = jax.jit(lambda x: jpyr.build_pyramid(x, U.N_LEVELS, U.SCALE_FACTOR))(
            jnp.asarray(img.numpy()))
    sizes = jpyr.level_sizes(img.shape[1], img.shape[2], U.N_LEVELS, U.SCALE_FACTOR)
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape[-2:]) == sizes[lvl]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    assert tpyr.scale_factors(8, 1.2) == jpyr.scale_factors(8, 1.2)


def test_fast_harris_nonmax_match_jax():
    img = _image().to(torch.float32)
    with U.f32():
        x = jnp.asarray(img.numpy())
        j_fast = np.asarray(jax.jit(jax.vmap(lambda a: jfast.fast_score(a, 5.0)))(x))
        j_fb = np.asarray(jax.jit(jax.vmap(
            lambda a: jfast.fast_with_fallback(a, 20.0, 5.0, 30)))(x))
        j_har = np.asarray(jax.jit(jax.vmap(jfast.harris_score))(x))
    np.testing.assert_array_equal(tfast.fast_score(img, 5.0).numpy(), j_fast)
    t_fb = tfast.fast_with_fallback(img, 20.0, 5.0, 30)
    np.testing.assert_array_equal(t_fb.numpy(), j_fb)
    assert (t_fb > 0).sum() > 1000
    np.testing.assert_allclose(tfast.harris_score(img).numpy(), j_har,
                               rtol=1e-5, atol=1e-12)


def test_uniform_topk_matches_jax():
    """Same score map (FAST with fallback, integer scores: many ties) and
    mask into both: the same tiles in the same order."""
    img = _image().to(torch.float32)
    score = tfast.fast_with_fallback(img, 20.0, 5.0, 30)
    mask = torch.from_numpy(U.masks_by_level()[0] > 0)
    k, bucket = 120, 16
    ty, tr, tv = tfast.select_uniform_topk(score, mask, k=k, bucket=bucket,
                                           border=26)
    with U.f32():
        jy, jr, jv = jax.jit(jax.vmap(lambda s, m: jfast.select_uniform_topk(
            s, m, k=k, bucket=bucket, border=26)))(
            jnp.asarray(score.numpy()), jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_orb_pieces_match_jax():
    img = _image().to(torch.float32)
    pat = tbrief.make_pattern(256)
    np.testing.assert_array_equal(pat, jbrief.make_pattern(256))
    rng = np.random.default_rng(0)
    yx = np.stack([rng.integers(30, 210, (3, 200)), rng.integers(30, 347, (3, 200))],
                  -1).astype(np.int32)
    r = tbrief.PATCH_R + 2
    t_raw = tbrief.extract_patches(img, torch.from_numpy(yx), r)
    t_ang = tbrief.ic_angle_patches(t_raw)
    t_blur = torch.round(tbrief.blur_patches_valid(t_raw))
    with U.f32():
        one = jax.jit(jax.vmap(lambda a, p: jbrief.extract_patches(a, p, r)))
        j_raw = one(jnp.asarray(img.numpy()), jnp.asarray(yx))
        j_ang = jax.jit(jax.vmap(jbrief.ic_angle_patches))(j_raw)
        j_blur = jax.jit(jax.vmap(lambda p: jnp.round(jbrief.blur_patches_valid(p))))(j_raw)
        # descriptors from the SAME blurred patches and angles in both
        j_desc = jax.jit(jax.vmap(lambda p, a: jbrief.orb_from_patches(
            p, a, jnp.asarray(pat))))(j_blur, jnp.asarray(t_ang.numpy()))
    np.testing.assert_array_equal(t_raw.numpy(), np.asarray(j_raw))
    np.testing.assert_allclose(t_ang.numpy(), np.asarray(j_ang), atol=1e-5)
    np.testing.assert_array_equal(t_blur.numpy(), np.asarray(j_blur))
    t_desc = tbrief.orb_from_patches(t_blur, t_ang, torch.from_numpy(pat))
    np.testing.assert_array_equal(t_desc.numpy().view(np.uint32), np.asarray(j_desc))


def test_extractor_matches_jax():
    assert (text.features_per_level(400, 8, 1.2)
            == jext.features_per_level(400, 8, 1.2))
    jx, tx = U.extractors()
    _, imgs = U.frames(3)
    n_valid = 0
    for img in imgs:
        tf = tx(img)
        with U.f32():
            jf = convert.features_from_numpy(jx(jnp.asarray(img.numpy())))
        for name in ("xy", "level", "valid", "desc_mask"):
            assert torch.equal(getattr(tf, name), getattr(jf, name)), name
        np.testing.assert_allclose(tf.response.numpy(), jf.response.numpy(),
                                   rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(tf.angle.numpy(), jf.angle.numpy(), atol=1e-5)
        np.testing.assert_allclose(tf.ray.numpy(), jf.ray.numpy(), atol=1e-6)
        valid = jf.valid
        assert torch.equal(thm.unpack_bits_u32(tf.desc)[valid],
                           thm.unpack_bits_u32(jf.desc)[valid])
        n_valid += int(valid.sum())
    assert n_valid > 0.9 * 3 * 3 * U.N_FEATURES
