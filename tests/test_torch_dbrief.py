"""The port's extractor options against the JAX package: the camera's
undistort/distort pair, the AGAST detector rings and the distortion-aware
descriptors dBRIEF and mdBRIEF, on the in-repo rig (full width for the
camera, the half-width frames of ``_torchutil`` for the descriptors).

Bars, each with what was measured on this configuration:
  - ``round_to_int32``: XLA's cast exactly (NaN to 0, saturation);
  - undistort_points in float32 within 2e-5 relative below 89 and above
    91 degrees off axis (measured 1.0e-5), 2e-3 between (measured 7.3e-4:
    the ideal plane divides by z, which crosses 0 at 90 degrees);
    distort_points within 1e-4 px (measured 6.1e-5, one float32 ulp at
    500-1000 px); in float64 within 1e-13 and 1e-10 relative (measured
    1.3e-14 and 4.1e-12) and 1e-9 px (measured 1.1e-13);
  - FAST/AGAST scores: identical for every ring (integer arithmetic);
  - distorted pattern offsets: at least 99.99% of the pattern points
    equal (measured 460,791 of 460,800 on the frame below, the other 9 in
    6 keypoints at 45-102 degrees off axis: the float32 atan2/cos/sin of
    the two libraries differ in the last ulp, and a point within an ulp
    of .5 then rounds the other way);
  - given the same offsets, dBRIEF and mdBRIEF bits identical;
  - the whole-image compute_* functions: ORB bits identical, dBRIEF and
    mdBRIEF descriptor and mask bits within 1e-4 of the bits (measured 0
    descriptor bits and 1 mask bit in 74,496, from the offsets above).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.ops import brief as jbrief
from multicol_slam_tpu.ops import camera as jcam
from multicol_slam_tpu.ops import fast as jfast
from multicol_slam_tpu.ops import pyramid as jpyr
from multicol_slam_tpu.utils import config_io as jcio
from multicol_slam_tpu_torch.ops import brief as tbrief
from multicol_slam_tpu_torch.ops import camera as tcam
from multicol_slam_tpu_torch.ops import fast as tfast
from multicol_slam_tpu_torch.ops import hamming as thm
from multicol_slam_tpu_torch.utils import config_io as tcio

import _torchutil as U

MASKS = ("fast_9_16", "agast_7_12", "agast_5_8")
MIN_OFFSET_AGREEMENT = 0.9999
MAX_BIT_DIFF = 1e-4
# undistort_points relative error off and within 1 degree of 90 degrees
# off axis, distort_points error in px
UNDISTORT_BARS = {np.float32: (2e-5, 2e-3, 1e-4), np.float64: (1e-13, 1e-10, 1e-9)}


def test_round_to_int32_is_xlas_cast():
    x = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.5, -2.5, 3.5, -0.5,
                  2147483520.0, 2 ** 31, -2 ** 31, -2147483904.0], np.float32)
    with U.f32():
        want = np.asarray(jnp.round(jnp.asarray(x)).astype(jnp.int32))
    got = tbrief.round_to_int32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:5], [0, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 1, -2 ** 31])


def _off_axis_pixels(cams, dtype, n=2000, seed=0):
    """(C, n, 2) pixels at radii 0-300 px around each principal point:
    inside the mirror mask (95 degrees) and past 90 degrees."""
    rng = np.random.default_rng(seed)
    u0, v0 = np.asarray(cams.u0, np.float64), np.asarray(cams.v0, np.float64)
    rad = rng.uniform(0, 300, (len(u0), n))
    th = rng.uniform(0, 2 * np.pi, (len(u0), n))
    return np.stack([u0[:, None] + rad * np.cos(th), v0[:, None] + rad * np.sin(th)],
                    -1).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_undistort_and_distort_points_match_jax(dtype):
    full, _ = jcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=dtype)
    cams = full.cams
    uv = _off_axis_pixels(cams, dtype)
    with jax.enable_x64(dtype == np.float64):
        jc = jax.tree.map(lambda x: jnp.asarray(x)[:, None], cams)
        j_und = np.asarray(jax.jit(lambda cm, p: jcam.undistort_points(cm, p, cm.p1[..., None]))(
            jc, jnp.asarray(uv)))
        j_dist = np.asarray(jax.jit(jcam.distort_points)(jc, jnp.asarray(j_und)))
    tc = tcam.CameraModel(*(torch.from_numpy(np.array(f)) for f in cams)).expand(1)
    assert torch.equal(tc.p1, tc.poly[..., 0])
    t_und = tcam.undistort_points(tc, torch.from_numpy(uv), tc.p1[..., None]).numpy()
    t_dist = tcam.distort_points(tc, torch.from_numpy(j_und.copy())).numpy()
    assert np.isfinite(t_und).all() and np.isfinite(j_und).all()

    ray = tcam.img_to_world(tc, torch.from_numpy(uv)).numpy()
    angle = np.degrees(np.arccos(np.clip(ray[..., 2], -1, 1)))
    near_90 = np.abs(angle - 90) < 1
    assert near_90.any() and (angle > 95).any()
    rel = np.abs(t_und - j_und).max(-1) / np.maximum(1, np.abs(j_und).max(-1))
    rel_off, rel_near, px = UNDISTORT_BARS[dtype]
    assert rel[~near_90].max() <= rel_off and rel[near_90].max() <= rel_near
    assert np.abs(t_dist - j_dist).max() <= px
    # the round trip: back to the pixel within the inverse poly's fit
    # (5.3e-3 px measured in float64) inside 89 degrees; past 90 degrees the
    # ideal point is the antipode's (the reference's quirk), in both packages
    t_back = tcam.distort_points(tc, torch.from_numpy(t_und)).numpy()
    inside = angle < 89
    assert np.abs(t_back - uv)[inside].max() <= 1e-2
    assert (np.abs(t_back - uv).max(-1)[angle > 91] > 100).all()
    np.testing.assert_allclose(t_back[~near_90], j_dist[~near_90], atol=1e-2)


def _image():
    return U.frames(2)[1][1].to(torch.float32)       # (C, H, W)


@pytest.mark.parametrize("mask", MASKS)
def test_fast_and_agast_scores_match_jax(mask):
    img = _image()
    with U.f32():
        x = jnp.asarray(img.numpy())
        j_score = np.asarray(jax.jit(jax.vmap(lambda a: jfast.fast_score(a, 5.0, mask)))(x))
        j_fb = np.asarray(jax.jit(jax.vmap(
            lambda a: jfast.fast_with_fallback(a, 20.0, 5.0, 30, mask)))(x))
    np.testing.assert_array_equal(tfast.fast_score(img, 5.0, mask).numpy(), j_score)
    t_fb = tfast.fast_with_fallback(img, 20.0, 5.0, 30, mask)
    np.testing.assert_array_equal(t_fb.numpy(), j_fb)
    assert (t_fb > 0).sum() > 1000


def _corner_image(h=64, w=64, cx=32, cy=32):
    """tests/test_extraction.py's bright square on a dark background."""
    img = np.full((h, w), 30.0, np.float32)
    img[cy - 8:cy + 8, cx - 8:cx + 8] = 200.0
    return torch.from_numpy(img)


@pytest.mark.parametrize("mask", MASKS)
def test_agast_masks_detect_corners(mask):
    """The port's test_extraction.py::test_agast_masks_detect_corners."""
    assert int((tfast.fast_score(_corner_image(), 20.0, mask) > 0).sum()) >= 4


@pytest.mark.parametrize("mask", MASKS)
def test_agast_flat_no_corners(mask):
    """The port's test_extraction.py::test_agast_flat_no_corners."""
    assert float(tfast.fast_score(torch.full((64, 64), 100.0), 10.0, mask).max()) == 0.0


def test_mdbrief_mask_flat_region_stable():
    """The port's test_extraction.py::test_mdbrief_mask_flat_region_stable:
    in a flat region every test is degenerate but stable (equal values
    give bit 0 at every rotation)."""
    full = tcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=torch.float64)[0]
    cam0 = full.cams.index(0).expand(2)
    img = torch.full((1, 480, 754), 100.0)
    yx = torch.tensor([[[240, 377]]], dtype=torch.int32)
    pat = torch.from_numpy(tbrief.make_pattern(256))
    desc, mask = tbrief.compute_mdbrief(img, yx, torch.zeros(1, 1), torch.zeros(1, 1, 2),
                                        cam0, pat)
    assert int(desc.sum()) == 0
    assert torch.equal(mask, torch.full((1, 1, 8), -1, dtype=torch.int32))


@pytest.fixture(scope="module")
def keypoints():
    """The JAX extractor's keypoints, IC angles and undistorted points on one
    half-width frame (3 cameras x 300 slots) and its blurred level-0 image,
    as numpy arrays."""
    jx, _ = U.extractors()
    img = _image()
    cams = U.jax_rig().cams
    with U.f32():
        f = jx(jnp.asarray(img.numpy()))
        jc = jax.tree.map(lambda x: jnp.asarray(x)[:, None], cams)
        und = jax.jit(lambda cm, p: jcam.undistort_points(cm, p, cm.p1[..., None]))(jc, f.xy)
        blur = jnp.round(jpyr.box_filter(jnp.asarray(img.numpy())))
    yx = np.asarray(f.xy)[..., ::-1].round().astype(np.int32)
    level0 = np.asarray(f.level) == 0
    return dict(angle=np.array(f.angle), undist=np.array(und), yx=yx,
                valid=np.array(f.valid), level0=level0, blur=np.array(blur),
                pattern=tbrief.make_pattern(256))


def _jax_offsets(kp, angle):
    cams = U.jax_rig().cams
    with U.f32():
        fn = jax.jit(jax.vmap(jbrief.distorted_pattern_offsets, in_axes=(0, 0, None, 0)))
        return np.array(fn(jax.tree.map(jnp.asarray, cams), jnp.asarray(kp["undist"]),
                             jnp.asarray(kp["pattern"]), jnp.asarray(angle)))


def _cams2():
    return U.torch_rig().cams.expand(2)


def test_distorted_pattern_offsets_match_jax(keypoints):
    kp = keypoints
    want = _jax_offsets(kp, kp["angle"])
    got = tbrief.distorted_pattern_offsets(_cams2(), torch.from_numpy(kp["undist"]),
                                           torch.from_numpy(kp["pattern"]),
                                           torch.from_numpy(kp["angle"])).numpy()
    assert got.shape == want.shape == (3, U.N_FEATURES, 512, 2) and got.dtype == np.int32
    same = (got == want).all(-1)
    assert same.mean() >= MIN_OFFSET_AGREEMENT, (same.size - same.sum(), same.size)


def _patches(kp):
    """Blurred (3, K, 49, 49) patches at the level-0 keypoints (others
    left at their clamped windows, which still sample the same values)."""
    return tbrief.extract_patches(torch.from_numpy(kp["blur"]), torch.from_numpy(kp["yx"]),
                                  tbrief.PATCH_R)


@pytest.mark.parametrize("kind", ["dbrief", "mdbrief"])
def test_descriptor_bits_match_jax_given_the_same_offsets(keypoints, kind, monkeypatch):
    """The port's sampling and packing on the JAX package's offsets: the
    port's ``distorted_pattern_offsets`` returns JAX's for the angle it is
    given (angle and angle +-20 degrees), so the bits must be identical."""
    kp = keypoints
    monkeypatch.setattr(tbrief, "distorted_pattern_offsets",
                        lambda cam, und, pat, a: torch.from_numpy(_jax_offsets(kp, a.numpy())))
    patches = _patches(kp)
    args = (torch.from_numpy(kp["angle"]), torch.from_numpy(kp["undist"]), _cams2(),
            torch.from_numpy(kp["pattern"]))
    cams = U.jax_rig().cams
    with U.f32():
        jfn = getattr(jbrief, f"{kind}_from_patches")
        want = jax.jit(jax.vmap(jfn, in_axes=(0, 0, 0, 0, None)))(
            jnp.asarray(patches.numpy()), *(jnp.asarray(a.numpy()) for a in args[:2]),
            jax.tree.map(jnp.asarray, cams), jnp.asarray(kp["pattern"]))
    got = getattr(tbrief, f"{kind}_from_patches")(patches, *args)
    want = want if kind == "mdbrief" else (want,)
    got = got if kind == "mdbrief" else (got,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))
    if kind == "mdbrief":
        ones = thm.unpack_bits_u32(got[1]).float().mean()
        assert 0.3 < ones < 1.0                    # stability masks are dense


@pytest.mark.parametrize("kind", ["orb", "dbrief", "mdbrief"])
def test_compute_functions_match_jax(keypoints, kind):
    """compute_orb / compute_dbrief / compute_mdbrief on the blurred
    level-0 image at the level-0 keypoints."""
    kp = keypoints
    cams = U.jax_rig().cams
    img, yx, ang, und, pat = (kp["blur"], kp["yx"], kp["angle"], kp["undist"], kp["pattern"])
    with U.f32():
        J = lambda a: jnp.asarray(a)
        if kind == "orb":
            want = jax.jit(jax.vmap(jbrief.compute_orb, in_axes=(0, 0, 0, None)))(
                J(img), J(yx), J(ang), J(pat))
        else:
            want = jax.jit(jax.vmap(getattr(jbrief, f"compute_{kind}"),
                                    in_axes=(0, 0, 0, 0, 0, None)))(
                J(img), J(yx), J(ang), J(und), jax.tree.map(jnp.asarray, cams), J(pat))
    T = torch.from_numpy
    if kind == "orb":
        got = tbrief.compute_orb(T(img), T(yx), T(ang), T(pat))
    else:
        got = getattr(tbrief, f"compute_{kind}")(T(img), T(yx), T(ang), T(und), _cams2(), T(pat))
    got = got if kind == "mdbrief" else (got,)
    want = want if kind == "mdbrief" else (want,)
    sel = T(kp["level0"] & kp["valid"])
    assert int(sel.sum()) > 250
    for g, w in zip(got, want):
        a = thm.unpack_bits_u32(g)[sel]
        b = thm.unpack_bits_u32(T(np.asarray(w).view(np.int32)))[sel]
        diff = float((a != b).float().mean())
        assert diff == 0.0 if kind == "orb" else diff <= MAX_BIT_DIFF, diff
