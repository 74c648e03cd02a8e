"""Feature extraction's two hand-written kernels (``kernels/extract.py``:
detection in ``csrc/fast_detect.cu``, the descriptor in
``csrc/orb_describe.cu``) and the extractor's kernel path.

On the CPU:
  - ``make_extractor``'s extractor on the CPU (the kernel path, whose
    wrappers take their plain versions on CPU tensors) against the JAX
    package at the three rings, Harris on and off, and 16, 32 and 64
    bytes, to the bars of tests/test_torch_extractor.py, and equal to the
    plain chain (``extract.plain``) bit for bit, with padding slots (more
    features than buckets) and on a blank frame;
  - a CPU call builds and loads no kernel library and counts no launch;
  - the wrappers' argument checks;
  - ``detect_reference`` against the bucket maxima written out as the
    plain selection takes them, and the kernels' own arithmetic mirrored
    in numpy against the functions they stand for: the rings' arc minima
    by doubling, Harris at one pixel, the tile's first maximum through the
    CTA's reduction, the blur's order, the moments' summation order (each
    product added once) and the tables the sources hold.

On the card (``cuda`` marker; skips without one): the kernels against
their plain versions at each ring and threshold pair, with Harris on and
off, on rendered frames and on noise (negative Harris responses), on
plateaus, fully masked levels, all-zero tiles, keypoints at the canvas
clamp, eight cameras, and inside a CUDA graph. The bars: the bucket
maxima and indices, keypoints, levels, responses and validity identical;
angles identical at level 0 and within 1e-5 rad above it; descriptor
bits identical where the angle is. Angles identical at every level too,
while the descriptor's moment sums keep the order of the PyTorch version
named in MOMENT_ORDER_TORCH (test_angles_bit_equal_at_every_level).

This file imports JAX only inside the tests that compare with it, so the
card's tests run where JAX is not installed:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_extract_kernels.py
"""

import os
import re

import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch.kernels import extract as ek
from multicol_slam_tpu_torch.kernels import hamming_nn
from multicol_slam_tpu_torch.models import extractor as text
from multicol_slam_tpu_torch.ops import brief, fast, pyramid
from multicol_slam_tpu_torch.ops.camera import make_extraction_masks
from multicol_slam_tpu_torch.ops.hamming import unpack_bits_u32
from multicol_slam_tpu_torch.utils import config_io, synthetic

CSRC = os.path.dirname(ek.DETECT_SOURCE)
RINGS = ("fast_9_16", "agast_7_12", "agast_5_8")
MAX_ANGLE_DIFF = 1e-5


# -- the rig, frames and extractors, at half width for the CPU ------------------------

def _rig(scale: float):
    rig, _ = config_io.load_mcs(config_io.SYNTH_RIG_DIR)
    if scale != 1.0:
        from multicol_slam_tpu_torch.ops import rig as rig_ops
        rig = rig_ops.scale_rig(rig, scale)
    return rig


def _masks(rig, n_levels: int, sf: float):
    w, h = int(float(rig.cams.width[0])), int(float(rig.cams.height[0]))
    per_cam = []
    for c in range(rig.n_cams):
        if float(rig.cams.mirror[c]) > 0.5:
            per_cam.append(make_extraction_masks(float(rig.cams.u0[c]), float(rig.cams.v0[c]),
                                                 w, h, n_levels, sf))
        else:
            per_cam.append([np.full(sz, 255, np.uint8)
                            for sz in pyramid.level_sizes(h, w, n_levels, sf)])
    return [np.stack([m[lvl] for m in per_cam]) for lvl in range(n_levels)], (h, w)


def _frames(rig, n: int, device="cpu"):
    gt = synthetic.smooth_trajectory(100, radius=0.6)[1:1 + n]
    render = synthetic.make_renderer(rig.to(device))
    imgs = render(torch.tensor(gt, dtype=torch.float32, device=device))
    return torch.round(imgs).to(torch.uint8)


def _extractor(rig, **kw):
    cfg = text.ExtractorConfig(**kw)
    masks, hw = _masks(rig, cfg.n_levels, cfg.scale_factor)
    return text.make_extractor(cfg, rig.cams, masks, hw)


def _assert_same(a, b):
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


SMALL = dict(n_features=300, n_levels=4, use_harris=True)
CONFIGS = [dict(detector_mask=r, use_harris=h, desc_bytes=32) for r in RINGS for h in (True, False)]
CONFIGS += [dict(detector_mask="fast_9_16", use_harris=True, desc_bytes=b) for b in (16, 64)]


# -- on the CPU ----------------------------------------------------------------------------

@pytest.mark.parametrize("opts", CONFIGS, ids=lambda o: "-".join(map(str, o.values())))
def test_cpu_extractor_matches_jax_and_the_kernel_path(opts):
    """The extractor on the CPU (the kernel path, its wrappers' plain
    versions) against the JAX package (tests/test_torch_extractor.py's
    bars), and the plain chain equal to it."""
    import jax.numpy as jnp

    import _torchutil as U
    from multicol_slam_tpu.models import extractor as jext
    from multicol_slam_tpu_torch.utils import convert

    kw = dict(U._extractor_kwargs(), **opts)
    tx = text.make_extractor(text.ExtractorConfig(**kw), U.torch_rig().cams,
                             U.masks_by_level(), U.image_hw())
    jx = jext.make_extractor(jext.ExtractorConfig(**kw), U.jax_rig().cams,
                             U.masks_by_level(), U.image_hw())
    img = U.frames(2)[1][1]
    tf = tx(img)
    _assert_same(tf, tx.plain(img))
    with U.f32():
        jf = convert.features_from_numpy(jx(jnp.asarray(img.numpy())))
    moved = 0
    for c in range(tf.n_cams):
        to = np.lexsort((tf.xy[c, :, 0].numpy(), tf.xy[c, :, 1].numpy(), tf.level[c].numpy(),
                         ~tf.valid[c].numpy()))
        jo = np.lexsort((jf.xy[c, :, 0].numpy(), jf.xy[c, :, 1].numpy(), jf.level[c].numpy(),
                         ~jf.valid[c].numpy()))
        moved += int((to != jo).sum())
        for name in ("xy", "level", "valid"):
            assert torch.equal(getattr(tf, name)[c][to], getattr(jf, name)[c][jo]), name
        valid = jf.valid[c][jo]
        assert torch.equal(unpack_bits_u32(tf.desc[c][to])[valid],
                           unpack_bits_u32(jf.desc[c][jo])[valid])
    assert moved <= 0.01 * tf.valid.numel()
    assert int(tf.valid.sum()) > 0.9 * tf.valid.numel()


@pytest.mark.parametrize("desc", ["orb", "dbrief", "mdbrief"])
@pytest.mark.parametrize("case", ["frame", "more_features_than_buckets", "blank"])
def test_kernel_path_equals_plain_on_cpu(desc, case):
    rig = _rig(0.5)
    kw = dict(SMALL, use_dbrief=desc != "orb", learn_masks=desc == "mdbrief",
              detector_mask="agast_7_12" if desc != "orb" else "fast_9_16")
    if case == "more_features_than_buckets":
        kw["n_features"] = 4000
    tx = _extractor(rig, **kw)
    img = _frames(rig, 1)[0]
    if case == "blank":
        img = torch.zeros_like(img)
    a, b = tx.plain(img), tx(img)
    _assert_same(a, b)
    if case == "more_features_than_buckets":
        assert not bool(a.valid.all())          # padding slots past the buckets
    if case == "blank":
        assert not bool(a.valid.any())


def test_cpu_call_loads_no_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU call built a kernel library")
    monkeypatch.setattr(hamming_nn, "build", refuse)
    before = (ek.detect.launches, ek.describe.launches, dict(ek._libs))
    rig = _rig(0.5)
    tx = _extractor(rig, **SMALL)
    tx(_frames(rig, 1)[0])
    assert (ek.detect.launches, ek.describe.launches, dict(ek._libs)) == before


def _detect_args(C=2, sizes=((60, 80), (50, 67)), buckets=(16, 12)):
    gen = torch.Generator().manual_seed(3)
    levels = [torch.rand((C,) + s, generator=gen) * 255 for s in sizes]
    masks = [torch.ones((C,) + s, dtype=torch.bool) for s in sizes]
    return levels, masks, list(buckets)


def test_wrappers_raise_on_bad_arguments():
    levels, masks, buckets = _detect_args()
    kw = dict(th_hi=20, th_lo=5, cell=30, border=8, ring="fast_9_16", harris=True)
    ek.detect(levels, masks, buckets, **kw)
    with pytest.raises(TypeError):
        ek.detect([levels[0].double(), levels[1]], masks, buckets, **kw)
    with pytest.raises(TypeError):
        ek.detect(levels, [masks[0].to(torch.uint8), masks[1]], buckets, **kw)
    with pytest.raises(ValueError):
        ek.detect([levels[0].transpose(1, 2).contiguous().transpose(1, 2), levels[1]], masks,
                  buckets, **kw)
    with pytest.raises(RuntimeError):
        ek.detect([levels[0], levels[1].to("meta")], masks, buckets, **kw)
    with pytest.raises(ValueError):
        ek.detect(levels, masks, [16, 65], **kw)
    with pytest.raises(ValueError):
        ek.detect(levels, masks, buckets, **dict(kw, ring="fast_7_12"))
    with pytest.raises(ValueError):
        ek.detect(levels, masks[:1], buckets, **kw)
    big = [torch.rand(2, 120, 160), torch.rand(2, 100, 133)]
    yx = torch.full((2, 5, 2), 60, dtype=torch.int32)
    lvl = torch.zeros((2, 5), dtype=torch.int32)
    pat = torch.from_numpy(brief.make_pattern(256))
    ek.describe(big, yx, lvl, pat)
    with pytest.raises(TypeError):
        ek.describe(big, yx.long(), lvl, pat)
    with pytest.raises(TypeError):
        ek.describe(big, yx, lvl.float(), pat)
    with pytest.raises(ValueError):
        ek.describe(big, yx.transpose(0, 1).contiguous().transpose(0, 1), lvl, pat)
    with pytest.raises(RuntimeError):
        ek.describe(big, yx.to("meta"), lvl, pat)
    with pytest.raises(ValueError):
        ek.describe(big, yx, lvl, pat[:100])
    with pytest.raises(ValueError):
        ek.describe(big[::-1], yx, lvl, pat)              # a level wider than level 0


def test_detect_reference_is_the_plain_selections_bucket_maxima():
    """Each level's row: the tiles' first maxima exactly as the plain
    selection took them before it was split out (pad, tile, max), the
    columns past the level's buckets -inf and 0."""
    levels, masks, buckets = _detect_args()
    masks[1][:, :20] = False
    kw = dict(th_hi=20, th_lo=5, cell=30, border=8, ring="agast_7_12", harris=True)
    vals, args = ek.detect_reference(levels, masks, buckets, **kw)
    T = vals.shape[-1]
    for lvl, (img, m, b) in enumerate(zip(levels, masks, buckets)):
        score = fast.fast_with_fallback(img, 20, 5, 30, "agast_7_12")
        score = torch.where(score > 0, fast.harris_score(img) + 1e-6, torch.zeros_like(score))
        h, w = img.shape[-2:]
        yy, xx = torch.arange(h)[:, None], torch.arange(w)[None, :]
        inside = (yy >= 8) & (yy < h - 8) & (xx >= 8) & (xx < w - 8)
        s = torch.where(m & inside, score, torch.zeros_like(score))
        hp, wp = -(-h // b) * b, -(-w // b) * b
        sp = torch.nn.functional.pad(s, (0, wp - w, 0, hp - h))
        tiles = sp.reshape(-1, hp // b, b, wp // b, b).transpose(-3, -2).reshape(
            s.shape[0], -1, b * b)
        v, a = tiles.max(-1)
        n = v.shape[-1]
        assert torch.equal(vals[:, lvl, :n], v) and torch.equal(args[:, lvl, :n], a.int())
        assert bool((vals[:, lvl, n:] == -float("inf")).all()) and T >= n
        assert not bool(args[:, lvl, n:].any())


def _source_table(path, name):
    text_ = open(path).read()
    body = re.search(name + r"[^=]*=\s*\{(.*?)\};", text_, re.S).group(1)
    return [int(v) for v in re.findall(r"-?\d+", body)]


def test_source_tables_match_the_plain_versions():
    det = os.path.join(CSRC, "fast_detect.cu")
    for name, ring in (("RING16", fast.CIRCLE), ("RING12", fast.CIRCLE_12),
                       ("RING8", fast.CIRCLE_8)):
        assert _source_table(det, name) == ring.reshape(-1).tolist()
    src = open(det).read()
    for mask, (circle, arc, r) in fast.DETECTOR_MASKS.items():
        assert re.search(rf"Ring<{len(circle)}> \{{\s*static constexpr int ARC = {arc}, "
                         rf"R = {r};", src), mask
    umax = _source_table(os.path.join(CSRC, "orb_describe.cu"), "UMAX")
    wu, wv = brief._ic_weights()
    assert umax == [int(np.abs(wu[brief.HALF_PATCH + v]).max()) for v in range(16)]


def _best_arc_doubling(v, arc):
    """best_arc of csrc/fast_detect.cu: arc minima by doubling, joined by
    the arc length's bits, then the max."""
    n = len(v)
    pw, acc, have, width = list(v), None, 0, 1
    for bit in range(5):
        if arc & (1 << bit):
            acc = list(pw) if not have else [min(acc[k], pw[(k + have) % n]) for k in range(n)]
            have += width
        if (arc >> (bit + 1)) == 0:
            break
        pw = [min(pw[k], pw[(k + width) % n]) for k in range(n)]
        width *= 2
    return max(acc)


@pytest.mark.parametrize("mask", RINGS)
def test_arc_doubling_equals_the_segment_test(mask):
    circle, arc, _ = fast.DETECTOR_MASKS[mask]
    n = len(circle)
    rng = np.random.default_rng(n)
    for _ in range(300):
        v = rng.integers(-4, 5, n).astype(np.float32)
        want = max(min(v[(k + j) % n] for j in range(arc)) for k in range(n))
        assert _best_arc_doubling(v, arc) == want


def _harris_at(img, y, x):
    """harris_at of csrc/fast_detect.cu in float32, in its order."""
    f = np.float32
    H, W = img.shape
    at = lambda yy, xx: img[min(max(yy, 0), H - 1), min(max(xx, 0), W - 1)]
    a = b = c = f(0)
    for j in range(7):
        yy = y + j - 3
        ha = hb = hc = f(0)
        if 0 <= yy < H:
            for i in range(7):
                xx = x + i - 3
                ta = tb = tc = f(0)
                if 0 <= xx < W:
                    gx = (at(yy, xx + 2) - at(yy, xx - 2)) * f(0.5)
                    gy = (at(yy - 2, xx) - at(yy + 2, xx)) * f(-0.5)
                    ta, tb, tc = gx * gx, gx * gy, gy * gy
                ha, hb, hc = ha + ta, hb + tb, hc + tc
        a, b, c = a + ha, b + hb, c + hc
    s = a + c
    return (a * c - b * b - f(ek.HARRIS_K) * (s * s)) * f(ek.HARRIS_SCALE2)


def test_harris_at_one_pixel_equals_the_dense_response():
    rng = np.random.default_rng(5)
    img = (rng.random((40, 52)) * 255).astype(np.float32)
    dense = fast.harris_score(torch.from_numpy(img)).numpy()
    pts = [(0, 0), (0, 51), (39, 0), (39, 51), (1, 2), (2, 1), (20, 26), (38, 50)]
    pts += [tuple(p) for p in rng.integers(0, (40, 52), (40, 2))]
    for y, x in pts:
        assert _harris_at(img, y, x) == dense[y, x], (y, x)


def _tile_first_max(vals, threads=256):
    """tile_maxima's reduction: each thread over its pixels in raster
    order, the warp's shuffle-down tree, the warps in order, (value, lower
    index) first."""
    better = lambda v, i, w, j: v > w or (v == w and i < j)
    best = [(-np.inf, 2 ** 31 - 1)] * threads
    for t in range(threads):
        for i in range(t, len(vals), threads):
            if better(vals[i], i, *best[t]):
                best[t] = (vals[i], i)
    for w in range(threads // 32):
        lane = best[32 * w:32 * w + 32]
        for off in (16, 8, 4, 2, 1):
            lane = [lane[k] if k + off >= 32 or not better(*lane[k + off], *lane[k])
                    else lane[k + off] for k in range(32)]
        best[32 * w] = lane[0]
    out = best[0]
    for w in range(1, threads // 32):
        if better(*best[32 * w], *out):
            out = best[32 * w]
    return out


def test_tile_reduction_takes_the_first_maximum():
    rng = np.random.default_rng(7)
    for b in (8, 19, 37, 64):
        for hi in (1, 3, 50):
            vals = rng.integers(-2, hi, b * b).astype(np.float32)
            v, i = _tile_first_max(vals)
            t = torch.from_numpy(vals).max(0)
            assert (v, i) == (float(t.values), int(t.indices)), (b, hi)


def _blur_rounded(raw, divide: bool):
    """The blur of csrc/orb_describe.cu in float32: five columns from the
    left, five such rows from the top, each from 0, then / 25 (the CPU's
    true division) or times the float32 reciprocal (the card's), rint."""
    f = np.float32
    h = np.zeros((53, 49), np.float32)
    for r in range(53):
        for j in range(49):
            s = f(0)
            for i in range(5):
                s = s + raw[r, j + i]
            h[r, j] = s
    out = np.zeros((49, 49), np.float32)
    for y in range(49):
        for x in range(49):
            s = f(0)
            for i in range(5):
                s = s + h[y + i, x]
            out[y, x] = np.rint(s / f(25) if divide else s * (f(1) / f(25)))
    return out


def test_blur_order_and_scale():
    rng = np.random.default_rng(11)
    for integer in (True, False):
        raw = rng.random((53, 53)) * 255
        raw = (np.round(raw) if integer else raw).astype(np.float32)
        want = torch.round(brief.blur_patches_valid(torch.from_numpy(raw))).numpy()
        assert np.array_equal(_blur_rounded(raw, divide=True), want)
        if integer:       # sums of integers are never within a float32 ulp of .5 * 25
            assert np.array_equal(_blur_rounded(raw, divide=False), want)


def _moment_order(row):
    """The element order of moment_sum in csrc/orb_describe.cu for output
    row ``row``: per lane, its accumulators' elements in order."""
    n = 961
    shift = (row * n) % 4
    lanes = [[[] for _ in range(4)] for _ in range(32)]
    base, end = 0, n
    if shift:
        for lane in range(shift, 4):
            lanes[lane][0].append(lane - shift)
        base, end = 4 - shift, n + shift - 4
    for lane in range(32):
        idx = lane
        while idx * 4 + 3 < end:
            for i in range(4):
                lanes[lane][i].append(base + idx * 4 + i)
            idx += 32
        if end - end % 4 + lane < end:
            lanes[lane][0].append(base + end - end % 4 + lane)
    return lanes


def test_moment_order_adds_every_product_once():
    for row in range(8):
        got = sorted(e for lane in _moment_order(row) for acc in lane for e in acc)
        assert got == list(range(961)), row


def test_level0_moments_are_exact_in_any_order():
    """At level 0 the window holds integers: every partial sum of the
    moments stays under 2^24, so the kernel's order gives the plain
    version's angle bit for bit."""
    rng = np.random.default_rng(13)
    raw = torch.from_numpy(rng.integers(0, 256, (64, 53, 53)).astype(np.float32))
    wu, wv = brief._ic_weights()
    ctr = raw[:, 11:42, 11:42].numpy()
    for w in (wu, wv):
        terms = ctr * w
        assert np.abs(terms).reshape(64, -1).sum(-1).max() < 2 ** 24
        fwd = terms.reshape(64, -1).astype(np.float32)
        s_fwd = np.zeros(64, np.float32)
        for e in range(961):
            s_fwd = s_fwd + fwd[:, e]
        assert np.array_equal(s_fwd, (torch.from_numpy(ctr) * torch.from_numpy(w)).sum(
            (-2, -1)).numpy())


# -- on the card ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the extraction kernels are CUDA only")
    return torch.device("cuda", 0)


def _hold(plain, kernel):
    """The kernel path's features against the plain chain's on the card."""
    for name in ("xy", "level", "response", "valid", "ray"):
        assert torch.equal(getattr(plain, name), getattr(kernel, name)), name
    same = plain.angle == kernel.angle
    assert bool(same[plain.level == 0].all())
    assert float((plain.angle - kernel.angle).abs().max()) <= MAX_ANGLE_DIFF
    for name in ("desc", "desc_mask"):
        a, b = unpack_bits_u32(getattr(plain, name)), unpack_bits_u32(getattr(kernel, name))
        assert torch.equal(a[same], b[same]), name
        assert float((a != b).float().mean()) <= 1e-4, name


def _detect_both(levels, masks, buckets, **kw):
    v1, a1 = ek.detect(levels, masks, buckets, **kw)
    v0, a0 = ek.detect_reference(levels, masks, buckets, **kw)
    assert torch.equal(v0, v1) and torch.equal(a0, a1)
    return v0


@pytest.mark.cuda
@pytest.mark.parametrize("mask", RINGS)
@pytest.mark.parametrize("th", [(20, 5), (5, 5), (40, 10)])
@pytest.mark.parametrize("harris", [True, False])
def test_kernels_against_plain_on_frames(dev, mask, th, harris):
    rig = _rig(1.0)
    tx = _extractor(rig, detector_mask=mask, use_harris=harris, fast_th=th[0],
                    fast_th_min=th[1])
    frames = _frames(rig, 2, dev)
    n0 = ek.detect.launches, ek.describe.launches
    for img in frames:
        _hold(tx.plain(img), tx(img))
    assert (ek.detect.launches - n0[0], ek.describe.launches - n0[1]) == (4, 2)


# csrc/orb_describe.cu's moment_sum copies the order in which PyTorch's CUDA
# sum reduces the moments' products, as it was in this version
MOMENT_ORDER_TORCH = "2.11.0+cu128"


@pytest.mark.cuda
@pytest.mark.parametrize("mask", RINGS)
def test_angles_bit_equal_at_every_level(dev, mask):
    """Above level 0 the moments' sums depend on their order: the kernel
    gives the plain version's angles bit for bit only while moment_sum's
    order is PyTorch's own."""
    rig = _rig(1.0)
    tx = _extractor(rig, detector_mask=mask, use_harris=True)
    for img in _frames(rig, 2, dev):
        plain, kernel = tx.plain(img), tx(img)
        upper = plain.level > 0
        assert bool(upper.any())
        apart = int((plain.angle != kernel.angle)[upper].sum())
        assert not apart, (
            f"{apart} of {int(upper.sum())} angles above level 0 differ from the plain "
            f"version's (at most {float((plain.angle - kernel.angle).abs().max()):.3g} rad): "
            f"moment_sum in csrc/orb_describe.cu sums in the order of PyTorch "
            f"{MOMENT_ORDER_TORCH}'s CUDA reduction, and this is PyTorch {torch.__version__}; "
            f"match the new order or hold the angle to its 1e-5 bar alone")


@pytest.mark.cuda
def test_detect_on_noise_plateaus_and_masked_levels(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    sizes, buckets = ((200, 300), (167, 250), (139, 208)), [24, 20, 19]
    noise = [torch.randint(0, 256, (3,) + s, generator=gen, device=dev).float() for s in sizes]
    # plateaus: blocks of equal values with steps between them
    yy, xx = (torch.arange(n, device=dev) for n in sizes[0])
    steps = ((yy[:, None] // 7 + xx[None, :] // 9) % 3 * 40).float().expand(3, -1, -1)
    # strong stripes over faint noise: corners whose Harris response is
    # under -1e-6, so they lose to the bucket's zeros
    stripes = ((xx // 12) % 2 * 243.0).expand(3, sizes[0][0], -1) + torch.randint(
        0, 12, (3,) + sizes[0], generator=gen, device=dev)
    masks = [torch.ones((3,) + s, dtype=torch.bool, device=dev) for s in sizes]
    masks[1][:] = False                           # a fully masked level
    masks[2][:, :70] = False
    for ring in RINGS:
        for levels in (noise, [steps.contiguous()] + noise[1:],
                       [stripes.contiguous()] + noise[1:],
                       [torch.zeros((3,) + s, device=dev) for s in sizes]):
            for harris in (True, False):
                vals = _detect_both(levels, masks, buckets, th_hi=20, th_lo=5, cell=30,
                                    border=26, ring=ring, harris=harris)
                assert not bool(vals[:, 1, :].gt(0).any())
    score = fast.fast_with_fallback(stripes.contiguous(), 20, 5, 30)
    assert bool((fast.harris_score(stripes.contiguous())[score > 0] + 1e-6 < 0).any())


@pytest.mark.cuda
def test_describe_at_the_clamp_and_across_levels(dev):
    rig = _rig(1.0)
    img = _frames(rig, 1, dev)[0].float()
    pyr = pyramid.build_pyramid(img, 8, 1.2)
    C = img.shape[0]
    pts = []
    for lvl, p in enumerate(pyr):
        h, w = p.shape[-2:]
        pts += [(lvl, 0, 0), (lvl, h - 1, w - 1), (lvl, 3, w // 2), (lvl, h - 2, 5),
                (lvl, h // 2, w // 2)]
    level = torch.tensor([[p[0] for p in pts]] * C, dtype=torch.int32, device=dev)
    yx = torch.tensor([[p[1:] for p in pts]] * C, dtype=torch.int32, device=dev)
    pattern = torch.from_numpy(brief.make_pattern(256)).to(dev)
    a1, d1 = ek.describe(pyr, yx, level, pattern)
    a0, d0 = ek.describe_reference(pyr, yx, level, pattern)
    same = a0 == a1
    assert bool(same[level == 0].all())
    assert float((a0 - a1).abs().max()) <= MAX_ANGLE_DIFF
    assert torch.equal(d0[same], d1[same])
    b1 = ek.describe(pyr, yx, level, None)[1]
    b0 = ek.describe_reference(pyr, yx, level, None)[1]
    assert torch.equal(b0, b1)


@pytest.mark.cuda
def test_eight_cameras_and_graph_replay(dev):
    from multicol_slam_tpu_torch.ops.camera import stack_cameras
    from multicol_slam_tpu_torch.utils import graphs

    base = _rig(1.0)
    cams = stack_cameras([base.cams.index(0)] * 8)
    cfg = text.ExtractorConfig(use_harris=True, detector_mask="agast_7_12", use_dbrief=True,
                               learn_masks=True)
    masks, hw = _masks(base, cfg.n_levels, cfg.scale_factor)
    masks = [np.concatenate([m[:1]] * 8) for m in masks]
    tx = text.make_extractor(cfg, cams, masks, hw)
    frames = _frames(base, 3, dev)
    imgs = torch.cat([frames[0], frames[1], frames[2][:2]])        # eight cameras
    eager = tx(imgs)
    _hold(tx.plain(imgs), eager)
    g = graphs.jit(tx)
    g(imgs)
    replay = g(imgs)
    for name in eager._fields:
        assert torch.equal(getattr(eager, name), getattr(replay, name)), name
