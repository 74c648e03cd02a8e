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
    in numpy against the functions they stand for: the segment test as
    bit masks (every ring pattern; differences within a few ulps of the
    thresholds), the rings' arc minima by doubling, the divisions by
    multiply-shift and the walks over a tile, the survivors' lists and
    Harris over them, the tile's first maximum through the CTA's
    reduction, the blur's order at the sampled points, the moments'
    order (each product added once, a float64 mirror bit for bit, the
    JAX package's angle within 1e-5 rad) and the tables the sources hold.

On the card (``cuda`` marker; skips without one): the kernels against
their plain versions at each ring and threshold pair, with Harris on and
off, on rendered frames and on noise (negative Harris responses), on
plateaus, fully masked levels, all-zero tiles, keypoints at the canvas
clamp, eight cameras, and inside a CUDA graph. The bar: every output
identical, the bucket maxima and indices, keypoints, levels, responses,
validity, the angles at every level and the descriptor bits.

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
# launch 2's CTA width in csrc/fast_detect.cu, which the mirrors below follow
THREADS = int(re.search(r"#define THREADS (\d+)", open(ek.DETECT_SOURCE).read()).group(1))


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


def _has_run(m, n, arc):
    """has_run of csrc/fast_detect.cu on an array of n-bit ring masks: the
    ring twice, runs doubled by shift and AND, then joined to arc."""
    x = m.astype(np.uint64) | (m.astype(np.uint64) << np.uint64(n))
    r, w = x, 1
    while 2 * w <= arc:
        r = r & (r >> np.uint64(w))
        w *= 2
    if arc > w:
        r = r & (r >> np.uint64(arc - w))
    return (r & np.uint64((1 << n) - 1)) != 0


@pytest.mark.parametrize("mask", RINGS)
def test_bit_mask_run_test_on_every_ring_pattern(mask):
    """For all 2^N bright patterns, a run of ARC set bits exactly where
    the plain version's arc minima of the 0/1 pattern reach 1, in either
    bit order (ring_bits shifts pixel 0 up to the highest bit)."""
    circle, arc, _ = fast.DETECTOR_MASKS[mask]
    n = len(circle)
    m = np.arange(2 ** n, dtype=np.int64)
    bits = torch.from_numpy(((m[:, None] >> np.arange(n)) & 1).astype(np.float32))
    best = torch.stack(fast._ring_min_arc([bits[:, k] for k in range(n)], arc)).amax(0)
    assert np.array_equal(_has_run(m, n, arc), (best >= 1).numpy())
    reversed_ = (((m[:, None] >> np.arange(n)) & 1) << np.arange(n)[::-1]).sum(1)
    assert np.array_equal(_has_run(reversed_, n, arc), _has_run(m, n, arc))   # ring_bits' order


def _diff_threshold(th):
    """diff_threshold of csrc/fast_detect.cu in float32: the least t with
    fl(t - 1) >= th."""
    f = np.float32
    th, one = f(th), f(1)
    x = f(th + one)
    while f(np.nextafter(x, f(-np.inf)) - one) >= th:
        x = np.nextafter(x, f(-np.inf))
    while not f(x - one) >= th:
        x = np.nextafter(x, f(np.inf))
    return x


def _ring_score(d, t, th, arc):
    """ring_score of csrc/fast_detect.cu on ring differences d (B, N)
    float32: the bit masks against t, then the arc minima of the polarity
    that passes (of both where both do, which t <= 0 allows); 0 where
    neither does."""
    n = d.shape[1]
    weights = (1 << np.arange(n)[::-1]).astype(np.int64)      # pixel 0 the highest bit
    bright = _has_run(((d >= t) * weights).sum(1), n, arc)
    dark = _has_run(((d <= -t) * weights).sum(1), n, arc)
    if t > 0:
        assert not (bright & dark).any()          # 2 arc > n: the arcs would overlap
    out = np.zeros(len(d), np.float32)
    for i in np.flatnonzero(bright | dark):
        best = -np.inf
        for on, v in ((bright[i], d[i]), (dark[i], -d[i])):
            if on:
                best = max(best, max(min(v[(k + j) % n] for j in range(arc)) for k in range(n)))
        score = np.float32(np.float32(best) - np.float32(1))
        out[i] = score if score >= th else 0
    return out, bright | dark


@pytest.mark.parametrize("mask", RINGS)
def test_bit_mask_test_decides_as_the_score_threshold(mask):
    """Ring differences placed within a few ulps of the thresholds' t (and
    -t) and non-integer centres: the bit test passes exactly where
    fast.fast_score's score >= th, and ring_score gives fast_score's s_lo
    bit for bit. This is the monotone-rounding argument, checked."""
    circle, arc, r = fast.DETECTOR_MASKS[mask]
    n, f = len(circle), np.float32
    rng = np.random.default_rng(100 + n)
    B = 3000
    for th in (5.0, 20.0, 7.25, float(np.nextafter(f(0), f(1))), -3.0):
        t = _diff_threshold(th)
        assert f(t - f(1)) >= f(th) and f(np.nextafter(t, f(-np.inf)) - f(1)) < f(th)
        c = np.where(rng.random(B) < 0.5, rng.uniform(0, 4, B), rng.uniform(0, 255, B)).astype(f)
        near = (t.view(np.int32) + rng.integers(-4, 5, (B, n))).astype(np.int32).view(f)
        sign = np.where(rng.random((B, 1)) < 0.5, f(1), f(-1))
        d_want = np.where(rng.random((B, n)) < 0.15, rng.uniform(-30, 30, (B, n)).astype(f),
                          sign * near)
        start = rng.integers(0, n, B)             # a run of arc - 1 .. arc + 1 near t
        length = rng.integers(arc - 1, arc + 2, B)
        for i in range(B):
            for j in range(length[i], n):
                d_want[i, (start[i] + j) % n] = rng.uniform(-abs(t), abs(t))
        img = (rng.random((B, 2 * r + 1, 2 * r + 1)) * 255).astype(f)
        img[:, r, r] = c
        for k, (dy, dx) in enumerate(circle):
            img[:, r + dy, r + dx] = c + d_want[:, k]
        d = np.stack([img[:, r + dy, r + dx] - img[:, r, r] for dy, dx in circle], 1)
        score = fast.fast_score(torch.from_numpy(img), -np.inf, mask).numpy()[:, r, r]
        s_lo = fast.fast_score(torch.from_numpy(img), th, mask).numpy()[:, r, r]
        got, passed = _ring_score(d, t, f(th), arc)
        assert np.array_equal(passed, score >= f(th)), th
        assert np.array_equal(got.view(np.int32), s_lo.view(np.int32)), th
        if th > 0:                                             # both sides exercised
            assert min(passed.sum(), (~passed).sum()) >= 5, th


def _magic(d):
    return (1 << 32) // d + 1


@pytest.mark.parametrize("m", [1, 2, 7, 10, 16, 27, 39, 47, 66, 74])
def test_walk_and_fastdiv_equal_division(m):
    """fastdiv(x, magic(d)) == x // d over the dividends the kernels
    divide, and a thread's Walk over an m-wide area (at both launches' CTA
    widths) visits divmod(threadIdx + width it, m), as the division would."""
    fastdiv = lambda x, mg: (x * mg) >> 32
    for d in (m, 30, 64, 416, 65536):
        x = np.arange(0, min(2 ** 32 // d, 70000), dtype=np.uint64)
        assert np.array_equal(fastdiv(x, np.uint64(_magic(d))), x // np.uint64(d)), d
    for nt in (THREADS, 256):
        for tid in range(nt):
            r = fastdiv(tid, _magic(m))
            c, dr = tid - r * m, fastdiv(nt, _magic(m))
            dc = nt - dr * m
            for it in range(-(-m * m // nt) + 1):
                assert (r, c) == divmod(tid + nt * it, m), (tid, it)
                r, c = r + dr, c + dc
                if c >= m:
                    c, r = c - m, r + 1


def _warp_lists(survived):
    """tile_maxima's survivor lists: pixel i = tid + THREADS it of a
    tile's raster order; each warp a ballot an iteration, its survivors
    written at its count so far + the lanes below them."""
    warps = THREADS // 32
    iters = -(-len(survived) // THREADS)
    flags = np.zeros(iters * THREADS, bool)
    flags[:len(survived)] = survived
    ballots = flags.reshape(iters, warps, 32)
    lists = []
    for warp in range(warps):
        own, n = {}, 0
        for it in range(iters):
            for lane in range(32):
                if ballots[it, warp, lane]:
                    own[n + int(ballots[it, warp, :lane].sum())] = it * THREADS + warp * 32 + lane
            n += int(ballots[it, warp].sum())
        lists.append([own[k] for k in range(n)])
    return lists


def _harris_lanes(win, n, i, b, ty0, tx0, H, W):
    """Harris over the list in csrc/fast_detect.cu at survivor i of the
    tile at (ty0, tx0), bucket b, from the window (n x n, 5 pixels around
    the tile, clamped): lane j sums row j's seven columns from the left,
    the first lane the seven row sums from the top; + 1e-6."""
    f = np.float32
    dyt, dxt = divmod(i, b)
    y, x = ty0 + dyt, tx0 + dxt
    rows = []
    for j in range(7):
        ha = hb = hc = f(0)
        if 0 <= y + j - 3 < H:
            for c in range(7):
                ta = tb = tc = f(0)
                if 0 <= x + c - 3 < W:
                    q = (dyt + 5 + j - 3) * n + dxt + 5 - 3 + c
                    gx = (win[q + 2] - win[q - 2]) * f(0.5)
                    gy = (win[q - 2 * n] - win[q + 2 * n]) * f(-0.5)
                    ta, tb, tc = gx * gx, gx * gy, gy * gy
                ha, hb, hc = ha + ta, hb + tb, hc + tc
        rows.append((ha, hb, hc))
    a = bb = c = f(0)
    for ha, hb, hc in rows:
        a, bb, c = a + ha, bb + hb, c + hc
    s = a + c
    return (a * c - bb * bb - f(ek.HARRIS_K) * (s * s)) * f(ek.HARRIS_SCALE2) + f(1e-6)


def test_harris_over_the_compacted_survivors():
    """The warps' lists hold the tile's survivors once each, each list in
    raster order, and Harris taken over them lane by lane equals the dense response
    (+ 1e-6) at those pixels, tiles at the image's corners and edges
    included (the clamped differences and the zero padding)."""
    rng = np.random.default_rng(23)
    H, W = 70, 90
    img = (rng.random((H, W)) * 255).astype(np.float32)
    dense = (fast.harris_score(torch.from_numpy(img)) + 1e-6).numpy()
    for b in (8, 19, 37, 64):
        n = b + 10
        for ty0, tx0 in ((0, 0), (0, W - b), (H - b, 0), (H - b - 3, W - b - 5), (11, 23)):
            yy = np.clip(np.arange(ty0 - 5, ty0 - 5 + n), 0, H - 1)
            xx = np.clip(np.arange(tx0 - 5, tx0 - 5 + n), 0, W - 1)
            win = img[yy][:, xx].reshape(-1)
            survived = rng.random(b * b) < (0.05 if b > 20 else 0.3)
            survived[-1] = True
            lists = _warp_lists(survived)
            assert all(own == sorted(own) for own in lists)        # each in raster order
            assert sorted(i for own in lists for i in own) == list(np.flatnonzero(survived))
            for i in (i for own in lists for i in own):
                y, x = ty0 + i // b, tx0 + i % b
                if y < H and x < W:
                    assert _harris_lanes(win, n, i, b, ty0, tx0, H, W) == dense[y, x], (b, i)


def _point_blur(raw, Y, X, divide: bool):
    """blurred() of csrc/orb_describe.cu at (Y, X) of the 49 x 49 patch:
    five columns from the left at each of rows Y..Y + 4, the rows from the
    top, each from 0, then / 25 (the CPU's) or times the reciprocal (the
    card's), rint."""
    f = np.float32
    v = f(0)
    for i in range(5):
        h = f(0)
        for j in range(5):
            h = h + raw[Y + i, X + j]
        v = v + h
    return np.rint(v / f(25) if divide else v * (f(1) / f(25)))


def test_blur_at_the_sampled_points():
    """The blur taken where ORB samples it equals the whole blurred patch
    there, at every rotated pattern point of random angles."""
    rng = np.random.default_rng(29)
    pattern = torch.from_numpy(brief.make_pattern(256))
    for integer in (True, False):
        raw = rng.random((6, 53, 53)) * 255
        raw = (np.round(raw) if integer else raw).astype(np.float32)
        whole = torch.round(brief.blur_patches_valid(torch.from_numpy(raw))).numpy()
        angle = torch.from_numpy(rng.uniform(-np.pi, np.pi, 6).astype(np.float32))
        off = brief.rotate_pattern_int(pattern, angle).numpy().clip(-23, 23) + 24
        for k in range(6):
            for Y, X in off[k]:
                assert _point_blur(raw[k], Y, X, divide=True) == whole[k, Y, X]
                if integer:
                    assert _point_blur(raw[k], Y, X, divide=False) == whole[k, Y, X]


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


def _tile_first_max(vals, lists=(), threads=THREADS):
    """tile_maxima's reduction: each thread over its pixels in raster
    order but the survivors, then each survivor in the lane that finished
    its Harris (warp w's list ``lists[w]``, position s: lane 7 (s % 4) of
    warp w), the warp's shuffle-down tree, the warps in order, (value,
    lower index) first."""
    better = lambda v, i, w, j: v > w or (v == w and i < j)
    best = [(-np.inf, 2 ** 31 - 1)] * threads
    listed = {i for own in lists for i in own}
    for t in range(threads):
        for i in range(t, len(vals), threads):
            if i not in listed and better(vals[i], i, *best[t]):
                best[t] = (vals[i], i)
    for w, own in enumerate(lists):
        for sv, i in enumerate(own):
            t = 32 * w + 7 * (sv % 4)
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
            t = torch.from_numpy(vals).max(0)
            want = (float(t.values), int(t.indices))
            assert _tile_first_max(vals) == want, (b, hi)
            lists = _warp_lists(rng.random(b * b) < 0.2)
            assert _tile_first_max(vals, lists) == want, (b, hi)


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


def _moment_order():
    """The order in which csrc/orb_describe.cu's moment() adds a moment's
    31 x 31 products (brief.moment_sum's): lane v + 15 sums row v from the
    left, lane 0 adds the row sums from the top. Returns the flat indices
    of the products, row by row, in the order each is added."""
    rows = [[v * 31 + u for u in range(31)] for v in range(31)]   # lane v: its row's order
    return [e for lane in range(31) for e in rows[lane]]


def test_moment_order_adds_every_product_once():
    order = _moment_order()
    assert sorted(order) == list(range(961))
    assert order == list(range(961))           # rows from the top, each from the left


def _moment_mirror(terms):
    """moment() of csrc/orb_describe.cu in numpy: each float32 product
    widened to float64, a row's sum from the left, the rows from the top,
    rounded once to float32."""
    t = terms.astype(np.float64).reshape(terms.shape[:-2] + (-1,))
    order = _moment_order()
    out = np.zeros(terms.shape[:-2], np.float32)
    for idx in np.ndindex(*terms.shape[:-2]):
        rows = []
        for v in range(31):
            s = t[idx][order[31 * v]]
            for e in order[31 * v + 1:31 * v + 31]:
                s = s + t[idx][e]
            rows.append(s)
        total = rows[0]
        for r in rows[1:]:
            total = total + r
        out[idx] = np.float32(total)
    return out


def test_moment_sum_matches_a_float64_mirror_and_jax():
    """brief.moment_sum equals the kernel's order mirrored in numpy bit for
    bit on non-integer windows (the levels above 0), and the port's angle
    stays within the JAX package's 1e-5 rad."""
    import jax
    import jax.numpy as jnp

    import _torchutil as U
    from multicol_slam_tpu.ops import brief as jbrief

    rng = np.random.default_rng(17)
    raw = (rng.random((40, 53, 53)) * 255).astype(np.float32)
    raw[:8] = np.round(raw[:8] * 4) / 4                 # a few coarser ones
    wu, wv = brief._ic_weights()
    ctr = raw[:, 11:42, 11:42]
    for w in (wu, wv):
        terms = ctr * w
        got = brief.moment_sum(torch.from_numpy(terms)).numpy()
        assert np.array_equal(got.view(np.int32), _moment_mirror(terms).view(np.int32))
    angle = brief.ic_angle_patches(torch.from_numpy(raw)).numpy()
    with U.f32():
        want = np.asarray(jax.jit(jbrief.ic_angle_patches)(jnp.asarray(raw)))
    assert float(np.abs(angle - want).max()) <= 1e-5


def test_level0_moments_are_exact_in_any_order():
    """At level 0 the window holds integers: every partial sum of the
    moments stays under 2^24, so the kernel's order gives the plain
    version's angle bit for bit, as PyTorch's float32 sum gives it too."""
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
        assert np.array_equal(s_fwd, brief.moment_sum(torch.from_numpy(terms)).numpy())


# -- on the card ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the extraction kernels are CUDA only")
    return torch.device("cuda", 0)


def _hold(plain, kernel):
    """The kernel path's features against the plain chain's on the card:
    every output identical."""
    for name in plain._fields:
        assert torch.equal(getattr(plain, name), getattr(kernel, name)), name


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


@pytest.mark.cuda
@pytest.mark.parametrize("mask", RINGS)
def test_angles_bit_equal_at_every_level(dev, mask):
    """Above level 0 the moments' sums depend on their order: the kernel
    and the plain version both sum in brief.moment_sum's order (float64
    elementwise adds), so the angles are equal bit for bit at every level,
    whatever PyTorch's own reductions do."""
    rig = _rig(1.0)
    tx = _extractor(rig, detector_mask=mask, use_harris=True)
    for img in _frames(rig, 2, dev):
        plain, kernel = tx.plain(img), tx(img)
        upper = plain.level > 0
        assert bool(upper.any())
        apart = int((plain.angle != kernel.angle).sum())
        assert not apart, (f"{apart} angles differ from the plain version's (at most "
                           f"{float((plain.angle - kernel.angle).abs().max()):.3g} rad)")


@pytest.mark.cuda
def test_rotation_equals_torch_cos_and_sin_at_every_angle(dev):
    """The descriptor's copy of the math library's cosf and sinf (its fast
    path, no local memory) equals torch.cos and torch.sin bit for bit at
    every float32 in [-pi, pi], the IC angle's range."""
    top = int(np.array(np.pi, np.float32).view(np.int32))
    step = 1 << 26
    for start in range(0, top + 1, step):
        bits = torch.arange(start, min(start + step, top + 1), dtype=torch.int32, device=dev)
        for sign in (0, -2 ** 31):
            a = (bits | sign).view(torch.float32)
            cs, sn = ek.rotation(a)
            assert torch.equal(cs.view(torch.int32), torch.cos(a).view(torch.int32)), start
            assert torch.equal(sn.view(torch.int32), torch.sin(a).view(torch.int32)), start


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
    assert torch.equal(a0, a1) and torch.equal(d0, d1)
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
