"""The port's CUDA kernel on the card: both entries of the Hamming-NN
kernel against their plain versions, both variants, at the system's
shapes and ragged ones, with duplicate minima, fully gated rows and the
adversarial cases of tests/_radius_cases.py; the vocabulary-node gate of
SearchByBoW on the window-gated entry against a dense node gate; the
relocalization projection search on the card against the CPU path; the
mdBRIEF path: the pattern offsets' saturating cast, the distorted pattern
and both extractors of the mdBRIEF system on the card against the CPU (to
the bars stated in those tests), and the masked window-gated entry on the
system's own stability masks. Equality is exact unless a test states a
bar.

These tests import no JAX, so they also run where JAX is not installed:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card they skip.
"""

import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch.kernels import hamming_nn as knn

import _radius_cases as RC

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hamming-NN kernel is CUDA only")
    return torch.device("cuda", 0)


def _words(shape, gen, dev):
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         dtype=torch.int64, device=dev).to(torch.int32)


@pytest.mark.parametrize("C,N,M", [(3, 400, 400), (3, 2048, 400), (2, 1, 1),
                                   (2, 1, 257), (2, 129, 1), (2, 129, 257)])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain(dev, C, N, M, masked):
    gen = torch.Generator(device=dev).manual_seed(C * N + M)
    q, db = _words((C, N, 8), gen, dev), _words((C, M, 8), gen, dev)
    half = M // 2
    db[:, half:2 * half] = db[:, :half]           # duplicate minima
    q[:, :min(N, half)] = db[:, :min(N, half)]
    gate = torch.rand((C, N, M), generator=gen, device=dev) < 0.3
    gate[:, ::5] = False                           # fully gated rows
    masks = (_words(q.shape, gen, dev), _words(db.shape, gen, dev)) if masked else ()
    before = knn.hamming_nn.launches
    got = knn.hamming_nn(q, db, gate, *masks)
    torch.cuda.synchronize()
    assert knn.hamming_nn.launches == before + 1
    for a, b in zip(got, knn.hamming_nn_reference(q, db, gate, *masks)):
        assert torch.equal(a, b)
    assert (got[0][:, ::5] == -1).all()


def test_kernel_rejects_non_contiguous(dev):
    q = torch.zeros((1, 8, 4), dtype=torch.int32, device=dev).transpose(1, 2)
    db = torch.zeros((1, 3, 8), dtype=torch.int32, device=dev)
    gate = torch.ones((1, 4, 3), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        knn.hamming_nn(q, db, gate)


@pytest.mark.parametrize("C,N,M", [(3, 800, 800), (15, 800, 800), (12, 256, 800),
                                   (3, 2048, 800)])
def test_kernel_matches_plain_at_the_systems_shapes(dev, C, N, M):
    """Slots are K = 800 per camera in the full system: initialization and
    window search (3, 800, 800), triangulation against 5 neighbours
    (15, 800, 800), fuse into 4 targets (12, 256, 800), local map
    (3, 2048, 800)."""
    gen = torch.Generator(device=dev).manual_seed(C + N + M)
    q, db = _words((C, N, 8), gen, dev), _words((C, M, 8), gen, dev)
    n_copy = min(N, M) // 2
    q[:, :n_copy] = db[:, :n_copy]
    gate = torch.rand((C, N, M), generator=gen, device=dev) < 0.01
    got = knn.hamming_nn(q, db, gate)
    for a, b in zip(got, knn.hamming_nn_reference(q, db, gate)):
        assert torch.equal(a, b)


def _features(n, gen, dev):
    from multicol_slam_tpu_torch.models.extractor import Features
    C = 3
    return Features(
        xy=torch.rand((C, n, 2), generator=gen, device=dev) * 200,
        level=torch.randint(0, 2, (C, n), generator=gen, device=dev, dtype=torch.int32),
        angle=torch.zeros((C, n), device=dev), response=torch.ones((C, n), device=dev),
        ray=torch.nn.functional.normalize(torch.randn((C, n, 3), generator=gen, device=dev), dim=-1),
        desc=_words((C, n, 8), gen, dev),
        desc_mask=torch.full((C, n, 8), -1, dtype=torch.int32, device=dev),
        valid=torch.rand((C, n), generator=gen, device=dev) < 0.9)


def test_mutual_search_launches_twice_and_matches_the_cpu(dev):
    """search_for_initialization's mutual check is a second launch of the
    window-gated entry with the roles swapped; on the card it must equal
    the CPU path."""
    from multicol_slam_tpu_torch.models import matcher as tm
    gen = torch.Generator(device=dev).manual_seed(7)
    f1 = _features(800, gen, dev)
    # f2: a jittered copy of f1 with a quarter of the bits flipped
    flip = _words(f1.desc.shape, gen, dev) & _words(f1.desc.shape, gen, dev)
    flip &= _words(f1.desc.shape, gen, dev)
    f2 = f1._replace(xy=f1.xy + torch.randn(f1.xy.shape, generator=gen, device=dev),
                     desc=f1.desc ^ flip)
    before = knn.hamming_nn_radius.launches
    got = tm.search_for_initialization(f1, f2, tm.MatchParams())
    torch.cuda.synchronize()
    assert knn.hamming_nn_radius.launches == before + 2
    cpu = lambda f: type(f)(*(t.cpu() for t in f))
    want = tm.search_for_initialization(cpu(f1), cpu(f2), tm.MatchParams())
    assert torch.equal(got.cpu(), want)
    assert (want >= 0).sum() > 100


def _radius_args(case, masked, dev):
    words = lambda a: torch.from_numpy(a.view(np.int32).copy()).to(dev)
    args = [words(case["q"]), words(case["db"])] + [
        torch.from_numpy(case[k]).to(dev) for k in (
            "q_uv", "q_r2", "q_lvl_lo", "q_lvl_hi", "q_ok", "db_xy", "db_lvl", "db_ok")]
    return args + ([words(case["q_mask"]), words(case["db_mask"])] if masked else [])


def _radius_matches_plain(args):
    before = knn.hamming_nn_radius.launches
    got = knn.hamming_nn_radius(*args)
    torch.cuda.synchronize()
    assert knn.hamming_nn_radius.launches == before + 1
    for a, b in zip(got, knn.hamming_nn_radius_reference(*args)):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("case", RC.CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_radius_entry_matches_plain_on_adversarial_cases(dev, case, masked):
    """Points exactly on the radius (a fused multiply-add would flip
    them), both edges of the level window, fully gated rows, duplicate
    minima, queries shared by every camera, 4/8/16 words."""
    got = _radius_matches_plain(_radius_args(RC.radius_case(case, seed=len(case)),
                                             masked, dev))
    assert (got[0] >= 0).any()


@pytest.mark.parametrize("C,Cq,N,M", [(3, 3, 800, 800), (3, 1, 1024, 800),
                                      (12, 1, 1024, 800), (2, 2, 1, 1), (2, 1, 129, 257)])
@pytest.mark.parametrize("masked", [False, True])
def test_radius_entry_matches_plain_at_the_systems_shapes(dev, C, Cq, N, M, masked):
    """Initialization, window search and motion-model tracking (3, 800) x
    (3, 800); local-map tracking (1, 1024) x (3, 800) with the map points
    shared by the cameras; fuse into 4 targets (1, 1024) x (12, 800);
    ragged shapes."""
    case = RC.radius_case("broadcast" if Cq == 1 else "common", seed=N + M, C=C, N=N, M=M)
    _radius_matches_plain(_radius_args(case, masked, dev))


def test_system_runs_on_the_card_by_default(dev):
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, enable_loop_closing=False)
    assert slam.device.type == "cuda" and slam.rig.M_c.is_cuda


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_node_gate_on_the_radius_entry_matches_the_dense_node_gate(dev, seed):
    """SearchByBoW's gate (both rows valid, the same vocabulary node) put
    in the window-gated entry's level fields, with zero pixel positions and
    an infinite radius, at the (1, 2400) x (1, 2400) shape of the loop and
    relocalization sites, on random trees: entry A equals the dense-gate
    plain version on the dense node gate, and ``matcher.search_by_bow`` on
    the card equals its CPU path."""
    from multicol_slam_tpu_torch.models import matcher as tm
    from multicol_slam_tpu_torch.models import vocabulary as tv
    rng = np.random.default_rng(seed)
    N, M = 2400, 2400
    base = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)
    voc = tv.train_vocabulary(base[rng.choice(N, 600, replace=False)], k=4 + seed,
                              levels=3, seed=seed).to(dev)
    # the database: the queries with about 10 of 256 bits flipped, shuffled
    flip = np.zeros((M, 8), np.uint32)
    for _ in range(10):
        bit = np.left_shift(np.uint32(1), rng.integers(0, 32, (M, 8), dtype=np.uint32))
        flip |= np.where(rng.random((M, 8)) < 1 / 8, bit, np.uint32(0))
    db_np = (base ^ flip)[rng.permutation(M)]
    q = torch.from_numpy(base.view(np.int32)).to(dev)
    db = torch.from_numpy(db_np.view(np.int32)).to(dev)
    q_ok = torch.from_numpy(rng.random(N) < 0.8).to(dev)
    db_ok = torch.from_numpy(rng.random(M) < 0.8).to(dev)
    up = voc.levels - 1
    q_node = tv.transform_words(voc, q, q_ok, levelsup=up)[1]
    db_node = tv.transform_words(voc, db, db_ok, levelsup=up)[1]

    gate = q_ok[:, None] & db_ok[None, :] & (q_node[:, None] == db_node[None, :])
    before = knn.hamming_nn_radius.launches
    got = knn.hamming_nn_radius(
        q[None], db[None], torch.zeros((1, N, 2), device=dev),
        torch.full((1, N), float("inf"), device=dev), q_node[None], q_node[None],
        q_ok[None], torch.zeros((1, M, 2), device=dev), db_node[None], db_ok[None])
    torch.cuda.synchronize()
    assert knn.hamming_nn_radius.launches == before + 1
    for a, b in zip(got, knn.hamming_nn_reference(q[None], db[None], gate[None])):
        assert torch.equal(a, b)

    params = tm.MatchParams()
    match = tm.search_by_bow(q, q_ok, q_node, db, db_ok, db_node, params)
    assert knn.hamming_nn_radius.launches == before + 2
    cpu = [t.cpu() for t in (q, q_ok, q_node, db, db_ok, db_node)]
    want = tm.search_by_bow(*cpu, params)
    assert torch.equal(match.cpu(), want)
    assert (want >= 0).sum() > 100


def test_reloc_projection_match_on_the_card_matches_the_cpu(dev):
    """The relocalization round's projection search (radius 10 x 1.2^level,
    level +-1, free slots only, the absolute ORBdist gate) at a
    (1, 512) x (3, 800) shape: the same matches on the card as on the CPU,
    one launch."""
    from multicol_slam_tpu_torch.models import matcher as tm
    gen = torch.Generator(device=dev).manual_seed(11)
    feats = _features(800, gen, dev)
    C, P = 3, 512
    # each point: a feature of its camera with a few bits flipped, predicted
    # within a few pixels of it
    cam = torch.randint(0, C, (P,), generator=gen, device=dev)
    slot = torch.randint(0, 800, (P,), generator=gen, device=dev)
    noise = _words((P, 8), gen, dev) & _words((P, 8), gen, dev) & _words((P, 8), gen, dev)
    pt_desc = feats.desc[cam, slot] ^ (noise & _words((P, 8), gen, dev))
    uv = feats.xy[cam, slot][None].expand(C, P, 2) \
        + 4 * torch.randn((C, P, 2), generator=gen, device=dev)
    lvl = feats.level[cam, slot][None].expand(C, P).contiguous()
    ok = torch.rand((C, P), generator=gen, device=dev) < 0.7
    has = torch.rand((C, 800), generator=gen, device=dev) < 0.3
    args = (has, pt_desc, torch.full_like(pt_desc, -1), uv.contiguous(), ok, lvl,
            tm.MatchParams())
    before = knn.hamming_nn_radius.launches
    got = tm.reloc_projection_match(feats, *args, th=10.0, orb_dist=100)
    torch.cuda.synchronize()
    assert knn.hamming_nn_radius.launches == before + 1
    cpu = lambda t: t.cpu() if torch.is_tensor(t) else t
    want = tm.reloc_projection_match(type(feats)(*(t.cpu() for t in feats)),
                                     *(cpu(a) for a in args), th=10.0, orb_dist=100)
    assert torch.equal(got.cpu(), want)
    assert (want >= 0).sum() > 50


def test_round_to_int32_on_the_card_is_xlas_cast(dev):
    """The pattern offsets' cast: NaN to 0, saturation at the int32 range,
    on the card as on the CPU (a bare cast saturates on the card and sends
    all of these to INT_MIN on the CPU)."""
    from multicol_slam_tpu_torch.ops.brief import round_to_int32
    x = torch.tensor([float("nan"), float("inf"), -float("inf"), 3e9, -3e9, 2.5, -2.5,
                      2147483520.0, 2.0 ** 31, -2.0 ** 31])
    want = [0, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 1, -2 ** 31, 2, -2, 2147483520,
            2 ** 31 - 1, -2 ** 31]
    assert round_to_int32(x.to(dev)).cpu().tolist() == want
    assert round_to_int32(x).tolist() == want


def _mdbrief_systems():
    """The mdBRIEF system (learned masks, AGAST 7_12) on the card and on the
    CPU, with two frames of bench_trajectory rendered on the card."""
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io, synthetic
    s = config_io.SlamSettings(use_mdbrief=True, learn_masks=True, use_agast=True,
                               fast_agast_type=2)
    card = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, settings=s, enable_loop_closing=False)
    cpu = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, settings=s, enable_loop_closing=False,
                       device="cpu")
    gt = synthetic.bench_trajectory(43)[[0, 8]]
    render = synthetic.make_renderer(card.rig)
    frames = render(torch.tensor(gt, dtype=torch.float32, device=card.device))
    return card, cpu, frames.round().to(torch.uint8)


def test_distorted_pattern_offsets_on_the_card_match_the_cpu(dev):
    """The card's float32 atan2, cos and sin differ from the CPU's in the
    last ulp; at least 99.99% of the pattern points must round alike (the
    bar the CPU holds against the JAX package, tests/test_torch_dbrief.py)."""
    from multicol_slam_tpu_torch.ops import brief
    from multicol_slam_tpu_torch.ops.camera import undistort_points
    card, _, frames = _mdbrief_systems()
    f = card.extract_init(frames[0])
    cams1, cams2 = card.rig.cams.expand(1), card.rig.cams.expand(2)
    und = undistort_points(cams1, f.xy, cams1.p1[..., None])
    pat = torch.from_numpy(brief.make_pattern(256))
    got = brief.distorted_pattern_offsets(cams2, und, pat.to(dev), f.angle).cpu()
    want = brief.distorted_pattern_offsets(type(cams2)(*(t.cpu() for t in cams2)), und.cpu(),
                                           pat, f.angle.cpu())
    same = (got == want).all(-1)
    assert got.shape == (3, 800, 512, 2)
    assert float(same.float().mean()) >= 0.9999, int((~same).sum())


def test_mdbrief_extractor_on_the_card_matches_the_cpu(dev):
    """Both extractors of the mdBRIEF system on one frame: identical
    keypoints, levels and validity; descriptor and mask bits within 1e-4
    of the bits."""
    from multicol_slam_tpu_torch.ops.hamming import unpack_bits_u32
    card, cpu, frames = _mdbrief_systems()
    for name in ("extract", "extract_init"):
        got = getattr(card, name)(frames[1])
        want = getattr(cpu, name)(frames[1].cpu())
        for field in ("xy", "level", "valid"):
            assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), (name, field)
        ok = want.valid
        for field in ("desc", "desc_mask"):
            a = unpack_bits_u32(getattr(got, field).cpu())[ok]
            b = unpack_bits_u32(getattr(want, field))[ok]
            assert float((a != b).float().mean()) <= 1e-4, (name, field)


def test_masked_radius_entry_on_real_stability_masks(dev):
    """Entry A with the mdBRIEF system's own descriptors and stability masks
    (dense, about two thirds of the bits set) at the initialization shape
    (3, 800) x (3, 800) and the local-map shape (1, 1024) x (3, 800):
    equal to its plain version, and the matcher's search equal to its CPU
    path."""
    from multicol_slam_tpu_torch.models import matcher as tm
    card, _, frames = _mdbrief_systems()
    f1, f2 = card.extract_init(frames[0]), card.extract_init(frames[1])
    C, K = f1.valid.shape
    r2 = torch.full((C, K), 2500.0, device=dev)
    zero = torch.zeros_like(f1.level)
    args = [f1.desc, f2.desc, f1.xy, r2, zero, zero, f1.valid & (f1.level == 0),
            f2.xy, f2.level, f2.valid, f1.desc_mask, f2.desc_mask]
    got = _radius_matches_plain([t.contiguous() for t in args])
    assert (got[0] >= 0).sum() > 100
    # 1024 map points shared by the cameras: slots of f1 as points
    pick = torch.arange(1024, device=dev) % (C * K)
    pts_desc = f1.desc.reshape(C * K, -1)[pick][None].contiguous()
    pts_mask = f1.desc_mask.reshape(C * K, -1)[pick][None].contiguous()
    uv = f1.xy.reshape(C * K, 2)[pick][None].expand(C, 1024, 2).contiguous()
    lvl = f1.level.reshape(-1)[pick][None].expand(C, 1024).contiguous()
    ok = f1.valid.reshape(-1)[pick][None].expand(C, 1024).contiguous()
    _radius_matches_plain([pts_desc, f2.desc, uv, torch.full((C, 1024), 144.0, device=dev),
                           lvl - 1, lvl, ok, f2.xy, f2.level, f2.valid, pts_mask, f2.desc_mask])
    params = tm.MatchParams(masked=True)
    match = tm.search_for_initialization(f1, f2, params)
    cpu = lambda f: type(f)(*(t.cpu() for t in f))
    assert torch.equal(match.cpu(), tm.search_for_initialization(cpu(f1), cpu(f2), params))


def test_two_threads_on_their_own_streams_launch_both_entries(dev, monkeypatch):
    """The tracker and the async mapper launch the kernel from two threads,
    each on its own stream. Two threads reach the wrapper first at once
    (the library reset, so the build races), then launch both entries on
    fresh inputs in turn; every result equals its plain version, the
    library is built and loaded once, and every launch is counted."""
    import threading
    builds = []
    build = knn._build_and_load
    monkeypatch.setattr(knn, "_lib", None)
    monkeypatch.setattr(knn, "_build_and_load", lambda: builds.append(1) or build())
    before = knn.hamming_nn.launches, knn.hamming_nn_radius.launches
    barrier, errors, libs = threading.Barrier(2), [], []
    reps = 20

    def worker(seed):
        try:
            stream = torch.cuda.Stream(device=dev)
            gen = torch.Generator(device=dev).manual_seed(seed)
            case = RC.radius_case("common", seed=seed, C=3, N=800, M=800)
            with torch.cuda.stream(stream):
                barrier.wait()
                libs.append(knn.load_library())
                for _ in range(reps):
                    q, db = _words((3, 800, 8), gen, dev), _words((3, 800, 8), gen, dev)
                    gate = torch.rand((3, 800, 800), generator=gen, device=dev) < 0.05
                    got_b = knn.hamming_nn(q, db, gate)
                    args = _radius_args(case, False, dev)
                    got_a = knn.hamming_nn_radius(*args)
                    stream.synchronize()
                    for a, b in zip(got_b, knn.hamming_nn_reference(q, db, gate)):
                        assert torch.equal(a, b)
                    for a, b in zip(got_a, knn.hamming_nn_radius_reference(*args)):
                        assert torch.equal(a, b)
        except BaseException as exc:       # reported on the test's thread
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(builds) == 1 and len(libs) == 2 and libs[0] is libs[1]
    assert knn.hamming_nn.launches == before[0] + 2 * reps
    assert knn.hamming_nn_radius.launches == before[1] + 2 * reps
