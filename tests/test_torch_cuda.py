"""The port's CUDA kernel on the card: both entries of the Hamming-NN
kernel against their plain versions, both variants, at the system's
shapes and ragged ones, with duplicate minima, fully gated rows and the
adversarial cases of tests/_radius_cases.py. Equality is exact.

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
