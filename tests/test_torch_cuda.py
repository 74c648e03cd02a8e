"""The port's CUDA kernel on the card: the Hamming-NN kernel against its
plain version, both variants, at the WORKING frame's shapes and ragged
ones, with duplicate minima and fully gated rows. Equality is exact.

These tests import no JAX, so they also run where JAX is not installed:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card they skip.
"""

import pytest
import torch

from multicol_slam_tpu_torch.kernels import hamming_nn as knn

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
