"""The small eigensolvers of the graphed RANSAC (``kernels/small_eig.py``,
``csrc/small_eig.cu``): ``sym_eig`` (symmetric n x n, n <= 12) and ``svd3``
(3x3), with ``torch.linalg.eigh`` / ``svd`` as their plain versions.

On the CPU:
  - the plain versions against ``numpy.linalg.eigh`` / ``svd`` on seeded
    matrices, with repeated and zero eigenvalues and an essential matrix's
    singular values (s, s, 0): values within 1e-5 of the largest (float32)
    or 1e-12 (float64), vectors within 1e-4 after a per-column sign
    alignment, where the value's gap to its neighbours exceeds 1e-3 of the
    largest (a repeated value's vectors are any basis of its space);
  - the device rule (a CPU tensor takes the plain version, another device
    raises) and the input checks;
  - the bootstrap (``initialize_device`` on frames 0 and 8 at full width)
    chooses the same candidate, the same leading camera and ``n_good``
    when ``decompose_essential``'s singular vectors flip sign: the four
    candidates are one set, scored by cheirality, not by their order.

On the card (``@pytest.mark.cuda``, skipped here) the kernels against
their plain versions at the system's shapes (1024 x 4x4 of GP3P's Horn
alignment, 1-3 x 9x9 of the 8-point refit, 3x3 of the decomposition and
the DLT) to the bars above, their launches counted, and a capture and
replay of each equal to the eager launch. No JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_small_eig.py
"""

import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch.kernels import small_eig as se

VAL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
VEC_TOL = 1e-4
GAP = 1e-3


def _sym_cases(dtype, seed=0):
    """Seeded symmetric matrices: random of each size 2-12, the 4x4 and 9x9
    of the system's shapes, repeated and zero eigenvalues."""
    rng = np.random.default_rng(seed)
    out = []
    for n in range(2, 13):
        a = rng.standard_normal((5, n, n))
        out.append(a + a.transpose(0, 2, 1))
    a = rng.standard_normal((64, 9, 9))
    out.append(a.transpose(0, 2, 1) @ a)              # A^T A, the 8-point refit's
    q, _ = np.linalg.qr(rng.standard_normal((6, 4, 4)))
    for vals in ([1, 1, 2, 3], [0, 0, 1, 5], [2, 2, 2, 2], [0, 1, 1, 0]):
        out.append(q @ np.diag(vals)[None] @ q.transpose(0, 2, 1))
    return [torch.tensor(x, dtype=dtype) for x in out]


def _svd_cases(dtype, seed=1):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((32, 3, 3))]
    u, _ = np.linalg.qr(rng.standard_normal((8, 3, 3)))
    v, _ = np.linalg.qr(rng.standard_normal((8, 3, 3)))
    for s in ([1, 1, 0], [2, 1, 0], [3, 0, 0], [1, 1, 1], [0, 0, 0]):
        out.append(u @ np.diag(s)[None] @ v.transpose(0, 2, 1))
    return [torch.tensor(x, dtype=dtype) for x in out]


def _aligned_err(got, want, vals):
    """Max |diff| of the columns of got and want, each column's sign
    aligned, over the columns whose value is apart from its neighbours."""
    scale = vals.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    gap = torch.full_like(vals, float("inf"))
    d = (vals[..., 1:] - vals[..., :-1]).abs()
    gap[..., 1:] = torch.minimum(gap[..., 1:], d)
    gap[..., :-1] = torch.minimum(gap[..., :-1], d)
    sign = torch.sign((got * want).sum(-2, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    err = (got * sign - want).abs().amax(-2)
    return float(torch.where(gap > GAP * scale, err, torch.zeros_like(err)).max())


def _check_eig(w, V, w_ref, V_ref, dtype):
    """w, V against w_ref, V_ref (all float64) at the bars of ``dtype``."""
    scale = w_ref.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    assert float(((w - w_ref).abs() / scale).max()) <= VAL_TOL[dtype]
    assert _aligned_err(V, V_ref, w_ref) <= VEC_TOL


def _check_svd(U, S, Vh, U_ref, S_ref, Vh_ref, dtype):
    """The SVD (float64 tensors) against the reference at ``dtype``'s bars."""
    scale = S_ref[..., :1].clamp(min=1e-30)
    assert float(((S - S_ref).abs() / scale).max()) <= VAL_TOL[dtype]
    # a column is compared where its singular value is apart from the others
    assert _aligned_err(U, U_ref, S_ref) <= VEC_TOL
    assert _aligned_err(Vh.transpose(-1, -2), Vh_ref.transpose(-1, -2), S_ref) <= VEC_TOL
    rec = (U * S[..., None, :]) @ Vh
    ref = (U_ref * S_ref[..., None, :]) @ Vh_ref
    assert float((rec - ref).abs().max()) <= 10 * VAL_TOL[dtype] * float(scale.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_eig_matches_numpy(dtype):
    for A in _sym_cases(dtype):
        w, V = se.sym_eig(A)
        w_np, V_np = np.linalg.eigh(A.double().numpy())
        _check_eig(w.double(), V.double(), torch.tensor(w_np), torch.tensor(V_np), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_svd_matches_numpy(dtype):
    for A in _svd_cases(dtype):
        U, S, Vh = se.svd3(A)
        U_np, S_np, Vh_np = np.linalg.svd(A.double().numpy())
        _check_svd(U.double(), S.double(), Vh.double(), torch.tensor(U_np),
                   torch.tensor(S_np), torch.tensor(Vh_np), dtype)


def test_cpu_tensors_take_the_plain_version():
    A = _sym_cases(torch.float32)[2]
    w, V = se.sym_eig(A)
    w_ref, V_ref = torch.linalg.eigh(A)
    assert torch.equal(w, w_ref) and torch.equal(V, V_ref)
    B = _svd_cases(torch.float64)[0]
    for a, b in zip(se.svd3(B), torch.linalg.svd(B)):
        assert torch.equal(a, b)
    assert se.sym_eig.launches == 0 and se.svd3.launches == 0


def test_input_checks_and_devices():
    with pytest.raises(ValueError):
        se.sym_eig(torch.zeros(3, 4))
    with pytest.raises(ValueError):
        se.sym_eig(torch.zeros(13, 13))
    with pytest.raises(TypeError):
        se.sym_eig(torch.zeros(3, 3, dtype=torch.int32))
    with pytest.raises(ValueError):
        se.svd3(torch.zeros(2, 4, 4))
    with pytest.raises(RuntimeError, match="no kernel"):
        se.sym_eig(torch.zeros(4, 4, device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        se.svd3(torch.zeros(3, 3, device="meta"))


def test_bootstrap_ignores_the_sign_of_the_singular_vectors(monkeypatch):
    """initialize_device on frames 0 and 8 with the decomposition's singular
    vectors as returned, and with columns 0 and 2 of U (rows of Vh) negated
    (then column 1 alone): the same chosen pose per camera, good masks,
    n_good and leading camera."""
    from multicol_slam_tpu_torch.models import initializer, matcher
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.ops import ransac
    from multicol_slam_tpu_torch.utils import config_io, synthetic

    torch.set_num_threads(2)
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, device="cpu",
                        enable_loop_closing=False)
    gt = synthetic.bench_trajectory(9)
    render = synthetic.make_renderer(slam.rig)
    frames = torch.round(render(torch.tensor(gt[[0, 8]], dtype=torch.float32)))
    f0, f1 = (slam._extract_init_padded(f) for f in frames.to(torch.uint8))

    def run():
        cand = initializer.initialize_device(torch.Generator().manual_seed(42), slam.rig,
                                             f0, f1, matcher.MatchParams())
        cand = initializer.InitCandidate(*(t.numpy() for t in cand))
        return cand, initializer.pick_leading_camera(cand, slam.rig)

    base, lead = run()
    assert lead is not None
    svd = ransac.svd3
    for cols in ((0, 2), (1,)):
        flip = torch.ones(3, dtype=torch.float32)
        flip[list(cols)] = -1.0

        def flipped(A, _flip=flip):
            U, S, Vh = svd(A)
            f = _flip.to(A.dtype)
            return U * f, S, Vh * f[:, None]
        monkeypatch.setattr(ransac, "svd3", flipped)
        cand, lead2 = run()
        monkeypatch.setattr(ransac, "svd3", svd)
        assert lead2 is not None and lead2.lead_cam == lead.lead_cam
        np.testing.assert_array_equal(cand.n_good, base.n_good)
        np.testing.assert_array_equal(cand.good, base.good)
        np.testing.assert_allclose(cand.R12, base.R12, rtol=0, atol=1e-5)
        np.testing.assert_allclose(cand.t12, base.t12, rtol=0, atol=1e-5)


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the small eigensolver kernels are CUDA only")
    return torch.device("cuda", 0)


def _system_shapes(dtype, seed=3):
    """1024 x 4x4 (GP3P's Horn alignment), 3 x 9x9 and 9x9 (the 8-point
    refit), with the seeded cases above."""
    rng = np.random.default_rng(seed)
    a4 = rng.standard_normal((1024, 4, 4))
    a9 = rng.standard_normal((3, 30, 9))
    cases = [a4 + a4.transpose(0, 2, 1), a9.transpose(0, 2, 1) @ a9,
             (a9.transpose(0, 2, 1) @ a9)[0]]
    return [torch.tensor(x, dtype=dtype) for x in cases] + _sym_cases(dtype, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sym_eig_kernel_matches_plain(dev, dtype):
    n0 = se.sym_eig.launches
    cases = _system_shapes(dtype)
    for A in cases:
        w, V = se.sym_eig(A.to(dev))
        w_ref, V_ref = se.sym_eig_reference(A.to(dev))
        torch.cuda.synchronize()
        _check_eig(w.double().cpu(), V.double().cpu(), w_ref.double().cpu(),
                   V_ref.double().cpu(), dtype)
    assert se.sym_eig.launches == n0 + len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_svd3_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(4)
    cases = [torch.tensor(rng.standard_normal((3, 3)), dtype=dtype)] + _svd_cases(dtype)
    n0 = se.svd3.launches
    for A in cases:
        got = se.svd3(A.to(dev))
        want = se.svd3_reference(A.to(dev))
        torch.cuda.synchronize()
        _check_svd(*(t.double().cpu() for t in got), *(t.double().cpu() for t in want),
                   dtype)
    assert se.svd3.launches == n0 + len(cases)


@pytest.mark.cuda
def test_kernels_capture_and_replay(dev):
    A = _system_shapes(torch.float32)[0].to(dev)
    B = _svd_cases(torch.float32)[0].to(dev)
    eager = (se.sym_eig(A), se.svd3(B))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = (se.sym_eig(A), se.svd3(B))
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(outs, eager):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
