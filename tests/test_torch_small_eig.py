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

A float64 numpy mirror of the kernels' algorithm (test use only) holds
the design on the CPU: the round-robin schedule (every pair p < q once a
sweep, n = 1..12), ``sym_eig``'s parallel-order Jacobi with its rank
sort, and ``svd3``'s one-sided Jacobi with its compare-and-swap sort and
rank-deficient completion, each within the float32 and float64 sweep
caps and against ``numpy.linalg`` to the bars above.

On the card (``@pytest.mark.cuda``, skipped here) the kernels against
their plain versions at the system's shapes (1024 x 4x4 of GP3P's Horn
alignment, 256 x 4x4 of the loop closer's Sim3 RANSAC, 1-3 x 9x9 of the
8-point refit, 3x3 of the decomposition and the DLT) to the bars above,
their launches counted, a capture and replay of each equal to the eager
launch, and no local memory in the float32 instances the system runs
(n = 4, 9, and svd3). No JAX:

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


# -- a numpy mirror of the kernels' algorithm ----------------------------------

CAPS = {torch.float32: (float(np.finfo(np.float32).eps), 12),
        torch.float64: (float(np.finfo(np.float64).eps), 16)}


def _schedule(n):
    """(m, rounds): n padded to an even m (a dummy index when n is odd),
    and the kernel's rounds, each the (p < q) pairs k = 0..m/2-1 of the
    round-robin that keeps index m - 1 fixed and turns the others."""
    m = n + (n & 1)
    rounds = []
    for r in range(m - 1):
        pairs = []
        for k in range(m // 2):
            a, b = (r, m - 1) if k == 0 else ((r + k) % (m - 1), (r - k + m - 1) % (m - 1))
            pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
    return m, rounds


def _schur2(app, aqq, apq):
    theta = (aqq - app) / (2.0 * apq)
    t = np.copysign(1.0, theta) / (abs(theta) + np.sqrt(theta * theta + 1.0))
    c = 1.0 / np.sqrt(t * t + 1.0)
    return c, t * c


def _before(x, i, y, j):
    """The kernels' strict total order on (value, index): NaNs last, ties
    and NaNs by index."""
    nx, ny = bool(np.isnan(x)), bool(np.isnan(y))
    if nx != ny:
        return ny
    if nx:
        return i < j
    return x < y or (x == y and i < j)


def _ranks(w):
    return [sum(_before(w[k], k, w[j], j) for k in range(len(w))) for j in range(len(w))]


def _mirror_sym_eig(A, eps, cap):
    """sym_eig's algorithm on one matrix in float64: the lower triangle,
    parallel-order Jacobi (a round's rotations G at once: A <- G^T A G with
    each pair's own entry set to 0, V <- V G), the skip rule, the sweep
    cap; values placed by rank. Returns (w, V, sweeps that rotated)."""
    n = A.shape[0]
    m, rounds = _schedule(n)
    lower = np.tril(A)
    a = np.zeros((m, m))
    a[:n, :n] = lower + np.tril(lower, -1).T
    v = np.eye(m)
    sweeps = 0
    for _ in range(cap):
        rotated = False
        for pairs in rounds:
            G, own = np.eye(m), []
            for p, q in pairs:
                if q >= n:
                    continue                  # the dummy index
                apq = a[q, p]
                c, s = 1.0, 0.0
                if not (abs(apq) <= eps * np.sqrt(abs(a[p, p] * a[q, q])) or apq == 0):
                    c, s = _schur2(a[p, p], a[q, q], apq)
                    rotated = True
                G[p, p] = G[q, q] = c
                G[q, p], G[p, q] = -s, s
                own.append((p, q))
            a = G.T @ a @ G
            for p, q in own:
                a[p, q] = a[q, p] = 0.0
            v = v @ G
        if not rotated:
            break
        sweeps += 1
    w = np.diag(a)[:n]
    W, Vo = np.empty(n), np.empty((n, n))
    for j, r in enumerate(_ranks(w)):
        W[r], Vo[:, r] = w[j], v[:n, j]
    return W, Vo, sweeps


def _cas_desc(sig, cols):
    """svd3's sort: compare-and-swap (0, 1), (1, 2), (0, 1), strictly
    greater swaps, moving the columns of each array in ``cols`` along."""
    sig = list(sig)
    for i, j in ((0, 1), (1, 2), (0, 1)):
        if sig[j] > sig[i]:
            sig[i], sig[j] = sig[j], sig[i]
            for c in cols:
                c[:, [i, j]] = c[:, [j, i]]
    return sig


def _complete(a, sig, eps):
    """svd3's U: normalized columns, a column at or below 8 eps of the
    largest completed (u2 from the axis least aligned with u1, made
    orthogonal to it; u3 = u1 x u2)."""
    thr = 8 * eps * sig[0]
    u0 = np.array([1.0, 0.0, 0.0]) if sig[0] <= 0 else a[:, 0] / sig[0]
    mags = np.abs(u0)
    e = (2 if mags[2] < mags[1] else 1) if mags[1] < mags[0] else (2 if mags[2] < mags[0] else 0)
    x = np.eye(3)[e] - u0[e] * u0
    u1 = a[:, 1] / sig[1] if sig[1] > thr else x / np.sqrt(x @ x)
    u2 = a[:, 2] / sig[2] if sig[2] > thr else np.cross(u0, u1)
    return np.stack([u0, u1, u2], 1)


def _mirror_svd3(A, eps, cap):
    """svd3's algorithm on one 3x3 matrix in float64: Hestenes rotations of
    the pairs (0, 1), (0, 2), (1, 2) until a sweep rotates nothing (at most
    cap), column norms, the compare-and-swap sort, the completion.
    Returns (U, S, Vh, sweeps that rotated)."""
    a, v = A.astype(np.float64).copy(), np.eye(3)
    sweeps = 0
    for _ in range(cap):
        rotated = False
        for p, q in ((0, 1), (0, 2), (1, 2)):
            alpha, beta, gamma = a[:, p] @ a[:, p], a[:, q] @ a[:, q], a[:, p] @ a[:, q]
            if gamma == 0 or abs(gamma) <= eps * np.sqrt(alpha * beta):
                continue
            c, s = _schur2(alpha, beta, gamma)
            a[:, [p, q]] = a[:, [p, q]] @ np.array([[c, s], [-s, c]])
            v[:, [p, q]] = v[:, [p, q]] @ np.array([[c, s], [-s, c]])
            rotated = True
        if not rotated:
            break
        sweeps += 1
    sig = _cas_desc(np.linalg.norm(a, axis=0), [a, v])
    return _complete(a, sig, eps), np.array(sig), v.T, sweeps


@pytest.mark.parametrize("n", range(1, 13))
def test_round_robin_takes_every_pair_once_a_sweep(n):
    m, rounds = _schedule(n)
    assert m % 2 == 0 and m - n in (0, 1) and len(rounds) == m - 1
    seen = [pq for pairs in rounds for pq in pairs if pq[1] < n]
    assert sorted(seen) == [(p, q) for p in range(n) for q in range(p + 1, n)]
    for pairs in rounds:                       # a round's pairs are disjoint
        idx = [i for pq in pairs for i in pq]
        assert len(pairs) == m // 2 and len(set(idx)) == m


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mirror_sym_eig_converges_and_matches_numpy(dtype):
    eps, cap = CAPS[dtype]
    for A in _sym_cases(torch.float64):
        for a in A.numpy():
            w, V, sweeps = _mirror_sym_eig(a, eps, cap)
            assert sweeps < cap                # ended by a sweep with no rotation
            w_np, V_np = np.linalg.eigh(a)
            assert np.all(np.diff(w) >= 0)
            _check_eig(torch.tensor(w)[None], torch.tensor(V)[None],
                       torch.tensor(w_np)[None], torch.tensor(V_np)[None], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mirror_svd3_converges_and_matches_numpy(dtype):
    eps, cap = CAPS[dtype]
    for A in _svd_cases(torch.float64):
        for a in A.numpy():
            U, S, Vh, sweeps = _mirror_svd3(a, eps, cap)
            assert sweeps < cap
            # the columns stop rotating once orthogonal to eps of the dtype
            np.testing.assert_allclose(U.T @ U, np.eye(3), atol=100 * eps)
            U_np, S_np, Vh_np = np.linalg.svd(a)
            _check_svd(*(torch.tensor(x)[None] for x in (U, S, Vh, U_np, S_np, Vh_np)),
                       dtype)


def test_rank_sort_is_a_stable_permutation():
    rng = np.random.default_rng(6)
    for _ in range(200):
        n = int(rng.integers(1, 13))
        w = rng.integers(-3, 4, n).astype(np.float64)     # many ties
        w[rng.random(n) < 0.15] = np.nan
        r = _ranks(w)
        assert sorted(r) == list(range(n))
        order = np.empty(n, int)
        order[r] = np.arange(n)
        finite = ~np.isnan(w)
        k = int(finite.sum())
        np.testing.assert_array_equal(order[:k], np.nonzero(finite)[0][
            np.argsort(w[finite], kind="stable")])
        np.testing.assert_array_equal(order[k:], np.nonzero(~finite)[0])


def test_svd3_sort_and_completion():
    """The three compare-and-swaps give the stable descending order (ties
    keep their columns' order) and move the columns with their values;
    the completion gives an orthonormal, right-handed U where columns are
    rank-deficient."""
    eps = float(np.finfo(np.float32).eps)
    for sig in ([1, 2, 3], [3, 2, 1], [2, 3, 2], [1, 1, 2], [2, 1, 1], [0, 0, 0], [5, 5, 5]):
        cols = np.arange(9, dtype=np.float64).reshape(3, 3)
        got = _cas_desc(np.array(sig, np.float64), [cols])
        order = sorted(range(3), key=lambda i: -sig[i])         # stable
        assert got == [sig[i] for i in order]
        np.testing.assert_array_equal(cols, np.arange(9).reshape(3, 3)[:, order])
    rng = np.random.default_rng(7)
    u, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    for s in ([1, 1, 0], [3, 0, 0], [0, 0, 0]):
        a = u * np.array(s, np.float64)
        U = _complete(a, list(map(float, s)), eps)
        np.testing.assert_allclose(U.T @ U, np.eye(3), atol=1e-12)
        if s[0] > 0:
            np.testing.assert_allclose(U[:, 0], u[:, 0], atol=1e-12)
        np.testing.assert_allclose(np.linalg.det(U), 1.0, atol=1e-12)


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
    """1024 x 4x4 (GP3P's Horn alignment), 256 x 4x4 (the loop closer's
    Sim3 RANSAC), 3 x 9x9 and 9x9 (the 8-point refit), with the seeded
    cases above."""
    rng = np.random.default_rng(seed)
    a4 = rng.standard_normal((1024, 4, 4))
    a9 = rng.standard_normal((3, 30, 9))
    cases = [a4 + a4.transpose(0, 2, 1), (a4 + a4.transpose(0, 2, 1))[:256],
             a9.transpose(0, 2, 1) @ a9, (a9.transpose(0, 2, 1) @ a9)[0]]
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
@pytest.mark.parametrize("case", [0, 1], ids=["1024x4x4", "256x4x4"])
def test_kernels_capture_and_replay(dev, case):
    A = _system_shapes(torch.float32)[case].to(dev)
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


@pytest.mark.cuda
@pytest.mark.parametrize("entry, n", [("sym_eig", 4), ("sym_eig", 9), ("svd3", 3)])
def test_float32_instances_use_no_local_memory(dev, entry, n):
    """The float32 instances the system launches (Horn's 4x4, the 8-point
    refit's 9x9, the 3x3 SVD) keep every matrix in registers: no local
    (stack) bytes, by cudaFuncGetAttributes."""
    attrs = se.kernel_attributes(entry, n, torch.float32, dev)
    assert attrs["local_bytes"] == 0, attrs
    assert attrs["registers"] > 0
