"""Batched essential-matrix RANSAC on bearing rays: hypotheses as a batch
axis.

Port of the central relative-pose half of ``multicol_slam_tpu/ops/
ransac.py`` (reference: OpenGV's STEWENIUS 5-pt RANSAC,
cMultiInitializer.cpp:131-146, threshold 1e-4): every minimal sample is
drawn up front, every hypothesis is solved in one batch, all hypotheses
are scored against all correspondences in one dense pass, and the winner
is refit with the 8-point solver on its inliers. The non-central
absolute pose of relocalization (GP3P hypotheses, the GPnP DLT refit;
reference cTracking.cpp:1234-1266) is batched the same way. Sampling
takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch

from .geometry import cayley2rot, cayley_rot_grads, skew, triangulate_midpoint


def sample_minimal_sets(gen: torch.Generator, n_hyps: int, sample_size: int,
                        n_points: int, weights: torch.Tensor | None = None):
    """(n_hyps, sample_size) int64 indices drawn iid, proportional to
    ``weights + 1e-12`` when given (the JAX package draws categorical over
    log(weights + 1e-12)); duplicates within a hypothesis merely waste
    it. The draws follow ``gen``'s device."""
    if weights is None:
        return torch.randint(0, n_points, (n_hyps, sample_size), generator=gen,
                             device=gen.device)
    p = weights.to(torch.float32) + 1e-12
    idx = torch.multinomial(p, n_hyps * sample_size, replacement=True,
                            generator=gen)
    return idx.reshape(n_hyps, sample_size)


# ---------------------------------------------------------------------------
# Essential matrix solvers
# ---------------------------------------------------------------------------

def essential_8pt(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Central relative pose from >= 8 bearing pairs (..., M, 3) with
    v1^T E v2 = 0: the null vector of A^T A (eigh), projected onto the
    essential manifold (singular values 1, 1, 0). Returns (..., 3, 3),
    up to sign and scale."""
    A = (v1[..., :, :, None] * v2[..., :, None, :]).flatten(-2)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    E = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    U, _, Vt = torch.linalg.svd(E)
    s = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * s) @ Vt


def essential_5pt(v1: torch.Tensor, v2: torch.Tensor, cay0: torch.Tensor,
                  t0: torch.Tensor, iters: int = 24):
    """Minimal 5-point relative pose by damped Newton from a seed, batched
    over lanes: v1, v2 (L, 5, 3), seeds cay0, t0 (L, 3). The pose is
    (cayley(3), t(3)) with the gauge |t|^2 = 1 appended to the five
    epipolar constraints; each step solves the damped 6x6 normal
    equations by Cholesky and clips to +-0.5 (the JAX package's
    ``essential_5pt``, with the Jacobian written out in place of
    ``jax.jacfwd``). Returns (E (L, 3, 3), residual norm (L,))."""
    x = torch.cat([cay0, t0], -1)
    eye = torch.eye(6, dtype=x.dtype, device=x.device)

    def F(x):
        R = cayley2rot(x[:, :3])
        t = x[:, 3:]
        E = skew(t) @ R
        ep = torch.einsum("lni,lij,lnj->ln", v1, E, v2)
        gauge = (t * t).sum(-1, keepdim=True) - 1.0
        return torch.cat([ep, gauge], -1), R, t

    for _ in range(iters):
        r, R, t = F(x)
        # d ep / d t_k = v1 . (e_k x R v2) = (R v2 x v1)_k;
        # d ep / d c_m = (dR_m v2) . (v1 x t)
        Rv2 = torch.einsum("lij,lnj->lni", R, v2)
        Jt = torch.linalg.cross(Rv2, v1)
        dRv2 = torch.einsum("lmij,lnj->lnmi", cayley_rot_grads(x[:, :3]), v2)
        Jc = torch.einsum("lnmi,lni->lnm", dRv2, torch.linalg.cross(v1, t[:, None, :]))
        J_ep = torch.cat([Jc, Jt], -1)                              # (L, 5, 6)
        J_g = torch.cat([torch.zeros_like(t), 2.0 * t], -1)[:, None, :]
        J = torch.cat([J_ep, J_g], 1)                               # (L, 6, 6)
        JtJ = J.transpose(-1, -2) @ J + 1e-8 * eye
        # cholesky_ex: no host check of the factorization
        L = torch.linalg.cholesky_ex(JtJ)[0]
        step = torch.cholesky_solve(J.transpose(-1, -2) @ r[..., None], L)[..., 0]
        x = x - torch.clamp(step, -0.5, 0.5)
    r, R, t = F(x)
    return skew(t) @ R, torch.linalg.norm(r, dim=-1)


# rotation seeds (cayley) x translation-direction seeds: small-motion
# basin first (SLAM init is near identity), then axis directions
ESSENTIAL_SEEDS = (
    ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0)),
    ((0.0, 0.0, 0.0), (-1.0, 0.0, 0.0)),
    ((0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
    ((0.0, 0.0, 0.0), (0.0, 0.0, 1.0)),
    ((0.05, -0.05, 0.05), (0.577, 0.577, 0.577)),
    ((-0.05, 0.05, -0.05), (-0.577, 0.577, -0.577)),
)


def decompose_essential(E: torch.Tensor):
    """E (3, 3) -> 4 candidate (R12 (4, 3, 3), t12 (4, 3)) with |t| = 1
    (the U W V^T factorizations). The singular vectors' signs, and so the
    candidates' order, depend on the SVD backend."""
    U, _, Vt = torch.linalg.svd(E)
    d = torch.linalg.det(U) * torch.linalg.det(Vt)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vt * torch.sign(d)
    Rb = U @ W.T @ Vt * torch.sign(d)
    t = U[:, 2]
    return torch.stack([Ra, Ra, Rb, Rb]), torch.stack([t, -t, t, -t])


def _epipolar_err(E: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor):
    """Squared algebraic epipolar residual per pair, E (..., 3, 3) against
    v1, v2 (..., N, 3) (the form of the reference's ray threshold 1e-4)."""
    Ev2 = torch.einsum("...ij,...nj->...ni", E, v2)
    Etv1 = torch.einsum("...ji,...nj->...ni", E, v1)
    num = (v1 * Ev2).sum(-1)
    den = (Ev2[..., :2] ** 2).sum(-1) + (Etv1[..., :2] ** 2).sum(-1)
    return num * num / torch.clamp(den, min=1e-12)


def ransac_essential(gen: torch.Generator, v1: torch.Tensor, v2: torch.Tensor,
                     valid: torch.Tensor, *, threshold: float = 1e-4,
                     n_hyps: int = 256, sample_size: int = 5):
    """Batched essential RANSAC over bearing pairs v1, v2 (N, 3) with
    valid (N,). ``sample_size=5`` (the default, the bootstrap's): each
    minimal 5-point sample is solved from every seed of ESSENTIAL_SEEDS
    (one lane per (sample, seed)), and lanes whose residual stays above
    250 eps are dropped. ``sample_size=8`` (or more): one linear 8-point
    solve (``essential_8pt``) per sample. The best-scoring hypothesis (first on
    ties) is refit with the 8-point solver on its inliers and kept if it
    scores at least as well. Returns (E (3, 3), inlier mask (N,),
    n_inliers).

    Deviation: the Newton iterations run in float64 for float32 inputs.
    Near-degenerate minimal samples leave the root poorly determined in
    float32: on the synthetic rig's bootstrap pair, the winning lane's E
    differed by 0.0044 from its float64 root in the port and by 0.0016 in
    the JAX package, and the bootstrap poses diverged by millimetres;
    solved in float64, the port's poses follow the JAX package's to 1e-5 m
    (tests/test_torch_system.py)."""
    n = v1.shape[0]
    idx = sample_minimal_sets(gen, n_hyps, sample_size, n,
                              valid.to(torch.float32)).to(v1.device)
    dt, dev = v1.dtype, v1.device
    if sample_size == 5:
        cays = torch.tensor([s[0] for s in ESSENTIAL_SEEDS], dtype=dt, device=dev)
        ts = torch.tensor([s[1] for s in ESSENTIAL_SEEDS], dtype=dt, device=dev)
        ts = ts / torch.linalg.norm(ts, dim=-1, keepdim=True)
        n_seeds = len(ESSENTIAL_SEEDS)
        lanes = lambda a: a[:, None].expand((n_hyps, n_seeds) + tuple(a.shape[1:])) \
            .reshape((n_hyps * n_seeds,) + tuple(a.shape[1:]))
        seed = lambda a: a[None].expand((n_hyps,) + tuple(a.shape)).reshape(-1, 3)
        f64 = torch.float64
        Es, res = essential_5pt(lanes(v1[idx]).to(f64), lanes(v2[idx]).to(f64),
                                seed(cays).to(f64), seed(ts).to(f64))
        Es, res = Es.to(dt), res.to(dt)
        # convergence tolerance at the dtype's noise floor
        tol = 250.0 * torch.finfo(dt).eps
        Es = torch.where((res > tol)[:, None, None],
                         torch.full_like(Es, float("inf")), Es)
    else:
        Es = essential_8pt(v1[idx], v2[idx])                      # (S, 3, 3)
    errs = _epipolar_err(Es, v1[None], v2[None])                  # (S, N)
    errs = torch.where(torch.isfinite(errs), errs, torch.full_like(errs, float("inf")))
    inl = (errs < threshold) & valid[None, :]
    scores = inl.sum(1)
    best = torch.argmax(scores)
    # all-inlier refit of the winner, rows weighted by its inlier mask
    wbest = inl[best].to(v1.dtype)[:, None]
    E_ref = essential_8pt(v1 * wbest, v2 * wbest)
    inl_ref = (_epipolar_err(E_ref, v1, v2) < threshold) & valid
    better = inl_ref.sum() >= scores[best]
    E_out = torch.where(better, E_ref, Es[best])
    inl_out = torch.where(better, inl_ref, inl[best])
    return E_out, inl_out, inl_out.sum()


# ---------------------------------------------------------------------------
# Non-central absolute pose (relocalization)
# ---------------------------------------------------------------------------

_PAIRS = ((0, 1), (0, 2), (1, 2))


def gp3p(origins: torch.Tensor, dirs: torch.Tensor, X: torch.Tensor,
         d0: torch.Tensor, iters: int = 16):
    """Minimal 3-point generalized absolute pose by damped Newton, batched
    over lanes (the role of OpenGV's GP3P, cTracking.cpp:1234-1266): the
    depths d (L, 3) place q_i = o_i + d_i f_i in the body frame, and
    rigidity gives |q_i - q_j|^2 = |X_i - X_j|^2 for the three pairs. Each
    step solves the damped 3x3 normal equations by Cholesky, clips to
    +-(0.5 |d| + 1) and keeps depths >= 1e-4; the body pose then follows
    from Horn's alignment at unit scale. The Jacobian is written out: row
    (i, j) is 2 (q_i - q_j) . f_i in column i and its negative with f_j in
    column j.

    origins, dirs, X: (L, 3, 3); d0: (L, 3). Returns (T world->body
    (L, 4, 4), residual norm / (1 + sum |X_i - X_j|^2) (L,))."""
    from .sim3 import horn_alignment

    a = torch.tensor([p[0] for p in _PAIRS], device=X.device)
    b = torch.tensor([p[1] for p in _PAIRS], device=X.device)
    D2 = ((X[:, a] - X[:, b]) ** 2).sum(-1)                    # (L, 3)
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    sel_a = torch.nn.functional.one_hot(a, 3).to(X.dtype)        # (3 pairs, 3)
    sel_b = torch.nn.functional.one_hot(b, 3).to(X.dtype)

    def F(d):
        q = origins + d[..., None] * dirs
        diff = q[:, a] - q[:, b]                                 # (L, 3, 3)
        return (diff * diff).sum(-1) - D2, diff

    d = d0
    for _ in range(iters):
        r, diff = F(d)
        ga = 2.0 * (diff * dirs[:, a]).sum(-1)                   # (L, 3)
        gb = -2.0 * (diff * dirs[:, b]).sum(-1)
        J = ga[..., None] * sel_a + gb[..., None] * sel_b        # (L, 3, 3)
        JtJ = J.transpose(-1, -2) @ J + 1e-9 * eye
        L = torch.linalg.cholesky_ex(JtJ)[0]
        step = torch.cholesky_solve(J.transpose(-1, -2) @ r[..., None], L)[..., 0]
        lim = 0.5 * torch.abs(d) + 1.0
        step = torch.minimum(torch.maximum(step, -lim), lim)
        d = torch.clamp(d - step, min=1e-4)
    r, _ = F(d)
    res = torch.linalg.norm(r, dim=-1) / (1.0 + D2.sum(-1))
    q = origins + d[..., None] * dirs
    # torch.linalg.eigh fails on non-finite input where XLA returns NaN: a
    # diverged lane gets a finite pose here and a NaN residual, which
    # ransac_gpnp rejects
    S = horn_alignment(torch.nan_to_num(q), X, fix_scale=True)  # q = R X + t
    top = torch.cat([S.R, S.t[..., None]], -1)
    bottom = torch.eye(4, dtype=X.dtype, device=X.device)[3:].expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2), res


def _dlt_pose(origins, dirs, X, w):
    """The DLT shared by gpnp_dlt and _refit: rows D (R X + t) = D o with
    D = [dirs]x scaled by w (M,), solved by the 12x12 normal equations;
    R is projected onto SO(3) and the DLT scale moved into t."""
    m = X.shape[0]
    D = skew(dirs) * w[:, None, None]                           # (M, 3, 3)
    A = torch.cat([torch.stack([D * X[:, c][:, None, None] for c in range(3)], 2)
                   .reshape(m, 3, 9), D], 2)                     # (M, 3, 12)
    b = torch.einsum("mij,mj->mi", D, origins)
    Af, bf = A.reshape(-1, 12), b.reshape(-1)
    AtA = Af.T @ Af + 1e-9 * torch.eye(12, dtype=X.dtype, device=X.device)
    # solve_ex: a singular system gives non-finite entries, as in the JAX
    # package, instead of an error; the SVD gets them zeroed
    u = torch.linalg.solve_ex(AtA, Af.T @ bf)[0]
    Rm = torch.nan_to_num(u[:9].reshape(3, 3).T, nan=0.0, posinf=0.0, neginf=0.0)
    U, s, Vt = torch.linalg.svd(Rm)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones((), dtype=X.dtype, device=X.device)
    Rproj = U @ torch.diag(torch.stack([one, one, det])) @ Vt
    scale = s.sum() / 3.0 * det
    t = u[9:12] / torch.where(torch.abs(scale) > 1e-9, scale, one)
    top = torch.cat([Rproj, t[:, None]], 1)
    return torch.cat([top, torch.eye(4, dtype=X.dtype, device=X.device)[3:]], 0)


def gpnp_dlt(origins: torch.Tensor, dirs: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Generalized-camera absolute pose from >= 6 ray / point pairs (the
    gpnp role, cTracking.cpp:1234-1266): (R X + t - o) x d = 0 is linear in
    the 12 entries of [R | t]. origins, dirs: (M, 3) body-frame ray origins
    and unit directions; X: (M, 3) world points. Returns the 4x4
    world->body SE3."""
    return _dlt_pose(origins, dirs, X, torch.ones_like(X[:, 0]))


def _ray_angle_err(T: torch.Tensor, origins, dirs, X) -> torch.Tensor:
    """1 - cos of the angle between each measured ray and the direction to
    its transformed point, T (..., 4, 4) against (N, 3) -> (..., N)."""
    Y = torch.einsum("...ij,nj->...ni", T[..., :3, :3], X) + T[..., None, :3, 3]
    v = Y - origins
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
    return 1.0 - (v * dirs).sum(-1)


DEPTH_SEEDS = (0.3, 1.0, 3.0, 10.0)


def ransac_gpnp(gen: torch.Generator, origins: torch.Tensor, dirs: torch.Tensor,
                X: torch.Tensor, valid: torch.Tensor, *, threshold: float = 1e-4,
                n_hyps: int = 256, sample_size: int = 3):
    """Batched non-central absolute-pose RANSAC (GP3P-RANSAC, threshold
    1e-4 on 1 - cos of the ray angle as cTracking.cpp:1256): each minimal
    3-point sample, drawn among the valid rows, is solved from every depth
    seed of DEPTH_SEEDS (one lane per (sample, seed), 16 Newton steps);
    lanes whose residual stays above 1e-4 are dropped. The best-scoring
    hypothesis (first on ties) is refit with the DLT on its inliers and
    kept if it scores at least as well.

    ``sample_size`` 6 or more (the relocalizer uses 3): one DLT
    (``gpnp_dlt``) per sample in place of GP3P, sample by sample.

    origins, dirs, X: (N, 3); valid (N,). Returns (T world->body (4, 4),
    inlier mask (N,), n_inliers)."""
    n = X.shape[0]
    idx = sample_minimal_sets(gen, n_hyps, sample_size, n,
                              valid.to(torch.float32)).to(X.device)
    if sample_size == 3:
        seeds = torch.tensor(DEPTH_SEEDS, dtype=X.dtype, device=X.device)
        S = len(DEPTH_SEEDS)
        lanes = lambda a: a[idx][:, None].expand(n_hyps, S, 3, 3).reshape(-1, 3, 3)
        d0 = seeds[None, :, None].expand(n_hyps, S, 3).reshape(-1, 3)
        Ts, res = gp3p(lanes(origins), lanes(dirs), lanes(X), d0)
        eye_inf = torch.eye(4, dtype=X.dtype, device=X.device) * float("inf")
        # unconverged lanes, NaN residuals too, score no inliers (in the JAX
        # package a NaN lane's pose is NaN itself)
        Ts = torch.where(~(res <= 1e-4)[:, None, None], eye_inf, Ts)
    else:
        Ts = torch.stack([gpnp_dlt(origins[i], dirs[i], X[i]) for i in idx])
    errs = _ray_angle_err(Ts, origins, dirs, X)                  # (L, N)
    errs = torch.where(torch.isfinite(errs), errs, torch.full_like(errs, float("inf")))
    inl = (errs < threshold) & valid[None, :]
    scores = inl.sum(1)
    best = torch.argmax(scores)
    T_ref = _refit(origins, dirs, X, inl[best])
    inl_ref = (_ray_angle_err(T_ref, origins, dirs, X) < threshold) & valid
    better = inl_ref.sum() >= scores[best]
    T_out = torch.where(better, T_ref, Ts[best])
    inl_out = torch.where(better, inl_ref, inl[best])
    return T_out, inl_out, inl_out.sum()


def _refit(origins, dirs, X, inlier_mask):
    """The DLT on the inliers only (rows weighted by the mask)."""
    return _dlt_pose(origins, dirs, X, inlier_mask.to(X.dtype))


def cheirality_counts(R12s: torch.Tensor, t12s: torch.Tensor, v1: torch.Tensor,
                      v2: torch.Tensor, valid: torch.Tensor):
    """For each candidate (R12, t12), camera 2's pose in camera 1's frame:
    triangulate every pair and count those in front of both cameras (the
    CheckRT vote, cMultiInitializer.cpp:200-307). Returns (counts (4,),
    points (4, N, 3) in camera 1's frame)."""
    X = triangulate_midpoint(t12s[:, None, :], R12s[:, None], v1[None], v2[None])
    z1 = (X * v1[None]).sum(-1)
    X2 = torch.einsum("bji,bnj->bni", R12s, X - t12s[:, None, :])
    z2 = (X2 * v2[None]).sum(-1)
    ok = (z1 > 0) & (z2 > 0) & valid[None]
    return ok.sum(1), X
