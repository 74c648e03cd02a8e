"""Adversarial inputs for the Hamming-NN kernel's entry A
(``kernels.hamming_nn.hamming_nn_radius``), made with numpy from a seed.
No JAX here: the card tests use them too.

Every query copies a distinct database row of its camera (a few bits
flipped) and sits a few pixels from it, so its best match is that row
unless the case's gate says otherwise:

- ``on_radius``: each query's own row lies exactly on its radius (r^2 is
  the float32 d^2 of that pair) in even rows, just outside it in odd rows;
- ``level_edges``: each query's own row sits at lo - 1, lo, hi, hi + 1 of
  its level window, in turn;
- ``fully_gated``: rows with q_ok false, with r^2 = 0, with lo > hi;
- ``duplicate_minima``: the database's second half repeats its first half
  (descriptor, place, level), and queries are exact copies;
- ``broadcast``: one set of queries (Cq = 1) serves every camera;
- ``words4`` / ``words16``: 16- and 64-byte descriptors;
- any other name: the common set-up alone.
"""

import numpy as np

CASES = ("on_radius", "level_edges", "fully_gated", "duplicate_minima",
         "broadcast", "words4", "words16")


def sq_dist(db_xy, q_uv):
    """(C, N, M) float32 squared distance, one rounding per operation, in
    the matchers' order: dx = db_x - q_u, then dx * dx + dy * dy."""
    dx = db_xy[:, None, :, 0] - q_uv[:, :, None, 0]
    dy = db_xy[:, None, :, 1] - q_uv[:, :, None, 1]
    return dx * dx + dy * dy


def radius_case(name, seed=0, C=3, N=96, M=200):
    """Returns a dict of numpy arrays: q (Cq, N, W) and db (C, M, W)
    uint32, q_uv (C, N, 2), q_r2 (C, N) float32, q_lvl_lo / q_lvl_hi (C, N)
    int32, q_ok (C, N) bool, db_xy (C, M, 2) float32, db_lvl (C, M) int32,
    db_ok (C, M) bool, q_mask / db_mask uint32 (about 3 bits in 4 set), and
    src (C, N), each query's own database row."""
    rng = np.random.default_rng(seed)
    W = {"words4": 4, "words16": 16}.get(name, 8)
    Cq = 1 if name == "broadcast" else C

    def words(*shape):
        return rng.integers(0, 2 ** 32, shape, dtype=np.uint32)

    def flips(shape, p):
        bits = (rng.random(shape + (32,)) < p).astype(np.uint64)
        return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)

    db = words(C, M, W)
    db_xy = rng.uniform(0, 120, (C, M, 2)).astype(np.float32)
    db_lvl = rng.integers(0, 5, (C, M)).astype(np.int32)
    db_ok = rng.random((C, M)) < 0.95
    db_mask = words(C, M, W) | words(C, M, W)
    half = M // 2
    if name == "duplicate_minima":
        db_ok[:] = True
        for a in (db, db_xy, db_lvl, db_mask):
            a[:, half:2 * half] = a[:, :half]
    pool = half if name == "duplicate_minima" else M
    # distinct rows where there are enough of them
    draw = lambda: rng.choice(pool, N, replace=N > pool)
    src = np.stack([draw()] * C) if Cq == 1 else np.stack([draw() for _ in range(C)])
    cam = np.arange(C)[:, None]
    q = db[cam, src][:Cq] ^ (0 if name == "duplicate_minima" else flips((Cq, N, W), 0.03))
    q_mask = db_mask[cam, src][:Cq] | words(Cq, N, W)
    q_uv = (db_xy[cam, src] + rng.normal(0, 4, (C, N, 2))).astype(np.float32)
    rows = np.arange(N)
    own = sq_dist(db_xy, q_uv)[cam, rows[None], src]    # d^2 to its own row
    q_r2 = (own + rng.uniform(1, 400, (C, N))).astype(np.float32)
    lvl = db_lvl[cam, src]
    lo, hi = (lvl - 1).astype(np.int32), (lvl + 1).astype(np.int32)
    q_ok = rng.random((C, N)) < 0.95

    if name == "on_radius":
        q_r2 = np.where(rows % 2 == 0, own, np.nextafter(own, np.float32(0)))
        q_r2 = q_r2.astype(np.float32)
    elif name == "level_edges":
        db_lvl[cam, src] = np.stack([lo - 1, lo, hi, hi + 1])[rows % 4, cam, rows]
    elif name == "fully_gated":
        q_ok[:, 0::5] = False
        q_r2[:, 1::5] = 0.0
        q_uv[:, 1::5] += 0.5             # no database point exactly on a query
        lo[:, 2::5], hi[:, 2::5] = 3, 2
    return dict(q=q, db=db, q_uv=q_uv, q_r2=q_r2, q_lvl_lo=lo, q_lvl_hi=hi,
                q_ok=q_ok, db_xy=db_xy, db_lvl=db_lvl, db_ok=db_ok,
                q_mask=q_mask, db_mask=db_mask, src=src)


def dense_gate(case):
    """The (C, N, M) gate of a case, built with numpy in float32."""
    lvl = case["db_lvl"][:, None, :]
    return ((sq_dist(case["db_xy"], case["q_uv"]) <= case["q_r2"][..., None])
            & (lvl >= case["q_lvl_lo"][..., None]) & (lvl <= case["q_lvl_hi"][..., None])
            & case["q_ok"][..., None] & case["db_ok"][:, None, :])
