"""The pose LM kernel (``kernels/pose_lm.py``, ``csrc/pose_lm.cu``): one
launch a ``pose_optimization`` call on the card, both LM rounds and the
gate between them, each round stopping on the device once it is done.

On the CPU, two mirrors of the kernel's loop (test use only), each a
round that breaks out once an accepted step's gain is under GAIN_EPS and
takes H and g from the accepted pass:
  - on the plain version's own evaluations (``optimizer.pose_lm_parts``),
    equal to the plain version (the fixed loop of masked updates) bit for
    bit: pose, inlier mask, count and iterations, in float64 and float32,
    on ``test_torch_optimizer.py``'s seeds, on a table with no valid row,
    on a singular one (every weight 0, so H = 0 and lam = 0: the solve
    gives a non-finite step, rejected) and on a round 1 that ends early by
    gain;
  - with the kernel's fixed order of the sums (the rows cut into CLUSTER
    ranges, one a CTA; in a CTA each of THREADS threads over its rows in
    row order, the warp's lanes as a shuffle-down tree, the warps in warp
    order; then the CTAs in rank order) and its LU solve, against the JAX
    package: float64 within 1e-12 with equal iterations and masks,
    float32 within 1e-4 (the bar of ``test_torch_optimizer.py``) with
    equal masks; that order adds every row once at row counts that leave
    ranks empty or partly filled, and the kernel's butterfly over a
    warp's lanes groups them as the shuffle-down tree, bit for bit;
  - the wrapper's argument checks;
  - the clock reads of ``tools/pose_lm_study.py --marks`` still fit the
    kernel source (the kernel itself holds none).

On the card (``@pytest.mark.cuda``, skipped here; no JAX in this file's
imports) the kernel against the plain version on the same cases:
float64 pose within 1e-10, masks and iterations equal; float32: round 1
alone (``iters2=0``, whose inliers are the gate round 2 runs on) within
1e-4, gate rows and final inliers differing only where chi2 lies within
1e-3 relative of huber^2, and, where the two gates agree, the final pose
within 1e-4 (a gate row that flips gives round 2 another problem, as
``chip_smoke.py`` phase 18 found on a recorded local-map call: the
poses 2.9e-4 apart, round 1 within 1.1e-5); a graph's replay equal to
the eager launch,
launches counted, no local memory in the float32 instance, a cluster of
more than one CTA; the same bars at row counts that leave ranks of the
cluster empty or partly filled (0, 1, one CTA's threads + 1, 7,344). The float32
iteration count, and the robust costs at the two poses, are measured and
not held here: in float32 a 1e-6 relative gain is below the rounding of
the cost sum, so where a round stops depends on the order of the sums
(``chip_smoke.py`` phase 18 holds every recorded call's iterations
within what running its rows in other orders moves them by). The
plain version against
itself with the rows reversed (the same terms summed in another order)
parts by 0 to 7 of 20 iterations on seeds 0-7, by more than 2 on five,
and by none in float64 (``python3 tools/pose_lm_study.py --orders``, on
the CPU). On the card's machine:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pose_lm.py
"""

import re

import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch.kernels import pose_lm as K
from multicol_slam_tpu_torch.models import optimizer as topt

from _poseutil import in_dtype, problem, rig

SEEDS = (0, 1, 2)
_SRC = open(K.SOURCE).read()
THREADS = int(re.search(r"#define POSE_LM_THREADS (\d+)", _SRC).group(1))
CLUSTER = int(re.search(r"#define POSE_LM_CLUSTER (\d+)", _SRC).group(1))
WARPS = THREADS // 32
F32_BAND = 1e-3        # chi2 within this of huber^2 (relative) may flip in float32


def _case(name, dtype):
    """(rig, mt0, obs, X, keywords) of a named case in ``dtype``."""
    seed = int(name[4:]) if name.startswith("seed") else 0
    obs, X, mt0, _ = problem(seed)
    obs, X, mt0 = in_dtype(obs, X, mt0, dtype)
    kw = {}
    if name == "no_valid":
        obs = obs._replace(valid=torch.zeros_like(obs.valid))
    elif name == "singular":
        obs = obs._replace(inv_sigma2=torch.zeros_like(obs.inv_sigma2))
    elif name == "early":
        kw = dict(iters1=12, iters2=3)
    return rig(dtype), mt0, obs, X, kw


CASES = [f"seed{s}" for s in SEEDS] + ["no_valid", "singular", "early"]


# -- the mirrors -----------------------------------------------------------------

def _lm(mt0, obs, evaluate, solve, chi2_at, *, huber, iters1, iters2):
    """The kernel's loop: ``evaluate(mt, w)`` -> (cost, H (6, 6), g (6,)),
    ``solve(H, lam, g)`` -> d, ``chi2_at(mt)`` -> chi2 (K,). Returns
    (mt, inlier, n_inliers, iterations, (round 1's, round 2's))."""
    delta2 = huber * huber

    def lm_round(mt, w, iters):
        cost, H, g = evaluate(mt, w)
        lam = topt.LM_TAU * torch.diagonal(H).max()
        it = 0
        while it < iters:
            mt_new = mt - solve(H, lam, g)
            cost_new, H_new, g_new = evaluate(mt_new, w)
            accept = bool(cost_new < cost)
            gain = (cost - cost_new) / torch.clamp(cost_new, min=1e-12)
            it += 1
            if accept:
                mt, cost, H, g, lam = mt_new, cost_new, H_new, g_new, lam * 0.5
            else:
                lam = lam * 4.0
            if accept and bool(gain < topt.GAIN_EPS):
                break
        return mt, it

    mt1, it1 = lm_round(mt0, obs.valid, iters1)
    inlier = obs.valid & (chi2_at(mt1) <= delta2)
    mt2, it2 = lm_round(mt1, inlier, iters2)
    final = obs.valid & (chi2_at(mt2) <= delta2)
    return (mt2, final, final.sum(), torch.tensor(it1 + it2, dtype=torch.int32),
            (it1, it2))


def early_exit_mirror(rig_, mt0, obs, X, *, huber=topt.HUBER_POSE, iters1=10, iters2=10):
    """The kernel's loop on the plain version's evaluations and solve."""
    chi2_of, hess, _ = topt.pose_lm_parts(rig_, obs, X, huber)
    eye = torch.eye(6, dtype=mt0.dtype)

    def evaluate(mt, w):
        return (chi2_of(mt, w)[1],) + hess(mt, w)

    return _lm(mt0, obs, evaluate,
               lambda H, lam, g: torch.linalg.solve_ex(H + lam * eye, g)[0],
               lambda mt: chi2_of(mt, obs.valid)[0],
               huber=huber, iters1=iters1, iters2=iters2)


def warp_sum(lanes: torch.Tensor) -> torch.Tensor:
    """(..., 32, n) -> (..., n): the shuffle-down tree, lane l adding lane
    l + 16, then 8, 4, 2, 1 (lanes past 31 read their own value)."""
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + torch.cat([lanes[..., off:, :], lanes[..., 32 - off:, :]], -2)
    return lanes[..., 0, :]


def butterfly_sums(lanes: torch.Tensor) -> torch.Tensor:
    """(32, 32) -> (32,): the kernel's ``warp_sums``, lane l's 32 terms
    (28 and 4 zeros) to term l's sum in lane l: at step w = 16, 8, 4, 2, 1
    each lane keeps the half of its terms that its bit w picks and adds its
    partner's (lane l ^ w) copy of that half."""
    v = [lanes[:, i] for i in range(32)]             # v[i][lane]
    lane = torch.arange(32)
    for w in (16, 8, 4, 2, 1):
        up = (lane & w) != 0
        nxt = []
        for i in range(w):
            send = torch.where(up, v[i], v[i + w])
            keep = torch.where(up, v[i + w], v[i])
            nxt.append(keep + send[lane ^ w])
        v = nxt
    return v[0]


def kernel_order_sum(v: torch.Tensor) -> torch.Tensor:
    """Column sums of v (K, n) in the kernel's order: CTA rank r of the
    CLUSTER owns rows [r c, (r + 1) c), c = ceil(K / CLUSTER); in a CTA,
    row k on thread (k - r c) % THREADS, each thread in row order, then
    each warp's 32 threads as the shuffle-down tree (``warp_sum``; the
    kernel's butterfly groups them the same way), then the CTA's warps in
    warp order; then the ranks' sums in rank order."""
    K_, n = v.shape
    chunk = -(-K_ // CLUSTER)
    total = None
    for r in range(CLUSTER):
        lo, hi = min(K_, r * chunk), min(K_, r * chunk + chunk)
        steps = -(-(hi - lo) // THREADS)
        acc = torch.zeros(THREADS, n, dtype=v.dtype)
        pad = torch.cat([v[lo:hi], torch.zeros(steps * THREADS - (hi - lo), n, dtype=v.dtype)])
        for s in range(steps):
            acc = acc + pad[s * THREADS:(s + 1) * THREADS]
        parts = warp_sum(acc.reshape(WARPS, 32, n))
        cta = parts[0]
        for w in range(1, WARPS):
            cta = cta + parts[w]
        total = cta if total is None else total + cta
    return total


def lu_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's solve: LU with partial pivoting (first largest |a|),
    no check, in A's dtype."""
    dt = np.float64 if A.dtype == torch.float64 else np.float32
    a = [[dt(x) for x in row] for row in A.tolist()]
    y = [dt(x) for x in b.tolist()]
    with np.errstate(all="ignore"):
        for k in range(6):
            p = k
            for i in range(k + 1, 6):
                if abs(a[i][k]) > abs(a[p][k]):
                    p = i
            a[k], a[p], y[k], y[p] = a[p], a[k], y[p], y[k]
            for i in range(k + 1, 6):
                lk = a[i][k] / a[k][k]
                a[i] = a[i][:k + 1] + [a[i][j] - lk * a[k][j] for j in range(k + 1, 6)]
                y[i] = y[i] - lk * y[k]
        x = [dt(0)] * 6
        for i in range(5, -1, -1):
            s = y[i]
            for j in range(i + 1, 6):
                s = s - a[i][j] * x[j]
            x[i] = s / a[i][i]
    return torch.tensor(np.array(x, dt))


def kernel_order_mirror(rig_, mt0, obs, X, *, huber=topt.HUBER_POSE, iters1=10,
                        iters2=10):
    """The kernel's loop with its order of the sums and its solve, on the
    plain version's terms by row."""
    chi2_of, _, rows = topt.pose_lm_parts(rig_, obs, X, huber)
    iu = torch.triu_indices(6, 6)

    def evaluate(mt, w):
        r, J, wt = rows(mt, w)
        chi2 = (r * r).sum(-1) * obs.inv_sigma2
        e = torch.sqrt(chi2)
        rho = torch.where(e <= huber, chi2, 2 * huber * e - huber * huber)
        cost = torch.where(w, rho, torch.zeros_like(rho))
        wJ = J * wt[:, None, None]
        Hk = wJ[:, 0, iu[0]] * J[:, 0, iu[1]] + wJ[:, 1, iu[0]] * J[:, 1, iu[1]]
        gk = wJ[:, 0] * r[:, :1] + wJ[:, 1] * r[:, 1:]
        tot = kernel_order_sum(torch.cat([cost[:, None], Hk, gk], 1))
        H = torch.zeros(6, 6, dtype=mt.dtype)
        H[iu[0], iu[1]] = tot[1:22]
        H[iu[1], iu[0]] = tot[1:22]
        return tot[0], H, tot[22:]

    eye = torch.eye(6, dtype=mt0.dtype)
    return _lm(mt0, obs, evaluate, lambda H, lam, g: lu_solve(H + lam * eye, g),
               lambda mt: chi2_of(mt, obs.valid)[0],
               huber=huber, iters1=iters1, iters2=iters2)


# -- the CPU tests ---------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_early_exit_mirror_equals_plain(dtype, name):
    rig_, mt0, obs, X, kw = _case(name, dtype)
    want = topt.pose_optimization_reference(rig_, mt0, obs, X, **kw)
    got = early_exit_mirror(rig_, mt0, obs, X, **kw)
    for a, b, what in zip(got[:4], want, ("pose", "inliers", "count", "iterations")):
        assert a.dtype == b.dtype and torch.equal(a, b), (what, a, b)
    it1, it2 = got[4]
    if name == "no_valid":
        assert int(want[2]) == 0 and it1 == it2 == 10 and torch.equal(want[0], mt0)
    if name == "singular":
        assert it1 == it2 == 10 and torch.equal(want[0], mt0)
    if name == "early":
        assert it1 < 12, it1           # round 1 stopped by gain, not by iters1


def test_cpu_takes_the_plain_version():
    """On a CPU tensor pose_optimization is the plain version, bit for
    bit, with its dtypes: pose in the input's, a bool mask, an int64
    count, int32 iterations."""
    rig_, mt0, obs, X, _ = _case("seed0", torch.float32)
    got = topt.pose_optimization(rig_, mt0, obs, X)
    want = topt.pose_optimization_reference(rig_, mt0, obs, X)
    assert [t.dtype for t in got] == [torch.float32, torch.bool, torch.int64, torch.int32]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_kernel_order_mirror_matches_jax(dtype, seed):
    import jax
    import jax.numpy as jnp

    from multicol_slam_tpu.models import optimizer as jopt
    from multicol_slam_tpu.ops import rig as jrig
    from multicol_slam_tpu.utils import config_io as jcio
    from multicol_slam_tpu_torch.utils import config_io as tcio

    t_dt = torch.float64 if dtype == "f64" else torch.float32
    np_dt = np.float64 if dtype == "f64" else np.float32
    rig_, mt0, obs, X, _ = _case(f"seed{seed}", t_dt)
    mt, inl, n_in, it, _ = kernel_order_mirror(rig_, mt0, obs, X)
    jr = jrig.scale_rig(jcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=np_dt)[0], 0.5)
    to_jax = lambda t: jnp.asarray(t.numpy())
    with jax.enable_x64(dtype == "f64"):
        j_mt, j_inl, j_n, j_it = jopt.pose_optimization(
            jax.tree.map(jnp.asarray, jr), to_jax(mt0),
            jopt.BAObservations(*(to_jax(t) for t in obs)), to_jax(X))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(j_inl))
    assert int(n_in) == int(j_n)
    if dtype == "f64":
        assert int(it) == int(j_it), (int(it), int(j_it))
        np.testing.assert_allclose(mt.numpy(), np.asarray(j_mt), rtol=0, atol=1e-12)
    else:
        np.testing.assert_allclose(mt.numpy(), np.asarray(j_mt), rtol=0, atol=1e-4)


# row counts that leave ranks empty (0, 1), fill every rank partly (one
# CTA's threads + 1), give a thread two rows (a cluster's threads + 1) and
# the phase-4 local map's 7,344
ROW_COUNTS = (0, 1, 31, THREADS - 1, THREADS, THREADS + 1, 2400, CLUSTER * THREADS + 1, 7344)


@pytest.mark.parametrize("n", ROW_COUNTS)
def test_kernel_order_sum_is_a_sum(n):
    """The mirror's order adds every row once: against float64 sums of
    integers (exact in any order)."""
    v = torch.arange(n * 3, dtype=torch.float64).reshape(n, 3) % 7
    assert torch.equal(kernel_order_sum(v), v.sum(0)), n


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_butterfly_groups_as_the_shuffle_tree(dtype):
    """The kernel's warp sums (a butterfly, term n to lane n) equal the
    shuffle-down tree's bit for bit, on terms of mixed scale and sign."""
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        lanes = (torch.randn(32, 32, generator=gen, dtype=torch.float64)
                 * 10.0 ** torch.randint(-6, 7, (32, 32), generator=gen)).to(dtype)
        lanes[:, 28:] = 0
        want = warp_sum(lanes[None])[0]
        assert torch.equal(butterfly_sums(lanes), want)


def test_wrapper_checks_raise():
    rig_, mt0, obs, X, _ = _case("seed0", torch.float32)
    K.check(rig_, mt0, obs, X)                      # what the kernel reads passes
    with pytest.raises(RuntimeError, match="no kernel for cpu"):
        K.pose_lm(rig_, mt0, obs, X, huber=topt.HUBER_POSE, iters1=10, iters2=10,
                  tau=topt.LM_TAU, gain_eps=topt.GAIN_EPS)
    bad = [
        (TypeError, "no kernel for torch.float16",
         (rig_, mt0.half(), obs, X)),
        (TypeError, "X_world is torch.float64",
         (rig_, mt0, obs, X.double())),
        (TypeError, "obs.cam is torch.int64",
         (rig_, mt0, obs._replace(cam=obs.cam.long()), X)),
        (TypeError, "obs.valid is torch.uint8",
         (rig_, mt0, obs._replace(valid=obs.valid.to(torch.uint8)), X)),
        (ValueError, "obs.uv is not contiguous",
         (rig_, mt0, obs._replace(uv=obs.uv.t().contiguous().t()), X)),
        (ValueError, "X_world has shape",
         (rig_, mt0, obs, X[:, :2].contiguous())),
        (ValueError, "obs.inv_sigma2 has shape",
         (rig_, mt0, obs._replace(inv_sigma2=obs.inv_sigma2[:-1]), X)),
        (ValueError, "mt_min0 has shape",
         (rig_, mt0[:5], obs, X)),
        (ValueError, "inverse polynomial coefficients",
         (rig_._replace(cams=rig_.cams._replace(inv_poly=rig_.cams.inv_poly[:, :1].contiguous())),
          mt0, obs, X)),
        (RuntimeError, "obs.uv is on meta",
         (rig_, mt0, obs._replace(uv=obs.uv.to("meta")), X)),
    ]
    for exc, msg, args in bad:
        with pytest.raises(exc, match=re.escape(msg)):
            K.check(*args)
    with pytest.raises(ValueError, match="no pose LM kernel"):
        K.kernel_attributes(torch.float16)


def test_outputs_and_arguments_match_the_c_interface():
    """The launch arguments line up with the library's declared C
    interface, and the outputs are allocated as the plain version returns
    them."""
    import ctypes

    class Lib:
        pose_lm_launch = type("F", (), {})()
        pose_lm_init = type("F", (), {})()
        pose_lm_attributes = type("F", (), {})()

    lib = Lib()
    K.bind(lib)
    rig_, mt0, obs, X, _ = _case("seed0", torch.float64)
    out = K.outputs_like(mt0, obs.uv.shape[0])
    assert [(t.dtype, tuple(t.shape)) for t in out] == [
        (torch.float64, (6,)), (torch.bool, (600,)), (torch.int64, ()), (torch.int32, ())]
    args = K.arguments(rig_, mt0, obs, X, out, huber=1.0, iters1=3, iters2=4, tau=1e-5,
                       gain_eps=1e-6)
    types = lib.pose_lm_launch.argtypes
    assert len(args) + 1 == len(types)              # the stream last
    for a, t in zip(args, types):
        want = {ctypes.c_void_p: int, ctypes.c_int: int, ctypes.c_longlong: int,
                ctypes.c_double: float}[t]
        assert isinstance(a, want), (a, t)
    assert args[-1] == 1 and args[7:9] == (3, 16)   # float64; C cameras, npoly


def test_study_marks_copy_patches_the_kernel(tmp_path, monkeypatch):
    """``tools/pose_lm_study.py --marks`` times a pass's stages on a copy of
    the kernel source with clock reads put in at fixed anchors: each
    anchor stands once in the source, so the copy holds all seven marks,
    and the kernel itself holds none."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(K.SOURCE), "..", "..", "tools", "pose_lm_study.py")
    spec = importlib.util.spec_from_file_location("pose_lm_study", path)
    study = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(study)
    monkeypatch.setattr(study, "STUDY_DIR", str(tmp_path))
    text = open(study.write_marks(K.SOURCE)).read()
    assert [f"s.marks[{i}] += now - s.mark_t;" in text for i in range(7)] == [True] * 7
    assert "pose_lm_marks_read" in text and "s.mark_t = clock64();" in text
    assert "clock64" not in _SRC and "s.marks" not in _SRC


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _to(dev, rig_, mt0, obs, X):
    return (rig_.to(dev), mt0.to(dev), topt.BAObservations(*(t.to(dev) for t in obs)),
            X.to(dev))


def final_cost(rig_, obs, X, mt, inlier):
    """The robust cost at ``mt`` over ``inlier``, in float64."""
    obs64 = topt.BAObservations(*(t.double() if t.is_floating_point() else t for t in obs))
    rig64 = rig_._replace(M_c=rig_.M_c.double(),
                          cams=type(rig_.cams)(*(f.double() for f in rig_.cams)))
    chi2_of = topt.pose_lm_parts(rig64, obs64, X.double(), topt.HUBER_POSE)[0]
    return float(chi2_of(mt.double(), inlier)[1])


def _flip_band(rig_, obs, X, mt, flipped):
    if not bool(flipped.any()):
        return 0.0
    chi2 = topt.pose_lm_parts(rig_, obs, X, topt.HUBER_POSE)[0](mt, obs.valid)[0]
    d2 = topt.HUBER_POSE ** 2
    return float(((chi2[flipped] - d2).abs() / d2).max())


def kernel_against_plain(rig_, mt0, obs, X, kw, got, want) -> dict:
    """The card's bars (module docstring) for the kernel's outputs ``got``
    against the plain version's ``want`` on the same inputs; in float32
    also round 1 alone (``iters2=0``: its inliers are round 2's gate), the
    final pose held where the two gates agree. Raises AssertionError,
    else returns the measures."""
    mt, inl, n_in, it = got
    p_mt, p_inl, p_n, p_it = want
    err = float((mt.double() - p_mt.double()).abs().max())
    flipped = inl != p_inl
    out = dict(pose_err=err, flipped=int(flipped.sum()), iterations=(int(it), int(p_it)))
    if mt.dtype == torch.float64:
        assert err <= 1e-10, out
        assert torch.equal(inl, p_inl) and int(n_in) == int(p_n) and int(it) == int(p_it), out
        return out
    one = dict(kw, iters2=0)
    r1 = topt.pose_optimization(rig_, mt0, obs, X, **one)
    p_r1 = topt.pose_optimization_reference(rig_, mt0, obs, X, **one)
    gate = r1[1] != p_r1[1]
    out.update(round1_err=float((r1[0].double() - p_r1[0].double()).abs().max()),
               gate_flipped=int(gate.sum()),
               gate_band=_flip_band(rig_, obs, X, p_r1[0], gate))
    assert out["round1_err"] <= 1e-4 and out["gate_band"] <= F32_BAND, out
    if not out["gate_flipped"]:
        out["flip_band"] = _flip_band(rig_, obs, X, p_mt, flipped)
        assert err <= 1e-4 and out["flip_band"] <= F32_BAND, out
    a, b = final_cost(rig_, obs, X, mt, p_inl), final_cost(rig_, obs, X, p_mt, p_inl)
    out["cost_rel"] = abs(a - b) / max(abs(b), 1e-30)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain(dev, dtype, name):
    rig_, mt0, obs, X, kw = _case(name, dtype)
    rig_, mt0, obs, X = _to(dev, rig_, mt0, obs, X)
    before = K.pose_lm.launches
    got = topt.pose_optimization(rig_, mt0, obs, X, **kw)
    torch.cuda.synchronize()
    assert K.pose_lm.launches == before + 1
    want = topt.pose_optimization_reference(rig_, mt0, obs, X, **kw)
    assert [t.dtype for t in got] == [t.dtype for t in want]
    kernel_against_plain(rig_, mt0, obs, X, kw, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (0, 1, THREADS + 1, 7344))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_at_row_counts(dev, dtype, n):
    """Row counts that leave ranks of the cluster empty or partly filled."""
    obs, X, mt0, _ = problem(1, max(n, 1))
    obs = topt.BAObservations(*(t[:n].contiguous() for t in obs))
    obs, X, mt0 = in_dtype(obs, X, mt0, dtype)
    rig_, mt0, obs, X = _to(dev, rig(dtype), mt0, obs, X)
    got = topt.pose_optimization(rig_, mt0, obs, X)
    want = topt.pose_optimization_reference(rig_, mt0, obs, X)
    out = kernel_against_plain(rig_, mt0, obs, X, {}, got, want)
    if n == 0:
        assert out["iterations"] == (20, 20) and int(got[2]) == 0 and torch.equal(got[0], mt0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_captures_and_replays(dev, dtype):
    rig_, mt0, obs, X = _to(dev, *_case("seed1", dtype)[:4])
    eager = topt.pose_optimization(rig_, mt0, obs, X)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        topt.pose_optimization(rig_, mt0, obs, X)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = topt.pose_optimization(rig_, mt0, obs, X)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, eager))


@pytest.mark.cuda
def test_kernel_uses_no_local_memory_in_float32(dev):
    attrs = K.kernel_attributes(torch.float32, dev)
    assert attrs["local_bytes"] == 0, attrs
    assert (attrs["cluster"], attrs["threads"]) == (CLUSTER, THREADS) and CLUSTER > 1, attrs
    assert attrs["max_active_clusters"] >= 1, attrs
