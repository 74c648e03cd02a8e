"""Map bootstrap from two multi-frames (cMultiInitializer.cpp).

Port of ``multicol_slam_tpu/models/initializer.py``. Per camera: mutual
level-0 window matching, 5-point essential RANSAC over the matched
bearing rays (threshold 1e-4, 256 hypotheses), the cheirality vote over
the four decompositions, the parallax measure ||b1 x R b2|| with median
> 0.06, and the CheckRT gates (z > 0 in both views, squared reprojection
error <= 5 px^2 in both views, parallax > 1 degree,
cMultiInitializer.cpp:200-307). A camera leads if it reconstructs more
than 60 good points (:180-196); the world frame is the leading camera's
frame at the reference time (cTracking::CreateInitialMap :443-449).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import ransac
from ..ops.camera import world_to_img
from ..ops.geometry import hom2cayley
from ..ops.rig import Rig
from ..utils import graphs
from . import matcher
from .extractor import Features

MIN_MATCHES = 100        # cTracking.cpp:405-416
MIN_GOOD = 60            # cMultiInitializer.cpp:184
MIN_MEDIAN_NORM = 0.06   # cMultiInitializer.cpp:185
REPROJ_TH2 = 5.0         # CheckRT th2
MIN_PARALLAX_DEG = 1.0


class InitCandidate(NamedTuple):
    """Per-camera results (the leading camera is chosen on the host)."""

    R12: torch.Tensor         # (C, 3, 3) cam(cur) -> cam(ref) rotation
    t12: torch.Tensor         # (C, 3)
    X: torch.Tensor           # (C, K, 3) triangulated points (ref-cam frame)
    good: torch.Tensor        # (C, K) CheckRT-passing matches (ref slots)
    n_good: torch.Tensor      # (C,)
    median_norm: torch.Tensor  # (C,)
    match_idx: torch.Tensor   # (C, K) ref slot -> cur slot (-1 none)


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of a 1-D tensor as ``jnp.nanmedian``
    takes it: the two middle values weighted 0.5 / 0.5 when their count is
    even (``torch.nanmedian`` returns the lower one); NaN when empty."""
    n = (~torch.isnan(x)).sum()
    s = torch.sort(torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)).values
    q = 0.5 * (n.to(x.dtype) - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    last = x.shape[0] - 1
    lo_v = s.index_select(0, torch.clamp(lo, 0, last).long().reshape(1))[0]
    hi_v = s.index_select(0, torch.clamp(hi, 0, last).long().reshape(1))[0]
    med = lo_v * (1.0 - w_hi) + hi_v * w_hi
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def initialize_device(gen: torch.Generator, rig: Rig, f_ref: Features,
                      f_cur: Features, params: matcher.MatchParams,
                      n_hyps: int = 256) -> InitCandidate:
    """Matching, RANSAC and CheckRT for every camera. RANSAC draws from
    ``gen`` camera by camera, in camera order. On the card the tracker
    replays this as a CUDA graph, drawing from ``gen`` as registered with
    it (``utils/graphs.py``)."""
    match_idx = matcher.search_for_initialization(f_ref, f_cur, params)
    C = match_idx.shape[0]
    dt, dev = f_ref.ray.dtype, f_ref.ray.device
    cos_th = graphs.constant("init_cos_parallax", dev, dt, lambda: torch.cos(
        torch.deg2rad(torch.tensor(MIN_PARALLAX_DEG, dtype=dt, device=dev))))
    outs = []
    for c in range(C):
        m = match_idx[c]
        matched = m >= 0
        idx2 = torch.clamp(m, min=0).long()
        v1, v2 = f_ref.ray[c], f_cur.ray[c][idx2]
        E, inl, _ = ransac.ransac_essential(gen, v1, v2, matched, threshold=1e-4,
                                            n_hyps=n_hyps)
        Rs, ts = ransac.decompose_essential(E)
        counts, Xs = ransac.cheirality_counts(Rs, ts, v1, v2, inl)
        b = torch.argmax(counts).reshape(1)
        R12, t12, X = (a.index_select(0, b)[0] for a in (Rs, ts, Xs))

        cr = torch.linalg.cross(v1, v2 @ R12.T)
        norms = torch.linalg.norm(cr, dim=-1)
        med = nanmedian(torch.where(inl, norms, torch.full_like(norms, float("nan"))))

        cam = rig.cams.index(c)
        z1 = (X * v1).sum(-1)
        X2 = (X - t12) @ R12
        z2 = (X2 * v2).sum(-1)
        err1 = ((world_to_img(cam, X) - f_ref.xy[c]) ** 2).sum(-1)
        err2 = ((world_to_img(cam, X2) - f_cur.xy[c][idx2]) ** 2).sum(-1)
        # parallax between the viewing rays from the two camera centres
        n2 = X - t12
        cosp = (X * n2).sum(-1) / torch.clamp(
            torch.linalg.norm(X, dim=-1) * torch.linalg.norm(n2, dim=-1), min=1e-12)
        good = (inl & (z1 > 0) & (z2 > 0)
                & (err1 <= REPROJ_TH2) & (err2 <= REPROJ_TH2)
                & (cosp < cos_th) & torch.isfinite(X).all(-1))
        outs.append((R12, t12, X, good, good.sum(), med))
    R12, t12, X, good, n_good, med = (torch.stack(f) for f in zip(*outs))
    return InitCandidate(R12=R12, t12=t12, X=X, good=good, n_good=n_good,
                         median_norm=med, match_idx=match_idx)


class InitResult(NamedTuple):
    lead_cam: int
    mt_ref: np.ndarray     # (6,) body pose cayley at the reference frame
    mt_cur: np.ndarray     # (6,)
    X_world: np.ndarray    # (G, 3) good points in the world frame
    ref_slots: np.ndarray  # (G,) reference-frame slots (lead camera)
    cur_slots: np.ndarray  # (G,)
    n_matches: int


def pick_leading_camera(cand, rig: Rig) -> Optional[InitResult]:
    """Leading-camera selection and world anchoring on the host
    (cMultiInitializer.cpp:180-196, cTracking.cpp:443-449). ``cand`` holds
    InitCandidate's fields as numpy arrays. The anchoring poses pass
    through float32 as in the JAX package's production dtype."""
    n_good = np.asarray(cand.n_good)
    med = np.asarray(cand.median_norm)
    ok = (n_good > MIN_GOOD) & (med > MIN_MEDIAN_NORM)
    if not ok.any():
        return None
    # among qualifying cameras, the most reconstructed points
    lead = int(max(np.nonzero(ok)[0], key=lambda c: n_good[c]))
    R12 = np.asarray(cand.R12[lead])
    t12 = np.asarray(cand.t12[lead])
    X_cam = np.asarray(cand.X[lead])
    good = np.asarray(cand.good[lead])
    m = np.asarray(cand.match_idx[lead])

    Mc = rig.M_c[lead].detach().cpu().numpy().astype(np.float64)
    Mc_inv = np.linalg.inv(Mc)
    # world = lead camera frame at the reference time
    T_rel = np.eye(4)
    T_rel[:3, :3] = R12
    T_rel[:3, 3] = t12
    M_t_cur = T_rel @ Mc_inv

    ref_slots = np.nonzero(good)[0]
    cur_slots = m[ref_slots]
    h2c = lambda M: hom2cayley(torch.as_tensor(M, dtype=torch.float32)).numpy()
    return InitResult(lead_cam=lead, mt_ref=h2c(Mc_inv), mt_cur=h2c(M_t_cur),
                      X_world=X_cam[ref_slots],
                      ref_slots=ref_slots.astype(np.int32),
                      cur_slots=cur_slots.astype(np.int32),
                      n_matches=int((m >= 0).sum()))
