"""Map checkpoints: save a MapStore to one compressed npz and load it back.

Port of ``multicol_slam_tpu/utils/checkpoint.py``, in the same npz
layout, so a map written by either package loads in the other: the point
and keyframe pools under their MapStore names, ``_next`` (the next point
and keyframe ids), the observation lists as ``obs_table`` rows
(point, keyframe, camera, slot), ``pt_replaced`` and ``loop_edges`` as
pairs, each keyframe's features as ``kf{i}_feat_{field}`` (packed words
as uint32), and ``_meta_json`` (the pool sizes and the caller's
``extra``, as UTF-8 JSON bytes). The reference keeps no map on disk
(it writes only the trajectory); a checkpoint lets a session resume from
a map: load it, set the tracker LOST, and relocalize.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..models.extractor import Features
from ..models.map import MapStore
from .convert import features_from_numpy, features_to_numpy

_POOLS = ("pt_valid", "pt_pos", "pt_desc", "pt_desc_mask", "pt_normal",
          "pt_min_dist", "pt_max_dist", "pt_visible", "pt_found", "pt_first_kf",
          "kf_valid", "kf_pose", "kf_pt", "kf_parent", "kf_frame_id")


def _normalize(path: str) -> str:
    """np.savez_compressed appends '.npz' to a path without it; so do
    save_map and load_map, so they agree on any path."""
    return path if path.endswith(".npz") else path + ".npz"


def _pairs(rows) -> np.ndarray:
    return np.asarray(rows, np.int32).reshape(-1, 2)


def save_map(path: str, m: MapStore, extra: dict | None = None) -> None:
    """Write ``m`` and the JSON-serializable ``extra`` to ``path`` (.npz)."""
    arrays = {name: getattr(m, name) for name in _POOLS}
    arrays["_next"] = np.asarray([m._next_pt, m._next_kf])
    arrays["obs_table"] = np.asarray(
        [(p, kf, cam, slot) for p, lst in m.pt_obs.items() for kf, cam, slot in lst],
        np.int32).reshape(-1, 4)
    arrays["pt_replaced"] = _pairs(list(m.pt_replaced.items()))
    arrays["loop_edges"] = _pairs([(kf, e) for kf, eds in m.kf_loop_edges.items()
                                   for e in eds])
    for kf in np.nonzero(m.kf_valid)[0]:
        f = m.kf_features[kf]
        if f is not None:
            for name, val in features_to_numpy(f).items():
                arrays[f"kf{kf}_feat_{name}"] = val
    meta = dict(capacity_pts=m.capacity_pts, capacity_kfs=m.capacity_kfs,
                n_cams=m.n_cams, k_per_cam=m.k_per_cam, desc_words=m.desc_words,
                extra=extra or {})
    arrays["_meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(_normalize(path), **arrays)


def load_map(path: str, device=None) -> tuple[MapStore, dict]:
    """(MapStore, extra) from a checkpoint of either package; keyframe
    features come back as the port's Features on ``device``: the card by
    default, as every entry point of the port, raising without one;
    ``device="cpu"`` loads them onto the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_map puts keyframe features on the card by default and no "
                           "CUDA device is available: pass device='cpu' to load onto the CPU")
    with np.load(_normalize(path), allow_pickle=False) as z:
        meta = json.loads(bytes(z["_meta_json"]).decode())
        m = MapStore(capacity_pts=meta["capacity_pts"],
                     capacity_kfs=meta["capacity_kfs"], n_cams=meta["n_cams"],
                     k_per_cam=meta["k_per_cam"], desc_words=meta["desc_words"])
        for name in _POOLS:
            getattr(m, name)[...] = z[name]
        m._next_pt, m._next_kf = (int(v) for v in z["_next"])
        for p, kf, cam, slot in z["obs_table"].tolist():
            m.pt_obs[p].append((kf, cam, slot))
        m.rebuild_obs_log()
        for a, b in z["pt_replaced"].tolist():
            m.pt_replaced[a] = b
            m.pt_forward[a] = b
        m.recompute_covisibility()
        for kf, e in z["loop_edges"].tolist():
            m.kf_loop_edges[kf].add(e)
        for kf in np.nonzero(m.kf_valid)[0]:
            if f"kf{kf}_feat_xy" in z:
                m.kf_features[kf] = features_from_numpy(
                    {name: z[f"kf{kf}_feat_{name}"] for name in Features._fields},
                    device)
    return m, meta.get("extra", {})


def map_differences(a: MapStore, b: MapStore) -> list[str]:
    """The parts of two MapStores' saved state that differ; empty when a
    load gave back what was saved. Compared: the sizes, every pool, the
    merge table and its forwarding, the observation lists, covisibility,
    the loop edges, the live observation rows (as a set: a load rebuilds
    the log from the lists, where a live log may hold a row twice after an
    observation was erased and added again) and each keyframe's features."""
    nonempty = lambda d: {i: v for i, v in d.items() if v}
    rows = lambda m: np.unique(m.obs_rows(), axis=0)
    out = [k for k in ("capacity_pts", "capacity_kfs", "n_cams", "k_per_cam", "desc_words",
                       "_next_pt", "_next_kf") if getattr(a, k) != getattr(b, k)]
    out += [k for k in _POOLS + ("pt_forward",)
            if not np.array_equal(getattr(a, k), getattr(b, k))]
    out += ["pt_replaced"] if a.pt_replaced != b.pt_replaced else []
    out += [k for k in ("pt_obs", "_pt_kfs", "_covis", "kf_loop_edges")
            if nonempty(getattr(a, k)) != nonempty(getattr(b, k))]
    if not np.array_equal(rows(a), rows(b)):
        out.append("observation rows")
    for kf in range(max(a._next_kf, b._next_kf)):
        fa, fb = a.kf_features[kf], b.kf_features[kf]
        if (fa is None) != (fb is None) or fa is not None and not all(
                torch.equal(x.cpu(), y.cpu()) for x, y in zip(fa, fb)):
            out.append(f"keyframe {kf}'s features")
    return out
