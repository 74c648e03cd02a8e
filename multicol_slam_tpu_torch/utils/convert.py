"""Converters between the JAX package's state, taken as numpy arrays, and
this package's tensors: rigs, Features, the whole MapStore and the BoW
vocabulary.

Packed descriptor words are uint32 in the JAX package and int32 bit
patterns in tensors here: uint32 is viewed as int32 on the way in and as
uint32 on the way out, so the bits never change. The host map keeps
uint32 words in both packages.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..models.extractor import Features
from ..models.map import MapStore
from ..models.vocabulary import Vocabulary
from ..ops.camera import CameraModel
from ..ops.rig import Rig

_PACKED = ("desc", "desc_mask")


def _tensor(a, device=None) -> torch.Tensor:
    a = np.array(a)          # a writable copy: JAX arrays come read-only
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def rig_from_numpy(rig, device=None) -> Rig:
    """A rig with ``M_c`` and a ``cams`` carrying CameraModel's fields,
    as numpy-convertible arrays -> Rig of tensors."""
    cams = CameraModel(*(_tensor(getattr(rig.cams, f), device)
                         for f in CameraModel._fields))
    return Rig(M_c=_tensor(rig.M_c, device), cams=cams)


def features_from_numpy(feats, device=None) -> Features:
    """Anything with Features' fields (attributes, or keys of a dict) as
    numpy-convertible arrays -> Features of tensors."""
    get = feats.__getitem__ if isinstance(feats, dict) else \
        (lambda f: getattr(feats, f))
    return Features(*(_tensor(get(f), device) for f in Features._fields))


def features_to_numpy(feats: Features) -> dict:
    """Features of tensors -> {field: numpy array}, packed words as
    uint32, ready for the JAX package's ``Features(**d)``."""
    out = {}
    for f in Features._fields:
        a = getattr(feats, f).detach().cpu().numpy()
        out[f] = a.view(np.uint32) if f in _PACKED else a
    return out


# MapStore state: sizes, numpy pools, scalars and the host graph
_MAP_SIZES = ("capacity_pts", "capacity_kfs", "n_cams", "k_per_cam", "desc_words")
_MAP_ARRAYS = ("pt_valid", "pt_pos", "pt_desc", "pt_desc_mask", "pt_normal",
               "pt_min_dist", "pt_max_dist", "pt_visible", "pt_found",
               "pt_first_kf", "pt_forward", "_obs_log", "kf_valid", "kf_pose",
               "kf_pt", "kf_parent", "kf_frame_id")
_MAP_SCALARS = ("_obs_n", "_next_pt", "_next_kf")


def _copy_graph(get):
    """Deep copies of the map's host graph (observation lists, forwarding,
    covisibility counts, loop edges) in the JAX package's containers."""
    return dict(
        pt_obs=defaultdict(list, {int(p): [tuple(int(v) for v in o) for o in lst]
                                  for p, lst in get("pt_obs").items()}),
        pt_replaced={int(a): int(b) for a, b in get("pt_replaced").items()},
        _covis=defaultdict(dict, {int(k): {int(o): int(w) for o, w in d.items()}
                                  for k, d in get("_covis").items()}),
        _pt_kfs={int(p): {int(k): int(n) for k, n in d.items()}
                 for p, d in get("_pt_kfs").items()},
        kf_loop_edges=defaultdict(set, {int(k): {int(o) for o in s}
                                        for k, s in get("kf_loop_edges").items()}))


def map_to_numpy(m: MapStore) -> dict:
    """The port's MapStore -> {field: value}: numpy pools (uint32
    descriptor words), scalars, the host graph, and ``kf_features`` as a
    list of ``features_to_numpy`` dicts (None for empty keyframe slots),
    ready to load into the JAX package's MapStore."""
    get = lambda k: getattr(m, k)
    out = {k: get(k) for k in _MAP_SIZES + _MAP_SCALARS}
    out.update({k: np.array(get(k)) for k in _MAP_ARRAYS})
    out.update(_copy_graph(get))
    out["kf_features"] = [None if f is None else features_to_numpy(f)
                          for f in m.kf_features]
    return out


def map_from_numpy(src, device=None) -> MapStore:
    """A JAX package MapStore (or a ``map_to_numpy`` dict) -> the port's
    MapStore, with keyframe Features as tensors on ``device``. Everything
    is copied: the two maps share no state."""
    get = src.__getitem__ if isinstance(src, dict) else lambda k: getattr(src, k)
    m = MapStore(**{k: int(get(k)) for k in _MAP_SIZES})
    for k in _MAP_SCALARS:
        setattr(m, k, int(get(k)))
    for k in _MAP_ARRAYS:
        setattr(m, k, np.array(get(k)))
    for k, v in _copy_graph(get).items():
        setattr(m, k, v)
    m.kf_features = [None if f is None else features_from_numpy(f, device)
                     for f in get("kf_features")]
    return m


_VOC_ARRAYS = ("centroids", "children", "word_of_node", "weights")
_VOC_SIZES = ("k", "levels", "n_words_")


def vocabulary_to_numpy(voc: Vocabulary) -> dict:
    """The port's Vocabulary -> {field: value}, centroids as uint32, ready
    for the JAX package's ``Vocabulary(**d)`` once its arrays are made JAX
    arrays."""
    out = {k: getattr(voc, k).detach().cpu().numpy() for k in _VOC_ARRAYS}
    out["centroids"] = out["centroids"].view(np.uint32)
    out.update({k: int(getattr(voc, k)) for k in _VOC_SIZES})
    return out


def vocabulary_from_numpy(src, device=None) -> Vocabulary:
    """A JAX package Vocabulary (or a ``vocabulary_to_numpy`` dict) -> the
    port's Vocabulary on ``device``; the bits of the centroids are kept."""
    get = src.__getitem__ if isinstance(src, dict) else lambda k: getattr(src, k)
    return Vocabulary(**{k: _tensor(get(k), device) for k in _VOC_ARRAYS},
                      **{k: int(get(k)) for k in _VOC_SIZES})
