"""Converters between the JAX package's NamedTuples, taken as numpy
arrays, and this package's tensors.

Packed descriptor words are uint32 in the JAX package and int32 bit
patterns here: uint32 is viewed as int32 on the way in and as uint32 on
the way out, so the bits never change.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.extractor import Features
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
    """Anything with Features' fields as numpy-convertible arrays ->
    Features of tensors."""
    return Features(*(_tensor(getattr(feats, f), device)
                      for f in Features._fields))


def features_to_numpy(feats: Features) -> dict:
    """Features of tensors -> {field: numpy array}, packed words as
    uint32, ready for the JAX package's ``Features(**d)``."""
    out = {}
    for f in Features._fields:
        a = getattr(feats, f).detach().cpu().numpy()
        out[f] = a.view(np.uint32) if f in _PACKED else a
    return out
