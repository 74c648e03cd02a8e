"""Feature extraction's two hand-written Hopper kernels and their plain
versions.

- ``detect`` (``csrc/fast_detect.cu``, two launches): FAST-9/16 or AGAST
  corners with the per-cell fallback, 3x3 non-maximum suppression, the
  optional Harris ranking at the survivors and each bucket's maximum, for
  every level and camera of the pyramid. Its plain version,
  ``detect_reference``, composes ``fast.fast_with_fallback``,
  ``fast.harris_score`` and ``fast.bucket_maxima`` level by level.
- ``describe`` (``csrc/orb_describe.cu``, one launch, a CTA a keypoint):
  the keypoint's raw window on the extractor's canvas, its IC angle, the
  5x5 blur rounded to integers and the ORB bits, or (no pattern: dBRIEF,
  mdBRIEF) the angle and the blurred patches. Its plain version,
  ``describe_reference``, composes ``brief.extract_patches``,
  ``ic_angle_patches``, ``blur_patches_valid`` and ``orb_from_patches``.

Neither replaces a TPU kernel: the JAX package writes extraction as a
plain jnp chain that XLA fuses (``multicol_slam_tpu/models/extractor.py:
140-212``). A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. The inputs must be contiguous tensors on one device
of the dtypes each function names. The libraries are built with ``nvcc``
(``--fmad=false``: no multiply-add is contracted, so Harris's and the
rotation's products and sums round as PyTorch's separate kernels do) into
``kernels/build/`` at first use and loaded with ctypes; the first use on a
device loads every instance there (``fast_detect_init``,
``orb_describe_init``), so a launch inside a capture makes no other
runtime call. Launches go on the current stream and are counted through
``graphs.on_launch`` (``detect.launches``, two a call; ``describe.launches``).
``kernel_attributes`` reads an instance's registers and local bytes.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from ..ops import brief, fast
from ..utils import graphs
from . import hamming_nn

DETECT_SOURCE = os.path.join(os.path.dirname(hamming_nn.SOURCE), "fast_detect.cu")
DESCRIBE_SOURCE = os.path.join(os.path.dirname(hamming_nn.SOURCE), "orb_describe.cu")
NVCC_EXTRA = ("--fmad=false",)
RING_PIXELS = {"fast_9_16": 16, "agast_7_12": 12, "agast_5_8": 8}
MAX_LEVELS = 16
MAX_EDGE = 64          # the largest bucket and cell edge the detection kernel takes
HARRIS_K = 0.04        # fast.harris_score's defaults: k, and a 7x7 block
HARRIS_SCALE2 = ((1.0 / (4 * 255.0 * 7)) ** 2) ** 2
WINDOW = brief.PATCH_R + 2       # the raw window's radius (53 x 53)
BLUR_SIDE = 2 * WINDOW + 1 - 4   # the valid 5x5 blur (49 x 49)

_libs: dict = {}
_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_ready_devices: set = set()


def _bind_detect(lib: ctypes.CDLL) -> None:
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.fast_detect_launch.argtypes = ([ptr, ptr, ptr] + [i32] * 5 + [f32, f32, i32, i32, f32, f32]
                                       + [ptr, i64, ptr, ptr, ptr])
    lib.fast_detect_launch.restype = i32
    lib.fast_detect_init.argtypes = []
    lib.fast_detect_init.restype = i32
    lib.fast_detect_attributes.argtypes = [i32, i32, ptr]
    lib.fast_detect_attributes.restype = i32


def _bind_describe(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.orb_describe_launch.argtypes = [ptr, ptr] + [i32] * 3 + [ptr] * 3 + [i32] + [ptr] * 4
    lib.orb_describe_launch.restype = i32
    lib.orb_describe_init.argtypes = []
    lib.orb_describe_init.restype = i32
    lib.orb_describe_attributes.argtypes = [ptr]
    lib.orb_describe_attributes.restype = i32


_SOURCES = {"detect": (DETECT_SOURCE, "libfast_detect", _bind_detect),
            "describe": (DESCRIBE_SOURCE, "liborb_describe", _bind_describe)}


def load_library(which: str = "both"):
    """Build (once per source version) and load a kernel library ("detect"
    or "describe"), or both (``which="both"``, as chip_smoke.py's build
    phase asks)."""
    if which == "both":
        return load_library("detect"), load_library("describe")
    lib = _libs.get(which)
    if lib is not None:
        return lib
    with _lib_lock:
        if which not in _libs:
            source, stem, bind = _SOURCES[which]
            lib = ctypes.CDLL(hamming_nn.build(source, stem, NVCC_EXTRA))
            bind(lib)
            _libs[which] = lib
    return _libs[which]


def _init_on(dev):
    """Load both libraries' kernels on dev, once per device."""
    if dev.index in _ready_devices:
        return
    detect_lib, describe_lib = load_library()
    with _lib_lock:
        if dev.index not in _ready_devices:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"the extraction kernels are first used on {dev} inside "
                                   "a CUDA-graph capture: run the function once before "
                                   "capturing it")
            with torch.cuda.device(dev):
                err = detect_lib.fast_detect_init() or describe_lib.orb_describe_init()
            if err != 0:
                raise RuntimeError(f"extraction kernel init failed on {dev}: cudaError {err}")
            _ready_devices.add(dev.index)


def kernel_attributes(kernel: str, ring: str = "fast_9_16", device=None) -> dict:
    """Registers and local (stack) bytes a thread and threads a CTA of an
    instance: ``kernel`` "cell_flags" or "tile_maxima" (of ``ring``) or
    "describe" (a read-only query)."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    _init_on(dev)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(dev):
        if kernel == "describe":
            err = load_library("describe").orb_describe_attributes(out)
        elif kernel in ("cell_flags", "tile_maxima"):
            err = load_library("detect").fast_detect_attributes(
                int(kernel == "tile_maxima"), RING_PIXELS[ring], out)
        else:
            raise ValueError(f"no extraction kernel {kernel!r}")
    if err != 0:
        raise RuntimeError(f"extraction kernel attribute query failed: cudaError {err}")
    return dict(zip(("registers", "local_bytes", "threads"), out[:3]))


def _bump(name: str, n: int):
    """Count n launches of the wrapper ``name`` through graphs.on_launch
    (by name: a caller may stand a wrapper of its own in the module's
    place while the count stays on the wrapper's)."""
    def bump():
        with _count_lock:
            _WRAPPERS[name].launches += n
    graphs.on_launch(bump)


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


# -- detection -------------------------------------------------------------------------

def n_tiles(h: int, w: int, bucket: int) -> int:
    """Buckets of a level: ceil(h / bucket) x ceil(w / bucket)."""
    return -(-h // bucket) * -(-w // bucket)


def check_detect(levels, masks, buckets, cell, border, ring) -> None:
    """Raise unless ``levels`` (L of (C, H_l, W_l) float32) and ``masks``
    (L of (C, H_l, W_l) bool) are contiguous tensors on one device, with
    1 <= L <= MAX_LEVELS, a bucket a level and ``cell`` in 1..MAX_EDGE,
    ``border`` >= 0 and a known ring."""
    if not levels or len(levels) > MAX_LEVELS or len(masks) != len(levels) \
            or len(buckets) != len(levels):
        raise ValueError(f"detect: {len(levels)} levels, {len(masks)} masks, {len(buckets)} "
                         f"buckets; want as many of each, 1..{MAX_LEVELS}")
    if ring not in RING_PIXELS:
        raise ValueError(f"detect: no ring {ring!r}")
    if not 1 <= cell <= MAX_EDGE or border < 0 \
            or any(not 1 <= b <= MAX_EDGE for b in buckets):
        raise ValueError(f"detect: cell {cell}, buckets {list(buckets)} (1..{MAX_EDGE}), "
                         f"border {border}")
    dev, C = levels[0].device, levels[0].shape[0]
    for i, (img, m) in enumerate(zip(levels, masks)):
        for name, t, dtype in (("level", img, torch.float32), ("mask", m, torch.bool)):
            if t.device != dev:
                raise RuntimeError(f"detect: {name} {i} is on {t.device}, level 0 on {dev}")
            if t.dtype != dtype:
                raise TypeError(f"detect: {name} {i} is {t.dtype}, want {dtype}")
            if not t.is_contiguous():
                raise ValueError(f"detect: {name} {i} is not contiguous")
        if img.dim() != 3 or img.shape[0] != C or tuple(m.shape) != tuple(img.shape):
            raise ValueError(f"detect: level {i} {tuple(img.shape)}, mask {tuple(m.shape)}; "
                             f"want (C={C}, H, W) both")


def detect_reference(levels, masks, buckets, *, th_hi: float, th_lo: float, cell: int,
                     border: int, ring: str, harris: bool):
    """The plain version of ``detect``, level by level: (vals (C, L, T)
    float32, args (C, L, T) int32), T the most buckets of a level, the
    columns past a level's buckets -inf and 0."""
    T = max(n_tiles(*img.shape[-2:], b) for img, b in zip(levels, buckets))
    vals, args = [], []
    for img, m, b in zip(levels, masks, buckets):
        score = fast.fast_with_fallback(img, th_hi, th_lo, cell, ring)
        if harris:
            score = torch.where(score > 0, fast.harris_score(img) + 1e-6,
                                torch.zeros_like(score))
        v, a, _ = fast.bucket_maxima(score, m, b, border)
        pad = T - v.shape[-1]
        vals.append(torch.nn.functional.pad(v, (0, pad), value=-float("inf")))
        args.append(torch.nn.functional.pad(a.to(torch.int32), (0, pad)))
    return torch.stack(vals, 1), torch.stack(args, 1)


def detect(levels, masks, buckets, *, th_hi: float, th_lo: float, cell: int, border: int,
           ring: str, harris: bool):
    """(vals (C, L, T) float32, args (C, L, T) int32): level l's bucket
    maxima of the detection score (``detect_reference``) and each one's
    first index inside its bucket, T the most buckets of a level. Two
    launches on the current stream on CUDA tensors; the plain version on
    CPU tensors."""
    check_detect(levels, masks, buckets, cell, border, ring)
    dev = levels[0].device
    kw = dict(th_hi=th_hi, th_lo=th_lo, cell=cell, border=border, ring=ring, harris=harris)
    if dev.type == "cpu":
        return detect_reference(levels, masks, buckets, **kw)
    if dev.type != "cuda":
        raise RuntimeError(f"detect has no kernel for {dev}")
    C, L = levels[0].shape[0], len(levels)
    sizes = [tuple(img.shape[-2:]) for img in levels]
    T = max(n_tiles(h, w, b) for (h, w), b in zip(sizes, buckets))
    n_flags = sum(C * n_tiles(h, w, cell) for h, w in sizes)
    vals = torch.empty((C, L, T), dtype=torch.float32, device=dev)
    args = torch.empty((C, L, T), dtype=torch.int32, device=dev)
    flags = torch.empty(n_flags, dtype=torch.uint8, device=dev)
    _init_on(dev)
    dims = _ints([v for (h, w), b in zip(sizes, buckets) for v in (h, w, b)])
    with torch.cuda.device(dev):
        err = load_library("detect").fast_detect_launch(
            _ptrs(levels), _ptrs(masks), dims, L, C, T, int(cell), int(border),
            float(th_hi), float(th_lo), RING_PIXELS[ring], int(bool(harris)), HARRIS_K,
            HARRIS_SCALE2, flags.data_ptr(), n_flags, vals.data_ptr(), args.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"detection kernel launch failed: cudaError {err}")
    _bump("detect", 2)
    return vals, args


detect.launches = 0


# -- the descriptor ---------------------------------------------------------------------

def check_describe(levels, yx, level, pattern) -> None:
    """Raise unless ``levels`` (L of (C, H_l, W_l) float32, level 0 the
    widest), ``yx`` (C, K, 2) and ``level`` (C, K) int32 and ``pattern``
    ((2 n_pairs, 2) int32, n_pairs a multiple of 32, or None) are
    contiguous tensors on one device, 1 <= L <= MAX_LEVELS."""
    if not levels or len(levels) > MAX_LEVELS:
        raise ValueError(f"describe: {len(levels)} levels, want 1..{MAX_LEVELS}")
    dev, C = levels[0].device, levels[0].shape[0]
    named = [(f"level {i}", t, torch.float32) for i, t in enumerate(levels)]
    named += [("yx", yx, torch.int32), ("level", level, torch.int32)]
    if pattern is not None:
        named.append(("pattern", pattern, torch.int32))
    for name, t, dtype in named:
        if t.device != dev:
            raise RuntimeError(f"describe: {name} is on {t.device}, level 0 on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"describe: {name} is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"describe: {name} is not contiguous")
    if any(t.dim() != 3 or t.shape[0] != C or t.shape[-1] > levels[0].shape[-1]
           for t in levels):
        raise ValueError(f"describe: levels {[tuple(t.shape) for t in levels]}; want (C, H, W) "
                         "each, none wider than level 0")
    if yx.dim() != 3 or yx.shape[0] != C or yx.shape[-1] != 2 \
            or tuple(level.shape) != tuple(yx.shape[:2]):
        raise ValueError(f"describe: yx {tuple(yx.shape)}, level {tuple(level.shape)}; want "
                         f"(C={C}, K, 2) and (C, K)")
    if pattern is not None and (pattern.dim() != 2 or pattern.shape[-1] != 2
                                or pattern.shape[0] % 64):
        raise ValueError(f"describe: pattern {tuple(pattern.shape)}; want (2 n_pairs, 2), "
                         "n_pairs a multiple of 32")


def canvas_of(levels) -> tuple:
    """(canvas (C, sum H_l, W_0): the levels stacked from the top, each
    padded right with zeros; each level's first row)."""
    w0 = levels[0].shape[-1]
    canvas = torch.cat([torch.nn.functional.pad(p, (0, w0 - p.shape[-1])) for p in levels], 1)
    rows = [0]
    for p in levels[:-1]:
        rows.append(rows[-1] + p.shape[-2])
    return canvas, rows


def describe_reference(levels, yx, level, pattern):
    """The plain version of ``describe``: (angle (C, K) float32, the packed
    ORB words (C, K, n_pairs / 32) int32), or with no pattern (angle, the
    blurred patches (C, K, 49, 49) float32)."""
    canvas, rows = canvas_of(levels)
    row0 = torch.zeros_like(level)
    for lvl, r in enumerate(rows[1:], 1):      # no host-to-device copy: capturable
        row0 = torch.where(level == lvl, r, row0)
    yx_canvas = torch.stack([yx[..., 0] + row0, yx[..., 1]], -1)
    raw = brief.extract_patches(canvas, yx_canvas, WINDOW)
    angle = brief.ic_angle_patches(raw)
    blur = torch.round(brief.blur_patches_valid(raw))
    if pattern is None:
        return angle, blur
    return angle, brief.orb_from_patches(blur, angle, pattern)


def describe(levels, yx, level, pattern):
    """(angle (C, K) float32, ORB words (C, K, n_pairs / 32) int32) of the
    keypoints yx (level pixels) at ``level`` of the pyramid ``levels``
    (every level, as the extractor's canvas stacks them), or with no
    pattern (angle, blurred patches (C, K, 49, 49)): ``describe_reference``.
    One launch on the current stream on CUDA tensors; the plain version on
    CPU tensors."""
    check_describe(levels, yx, level, pattern)
    dev = levels[0].device
    if dev.type == "cpu":
        return describe_reference(levels, yx, level, pattern)
    if dev.type != "cuda":
        raise RuntimeError(f"describe has no kernel for {dev}")
    C, K = level.shape
    angle = torch.empty((C, K), dtype=torch.float32, device=dev)
    n_pairs = 0 if pattern is None else pattern.shape[0] // 2
    if pattern is None:
        out = torch.empty((C, K, BLUR_SIDE, BLUR_SIDE), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((C, K, n_pairs // 32), dtype=torch.int32, device=dev)
    if C * K == 0:
        return angle, out
    _init_on(dev)
    dims = _ints([v for t in levels for v in t.shape[-2:]])
    with torch.cuda.device(dev):
        err = load_library("describe").orb_describe_launch(
            _ptrs(levels), dims, len(levels), C, K, yx.data_ptr(), level.data_ptr(),
            None if pattern is None else pattern.data_ptr(), n_pairs, angle.data_ptr(),
            None if pattern is None else out.data_ptr(),
            out.data_ptr() if pattern is None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"descriptor kernel launch failed: cudaError {err}")
    _bump("describe", 1)
    return angle, out


describe.launches = 0
_WRAPPERS = {"detect": detect, "describe": describe}
