"""The pose-only Levenberg-Marquardt as one hand-written Hopper kernel.

``pose_lm`` runs a whole ``optimizer.pose_optimization`` call in one
launch of ``csrc/pose_lm.cu``: both LM rounds, the outlier gate between
them and the final inlier count, each round stopping on the device once
an accepted step's gain is under GAIN_EPS, as the JAX package's
``lax.while_loop`` does (``multicol_slam_tpu/models/optimizer.py:82-165``,
a compiled unit and not a Pallas kernel). Its plain version is
``optimizer.pose_optimization_reference``; ``optimizer.pose_optimization``
takes it for a CPU tensor and this kernel for a CUDA tensor.

A launch needs no preparatory PyTorch operation: the kernel gathers the
points and the cameras' fields by the observation table's indices and
computes ``cayley2hom(rig.M_c_min)`` itself, so a call is the four output
allocations and one launch, with no cast or copy. The inputs must be
contiguous CUDA tensors of one float dtype (float32 or float64; ``cam``
and ``pt`` int32, ``valid`` bool) on one device; anything else raises.
``huber``, ``iters1`` and ``iters2`` are launch arguments, so the launch
captures inside the tracker's CUDA graphs.

The library is built with ``nvcc`` (``--fmad=false``: no multiply-add is
contracted, so a row's elementwise chain rounds as PyTorch's separate
kernels do) into ``kernels/build/`` at first use and loaded with ctypes;
the first use on a device loads both instances there (``pose_lm_init``),
so a launch inside a capture makes no other runtime call. Launches are
counted through ``graphs.on_launch`` (``pose_lm.launches``).
``kernel_attributes`` reads an instance's registers, local and shared
bytes back (``cudaFuncGetAttributes``).
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from ..utils import graphs
from . import hamming_nn

SOURCE = os.path.join(os.path.dirname(hamming_nn.SOURCE), "pose_lm.cu")
NVCC_EXTRA = ("--fmad=false",)
MAX_CAMS = 32
MAX_POLY = 16

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_ready_devices: set = set()


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(hamming_nn.build(SOURCE, "libpose_lm", NVCC_EXTRA))
            bind(lib)
            _lib = lib
    return _lib


def bind(lib: ctypes.CDLL) -> None:
    """Declare the library's C interface on ``lib``."""
    ptr, i64, i32, f64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    lib.pose_lm_launch.argtypes = ([ptr] * 7 + [i32, i32] + [ptr] * 6 + [i64, ptr, i64, f64,
                                   i32, i32, f64, f64] + [ptr] * 4 + [i32, ptr])
    lib.pose_lm_launch.restype = i32
    lib.pose_lm_init.argtypes = []
    lib.pose_lm_init.restype = i32
    lib.pose_lm_attributes.argtypes = [i32, ptr]
    lib.pose_lm_attributes.restype = i32


def _init_on(dev):
    """Load the library's kernels on dev, once per device."""
    if dev.index in _ready_devices:
        return
    lib = load_library()
    with _lib_lock:
        if dev.index not in _ready_devices:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"the pose LM kernel is first used on {dev} inside a "
                                   "CUDA-graph capture: run the function once before "
                                   "capturing it")
            with torch.cuda.device(dev):
                err = lib.pose_lm_init()
            if err != 0:
                raise RuntimeError(f"pose LM kernel init failed on {dev}: cudaError {err}")
            _ready_devices.add(dev.index)


def kernel_attributes(dtype: torch.dtype, device=None) -> dict:
    """Registers and local (stack) bytes a thread of the kernel instance
    for ``dtype``, on the card (a read-only query)."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"no pose LM kernel for {dtype}")
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    _init_on(dev)
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        err = load_library().pose_lm_attributes(int(dtype == torch.float64), out)
    if err != 0:
        raise RuntimeError(f"pose LM attribute query failed: cudaError {err}")
    return dict(registers=out[0], local_bytes=out[1])


def check(rig, mt_min0, obs, X_world):
    """Raise unless the inputs are what the kernel reads: contiguous
    tensors on one device, floats of one dtype (float32 or float64), an
    int32 camera and point index and a bool validity per row, (C, 4, 4)
    extrinsics and (C,) / (C, npoly) camera fields for 1 <= C <= MAX_CAMS
    and 2 <= npoly <= MAX_POLY, a (6,) pose, (K, 2) measurements and
    (P, 3) points."""
    cams = rig.cams
    floats = {"rig.M_c": rig.M_c, "cams.c": cams.c, "cams.d": cams.d, "cams.e": cams.e,
              "cams.u0": cams.u0, "cams.v0": cams.v0, "cams.inv_poly": cams.inv_poly,
              "mt_min0": mt_min0, "obs.uv": obs.uv, "obs.inv_sigma2": obs.inv_sigma2,
              "X_world": X_world}
    named = dict(floats, **{"obs.cam": obs.cam, "obs.pt": obs.pt, "obs.valid": obs.valid})
    dev = mt_min0.device
    for name, t in named.items():
        if t.device != dev:
            raise RuntimeError(f"pose_lm: {name} is on {t.device}, mt_min0 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"pose_lm: {name} is not contiguous")
    dtype = mt_min0.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pose_lm: no kernel for {dtype}")
    for name, t in floats.items():
        if t.dtype != dtype:
            raise TypeError(f"pose_lm: {name} is {t.dtype}, mt_min0 {dtype}")
    for name, t, want in (("obs.cam", obs.cam, torch.int32), ("obs.pt", obs.pt, torch.int32),
                          ("obs.valid", obs.valid, torch.bool)):
        if t.dtype != want:
            raise TypeError(f"pose_lm: {name} is {t.dtype}, want {want}")
    C = rig.M_c.shape[0]
    K = obs.uv.shape[0]
    npoly = cams.inv_poly.shape[-1]
    shapes = {"rig.M_c": (rig.M_c.shape, (C, 4, 4)), "mt_min0": (mt_min0.shape, (6,)),
              "cams.inv_poly": (cams.inv_poly.shape, (C, npoly)),
              "obs.uv": (obs.uv.shape, (K, 2)), "X_world": (X_world.shape,
                                                            (X_world.shape[0], 3))}
    shapes.update({f"cams.{f}": (getattr(cams, f).shape, (C,)) for f in ("c", "d", "e", "u0", "v0")})
    shapes.update({f"obs.{f}": (getattr(obs, f).shape, (K,))
                   for f in ("cam", "pt", "inv_sigma2", "valid")})
    for name, (got, want) in shapes.items():
        if tuple(got) != tuple(want):
            raise ValueError(f"pose_lm: {name} has shape {tuple(got)}, want {tuple(want)}")
    if not 1 <= C <= MAX_CAMS or not 2 <= npoly <= MAX_POLY:
        raise ValueError(f"pose_lm: {C} cameras (1..{MAX_CAMS}) and {npoly} inverse "
                         f"polynomial coefficients (2..{MAX_POLY})")


def arguments(rig, mt_min0, obs, X_world, outputs, *, huber: float, iters1: int,
              iters2: int, tau: float, gain_eps: float) -> tuple:
    """``pose_lm_launch``'s arguments but the stream, for checked inputs
    and ``outputs`` = (mt (6,), inlier (K,) bool, n_inliers () int64,
    iterations () int32) allocated like them."""
    cams = rig.cams
    ptr = lambda t: t.data_ptr()
    mt, inlier, n_in, it = outputs
    return (ptr(rig.M_c), ptr(cams.c), ptr(cams.d), ptr(cams.e), ptr(cams.u0), ptr(cams.v0),
            ptr(cams.inv_poly), rig.M_c.shape[0], cams.inv_poly.shape[-1], ptr(mt_min0),
            ptr(obs.uv), ptr(obs.cam), ptr(obs.pt), ptr(obs.inv_sigma2), ptr(obs.valid),
            obs.uv.shape[0], ptr(X_world), X_world.shape[0], float(huber), int(iters1),
            int(iters2), float(tau), float(gain_eps), ptr(mt), ptr(inlier), ptr(n_in),
            ptr(it), int(mt_min0.dtype == torch.float64))


def outputs_like(mt_min0, K: int) -> tuple:
    """Uninitialized (mt, inlier, n_inliers, iterations) for K rows."""
    dev = mt_min0.device
    return (torch.empty(6, dtype=mt_min0.dtype, device=dev),
            torch.empty(K, dtype=torch.bool, device=dev),
            torch.empty((), dtype=torch.int64, device=dev),
            torch.empty((), dtype=torch.int32, device=dev))


def pose_lm(rig, mt_min0, obs, X_world, *, huber: float, iters1: int, iters2: int,
            tau: float, gain_eps: float):
    """(mt (6,), inlier mask (K,), n_inliers (), iterations ()) of
    ``optimizer.pose_optimization`` on CUDA tensors, in one launch on the
    current stream."""
    if mt_min0.device.type != "cuda":
        raise RuntimeError(f"pose_lm has no kernel for {mt_min0.device}")
    check(rig, mt_min0, obs, X_world)
    out = outputs_like(mt_min0, obs.uv.shape[0])
    dev = mt_min0.device
    _init_on(dev)
    args = arguments(rig, mt_min0, obs, X_world, out, huber=huber, iters1=iters1,
                     iters2=iters2, tau=tau, gain_eps=gain_eps)
    with torch.cuda.device(dev):
        err = load_library().pose_lm_launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pose LM kernel launch failed: cudaError {err}")

    def bump():
        with _count_lock:
            pose_lm.launches += 1
    graphs.on_launch(bump)
    return out


pose_lm.launches = 0
