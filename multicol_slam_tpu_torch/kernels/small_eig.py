"""Small dense eigensolvers for the graphed RANSAC units: the hand-written
Hopper kernel's two entries and their plain PyTorch versions.

``sym_eig`` (a batched symmetric eigen-decomposition, n <= 12) and
``svd3`` (a batched 3x3 SVD) share ``csrc/small_eig.cu``. They replace no
TPU kernel: the JAX package's jitted RANSAC runs XLA's ``eigh`` and
``svd`` inside its compiled unit, while on the card ``torch.linalg.eigh``
and ``svd`` read cuSOLVER's info flag on the host after each call, which a
CUDA-graph capture refuses. The bootstrap's 8-point refit and
decomposition, the DLT refit and Horn's alignment in GP3P call these
(``ops/ransac.py``, ``ops/sim3.py``).

A CPU tensor takes the plain version (``torch.linalg.eigh`` /
``torch.linalg.svd``); a CUDA tensor launches the kernel or raises. The
library is built with ``nvcc`` into ``kernels/build/`` at first use and
loaded with ctypes; the first use on a device also loads every kernel of
it there (``small_eig_init``), so a launch inside a capture makes no other
runtime call. Launches are counted through ``graphs.on_launch`` (``.launches``
on each entry). Eigen and singular vectors are defined up to sign: the
kernel's may differ in sign from the plain version's, column by column.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from ..utils import graphs
from . import hamming_nn

SOURCE = os.path.join(os.path.dirname(hamming_nn.SOURCE), "small_eig.cu")
MAX_N = 12

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
            lib = ctypes.CDLL(hamming_nn.build(SOURCE, "libsmall_eig"))
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.sym_eig_launch.argtypes = [ptr] * 4 + [i64, i32, i32, ptr]
            lib.sym_eig_launch.restype = i32
            lib.svd3_launch.argtypes = [ptr] * 5 + [i64, i32, ptr]
            lib.svd3_launch.restype = i32
            lib.small_eig_init.argtypes = []
            lib.small_eig_init.restype = i32
            _lib = lib
    return _lib


def _init_on(dev):
    """Load the library's kernels on dev, once per device."""
    if dev.index in _ready_devices:
        return
    lib = load_library()
    with _lib_lock:
        if dev.index not in _ready_devices:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the small eigensolvers are first used on "
                                   f"{dev} inside a CUDA-graph capture: run the "
                                   "function once before capturing it")
            with torch.cuda.device(dev):
                err = lib.small_eig_init()
            if err != 0:
                raise RuntimeError(f"small eigensolver init failed on {dev}: cudaError {err}")
            _ready_devices.add(dev.index)


def _count(entry):
    def bump():
        with _count_lock:
            entry.launches += 1
    graphs.on_launch(bump)


def _check(name, A, size: int | None):
    """n of square (..., n, n) float32 / float64 matrices (n == ``size``
    when given, else 1..MAX_N); raises on anything else."""
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"{name}: expected (..., n, n), got {tuple(A.shape)}")
    n = A.shape[-1]
    if size is not None and n != size:
        raise ValueError(f"{name}: expected (..., {size}, {size}), got {tuple(A.shape)}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name}: n = {n} outside 1..{MAX_N}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: expected float32 or float64, got {A.dtype}")
    return n


def _launch(fn, dev, *args):
    _init_on(dev)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"small eigensolver launch failed: cudaError {err}")


# -- plain versions ------------------------------------------------------------

def sym_eig_reference(A: torch.Tensor):
    """Plain version of ``sym_eig``: ``torch.linalg.eigh`` (lower triangle)."""
    return torch.linalg.eigh(A)


def svd3_reference(A: torch.Tensor):
    """Plain version of ``svd3``: ``torch.linalg.svd``."""
    return torch.linalg.svd(A)


# -- entries -------------------------------------------------------------------

def sym_eig(A: torch.Tensor, sweeps: torch.Tensor | None = None):
    """(eigenvalues (..., n) ascending, eigenvectors (..., n, n) as columns)
    of symmetric (..., n, n) float32 / float64 matrices, n <= 12, read
    from the lower triangle. A CPU tensor takes ``torch.linalg.eigh``; a
    CUDA tensor launches the Jacobi kernel. ``sweeps`` (an int32 tensor of
    the batch's size, CUDA only) receives each matrix's Jacobi sweeps."""
    n = _check("sym_eig", A, None)
    if A.device.type == "cpu":
        return sym_eig_reference(A)
    if A.device.type != "cuda":
        raise RuntimeError(f"sym_eig has no kernel for {A.device}")
    batch_shape = A.shape[:-2]
    a = A.reshape(-1, n, n).contiguous()
    B = a.shape[0]
    w = torch.empty((B, n), dtype=A.dtype, device=A.device)
    V = torch.empty((B, n, n), dtype=A.dtype, device=A.device)
    _launch(load_library().sym_eig_launch, A.device, a.data_ptr(), w.data_ptr(),
            V.data_ptr(), None if sweeps is None else sweeps.data_ptr(), B, n,
            int(A.dtype == torch.float64))
    _count(sym_eig)
    return w.reshape(batch_shape + (n,)), V.reshape(batch_shape + (n, n))


sym_eig.launches = 0


def svd3(A: torch.Tensor, sweeps: torch.Tensor | None = None):
    """(U (..., 3, 3), S (..., 3) descending, Vh (..., 3, 3)) of (..., 3, 3)
    float32 / float64 matrices, as ``torch.linalg.svd`` returns them. A
    CPU tensor takes ``torch.linalg.svd``; a CUDA tensor launches the
    one-sided Jacobi kernel."""
    _check("svd3", A, 3)
    if A.device.type == "cpu":
        return svd3_reference(A)
    if A.device.type != "cuda":
        raise RuntimeError(f"svd3 has no kernel for {A.device}")
    batch_shape = A.shape[:-2]
    a = A.reshape(-1, 3, 3).contiguous()
    B = a.shape[0]
    U = torch.empty((B, 3, 3), dtype=A.dtype, device=A.device)
    S = torch.empty((B, 3), dtype=A.dtype, device=A.device)
    Vh = torch.empty((B, 3, 3), dtype=A.dtype, device=A.device)
    _launch(load_library().svd3_launch, A.device, a.data_ptr(), U.data_ptr(), S.data_ptr(),
            Vh.data_ptr(), None if sweeps is None else sweeps.data_ptr(), B,
            int(A.dtype == torch.float64))
    _count(svd3)
    return (U.reshape(batch_shape + (3, 3)), S.reshape(batch_shape + (3,)),
            Vh.reshape(batch_shape + (3, 3)))


svd3.launches = 0
