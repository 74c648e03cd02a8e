"""Gated Hamming nearest neighbour: the hand-written Hopper kernel and its
plain PyTorch version.

``hamming_nn`` replaces ``fused_hamming_nn`` and
``fused_hamming_nn_masked`` of ``multicol_slam_tpu/ops/pallas/hamming_nn.py``
and is the inner loop of both main-path matchers. A CPU tensor takes
``hamming_nn_reference``; a CUDA tensor launches ``csrc/hamming_nn.cu``
or raises. The kernel is built with ``nvcc`` into ``kernels/build/`` at
first use, as a plain-C shared library loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from ..ops import hamming as hm

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "hamming_nn.cu")
BUILD_DIR = os.path.join(_PKG, "kernels", "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
WORDS = (4, 8, 16)   # descriptor words the kernel is built for (16/32/64 B)

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the Hamming-NN kernel needs the "
                           "CUDA toolkit to build")
    return path


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libhamming_nn_{digest}.so")
    if not os.path.exists(so):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed to build hamming_nn.cu:\n"
                                   + proc.stdout + proc.stderr)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(so)
    lib.hamming_nn_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.hamming_nn_launch.restype = ctypes.c_int
    _lib = lib
    return lib


def hamming_nn_reference(q, db, gate, q_mask=None, db_mask=None):
    """Plain version: the +-1 float32 matmul distance (exact), then
    masked_argmin2, with a fully gated row's index mapped to -1."""
    if q_mask is None:
        dist = hm.hamming_matrix(q, db)
    else:
        dist = hm.hamming_matrix_masked(q, db, q_mask, db_mask)
    idx, best, second = hm.masked_argmin2(dist, gate.to(torch.bool))
    idx = torch.where(best >= hm.INVALID, torch.full_like(idx, -1), idx)
    return idx, best, second


def _check(q, db, gate, q_mask, db_mask):
    if (q_mask is None) != (db_mask is None):
        raise ValueError("pass both masks or neither")
    if q.dim() != 3 or db.dim() != 3 or gate.dim() != 3:
        raise ValueError("expected q (C, N, W), db (C, M, W), gate (C, N, M)")
    C, N, W = q.shape
    M = db.shape[1]
    if db.shape != (C, M, W) or gate.shape != (C, N, M):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, db "
                         f"{tuple(db.shape)}, gate {tuple(gate.shape)}")
    if q.dtype != torch.int32 or db.dtype != torch.int32:
        raise TypeError("packed descriptors must be int32")
    if gate.dtype not in (torch.bool, torch.uint8):
        raise TypeError("gate must be bool or uint8")
    tensors = [q, db, gate]
    if q_mask is not None:
        if q_mask.shape != q.shape or db_mask.shape != db.shape:
            raise ValueError("masks must match the descriptors' shapes")
        if q_mask.dtype != torch.int32 or db_mask.dtype != torch.int32:
            raise TypeError("packed masks must be int32")
        tensors += [q_mask, db_mask]
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    return tensors


def hamming_nn(q, db, gate, q_mask=None, db_mask=None):
    """Per query row: (idx, best, second) int32 (C, N) of the gated Hamming
    distance; idx -1 and distances 0x7FFFFFFF where the row is fully gated.

    q (C, N, W) int32, db (C, M, W) int32, gate (C, N, M) bool or uint8,
    optional q_mask / db_mask for the masked (mdBRIEF) distance. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    tensors = _check(q, db, gate, q_mask, db_mask)
    if q.device.type == "cpu":
        return hamming_nn_reference(q, db, gate, q_mask, db_mask)
    if q.device.type != "cuda":
        raise RuntimeError(f"hamming_nn has no kernel for {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("hamming_nn's kernel needs contiguous inputs")
    C, N, W = q.shape
    M = db.shape[1]
    if W not in WORDS:
        raise ValueError(f"hamming_nn's kernel is built for {WORDS} words, got {W}")
    lib = load_library()
    out = [torch.empty((C, N), dtype=torch.int32, device=q.device)
           for _ in range(3)]
    masked = q_mask is not None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.hamming_nn_launch(
        q.data_ptr(), db.data_ptr(), gate.data_ptr(),
        q_mask.data_ptr() if masked else None,
        db_mask.data_ptr() if masked else None,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        C, N, M, W, int(masked), stream)
    if err != 0:
        raise RuntimeError(f"hamming_nn kernel launch failed: cudaError {err}")
    hamming_nn.launches += 1
    return tuple(out)


hamming_nn.launches = 0
