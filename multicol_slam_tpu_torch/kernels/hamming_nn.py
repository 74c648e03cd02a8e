"""Gated Hamming nearest neighbour: the hand-written Hopper kernel's two
entries and their plain PyTorch versions.

Both entries replace ``fused_hamming_nn`` and ``fused_hamming_nn_masked``
of ``multicol_slam_tpu/ops/pallas/hamming_nn.py`` and share one CUDA core,
``csrc/hamming_nn.cu``:

- ``hamming_nn_radius`` (entry A) builds the gate inside the kernel from
  per-row fields: a window in pixels, a level window and validity flags.
  The motion-model, local-map, window, initialization and fuse searches
  use it, so no (C, N, M) gate exists on the card.
- ``hamming_nn`` (entry B) takes a dense (C, N, M) gate, for the
  epipolar-gated triangulation searches.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. The kernel is built with ``nvcc`` into ``kernels/build/`` at
first use, as a plain-C shared library loaded with ctypes; the first use
on a device also grants the kernel's shared memory there
(``hamming_nn_init``), so a launch makes no other runtime call and can be
captured into a CUDA graph (``utils/graphs.py``; the graph's warm-up run
does the first use before any capture). The wrappers may be called from
several threads at once (the tracker and the async mapper): the library
is built, loaded and initialized once, under a lock, and the launch
counters are incremented under one. Each launch goes on the calling
thread's current stream and is counted through ``graphs.on_launch``: at
once, or, inside a capture, at every replay of the graph.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from ..ops import hamming as hm
from ..utils import graphs

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "hamming_nn.cu")
BUILD_DIR = os.path.join(_PKG, "kernels", "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
WORDS = (4, 8, 16)   # descriptor words the kernel is built for (16/32/64 B)
GATE_ALIGN = 16      # entry B reads gate rows as 16-byte vectors

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_ready_devices: set = set()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the kernels need the "
                           "CUDA toolkit to build")
    return path


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library; the
    first callers of several threads build and load it once."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            _lib = _build_and_load()
    return _lib


def build(source: str, stem: str, extra: tuple = ()) -> str:
    """The shared library of a kernel source, built with ``nvcc`` (NVCC_FLAGS
    and the source's ``extra`` flags) into ``BUILD_DIR`` once per version
    of the source and flags; its path."""
    flags = [*NVCC_FLAGS, *extra]
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()
                                ).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"{stem}_{digest}.so")
    if not os.path.exists(so):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *flags, "-o", tmp, source],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {os.path.basename(source)}:\n"
                                   + proc.stdout + proc.stderr)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so


def _build_and_load() -> ctypes.CDLL:
    so = build(SOURCE, "libhamming_nn")
    lib = ctypes.CDLL(so)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.hamming_nn_launch.argtypes = [ptr] * 3 + [i64] + [ptr] * 5 + [i32] * 5 + [ptr]
    lib.hamming_nn_launch.restype = i32
    lib.hamming_nn_radius_launch.argtypes = [ptr, i64] + [ptr] * 14 + [i32] * 5 + [ptr]
    lib.hamming_nn_radius_launch.restype = i32
    lib.hamming_nn_init.argtypes = []
    lib.hamming_nn_init.restype = i32
    return lib


def _init_on(dev):
    """Grant the kernel its shared memory on dev, once per device."""
    if dev.index in _ready_devices:
        return
    lib = load_library()
    with _lib_lock:
        if dev.index not in _ready_devices:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the Hamming-NN kernel is first used on "
                                   f"{dev} inside a CUDA-graph capture: run the "
                                   "function once before capturing it")
            with torch.cuda.device(dev):
                err = lib.hamming_nn_init()
            if err != 0:
                raise RuntimeError(f"Hamming-NN kernel init failed on {dev}: "
                                   f"cudaError {err}")
            _ready_devices.add(dev.index)


# -- plain versions ------------------------------------------------------------

def hamming_nn_reference(q, db, gate, q_mask=None, db_mask=None):
    """Plain version of entry B: the +-1 float32 matmul distance (exact),
    then masked_argmin2, with a fully gated row's index mapped to -1. q may
    have one camera (Cq = 1) shared by every camera of db."""
    if q_mask is None:
        dist = hm.hamming_matrix(q, db)
    else:
        dist = hm.hamming_matrix_masked(q, db, q_mask, db_mask)
    idx, best, second = hm.masked_argmin2(dist, gate.to(torch.bool))
    idx = torch.where(best >= hm.INVALID, torch.full_like(idx, -1), idx)
    return idx, best, second


def radius_gate(q_uv, q_r2, q_lvl_lo, q_lvl_hi, q_ok, db_xy, db_lvl, db_ok):
    """The dense (C, N, M) gate that entry A builds inside the kernel, by
    the matchers' torch expressions: squared pixel distance within q_r2,
    database level in [q_lvl_lo, q_lvl_hi], both rows valid."""
    gate = ((db_xy[:, None, :, :] - q_uv[:, :, None, :]) ** 2).sum(-1) <= q_r2[..., None]
    lvl = db_lvl[:, None, :]
    gate &= (lvl >= q_lvl_lo[..., None]) & (lvl <= q_lvl_hi[..., None])
    gate &= db_ok[:, None, :] & q_ok[..., None]
    return gate


def hamming_nn_radius_reference(q, db, q_uv, q_r2, q_lvl_lo, q_lvl_hi, q_ok,
                                db_xy, db_lvl, db_ok, q_mask=None, db_mask=None):
    """Plain version of entry A: the dense gate, then entry B's plain
    version."""
    gate = radius_gate(q_uv, q_r2, q_lvl_lo, q_lvl_hi, q_ok, db_xy, db_lvl, db_ok)
    return hamming_nn_reference(q, db, gate, q_mask, db_mask)


# -- checks --------------------------------------------------------------------

def _expect(name, t, shape, dtypes):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected {' or '.join(map(str, dtypes))}, got {t.dtype}")


def _check_desc(q, db, q_mask, db_mask):
    """q (Cq, N, W) with Cq in (1, C), db (C, M, W), optional masks of the
    same shapes; returns (C, N, M, W)."""
    if (q_mask is None) != (db_mask is None):
        raise ValueError("pass both masks or neither")
    if q.dim() != 3 or db.dim() != 3:
        raise ValueError("expected q (C, N, W) and db (C, M, W)")
    C, M, W = db.shape
    N = q.shape[1]
    if q.shape[0] not in (1, C):
        raise ValueError(f"q has {q.shape[0]} cameras, db {C}")
    _expect("q", q, (q.shape[0], N, W), (torch.int32,))
    _expect("db", db, (C, M, W), (torch.int32,))
    if q_mask is not None:
        _expect("q_mask", q_mask, q.shape, (torch.int32,))
        _expect("db_mask", db_mask, db.shape, (torch.int32,))
    return C, N, M, W


def _same_device(tensors):
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError("all inputs must be on one device")


def _kernel_ready(name, tensors, W):
    """For a CUDA launch: contiguous inputs and a word count the kernel is
    built for."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name} has no kernel for {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}'s kernel needs contiguous inputs")
    if W not in WORDS:
        raise ValueError(f"{name}'s kernel is built for {WORDS} words, got {W}")


def _outputs(dev, C, N):
    return tuple(torch.empty((C, N), dtype=torch.int32, device=dev) for _ in range(3))


def _run(fn, dev, *args):
    """Launch on dev's current stream; raise on any CUDA error."""
    _init_on(dev)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"Hamming-NN kernel launch failed: cudaError {err}")


def _count(entry):
    """One launch of ``entry``: counted now, or, inside a CUDA-graph
    capture, at every replay of the graph (``graphs.on_launch``)."""
    def bump():
        with _count_lock:
            entry.launches += 1
    graphs.on_launch(bump)


def _desc_ptr(t):
    """Device pointer of descriptor words, read as 16-byte vectors."""
    if t is None:
        return None
    if t.data_ptr() % 16:
        raise ValueError("descriptor rows must be 16-byte aligned")
    return t.data_ptr()


# -- entry B -------------------------------------------------------------------

def hamming_nn(q, db, gate, q_mask=None, db_mask=None):
    """Entry B. Per query row: (idx, best, second) int32 (C, N) of the
    gated Hamming distance; idx -1 and distances 0x7FFFFFFF where the row
    is fully gated.

    q (C, N, W) int32, db (C, M, W) int32, gate (C, N, M) bool or uint8,
    optional q_mask / db_mask for the masked (mdBRIEF) distance. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    C, N, M, W = _check_desc(q, db, q_mask, db_mask)
    _expect("q", q, (C, N, W), (torch.int32,))
    _expect("gate", gate, (C, N, M), (torch.bool, torch.uint8))
    masks = [] if q_mask is None else [q_mask, db_mask]
    tensors = [q, db, gate] + masks
    _same_device(tensors)
    if q.device.type == "cpu":
        return hamming_nn_reference(q, db, gate, q_mask, db_mask)
    _kernel_ready("hamming_nn", tensors, W)
    if M % GATE_ALIGN or gate.data_ptr() % GATE_ALIGN:
        padded = torch.zeros((C, N, -(-M // GATE_ALIGN) * GATE_ALIGN),
                             dtype=torch.uint8, device=gate.device)
        padded[..., :M] = gate
        gate = padded
    out = _outputs(q.device, C, N)
    _run(load_library().hamming_nn_launch, q.device,
         _desc_ptr(q), _desc_ptr(db), gate.data_ptr(), gate.stride(1),
         _desc_ptr(q_mask), _desc_ptr(db_mask), *(o.data_ptr() for o in out),
         C, N, M, W, int(bool(masks)))
    _count(hamming_nn)
    return out


hamming_nn.launches = 0


# -- entry A -------------------------------------------------------------------

def hamming_nn_radius(q, db, q_uv, q_r2, q_lvl_lo, q_lvl_hi, q_ok,
                      db_xy, db_lvl, db_ok, q_mask=None, db_mask=None):
    """Entry A: ``hamming_nn`` with the gate built inside the kernel. Query
    row n of camera c may match database row m iff q_ok[c, n], db_ok[c, m],
    q_lvl_lo[c, n] <= db_lvl[c, m] <= q_lvl_hi[c, n] and the squared pixel
    distance of db_xy[c, m] from q_uv[c, n] is at most q_r2[c, n].

    q (Cq, N, W) int32 with Cq = C, or 1 for queries shared by every camera;
    db (C, M, W) int32; q_uv (C, N, 2) and q_r2 (C, N) float32; q_lvl_lo /
    q_lvl_hi (C, N) int32; q_ok (C, N) bool; db_xy (C, M, 2) float32; db_lvl
    (C, M) int32; db_ok (C, M) bool; optional masks shaped as q and db.
    Returns (idx, best, second) int32 (C, N) as ``hamming_nn``."""
    C, N, M, W = _check_desc(q, db, q_mask, db_mask)
    f32, i32, b8 = (torch.float32,), (torch.int32,), (torch.bool,)
    _expect("q_uv", q_uv, (C, N, 2), f32)
    _expect("q_r2", q_r2, (C, N), f32)
    _expect("q_lvl_lo", q_lvl_lo, (C, N), i32)
    _expect("q_lvl_hi", q_lvl_hi, (C, N), i32)
    _expect("q_ok", q_ok, (C, N), b8)
    _expect("db_xy", db_xy, (C, M, 2), f32)
    _expect("db_lvl", db_lvl, (C, M), i32)
    _expect("db_ok", db_ok, (C, M), b8)
    masks = [] if q_mask is None else [q_mask, db_mask]
    fields = [q_uv, q_r2, q_lvl_lo, q_lvl_hi, q_ok, db_xy, db_lvl, db_ok]
    tensors = [q, db] + fields + masks
    _same_device(tensors)
    if q.device.type == "cpu":
        return hamming_nn_radius_reference(q, db, *fields, q_mask, db_mask)
    _kernel_ready("hamming_nn_radius", tensors, W)
    q_cstride = 0 if q.shape[0] == 1 else N * W
    out = _outputs(q.device, C, N)
    _run(load_library().hamming_nn_radius_launch, q.device,
         _desc_ptr(q), q_cstride, _desc_ptr(db), *(t.data_ptr() for t in fields),
         _desc_ptr(q_mask), _desc_ptr(db_mask), *(o.data_ptr() for o in out),
         C, N, M, W, int(bool(masks)))
    _count(hamming_nn_radius)
    return out


hamming_nn_radius.launches = 0
