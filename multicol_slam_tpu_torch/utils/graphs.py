"""CUDA graphs of the port's device steps: the counterpart of ``jax.jit``.

The JAX package compiles its steady-state WORKING frame and the body of
its chunk scan once for each set of static arguments and input shapes
(``multicol_slam_tpu/models/tracking.py:272-276``, ``lax.scan``).
``jit(fn)`` does the same with a CUDA graph: one capture of ``fn`` per
key, replayed on every later call with that key.

- The key: every non-tensor leaf of the arguments (the extractor, the
  ``MatchParams``, thresholds, level counts: the JAX package's static
  arguments) and each tensor leaf's shape, dtype and device. Arguments
  are flattened through tuples (NamedTuples such as ``Features``,
  ``Rig`` and ``BAObservations`` included), lists and dicts.
- The first key of ``fn`` on a device runs ``fn`` once on the pool's
  side stream, the warm-up a capture needs (per-device constants, the
  kernel's library, lazily loaded kernels), returns those outputs, then
  captures ``fn`` on the key's static input buffers. A later key of the
  same wrapper and device skips the warm-up: it captures at once and
  returns the outputs of one replay (a replay equals the eager call).
  Library handles are per thread, and a capture must not create one:
  before a thread's first capture on a pool's side stream, a small
  product and solve there make its cuBLAS and cuSOLVER handles.
  Every later call copies its inputs into those
  buffers, replays the graph on the caller's current stream and returns
  copies of the outputs: the graph's own outputs are overwritten by its
  next replay, and a caller may keep what a call returned (the next
  frame's ``last`` features, a keyframe's features handed to the
  mapper).
- Graphs allocate from the memory pool of their ``Pool`` (one memory
  pool and one side stream per device, the stream ``own_stream``'s):
  graphs of one pool may share
  memory, so they replay one at a time; graphs that replay at the same
  time on two threads' streams (the tracker's steps and the async
  mapper's units) hold two pools. ``jit`` without a pool uses the
  module's shared one. ``Pool.jit(fn)`` is a pool's one wrapper of
  ``fn``, for a unit whose callers are made and dropped (the sharded BA
  of each ``run_global_ba``): its graphs outlive them.
- ``compiled(pool)`` decorates a function as ``jax.jit`` decorates the
  JAX package's: a call with tensors on a card (``graphed``) takes the
  function's graph, any other call the plain function (``.fn``).
- A ``torch.Generator`` argument (the RANSAC units' sampling streams) is
  a leaf of the key, by identity, and is registered with the graph
  (``CUDAGraph.register_generator_state``): the warm-up draws as the eager
  call would, the capture leaves the generator where the warm-up left it,
  and each replay draws what one eager call draws from the generator's
  state at the replay and advances it as that call would. So a run with
  graphs draws what an eager run draws, call for call. A generator on
  another device than the tensors (a CPU generator among CUDA tensors)
  raises.
- Per-device constants of a graphed function (seeds, selection
  matrices made from host numbers) come from ``constant``: made once per
  device and dtype at the first (warm-up) call, since a capture refuses
  the host-to-device copy that makes them.
- A capture that fails raises, naming the function and the key; nothing
  falls back to running ``fn`` eagerly, and there is no switch to turn
  graphs off.
- Launch accounting: a kernel wrapper reports each launch through
  ``on_launch``; inside a capture the report is recorded with the graph
  and repeated at each of its replays, so launch counts stay true.
- ``stats()``: graphs held, captures, capture seconds, replays and the
  pools' bytes, in all and per graphed function (with the generators
  each function's graphs registered). ``thread_seconds()``:
  the calling thread's seconds in warm-ups, waiting for another thread's
  capture, and capturing. Under ``torch.profiler`` a first call's warm-up
  and capture are the span ``graphs.capture`` (``utils/timing.py``).

Captures use ``capture_error_mode="thread_local"``: one thread may
allocate, launch and synchronize on its own stream while another
captures. Captures themselves are serialized across threads (one at a
time in the process; ``torch.cuda.graph`` synchronizes the device and
empties the allocator's cache before it begins, which would break
another thread's capture); a warm-up runs on the side stream of the
function's pool, outside that lock. Python's cyclic garbage collector
is off during a capture: a collection inside it could destroy another
graph, or free a pool's memory, on the capturing thread, a CUDA call the
capture forbids (on the H100 a capture of the tracker's step failed on
such a call of its own thread while an earlier system waited for the
collector).
"""

from __future__ import annotations

import ctypes
import functools
import gc
import threading
import time
import weakref
from typing import Any, Callable, NamedTuple

import torch

from .timing import span

_local = threading.local()
_lock = threading.Lock()
_capture_lock = threading.Lock()
_caches: "weakref.WeakSet[jit]" = weakref.WeakSet()
_all_pools: "weakref.WeakSet[Pool]" = weakref.WeakSet()
_constants: dict = {}


class _Counters:
    def __init__(self):
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.log: list = []   # per capture: function, pool, warm-up, thread, shapes, seconds
        self.by_fn: dict = {}  # function -> captures, capture_s, replays


_counters = _Counters()


# -- launch accounting ---------------------------------------------------------

def on_launch(fn: Callable[[], None]) -> None:
    """Account for one kernel launch the calling thread makes now: call
    ``fn`` at once, or, while this thread captures a graph through
    ``jit``, at each replay of that graph (the launch happens then).
    Inside a capture that other code makes, ``fn`` is not called: that
    graph's replays are not seen here."""
    hooks = getattr(_local, "hooks", None)
    if hooks is not None:
        hooks.append(fn)
    elif not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        fn()


def thread_seconds() -> dict:
    """The calling thread's seconds, since it started, in first calls of
    ``jit``: ``warm_up`` (the eager runs before captures), ``capture_wait``
    (waiting for another thread's capture to end) and ``capture`` (the
    captures), wall-clock; ``warm_up_cpu`` and ``capture_cpu``, the
    thread's CPU time in the first and the last (``time.thread_time``)."""
    return dict(_seconds())


def _seconds() -> dict:
    spent = getattr(_local, "seconds", None)
    if spent is None:
        spent = _local.seconds = dict(warm_up=0.0, warm_up_cpu=0.0, capture_wait=0.0,
                                        capture=0.0, capture_cpu=0.0)
    return spent


def capturing() -> bool:
    """Whether the calling thread is capturing a graph through ``jit``."""
    return getattr(_local, "hooks", None) is not None


def constant(name: str, device: torch.device, dtype, make: Callable[[], torch.Tensor]):
    """The tensor ``make()`` returns, made once per (name, device, dtype) and
    kept: a graphed function's constants from host numbers are made at its
    first (warm-up) call, outside any capture."""
    key = (name, torch.device(device), dtype)
    t = _constants.get(key)
    if t is None:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the constant {name} is first made on {device} inside a "
                               f"CUDA-graph capture: run the function once before "
                               f"capturing it")
        t = _constants.setdefault(key, make())
    return t


# -- flattening ----------------------------------------------------------------

class _Static(NamedTuple):
    """A non-tensor leaf: part of the key, passed to ``fn`` as it is."""

    value: Any


def _flatten(tree, leaves: list):
    """(structure, leaves appended): tuples (NamedTuples kept by type),
    lists and dicts are walked; a tensor leaf becomes a slot number."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return len(leaves) - 1
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    return _Static(tree)


def _unflatten(spec, leaves):
    if isinstance(spec, int):
        return leaves[spec]
    if isinstance(spec, _Static):
        return spec.value
    kind, items = spec
    if kind is dict:
        return {k: _unflatten(v, leaves) for k, v in items}
    vals = [_unflatten(x, leaves) for x in items]
    if hasattr(kind, "_fields"):
        return kind(*vals)
    return kind(vals)


def _generators(spec) -> list:
    """The ``torch.Generator`` leaves of a flattened argument tree."""
    if isinstance(spec, _Static):
        return [spec.value] if isinstance(spec.value, torch.Generator) else []
    if isinstance(spec, int):
        return []
    kind, items = spec
    return [g for item in items for g in _generators(item[1] if kind is dict else item)]


def _same_device(a: torch.device, b: torch.device) -> bool:
    index = lambda d: (d.index if d.index is not None
                       else torch.cuda.current_device() if d.type == "cuda" else None)
    return a.type == b.type and index(a) == index(b)


def _key(spec, leaves):
    try:
        hash(spec)
    except TypeError as e:
        raise TypeError(f"a non-tensor argument is not hashable, so it cannot be part "
                        f"of a graph's key: {e}") from None
    return spec, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)


# -- CUDA ----------------------------------------------------------------------

CU_STREAM_NON_BLOCKING = 1
_free_streams: dict = {}        # device index -> own_stream's streams given back
_streams_lock = threading.RLock()   # a Pool's finalizer may run inside own_stream


def own_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """A non-blocking CUDA stream on ``device`` that no other caller holds.
    ``torch.cuda.Stream()`` hands out PyTorch's pool of 32 streams of a
    priority in turn, so in a process that has made many, two of its
    streams can be one: an async mapper's stream a graph pool's side
    stream, whose capture then sees the mapper's host-to-device copy. A
    stream given back by ``release_stream`` is handed out again; else one
    is made in the device's primary context by libcuda's
    ``cuStreamCreate``. None is destroyed: the caching allocator may record
    events on a stream it has served for as long as the process lives."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    with _streams_lock:
        free = _free_streams.get(idx)
        if free:
            return free.pop()
    torch.cuda.init()
    cu = ctypes.CDLL("libcuda.so.1")
    dev, ctx, stream = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_void_p()
    err = cu.cuDeviceGet(ctypes.byref(dev), idx) \
        or cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev)
    if not err:
        # PyTorch holds the primary context too: this call's hold ends here
        err = cu.cuCtxPushCurrent_v2(ctx)
        if not err:
            err = cu.cuStreamCreate(ctypes.byref(stream), CU_STREAM_NON_BLOCKING)
            popped = ctypes.c_void_p()
            err = cu.cuCtxPopCurrent_v2(ctypes.byref(popped)) or err
        err = cu.cuDevicePrimaryCtxRelease_v2(dev) or err
    if err:
        raise RuntimeError(f"no stream of its own on cuda:{idx}: CUresult {err}")
    return torch.cuda.ExternalStream(stream.value, device=torch.device("cuda", idx))


def release_stream(stream: torch.cuda.ExternalStream) -> None:
    """Give back a stream of ``own_stream``'s whose holder is done with it:
    a later ``own_stream`` on its device returns it. Its queued work is
    not waited for; a later holder's work runs after it."""
    with _streams_lock:
        _free_streams.setdefault(stream.device_index, []).append(stream)


def _release_side_streams(state: dict) -> None:
    for _, side in state.values():
        release_stream(side)


class Pool:
    """A group of graphs' memory: per device one CUDA-graph memory pool and
    one side stream (the warm-ups' and the captures', ``own_stream``'s:
    no other pool's and no async mapper's), made at first use.
    The graphs of one pool may share memory, so they must replay one at a
    time: graphs that can replay at the same time on two streams belong
    to two pools."""

    def __init__(self, name: str):
        self.name = name
        self._state: dict = {}
        self._jits: dict = {}
        _all_pools.add(self)
        # the side streams go back to own_stream's free list with the pool
        weakref.finalize(self, _release_side_streams, self._state).atexit = False

    def state(self, device: torch.device):
        """(pool handle, side stream) on the device, made once."""
        idx = device.index if device.index is not None else torch.cuda.current_device()
        with _lock:
            if idx not in self._state:
                with torch.cuda.device(idx):
                    self._state[idx] = (torch.cuda.graph_pool_handle(),
                                        own_stream(torch.device("cuda", idx)))
            return self._state[idx]

    def handles(self) -> list:
        with _lock:
            return [h for h, _ in self._state.values()]

    def jit(self, fn: Callable) -> "jit":
        """The pool's one ``jit`` of ``fn``, made at first use: its graphs
        outlive the call that asked for them, so a later caller with the
        same keys replays them."""
        with _lock:
            wrapper = self._jits.get(fn)
            if wrapper is None:
                wrapper = self._jits[fn] = jit(fn, self)
            return wrapper


SHARED = Pool("shared")


def graphed(device: torch.device) -> bool:
    """Whether a unit whose tensors lie on ``device`` runs as a CUDA graph
    (on a card) or as its plain function (anywhere else)."""
    return device.type == "cuda"


def compiled(pool: Pool):
    """A decorator, as ``jax.jit`` decorates the JAX package's functions:
    the function's callers with tensors on a card get its CUDA graph in
    ``pool`` (``jit``), callers with tensors elsewhere the plain function.
    Inside another function's capture it runs plain, a part of that graph.
    ``.fn`` is the plain function, ``.graph`` the ``jit``."""
    def wrap(fn: Callable) -> "_Compiled":
        return _Compiled(fn, pool)
    return wrap


class _Compiled:
    def __init__(self, fn: Callable, pool: Pool):
        self.fn = fn
        self.graph = jit(fn, pool)
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        leaves: list = []
        _flatten((args, kwargs), leaves)
        if leaves and graphed(leaves[0].device) and not capturing():
            return self.graph(*args, **kwargs)
        return self.fn(*args, **kwargs)


def _side(device: torch.device, pool: Pool):
    """(pool handle, side stream) of the pool on a CUDA device."""
    if device.type != "cuda":
        raise RuntimeError(f"a CUDA graph needs CUDA tensors, got tensors on {device}")
    return pool.state(device)


def _warm_up(run: Callable[[], list], device: torch.device, pool: Pool) -> list:
    """``run()`` once, eagerly, on the pool's side stream: what a capture
    needs built (constants, handles, the kernel's library) is built here.
    Returns its output leaves, safe to use on the caller's stream."""
    _, side = _side(device, pool)
    cur = torch.cuda.current_stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        outs = run()
    cur.wait_stream(side)
    for t in outs:
        t.record_stream(cur)
    return outs


def _libraries(device: torch.device, side) -> None:
    """The calling thread's cuBLAS and cuSOLVER handles and their
    workspace on ``side``, made once per thread and stream by a 3x3
    product and solve there (a capture that made them would fail)."""
    ready = getattr(_local, "ready", None)
    if ready is None:
        ready = _local.ready = set()
    if side.cuda_stream in ready:
        return
    cur = torch.cuda.current_stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        a = torch.eye(3, device=device)
        torch.linalg.solve_ex(a @ a, torch.bmm(a[None], a[None])[0, 0])
    cur.wait_stream(side)
    ready.add(side.cuda_stream)


def _capture(run: Callable[[], list], device: torch.device, pool: Pool, *,
             generators=()):
    """Capture ``run()`` into a graph of the pool on the device, the
    generators registered with it. Returns (replay, the graph's output
    leaves)."""
    handle, side = _side(device, pool)
    _libraries(device, side)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph, pool=handle, stream=side,
                          capture_error_mode="thread_local"):
        outs = run()
    return graph.replay, outs


# -- the wrapper ---------------------------------------------------------------

class _Entry(NamedTuple):
    replay: Callable[[], None]
    inputs: list          # the static input buffers
    outputs: list         # the graph's output leaves
    out_spec: Any
    hooks: list           # launch reports to repeat at each replay


class jit:
    """``jit(fn, pool)(*args, **kwargs)``: ``fn`` captured once per key into
    a CUDA graph of ``pool`` (``SHARED`` by default) and replayed (see the
    module's docstring). ``fn`` must return tensors in tuples, lists or
    dicts, must not read a device tensor on the host, and must not change
    its inputs. ``captures`` and ``replays`` count this wrapper's."""

    def __init__(self, fn: Callable, pool: Pool | None = None):
        self.fn = fn
        self.name = getattr(fn, "__qualname__", repr(fn))
        self.pool = pool or SHARED
        self.captures = 0
        self.replays = 0
        self._graphs: dict = {}
        self._warmed: set = set()     # devices this wrapper has run a warm-up on
        self.generators: list = []    # the generators its graphs registered
        _caches.add(self)

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, *args, **kwargs):
        leaves: list = []
        spec = _flatten((args, kwargs), leaves)
        key = _key(spec, leaves)
        entry = self._graphs.get(key)
        if entry is None:
            with span("graphs.capture", fn=self.name):
                return self._first_call(key, spec, leaves)
        for buf, x in zip(entry.inputs, leaves):
            buf.copy_(x)
        self.replays += 1
        with _lock:
            _counters.replays += 1
            _fn_counters(self.name)["replays"] += 1
        return _replay(entry)

    def _first_call(self, key, spec, leaves):
        """Warm-up (a first key on the device) and capture; returns the
        warm-up's outputs, or with no warm-up those of one replay."""
        device = leaves[0].device if leaves else torch.device("cpu")
        gens = _generators(spec)
        for gen in gens:
            if not _same_device(gen.device, device):
                raise ValueError(f"{self.name} draws from a generator on {gen.device} with "
                                 f"tensors on {device}: a graph registers generators of "
                                 f"its own device only")
        warm = device not in self._warmed
        out_spec = []

        def run_on(xs):
            def run():
                a, kw = _unflatten(spec, xs)
                outs: list = []
                out_spec[:] = [_flatten(self.fn(*a, **kw), outs)]
                _check_outputs(self.name, out_spec[0])
                return outs
            return run

        spent = _seconds()
        t0, c0 = time.perf_counter(), time.thread_time()
        result = _warm_up(run_on(leaves), device, self.pool) if warm else None
        inputs = [x.clone(memory_format=torch.contiguous_format) for x in leaves]
        hooks: list = []
        t1 = time.perf_counter()
        spent["warm_up"] += t1 - t0
        spent["warm_up_cpu"] += time.thread_time() - c0
        with _capture_lock:
            t0, c0 = time.perf_counter(), time.thread_time()
            spent["capture_wait"] += t0 - t1
            _local.hooks = hooks
            collecting = gc.isenabled()
            gc.disable()
            try:
                # generators passed only when there are some (a capture
                # stand-in without them serves every other function)
                replay, outputs = _capture(run_on(inputs), device, self.pool,
                                           **({"generators": gens} if gens else {}))
            except Exception as e:
                shapes = [tuple(t.shape) for t in leaves]
                raise RuntimeError(f"CUDA-graph capture of {self.name} failed (tensor "
                                   f"inputs {shapes}): {type(e).__name__}: {e}") from e
            finally:
                _local.hooks = None
                if collecting:
                    gc.enable()
            seconds = time.perf_counter() - t0
            spent["capture"] += seconds
            spent["capture_cpu"] += time.thread_time() - c0
        self.captures += 1
        with _lock:
            _counters.captures += 1
            _counters.capture_s += seconds
            c = _fn_counters(self.name)
            c["captures"] += 1
            c["capture_s"] += seconds
            _counters.log.append(dict(fn=self.name, pool=self.pool.name, seconds=seconds,
                                      warm_up=warm, thread=threading.current_thread().name,
                                      shapes=[tuple(t.shape) for t in leaves]))
        entry = _Entry(replay, inputs, outputs, out_spec[0], hooks)
        self._graphs[key] = entry
        self.generators += [g for g in gens if all(g is not h for h in self.generators)]
        if not warm:
            return _replay(entry)
        self._warmed.add(device)
        return _unflatten(entry.out_spec, result)

    def clear(self):
        """Drop this function's graphs (their pool memory returns to the
        shared pool)."""
        self._graphs.clear()


def _replay(entry: _Entry):
    """Replay a graph on the caller's stream, repeat its launch reports,
    and return copies of its outputs."""
    entry.replay()
    for hook in entry.hooks:
        hook()
    return _unflatten(entry.out_spec, [t.clone() for t in entry.outputs])


def _check_outputs(name, spec):
    """Raise if a graphed function's output holds a non-tensor leaf: a
    replay could not reproduce it."""
    if isinstance(spec, _Static):
        raise TypeError(f"{name} returned {spec.value!r}: a graphed function returns "
                        f"tensors only")
    if isinstance(spec, int):
        return
    kind, items = spec
    for item in items:
        _check_outputs(name, item[1] if kind is dict else item)


# -- counters ------------------------------------------------------------------

def _fn_counters(name: str) -> dict:
    """A graphed function's counters (callers hold ``_lock``)."""
    return _counters.by_fn.setdefault(name, dict(captures=0, capture_s=0.0, replays=0))


def pool_bytes() -> dict:
    """Bytes each live pool holds on the card (segments of the caching
    allocator owned by the pool), by pool name."""
    pools = [p for p in list(_all_pools) if p.handles()]
    if not pools:
        return {}
    owner = {_pool_id(h): p.name for p in pools for h in p.handles()}
    out = dict.fromkeys(sorted({p.name for p in pools}), 0)
    for seg in torch.cuda.memory_snapshot():
        name = owner.get(_pool_id(seg.get("segment_pool_id")))
        if name is not None:
            out[name] += seg["total_size"]
    return out


def _pool_id(handle):
    try:
        return tuple(handle)
    except TypeError:
        return handle


def stats() -> dict:
    """Graphs held (by live ``jit`` wrappers), captures, capture seconds,
    replays, the pools' bytes on the card (``pool_bytes`` in all,
    ``pools`` by name), per graphed function (``by_fn``: captures,
    capture seconds, replays, graphs held, its pool's name and the
    generators its live wrappers' graphs registered) and the
    log of captures (each one's function, pool, whether a warm-up ran
    before it, the capturing thread, tensor input shapes and seconds)."""
    with _lock:
        caches = list(_caches)
        by_fn = {k: dict(v, graphs_held=0, pool=None, generators=[])
                 for k, v in _counters.by_fn.items()}
        for c in caches:
            if c.name in by_fn:
                by_fn[c.name]["graphs_held"] += len(c)
                by_fn[c.name]["pool"] = c.pool.name
                by_fn[c.name]["generators"] += [f"{g.device} seed {g.initial_seed()}"
                                                for g in c.generators]
        out = dict(graphs_held=sum(len(c) for c in caches), captures=_counters.captures,
                   capture_s=_counters.capture_s, replays=_counters.replays,
                   by_fn=by_fn, log=list(_counters.log))
    pools = pool_bytes()
    out["pools"] = pools
    out["pool_bytes"] = sum(pools.values())
    return out
