#!/usr/bin/env python3
"""The small eigensolvers on the card, parent against change: builds the
kernel source twice (``csrc/small_eig.cu`` as it is, and the parent's,
written out of git beforehand), prints each instance's
registers, stack frame and spills (``nvcc -Xptxas -v``), and times every
build on the same recorded inputs of every call site, in turns, beside
the launch floor (an empty kernel in a CUDA graph) and torch.linalg. It
also breaks the device time of the bootstrap (``initialize_device``) and
of a relocalization (``Tracker._relocalize``) down by stage.

One process a system run (``--order``, default parent, change, change,
parent): the process loads that build into ``kernels.small_eig`` and runs
``MultiColSLAM`` at its defaults over 40 frames of ``bench_trajectory``
under ``chip_smoke.EigSpy`` (each site's first input and its launches),
then one ComputeSim3 between the first two keyframes (the loop closer's
Sim3 RANSAC, 256 x 4x4), then

- the stages: the eager ``initialize_device`` on the bootstrap's recorded
  inputs (its generator state restored; 5 calls) and three forced
  relocalizations with the tracker's units eager (the stages inside
  ``_relocalize`` only), under ``torch.profiler`` with a
  ``record_function`` range a stage (``stage_device_us``). The graphed
  ``initialize_device`` on the same inputs (5 calls): ms between two
  events, and the host ms of the call up to the second event;
- the sites: each build's device us a launch (``chip_smoke.device_ms``:
  20 launches in one CUDA graph, replayed) in the order parent, change,
  change, parent, and each build's output against torch.linalg at
  ``chip_smoke``'s bars.

    python3 tools/eig_study.py --write-parent HEAD~1     # in a git checkout: the parent's source
    python3 tools/eig_study.py                           # on one H100

Prints each process's tables beside the card's name and power limit; the
last line is one JSON object, a list of runs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, ROOT)
REL_SOURCE = "multicol_slam_tpu_torch/csrc/small_eig.cu"
STUDY_DIR = os.path.join(ROOT, "multicol_slam_tpu_torch", "kernels", "build", "study")
PARENT = os.path.join(STUDY_DIR, "small_eig_parent.cu")
EMPTY = os.path.join(ROOT, "tools", "empty_kernel.cu")
FRAMES = 40
RELOCS = 3
INIT_REPS = 5
STAGE = "stage:"


def card() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()


def write_parent(rev: str) -> None:
    """The kernel source at git revision rev, written to PARENT."""
    src = subprocess.run(["git", "-C", ROOT, "show", f"{rev}:{REL_SOURCE}"],
                         capture_output=True, text=True, check=True).stdout
    os.makedirs(STUDY_DIR, exist_ok=True)
    with open(PARENT, "w") as f:
        f.write(src)
    print(f"wrote {os.path.relpath(PARENT, ROOT)} from {rev}:{REL_SOURCE}")


# -- builds ---------------------------------------------------------------------

def build(source: str, label: str):
    """(the .so path, ptxas' report) of source built with the port's flags
    and -Xptxas -v into STUDY_DIR."""
    from multicol_slam_tpu_torch.kernels import hamming_nn

    os.makedirs(STUDY_DIR, exist_ok=True)
    so = os.path.join(STUDY_DIR, f"lib{label}.so")
    proc = subprocess.run([hamming_nn._nvcc(), *hamming_nn.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", so, source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"eig_study: nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    return so, proc.stdout + proc.stderr


def demangle(name: str) -> str:
    """kernel<type, N> of an anonymous-namespace template kernel's mangled
    name (_ZN, the namespace's and then the kernel's length-prefixed
    names, I type [Li N E] E); the name as it is otherwise."""
    m = re.match(r"_ZN(\d+)", name)
    if not m:
        return name
    rest = name[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return name
    ident = rest[m.end():m.end() + int(m.group(1))]
    rest = rest[m.end() + len(ident):]
    args = re.match(r"I([fd])(?:Li(\d+)E)?", rest)
    if not args:
        return ident
    t = {"f": "float", "d": "double"}[args.group(1)]
    return f"{ident}<{t}{', ' + args.group(2) if args.group(2) else ''}>"


def ptxas_table(text: str) -> dict:
    """{kernel: dict(registers, stack, spill_stores, spill_loads)} from
    ptxas' -v report."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = demangle(m.group(1))
            out[cur] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            out[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    return out


def open_lib(so: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.sym_eig_launch.argtypes = [ptr] * 4 + [i64, i32, i32, ptr]
    lib.sym_eig_launch.restype = i32
    lib.svd3_launch.argtypes = [ptr] * 5 + [i64, i32, ptr]
    lib.svd3_launch.restype = i32
    lib.small_eig_init.argtypes = []
    lib.small_eig_init.restype = i32
    return lib


def launcher(lib, entry, A):
    """A function that launches lib's entry on A into outputs made once,
    on the current stream (its error code), and those outputs."""
    import torch

    n = A.shape[-1]
    a = A.reshape(-1, n, n).contiguous()
    B, f64 = a.shape[0], int(A.dtype == torch.float64)
    new = lambda *s: torch.empty(s, dtype=A.dtype, device=A.device)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    if entry == "sym_eig":
        w, V = new(B, n), new(B, n, n)
        return (lambda: lib.sym_eig_launch(a.data_ptr(), w.data_ptr(), V.data_ptr(), None,
                                           B, n, f64, stream())), (w, V)
    U, S, Vh = new(B, 3, 3), new(B, 3), new(B, 3, 3)
    return (lambda: lib.svd3_launch(a.data_ptr(), U.data_ptr(), S.data_ptr(), Vh.data_ptr(),
                                    None, B, f64, stream())), (U, S, Vh)


def mean_sweeps(lib, entry, A, outs) -> float:
    """The Jacobi sweeps a matrix that lib's entry takes on A (its sweeps
    output), into the outputs ``outs``."""
    import torch

    n = A.shape[-1]
    a = A.reshape(-1, n, n).contiguous()
    sw = torch.zeros(a.shape[0], dtype=torch.int32, device=A.device)
    ptrs = [a.data_ptr()] + [o.data_ptr() for o in outs] + [sw.data_ptr(), a.shape[0]]
    f64, stream = int(A.dtype == torch.float64), torch.cuda.current_stream().cuda_stream
    if entry == "sym_eig":
        lib.sym_eig_launch(*ptrs, n, f64, stream)
    else:
        lib.svd3_launch(*ptrs, f64, stream)
    torch.cuda.synchronize()
    return round(float(sw.double().mean()), 3)


# -- stages -----------------------------------------------------------------------

class Ranges:
    """While entered, each target (owner, attribute, label) runs inside a
    ``record_function`` range named STAGE + label."""

    def __init__(self, *targets):
        self.targets = targets

    def __enter__(self):
        import torch

        self.saved = []
        for owner, attr, label in self.targets:
            f = getattr(owner, attr)

            def ranged(*a, _f=f, _label=label, **k):
                with torch.profiler.record_function(STAGE + _label):
                    return _f(*a, **k)
            self.saved.append((owner, attr, f, attr in vars(owner)))
            setattr(owner, attr, ranged)
        return self

    def __exit__(self, *exc):
        for owner, attr, f, own in reversed(self.saved):
            if own:
                setattr(owner, attr, f)
            else:
                delattr(owner, attr)


def stage_device_us(prof, within: str | None = None) -> tuple:
    """({stage: device us}, all device us, {stage: us from the stage's
    first kernel's start to its last kernel's end}) of a profile. A
    device activity (kernel, copy, fill) is traced to the host operation
    that launched it (its linked correlation id) and counts in every STAGE
    range open on that thread at that host moment. A kernel with no such
    link (the ctypes kernels: their launch is no PyTorch operation) counts
    in every stage whose range holds it on the device's timeline, where
    the profiler draws each range from its first kernel's start to its
    last kernel's end. With ``within``, only activity inside that stage
    counts in the others."""
    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    host = {e.correlation_id(): (e.start_ns(), e.start_thread_id()) for e in evs
            if e.device_type() == DeviceType.CPU}
    ranges = [(e.name()[len(STAGE):], e.start_ns(), e.end_ns(), e.start_thread_id())
              for e in evs if e.device_type() == DeviceType.CPU and e.name().startswith(STAGE)]
    dev_ranges = [(e.name()[len(STAGE):], e.start_ns(), e.end_ns()) for e in evs
                  if e.device_type() == DeviceType.CUDA and e.name().startswith(STAGE)]
    by_stage, span, total = Counter(), Counter(), 0.0
    for lb, start, end in dev_ranges:
        span[lb] += (end - start) / 1e3
    for e in evs:
        if e.device_type() != DeviceType.CUDA or e.name().startswith(STAGE):
            continue
        us = e.duration_ns() / 1e3
        total += us
        at = host.get(e.linked_correlation_id())
        hit = set() if at is None else {lb for lb, start, end, th in ranges
                                        if th == at[1] and start <= at[0] <= end}
        if not hit:
            hit = {lb for lb, start, end in dev_ranges
                   if start <= e.start_ns() and e.end_ns() <= end}
        if within is not None and within not in hit:
            continue
        for lb in hit or {"(no stage)"}:
            by_stage[lb] += us
    return dict(by_stage), total, dict(span)


def profiled_stages(fn, targets, reps, within=None):
    """Per call of fn (reps calls, each profiled alone), medians: the
    device us by stage (inside stage ``within`` where given), all device
    us, each stage's span on the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                Ranges(*targets):
            fn()
            torch.cuda.synchronize()
        runs.append(stage_device_us(prof, within))
    med = lambda i: {lb: round(statistics.median(r[i].get(lb, 0.0) for r in runs), 3)
                     for lb in sorted({k for r in runs for k in r[i]})}
    return med(0), round(statistics.median(r[1] for r in runs), 3), med(2)


# -- one process: the system on one build ---------------------------------------

def one(label: str, libs: dict) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from multicol_slam_tpu_torch.kernels import small_eig
    from multicol_slam_tpu_torch.models import initializer, matcher, tracking
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.ops import ransac, sim3
    from multicol_slam_tpu_torch.utils import config_io, graphs, synthetic

    if not torch.cuda.is_available():
        raise SystemExit("eig_study: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    loaded = {k: open_lib(so) for k, so in libs.items() if k != "_empty"}
    small_eig._lib = loaded[label]            # the system runs on this build

    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR)
    tr = slam.tracker
    rec = {}
    init_unit = tr._init_device

    def record_init(gen, *a, **k):
        if "init" not in rec:
            rec["init"] = (gen, gen.get_state(), cs.clone_tree(a), dict(k))
        return init_unit(gen, *a, **k)
    tr._init_device = record_init
    gt = synthetic.bench_trajectory(FRAMES + RELOCS)
    render = synthetic.make_renderer(slam.rig)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev)))
    frames = frames.to(torch.uint8)
    small_eig.sym_eig.launches = small_eig.svd3.launches = 0
    with cs.EigSpy() as spy:
        init_at = None
        for i in range(FRAMES):
            if slam.track(frames[i], i / 25.0) is not None and init_at is None:
                init_at = i
        # the loop closer's Sim3 RANSAC, once, between the first two keyframes
        lc, kfs = slam.loop_closer, slam.map.keyframe_ids().tolist()
        pairs = [p for p in lc._matched_point_pairs(kfs[0], kfs[1]) if p[0] != p[1]]
        lc._compute_sim3(kfs[0], kfs[1], pairs)
        torch.cuda.synchronize()
    tr._init_device = init_unit
    print(f"[{label}] init at frame {init_at}, {slam.map.n_keyframes()} keyframes, "
          f"eig launches by site {dict(spy.launches)}", file=sys.stderr)

    # stages of the bootstrap: the eager initialize_device on its inputs
    tr_gen, state, a, k = rec["init"]
    gen = torch.Generator(device=dev)

    def eager_init():
        gen.set_state(state)
        return initializer.initialize_device(gen, *a, **k)
    eager_init()
    init_targets = [(matcher, "search_for_initialization", "matching"),
                    (ransac, "sample_minimal_sets", "sampling"),
                    (ransac, "essential_5pt", "newton_5pt"),
                    (ransac, "_epipolar_err", "scoring"),
                    (ransac, "essential_8pt", "refit_8pt"),
                    (ransac, "sym_eig", "sym_eig"), (ransac, "svd3", "svd3"),
                    (ransac, "decompose_essential", "decompose"),
                    (ransac, "cheirality_counts", "cheirality_triangulation"),
                    (initializer, "initialize_device", "total")]
    init_stages = profiled_stages(eager_init, init_targets, INIT_REPS)
    print(f"[{label}] initialize_device stages {init_stages}", file=sys.stderr)
    graph_ms, host_ms, after = [], [], tr_gen.get_state()
    for _ in range(INIT_REPS):               # the tracker's generator: the graph's key
        tr_gen.set_state(state)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        t0.record()
        init_unit(tr_gen, *a, **k)
        t1.record()
        host_ms.append((time.perf_counter() - h0) * 1e3)
        t1.synchronize()
        graph_ms.append(t0.elapsed_time(t1))
    tr_gen.set_state(after)

    # stages of a relocalization: forced on the last frames, units eager
    held = {u: getattr(tr, u) for u in tracking.UNIT_NAMES}
    for u, g in held.items():
        if isinstance(g, graphs.jit):
            setattr(tr, u, g.fn)
    reloc_targets = [(tr, "reloc_candidates_fn", "bow"), (tr, "_reloc_matches", "search_by_bow"),
                     (tr, "_gpnp", "gp3p"), (ransac, "gp3p", "gp3p_newton"),
                     (sim3, "horn_alignment", "horn"), (ransac, "_refit", "dlt_refit"),
                     (tr, "_optimize_current_pose", "pose_lm"),
                     (tr, "_reloc_project_candidate", "projection"),
                     (tr, "_track_local_map", "local_map"), (tr, "_relocalize", "total")]
    reloc_runs, ok = [], []

    def forced(i):
        tr.force_reloc = True
        ok.append(slam.track(frames[i], i / 25.0) is not None)
    for i in range(FRAMES, FRAMES + RELOCS):
        reloc_runs.append(profiled_stages(lambda: forced(i), reloc_targets, 1, "total"))
    for u, g in held.items():
        setattr(tr, u, g)
    reloc_stages = tuple(
        {lb: round(statistics.median(r[i].get(lb, 0.0) for r in reloc_runs), 3)
         for lb in sorted({k for r in reloc_runs for k in r[i]})} for i in (0, 2))
    reloc_stages = (reloc_stages[0], round(statistics.median(r[1] for r in reloc_runs), 3),
                    reloc_stages[1])
    print(f"[{label}] _relocalize stages {reloc_stages}, relocalized {ok}", file=sys.stderr)

    # every build at every site, in turns; the floor
    empty = ctypes.CDLL(libs["_empty"])
    empty.empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    empty.empty_launch.restype = ctypes.c_int
    floor_us = {t: cs.device_ms(lambda t=t: empty.empty_launch(
        t, torch.cuda.current_stream().cuda_stream)) * 1e3 for t in (32, 64)}
    turns = ["parent", "change", "change", "parent"]
    sites = {}
    for site, A in sorted(spy.args.items()):
        entry = site.split("@")[0]
        want = getattr(small_eig, entry + "_reference")(A)
        row = dict(shape=list(A.shape), dtype=str(A.dtype).replace("torch.", ""),
                   launches=spy.launches[site],
                   linalg_us=cs.cuda_ms(lambda: getattr(small_eig, entry + "_reference")(A)) * 1e3,
                   us={}, err={}, sweeps={})
        for b in turns:
            fn, outs = launcher(loaded[b], entry, A)
            if fn() != 0:
                raise SystemExit(f"eig_study: build {b} failed to launch at {site}")
            torch.cuda.synchronize()
            if b not in row["sweeps"]:
                row["sweeps"][b] = mean_sweeps(loaded[b], entry, A, outs)
                fn()
                torch.cuda.synchronize()
            if b not in row["err"]:
                val, vec, _ = cs.eig_errors(entry, A, outs, want)
                row["err"][b] = [val, vec]
                if val > cs.EIG_VAL_TOL[A.dtype] or vec > cs.EIG_VEC_TOL:
                    print(f"[{label}] {site}: build {b} off torch.linalg: values {val:.3g}, "
                          f"vectors {vec:.3g}", file=sys.stderr)
            row["us"].setdefault(b, []).append(round(cs.device_ms(fn) * 1e3, 3))
        sites[site] = row
    return dict(label=label, device=torch.cuda.get_device_name(0), init_frame=init_at,
                keyframes=int(slam.map.n_keyframes()), relocalized=ok,
                floor_us={str(t): round(v, 3) for t, v in floor_us.items()},
                init_stages_us=init_stages[0], init_total_us=init_stages[1],
                init_span_us=init_stages[2],
                init_graph_ms=[round(x, 3) for x in graph_ms],
                init_graph_host_ms=[round(x, 3) for x in host_ms],
                reloc_stages_us=reloc_stages[0], reloc_total_us=reloc_stages[1],
                reloc_span_us=reloc_stages[2], sites=sites,
                ok=bool(np.all(ok)) and init_at is not None)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write-parent", metavar="REV",
                    help="write the kernel source at git revision REV as the parent, and stop")
    ap.add_argument("--order", nargs="+", default=["parent", "change", "change", "parent"],
                    help="the build each system run loads, one process a run, in this order")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--libs", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.write_parent:
        write_parent(args.write_parent)
        return
    if args.one:
        print(json.dumps(one(args.one, json.loads(args.libs))))
        return
    if not os.path.exists(PARENT):
        raise SystemExit(f"eig_study: no parent source at {PARENT}: run "
                         "`python3 tools/eig_study.py --write-parent HEAD~1` in a git checkout")
    name = card()
    sources = {"parent": PARENT, "change": os.path.join(ROOT, REL_SOURCE), "_empty": EMPTY}
    built, t0 = {}, time.perf_counter()

    def make(label, src):
        built[label] = build(src, label)
    threads = [threading.Thread(target=make, args=kv) for kv in sources.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if set(built) != set(sources):
        raise SystemExit("eig_study: a build failed")
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.3f} s, one nvcc a source "
          f"({name})")
    for label in sources:
        for kern, props in ptxas_table(built[label][1]).items():
            if re.search(r"(, [49]>|svd3)", kern):
                print(f"ptxas {label}: {kern}: {props}")
    libs = json.dumps({k: v[0] for k, v in built.items()})
    runs = []
    for label in args.order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", label,
                               "--libs", libs], capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-6000:])
        if proc.returncode != 0:
            print(proc.stdout[-4000:], file=sys.stderr)
            raise SystemExit(f"eig_study: the run on the {label} build failed")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        r["ptxas"] = {k: ptxas_table(v[1]) for k, v in built.items() if k != "_empty"}
        runs.append(r)
        print(f"[{label}] floor us (an empty kernel, 32 and 64 threads) {r['floor_us']}; "
              f"init frame {r['init_frame']}, relocalized {r['relocalized']} ({name})")
        print(f"[{label}] initialize_device eager, device us by stage (median of "
              f"{INIT_REPS}): {r['init_stages_us']}, all device us {r['init_total_us']}; "
              f"span on the device {r['init_span_us']}; graphed ms a call (events) "
              f"{r['init_graph_ms']}, host ms a call {r['init_graph_host_ms']} ({name})")
        print(f"[{label}] _relocalize, units eager, device us by stage (median of {RELOCS}): "
              f"{r['reloc_stages_us']}, all device us {r['reloc_total_us']}; span on "
              f"the device {r['reloc_span_us']} ({name})")
        for site, row in r["sites"].items():
            med = {b: statistics.median(v) for b, v in row["us"].items()}
            print(f"[{label}] {site} {row['shape']} {row['dtype']}, {row['launches']} launches: "
                  f"device us a launch {med} (each turn {row['us']}), Jacobi sweeps a matrix "
                  f"{row['sweeps']}, torch.linalg {row['linalg_us']:.2f} us, errors "
                  f"{row['err']} ({name})")
    print(name)
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
