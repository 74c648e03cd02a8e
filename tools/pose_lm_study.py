#!/usr/bin/env python3
"""The pose LM kernel on the card, parent against change, and the
measures of it that ``chip_smoke.py`` does not take.

    python3 tools/pose_lm_study.py --write-parent HEAD~1   # in a git checkout: the parent's source
    python3 tools/pose_lm_study.py --sites --split         # on one H100
    python3 tools/pose_lm_study.py --split --marks --shapes 512 256x16
    python3 tools/pose_lm_study.py --async-mapper --shapes 256x8
    python3 tools/pose_lm_study.py --reloc                 # on the card
    python3 tools/pose_lm_study.py --scan                  # on the card, in either tree
    python3 tools/pose_lm_study.py --orders                # on the CPU, no card

``--write-parent REV`` writes ``csrc/pose_lm.cu`` at git revision REV
under ``kernels/build/study/`` (ignored by git).
``--sites``, ``--split``, ``--marks`` and ``--async-mapper`` build that parent, the current source and
the empty kernels (``tools/empty_kernel.cu``) with the port's flags and
``-Xptxas -v`` (registers, stack, spills), one ``nvcc`` a source, all at
once; ``--shapes`` adds builds of the current source at other CTA widths
and cluster sizes (``-DPOSE_LM_THREADS=N -DPOSE_LM_CLUSTER=M``). Every build keeps the C interface of
``pose_lm_launch``, so all load under the one binding
(``kernels/pose_lm.py::bind``) and run on the same inputs in one process.
Each device time is ``chip_smoke.device_ms`` (20 launches in one CUDA
graph, replayed) and the builds are timed in turns: parent, change,
change, parent (the other shapes after the change).

``--sites`` runs ``MultiColSLAM`` at its defaults over 40 frames of
``bench_trajectory`` and forces relocalizations on frames 40-42 (the
tracker's units eager there) under ``chip_smoke.PoseSpy`` (each call
site's first inputs and its launches),
then times every build on each site's recorded input beside the launch
floor (an empty kernel of one block, and an empty cluster of the
kernel's shape) and the plain version, and prints each build's
iterations, inliers and pose against the plain version's.

``--split`` times calls at fixed iterations (``gain_eps`` 0, so no round
stops early; 3, 13 and 23 passes) over K = 0, 1,200, 2,400, 5,472 and
7,344 rows of ``tests/_poseutil.py``'s problem: the slope over the
passes is an iteration's device us (its solve and its pass) at each K,
and a line through those at K > 0 splits it into a fixed part and a part
a row, for every build. (At K = 0, H = 0 and every solve divides by
zero.)

``--marks`` builds a copy of the current source with clock reads added
at fixed places (``write_marks``, under ``kernels/build/study/``) and
prints a pass's SM cycles by stage at 23 passes over each row count of
``--split``.

``--async-mapper`` runs ``MultiColSLAM(async_mapping=True)`` over 60
frames of ``bench_trajectory`` once a build, in turns, each in a
process of its own, every capture of the system launching that build's
kernel, frames 12-59 under ``torch.profiler``: each pose LM launch's
device us and the wait before it on its stream (the gap from the kernel
before it, in a graph replay the time to be placed on the card), apart
for launches that start while the mapper's stream runs. Then, as those
are few, each build between CUDA events on 2,400 and 5,472 rows alone
and while the local BA replays on another stream.

``--scan`` runs the bench's headline (``bench.production_tracker``, the
package of the tree it runs in: copy this file into a parent checkout to
run it there) and, after the bench's own timed call, four more and one
under ``torch.profiler``: a frame's device us by kernel class (the pose
LM kernel, the Hamming kernels, the rest), the busiest kernels, the
device's busy share and the pose LM launches' device us in the graph.

``--reloc`` runs the same system and forces relocalizations with the
tracker's units eager, for each pose LM variant in the order build,
plain, plain, build (``build``: ``optimizer.pose_optimization`` as the
tree has it; ``plain``: ``pose_optimization_reference``):
``_relocalize``'s device us by stage (the pose LM, GP3P, SearchByBoW, the
BoW candidates, the projection round and the local-map re-match) and in
all, medians over a variant's six relocalizations.

``--orders`` runs on the CPU: the plain version's iterations in float64
and float32 on ``tests/_poseutil.py``'s problems (seeds 0-7), with the
rows in their order and reversed, which sums the same terms in another
order. (``chip_smoke.py`` phase 18 measures the same on the card, on
every recorded call.)

Each mode on the card prints the card's name and power limit; the last
line is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, ROOT)
REL_SOURCE = "multicol_slam_tpu_torch/csrc/pose_lm.cu"
STUDY_DIR = os.path.join(ROOT, "multicol_slam_tpu_torch", "kernels", "build", "study")
PARENT = os.path.join(STUDY_DIR, "pose_lm_parent.cu")
EMPTY = os.path.join(ROOT, "tools", "empty_kernel.cu")
FRAMES = 40
RELOCS = 3
SPLIT_ROWS = (0, 1200, 2400, 5472, 7344)
SPLIT_ITERS = (0, 5, 10)          # iters1 = iters2: 3, 13 and 23 passes
ASYNC_FRAMES, ASYNC_WARM = 60, 12
BESIDE_REPS = 20
SCAN_REPEATS = 4


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

# The marks copy of the kernel: rank 0's thread 0 adds the SM cycles of
# each stage of every pass (the rows; the warps' sums and the barrier after
# them; the CTA's sums sent to every rank and the cluster barrier; the
# ranks' sums added; the LM step, accept and solve; the next pose's
# constants; the barrier before the rows) and the passes, read back by
# pose_lm_marks_read. Each (anchor, text) puts text after the one place
# where anchor stands in csrc/pose_lm.cu.
MARK = """  if (threadIdx.x == 0 && cg::this_cluster().block_rank() == 0) {
    const long long now = clock64();
    s.marks[%d] += now - s.mark_t;
    s.mark_t = now;
  }
"""
MARKS_PATCH = (
    ("namespace cg = cooperative_groups;\n\nnamespace {\n",
     "constexpr int NMARK = 7;\n__device__ long long pose_lm_marks[NMARK + 1];\n"),
    ("  int go;\n", "  long long marks[NMARK], mark_t;\n"),
    ("      acc[22 + i] += w0 * r0 + w1 * r1;\n    }\n  }\n", MARK % 0),
    ("  if (lane == 0) s.cnt[warp] = cnt;\n  __syncthreads();\n", MARK % 1),
    ("    }\n  }\n  cluster.sync();\n", MARK % 2),
    ("    count = __shfl_sync(0xffffffffu, c, NSUM);\n  }\n", MARK % 3),
    ("          for (int i = 0; i < 6; ++i) mt[i] = mt_acc[i] - d[i];\n", MARK % 4),
    ("        if (tid == 0) s.go = go;\n      }\n", MARK % 5),
    ("        if (tid == 0) s.go = go;\n      }\n%s      __syncthreads();\n" % (MARK % 5),
     MARK % 6),
    ("  if (lead) set_pose(s, mt, warp, lane, a.C);\n",
     "  if (tid == 0)\n    for (int i = 0; i < NMARK; ++i) s.marks[i] = 0;\n"),
    ("  cluster.sync();\n  for (int round = 0;", None),
    ("    *a.it_out = it_total;\n",
     "    for (int i = 0; i < NMARK; ++i) pose_lm_marks[i] = s.marks[i];\n"
     "    pose_lm_marks[NMARK] = pass;\n"),
    ("}  // extern \"C\"\n",
     "\nextern \"C\" int pose_lm_marks_read(long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, pose_lm_marks, sizeof(pose_lm_marks));\n}\n"),
)


def write_marks(src: str) -> str:
    """The marks copy of the kernel source src (MARKS_PATCH), written under
    STUDY_DIR; returns its path."""
    text = open(src).read()
    for anchor, add in MARKS_PATCH:
        if text.count(anchor) != 1:
            raise SystemExit(f"pose_lm_study: the marks anchor {anchor!r} stands "
                             f"{text.count(anchor)} times in {src}, want once")
        if add is None:   # the clock starts after the cluster barrier before the passes
            add = "  cluster.sync();\n  if (tid == 0) s.mark_t = clock64();\n  for (int round = 0;"
            text = text.replace(anchor, add)
        else:
            text = text.replace(anchor, anchor + add)
    out = os.path.join(STUDY_DIR, "pose_lm_marks.cu")
    with open(out, "w") as f:
        f.write(text)
    return out

def build_all(shapes, marks=False) -> dict:
    """{label: (.so, ptxas' report)} for the parent, the change, the change
    at each shape in ``shapes``, with ``marks`` the change's marks copy
    (``write_marks``), and the empty kernels, one nvcc a build, all at
    once."""
    from multicol_slam_tpu_torch.kernels import hamming_nn, pose_lm

    if not os.path.exists(PARENT):
        raise SystemExit(f"pose_lm_study: no parent source at {PARENT}: run "
                         "`python3 tools/pose_lm_study.py --write-parent HEAD~1` in a git "
                         "checkout")
    change = os.path.join(ROOT, REL_SOURCE)
    jobs = {"parent": (PARENT, pose_lm.NVCC_EXTRA), "change": (change, pose_lm.NVCC_EXTRA),
            "_empty": (EMPTY, ())}
    for shape in shapes:
        w, _, c = shape.partition("x")
        flags = [f"-DPOSE_LM_THREADS={w}"] + ([f"-DPOSE_LM_CLUSTER={c}"] if c else [])
        jobs[f"change@{shape}"] = (change, (*pose_lm.NVCC_EXTRA, *flags))
    os.makedirs(STUDY_DIR, exist_ok=True)
    if marks:
        jobs["_marks"] = (write_marks(change), pose_lm.NVCC_EXTRA)
    built = {}

    def make(label, src, extra):
        so = os.path.join(STUDY_DIR, f"lib{label.replace('@', '_')}.so")
        proc = subprocess.run([hamming_nn._nvcc(), *hamming_nn.NVCC_FLAGS, *extra, "-Xptxas",
                               "-v", "-o", so, src], capture_output=True, text=True)
        if proc.returncode == 0:
            built[label] = (so, proc.stdout + proc.stderr)
        else:
            print(f"nvcc failed on {label}:\n{proc.stdout}{proc.stderr}", file=sys.stderr)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=make, args=(lb, *job)) for lb, job in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if set(built) != set(jobs):
        raise SystemExit("pose_lm_study: a build failed")
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.3f} s, one nvcc a build")
    return built


def load(built: dict) -> dict:
    """{label: the loaded library} of each pose LM build, its kernels
    loaded on the current device."""
    from multicol_slam_tpu_torch.kernels import pose_lm

    libs = {}
    for label, (so, _) in built.items():
        if label.startswith("_"):
            continue
        lib = ctypes.CDLL(so)
        pose_lm.bind(lib)
        err = lib.pose_lm_init()
        if err != 0:
            raise SystemExit(f"pose_lm_study: pose_lm_init of {label}: cudaError {err}")
        libs[label] = lib
    return libs


def attributes(lib) -> dict:
    """Registers and local bytes a thread of each instance (and, where the
    build reports them, its cluster size, CTA width and the clusters of
    that shape the card can hold at once)."""
    out = {}
    for f64, name in ((0, "float32"), (1, "float64")):
        vals = (ctypes.c_int * 5)(*([-1] * 5))
        if lib.pose_lm_attributes(f64, vals) != 0:
            raise SystemExit("pose_lm_study: pose_lm_attributes failed")
        out[name] = dict(zip(("registers", "local_bytes", "cluster", "threads",
                              "max_active_clusters"), list(vals)))
    return out


def turns(libs) -> list:
    """The order of the builds in one round of timing."""
    rest = [lb for lb in libs if lb.startswith("change@")]
    return ["parent", "change", *rest, "change", *rest, "parent"]


def launcher(lib, inputs, **over):
    """A function that launches lib's kernel on a recorded call's inputs
    ((args, kwargs) of pose_optimization, with ``over`` in place of the
    launch settings) into outputs made once; and those outputs."""
    import torch

    from multicol_slam_tpu_torch.kernels import pose_lm
    from multicol_slam_tpu_torch.models import optimizer

    a, k = inputs
    rig, mt0, obs, X = a[:4]
    kw = dict(huber=k.get("huber", optimizer.HUBER_POSE), iters1=k.get("iters1", 10),
              iters2=k.get("iters2", 10), tau=optimizer.LM_TAU, gain_eps=optimizer.GAIN_EPS)
    kw.update(over)
    pose_lm.check(rig, mt0, obs, X)
    out = pose_lm.outputs_like(mt0, obs.uv.shape[0])
    args = pose_lm.arguments(rig, mt0, obs, X, out, **kw)

    def fn():
        err = lib.pose_lm_launch(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"pose LM launch failed: cudaError {err}")
    return fn, out


def timed(libs, inputs, **over) -> dict:
    """{build: [device us a launch, one a turn]} on one input."""
    import chip_smoke as cs

    us = {}
    for b in turns(libs):
        fn = launcher(libs[b], inputs, **over)[0]
        us.setdefault(b, []).append(round(cs.device_ms(fn) * 1e3, 3))
    return us


def floors(built, shapes) -> dict:
    """Device us of an empty launch: one block of 512 threads (the parent's
    shape) and one empty cluster (tools/empty_kernel.cu) of each (CTAs,
    CTA width) in ``shapes``."""
    import torch

    import chip_smoke as cs

    empty = ctypes.CDLL(built["_empty"][0])
    empty.empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    empty.empty_cluster_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for f in (empty.empty_launch, empty.empty_cluster_launch, empty.empty_init):
        f.restype = ctypes.c_int
    if empty.empty_init() != 0:
        raise SystemExit("pose_lm_study: empty_init failed")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    out = {"block_512": cs.device_ms(lambda: empty.empty_launch(512, stream())) * 1e3}
    for n, w in sorted(shapes):
        out[f"cluster_{n}x{w}"] = cs.device_ms(lambda n=n, w=w: empty.empty_cluster_launch(
            n, w, stream())) * 1e3
    return {k: round(v, 3) for k, v in out.items()}


# -- the call sites ---------------------------------------------------------------

def record_sites(dev):
    """(each site's first inputs, its launches) over the system run; the
    forced relocalizations run with the tracker's units eager, so that
    their pose LM calls, replayed from graphs otherwise, are recorded."""
    import torch

    import chip_smoke as cs
    from multicol_slam_tpu_torch.models import tracking
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io, graphs, synthetic

    with cs.PoseSpy() as spy:
        slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR)
        tr = slam.tracker
        gt = synthetic.bench_trajectory(FRAMES + RELOCS)
        render = synthetic.make_renderer(slam.rig)
        frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev)))
        frames = frames.to(torch.uint8)
        for i in range(FRAMES):
            slam.track(frames[i], i / 25.0)
        held = {u: getattr(tr, u) for u in tracking.UNIT_NAMES}
        for u, g in held.items():
            if isinstance(g, graphs.jit):
                setattr(tr, u, g.fn)
        for i in range(FRAMES, FRAMES + RELOCS):
            tr.force_reloc = True
            slam.track(frames[i], i / 25.0)
        for u, g in held.items():
            setattr(tr, u, g)
        torch.cuda.synchronize()
    return dict(spy.first), dict(spy.launches)


def sites(libs, name) -> dict:
    import torch

    import chip_smoke as cs
    from multicol_slam_tpu_torch.models import optimizer

    first, launches = record_sites(torch.device("cuda", 0))
    report = {}
    for site, inputs in sorted(first.items()):
        a, k = inputs
        want = optimizer.pose_optimization_reference(*a, **k)
        plain_us = cs.device_ms(lambda: optimizer.pose_optimization_reference(*a, **k),
                                reps=2, rounds=3) * 1e3
        outs = {}
        for b, lib in libs.items():
            fn, out = launcher(lib, inputs)
            fn()
            torch.cuda.synchronize()
            outs[b] = dict(iterations=int(out[3]), inliers=int(out[2]),
                           pose_err=float((out[0].double() - want[0].double()).abs().max()),
                           mask_diff=int((out[1] != want[1]).sum()))
        us = timed(libs, inputs)
        row = dict(rows=int(a[2].uv.shape[0]), valid=int(a[2].valid.sum()),
                   dtype=str(a[1].dtype).replace("torch.", ""), launches=launches.get(site, 0),
                   plain=dict(iterations=int(want[3]), inliers=int(want[2]),
                              device_us=round(plain_us, 3)),
                   builds=outs, us=us, median_us={b: statistics.median(v) for b, v in us.items()})
        report[site] = row
        print(f"pose_lm@{site}: {row['rows']} rows ({row['valid']} valid) {row['dtype']}, "
              f"{row['launches']} launches; device us a launch {row['median_us']} (each turn "
              f"{us}); against the plain version ({row['plain']}): {outs} ({name})")
    return report


# -- the split of a pass ------------------------------------------------------------

def split_inputs():
    """{K: pose_optimization's arguments} on the card for each row count
    of SPLIT_ROWS: the first K rows of ``tests/_poseutil.py``'s problem."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _poseutil import problem, rig
    from multicol_slam_tpu_torch.models import optimizer

    dev = torch.device("cuda", 0)
    obs, X, mt0, _ = problem(0, max(SPLIT_ROWS))
    rig_, X, mt0 = rig(torch.float32).to(dev), X.to(dev), mt0.to(dev)
    return {K: (rig_, mt0, optimizer.BAObservations(*(t[:K].contiguous().to(dev) for t in obs)),
                X) for K in SPLIT_ROWS}


def split(libs, name) -> dict:
    import numpy as np

    points = {}
    for K, args in split_inputs().items():
        for it in SPLIT_ITERS:
            us = timed(libs, (args, {}), iters1=it, iters2=it, gain_eps=0.0)
            points[(K, it)] = {b: statistics.median(v) for b, v in us.items()}
            print(f"split: K {K}, {2 * it + 3} passes: device us a launch {points[(K, it)]} "
                  f"(each turn {us}) ({name})")
    fit = {}
    for b in libs:
        per_pass = {}
        for K in SPLIT_ROWS:
            p = np.array([2 * it + 3 for it in SPLIT_ITERS], float)
            t = np.array([points[(K, it)][b] for it in SPLIT_ITERS])
            per_pass[K] = round(float(np.polyfit(p, t, 1)[0]), 4)
        # K = 0 apart: with no rows H = 0, so every solve divides by zero
        ks = [K for K in SPLIT_ROWS if K > 0]
        row_us, fixed_us = np.polyfit(np.array(ks, float), np.array([per_pass[K] for K in ks]), 1)
        fit[b] = dict(pass_us=per_pass, pass_fixed_us=round(float(fixed_us), 4),
                      row_ns=round(float(row_us) * 1e3, 4))
        print(f"split, {b}: an iteration's device us (its solve and its pass) by rows "
              f"{per_pass}; fit over K > 0: {fit[b]['pass_fixed_us']} us + "
              f"{fit[b]['row_ns']} ns a row ({name})")
    return dict(points={f"{K}x{2 * it + 3}": v for (K, it), v in points.items()}, fit=fit)


# -- the stages of a pass -----------------------------------------------------------

STAGES = ("rows", "warp sums + barrier", "CTA sums to the ranks + cluster barrier",
          "ranks' sums added", "LM step (accept, solve)", "next pose's constants",
          "barrier before the rows")


def marks(built, name) -> dict:
    """The marks build's SM cycles a pass by stage (rank 0's thread 0) at
    23 passes over each row count of --split."""
    import numpy as np
    import torch

    from multicol_slam_tpu_torch.kernels import pose_lm

    lib = ctypes.CDLL(built["_marks"][0])
    pose_lm.bind(lib)
    lib.pose_lm_marks_read.argtypes = [ctypes.c_void_p]
    lib.pose_lm_marks_read.restype = ctypes.c_int
    if lib.pose_lm_init() != 0:
        raise SystemExit("pose_lm_study: pose_lm_init of the marks build failed")
    out = {}
    for K, args in split_inputs().items():
        fn = launcher(lib, (args, {}), iters1=10, iters2=10, gain_eps=0.0)[0]
        runs = []
        for _ in range(5):
            fn()
            torch.cuda.synchronize()
            rec = (ctypes.c_longlong * (len(STAGES) + 1))()
            if lib.pose_lm_marks_read(rec) != 0:
                raise SystemExit("pose_lm_study: pose_lm_marks_read failed")
            runs.append(list(rec))
        rec = np.median(np.array(runs, float), 0)
        passes = rec[-1]
        out[K] = {st: round(float(c / passes), 1) for st, c in zip(STAGES, rec[:-1])}
        clock = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, timeout=60).stdout.strip()
        out[K]["passes"], out[K]["sm_mhz_after"] = int(passes), clock
        print(f"marks: K {K}: SM cycles a pass by stage (rank 0, thread 0; median of 5 "
              f"calls of {int(passes)} passes) {out[K]} ({name})")
    return out


# -- beside the async mapper ----------------------------------------------------------

def device_kernels(prof) -> dict:
    """{stream: [(start ns, end ns, name)] in start order} of a profile's
    device activities."""
    from collections import defaultdict

    from torch.autograd import DeviceType

    out = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out[e.device_resource_id()].append((e.start_ns(), e.end_ns(), e.name()))
    return {k: sorted(v) for k, v in out.items()}


def spread(xs) -> dict:
    import numpy as np

    if not xs:
        return dict(n=0)
    return dict(n=len(xs), median=round(float(np.median(xs)), 3),
                p90=round(float(np.percentile(xs, 90)), 3), max=round(float(max(xs)), 3))


def pose_launches(prof) -> dict:
    """Each pose LM launch of a profile: its device us and the us from the
    end of the kernel before it on its stream to its start (in a graph
    replay, the wait to be placed), split by whether an activity on
    another stream (the mapper's) ran at its start."""
    streams = device_kernels(prof)
    split = {"beside the mapper": ([], []), "alone": ([], [])}
    for sid, acts in streams.items():
        for i, (start, end, name) in enumerate(acts):
            if "pose_lm_kernel" not in name or i == 0:
                continue
            busy = any(a <= start < b for other, xs in streams.items() if other != sid
                       for a, b, _ in xs)
            dur, gap = split["beside the mapper" if busy else "alone"]
            dur.append((end - start) / 1e3)
            gap.append((start - acts[i - 1][1]) / 1e3)
    return {k: dict(device_us=spread(d), wait_us=spread(g)) for k, (d, g) in split.items()}


def async_run(so: str) -> dict:
    """One system with the async mapper, every capture launching the pose
    LM build ``so``: MultiColSLAM(async_mapping=True) over ASYNC_FRAMES
    frames of bench_trajectory, frames ASYNC_WARM on profiled; each pose
    LM launch's device us and wait beside the mapper and alone
    (pose_launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multicol_slam_tpu_torch.kernels import pose_lm
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io, synthetic

    lib = ctypes.CDLL(so)
    pose_lm.bind(lib)
    if lib.pose_lm_init() != 0:
        raise SystemExit(f"pose_lm_study: pose_lm_init of {so} failed")
    pose_lm._lib = lib
    dev = torch.device("cuda", 0)
    gt = torch.tensor(synthetic.bench_trajectory(ASYNC_FRAMES), dtype=torch.float32, device=dev)
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, async_mapping=True)
    frames = torch.round(synthetic.make_renderer(slam.rig)(gt)).to(torch.uint8)
    for i in range(ASYNC_WARM):
        slam.track(frames[i], i / 25.0)
    passes = len(slam.mapping_ms)
    # the profiler synchronizes the device as it stops, which a capture on
    # the mapper's thread refuses: stop the mapper first
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(ASYNC_WARM, ASYNC_FRAMES):
            slam.track(frames[i], i / 25.0)
        slam.shutdown()
    return dict(pose_launches(prof), mapping_passes=len(slam.mapping_ms) - passes)


def beside_ba(libs, name) -> dict:
    """Each build's us a launch on split_inputs' 2,400 and 5,472 rows at 13
    passes, between CUDA events around each launch on its stream (the
    wait to be placed included), alone and while the local BA
    (``bench.ba_rate``'s problem: 16 keyframes x 2,048 points, 10
    iterations, graphed) replays on another stream: the async mapper's
    heaviest device work beside the tracker's."""
    import torch

    from multicol_slam_tpu_torch import bench
    from multicol_slam_tpu_torch.models import optimizer
    from multicol_slam_tpu_torch.utils import config_io, graphs

    dev = torch.device("cuda", 0)
    rig = config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0].to(dev)
    problem, mt0, X0, _ = bench._ba_problem(rig, 16, 2048, dev)
    ba = graphs.jit(optimizer.bundle_adjustment)
    load = torch.cuda.Stream()
    run_ba = lambda: ba(rig, mt0, X0, problem, iters=10, early_stop=False)
    with torch.cuda.stream(load):
        run_ba()
        run_ba()
    torch.cuda.synchronize()
    ins, out = split_inputs(), {}
    for K in (2400, 5472):
        for b in turns(libs):
            fn = launcher(libs[b], (ins[K], {}), iters1=5, iters2=5, gain_eps=0.0)[0]
            fn()
            torch.cuda.synchronize()
            for mode in ("alone", "beside the BA"):
                if mode != "alone":
                    with torch.cuda.stream(load):
                        run_ba()
                evs = [(torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True)) for _ in range(BESIDE_REPS)]
                for e0, e1 in evs:
                    e0.record()
                    fn()
                    e1.record()
                torch.cuda.synchronize()
                us = statistics.median(e0.elapsed_time(e1) * 1e3 for e0, e1 in evs)
                out.setdefault(K, {}).setdefault(b, {}).setdefault(mode, []).append(round(us, 3))
        print(f"beside the BA: K {K}, 13 passes: us a launch between events, each turn "
              f"{out[K]} ({name})")
    return out


def async_mapper(built, libs, name) -> dict:
    """The builds beside the async mapper: a system run a build in turns,
    each in a process of its own (async_run), and beside_ba."""
    report = {"system": {}}
    for b in turns(libs):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--async-run",
                               built[b][0]], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"pose_lm_study: the async run of {b} failed:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        report["system"].setdefault(b, []).append(run)
        print(f"async mapper, {b}: pose LM launches over frames {ASYNC_WARM}-"
              f"{ASYNC_FRAMES - 1} {run} ({name})")
    report["beside_ba"] = beside_ba(libs, name)
    return report


# -- the bench's headline scan ----------------------------------------------------------

class Clocks:
    """The card's SM clock (MHz) and board power (W), medians of
    ``nvidia-smi`` samples every 50 ms while the block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        text = self.proc.communicate(timeout=30)[0]
        rows = []
        for line in text.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        med = lambda i: statistics.median(r[i] for r in rows) if rows else None
        self.mhz, self.watts = med(0), med(1)


def kernel_class(name: str) -> str:
    if "pose_lm_kernel" in name:
        return "pose LM"
    if "hamming" in name:
        return "Hamming NN"
    return "the rest"


def scan(name) -> dict:
    """The bench's headline (``bench.production_tracker`` at the bench's
    sizes, this tree's package): the bench's own timed call, SCAN_REPEATS
    more of the same call, and one under ``torch.profiler``: a frame's
    device us by kernel class (the pose LM kernel, the Hamming kernels,
    the rest) and the busiest kernels, the device's busy share of the
    profiled call, the pose LM launches' device us."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multicol_slam_tpu_torch import bench

    dev = torch.device("cuda", 0)
    timed, rec = bench.timed_ms, dict(ms=[], host_ms=[], sm_mhz=[], watts=[])

    def one(fn, dev):
        """The bench's timing of fn, and the host's ms to enqueue it and
        the card's clock and power while it ran."""
        def enqueue():
            t0 = time.perf_counter()
            out = fn()
            rec["host_ms"].append((time.perf_counter() - t0) * 1e3)
            return out
        with Clocks() as clk:
            out, ms = timed(enqueue, dev)
        rec["ms"].append(ms)
        rec["sm_mhz"].append(clk.mhz)
        rec["watts"].append(clk.watts)
        return out, ms

    def timed_ms(fn, dev):
        out, ms = one(fn, dev)
        for _ in range(SCAN_REPEATS):
            one(fn, dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rec["profiled_ms"] = timed(fn, dev)[1]
        rec["streams"] = device_kernels(prof)
        return out, ms

    bench.timed_ms = timed_ms
    try:
        sizes = bench.SIZES["full"]["headline"]
        fps, diag = bench.production_tracker(dev, **sizes)
    finally:
        bench.timed_ms = timed
    n = sizes["n_reps"] * sizes["n_scan"]
    acts = sorted(a for xs in rec.pop("streams").values() for a in xs)
    by_class, by_name, pose = {}, {}, []
    busy, reach = 0, acts[0][0]
    for start, end, kname in acts:
        us = (end - start) / 1e3
        by_class[kernel_class(kname)] = by_class.get(kernel_class(kname), 0.0) + us / n
        by_name[kname] = by_name.get(kname, 0.0) + us / n
        if kernel_class(kname) == "pose LM":
            pose.append(us)
        busy += max(0, end - max(start, reach))
        reach = max(reach, end)
    window_us = (acts[-1][1] - acts[0][0]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = dict(fps=fps, ms_per_frame=[round(ms / n, 4) for ms in rec["ms"]],
               host_enqueue_ms_per_frame=[round(ms / n, 4) for ms in rec["host_ms"]],
               sm_mhz=rec["sm_mhz"], watts=rec["watts"],
               profiled_ms_per_frame=round(rec["profiled_ms"] / n, 4),
               device_us_per_frame={k: round(v, 2) for k, v in by_class.items()},
               device_ops_per_frame=round(len(acts) / n, 2),
               busy_us_per_frame=round(busy / 1e3 / n, 2),
               busy_share=round(busy / 1e3 / window_us, 4),
               pose_lm_us=dict(spread(pose), mean=round(float(np.mean(pose)), 3)),
               top_kernels_us_per_frame={k[:80]: round(v, 2) for k, v in top},
               inliers_median=diag["inliers_median"], map_points=diag["map_points"])
    print(f"headline scan: {out} ({name})")
    return out


# -- relocalization by stage ---------------------------------------------------------

def reloc(card: str) -> None:
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from multicol_slam_tpu_torch.models import optimizer, tracking
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io, graphs, synthetic

    frames_n = FRAMES
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR)
    tr = slam.tracker
    gt = synthetic.bench_trajectory(frames_n + 3)
    render = synthetic.make_renderer(slam.rig)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32,
                                             device=slam.rig.M_c.device))).to(torch.uint8)
    for i in range(frames_n):
        slam.track(frames[i], i / 25.0)
    held = {u: getattr(tr, u) for u in tracking.UNIT_NAMES}
    for u, g in held.items():
        if isinstance(g, graphs.jit):
            setattr(tr, u, g.fn)
    targets = [(tr, "reloc_candidates_fn", "bow"), (tr, "_reloc_matches", "search_by_bow"),
               (tr, "_gpnp", "gp3p"), (tr, "_pose_opt", "pose_lm"),
               (tr, "_reloc_project_candidate", "projection"),
               (tr, "_track_local_map", "local_map"), (tr, "_relocalize", "total")]
    fns = {"build": optimizer.pose_optimization,
           "plain": optimizer.pose_optimization_reference}
    runs = {k: [] for k in fns}
    t = frames_n
    for label in ("build", "plain", "plain", "build"):
        tr._pose_opt = fns[label]
        for i in range(frames_n, frames_n + 3):
            tr.force_reloc = True
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                    cs.Ranges(*targets):
                ok = slam.track(frames[i], t / 25.0) is not None
                torch.cuda.synchronize()
            t += 1
            us, ops, total, n_ops, _ = cs.stage_device(prof, "total")
            runs[label].append(dict(us=us, ops=ops, ok=ok, path=tr.frame_path[-1]))
    for u, g in held.items():
        setattr(tr, u, g)
    report = {}
    for label, rs in runs.items():
        stages = sorted({k for r in rs for k in r["us"]})
        med = {k: round(statistics.median(r["us"].get(k, 0.0) for r in rs), 3) for k in stages}
        ops = {k: statistics.median(r["ops"].get(k, 0) for r in rs) for k in stages}
        report[label] = dict(device_us=med, device_ops=ops, relocalized=[r["ok"] for r in rs],
                             paths=[r["path"] for r in rs])
        print(f"_relocalize with the {label} pose LM ({len(rs)} forced, eager units, medians): "
              f"device us by stage {med}, device operations {ops}, relocalized "
              f"{report[label]['relocalized']} ({card})")
    return report


def orders() -> None:
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _poseutil import in_dtype, problem, rig
    from multicol_slam_tpu_torch.models import optimizer

    rows = []
    for seed in range(8):
        for dtype in (torch.float64, torch.float32):
            obs, X, mt0 = in_dtype(*problem(seed)[:3], dtype)
            flip = optimizer.BAObservations(*(t.flip(0) for t in obs))
            a = optimizer.pose_optimization_reference(rig(dtype), mt0, obs, X)
            b = optimizer.pose_optimization_reference(rig(dtype), mt0, flip, X)
            rows.append(dict(seed=seed, dtype=str(dtype), iterations=int(a[3]),
                             reversed=int(b[3]),
                             pose_diff=float((a[0] - b[0]).abs().max())))
            print(rows[-1])
    print(json.dumps({"orders": rows}))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--write-parent", metavar="REV",
                   help="write the kernel source at git revision REV as the parent, and stop")
    p.add_argument("--orders", action="store_true")
    p.add_argument("--reloc", action="store_true")
    p.add_argument("--sites", action="store_true")
    p.add_argument("--split", action="store_true")
    p.add_argument("--marks", action="store_true",
                   help="also build the change's marks copy and print a pass's cycles "
                        "by stage")
    p.add_argument("--async-mapper", action="store_true")
    p.add_argument("--async-run", metavar="SO", help=argparse.SUPPRESS)
    p.add_argument("--scan", action="store_true")
    p.add_argument("--shapes", nargs="*", default=[], metavar="WxC",
                   help="also time the current source built at these CTA widths W "
                        "(and, given, C CTAs a cluster), e.g. 512 or 256x16")
    a = p.parse_args(argv)
    if a.write_parent:
        return write_parent(a.write_parent)
    if a.orders:
        return orders()
    if a.async_run:
        return print(json.dumps(async_run(a.async_run)))
    builds = a.sites or a.split or a.marks or a.async_mapper
    if not (a.reloc or a.scan or builds):
        p.error("give --write-parent, --orders, --reloc, --scan, --sites, --split, --marks "
                "or --async-mapper")

    import torch

    from eig_study import ptxas_table
    from multicol_slam_tpu_torch.kernels import hamming_nn as knn
    from multicol_slam_tpu_torch.kernels import small_eig

    if not torch.cuda.is_available():
        raise SystemExit("pose_lm_study: no CUDA device")
    torch.cuda.set_device(torch.device("cuda", 0))
    name = card()
    print(name)
    knn.load_library()
    small_eig.load_library()
    report = {"card": name, "device": torch.cuda.get_device_name(0)}
    if a.scan:
        report["scan"] = scan(name)
    if builds:
        built = build_all(a.shapes, a.marks)
        libs = load(built)
        for label, (_, text) in built.items():
            for kern, props in ptxas_table(text).items():
                print(f"ptxas {label}: {kern}: {props}")
        report["attributes"] = {b: attributes(lib) for b, lib in libs.items()}
        shapes = {(at["float32"]["cluster"], at["float32"]["threads"])
                  for at in report["attributes"].values()}
        report["floor_us"] = floors(built, {sh for sh in shapes if sh[0] > 0})
        print(f"instances {report['attributes']}; launch floors, device us "
              f"{report['floor_us']} ({name})")
        if a.marks:
            report["marks"] = marks(built, name)
        if a.split:
            report["split"] = split(libs, name)
        if a.sites:
            report["sites"] = sites(libs, name)
        if a.async_mapper:
            report["async_mapper"] = async_mapper(built, libs, name)
    if a.reloc:
        report["reloc"] = reloc(name)
    print(name)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
