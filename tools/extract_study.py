#!/usr/bin/env python3
"""The extraction kernels on the card, parent tree against change, and the
measures of them that ``chip_smoke.py`` does not take.

    python3 tools/extract_study.py --write-parent HEAD~1   # in a git checkout: the parent tree
    python3 tools/extract_study.py --turns --sass --marks  # on one H100
    python3 tools/extract_study.py --designs --trig        # on one H100

``--write-parent REV`` unpacks the package, ``chip_smoke.py`` and
``tools/`` of git revision REV under ``kernels/build/study/parent/``
(ignored by git).

``--turns`` renders the recorded inputs once (``FRAMES`` frames of
``bench_trajectory``'s start on the in-repo rig, 754x480 x 3 cameras,
saved under ``kernels/build/study/``), then runs one process a tree in
the order parent, change, change, parent. Each process imports the
package and ``chip_smoke.py`` of its own tree and, on the same frames,
times ``detect`` and ``describe`` (device us a call by CUDA-graph replay,
``chip_smoke.device_ms``) at each configuration of ``CONFIGS`` (the
extractors ``MultiColSLAM`` builds: the default, its init extractor,
the mdBRIEF settings) and the graphed ``working_track_step``
(``chip_smoke.graph_runs`` over ``STEP_FRAMES`` frames, then each replay
profiled alone: device ms a frame). The outputs of both trees' kernels
are compared: detection's bucket maxima identical, the angles counted
where they differ, the bits where the angles agree.

``--sass`` builds both trees' sources with the port's flags and
``-Xptxas -v`` (registers, stack, spills), one ``nvcc`` a source, all at
once, and reads each kernel's SASS (``cuobjdump -sass``): its
instructions, integer divisions, and each loop (a backward branch) with
its body's instructions by class. A loop over pixels runs its body once
a pixel, so its length is the instructions a pixel.

``--designs`` builds the change's detection in the design not taken
(``STORE_PATCH``: launch 1 stores s_lo, launch 2 reads it back) and times
it against the change's in turns at each configuration.

``--marks`` builds a copy of each tree's sources with clock reads put in
at fixed places (``write_marks``: the kernels themselves carry none) and
runs it once on the default configuration's recorded frame: each launch's
CTAs, the SM cycles a CTA by stage (thread 0's clock after each barrier),
and for the parent's detection the warp cycles spent in Harris.

Each mode prints the card's name and power limit; the last line is one
JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
STUDY_DIR = os.path.join(ROOT, "multicol_slam_tpu_torch", "kernels", "build", "study")
PARENT_TREE = os.path.join(STUDY_DIR, "parent")
INPUTS = os.path.join(STUDY_DIR, "extract_inputs.pt")
SOURCES = {"detect": "multicol_slam_tpu_torch/csrc/fast_detect.cu",
           "describe": "multicol_slam_tpu_torch/csrc/orb_describe.cu"}
FRAMES = 9             # frame 0 bootstraps the map; the kernels are timed on frame 1
STEP_FRAMES = 8        # graphed WORKING steps profiled a process
TURNS = ("parent", "change", "change", "parent")
CONFIGS = {"default": {}, "mdbrief": dict(use_mdbrief=True, learn_masks=True, use_agast=True,
                                          fast_agast_type=2)}
MARK_SLOTS = 32


def card() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()


def write_parent(rev: str) -> None:
    """The package, chip_smoke.py and tools/ at git revision rev, unpacked
    into PARENT_TREE."""
    import shutil

    shutil.rmtree(PARENT_TREE, ignore_errors=True)
    os.makedirs(PARENT_TREE)
    archive = subprocess.run(["git", "-C", ROOT, "archive", rev, "multicol_slam_tpu_torch",
                              "chip_smoke.py", "tools"], capture_output=True, check=True).stdout
    subprocess.run(["tar", "-x", "-C", PARENT_TREE], input=archive, check=True)
    print(f"wrote {os.path.relpath(PARENT_TREE, ROOT)} from {rev}")


def tree_of(label: str) -> str:
    return PARENT_TREE if label == "parent" else ROOT


# -- the recorded inputs and one tree's timings -----------------------------------------

def record() -> None:
    """Render FRAMES frames of bench_trajectory's start on the card into
    INPUTS (uint8 frames and the true poses)."""
    import torch

    from multicol_slam_tpu_torch.utils import config_io, synthetic

    rig, _ = config_io.load_mcs(config_io.SYNTH_RIG_DIR)
    gt = synthetic.smooth_trajectory(100, radius=0.6)[:FRAMES]
    render = synthetic.make_renderer(rig.to("cuda"))
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device="cuda")))
    os.makedirs(STUDY_DIR, exist_ok=True)
    torch.save({"frames": frames.to(torch.uint8).cpu(), "gt": gt}, INPUTS)


def kernel_inputs(ex, cfg, masks, hw, images):
    """The detection and descriptor wrappers' arguments at one extractor
    configuration, as phase 19 of chip_smoke.py makes them: (levels, masks,
    buckets, keywords) and (pyramid, yx, level, pattern)."""
    import numpy as np
    import torch

    from multicol_slam_tpu_torch.models import extractor
    from multicol_slam_tpu_torch.ops import brief, pyramid

    dev = images.device
    sizes = pyramid.level_sizes(*hw, cfg.n_levels, cfg.scale_factor)
    budgets = extractor.features_per_level(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    lv = [lvl for lvl in range(cfg.n_levels) if budgets[lvl] > 0]
    buckets = [extractor._level_buckets(*sizes[lvl], budgets[lvl]) for lvl in lv]
    pyr = pyramid.build_pyramid(images.to(torch.float32), cfg.n_levels, cfg.scale_factor)
    mk = [torch.from_numpy(np.asarray(masks[lvl]) > 0).to(dev) for lvl in lv]
    kw = dict(th_hi=cfg.fast_th, th_lo=cfg.fast_th_min, cell=cfg.cell, border=cfg.border,
              ring=cfg.detector_mask, harris=cfg.use_harris)
    feats = ex.plain(images)
    scales = torch.tensor(pyramid.scale_factors(cfg.n_levels, cfg.scale_factor),
                          device=dev)[feats.level.long()]
    yx = torch.round(feats.xy.flip(-1) / scales[..., None]).to(torch.int32).contiguous()
    pattern = None if cfg.use_dbrief else torch.from_numpy(
        brief.make_pattern(cfg.n_pairs)).to(dev)
    return ([pyr[lvl] for lvl in lv], mk, buckets, kw), (pyr, yx, feats.level.contiguous(),
                                                          pattern)


def extractors(dev):
    """{name: (cfg, masks, hw, extract)}: the extractors MultiColSLAM makes
    at each of CONFIGS (the default's init extractor as "init")."""
    from multicol_slam_tpu_torch.models import extractor, system
    from multicol_slam_tpu_torch.utils import config_io

    made, real = [], extractor.make_extractor

    def keep(cfg, cams, masks, hw):
        ex = real(cfg, cams, masks, hw)
        made.append((cfg, masks, hw, ex))
        return ex
    out = {}
    extractor.make_extractor = system.make_extractor = keep
    try:
        for name, kw in CONFIGS.items():
            made.clear()
            system.MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, device=dev,
                                settings=config_io.SlamSettings(**kw),
                                enable_loop_closing=False)
            out[name] = made[0]
            if name == "default":
                out["init"] = made[1]
    finally:
        extractor.make_extractor = system.make_extractor = real
    return out


def worker(tree: str, out_path: str) -> None:
    """One tree's timings on the recorded inputs, written to out_path
    (JSON) with the kernels' outputs beside it (.pt)."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from multicol_slam_tpu_torch.kernels import extract as ek
    from multicol_slam_tpu_torch.kernels import hamming_nn as knn
    from multicol_slam_tpu_torch.kernels import pose_lm, small_eig
    from multicol_slam_tpu_torch.utils import config_io

    assert ek.__file__.startswith(tree), (ek.__file__, tree)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for lib in (knn, small_eig, pose_lm):
        lib.load_library()
    ek.load_library()
    name = card()
    rec = torch.load(INPUTS, weights_only=False)
    frames, gt = rec["frames"].to(dev), rec["gt"]
    report, outputs = {"tree": tree, "card": name, "kernels": {}}, {}
    for cfg_name, (cfg, masks, hw, ex) in extractors(dev).items():
        (levels, mk, buckets, kw), (pyr, yx, lvl, pattern) = kernel_inputs(
            ex, cfg, masks, hw, frames[1])
        report["kernels"][cfg_name] = dict(
            detect_us=round(cs.device_ms(lambda: ek.detect(levels, mk, buckets, **kw)) * 1e3, 3),
            describe_us=round(cs.device_ms(lambda: ek.describe(pyr, yx, lvl, pattern)) * 1e3,
                              3))
        outputs[cfg_name] = (ek.detect(levels, mk, buckets, **kw),
                             ek.describe(pyr, yx, lvl, pattern), lvl)
    args, kw, step, _, _ = cs.graph_runs(dev, knn, name, config_io.SlamSettings(), frames,
                                         gt, STEP_FRAMES, "study")
    step(*args[0], **kw)
    runs = [cs.profiled(lambda _, i=i: step(*args[i], **kw), 1) for i in range(STEP_FRAMES)]
    report["graphed_step_ms"] = round(sum(r[1] for r in runs) / STEP_FRAMES, 4)
    torch.save({k: [(t.cpu() if torch.is_tensor(t) else [u.cpu() for u in t]) for t in v]
                for k, v in outputs.items()}, out_path + ".pt")
    with open(out_path, "w") as f:
        json.dump(report, f)


def compare_outputs(a: dict, b: dict) -> dict:
    """Detection identical, angles apart, bits apart where angles agree,
    between two trees' saved outputs."""
    import torch

    out = {}
    for cfg_name in a:
        (va, aa), (ang_a, da), lvl = a[cfg_name]
        (vb, ab), (ang_b, db), _ = b[cfg_name]
        same = ang_a == ang_b
        bits = (da != db) if da.dim() == 3 else (da != db).flatten(2)
        out[cfg_name] = dict(
            detection_identical=bool(torch.equal(va, vb) and torch.equal(aa, ab)),
            angles_apart=int((~same).sum()), angles_apart_level0=int((~same)[lvl == 0].sum()),
            max_angle_diff=float((ang_a - ang_b).abs().max()),
            outputs_apart_at_equal_angle=int(bits[same].sum()))
    return out


def turns() -> dict:
    """One process a tree in the order TURNS on the recorded inputs."""
    import torch

    if not os.path.isdir(PARENT_TREE):
        raise SystemExit(f"extract_study: no parent tree at {PARENT_TREE}: run "
                         "`python3 tools/extract_study.py --write-parent HEAD~1` in a git "
                         "checkout")
    record()
    runs = []
    for i, label in enumerate(TURNS):
        out = os.path.join(STUDY_DIR, f"turn{i}_{label}.json")
        env = dict(os.environ, PYTHONPATH=tree_of(label))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               tree_of(label), out], cwd=tree_of(label), env=env,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"extract_study: the {label} worker failed:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        with open(out) as f:
            runs.append((label, json.load(f)))
        print(f"turn {i} ({label}): {runs[-1][1]['kernels']}, graphed WORKING step "
              f"{runs[-1][1]['graphed_step_ms']} device ms a frame")
    saved = {lb: torch.load(os.path.join(STUDY_DIR, f"turn{TURNS.index(lb)}_{lb}.json.pt"))
             for lb in ("parent", "change")}
    table = {}
    for label, rep in runs:
        for cfg_name, t in rep["kernels"].items():
            for k, v in t.items():
                table.setdefault(cfg_name, {}).setdefault(f"{k}_{label}", []).append(v)
        table.setdefault("graphed_step_ms", {}).setdefault(label, []).append(
            rep["graphed_step_ms"])
    against = compare_outputs(saved["parent"], saved["change"])
    print(f"in turns {TURNS}: {table}; change against parent {against}")
    return {"times": table, "change_against_parent": against}


# -- builds, SASS and the clock marks ----------------------------------------------------

# The clock marks: thread 0 of a CTA adds the SM cycles since the last
# mark to a slot (atomics: the copy is for measuring, not for the port),
# each slot a stage. Slots 0-7 the cells' launch, 8-18 the tiles', 20-26
# the descriptor's; slot 31 counts skipped tiles, 30 the warp cycles in
# the parent's Harris, 28, 29 and 19 count CTAs.
MARKS_HEAD = """
__device__ unsigned long long extract_marks[%d];
#define MARK_START long long mark_t = clock64();
#define MARK(i) if (threadIdx.x == 0) { const long long mark_n = clock64(); \\
    atomicAdd(&extract_marks[i], (unsigned long long)(mark_n - mark_t)); mark_t = mark_n; }
#define COUNT(i) if (threadIdx.x == 0) atomicAdd(&extract_marks[i], 1ull);
extern "C" int extract_marks_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, extract_marks, sizeof(extract_marks));
}
extern "C" int extract_marks_reset() {
  unsigned long long zero[%d] = {};
  return (int)cudaMemcpyToSymbol(extract_marks, zero, sizeof(zero));
}
""" % (MARK_SLOTS, MARK_SLOTS)

# (source, stage names by slot, [(anchor, replacement)]) for each source
# the marks know; a source takes the set whose anchors all stand once in it
MARKS = {
    "detect@two-passes": ({0: "cells: setup + window load", 1: "cells: score every pixel + OR",
                     8: "tiles: setup + mask/border test", 9: "tiles: window load",
                     10: "tiles: score (b + 2)^2 pixels", 11: "tiles: NMS + Harris + thread max",
                     12: "tiles: warp and CTA max", 30: "warp cycles in Harris"},
                    [("#include <stdint.h>\n", "#include <stdint.h>\n" + MARKS_HEAD),
                     ("  extern __shared__ float win[];\n",
                      "  extern __shared__ float win[];\n  MARK_START COUNT(28)\n"),
                     ("cy0 - R, cx0 - R, n);\n  __syncthreads();\n",
                      "cy0 - R, cx0 - R, n);\n  __syncthreads();\n  MARK(0)\n"),
                     ("  hit = __syncthreads_or(hit);\n",
                      "  hit = __syncthreads_or(hit);\n  MARK(1)\n"),
                     ("  const int n = t.cell + 2 * R;\n", "  const int n = t.cell + 2 * R;\n  MARK(2)\n"),
                     ("  float* comb = smem + n * n;\n", "  float* comb = smem + n * n;\n  MARK(9)\n"),
                     ("  extern __shared__ float smem[];\n",
                      "  extern __shared__ float smem[];\n  MARK_START COUNT(29)\n"),
                     ("  if (!__syncthreads_or(need)) {\n",
                      "  const int any_need = __syncthreads_or(need);\n  MARK(8)\n"
                      "  if (!any_need) {\n    COUNT(31)\n"),
                     ("ty0 - HALO, tx0 - HALO, n);\n  __syncthreads();\n",
                      "ty0 - HALO, tx0 - HALO, n);\n  __syncthreads();\n  MARK(9)\n"),
                     ("    comb[i] = v;\n  }\n  __syncthreads();\n",
                      "    comb[i] = v;\n  }\n  __syncthreads();\n  MARK(10)\n"),
                     ("  float best = -INFINITY;\n  int arg = 0x7fffffff;\n",
                      "  float best = -INFINITY;\n  int arg = 0x7fffffff;\n  long long harris_c = 0;\n"),
                     ("      if (t.harris)\n",
                      "      const long long harris_t = clock64();\n      if (t.harris)\n"),
                     ("      s = nms;\n", "      s = nms;\n      harris_c += clock64() - harris_t;\n"),
                     ("  // the warp's, then the CTA's (value, lower index)\n",
                      "  if (threadIdx.x % 32 == 0) atomicAdd(&extract_marks[30], "
                      "(unsigned long long)harris_c);\n"
                      "  // the warp's, then the CTA's (value, lower index)\n"),
                     ("    red_i[warp] = arg;\n  }\n  __syncthreads();\n",
                      "    red_i[warp] = arg;\n  }\n  __syncthreads();\n  MARK(11)\n"),
                     ("    vals[out + tile] = best;\n    args[out + tile] = arg;\n  }\n}\n",
                      "    vals[out + tile] = best;\n    args[out + tile] = arg;\n  }\n"
                      "  MARK(12)\n}\n")]),
    "describe@cta-a-keypoint": ({20: "row table + window load", 21: "moments + horizontal sums",
                       22: "vertical sums, rounding", 23: "ORB"},
                      [("#include <stdint.h>\n", "#include <stdint.h>\n" + MARKS_HEAD),
                       ("  const int kp = blockIdx.x;\n",
                        "  const int kp = blockIdx.x;\n  MARK_START COUNT(19)\n"),
                       ("    raw[i] = x < widths[r] ? rows[r][x] : 0.0f;\n  }\n  __syncthreads();\n",
                        "    raw[i] = x < widths[r] ? rows[r][x] : 0.0f;\n  }\n  __syncthreads();\n"
                        "  MARK(20)\n"),
                       ("    hsum[i] = s;\n  }\n  __syncthreads();\n",
                        "    hsum[i] = s;\n  }\n  __syncthreads();\n  MARK(21)\n"),
                       ("  if (desc == nullptr) return;\n  __syncthreads();\n",
                        "  if (desc == nullptr) return;\n  __syncthreads();\n  MARK(22)\n"),
                       ("    if (lane == 0) desc[(size_t)kp * words + base / 32] = (int)bits;\n  }\n",
                        "    if (lane == 0) desc[(size_t)kp * words + base / 32] = (int)bits;\n  }\n"
                        "  __syncthreads();\n  MARK(23)\n")]),
    "detect@bit-masks": ({2: "cells: setup", 0: "cells: window copies + wait",
                     1: "cells: bit test + OR",
                     9: "tiles: setup + need flag", 8: "tiles: window copies + wait",
                     10: "tiles: bit test, minima where it passes, flags",
                     14: "tiles: suppression, the warps' survivor lists, Harris, warp max",
                     15: "tiles: CTA max"},
                    [("#include <stdint.h>\n", "#include <stdint.h>\n" + MARKS_HEAD),
                     ("  const Level& L = t.lv[level_of(t, blk, false)];\n  if (threadIdx.x == 0) found = 0;\n",
                      "  const Level& L = t.lv[level_of(t, blk, false)];\n  if (threadIdx.x == 0) found = 0;\n"
                      "  MARK_START COUNT(28)\n"),
                     ("                            n, t.div_cell_win);\n  window_wait();\n",
                      "                            n, t.div_cell_win);\n  window_wait();\n  MARK(0)\n"),
                     ("  hit = __syncthreads_or(hit);\n",
                      "  hit = __syncthreads_or(hit);\n  MARK(1)\n"),
                     ("  const int n = t.cell + 2 * R;\n", "  const int n = t.cell + 2 * R;\n  MARK(2)\n"),
                     ("  extern __shared__ float smem[];  // the window, then the scores\n",
                      "  extern __shared__ float smem[];\n  MARK_START COUNT(29)\n"),
                     ("  if (!flags[t.need0 + blk]) {\n",
                      "  MARK(9)\n  if (!flags[t.need0 + blk]) {\n    COUNT(31)\n"),
                     ("           mask[(size_t)y * W + x];\n  };\n  window_wait();\n",
                      "           mask[(size_t)y * W + x];\n  };\n  window_wait();\n  MARK(8)\n"),
                     ("    comb[p.r * m + p.c] = v;\n  }\n  __syncthreads();\n",
                      "    comb[p.r * m + p.c] = v;\n  }\n  __syncthreads();\n  MARK(10)\n"),
                     ("    red_i[warp] = arg;\n  }\n  __syncthreads();\n",
                      "    red_i[warp] = arg;\n  }\n  __syncthreads();\n  MARK(14)\n"),
                     ("    vals[out + tile] = best;\n    args[out + tile] = arg;\n  }\n}\n",
                      "    vals[out + tile] = best;\n    args[out + tile] = arg;\n  }\n"
                      "  MARK(15)\n}\n")]),
    "describe@two-warps": ({20: "window load", 21: "moments (+ the patch's columns)",
                       23: "row sums in place, cos, sin", 22: "ORB sampling"},
                      [("#include <stdint.h>\n", "#include <stdint.h>\n" + MARKS_HEAD),
                       ("  const int kp = blockIdx.x;\n",
                        "  const int kp = blockIdx.x;\n  MARK_START COUNT(19)\n"),
                       ("  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n  __syncthreads();\n",
                        "  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n  __syncthreads();\n"
                        "  MARK(20)\n"),
                       ("  __syncthreads();\n  const float a = atan2f(",
                        "  __syncthreads();\n  MARK(21)\n  const float a = atan2f("),
                       ("  const float cs = sin_cos(a, 1), sn = sin_cos(a, 0);\n  __syncthreads();\n",
                        "  const float cs = sin_cos(a, 1), sn = sin_cos(a, 0);\n  __syncthreads();\n"
                        "  MARK(23)\n"),
                       ("    for (int e = 0; e < 4; ++e) pt[e] = next[e];\n  }\n",
                        "    for (int e = 0; e < 4; ++e) pt[e] = next[e];\n  }\n"
                        "  __syncthreads();\n  MARK(22)\n")]),
}


# The design not taken for detection (--designs): launch 1 takes s_lo at
# every pixel (the bit test at th_lo and the minima where it passes),
# stores it (a float a pixel of every level and camera, in a buffer of the
# copy's own) and ORs the flag from it; launch 2 reads s_lo back with its
# one-pixel halo and takes no ring work. Each (anchor, text) replaces the
# one place where anchor stands in csrc/fast_detect.cu.
STORE_PATCH = (
    ("  int flag0;             // the level's first flag: flag0 + c * cells + cell\n",
     "  int flag0;             // the level's first flag: flag0 + c * cells + cell\n"
     "  long long score0;      // the level's first score\n"),
    ("  unsigned long long div_cell, div_cell_win;   // by the cell edge, by cell + 2 R\n",
     "  unsigned long long div_cell, div_cell_win;   // by the cell edge, by cell + 2 R\n"
     "  float* scores;         // s_lo of every level, camera and pixel\n"),
    # launch 1: s_lo at every pixel of the cell, stored, and the flag from it
    ("""      float d[N];
      bool bright, dark;
      ring_bits<N>(win, n, (p.r + R) * n + p.c + R, t.t_flag, d, bright, dark);
      hit |= bright || dark;
    }
    p.next();
    if (__any_sync(0xffffffffu, hit)) {
      *(volatile int*)&found = 1;
      break;
    }
    if (*(volatile int*)&found) break;
""", """      const float s = ring_score<N>(win, n, (p.r + R) * n + p.c + R, t.t_lo, t.th_lo);
      t.scores[L.score0 + ((long long)cam * L.H + cy0 + p.r) * L.W + cx0 + p.c] = s;
      hit |= s >= t.th_hi && s > 0.0f;
    }
    p.next();
"""),
    # launch 2: s_lo read back
    ("      v = ring_score<N>(win, n, (p.r + HALO - 1) * n + p.c + HALO - 1, t.t_lo, t.th_lo);\n",
     "      v = t.scores[L.score0 + ((long long)cam * H + y) * W + x];\n"),
    ("  int cell_ctas = 0, tile_ctas = 0, nflag = 0, max_bucket = 1;\n",
     "  int cell_ctas = 0, tile_ctas = 0, nflag = 0, max_bucket = 1;\n  long long nscore = 0;\n"),
    ("    v.flag0 = nflag;\n", "    v.flag0 = nflag;\n    v.score0 = nscore;\n    nscore += (long long)C * v.H * v.W;\n"),
    ("  if ((long long)nflag + tile_ctas > n_flags) return (int)cudaErrorInvalidValue;\n",
     "  if ((long long)nflag + tile_ctas > n_flags) return (int)cudaErrorInvalidValue;\n"
     "  static float* scores = nullptr;\n  static long long have = 0;\n"
     "  if (nscore > have) {\n    if (scores) cudaFree(scores);\n"
     "    if (cudaMalloc(&scores, nscore * sizeof(float)) != cudaSuccess) return (int)cudaErrorMemoryAllocation;\n"
     "    have = nscore;\n  }\n  t.scores = scores;\n"),
)


def write_store_design(src: str) -> str:
    """The store design's copy of the detection source src (STORE_PATCH),
    written under STUDY_DIR; returns its path."""
    text = open(src).read()
    for anchor, add in STORE_PATCH:
        if text.count(anchor) != 1:
            raise SystemExit(f"extract_study: the store design's anchor {anchor[:60]!r} stands "
                             f"{text.count(anchor)} times in {src}, want once")
        text = text.replace(anchor, add)
    out = os.path.join(STUDY_DIR, "fast_detect_store.cu")
    with open(out, "w") as f:
        f.write(text)
    return out


def designs(built: dict, name: str) -> dict:
    """The change's detection (launch 2 redoes the bit test) against the
    store design, in turns recompute, store, store, recompute, at each
    recorded configuration: device us a call and outputs against the plain
    version."""
    import torch

    import chip_smoke as cs
    from multicol_slam_tpu_torch.kernels import extract as ek

    if not os.path.exists(INPUTS):
        record()
    rec = torch.load(INPUTS, weights_only=False)
    images = rec["frames"][1].to("cuda")
    libs = {}
    for label, key in (("recompute", ("change", "detect")), ("store", ("store", "detect"))):
        lib = bind(ctypes.CDLL(built[key][0]), "detect")
        if lib.fast_detect_init() != 0:
            raise SystemExit(f"extract_study: fast_detect_init of the {label} build failed")
        libs[label] = lib
    out = {}
    for cfg_name, (cfg, masks, hw, ex) in extractors(torch.device("cuda", 0)).items():
        (levels, mk, buckets, kw), _ = kernel_inputs(ex, cfg, masks, hw, images)
        want = ek.detect_reference(levels, mk, buckets, **kw)
        for label in ("recompute", "store", "store", "recompute"):
            fn = lambda: launch_detect(libs[label], levels, mk, buckets, **kw)
            got = fn()
            torch.cuda.synchronize()
            same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            out.setdefault(cfg_name, {}).setdefault(label, []).append(
                (round(cs.device_ms(fn) * 1e3, 3), same))
        print(f"designs {cfg_name}: device us a call (equal to the plain version) {out[cfg_name]} "
              f"({name})")
    return out


# -- a build of another source: the parent's, a marks copy, the store design -----------

def bind(lib: ctypes.CDLL, which: str) -> ctypes.CDLL:
    """Bind the init and launch entries of a build of ``which``'s source
    ("detect" or "describe"; any tree's, a marks copy or a design) as the
    port's wrappers call them; returns lib."""
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    if which == "detect":
        lib.fast_detect_launch.argtypes = ([ptr, ptr, ptr] + [i32] * 5
                                           + [f32, f32, i32, i32, f32, f32]
                                           + [ptr, i64, ptr, ptr, ptr])
        lib.fast_detect_launch.restype = lib.fast_detect_init.restype = i32
    else:
        lib.orb_describe_launch.argtypes = ([ptr, ptr] + [i32] * 3 + [ptr] * 3 + [i32]
                                            + [ptr] * 4)
        lib.orb_describe_launch.restype = lib.orb_describe_init.restype = i32
    return lib


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def launch_detect(lib, levels, masks, buckets, *, th_hi, th_lo, cell, border, ring, harris):
    """Launch a bound detection build (its init run) on the current
    stream with the arguments ``ek.detect`` passes: (vals, args)."""
    import torch

    from multicol_slam_tpu_torch.kernels import extract as ek

    dev = levels[0].device
    C, L = levels[0].shape[0], len(levels)
    sizes = [tuple(img.shape[-2:]) for img in levels]
    T = max(ek.n_tiles(h, w, b) for (h, w), b in zip(sizes, buckets))
    n_flags = sum(C * (ek.n_tiles(h, w, cell) + ek.n_tiles(h, w, b))
                  for (h, w), b in zip(sizes, buckets))
    vals = torch.empty((C, L, T), dtype=torch.float32, device=dev)
    args = torch.empty((C, L, T), dtype=torch.int32, device=dev)
    flags = torch.empty(n_flags, dtype=torch.uint8, device=dev)
    dims = (ctypes.c_int * (3 * L))(*[v for (h, w), b in zip(sizes, buckets) for v in (h, w, b)])
    err = lib.fast_detect_launch(
        _ptrs(levels), _ptrs(masks), dims, L, C, T, int(cell), int(border), float(th_hi),
        float(th_lo), ek.RING_PIXELS[ring], int(bool(harris)), ek.HARRIS_K, ek.HARRIS_SCALE2,
        flags.data_ptr(), n_flags, vals.data_ptr(), args.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise SystemExit(f"extract_study: detection launch failed: cudaError {err}")
    return vals, args


def launch_describe(lib, levels, yx, level, pattern):
    """Launch a bound descriptor build (its init run) on the current
    stream with the arguments ``ek.describe`` passes: (angle, out)."""
    import torch

    from multicol_slam_tpu_torch.kernels import extract as ek

    dev = levels[0].device
    C, K = level.shape
    angle = torch.empty((C, K), dtype=torch.float32, device=dev)
    n_pairs = 0 if pattern is None else pattern.shape[0] // 2
    out = torch.empty((C, K, ek.BLUR_SIDE, ek.BLUR_SIDE), dtype=torch.float32, device=dev) \
        if pattern is None else torch.empty((C, K, n_pairs // 32), dtype=torch.int32, device=dev)
    dims = (ctypes.c_int * (2 * len(levels)))(*[v for t in levels for v in t.shape[-2:]])
    err = lib.orb_describe_launch(
        _ptrs(levels), dims, len(levels), C, K, yx.data_ptr(), level.data_ptr(),
        None if pattern is None else pattern.data_ptr(), n_pairs, angle.data_ptr(),
        None if pattern is None else out.data_ptr(), out.data_ptr() if pattern is None else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise SystemExit(f"extract_study: descriptor launch failed: cudaError {err}")
    return angle, out


def write_marks(src: str, label: str) -> tuple:
    """The marks copy of src (the MARKS set whose anchors all stand once
    in it), written under STUDY_DIR: (its path, its stage names)."""
    text = open(src).read()
    for key, (stages, patch) in MARKS.items():
        if all(text.count(anchor) == 1 for anchor, _ in patch):
            for anchor, add in patch:
                text = text.replace(anchor, add)
            out = os.path.join(STUDY_DIR, f"{label}_marks_{os.path.basename(src)}")
            with open(out, "w") as f:
                f.write(text)
            return out, stages
    raise SystemExit(f"extract_study: no marks set fits {src}")


def build_all(marks: bool, store: bool = False) -> dict:
    """{(tree, which[, "marks"]): (.so, ptxas' report)}: each tree's two
    sources (with ``marks`` their marks copies, with ``store`` the change's
    detection in the store design) built with the port's flags and
    -Xptxas -v, one nvcc a build, all at once."""
    from multicol_slam_tpu_torch.kernels import extract as ek
    from multicol_slam_tpu_torch.kernels import hamming_nn

    jobs = {}
    for label in ("parent", "change"):
        for which, rel in SOURCES.items():
            src = os.path.join(tree_of(label), rel)
            jobs[(label, which)] = src
            if marks:
                jobs[(label, which, "marks")] = write_marks(src, label)[0]
    if store:
        jobs[("store", "detect")] = write_store_design(os.path.join(ROOT, SOURCES["detect"]))
    built = {}

    def make(key, src):
        so = os.path.join(STUDY_DIR, "lib" + "_".join(key) + ".so")
        proc = subprocess.run([hamming_nn._nvcc(), *hamming_nn.NVCC_FLAGS, *ek.NVCC_EXTRA,
                               "-Xptxas", "-v", "-o", so, src], capture_output=True, text=True)
        if proc.returncode == 0:
            built[key] = (so, proc.stdout + proc.stderr)
        else:
            print(f"nvcc failed on {key}:\n{proc.stdout}{proc.stderr}", file=sys.stderr)
    os.makedirs(STUDY_DIR, exist_ok=True)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=make, args=(k, s)) for k, s in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if set(built) != set(jobs):
        raise SystemExit("extract_study: a build failed")
    print(f"built {len(built)} libraries in {time.perf_counter() - t0:.3f} s, one nvcc a build")
    return built


SASS_CLASSES = {
    "min/max": ("FMNMX", "IMNMX"), "float add/mul": ("FADD", "FMUL", "FFMA"),
    "float compare/select": ("FSETP", "FSEL", "FSET"), "shared load": ("LDS",),
    "global load": ("LDG", "LD"), "shuffle/vote": ("SHFL", "VOTE", "POPC", "FLO", "BREV"),
    "integer": ("IMAD", "IADD3", "LEA", "ISETP", "LOP3", "SHF", "SEL", "IABS", "I2F", "F2I",
                "MUFU", "PRMT", "SGXT", "BMSK"), "branch/barrier": ("BRA", "BAR", "BSSY",
                                                                    "BSYNC", "WARPSYNC"),
}


def sass_class(op: str) -> str:
    base = op.split(".")[0]
    for name, ops in SASS_CLASSES.items():
        if base in ops:
            return name
    return "other"


def sass_report(so: str) -> dict:
    """{kernel: dict(instructions, int_divisions, loops)} from
    cuobjdump -sass: a loop is a backward branch, its body the
    instructions from the target to the branch, by class."""
    from eig_study import demangle
    from multicol_slam_tpu_torch.kernels import hamming_nn

    cuobjdump = os.path.join(os.path.dirname(hamming_nn._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    out, cur, ins = {}, None, []

    def close():
        if cur is None:
            return
        loops = []
        for addr, op, target in ins:
            if op.startswith("BRA") and target is not None and target < addr:
                body = [o for a, o, _ in ins if target <= a <= addr]
                classes = {}
                for o in body:
                    classes[sass_class(o)] = classes.get(sass_class(o), 0) + 1
                loops.append(dict(start=hex(target), end=hex(addr), instructions=len(body),
                                  by_class=classes))
        out[cur] = dict(instructions=len(ins),
                        int_divisions=sum(1 for _, o, _ in ins if o.startswith("I2F.U32.RP")
                                          or o.startswith("I2F.RP")),
                        loops=[lp for lp in loops if lp["instructions"] >= 16])
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            cur, ins = demangle(m.group(1)), []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*);", line)
        if m and cur is not None:
            tgt = re.search(r"0x([0-9a-f]+)", m.group(3)) if m.group(2).startswith("BRA") else None
            ins.append((int(m.group(1), 16), m.group(2), int(tgt.group(1), 16) if tgt else None))
    close()
    return out


def marks_run(built: dict, name: str) -> dict:
    """Each tree's marks build run once on the default configuration's
    recorded frame (after one unmarked launch): CTAs and SM cycles a CTA by
    stage, from thread 0's clock."""
    import torch

    rec = torch.load(INPUTS, weights_only=False)
    images = rec["frames"][1].to("cuda")
    cfg, masks, hw, ex = extractors(torch.device("cuda", 0))["default"]
    (levels, mk, buckets, kw), (pyr, yx, lvl, pattern) = kernel_inputs(ex, cfg, masks, hw,
                                                                        images)
    out = {}
    for label in ("parent", "change"):
        for which, stem in (("detect", "fast_detect"), ("describe", "orb_describe")):
            lib = bind(ctypes.CDLL(built[(label, which, "marks")][0]), which)
            lib.extract_marks_read.argtypes = [ctypes.c_void_p]
            if getattr(lib, f"{stem}_init")() != 0:
                raise SystemExit(f"extract_study: {stem}_init of the {label} marks build failed")
            _, stages = write_marks(os.path.join(tree_of(label), SOURCES[which]), label)
            run = (lambda: launch_detect(lib, levels, mk, buckets, **kw)) \
                if which == "detect" else (lambda: launch_describe(lib, pyr, yx, lvl, pattern))
            run()
            torch.cuda.synchronize()
            lib.extract_marks_reset()
            run()
            torch.cuda.synchronize()
            rec = (ctypes.c_ulonglong * MARK_SLOTS)()
            if lib.extract_marks_read(rec) != 0:
                raise SystemExit("extract_study: extract_marks_read failed")
            ctas = {"cells": rec[28], "tiles": rec[29], "keypoints": rec[19],
                    "skipped tiles": rec[31]}
            per = {}
            for slot, stage in stages.items():
                n = (ctas["cells"] if slot < 8 else ctas["tiles"] if slot < 19
                     else ctas["keypoints"])
                per[stage] = dict(cycles=int(rec[slot]), per_cta=round(rec[slot] / max(n, 1), 1))
            out[f"{label} {which}"] = dict(ctas={k: int(v) for k, v in ctas.items() if v},
                                           stages=per)
            print(f"marks {label} {which}: CTAs {out[f'{label} {which}']['ctas']}; SM cycles by "
                  f"stage (all CTAs; a CTA) {per} ({name})")
    return out


# The trigonometry the descriptor calls, one kernel a function and one
# with cosf and sinf of one value, built as the kernels are: ptxas' stack
# frame of each says which keeps a frame in local memory (--trig).
TRIG_PROBE = r"""
#include <math.h>
extern "C" __global__ void probe_cosf(const float* a, float* o) { o[threadIdx.x] = cosf(a[threadIdx.x]); }
extern "C" __global__ void probe_sinf(const float* a, float* o) { o[threadIdx.x] = sinf(a[threadIdx.x]); }
extern "C" __global__ void probe_cosf_sinf(const float* a, float* o) {
  o[threadIdx.x] = cosf(a[threadIdx.x]) + sinf(a[threadIdx.x]);
}
extern "C" __global__ void probe_atan2f(const float* a, float* o) {
  o[threadIdx.x] = atan2f(a[threadIdx.x], a[threadIdx.x + 1]);
}
"""


def trig_probe() -> dict:
    """ptxas' report (registers, stack) for cosf, sinf and atan2f alone and
    for cosf and sinf of one value, and the PTX (printed)."""
    from eig_study import ptxas_table
    from multicol_slam_tpu_torch.kernels import extract as ek
    from multicol_slam_tpu_torch.kernels import hamming_nn

    os.makedirs(STUDY_DIR, exist_ok=True)
    src = os.path.join(STUDY_DIR, "trig_probe.cu")
    with open(src, "w") as f:
        f.write(TRIG_PROBE)
    flags = [f for f in hamming_nn.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([hamming_nn._nvcc(), *flags, *ek.NVCC_EXTRA, "-Xptxas", "-v", "-c",
                           "-o", src + ".o", src], capture_output=True, text=True, check=True)
    table = ptxas_table(proc.stdout + proc.stderr)
    ptx = subprocess.run([hamming_nn._nvcc(), "-arch=sm_90a", *ek.NVCC_EXTRA, "-O3", "-ptx",
                          "-o", "-", src], capture_output=True, text=True, check=True).stdout
    print(f"trig probe: {table}")
    print(ptx)
    return table


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--write-parent", metavar="REV",
                   help="unpack the parent tree at git revision REV, and stop")
    p.add_argument("--turns", action="store_true")
    p.add_argument("--sass", action="store_true")
    p.add_argument("--marks", action="store_true")
    p.add_argument("--designs", action="store_true",
                   help="time the change's detection against the store design (STORE_PATCH)")
    p.add_argument("--trig", action="store_true",
                   help="ptxas' stack frames of cosf, sinf and atan2f alone, and their PTX")
    p.add_argument("--worker", nargs=2, metavar=("TREE", "OUT"), help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.write_parent:
        return write_parent(a.write_parent)
    if a.worker:
        return worker(*a.worker)
    if not (a.turns or a.sass or a.marks or a.trig or a.designs):
        p.error("give --write-parent, --turns, --sass, --marks, --designs or --trig")

    import torch

    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    if not torch.cuda.is_available():
        raise SystemExit("extract_study: no CUDA device")
    torch.cuda.set_device(torch.device("cuda", 0))
    name = card()
    print(name)
    report = {"card": name, "device": torch.cuda.get_device_name(0)}
    if a.trig:
        report["trig"] = trig_probe()
    if a.turns:
        report["turns"] = turns()
    if a.sass or a.marks or a.designs:
        if not os.path.isdir(PARENT_TREE):
            raise SystemExit(f"extract_study: no parent tree at {PARENT_TREE}")
        from eig_study import ptxas_table

        built = build_all(a.marks, a.designs)
        for key, (so, text) in built.items():
            for kern, props in ptxas_table(text).items():
                print(f"ptxas {'/'.join(key)}: {kern}: {props}")
        if a.sass:
            report["sass"] = {}
            for key, (so, _) in built.items():
                if len(key) == 2:
                    rep = sass_report(so)
                    report["sass"]["/".join(key)] = rep
                    for kern, r in rep.items():
                        print(f"sass {'/'.join(key)}: {kern}: {r}")
        if a.marks:
            if not os.path.exists(INPUTS):
                record()
            report["marks"] = marks_run(built, name)
        if a.designs:
            report["designs"] = designs(built, name)
    print(name)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
