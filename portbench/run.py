#!/usr/bin/env python3
"""The port's benchmark: one cell of ``BENCHMARK.json``, run once.

    python3 portbench/run.py --workload orb3.laps_batch --seed 7 --seconds 20 --trace 0

From the root of a checkout, on a machine with a CUDA card. The cell
names a configuration (``configs/<name>/``) and a traffic mix
(``traffic/<mix>.json``, made by ``traffic/<kind>.py`` from its
parameters and ``--seed``). Set-up renders the mix's frames on the card,
builds ``multicol_slam_tpu_torch``'s ``MultiColSLAM`` at the
configuration and feeds it the set-up frames (the bootstrap and the
mix's set-up laps, which capture the graphs the window replays). The
window then feeds the stream on, a call at a time in a closed loop,
for ``--seconds`` seconds; with ``--trace 1`` it feeds one profiled
slice (the mix's ``trace_laps`` laps) instead and reports the per-layer
metrics.

After the window the run decides ``correct`` against the cell's limits
(``limits/<cell>.json``): the window's poses against the route that made
the frames, the map's landmarks against the room's walls, and the
features of keyframes drawn from the seed against the plain extraction
chain (``reference/``), run once the program's state is freed. Its last
lines on standard error are each number beside its limit; its last line
on standard output is one JSON object, whose last key, ``checks``,
repeats them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "multicol_slam_tpu")
KEYFRAMES_CHECKED = 4     # window keyframes whose features are held to the reference


def forbidden_modules(names) -> list:
    """The forbidden packages among module names, by whole top-level name."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def percentile(xs, q: float) -> float:
    """numpy's linear percentile of every value in xs."""
    import numpy as np
    return float(np.percentile(np.asarray(xs, np.float64), q))


class Window:
    """The calls of one window: stream frame, frames, host start and end,
    poses."""

    def __init__(self, system, traffic, g0: int):
        self.system, self.traffic, self.g0, self.g = system, traffic, g0, g0
        self.calls = []
        self.t0 = self.t1 = None

    def run(self, frames: int = None, seconds: float = None):
        """Feed calls of ``frames_per_call`` frames until ``frames`` frames
        (the last call cut to fit) or until ``seconds`` have passed when a
        call returns."""
        tr = self.traffic

        def size():
            left = None if frames is None else frames - (self.g - self.g0)
            return tr.per_call if left is None else min(tr.per_call, left)

        images, ts = tr.call(self.g, size())
        sync(self.system.device)
        self.t0 = time.perf_counter()
        while True:
            n = len(ts)
            a = time.perf_counter()
            poses = self.system.feed(tr.api, images, ts, tr.chunk)
            b = time.perf_counter()
            self.calls.append((self.g, n, a, b, poses))
            self.g += n
            if (frames is not None and self.g - self.g0 >= frames) or (
                    seconds is not None and b - self.t0 >= seconds):
                break
            images, ts = tr.call(self.g, size())
        self.t1 = time.perf_counter()

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def frames(self):
        """(stream frame, pose or None) of every frame handed over."""
        return [(g + i, p) for g, n, _, _, poses in self.calls for i, p in enumerate(poses)]

    def frame_ms(self) -> list:
        """Host ms from handing each frame over to its pose, the card
        synchronised: a call's time, for calls of one frame."""
        return [(b - a) * 1e3 for _, n, a, b, _ in self.calls if n == 1]


def end_to_end(window, setup_s: float) -> dict:
    """``fps``: the frames whose pose came back over the whole window;
    ``frame_ms_p95``: the 95th percentile of every frame's host ms, where
    the window hands frames over one at a time; ``setup_s``."""
    ok = sum(p is not None for _, p in window.frames())
    out = {"fps": ok / window.seconds, "setup_s": setup_s}
    frame_ms = window.frame_ms()
    if frame_ms:
        out["frame_ms_p95"] = percentile(frame_ms, 95)
    return out


class Context:
    """What a per-layer metric's reader reads: the program's counters
    before and after the window, the trace, and the least work of the
    extraction kernels over the slice."""

    def __init__(self, before, after, trace, window_s, busy_s, least):
        self.before, self.after, self.trace = before, after, trace
        self.window_s, self.busy_s, self._least, self._cache = window_s, busy_s, least, {}

    def added(self, key, sub=None):
        a, b = self.after[key], self.before[key]
        if sub is not None:
            a, b = a.get(sub, []), b.get(sub, [])
        return a[len(b):]

    def least_seconds(self, kind: str) -> float:
        if kind not in self._cache:
            self._cache[kind] = self._least(kind)
        return self._cache[kind]


def judge(limits: dict, values: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when every one is within."""
    checks = {}
    for name, lim in limits.items():
        v = values.get(name)
        checks[name] = {"value": v, "limit": lim["max"]}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def check_outputs(frames, traffic, points, keyframes, plain, seed, features=None) -> dict:
    """The numbers ``correct`` compares (reference/: plain NumPy and
    PyTorch) for the window's (stream frame, pose or None) ``frames``:
    frames without a pose; the worst position (cm) and rotation (degrees)
    error of the poses after their Sim3 alignment to the route; the median
    distance (cm) of the map's landmarks, so aligned, to the room's walls;
    the entries of sampled window keyframes' features (or of ``features``
    (frame) -> Features put in the program's place) that differ from the
    plain chain's."""
    import numpy as np
    import torch

    from portbench import world
    from portbench.reference import extract as ref_extract
    from portbench.reference import trajectory

    got = [(g, p) for g, p in frames if p is not None]
    values = {"lost_frames": len(frames) - len(got)}
    if len(got) >= 3:
        est = np.stack([np.asarray(p, np.float64) for _, p in got])
        gt = traffic.pose(np.array([g for g, _ in got]))
        err = trajectory.pose_errors(est, gt)
        values["pose_err_max_cm"] = float(err["pos_m"].max() * 100)
        values["rot_err_max_deg"] = float(err["rot_deg"].max())
        if len(points):
            X = (err["scale"] * (err["R"] @ points.T)).T + err["t"]
            d = world.surface_distance(X)
            values["landmark_median_cm"] = float(np.median(d) * 100)
    rng = np.random.default_rng([int(seed), 1])
    pick = rng.choice(len(keyframes), min(KEYFRAMES_CHECKED, len(keyframes)), replace=False) \
        if keyframes else []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        detail = {}
        for i in sorted(pick):
            g, feats = keyframes[i]
            if features is not None:
                feats = features(g)
            want = plain(traffic.frames[int(traffic.index(g))])
            detail[int(g)] = ref_extract.mismatches(feats, want)
        values["extract_mismatch"] = (sum(sum(d.values()) for d in detail.values())
                                      if detail else None)
        values["keyframes_checked"] = detail
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return values


def extraction_work(traffic, plain, cfg, masks, window, calls):
    """least(kind): the least seconds of detection or the descriptor over
    the slice: the mean over the slice's distinct frames of each frame's
    bound, times the extraction calls the slice made (every frame a chunk
    scanned, and every frame tracked on its own)."""
    import numpy as np

    from portbench.reference import work

    idx = sorted(set(int(i) for i in traffic.index(np.array([g for g, _ in window.frames()]))))

    def least(kind):
        total = 0.0
        for i in idx:
            images = traffic.frames[i]
            if kind == "detect":
                total += work.least_seconds(*work.detect_frame(plain, cfg, masks, images))
            else:
                total += work.least_seconds(*work.describe_frame(plain, cfg, plain(images)))
        return total / len(idx) * calls

    return least


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Run:
    """One run of a cell up to its outputs: set-up, the window (or the
    traced slice), the program's counters, outputs and peak memory, then
    the program's state freed and the reference's plain extractor built."""

    def __init__(self, bench, cell: dict, seed: int, seconds: float, traced: bool, dev):
        import torch

        from portbench import driver, spec, trace, world
        from portbench.reference import extract as ref_extract

        self.cell, self.seed, self.dev = cell, seed, dev
        cuda = dev.type == "cuda"
        self.config = config = bench.config(cell["config"])
        mix = spec.traffic(cell["traffic"])
        self.rig = rig = world.Rig(config.dir, dev)
        self.traffic = traffic = spec.generator(mix["kind"]).make(mix, seed, rig)
        system = driver.System(config, dev)

        # set-up: the bootstrap and the set-up laps, the graphs captured
        setup = Window(system, traffic, 0)
        setup.run(frames=traffic.setup_frames)
        sync(dev)
        self.setup_s = time.perf_counter() - T_START
        self.setup_failed = sum(p is None for _, p in setup.frames())

        self.before = system.counters()
        self.window = window = Window(system, traffic, setup.g)
        self.prof = None
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
            with trace.spans(system.span_targets()):
                with torch.profiler.profile(activities=acts) as self.prof:
                    with torch.profiler.record_function(trace.SPAN + "slice"):
                        window.run(frames=traffic.trace_frames)
                    sync(dev)
        else:
            window.run(seconds=seconds)
        self.after = system.counters()
        self.memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

        # the program's outputs, then its state freed
        self.points = system.map_points()
        self.keyframes = [(g, type(f)(*(t.clone() for t in f))) for g, f in system.keyframes
                          if window.g0 <= g < window.g]
        system.shutdown()
        del system
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        settings = world.load_opencv_yaml(config.settings_path)
        self.cfg = ref_extract.config_from_settings(settings)
        self.masks = ref_extract.extraction_masks(rig.cams, self.cfg)
        self.plain = ref_extract.make_plain_extractor(self.cfg, rig.cams, self.masks)

    def values(self, poses=None, points=None, features=None) -> dict:
        """The numbers ``correct`` compares, on this run's outputs or on
        those given in their place."""
        frames = self.window.frames() if poses is None else poses
        return check_outputs(frames, self.traffic, self.points if points is None else points,
                             self.keyframes, self.plain, self.seed, features=features)


def run_cell(bench, cell: dict, seed: int, seconds: float, traced: bool, dev) -> dict:
    """Set-up, the window (or the traced slice), the check; the result
    line's object. On a CPU ``dev`` (the tests) every step but the card's
    own readings runs the same."""
    import torch

    from portbench import spec, trace

    r = Run(bench, cell, seed, seconds, traced, dev)
    before, after, window = r.before, r.after, r.window
    values = r.values()
    correct, checks = judge(spec.limits(cell["name"]), values)
    frames = window.frames()
    ok = sum(p is not None for _, p in frames)
    result = {"correct": correct, "attempted": len(frames), "failed": len(frames) - ok}
    device = {}
    if traced:
        tr = trace.Trace.of(r.prof)
        t0, t1 = tr.span_interval("slice")
        busy = sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in tr.busy())
        calls = (sum(b for b, _, _ in after["chunk_scans"][len(before["chunk_scans"]):])
                 + sum(p != "chunk" for p in after["frame_path"][len(before["frame_path"]):]))
        masks = [torch.from_numpy(m > 0).to(dev) for m in r.masks]
        ctx = Context(before, after, tr, t1 - t0, busy,
                      extraction_work(r.traffic, r.plain, r.cfg, masks, window, calls))
        metrics = {}
        for m in bench.metrics(cell["name"], trace=True):
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = metrics
        device = {"busy_s": busy, "window_s": t1 - t0}
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps(t0, t1)}
    else:
        e2e = end_to_end(window, r.setup_s)
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in bench.metrics(cell["name"], trace=False)}
    cuda = dev.type == "cuda"
    result["device"] = dict({"platform": "gpu" if cuda else dev.type,
                             "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                             "count": 1, "memory_peak_bytes": r.memory_peak}, **device)
    result["setup_failed_frames"] = r.setup_failed
    result["counts"] = {
        "frames_by_path": dict(Counter(after["frame_path"][len(before["frame_path"]):])),
        "keyframes": after["keyframes"], "points": after["points"],
        "mapping_passes": len(after["mapping_ms"]) - len(before["mapping_ms"]),
        "late_captures": after["late_captures"][len(before["late_captures"]):]}
    result["keyframes_checked"] = values["keyframes_checked"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec
    bench = spec.Benchmark(ROOT)
    cell = bench.cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda:0"))
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the process loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
