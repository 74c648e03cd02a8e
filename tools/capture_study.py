#!/usr/bin/env python3
"""Where the async mapper's slowest pass goes, with and without each of
its two repairs: the port's bench stage ``full_system`` (90 frames of
``bench_trajectory(90, radius=0.8)``, async mapping, on the card), one
configuration a process, in turns:

- ``parent``: every key's first call of a graphed function warms up (the
  eager run before its capture) and the bootstrap captures nothing ahead
  (``graphs.jit`` and ``MultiColSLAM`` as they were before the repair);
- ``no_ahead``: a later key captures with no warm-up, nothing ahead;
- ``repaired``: as the port runs, the local BA's next buckets captured
  after the bootstrap passes too (``LocalMapper.capture_ahead``).

Per run: keyframes taken and refused, the slowest pass after the first
split into warm-up, capture, capture wait, interpreter lock and the rest
(``bench.pass_split``), that pass's voluntary and involuntary context
switches on its thread (``getrusage(RUSAGE_THREAD)``), the card's idle
share over the run (``bench.Utilization``), ATE, and the captures the
run made (function, thread, warm-up, seconds, the BA's key).

    python3 tools/capture_study.py                        # on the card
    python3 tools/capture_study.py --order parent repaired

The last line is one JSON object, a list of runs.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

MODES = ("parent", "no_ahead", "repaired")


def run(mode: str) -> dict:
    import torch

    from multicol_slam_tpu_torch import bench
    from multicol_slam_tpu_torch.kernels import hamming_nn as knn
    from multicol_slam_tpu_torch.models import local_mapping
    from multicol_slam_tpu_torch.utils import graphs

    if mode not in MODES:
        raise SystemExit(f"capture_study: unknown mode {mode!r}, want one of {MODES}")
    if mode == "parent":
        first_call = graphs.jit._first_call

        def warm_every_key(self, key, spec, leaves):
            self._warmed.clear()
            return first_call(self, key, spec, leaves)
        graphs.jit._first_call = warm_every_key
    if mode in ("parent", "no_ahead"):
        local_mapping.LocalMapper.capture_ahead = lambda self: None

    switches = []
    process = local_mapping.LocalMapper.process_keyframe

    def counted(self, kf):
        r0 = resource.getrusage(resource.RUSAGE_THREAD)
        try:
            return process(self, kf)
        finally:
            r1 = resource.getrusage(resource.RUSAGE_THREAD)
            switches.append((threading.current_thread().name, r1.ru_nvcsw - r0.ru_nvcsw,
                             r1.ru_nivcsw - r0.ru_nivcsw))
    local_mapping.LocalMapper.process_keyframe = counted

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    knn.load_library()
    out = bench.full_system(dev, 90)
    split = out["slowest_pass_split_ms"]
    return dict(mode=mode, card=bench.card_line(), n_keyframes=out["n_keyframes"],
                keyframes_refused=out["keyframes_refused"], ate_m=out["ate_m"],
                mapping_ms=out["mapping_ms"], slowest_pass_split_ms=split,
                slowest_pass_switches=(switches[split["pass_index"]][1:] if split else None),
                device_idle_share=out["device_idle_share"],
                captures=[{k: c.get(k) for k in ("fn", "thread", "warm_up", "seconds", "ba_key")}
                          for c in out["captures"]])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--order", nargs="+", default=["parent", "no_ahead", "repaired", "repaired",
                                                   "no_ahead", "parent"], choices=MODES)
    ap.add_argument("--one", choices=MODES, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(run(args.one)))
        return
    runs = []
    for mode in args.order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", mode],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"capture_study: the {mode} run failed:\n{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        r = runs[-1]
        print(f"{mode}: {r['n_keyframes']} keyframes, {r['keyframes_refused']} refused, "
              f"slowest pass split (ms) {r['slowest_pass_split_ms']}, switches (voluntary, "
              f"involuntary) {r['slowest_pass_switches']}, idle {r['device_idle_share']}, "
              f"ATE {r['ate_m']} ({r['card']})", flush=True)
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
