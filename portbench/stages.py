#!/usr/bin/env python3
"""Where a mapping pass's time goes, by the program's own spans: one traced
run of a cell, as ``run.py --trace 1`` makes it, printed as its result
line's object with one more key, ``stages``.

    python3 portbench/stages.py --workload orb3.laps_batch --seed 7

``stages`` holds, for every span of the local mapping and the loop closer
in the slice, its count, its mean ms a pass (its summed time over the
``local_mapping.pass`` spans), its mean ms and the share of its time in
which the card ran nothing; the share of the passes' time that no child
span covers, in all and in the worst pass; and the alignment's offset and
largest residual (``program_spans.alignment``).
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

from portbench import program_spans, run, spec, trace  # noqa: E402

LAYERS = ("local_mapping.", "loop_closing.")


def table(recs, tr) -> dict:
    passes = [i for i, r in enumerate(recs) if r.name == program_spans.PASS]
    dur = lambda r: (r.end_ns - r.start_ns) * 1e-6
    out = {}
    for name in sorted({r.name for r in recs if r.name.startswith(LAYERS)}):
        ms = [dur(r) for r in recs if r.name == name]
        out[name] = {"n": len(ms), "ms_a_pass": sum(ms) / max(len(passes), 1),
                     "mean_ms": sum(ms) / len(ms),
                     "idle_pct": program_spans.idle_pct(recs, tr, name)}
    covered = {i: 0.0 for i in passes}
    for r in recs:
        if r.parent in covered:
            covered[r.parent] += dur(r)
    aligned = program_spans.alignment(recs, tr)
    return {"spans": out,
            "uncovered_pct": (100.0 * (1 - sum(covered.values()) / sum(dur(recs[i]) for i in passes))
                              if passes else None),
            "worst_uncovered_pct": (max(100.0 * (1 - covered[i] / dur(recs[i])) for i in passes)
                                    if passes else None),
            "offset_s": aligned and aligned[0],
            "residual_ms": aligned and aligned[1] * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One traced run of a cell, by the program's spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("portbench: stages needs a CUDA card", file=sys.stderr)
        return 2
    kept = []
    of = trace.Trace.of
    trace.Trace.of = staticmethod(lambda prof: kept.append(of(prof)) or kept[-1])
    bench = spec.Benchmark(ROOT)
    result = run.run_cell(bench, bench.cell(args.workload), args.seed, args.seconds, True,
                          torch.device("cuda:0"))
    result["stages"] = table(program_spans.records() or [], kept[-1])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
