#!/usr/bin/env python3
"""Which of the RANSAC and bootstrap solvers' operations a CUDA graph can
capture on this card's PyTorch: each is run once on a side stream (the
warm-up a capture needs), then captured with ``torch.cuda.graph``, then
replayed and compared with an eager call on the same inputs.

Probed, at the shapes the tracker gives them: ``torch.linalg.eigh``
(1024 x 4x4 as Horn's alignment in GP3P, 3 x 9x9 as the 8-point refit),
``torch.linalg.svd`` (3x3, one and batched), ``torch.linalg.det`` (3x3),
``cholesky_ex`` with ``cholesky_solve`` and ``solve_ex`` (the Newton and
DLT steps), a 0-d integer tensor as an index (``x[argmax]``), and
``torch.randint`` / ``torch.multinomial`` drawing from a CUDA
``torch.Generator`` other than the default, registered with the graph
(``CUDAGraph.register_generator_state``) and not registered. For the
generators it also checks that a replay draws what an eager call draws
from the same state and leaves the generator where the eager call does.
Last, a launch of a thread-block cluster (``tools/empty_kernel.cu``'s
``cluster_probe_kernel``: as many blocks as a pose LM launch, each
reading its neighbour's shared memory after a cluster barrier).

    python3 tools/capture_probe.py            # on the card

Prints one line per probe, the card's name and power limit before the
last line, and as the last line one JSON object, probe -> verdict.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, ROOT)


def card() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()


def capture(fn, gens=()):
    """(graph, its outputs) after one warm-up of fn on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    for gen in gens:
        g.register_generator_state(gen)
    with torch.cuda.graph(g):
        out = fn()
    return g, out


def probe(name, fn, gens=(), check=None):
    """Capture fn, replay it once, compare with an eager call (``check``
    sets the generator state up and compares for the generator probes)."""
    try:
        g, out = capture(fn, gens)
    except Exception as e:   # the probe records what refuses capture
        torch.cuda.synchronize()
        verdict = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
        print(f"{name}: {verdict}")
        return verdict
    if check is not None:
        verdict = check(g, out)
    else:
        g.replay()
        torch.cuda.synchronize()
        want = fn()
        outs = out if isinstance(out, (tuple, list)) else (out,)
        wants = want if isinstance(want, (tuple, list)) else (want,)
        same = all(torch.equal(a, b) for a, b in zip(outs, wants))
        verdict = "captures, replay == eager" if same else "captures, replay != eager"
    print(f"{name}: {verdict}")
    return verdict


def main() -> None:
    if not torch.cuda.is_available():
        print("capture_probe: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = card()
    print(name)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"register_generator_state: "
          f"{hasattr(torch.cuda.CUDAGraph, 'register_generator_state')}")
    g0 = torch.Generator(device="cpu").manual_seed(0)
    rnd = lambda *s, dt=torch.float32: torch.randn(*s, generator=g0, dtype=dt).to(dev)
    sym = lambda b, n, dt=torch.float32: (lambda a: a @ a.transpose(-1, -2))(rnd(b, n, n, dt=dt))
    A4, A9, A9d = sym(1024, 4), sym(3, 9), sym(3, 9, torch.float64)
    M3, B3 = rnd(3, 3), rnd(256, 3, 3)
    spd = sym(1024, 3) + 3 * torch.eye(3, device=dev)
    rhs = rnd(1024, 3, 1)
    A12, b12 = sym(1, 12)[0] + torch.eye(12, device=dev), rnd(12)
    scores = rnd(256)
    rows = rnd(256, 5)
    res = {}
    res["eigh 1024x4x4 f32"] = probe("eigh 1024x4x4 f32", lambda: torch.linalg.eigh(A4))
    res["eigh 3x9x9 f32"] = probe("eigh 3x9x9 f32", lambda: torch.linalg.eigh(A9))
    res["eigh 3x9x9 f64"] = probe("eigh 3x9x9 f64", lambda: torch.linalg.eigh(A9d))
    res["eigh 9x9 f32"] = probe("eigh 9x9 f32", lambda: torch.linalg.eigh(A9[0]))
    res["svd 3x3 f32"] = probe("svd 3x3 f32", lambda: torch.linalg.svd(M3))
    res["svd 256x3x3 f32"] = probe("svd 256x3x3 f32", lambda: torch.linalg.svd(B3))
    res["det 3x3 f32"] = probe("det 3x3 f32", lambda: torch.linalg.det(M3))
    res["cholesky_ex + cholesky_solve 1024x3x3"] = probe(
        "cholesky_ex + cholesky_solve 1024x3x3",
        lambda: torch.cholesky_solve(rhs, torch.linalg.cholesky_ex(spd)[0]))
    res["solve_ex 12x12"] = probe("solve_ex 12x12", lambda: torch.linalg.solve_ex(A12, b12)[0])
    res["index by 0-d argmax"] = probe("index by 0-d argmax",
                                       lambda: rows[torch.argmax(scores)])
    res["index_select by argmax"] = probe(
        "index_select by argmax",
        lambda: rows.index_select(0, torch.argmax(scores).reshape(1))[0])

    weights = (torch.rand(2400, generator=g0) > 0.5).float().to(dev) + 1e-12
    for registered in (True, False):
        gen = torch.Generator(device=dev).manual_seed(42)
        draw = lambda: (torch.randint(0, 2400, (256, 5), generator=gen, device=dev),
                        torch.multinomial(weights, 256 * 3, replacement=True, generator=gen))

        def check(g, out, gen=gen, draw=draw):
            before = gen.get_state()
            g.replay()
            torch.cuda.synchronize()
            got = [t.clone() for t in out]
            after_replay = gen.get_state()
            gen.set_state(before)
            want = draw()
            torch.cuda.synchronize()
            after_eager = gen.get_state()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            state = torch.equal(after_replay, after_eager)
            moved = not torch.equal(before, after_replay)
            return (f"captures; replay draws == eager {same}; generator after replay == "
                    f"after eager {state}; replay advanced it {moved}")

        tag = "registered" if registered else "not registered"
        res[f"randint + multinomial, generator {tag}"] = probe(
            f"randint + multinomial, generator {tag}", draw,
            gens=(gen,) if registered else (), check=check)
    res["cluster launch"] = probe_cluster(dev)
    print(name)
    print(json.dumps(res))


def probe_cluster(dev) -> str:
    """Capture one launch of the cluster probe kernel, one cluster of as
    many blocks as a pose LM launch; its replay must write what an eager
    launch writes: block b, rank b + 1 mod the cluster size."""
    from multicol_slam_tpu_torch.kernels import hamming_nn, pose_lm

    lib = ctypes.CDLL(hamming_nn.build(os.path.join(ROOT, "tools", "empty_kernel.cu"),
                                       "libempty"))
    lib.cluster_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.cluster_probe_launch.restype = ctypes.c_int
    lib.empty_init.restype = ctypes.c_int
    n = pose_lm.kernel_attributes(torch.float32, dev)["cluster"]
    if lib.empty_init() != 0:
        return "refused: empty_init failed"
    want = (torch.arange(n, dtype=torch.int32, device=dev) + 1) % n

    def launch():
        out = torch.full((n,), -1, dtype=torch.int32, device=dev)
        err = lib.cluster_probe_launch(out.data_ptr(), n,
                                       torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"cluster launch failed: cudaError {err}")
        return out

    def check(g, out):
        out.fill_(-1)
        g.replay()
        torch.cuda.synchronize()
        eager = launch()
        torch.cuda.synchronize()
        return (f"captures; {n} blocks; replay == eager {torch.equal(out, eager)}; "
                f"each block read its neighbour's rank {torch.equal(out, want)}")

    return probe(f"cluster launch ({n} blocks, distributed shared memory)", launch,
                 check=check)


if __name__ == "__main__":
    main()
