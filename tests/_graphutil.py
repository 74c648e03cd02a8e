"""Helpers of the CUDA-graph tests (``tests/test_torch_graphs.py``,
``tests/test_torch_mapping_graphs.py``): the host-read audit and a capture
stand-in for the CPU. No JAX."""

import os
import traceback
from collections import Counter

import torch
from torch.overrides import TorchFunctionMode

from multicol_slam_tpu_torch.utils import graphs

PKG = os.path.join("multicol_slam_tpu_torch", "")
KERNELS = os.path.join("multicol_slam_tpu_torch", "kernels", "")

# Host reads the captured steps may make, as (file, function): each reads
# no tensor derived from an input, so it is the same at every replay.
ALLOWED = {
    # log(scale_factor) of a float32 CPU scalar made from a Python float,
    # taken on the host (no device copy)
    ("models/tracking.py", "frustum_check"),
}
# Calls that read a tensor on the host, or whose output shape depends on
# a tensor's values, or that make a tensor from host data.
HOST_READS = {"item", "tolist", "__bool__", "__int__", "__float__", "__index__",
              "numpy", "cpu", "nonzero", "argwhere", "masked_select", "unique",
              "unique_consecutive", "tensor", "as_tensor"}


class HostReads(TorchFunctionMode):
    """Records (file, function, call) of every host read made inside the
    port's package, the kernels' wrappers excepted: on the card their
    CUDA path launches the kernel without a read (their CPU path runs the
    plain version, which the card never runs)."""

    def __init__(self):
        super().__init__()
        self.reads = Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        read = name in HOST_READS
        if name == "to":
            read = any(str(a) == "cpu" for a in list(args[1:]) + list(kwargs.values()))
        if name in ("__getitem__", "__setitem__") and len(args) > 1:
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            read = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in idx)
        if name == "repeat_interleave" and len(args) > 1:
            read = isinstance(args[1], torch.Tensor)
        if read:
            self._record(name)
        return func(*args, **kwargs)

    def _record(self, name):
        stack = traceback.extract_stack()[:-2]
        if any(KERNELS in f.filename for f in stack):
            return
        for f in reversed(stack):      # the innermost named function
            if PKG in f.filename and not f.name.startswith("<"):
                rel = f.filename.split(PKG, 1)[1]
                self.reads[(rel, f.name, name)] += 1
                return


class StandIn:
    """A capture stand-in for the CPU tests. "warm-up" runs the function
    on the call's inputs; "capture" runs it once on the static buffers
    and keeps its outputs, the registered generators' states restored
    after it; "replay" runs it again on the buffers and
    writes the results into those outputs, as a graph's replay overwrites
    its static outputs. While it replays, a launch report goes nowhere: a
    replay runs no Python, and the graph repeats the reports recorded at
    its capture."""

    def __init__(self, monkeypatch):
        self.warm_ups = 0
        self.captures = 0
        self.replays = 0
        monkeypatch.setattr(graphs, "_warm_up", self.warm_up)
        monkeypatch.setattr(graphs, "_capture", self.capture)

    def warm_up(self, run, device, pool):
        self.warm_ups += 1
        return run()

    def capture(self, run, device, pool, *, generators=()):
        # a capture draws nothing: the generators stay where the warm-up
        # left them, and each replay draws from their state then
        states = [g.get_state() for g in generators]
        outs = run()
        for g, st in zip(generators, states):
            g.set_state(st)
        self.captures += 1

        def replay():
            self.replays += 1
            saved = getattr(graphs._local, "hooks", None)
            graphs._local.hooks = []
            try:
                new = run()
            finally:
                graphs._local.hooks = saved
            for o, n in zip(outs, new):
                o.copy_(n)
        return replay, outs
