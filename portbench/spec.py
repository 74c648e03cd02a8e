"""``BENCHMARK.json`` and the files it names, found by name.

- a cell: an entry of ``workloads``;
- a configuration: ``configs/<name>/config.json`` (its ``file``), with the
  settings YAML and the rig's calibration files beside it;
- a traffic mix: ``traffic/<name>.json``, whose ``kind`` names its
  generator, ``traffic/<kind>.py``;
- a per-layer metric: its reader, ``metrics/<name>.py``, or where that
  is missing the reader of the name before its first dot (``mapping_ms``
  reads ``mapping_ms.batch`` and ``mapping_ms.live``);
- a cell's limits for ``correct``: ``limits/<cell>.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Config:
    name: str
    dir: str
    settings_path: str
    system: dict
    raw: dict


class Benchmark:
    def __init__(self, root: str):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.raw = json.load(f)
        self.root = root

    def cell(self, name: str) -> dict:
        for w in self.raw["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"portbench: no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Config:
        entry = next((c for c in self.raw["configs"] if c["name"] == name), None)
        if entry is None:
            raise SystemExit(f"portbench: no configuration named {name!r}")
        return load_config(name, os.path.join(self.root, entry["file"]))

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones: those without ``workloads`` and those that list it."""
        group = self.raw["per_layer" if trace else "end_to_end"]
        return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def load_config(name: str, path: str) -> Config:
    """A configuration's ``config.json`` and the files beside it."""
    with open(path) as f:
        raw = json.load(f)
    d = os.path.dirname(path)
    return Config(name=name, dir=d, settings_path=os.path.join(d, raw["settings"]),
                  system=dict(raw.get("system", {})), raw=raw)


def traffic(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def generator(kind: str):
    return importlib.import_module(f"portbench.traffic.{kind}")


def limits(cell: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        return json.load(f)


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py`` (a name may hold dots),
    or of ``metrics/<the name before its first dot>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    if not os.path.isfile(path):
        path = os.path.join(HERE, "metrics", f"{metric.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
