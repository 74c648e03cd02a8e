"""Cells, configurations, traffic mixes and per-layer metrics are found by
name from files, and ``BENCHMARK.json`` keeps the contract's shape."""

import json
import os
import re

import pytest

from portbench import spec

ROOT = os.path.dirname(spec.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.Benchmark(ROOT)


def test_top_level_keys(bench):
    assert set(bench.raw) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert bench.raw["command"] == ["python3", "portbench/run.py"]
    assert bench.raw["paths"] == ["portbench"]
    assert 1 <= bench.raw["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys(bench):
    r = bench.raw
    for c in r["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in r["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in r["end_to_end"] + r["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in r["end_to_end"] + r["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in r["end_to_end"]}
    assert "setup_s" in e2e
    for m in r["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in r["per_layer"]:
        assert m["moves"] in e2e and m["layer"]


def test_every_cell_finds_its_files(bench):
    for w in bench.raw["workloads"]:
        cfg = bench.config(w["config"])
        assert os.path.isfile(cfg.settings_path)
        for f in cfg.raw["calibration"]:
            assert os.path.isfile(os.path.join(cfg.dir, f))
        mix = spec.traffic(w["traffic"])
        assert hasattr(spec.generator(mix["kind"]), "make")
        limits = spec.limits(w["name"])
        assert limits and all("max" in v for v in limits.values())


def test_every_per_layer_metric_has_a_reader(bench):
    for m in bench.raw["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_a_metric_moves_a_metric_its_cells_report(bench):
    """Each cell that reports a per-layer metric reports the end-to-end
    metric it moves."""
    for w in bench.raw["workloads"]:
        e2e = {m["name"] for m in bench.metrics(w["name"], trace=False)}
        assert {"setup_s"} < e2e
        for m in bench.metrics(w["name"], trace=True):
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_cells_in_order(bench):
    assert [w["name"] for w in bench.raw["workloads"]] == [
        "orb3.laps_batch", "mdbrief3.laps_batch", "orb3.laps_live"]


def test_a_new_cell_is_files_and_entries_alone(tmp_path, bench):
    """A configuration, a mix and a metric added as new files beside a new
    entry are found without an edit of the harness."""
    raw = json.loads(json.dumps(bench.raw))
    raw["workloads"].append(dict(raw["workloads"][0], name="orb3.other", traffic="laps_live"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(raw))
    other = spec.Benchmark(str(tmp_path))
    assert other.cell("orb3.other")["traffic"] == "laps_live"
    assert [m["name"] for m in other.metrics("orb3.other", trace=True)] == [
        "captures_in_window", "fast_detect_roofline", "orb_describe_roofline",
        "device_idle_pct"]
