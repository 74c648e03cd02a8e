"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (``run.run_cell``) on the CPU, on the cell's own traffic with a lap
of 60 frames in place of 240 (a lap of set-up takes minutes on the CPU)
and a short window. A sound run is correct; each fault the cells can
have makes it not: a step that returns its state unchanged (every pose
the first of the window), half of each call left out (every second
frame without a pose), an answer altered where it is produced (one pose
in five moved or turned as ``controls.py`` does; the extractor's
descriptors with a bit flipped; the map's landmarks, as the system hands
them over, pushed as ``controls.py`` pushes them from the centre of its
keyframes). The exchange between chips does not exist on one card.
"""

import numpy as np
import pytest
import torch

from portbench import controls, driver, run, spec

CELLS = ("orb3.laps_batch", "mdbrief3.laps_batch", "orb3.laps_live")
SECONDS = 12.0
LAP = 60          # frames a lap: a lap of set-up the CPU tracks in about a minute


def _stale(feed):
    first = []

    def f(self, api, images, ts, chunk):
        out = feed(self, api, images, ts, chunk)
        if self.frame_id >= 12 + LAP:      # the window: the first pose, again and again
            first.extend(p for p in out if p is not None and not first)
            out = [first[0] if first and p is not None else p for p in out]
        return out
    return f


def _half(feed):
    def f(self, api, images, ts, chunk):
        out = feed(self, api, images, ts, chunk)
        g0 = self.frame_id - len(out) + 1
        return [None if (g0 + i) % 2 and g0 >= 12 + LAP else p for i, p in enumerate(out)]
    return f


def _every_fifth(fault):
    def wrap(feed):
        def f(self, api, images, ts, chunk):
            out = feed(self, api, images, ts, chunk)
            g0 = self.frame_id - len(out) + 1
            return [fault(p) if p is not None and (g0 + i) % 5 == 0 and g0 >= 12 + LAP else p
                    for i, p in enumerate(out)]
        return f
    return wrap


def _flip_bits(init):
    def f(self, config, device):
        init(self, config, device)
        slam = self.slam
        for name in ("extract", "extract_init"):
            ex = getattr(slam, name)

            def flipped(images, ex=ex):
                feats = ex(images)
                return feats._replace(desc=feats.desc ^ torch.tensor(1, dtype=torch.int32))
            setattr(slam, name, flipped)
    return f


def _push_landmarks(map_points):
    def f(self):
        X = map_points(self)
        m = self.slam.map
        centre = np.asarray(m.kf_pose[m.kf_valid], np.float64)[:, 3:6].mean(0)
        return controls.push(X, centre)
    return f


FAULTS = {"stale": ("feed", _stale), "half": ("feed", _half),
          "moved": ("feed", _every_fifth(controls.move)),
          "turned": ("feed", _every_fifth(controls.turn)),
          "bits": ("__init__", _flip_bits), "landmarks": ("map_points", _push_landmarks)}


def _run(monkeypatch, cell, fault=None):
    orig = spec.traffic
    monkeypatch.setattr(spec, "traffic", lambda name: dict(orig(name), lap_frames=LAP))
    if fault:
        attr, make = FAULTS[fault]
        monkeypatch.setattr(driver.System, attr, make(getattr(driver.System, attr)))
    bench = spec.Benchmark(spec.HERE + "/..")
    torch.manual_seed(0)
    return run.run_cell(bench, bench.cell(cell), 2**31 + 7, SECONDS, False,
                        torch.device("cpu"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(monkeypatch, cell):
    res = _run(monkeypatch, cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    res = _run(monkeypatch, cell, fault)
    assert not res["correct"], res["checks"]
