"""The end-to-end metrics: ``fps`` is every frame whose pose came back
over the whole window, ``frame_ms_p95`` every frame's time."""

import time

import numpy as np
import torch

from portbench import run


class FakeSystem:
    device = torch.device("cpu")

    def __init__(self, delays, lost=()):
        self.delays, self.lost, self.i = delays, set(lost), 0

    def feed(self, api, images, ts, chunk):
        out = []
        for _ in ts:
            time.sleep(self.delays[self.i % len(self.delays)])
            out.append(None if self.i in self.lost else np.eye(4))
            self.i += 1
        return out


class FakeTraffic:
    api, chunk = "track", 8

    def __init__(self, per_call):
        self.per_call = per_call

    def call(self, g, n):
        return torch.zeros(n, 1, 1, 1), [g / 25.0 for g in range(g, g + n)]


def test_fps_is_all_frames_over_the_whole_window():
    w = run.Window(FakeSystem([0.002, 0.03], lost=[3]), FakeTraffic(4), 0)
    w.run(frames=12)
    m = run.end_to_end(w, 1.0)
    assert len(w.frames()) == 12
    # 11 poses over the window, from the first frame handed over to the last pose
    assert abs(m["fps"] - 11 / (w.t1 - w.t0)) < 1e-9
    assert w.t1 >= w.calls[-1][3] and w.t0 <= w.calls[0][2]
    assert "frame_ms_p95" not in m        # calls of four frames carry no frame's own time


def test_frame_ms_p95_is_over_every_frame():
    delays = [0.001] * 18 + [0.05, 0.08]
    w = run.Window(FakeSystem(delays), FakeTraffic(1), 0)
    w.run(frames=20)
    ms = w.frame_ms()
    assert len(ms) == 20
    assert run.end_to_end(w, 1.0)["frame_ms_p95"] == np.percentile(ms, 95)
    assert run.end_to_end(w, 1.0)["frame_ms_p95"] > 40      # the tail, not a median


def test_a_frame_budget_cuts_the_last_call():
    w = run.Window(FakeSystem([0.0]), FakeTraffic(32), 0)
    w.run(frames=70)
    assert [c[1] for c in w.calls] == [32, 32, 6] and w.g == 70


def test_stop_by_seconds_runs_past_the_deadline_by_one_call():
    w = run.Window(FakeSystem([0.01]), FakeTraffic(2), 100)
    w.run(seconds=0.1)
    assert w.seconds >= 0.1 and w.calls[0][0] == 100
    assert [c[0] for c in w.calls] == list(range(100, 100 + 2 * len(w.calls), 2))
