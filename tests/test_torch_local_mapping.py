"""One local-mapping pass of the port against the JAX package's, on a map
carried over from a JAX run: the JAX system bootstraps on frames 0-8 of
``bench_trajectory`` at full width; its map right before the mapping pass
of the second bootstrap keyframe (after the first keyframe's pass) moves
into the port with ``convert.map_from_numpy``, and both packages' mappers
run ``process_keyframe`` on it: point statistics, culling, triangulation
against the covisible keyframe, cross-camera points, fuse, local BA and
keyframe culling.

Bars, with what was measured on the CPU:
  - the keyframe-slot tables agree on >= 99% of slots (measured 100%);
  - the point count within 1% (measured 634 and 634);
  - the adjusted keyframe poses within 1e-4 in every entry and the points
    both maps hold within 1 cm (measured 8.9e-8 and 7.3e-5 m);
  - the distinctive descriptors identical on >= 99% of the observed
    points (measured 100%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multicol_slam_tpu.models import local_mapping as jlm
from multicol_slam_tpu.models import system as jsys
from multicol_slam_tpu_torch.models import local_mapping as tlm
from multicol_slam_tpu_torch.models import matcher as tm
from multicol_slam_tpu_torch.models import optimizer as topt
from multicol_slam_tpu_torch.utils import convert

import _torchutil as U

KF = 1          # the second bootstrap keyframe


@pytest.fixture(scope="module")
def carried():
    """(map before the pass as numpy, mapper probation list, JAX map after
    the pass as the port's MapStore)."""
    _, frames = U.bench_frames(9)
    snaps = {}
    orig = jlm.LocalMapper.process_keyframe

    def wrapped(self, kf):
        if kf == KF:
            snaps["before"] = convert.map_to_numpy(convert.map_from_numpy(self.map))
            snaps["recent"] = list(self.recent_pts)
        orig(self, kf)
        if kf == KF:
            snaps["after"] = convert.map_from_numpy(self.map)

    mp = pytest.MonkeyPatch()
    mp.setattr(jlm.LocalMapper, "process_keyframe", wrapped)
    try:
        with U.f32():
            js = jsys.MultiColSLAM(rig=jax.tree.map(jnp.asarray, U.full_jax_rig()),
                                   enable_loop_closing=False)
            for i in range(9):
                js.track(jnp.asarray(frames[i].numpy()), i / 25.0)
    finally:
        mp.undo()
    assert "after" in snaps, "the JAX run did not bootstrap by frame 8"
    return snaps


def _port_pass(carried):
    m = convert.map_from_numpy(carried["before"])
    mapper = tlm.LocalMapper(U.full_torch_rig(), m, tm.MatchParams())
    mapper.recent_pts = list(carried["recent"])
    mapper.process_keyframe(KF)
    return m, mapper


def test_process_keyframe_matches_jax(carried):
    got, mapper = _port_pass(carried)
    _assert_matches_jax(carried, got, mapper)


def test_process_keyframe_through_graphs_matches_jax(carried, monkeypatch):
    """The pass with the mapper's four units as graphs (``graphs.jit``
    through the capture stand-in of ``tests/_graphutil.py``): a first pass
    on a copy of the map captures each unit's keys, a second on another
    copy replays them, and the second is held to the bars above."""
    from _graphutil import StandIn
    from multicol_slam_tpu_torch.utils import graphs

    stand = StandIn(monkeypatch)
    pool = graphs.Pool("mapper")
    units = {name: graphs.jit(fn, pool) for name, fn in (
        ("_triangulate", tlm.triangulation_batch), ("_cross_camera", tlm.cross_camera_batch),
        ("_fuse", tlm.fuse_targets_batch), ("_bundle_adjust", topt.bundle_adjustment))}

    def graphed_pass():
        m = convert.map_from_numpy(carried["before"])
        mapper = tlm.LocalMapper(U.full_torch_rig(), m, tm.MatchParams())
        for name, unit in units.items():
            setattr(mapper, name, unit)
        mapper.recent_pts = list(carried["recent"])
        mapper.process_keyframe(KF)
        return m, mapper

    graphed_pass()
    captures = stand.captures
    got, mapper = graphed_pass()
    assert stand.captures == captures >= 4
    assert all(u.replays >= 1 for u in units.values())
    _assert_matches_jax(carried, got, mapper)


def _assert_matches_jax(carried, got, mapper):
    before, want = carried["before"], carried["after"]
    assert got._next_pt > before["_next_pt"]                  # it triangulated
    assert abs(got.n_points() - want.n_points()) <= 0.01 * want.n_points()
    same = (got.kf_pt[:2] == want.kf_pt[:2]).mean()
    assert same >= 0.99, same
    np.testing.assert_allclose(got.kf_pose[:2], want.kf_pose[:2], rtol=0, atol=1e-4)
    both = got.pt_valid & want.pt_valid[:len(got.pt_valid)]
    np.testing.assert_allclose(got.pt_pos[both], want.pt_pos[both], rtol=0, atol=0.01)
    obs = np.zeros(len(both), bool)
    obs[[p for p, lst in got.pt_obs.items() if lst]] = True
    sel = both & obs
    frac = (got.pt_desc[sel] == want.pt_desc[sel]).all(1).mean()
    assert frac >= 0.99, frac
    assert len(mapper.recent_pts) > 0


def test_stages_run_through_the_kernel_wrapper(carried, monkeypatch):
    """Every matching stage of the pass reduces through the kernel's
    wrappers: triangulation and cross-camera through the dense-gate entry
    ``hamming_nn``, one call each, and fuse through the window-gated entry
    ``hamming_nn_radius`` (two calls, forward and reverse)."""
    calls = []
    for name in ("hamming_nn", "hamming_nn_radius"):
        orig = getattr(tm, name)

        def spy(q, db, *rest, _name=name, _orig=orig):
            calls.append((_name, q.shape[:2], db.shape[:2]))
            return _orig(q, db, *rest)

        monkeypatch.setattr(tm, name, spy)
    _port_pass(carried)
    C, K = 3, 800
    T = tlm.LocalMapper.TRIANG_NEIGHBORS * C
    assert ("hamming_nn", (T, K), (T, K)) in calls
    assert ("hamming_nn", (C, K), (C, K)) in calls            # three camera pairs
    fuse = [c for c in calls if c[0] == "hamming_nn_radius"]
    assert len(fuse) >= 2 and all(c[1][0] == 1 and c[2][1] == K for c in fuse)
