"""Map checkpoints, port against the JAX package: one npz layout, so a map
written by either package loads in the other.

The maps come from test_torch_map.py's replayed operation sequence (both
pools grown, observations erased, points merged in a chain, a point and a
keyframe removed), with loop edges added. Bars: every pool, the
observation lists, the merge table and its forwarding, the loop edges,
the covisibility counts, the live observation rows (as a set: a load
rebuilds the log from the lists, where a live log may hold a row twice)
and every keyframe's features identical after a round trip, whichever
package wrote or read the file. Then a
resume: the JAX package's map from the organic loop episode
(tests/data/organic_loop_jax_map.npz) loaded into the port's
MultiColSLAM on the CPU, the tracker LOST, the two frames after the
fixture's fed, and a relocalized pose within 5 cm and 1 degree of ground
truth's step from the fixture's last keyframe (the map is the one before
the loop's correction, so only that step is meaningful).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from multicol_slam_tpu.models import extractor as jext
from multicol_slam_tpu.utils import checkpoint as jckpt
from multicol_slam_tpu_torch.utils import checkpoint as tckpt
from multicol_slam_tpu_torch.utils import convert, episode

import test_torch_map as TM

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "organic_loop_jax_map.npz")


def _maps():
    """(JAX map, port map) after the same operations, with loop edges."""
    jm, tm = TM._pair()
    TM._replay(jm, tm, np.random.default_rng(4), check=False)
    for m in (jm, tm):
        for a, b in ((0, 4), (1, 4)):
            m.kf_loop_edges[a].add(b)
            m.kf_loop_edges[b].add(a)
    return jm, tm


def _assert_same(a, b):
    """Two port MapStores hold the same saved state."""
    assert tckpt.map_differences(a, b) == []
    assert len(np.unique(a.obs_rows(), axis=0)) > 50


def test_port_round_trip(tmp_path):
    _, tm = _maps()
    p = str(tmp_path / "map.npz")
    tckpt.save_map(p, tm, extra={"note": "round trip", "ids": [3, 5]})
    m2, extra = tckpt.load_map(p, device="cpu")
    assert extra == {"note": "round trip", "ids": [3, 5]}
    assert tm.pt_replaced and not tm.kf_valid[3] and m2.kf_features[3] is None
    _assert_same(m2, tm)
    assert all(f.desc.device.type == "cpu" for f in m2.kf_features if f is not None)


def test_a_jax_map_loads_in_the_port(tmp_path):
    jm, _ = _maps()
    p = str(tmp_path / "jax_map.npz")
    jckpt.save_map(p, jm, extra={"from": "jax"})
    m2, extra = tckpt.load_map(p, device="cpu")
    assert extra == {"from": "jax"}
    # the JAX map through the converters, and the file through the port
    _assert_same(m2, convert.map_from_numpy(jm))


def test_a_port_map_loads_in_the_jax_package(tmp_path):
    jm, tm = _maps()
    p = str(tmp_path / "port_map.npz")
    tckpt.save_map(p, tm, extra={"from": "port"})
    jm2, extra = jckpt.load_map(p)
    assert extra == {"from": "port"}
    assert all(isinstance(f, jext.Features) and f.desc.dtype == jnp.uint32
               for f in jm2.kf_features if f is not None)
    _assert_same(convert.map_from_numpy(jm2), convert.map_from_numpy(jm))
    _assert_same(convert.map_from_numpy(jm2), tm)


@pytest.mark.parametrize("save_as,load_as", [("m", "m"), ("m", "m.npz"), ("m.npz", "m")])
def test_npz_normalisation(tmp_path, save_as, load_as):
    """Either package's save_map appends '.npz' as np.savez_compressed
    does, and both load_maps accept the path with or without it."""
    _, tm = _maps()
    tckpt.save_map(str(tmp_path / save_as), tm)
    assert sorted(os.listdir(tmp_path)) == ["m.npz"]
    _assert_same(tckpt.load_map(str(tmp_path / load_as), device="cpu")[0], tm)
    _assert_same(convert.map_from_numpy(jckpt.load_map(str(tmp_path / load_as))[0]), tm)


def test_resume_from_the_organic_loop_fixture():
    """The JAX package's map at the revisit, loaded into the port's system
    on the CPU: the tracker LOST, the two frames after the fixture's fed,
    and a frame relocalized within 5 cm and 1 degree of ground truth's
    step from the keyframe of the fixture's frame (mirrors
    tests/test_persistence.py's resume)."""
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io

    m, extra = tckpt.load_map(FIXTURE, device="cpu")
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, device="cpu",
                        settings=config_io.SlamSettings(**episode.SETTINGS),
                        enable_loop_closing=False, **episode.CAPACITY)
    errs = episode.resume(slam, m, extra["frame_id"])
    assert any(e is not None and e[0] < 0.05 and e[1] < 1.0 for e in errs), errs
