"""The async mapper's stream and the graph pools' side streams on the card:
each is a stream of its own (``graphs.own_stream``), never one of
PyTorch's pool of 32 streams a priority, so in a process that has made
more than 32 systems and pools no mapper stream is a capture's side
stream, and a system captures its graphs beside its live mapper. A
system's shutdown and a pool's collection give their streams back, to be
handed out again.

No JAX; on the card:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_streams.py
"""

import gc

import pytest
import torch

from multicol_slam_tpu_torch.models.system import MultiColSLAM
from multicol_slam_tpu_torch.models.tracking import TrackState
from multicol_slam_tpu_torch.utils import config_io, graphs, synthetic

pytestmark = pytest.mark.cuda

N_SYSTEMS = 34          # past PyTorch's 32 streams a priority


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the streams are CUDA streams")
    return torch.device("cuda", 0)


def test_no_stream_is_shared_across_many_systems_and_pools(dev):
    systems = [MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, async_mapping=True,
                            enable_loop_closing=False) for _ in range(N_SYSTEMS)]
    try:
        mapper = [s._mapper_stream.cuda_stream for s in systems]
        pools = [graphs.Pool(f"extra{i}") for i in range(N_SYSTEMS)]
        sides = [p.state(dev)[1].cuda_stream for p in pools]
        sides += [s.mapper.pool.state(dev)[1].cuda_stream for s in systems]
        sides.append(graphs.SHARED.state(dev)[1].cuda_stream)
        pooled = [torch.cuda.Stream(device=dev).cuda_stream for _ in range(2 * N_SYSTEMS)]
        assert len(set(mapper)) == len(mapper)
        assert len(set(sides)) == len(sides)
        assert not set(mapper) & set(sides)
        assert not (set(mapper) | set(sides)) & set(pooled)
    finally:
        for s in systems:
            s.shutdown()


def test_capture_beside_a_live_mapper_after_many_systems(dev):
    for _ in range(N_SYSTEMS):
        MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, async_mapping=True,
                     enable_loop_closing=False).shutdown()
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, async_mapping=True)
    gt = torch.tensor(synthetic.bench_trajectory(24), dtype=torch.float32, device=dev)
    frames = torch.round(synthetic.make_renderer(slam.rig)(gt)).to(torch.uint8)
    captures = graphs.stats()["captures"]
    try:
        for i in range(len(frames)):
            slam.track(frames[i], i / 25.0)
    finally:
        slam.shutdown()
    assert slam.state == TrackState.WORKING
    assert len(slam.mapping_ms) >= 3          # passes on the mapper's thread and stream
    assert graphs.stats()["captures"] > captures


def test_streams_go_back_at_shutdown_and_with_their_pool(dev):
    def free():
        return {s.cuda_stream for s in graphs._free_streams.get(dev.index, [])}

    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, async_mapping=True,
                        enable_loop_closing=False)
    mapper = slam._mapper_stream.cuda_stream
    assert mapper not in free()
    slam.shutdown()
    assert slam._mapper_stream is None and mapper in free()
    pool = graphs.Pool("short-lived")
    side = pool.state(dev)[1].cuda_stream
    assert side not in free()
    del pool
    gc.collect()
    assert side in free()
    n = len(free())
    taken = [graphs.own_stream(dev) for _ in range(n + 1)]
    got = {s.cuda_stream for s in taken}
    assert {mapper, side} <= got and len(got) == n + 1 and not free()
    for s in taken:
        graphs.release_stream(s)
