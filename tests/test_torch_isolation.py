"""The port stands alone: importing it loads no JAX, the Hamming-NN
wrappers take their plain versions for CPU tensors without counting a
kernel launch and raise on other devices, the system, the map loader and
the command line run on the card unless asked for the CPU, the system
builds loop closing and relocalization in its default configuration, it
runs every extractor option of the reference, and its async mapping and
chunked modes, refused until they were ported, work."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch.kernels import hamming_nn as knn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "multicol_slam_tpu_torch",
    "multicol_slam_tpu_torch.ops.geometry",
    "multicol_slam_tpu_torch.ops.camera",
    "multicol_slam_tpu_torch.ops.rig",
    "multicol_slam_tpu_torch.ops.pyramid",
    "multicol_slam_tpu_torch.ops.fast",
    "multicol_slam_tpu_torch.ops.brief",
    "multicol_slam_tpu_torch.ops.hamming",
    "multicol_slam_tpu_torch.ops.ransac",
    "multicol_slam_tpu_torch.ops.se3_np",
    "multicol_slam_tpu_torch.ops.sim3",
    "multicol_slam_tpu_torch.kernels.hamming_nn",
    "multicol_slam_tpu_torch.models.extractor",
    "multicol_slam_tpu_torch.models.matcher",
    "multicol_slam_tpu_torch.models.optimizer",
    "multicol_slam_tpu_torch.models.tracking",
    "multicol_slam_tpu_torch.models.initializer",
    "multicol_slam_tpu_torch.models.map",
    "multicol_slam_tpu_torch.models.local_mapping",
    "multicol_slam_tpu_torch.models.vocabulary",
    "multicol_slam_tpu_torch.models.keyframe_database",
    "multicol_slam_tpu_torch.models.sim3_opt",
    "multicol_slam_tpu_torch.models.loop_closing",
    "multicol_slam_tpu_torch.models.global_ba",
    "multicol_slam_tpu_torch.models.system",
    "multicol_slam_tpu_torch.parallel",
    "multicol_slam_tpu_torch.parallel.ba_sharding",
    "multicol_slam_tpu_torch.utils.config_io",
    "multicol_slam_tpu_torch.utils.synthetic",
    "multicol_slam_tpu_torch.utils.convert",
    "multicol_slam_tpu_torch.utils.checkpoint",
    "multicol_slam_tpu_torch.utils.episode",
    "multicol_slam_tpu_torch.utils.timing",
    "multicol_slam_tpu_torch.utils.trajectory",
    "multicol_slam_tpu_torch.utils.viz",
    "multicol_slam_tpu_torch.cli",
    "multicol_slam_tpu_torch.evaluate",
]


def test_import_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "chip_smoke.radius_cases()\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'multicol_slam_tpu'))\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n"
            "assert torch.get_float32_matmul_precision() == 'highest'\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    g = torch.Generator().manual_seed(0)
    q = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 9, 8), generator=g, dtype=torch.int32)
    db = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 11, 8), generator=g, dtype=torch.int32)
    gate = torch.rand((2, 9, 11), generator=g) < 0.5
    before = knn.hamming_nn.launches
    got = knn.hamming_nn(q, db, gate)
    assert knn.hamming_nn.launches == before
    for a, b in zip(got, knn.hamming_nn_reference(q, db, gate)):
        assert torch.equal(a, b)


def test_other_devices_raise_instead_of_falling_back():
    q = torch.zeros((1, 2, 8), dtype=torch.int32, device="meta")
    db = torch.zeros((1, 3, 8), dtype=torch.int32, device="meta")
    gate = torch.ones((1, 2, 3), dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        knn.hamming_nn(q, db, gate)


def test_radius_entry_on_other_devices_raises():
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device="meta")
    i32, b8 = torch.int32, torch.bool
    with pytest.raises(RuntimeError, match="no kernel"):
        knn.hamming_nn_radius(z(1, 2, 8, dtype=i32), z(1, 3, 8, dtype=i32), z(1, 2, 2),
                              z(1, 2), z(1, 2, dtype=i32), z(1, 2, dtype=i32),
                              z(1, 2, dtype=b8), z(1, 3, 2), z(1, 3, dtype=i32),
                              z(1, 3, dtype=b8))


@pytest.fixture
def small_rig():
    from multicol_slam_tpu_torch.ops.rig import scale_rig
    from multicol_slam_tpu_torch.utils import config_io
    return scale_rig(config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0], 0.25)


def _small_vocabulary():
    from multicol_slam_tpu_torch.models import vocabulary as tv
    rng = np.random.default_rng(0)
    return tv.train_vocabulary(rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32),
                               k=4, levels=2)


def _two_word_dbow2_yaml(path):
    """A DBoW2 OpenCV-YAML vocabulary of two leaves under the root (k 2,
    L 1): node 1's 256-bit descriptor all zeros, node 2's all ones.
    Returns the tree the port must read from it."""
    from multicol_slam_tpu_torch.models import vocabulary as tv
    lines = ["%YAML:1.0", "vocabulary:", "   k: 2", "   L: 1", "   scoringType: 0",
             "   weightingType: 0", "   nodes:"]
    for node, byte, weight in ((1, 0, 0.5), (2, 255, 0.25)):
        desc = " ".join([str(byte)] * 32)
        lines.append(f'      - {{ nodeId:{node}, parentId:0, weight:{weight}, '
                     f'descriptor:"{desc}" }}')
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return tv.Vocabulary(
        centroids=torch.tensor([[0] * 8, [0] * 8, [-1] * 8], dtype=torch.int32),
        children=torch.tensor([[1, 2], [-1, -1], [-1, -1]], dtype=torch.int32),
        word_of_node=torch.tensor([-1, 0, 1], dtype=torch.int32),
        weights=torch.tensor([0.5, 0.25]), k=2, levels=1, n_words_=2)


@pytest.mark.parametrize("vocabulary", [None, "npz", "yml"])
def test_system_builds_loop_closing_by_default(small_rig, tmp_path, vocabulary):
    """Loop closing is on by default, as in the JAX package; the loop
    closer comes with the first keyframe, from a vocabulary file when one
    is named (the npz layout or DBoW2 YAML, by extension)."""
    from multicol_slam_tpu_torch.models import vocabulary as tv
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    kw = {}
    if vocabulary is not None:
        path = str(tmp_path / f"voc.{vocabulary}")
        if vocabulary == "npz":
            voc = _small_vocabulary()
            tv.save_vocabulary(voc, path)
        else:
            voc = _two_word_dbow2_yaml(path)
        kw["vocabulary_path"] = path
    slam = MultiColSLAM(rig=small_rig, **kw)
    assert slam._enable_loops and slam.loop_closer is None
    if vocabulary is None:
        return
    slam._ensure_loop_closer(0)
    lc = slam.loop_closer
    assert slam.tracker.reloc_candidates_fn is not None
    assert slam.tracker.reloc_bow_match_fn == lc.bow_match_frame
    assert slam.map.on_kf_removed == lc.forget_keyframe
    for name in ("centroids", "children", "word_of_node", "weights"):
        assert torch.equal(getattr(lc.voc, name), getattr(voc, name))
    assert (lc.voc.k, lc.voc.levels, lc.voc.n_words) == (voc.k, voc.levels, voc.n_words)


@pytest.mark.parametrize("opts,detector", [
    (dict(use_mdbrief=True, learn_masks=True, use_agast=True, fast_agast_type=0), "agast_5_8"),
    (dict(use_mdbrief=True, learn_masks=True, use_agast=True, fast_agast_type=1), "agast_7_12"),
    (dict(use_mdbrief=True, learn_masks=True, use_agast=True, fast_agast_type=2), "agast_7_12"),
    (dict(use_mdbrief=True, learn_masks=True, use_agast=True, fast_agast_type=3), "fast_9_16"),
    (dict(use_mdbrief=True, learn_masks=False), "fast_9_16"),
    (dict(learn_masks=True, use_agast=False, fast_agast_type=0), "fast_9_16"),
])
def test_system_runs_every_extractor_option(small_rig, monkeypatch, opts, detector):
    """The reference's extractor options (extractor.usemdBRIEF, .masks,
    .useAgast, .fastAgastType) build both extractors as the JAX package's
    system.py:72-89 does and run a frame; the matchers take the masked
    distance only for mdBRIEF with learned masks."""
    from multicol_slam_tpu_torch.models import system as tsys
    from multicol_slam_tpu_torch.utils import config_io, synthetic
    cfgs = []
    make = tsys.make_extractor
    monkeypatch.setattr(tsys, "make_extractor", lambda cfg, *a: cfgs.append(cfg) or make(cfg, *a))
    s = config_io.SlamSettings(**opts)
    slam = tsys.MultiColSLAM(rig=small_rig, settings=s, enable_loop_closing=False)
    mdbrief = s.use_mdbrief and s.learn_masks
    assert [(c.detector_mask, c.use_dbrief, c.learn_masks, c.n_features, c.fast_th)
            for c in cfgs] == [(detector, s.use_mdbrief, s.learn_masks, 400, 20),
                               (detector, s.use_mdbrief, s.learn_masks, 800, 5)]
    assert slam.tracker.params.masked == slam.mapper.params.masked == mdbrief
    frame = synthetic.make_renderer(small_rig)(torch.eye(4)).round().to(torch.uint8)
    assert slam.track(frame, 0.0) is None and slam.state.name == "INITIALIZING"
    feats = slam.extract(frame)
    assert int(feats.valid.sum()) > 0
    assert bool((feats.desc_mask == -1).all()) != mdbrief


def test_system_refuses_unported_modes(small_rig):
    """async_mapping=True, refused until it was ported, builds the mapper
    thread and wires its hooks as the JAX package does; shutdown joins it."""
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    slam = MultiColSLAM(rig=small_rig, async_mapping=True)
    thread = slam._mapper_thread
    try:
        assert thread.is_alive() and thread.daemon
        tr = slam.tracker
        assert tr.on_new_keyframe == slam._enqueue_kf
        assert tr.on_init_keyframes == slam._process_init_kfs
        assert tr.mapper_idle_fn() and not slam.mapper.interrupt_check()
        tr.interrupt_ba_fn()
        assert slam.mapper.interrupt_check()
    finally:
        slam.shutdown()
    assert not thread.is_alive() and slam._kf_queue.unfinished_tasks == 0
    sync = MultiColSLAM(rig=small_rig)
    assert sync._mapper_thread is None and sync.tracker.mapper_idle_fn is None
    assert sync.tracker.on_new_keyframe == sync._process_kf


def test_unported_tracker_paths_raise(small_rig):
    """Relocalization and track_batch, both refused until they were ported,
    fail cleanly where there is nothing to do."""
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    slam = MultiColSLAM(rig=small_rig)
    # with no keyframe to match, relocalization fails cleanly
    assert slam.tracker._relocalize() is False
    h, w = int(small_rig.cams.height[0]), int(small_rig.cams.width[0])
    assert slam.track_batch(torch.zeros((0, 3, h, w), dtype=torch.uint8), []) == []
    with pytest.raises(ValueError, match="timestamps"):
        slam.track_batch(torch.zeros((2, 3, h, w), dtype=torch.uint8), [0.0])
    # before any frame the chunked path is refused, not run
    assert slam.tracker.track_chunk(torch.zeros((8, 3, h, w)), [0.0] * 8) is None
    assert slam.state.name == "NO_IMAGES_YET"


@pytest.mark.parametrize("source,device,want", [
    ("calib_dir", None, "raises"),
    ("calib_dir", "cpu", "cpu"),
    ("rig", None, "cpu"),          # a passed rig keeps its device
    ("rig", "cpu", "cpu"),
])
def test_system_runs_on_the_card_unless_asked_for_the_cpu(
        small_rig, monkeypatch, source, device, want):
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(calib_dir=config_io.SYNTH_RIG_DIR) if source == "calib_dir" \
        else dict(rig=small_rig)
    if device is not None:
        kw["device"] = device
    if want == "raises":
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MultiColSLAM(enable_loop_closing=False, **kw)
        return
    slam = MultiColSLAM(enable_loop_closing=False, **kw)
    assert slam.device == torch.device(want)
    assert slam.rig.M_c.device.type == want and slam.rig.cams.u0.device.type == want


@pytest.mark.parametrize("device,want", [(None, "raises"), ("cpu", "cpu")])
def test_load_map_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path,
                                                           device, want):
    from multicol_slam_tpu_torch.models.map import MapStore
    from multicol_slam_tpu_torch.utils import checkpoint, synthetic
    from multicol_slam_tpu_torch.ops.rig import scale_rig
    from multicol_slam_tpu_torch.utils import config_io
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    rig = scale_rig(config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0], 0.25)
    slam = MultiColSLAM(rig=rig, enable_loop_closing=False)
    frame = synthetic.make_renderer(rig)(torch.eye(4)).round().to(torch.uint8)
    m = MapStore(capacity_pts=16, capacity_kfs=4, n_cams=3, k_per_cam=800)
    m.alloc_keyframe(np.zeros(6), slam._extract_padded(frame), 0)
    path = str(tmp_path / "map.npz")
    checkpoint.save_map(path, m)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {} if device is None else {"device": device}
    if want == "raises":
        with pytest.raises(RuntimeError, match="device='cpu'"):
            checkpoint.load_map(path, **kw)
        return
    m2, _ = checkpoint.load_map(path, **kw)
    assert all(t.device.type == want for t in m2.kf_features[0])
    assert checkpoint.map_differences(m2, m) == []


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    from multicol_slam_tpu_torch import cli
    from multicol_slam_tpu_torch.utils import config_io
    argv = ["--calib", config_io.SYNTH_RIG_DIR, "--synthetic", "2", "--out-dir",
            str(tmp_path)]
    assert cli.parse_args(argv).device == "cuda"
    assert cli.parse_args(argv + ["--device", "cpu"]).device == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    assert not os.path.exists(tmp_path / "MKFTrajectory.txt")


# slice 8: the self-calibrating optimizers, their Jacobians and the rig
# helpers make every tensor on their inputs' device and never copy to the host
SELF_CAL = [("multicol_slam_tpu_torch.models.optimizer", name) for name in (
    "self_calibrating_bundle_adjustment", "refine_intrinsics", "extrinsic_jacobian",
    "intrinsics_jacobian")] + [("multicol_slam_tpu_torch.ops.rig", name) for name in (
        "make_rig", "world_to_cam_frame", "world_to_img_rig", "img_to_world_rig",
        "rays_to_body", "cam_centers_world")]
# slice 9: the sharded BA, the halves of the Schur step it shares with
# bundle_adjustment, and the leaf functions
SELF_CAL += [("multicol_slam_tpu_torch.models.optimizer", name) for name in (
    "make_ba_blocks", "make_schur_solve", "lm_accept", "bundle_adjustment")] + [
    ("multicol_slam_tpu_torch.parallel.ba_sharding", name) for name in (
        "pad_obs_to_multiple", "shard_obs", "reduce_sum", "gather_rows", "_sharded_problem",
        "make_sharded_ba_step", "make_sharded_ba")] + [
    ("multicol_slam_tpu_torch.ops.geometry", name) for name in (
        "essential_from_relpose", "essential_from_poses", "check_dist_epipolar_line",
        "rot2quat")] + [
    ("multicol_slam_tpu_torch.ops.camera", "is_in_mirror_mask"),
    ("multicol_slam_tpu_torch.ops.hamming", "hamming_matrix_exact"),
    ("multicol_slam_tpu_torch.ops.hamming", "hamming_matrix_masked_exact"),
    ("multicol_slam_tpu_torch.ops.hamming", "to_pm1"),
    ("multicol_slam_tpu_torch.ops.pyramid", "box_filter"),
    ("multicol_slam_tpu_torch.ops.brief", "ic_angle"),
    ("multicol_slam_tpu_torch.ops.ransac", "ransac_essential"),
    ("multicol_slam_tpu_torch.ops.ransac", "ransac_gpnp"),
    ("multicol_slam_tpu_torch.ops.hamming", "gated_nn_match")]
FACTORIES = {"zeros", "ones", "full", "empty", "eye", "arange", "tensor", "linspace",
             "as_tensor", "randn", "rand"}


@pytest.mark.parametrize("module,name", SELF_CAL)
def test_self_calibration_makes_tensors_on_the_inputs_device(module, name):
    """No ``.cpu()``, ``.item()`` or ``.numpy()`` in the function, and every
    tensor factory in it names a device (read from the source)."""
    import ast
    import importlib
    import inspect
    import textwrap

    tree = ast.parse(textwrap.dedent(inspect.getsource(
        getattr(importlib.import_module(module), name))))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
            continue
        assert node.func.attr not in ("cpu", "item", "numpy", "tolist"), \
            f"{name} calls .{node.func.attr}() at line {node.lineno}"
        if (isinstance(node.func.value, ast.Name) and node.func.value.id == "torch"
                and node.func.attr in FACTORIES):
            assert any(k.arg == "device" for k in node.keywords), \
                f"{name}: torch.{node.func.attr} without device= at line {node.lineno}"


def test_self_calibration_runs_on_the_inputs_device():
    """The same functions on tensors of the meta device: every output lies
    there (a tensor made on the CPU would not mix with them, and a copy to
    the host would fail)."""
    from multicol_slam_tpu_torch.models import optimizer as opt
    from multicol_slam_tpu_torch.ops import rig as rig_ops
    from multicol_slam_tpu_torch.utils import config_io

    m = torch.device("meta")
    rig = config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0].to(m)
    N, P, K, M = 4, 20, 61, 5
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=m)
    obs = opt.BAObservations(uv=z(K, 2), kf=z(K, dtype=torch.int32), cam=z(K, dtype=torch.int32),
                             pt=z(K, dtype=torch.int32), inv_sigma2=z(K),
                             valid=z(K, dtype=torch.bool))
    prob = opt.BAProblem(obs=obs, pt_obs=z(P, M, dtype=torch.int32),
                         fixed_kf=z(N, dtype=torch.bool), fixed_pt=z(P, dtype=torch.bool))
    cams = rig.cams.index(obs.cam.long())
    M_t = torch.eye(4, device=m)
    outs = [*opt.self_calibrating_bundle_adjustment(rig, z(N, 6), z(P, 3), prob, iters=2),
            *opt.bundle_adjustment(rig, z(N, 6), z(P, 3), prob, iters=2, free_mc=True),
            *opt.refine_intrinsics(rig, z(N, 6), z(P, 3), obs, iters=2)[1:],
            *opt.refine_intrinsics(rig, z(N, 6), z(P, 3), obs, iters=2)[0],
            opt.extrinsic_jacobian(z(6), z(K, 6), z(K, 3), cams),
            opt.intrinsics_jacobian(z(K, 3), cams),
            rig_ops.world_to_cam_frame(M_t, rig.M_c, z(P, 3)),
            *rig_ops.world_to_img_rig(rig, M_t, z(P, 3)),
            rig_ops.img_to_world_rig(rig, z(3, P, 2)),
            rig_ops.rays_to_body(rig, z(3, P, 3)),
            rig_ops.cam_centers_world(M_t, rig.M_c),
            rig_ops.make_rig([rig.M_c[c] for c in range(3)],
                             [rig.cams.index(c) for c in range(3)]).M_c]
    assert all(t.device == m for t in outs), [t.device for t in outs]


def test_sharded_ba_runs_on_the_mesh_devices():
    """The sharded BA on a mesh of two meta devices: every output lies
    there, so no shard's work fell back to the CPU or copied to the host."""
    from multicol_slam_tpu_torch.models import optimizer as opt
    from multicol_slam_tpu_torch.parallel import ba_sharding as bs
    from multicol_slam_tpu_torch.utils import config_io

    m = torch.device("meta")
    rig = config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0]
    N, P, K, M = 4, 20, 61, 5
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=m)
    obs = opt.BAObservations(uv=z(K, 2), kf=z(K, dtype=torch.int32), cam=z(K, dtype=torch.int32),
                             pt=z(K, dtype=torch.int32), inv_sigma2=z(K),
                             valid=z(K, dtype=torch.bool))
    shards = bs.shard_obs(bs.pad_obs_to_multiple(obs, 2), [m, m])
    args = (z(P, M, dtype=torch.int32), z(N, dtype=torch.bool), z(P, dtype=torch.bool))
    outs = [*bs.make_sharded_ba([m, m], rig, N, P, iters=2)(z(N, 6), z(P, 3), shards, *args),
            *bs.make_sharded_ba_step([m, m], rig, N, P)(z(N, 6), z(P, 3), shards, *args, 1e-4)]
    assert all(t.device == m for t in outs), [t.device for t in outs]
