"""The port stands alone: importing it loads no JAX, and the Hamming-NN
wrapper takes its plain version for CPU tensors without counting a
kernel launch."""

import os
import subprocess
import sys

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
    "multicol_slam_tpu_torch.kernels.hamming_nn",
    "multicol_slam_tpu_torch.models.extractor",
    "multicol_slam_tpu_torch.models.matcher",
    "multicol_slam_tpu_torch.models.optimizer",
    "multicol_slam_tpu_torch.models.tracking",
    "multicol_slam_tpu_torch.utils.config_io",
    "multicol_slam_tpu_torch.utils.synthetic",
    "multicol_slam_tpu_torch.utils.convert",
]


def test_import_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
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
