"""Nothing on the card imports JAX or the JAX package, by whole top-level
name, and the reference imports nothing of the program."""

import os
import subprocess
import sys

import pytest

from portbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_forbidden_modules_by_whole_top_level_name():
    assert run.forbidden_modules(["multicol_slam_tpu_torch", "multicol_slam_tpu_torch.ops",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["multicol_slam_tpu"]) == ["multicol_slam_tpu"]
    assert run.forbidden_modules(["multicol_slam_tpu.models.system"]) == ["multicol_slam_tpu"]
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax",
                                                                              "jaxlib"]


def _loaded_after(stmt):
    code = f"import sys; {stmt}; print(' '.join(sorted(sys.modules)))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    return out.stdout.split()


def test_the_yardstick_imports_nothing_of_the_program():
    mods = _loaded_after("import portbench.run, portbench.spec, portbench.world, "
                         "portbench.trace, portbench.traffic.laps, portbench.reference.extract, "
                         "portbench.reference.work, portbench.reference.trajectory")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"multicol_slam_tpu_torch", "multicol_slam_tpu", "jax", "jaxlib", "flax"}


def test_the_driver_loads_no_jax():
    mods = _loaded_after("import portbench.driver; import multicol_slam_tpu_torch.models.system")
    assert run.forbidden_modules(mods) == []


def test_no_result_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "orb3.laps_batch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
