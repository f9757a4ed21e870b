import os
import shutil
import subprocess
import sys

import pytest

from rtbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("mods,found", [
    ({"hrt_tpu_torch": 1, "hrt_tpu_torch.frameloop": 1, "torch": 1}, []),
    ({"hrt_tpu": 1}, ["hrt_tpu"]),
    ({"hrt_tpu.ops.rng": 1}, ["hrt_tpu"]),
    ({"jax": 1, "jax.numpy": 1}, ["jax"]),
    ({"jaxlib.xla_client": 1, "flax.linen": 1}, ["flax", "jaxlib"]),
    ({"jax_like": 1, "hrt_tpu_torchx": 1, "flaxen": 1}, []),
])
def test_guard_compares_whole_top_level_names(mods, found):
    assert harness.forbidden_modules(mods) == found


def test_the_benchmark_and_the_program_load_no_jax():
    """In a fresh process: the harness, the reference and the program's
    frame loop load neither JAX nor the JAX package."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import rtbench.run, rtbench.harness, rtbench.check\n"
            "import hrt_tpu_torch.frameloop, hrt_tpu_torch.models.scene\n"
            "from rtbench import harness\n"
            "print(harness.forbidden_modules())\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_exits_without_a_result_where_it_cannot_run(tmp_path):
    """Without a card (here), and in a directory holding only the
    benchmark's files, the command exits non-zero and prints no line."""
    shutil.copytree(f"{ROOT}/rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for cwd in (ROOT, str(tmp_path)):
        out = subprocess.run(
            [sys.executable, "rtbench/run.py", "--workload",
             "bench_scene.pt1080_still", "--seed", "3000000000",
             "--seconds", "1", "--trace", "0"], cwd=cwd,
            capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
