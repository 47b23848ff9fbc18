"""What a run refuses: JAX or the JAX package in the process (by whole
top-level name), and a machine without a card; and that nothing under
``port_bench/`` imports them, nor the reference anything of the port."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import pytest  # noqa: E402

from harness import guard  # noqa: E402


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"fast_neural_style_transfer_tpu_torch": 1,
            "fast_neural_style_transfer_tpu_torch.ops": 1, "numpy": 1, "jaxtyping": 1}
    assert guard.forbidden_modules(mods) == []
    for bad in ("fast_neural_style_transfer_tpu", "fast_neural_style_transfer_tpu.models",
                "jax", "jax.numpy", "jaxlib", "flax.linen"):
        assert guard.forbidden_modules({**mods, bad: 1}) == [bad]


def _imports(path: Path):
    text = path.read_text()
    return set(re.findall(r"^\s*(?:from|import)\s+([A-Za-z_][\w]*)", text, re.M))


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & set(guard.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "fast_neural_style_transfer_tpu_torch" not in _imports(path), path


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "stylenet-ref.serve.512-closed", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_with_only_the_benchmark_files_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "stylenet-ref.serve.512-closed", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
