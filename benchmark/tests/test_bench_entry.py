"""The run command fails, and prints no result, without a card, and in a
directory that holds only ``BENCHMARK.json`` and ``benchmark/`` (the
program is not part of the benchmark)."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")


def _run(cwd, *args):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result(no_card):
    got = _run(ROOT, "benchmark/run.py", "--workload", "d30-256.fid-bf16-b32",
               "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0")
    assert got.returncode != 0
    assert not got.stdout.strip()
    assert "no CUDA card" in got.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from benchmark.harness import runner, cells;"
            "runner.run_loaded(cells.workload('d16-256.train-b32'), 1, 1.0,"
            " False, time.time(), require_card=False, device='cpu')")
    got = _run(tmp_path, "-c", code)
    assert got.returncode != 0 and not got.stdout.strip()
    assert "sdvar_tpu_torch" in got.stderr
