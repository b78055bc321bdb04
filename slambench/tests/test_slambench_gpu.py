"""On the card: one short run of each cell through the command BENCHMARK.json
gives, its result line whole and correct, and the run's exit without a card.
Run: python -m pytest slambench/tests/test_slambench_gpu.py -m gpu"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(cell, seed, trace=0, seconds=1):
    cmd = M["command"] + ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                          "--trace", str(trace)]
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_a_short_run_is_whole_and_correct(card, cell):
    out = _run(cell, 2**31 + 17)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    want = {m["name"] for m in M["end_to_end"] if "workloads" not in m or cell in m["workloads"]}
    assert set(line["metrics"]) == want
    assert list(line)[-1] == "checks"


def test_no_card_no_result(tmp_path):
    """With no card visible the run exits non-zero and prints no result."""
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin:/usr/local/bin",
           "HOME": str(tmp_path)}
    cmd = [sys.executable, "-m", "slambench.run", "--workload", M["workloads"][0]["name"],
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory with BENCHMARK.json and slambench/ but not the program: the
    run exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    cmd = [sys.executable, "-m", "slambench.run", "--workload", M["workloads"][0]["name"],
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    env = {"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp_path)}
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
