"""The measurement path refuses to run without a CUDA device."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def test_run_exits_naming_the_missing_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "coco128.train_b256",
                          "--seed", str(2**31 + 5), "--seconds", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""


def test_run_refuses_a_directory_without_the_program(tmp_path):
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "coco128.sample_b128",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.card
def test_a_short_sample_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import json

    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "coco128.sample_b128",
                          "--seed", str(2**31 + 77), "--seconds", "2"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert line["device"]["platform"] == "gpu"
