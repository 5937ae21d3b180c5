"""The command without a card, and without the program beside it: a
non-zero exit and no result line."""

import os
import shutil
import subprocess
import sys

import pytest

from portbench.spec import ROOT


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "photo_1080p.upload", "--seed", str(2**31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_exits_nonzero_without_a_card(no_card):
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(tmp_path, env)
    assert out.returncode != 0
    assert out.stdout == ""
