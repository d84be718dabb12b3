"""A short run of every cell on the card, through the benchmark's command
(``python3 portbench/run.py ...``); skips where there is no card."""

import json
import os
import subprocess
import sys

import pytest

from portbench.tests import tiny
from portbench import bench


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "cell", [w["name"] for w in bench.load_manifest()["workloads"]])
def test_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "3", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
