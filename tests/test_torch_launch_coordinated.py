"""The port's launcher as a coordinated job, on the CPU: two processes of
``python -m repro_torch.launch.train --coordinated`` simulated by the
``REPRO_PROCESS_INDEX`` / ``REPRO_PROCESS_COUNT`` environment (each writes
its owned shards, the leader fuses and commits), then one process resumes
the same directory (the elastic restart).  The losses continue those of
an uninterrupted run."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import train as launch

torch.set_num_threads(1)

ARGS = ["--arch", "xlstm-125m", "--preset", "smoke", "--batch", "2",
        "--seq", "32", "--ckpt-every", "4", "--log-every", "100",
        "--device", "cpu"]

_PROG = r"""
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import train
print("LOSSES", json.dumps(train.main(sys.argv[1:])))
"""


def _run(args, env_extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **env_extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    return subprocess.Popen([sys.executable, "-c", _PROG] + args, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _losses(out):
    line = next(l for l in out.splitlines() if l.startswith("LOSSES "))
    return json.loads(line[len("LOSSES "):])


@pytest.mark.multiprocess
def test_two_process_coordinated_run_then_one_process_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    coord = str(tmp_path / "coord")
    procs = [_run(ARGS + ["--steps", "12", "--ckpt-dir", ckpt,
                          "--coordinated", "--coord-dir", coord],
                  {"REPRO_PROCESS_INDEX": str(p),
                   "REPRO_PROCESS_COUNT": "2"}) for p in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out, err)
        assert "coordinated checkpointing: process" in out
    first = [_losses(out) for out, _ in outs]
    assert first[0] == first[1]

    # the job is cut after step 8: the later step never happened
    shutil.rmtree(os.path.join(ckpt, "ram", "step_12"))
    step = os.path.join(ckpt, "ram", "step_8")
    files = set(os.listdir(step))
    assert {"commit.json", "manifest.host0.json",
            "manifest.host1.json"} <= files
    with open(os.path.join(step, "manifest.json")) as f:
        man = json.load(f)
    assert man["coordinated"]["process_count"] == 2
    split = [e for e in man["leaves"] if len(e["segments"]) == 2]
    assert split and all(e["encoding"] == "segmented"
                         for e in man["leaves"])
    assert {s["host"] for e in split for s in e["segments"]} == {0, 1}

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_PROCESS")}
    p = subprocess.Popen(
        [sys.executable, "-c", _PROG] + ARGS
        + ["--steps", "12", "--ckpt-dir", ckpt, "--resume"],
        env=dict(env, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
            [os.path.join(os.path.dirname(__file__), "..", "src")]
            + env.get("PYTHONPATH", "").split(os.pathsep))),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out, err = p.communicate(timeout=600)
    assert p.returncode == 0, (out, err)
    assert "resumed from step 8" in out
    resumed = _losses(out)

    straight = launch.main(ARGS + ["--steps", "12", "--ckpt-dir",
                                   str(tmp_path / "straight")])
    np.testing.assert_allclose(first[0], straight, rtol=1e-6)
    assert len(resumed) == 4
    np.testing.assert_allclose(resumed, first[0][8:], rtol=1e-5,
                               err_msg="resume diverged from straight run")
