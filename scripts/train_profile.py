"""Where the training path's time goes on one NVIDIA GPU.

    python3 scripts/train_profile.py [--out build/train_profile]

The training phase of ``chip_smoke.py`` (recurrentgemma-2b at full width,
12 layers, B=2, T=1024, seeded random weights, AdamW with the launcher's
``--preset full`` settings), profiled: ``torch.profiler`` over one warm
train step and over one scrutiny of the state (device time by kernel, and
the device's busy share of the wall time), the scrutinized save's stage
breakdown, and ``cProfile`` of the host side of the scrutinized and the
full restore.  It prints the summaries; the full tables go under
``--out``.  It needs one card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
import io
import os
import pstats
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
sys.path.insert(0, HERE)

from repro_torch import (CheckpointManager, Level,  # noqa: E402
                         get_config, scrutinize)
from repro_torch.data import pipeline as data_pipeline  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.train.optim import OptConfig  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from serve_profile import profiled  # noqa: E402

LAYERS, B, T = 12, 2, 1024


def host_profile(fn, tag: str, out: str):
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    res = fn()
    torch.cuda.synchronize()
    pr.disable()
    print(f"{tag}: wall {time.perf_counter() - t0:.4f} s")
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("tottime").print_stats(20)
    with open(os.path.join(out, f"{tag}.txt"), "w") as f:
        f.write(s.getvalue())
    print("\n".join(s.getvalue().splitlines()[:26]))
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/train_profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("train_profile: no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"),
                              n_layers=LAYERS)
    oc = OptConfig(kind="adamw", lr=3e-4, warmup=100, clip_norm=1.0,
                   decay_steps=5)
    state = launch.build_state(cfg, oc, B, T, seed=2028, device="cuda")
    step_fn = make_train_step(cfg, oc)

    def step():
        batch, state["data"] = data_pipeline.next_batch(cfg, state["data"])
        state["params"], state["opt"], metrics = step_fn(
            state["params"], state["opt"], batch)
        return metrics["loss"]

    step()                                        # warm-up
    profiled(step, "train_step", args.out)
    resume = launch.make_resume_fn(cfg)
    scrutinize(resume, state, device="cuda")     # warm-up
    rep = profiled(lambda: scrutinize(resume, state, device="cuda"),
                   "scrutiny", args.out)
    with tempfile.TemporaryDirectory(prefix="train_profile_") as root:
        for tag, report in (("scrutinized", rep), ("full", None)):
            d = os.path.join(root, tag)
            with CheckpointManager([Level(d, keep_n=1)],
                                   scrutiny_fn=lambda s, r=report: r,
                                   device="cuda") as mgr:
                t0 = time.perf_counter()
                mgr.save(1, state, block=True)
                print(f"{tag} save: wall {time.perf_counter() - t0:.4f} s, "
                      f"blocked_s {mgr.last_save_stats['blocked_s']:.4f}, "
                      f"stages {dict(mgr.last_save_stats['stages'])}")
            with CheckpointManager([Level(d, keep_n=1)],
                                   device="cuda") as mgr:
                restored = host_profile(lambda: mgr.restore(state),
                                        f"restore_{tag}", args.out)
            del restored
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
