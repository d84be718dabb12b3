"""Where the serving path's time goes on one NVIDIA GPU.

    python3 scripts/serve_profile.py [--out build/serve_profile]

The serving phase of ``chip_smoke.py`` (phi4-mini-3.8b at full width and
depth, B=4 prompts of 1024 tokens, max_len 2048, seeded random weights),
profiled: ``torch.profiler`` over one prefill and over three decode steps
(device time by kernel, and the device's busy share of the wall time),
one KV scrutiny, the save's stage breakdown, and ``cProfile`` of the
host side of one device restore.  It prints the summaries; the full tables go under
``--out``.  It needs one card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import (CheckpointManager, Engine, Level,  # noqa: E402
                         ScrutinyConfig, get_config, scrutinize)
from repro_torch.models import init_params  # noqa: E402

B, T, MAX_LEN = 4, 1024, 2048


def busy_share(prof, wall_s: float) -> float:
    """Summed device time of the kernels over the wall time (kernels on one
    stream do not overlap, so this is the device's busy share)."""
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return dev_us * 1e-6 / wall_s


def profiled(fn, tag: str, out: str):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    with open(os.path.join(out, f"{tag}.txt"), "w") as f:
        f.write(table)
    print(f"{tag}: wall {wall:.4f} s, device busy share "
          f"{busy_share(prof, wall):.3f}")
    print("\n".join(table.splitlines()[:14]))
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/serve_profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("serve_profile: no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = get_config("phi4-mini-3.8b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2027)
    eng = Engine(cfg, init_params(cfg, gen), MAX_LEN, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    state = eng.start(batch)                      # warm-up
    for _ in range(2):
        state, _ = eng.step(state)
    profiled(lambda: eng.prefill(batch), "prefill", args.out)

    def three_steps():
        s = state
        for _ in range(3):
            s, _ = eng.step(s)
        return s

    state = profiled(three_steps, "decode_3_steps", args.out)
    probe = dict(state, pos=torch.tensor(int(state["pos"]) + 2,
                                         dtype=torch.int32, device="cuda"))

    def scrutiny():
        return scrutinize(eng.resume_fn(2), probe,
                          config=ScrutinyConfig(probes=2), device="cuda")

    scrutiny()                                    # warm-up
    rep = profiled(scrutiny, "scrutiny", args.out)
    with tempfile.TemporaryDirectory(prefix="serve_profile_") as root:
        with CheckpointManager([Level(root, keep_n=2)],
                               scrutiny_fn=lambda s: rep, save_mode="device",
                               restore_mode="device", device="cuda") as mgr:
            mgr.save(1, state, block=True)
            print(f"save: {dict(mgr.last_save_stats['stages'])}")
            like = {"pos": state["pos"], "tokens": state["tokens"],
                    "cache": state["cache"]}
            pr = cProfile.Profile()
            t0 = time.perf_counter()
            pr.enable()
            mgr.restore(like)
            torch.cuda.synchronize()
            pr.disable()
            print(f"restore: wall {time.perf_counter() - t0:.4f} s")
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("tottime").print_stats(25)
    with open(os.path.join(args.out, "restore_host.txt"), "w") as f:
        f.write(s.getvalue())
    print("\n".join(s.getvalue().splitlines()[:34]))


if __name__ == "__main__":
    main()
