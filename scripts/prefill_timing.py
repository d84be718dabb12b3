"""The serving prefill's time on the card, cold and warm (needs one CUDA
device).

    python3 scripts/prefill_timing.py [--src DIR] [--reps 20]

Builds the serving engine that ``chip_smoke.py``'s serving phase builds
(phi4-mini-3.8b at full width, random weights from seed 2027, B=4, T=1024,
max_len 2048) and times ``Engine.prefill`` of the same prompt ``--reps`` + 1
times, each call synchronized on both sides: the first call of the process
(``first_s``: what ``chip_smoke.py`` reports as ``prefill_s``, one-time
set-up included) and then ``--reps`` calls on a warm process (``warm_s``,
with their median and minimum).  A cost that every call pays shows in the
warm calls; one paid once shows only in the first.  The card's name and
power limit come first.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that one call can time two trees.  Its
kernels are built into that tree's ``build/`` at first use.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ARCH = "phi4-mini-3.8b"
B, T, MAX_LEN = 4, 1024, 2048


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(here, "..", "src"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("prefill_timing: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import Engine, get_config
    from repro_torch.models import init_params

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2027)
    params = init_params(cfg, gen)
    eng = Engine(cfg, params, MAX_LEN, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=gen,
                                     device=dev, dtype=torch.int32)}
    times = []
    for _ in range(args.reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    warm = sorted(times[1:])
    print(json.dumps({"src": os.path.abspath(args.src), "arch": ARCH,
                      "first_s": times[0], "warm_s": times[1:],
                      "warm_median_s": warm[len(warm) // 2],
                      "warm_min_s": warm[0]}))


if __name__ == "__main__":
    main()
