"""Rematerialization's time and memory on the card: one training step's
loss and gradients, and the whole step, with remat off, "full" and "dots"
(needs one CUDA device).

    python3 scripts/remat_memory.py [--src DIR] [--arch recurrentgemma-2b]
        [--shapes 12x2x1024,12x4x2048,12x8x2048] [--reps 3]

For each shape (layers x B x T) the script builds the training state that
``chip_smoke.py``'s training phase builds (the architecture at its
published widths, depth cut to ``layers``, f32 parameters from seed 2028,
AdamW with the launcher's ``--preset full`` settings) and one batch of the
data pipeline.  Then, for each mode, it calls ``train.step.loss_and_grads``
once apart (a process's first checkpointed call imports ``torch._dynamo``)
and ``--reps`` times more, and the train step (``make_train_step``: loss,
gradients, clipping, AdamW) ``--reps`` times: the median ms of each and the
peak of allocated device memory over its calls, the training state
included.  A mode that runs out of memory is reported as ``"oom"``; the
losses of the modes that ran are checked equal.  The card's name and power
limit come first, one JSON line a shape after.

``--src`` names the ``src`` directory whose ``repro_torch`` is measured
(by default this checkout's), so that one call can measure two trees.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import torch

MODES = ("off", "full", "dots")


def _ms(fn, reps):
    """The median ms of ``reps`` synchronized calls, and the last result."""
    times = []
    for _ in range(reps):
        out = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], out


def _run(mode, fn, r, key):
    """``fn`` under remat ``mode`` into ``r``; False if it ran out."""
    if "oom" in r:
        return False
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r[key + "_ms"], out = fn()
        r[key + "_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out
    except torch.OutOfMemoryError:
        r["oom"] = key
        return False


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(here, "..", "src"))
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--shapes", default="12x2x1024,12x4x2048,12x8x2048")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("remat_memory: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import get_config
    from repro_torch.data import pipeline as dp
    from repro_torch.launch import train as launch
    from repro_torch.models import model
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import loss_and_grads, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for shape in args.shapes.split(","):
        layers, B, T = (int(x) for x in shape.split("x"))
        cfg = dataclasses.replace(get_config(args.arch), n_layers=layers)
        oc = OptConfig(kind="adamw", lr=3e-4, warmup=100, clip_norm=1.0,
                       decay_steps=10)
        gc.collect()
        torch.cuda.empty_cache()
        state = launch.build_state(cfg, oc, B, T, seed=2028, device="cuda")
        batch, _ = dp.next_batch(cfg, state["data"])
        row = {"src": os.path.abspath(args.src), "arch": args.arch,
               "layers": layers, "B": B, "T": T,
               "state_gib": sum(t.numel() * t.element_size() for t in
                                _leaves(state)) / 2 ** 30}
        losses, rows = {}, {m: {} for m in MODES}

        def remat(mode):
            model.set_remat_policy("dots" if mode == "off" else mode)
            return dataclasses.replace(cfg, remat=mode != "off")

        for mode in MODES:          # the loss and gradients, state unchanged
            c, r = remat(mode), rows[mode]

            def grads():
                t0 = time.perf_counter()
                loss_and_grads(c, state["params"], batch)
                torch.cuda.synchronize()
                r["first_ms"] = (time.perf_counter() - t0) * 1e3
                return _ms(lambda: loss_and_grads(c, state["params"],
                                                  batch)[0], args.reps)

            loss = _run(mode, grads, r, "grads")
            if loss is not False:
                losses[mode] = float(loss)
        for mode in MODES:          # the whole step, which moves the state
            c = remat(mode)
            step = make_train_step(c, oc)
            _run(mode, lambda: _ms(lambda: step(state["params"],
                                                state["opt"], batch),
                                   args.reps), rows[mode], "step")
        row.update(rows)
        model.set_remat_policy("dots")
        row["losses_equal"] = len(set(losses.values())) <= 1
        print(json.dumps(row), flush=True)
        del state, batch


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


if __name__ == "__main__":
    main()
