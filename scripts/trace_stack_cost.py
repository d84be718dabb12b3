"""What recording stack traces costs participation's trace (CPU).

    python3 scripts/trace_stack_cost.py [--program mg] [--runs 5]

``criticality.traced_step`` traces with ``make_fx`` through
``torch.func.functionalize``; ``make_fx(record_stack_traces=True)`` would
give each node of the graph the line of the program that made it, which
the static analyzer's ``ReaderRecord.source`` would then name.  This
script times ``Benchmark.participation()`` of one NPB program on the CPU
(one intra-op thread), each run in a fresh process so that every run
pays the trace, alternating without and with stack traces, and prints
each run and the medians.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

_CHILD = r"""
import sys, time
import torch
torch.set_num_threads(1)
from torch.fx.experimental.proxy_tensor import make_fx
from repro_torch import _tree
import repro_torch.core.criticality as C
from repro_torch.npb import get_benchmark

record = sys.argv[2] == "1"


def _trace(fn, treedef, leaves):
    def flat_fn(*ls):
        return tuple(_tree.leaves(fn(_tree.unflatten(treedef, list(ls)))))

    with torch.no_grad():
        return make_fx(torch.func.functionalize(flat_fn),
                       tracing_mode="real",
                       record_stack_traces=record)(*leaves)


C._trace = _trace
bench = get_benchmark(sys.argv[1], device="cpu")
t0 = time.perf_counter()
bench.participation()
print(time.perf_counter() - t0)
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--program", default="mg")
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    times = {False: [], True: []}
    for _ in range(args.runs):
        for record in (False, True):
            out = subprocess.run(
                [sys.executable, "-c", _CHILD, args.program,
                 "1" if record else "0"],
                env=env, check=True, capture_output=True, text=True).stdout
            times[record].append(float(out.strip().splitlines()[-1]))
            print(f"{args.program} participation_s record_stack_traces="
                  f"{record}: {times[record][-1]:.3f}", flush=True)
    off, on = (float(np.median(times[r])) for r in (False, True))
    print(f"median without {off:.3f} s, with {on:.3f} s: "
          f"{on / off - 1:+.1%}")


if __name__ == "__main__":
    main()
