"""The controls of the cells' comparisons, and the program's readings
beside them, on several seeds in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Each seed runs the cell as ``run.py`` does (its set-up, a window of
``--seconds`` at the cell's own load, the judge) and then the control in
the program's place on the same inputs: for a served model, the reference
in float8 e4m3 (one step below the configuration's bfloat16) at each
position of the same prompts and served tokens, judged by the float32
reference's gap for the token it puts first; for a restore, the saved state
with its cache held in float8 e4m3.  One JSON line a seed: the program's
numbers, each with the cell's limit, and the control's.  The benchmark's
own runs never run it; the limits in ``limits/`` are set from its
readings.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    run._environment()
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in a.seeds:
        res = run.run_cell(a.workload, seed, a.seconds, False, control=True)
        print(json.dumps(dict(res["control"], workload=a.workload,
                              seed=seed, checks=res["checks"],
                              attempted=res["attempted"])), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
