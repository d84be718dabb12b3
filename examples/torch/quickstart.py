"""Quickstart on the PyTorch port: scrutinize a checkpoint, drop the dead
weight, restart.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch import (load_checkpoint, participation, restore_state,
                         save_checkpoint, scrutinize)
from repro_torch.core.report import (render_distribution, storage_table,
                                     summary_table)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    # A toy "application state": a padded field (the paper's BT-style u) and
    # a loop counter.  Only the 12×12 interior of the 13×13 field is read.
    rng = np.random.RandomState(0)
    state = {
        "u": torch.tensor(rng.randn(13, 13), dtype=torch.float32,
                          device=dev),
        "step": torch.tensor(3, dtype=torch.int32, device=dev),
    }

    def resume(s):
        """The rest of the program: 3 more stencil sweeps + a norm."""
        u = s["u"]
        for _ in range(3):
            core = u[:12, :12]
            lap = (torch.roll(core, 1, 0) + torch.roll(core, -1, 0)
                   + torch.roll(core, 1, 1) + torch.roll(core, -1, 1)
                   - 4 * core)
            u = torch.cat([torch.cat([core + 0.1 * lap, u[:12, 12:]], 1),
                           u[12:]], 0)
        return {"norm": torch.sqrt((u[:12, :12] ** 2).sum())}

    # 1. the paper's AD analysis (+ the structural participation engine)
    rep_ad = scrutinize(resume, state, device=dev)
    rep_part = participation(resume, state, device=dev)
    print(summary_table(rep_ad, title="AD (vjp) criticality"))
    print()
    print("critical/uncritical map of u (# critical, . uncritical):")
    print(render_distribution(rep_part["u"].mask, (13, 13)))
    print()
    print(storage_table(rep_part, title="checkpoint storage"))

    # 2. write a reduced checkpoint, restore, verify the output matches
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, step=3, state=state, report=rep_part)
        _, leaves = load_checkpoint(d, fill=0.0)   # uncritical -> 0
        restored = restore_state(state, leaves, device=dev)
        out_full = float(resume(state)["norm"])
        out_restored = float(resume(restored)["norm"])
        print(f"\nrestart check: full={out_full:.6f} "
              f"reduced={out_restored:.6f} "
              f"match={np.allclose(out_full, out_restored)}")


if __name__ == "__main__":
    main()
