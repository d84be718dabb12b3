"""How bf16 rounding shows in the scrutiny of a training state.

    python3 scripts/train_bf16_masks.py [--layers 3] [--device cuda]

recurrentgemma-2b at full width (vocab 256,000, tied embedding), the given
number of layers, f32 parameters made from seed 2028, B=2, T=1024 (two
loss chunks of 512).  The AD scrutiny of the next step's loss, with the
default three probes, once with the loss in bf16 (the config's compute
dtype) and once in f32 (``launch.train.make_resume_fn``).  For each it
prints every parameter leaf that is not all critical, with its count of
uncritical elements: every parameter is read by the loss, so each such
element is a numerical zero of the gradient, not a structural one.  In
bf16 the tied embedding's gradient sums one bf16 product per loss chunk,
and two exact negatives cancel.  Needs a card.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import get_config, scrutinize  # noqa: E402
from repro_torch.data import pipeline as data_pipeline  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.train.optim import OptConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"),
                              n_layers=args.layers)
    state = launch.build_state(cfg, OptConfig(), 2, 1024, seed=2028,
                               device=args.device)

    def resume_bf16(s):
        batch, _ = data_pipeline.next_batch(cfg, s["data"])
        return {"loss": loss_fn(cfg, s["params"], batch)}

    for tag, fn in (("bf16", resume_bf16),
                    ("f32", launch.make_resume_fn(cfg))):
        rep = scrutinize(fn, state, device=args.device)
        bad = {n: l.total - l.critical for n, l in rep.leaves.items()
               if n.startswith("params/") and not l.all_critical}
        total = sum(l.total for n, l in rep.leaves.items()
                    if n.startswith("params/"))
        print(f"{tag} loss: {sum(bad.values())} of {total} parameter "
              f"elements uncritical; by leaf {bad}")
        del rep


if __name__ == "__main__":
    main()
