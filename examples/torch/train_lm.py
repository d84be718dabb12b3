"""End-to-end run on the PyTorch port: train a (reduced) LM with
scrutinized async checkpointing, crash it, and resume.

    PYTHONPATH=src python examples/torch/train_lm.py [--device cpu]
        [--steps 40] [--more 20]

Drives ``repro_torch.launch.train``; runs on the card unless
``--device cpu`` is given.
"""

import argparse
import shutil
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--more", type=int, default=20)
    args = ap.parse_args(argv)
    every = max(1, args.steps // 4)
    common = ["--arch", "phi4-mini-3.8b", "--task", "copy", "--batch", "8",
              "--seq", "64", "--ckpt-every", str(every), "--scrutinize",
              "--device", args.device]
    d = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        print(f"== phase 1: train {args.steps} steps, checkpoints every "
              f"{every} ==")
        train_main(common + ["--steps", str(args.steps), "--ckpt-dir", d])
        total = args.steps + args.more
        print(f"\n== phase 2: 'crash' and resume to {total} ==")
        resumed = train_main(common + ["--steps", str(total),
                                       "--ckpt-dir", d, "--resume"])
        print(f"\nresumed from step {args.steps}; continued losses: "
              f"{[round(l, 3) for l in resumed[:3]]} ...")
    finally:
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
