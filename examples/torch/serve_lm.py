"""Serving demo on the PyTorch port: batched decode with a scrutinized
engine-state checkpoint.

Mid-stream, the AD scrutiny proves the KV-cache suffix beyond the current
position uncritical, so the serving checkpoint shrinks accordingly.

    PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import os
import shutil
import tempfile

import torch

from repro_torch import Engine, get_config, save_checkpoint, scrutinize
from repro_torch.models import init_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    cfg = get_config("phi4-mini-3.8b").reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen)
    eng = Engine(cfg, params, max_len=64, device=dev)

    prompts = torch.randint(0, cfg.vocab, (4, 12), generator=gen,
                            device=dev, dtype=torch.int32)
    toks, state, _ = eng.generate({"tokens": prompts}, 6)
    print("generated token ids:\n", toks.cpu().numpy())

    # scrutinize the engine state for checkpointing mid-stream.  The cache
    # mask is value-level (masked slots get exactly-zero softmax weight), so
    # the AD engine, the paper's own method, is the sharp tool here;
    # participation() would conservatively call every read slot critical.
    rep = scrutinize(eng.resume_fn(4), state, device=dev)
    total = rep.total_elements
    print(f"\nengine-state scrutiny at pos={int(state['pos'])}: "
          f"{rep.uncritical_elements}/{total} elements uncritical "
          f"({100 * rep.uncritical_rate:.1f}%)")
    for name, leaf in sorted(rep.leaves.items()):
        if leaf.uncritical:
            print(f"  {name}: {leaf.uncritical}/{leaf.total} dropped")

    d = tempfile.mkdtemp()
    try:
        full = save_checkpoint(os.path.join(d, "full"), 0, state)
        red = save_checkpoint(os.path.join(d, "red"), 0, state, report=rep)

        def size(p):
            return sum(os.path.getsize(os.path.join(p, f))
                       for f in os.listdir(p))

        print(f"\nserving checkpoint: full={size(full) / 1e3:.0f} kB "
              f"reduced={size(red) / 1e3:.0f} kB "
              f"({100 * (1 - size(red) / size(full)):.0f}% saved)")
    finally:
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
