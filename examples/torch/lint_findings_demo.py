"""Checkpoint-safety linter walk-through on the PyTorch port: every rule
firing on purpose.

    PYTHONPATH=src python examples/torch/lint_findings_demo.py [--device cpu]

Builds a deliberately hazardous toy setup and shows both linter passes:

* the **aten-graph pass** (``lint_step``): traces the step fn into an aten
  graph and flags state the restart will miss (CKPT001), checkpointed
  bytes that are statically dead (CKPT002), and randomness with no saved
  generator state (CKPT003);
* the **AST pass** (``lint_file``): scans manager call sites for a write
  on another stream racing a pipelined save (CKPT101), undrained saves
  (CKPT102), and generators that never reach ``save()`` (CKPT103).  The
  hazardous code lives in a string below, so linting this *file* stays
  clean.

The same findings are available machine-readably (``findings_json``).
Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import json

import torch

from repro_torch.analysis import findings_json, lint_file, lint_step


def step(s):
    """One 'train step': reads w and step; scratch is overwritten before
    any read, so its checkpointed value is statically dead."""
    scratch = s["w"][:4] * 2.0
    noise = torch.randn_like(s["w"]) * 1e-3
    shift = s["step"].to(torch.float32)
    return {"loss": ((s["w"] + noise + shift) ** 2).sum() + scratch.sum()}


HAZARDOUS_TRAINER = '''
import torch
side = torch.cuda.Stream()
gen = torch.Generator(device="cuda").manual_seed(0)
for i in range(steps):
    mgr.save(i, {"params": params}, block=False)
    with torch.cuda.stream(side):
        params["w"].add_(torch.randn(params["w"].shape, generator=gen))
# no mgr.wait()/close(): in-flight writes race process exit
'''


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    state = {
        "w": torch.arange(8, dtype=torch.float32, device=dev),
        "scratch": torch.zeros(4, dtype=torch.float32, device=dev),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    # the pytree actually handed to manager.save: note it drops "step"
    checkpoint_state = {"w": state["w"], "scratch": state["scratch"]}

    print("== aten-graph pass: lint_step(step, state, checkpoint_state) ==")
    graph_findings = lint_step(step, state, checkpoint_state, device=dev)
    for f in graph_findings:
        print(f)
        if f.details.get("readers"):
            print("        readers:", f.details["readers"][0])
    # Expected: CKPT001 (error)  'step' is read but not checkpointed
    #           CKPT002 (warn)   'scratch' is saved but statically dead
    #           CKPT003 (warn)   randomness consumed, no key-like leaf saved

    print("\n== AST pass: lint_file on a hazardous trainer ==")
    for f in lint_file("hazardous_trainer.py", HAZARDOUS_TRAINER):
        print(f)
    # Expected: CKPT101 (error)  a side-stream write beside block=False
    #           CKPT102 (warn)   saves never drained
    #           CKPT103 (warn)   'gen' drawn from every step but never saved

    print("\n== machine-readable ==")
    print(json.dumps(findings_json(graph_findings), indent=2)[:400], "...")


if __name__ == "__main__":
    main()
