"""End-to-end training loop with scrutinized checkpointing and restart
(port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --steps 200 --batch 8 --seq 256 [--preset smoke] [--resume] \\
        [--scrutinize] [--coordinated] [--device cpu]

The loop wires the port's substrates together: the data pipeline
(resumable, its state checkpointed), the train step, the async multi-level
checkpoint manager with the AD-scrutinized reduction, and restart from
the newest complete checkpoint.  It runs on the card unless ``--device
cpu`` is given.

``--scrutinize`` reduces the checkpoints with participation analysis of
the reference's resume function, the next step's ``metrics["loss"]``, as
the reference does.  ``--verify-static`` scrutinizes with the AD engine
instead, its sweep pruned by the static analyzer
(``ScrutinyConfig(static_prune=True)``), and gates every report on the
AD ⊆ static soundness check (``analysis.soundness_checker``) before it
reduces a checkpoint.

The manager is always the ``CoordinatedCheckpointManager``, as in the
reference: a job of one process delegates its saves to the pipelined
``CheckpointManager``; a job of several (``REPRO_PROCESS_INDEX`` /
``REPRO_PROCESS_COUNT``, or an initialized ``torch.distributed`` group)
or ``--coordinated`` writes the coordinated format, each process its
owned shards, with the barriers over ``--coord-dir`` (default
``<ckpt-dir>/coord``).  ``--resume`` restores the newest committed step
whole on every process, whatever process count saved it (the elastic
restart).

``--preset smoke`` shrinks the model (``ArchConfig.reduced()``).  The MoE
archs (``--arch olmoe-1b-7b``, ``deepseek-v3-671b``) train with the aux
loss in their loss.  At full width olmoe-1b-7b's 6.92 B parameters are
110 GB with f32 gradients and AdamW moments, more than one card holds;
the compressed data-parallel step (``train/step.py``) does not shrink
that, since every replica keeps the parameters, the moments and an f32
error buffer whole.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch._tensors import resolve_device
from repro_torch.checkpoint import CoordinatedCheckpointManager, Level
from repro_torch.configs import get_config
from repro_torch.analysis import soundness_checker
from repro_torch.core import ScrutinyConfig, participation, scrutinize
from repro_torch.data import pipeline as data_pipeline
from repro_torch.distributed.collective import (current_context,
                                                get_collective)
from repro_torch.models import count_params, init_params, loss_fn
from repro_torch.train.optim import OptConfig, init_opt
from repro_torch.train.step import make_train_step


def build_state(cfg, oc, batch, seq, seed=0, *, device=None):
    """The training state on ``device`` (the card unless the caller asks
    for the CPU): parameters drawn from a generator seeded with ``seed``,
    the optimizer state, the data pipeline and the step."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen)
    return {"params": params, "opt": init_opt(oc, params),
            "data": data_pipeline.init_state(cfg, batch, seq, seed=seed,
                                             device=device),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_resume_fn(cfg):
    """'The rest of the program' after a training checkpoint, as the
    reference's launcher defines it (``launch/train.py:103-106``): the next
    step's ``metrics["loss"]``, the loss at the state's parameters on the
    data pipeline's next batch.  The step's update does not reach that
    output; XLA drops it from the reference's jitted step, and here it is
    not run, so the scrutiny's vjp holds no second-order graph.

    The loss runs in f32 whatever ``cfg.dtype`` is, as the serving
    engine's ``resume_fn`` runs its cache in f32: in bf16 the tied
    embedding's gradient sums one bf16 product per loss chunk, and where
    two are exact negatives an element that the loss reads comes out with
    a zero gradient in every probe (``scripts/train_bf16_masks.py``;
    ROADMAP Queue 3)."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def resume(s):
        # the batch next_batch pops; its refill does not reach the loss
        # (XLA drops it from the reference's step), and its generator's
        # seed is a host read that no traced step can hold
        batch = data_pipeline.peek_batch(cfg, s["data"])
        return {"loss": loss_fn(cfg32, s["params"], batch)}

    return resume


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    # not the reference launcher's default: a port run with --resume must
    # not pick up the step directories a reference run left there
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                        "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--scrutinize", action="store_true",
                    help="reduce checkpoints with participation analysis")
    ap.add_argument("--verify-static", action="store_true",
                    help="scrutinize with the AD probe engine, prune the "
                         "sweep with the static analyzer, and gate every "
                         "report on the AD⊆static soundness check")
    ap.add_argument("--coordinated", action="store_true",
                    help="write the coordinated (multi-host) checkpoint "
                         "format even on one process")
    ap.add_argument("--coord-dir", default=None,
                    help="shared rendezvous dir of the coordinated save "
                         "(default <ckpt-dir>/coord)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--task", default="lm", choices=["lm", "copy"],
                    help="lm: next-token; copy: identity (fast smoke signal)")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    smoke = args.preset == "smoke"
    if smoke:
        cfg = cfg.reduced()
    lr = args.lr if args.lr is not None else (3e-3 if smoke else 3e-4)
    oc = OptConfig(kind="adamw", lr=lr, warmup=5 if smoke else 100,
                   clip_norm=10.0 if smoke else 1.0, decay_steps=args.steps)
    step_fn = make_train_step(cfg, oc)

    state = build_state(cfg, oc, args.batch, args.seq, device=device)
    print(f"arch={cfg.name} params={count_params(state['params'])/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq} device={device}")

    scrutiny_fn = None
    soundness_check = None
    if args.scrutinize or args.verify_static:
        # one stable fn object, so the shared trace cache hits across
        # scrutiny, the static analyzer and the soundness gate
        resume = make_resume_fn(cfg)
        if args.verify_static:
            scfg = ScrutinyConfig(static_prune=True)

            def scrutiny_fn(s):
                return scrutinize(resume, s, config=scfg, device=device)

            soundness_check = soundness_checker(resume, device=device)
            print("static verification: soundness gate + probe-sweep "
                  "pruning enabled")
        else:
            def scrutiny_fn(s):
                return participation(resume, s, config=ScrutinyConfig(),
                                     device=device)

    # Coordinated when the job spans processes (the REPRO_PROCESS_*
    # simulation or a torch.distributed group); a single-process job
    # delegates to the pipelined manager inside, so the wiring is
    # unconditional, as in the reference.
    ctx = current_context()
    coordinated = args.coordinated or ctx.count > 1
    collective = get_collective(
        coord_dir=args.coord_dir or os.path.join(args.ckpt_dir, "coord"))
    parity = not coordinated             # per-host parity: a future level
    mgr = CoordinatedCheckpointManager(
        [Level(os.path.join(args.ckpt_dir, "ram"), interval=args.ckpt_every,
               keep_n=2),
         Level(os.path.join(args.ckpt_dir, "disk"),
               interval=args.ckpt_every * 4, keep_n=2, shards=2,
               parity=parity)],
        collective=collective, scrutiny_fn=scrutiny_fn,
        soundness_check=soundness_check,
        force_coordinated=args.coordinated, device=device)
    if coordinated:
        print(f"coordinated checkpointing: process {ctx.index} of "
              f"{ctx.count}")

    start = 0
    losses = []
    try:
        if args.resume:
            got = mgr.restore(state)
            if got is not None:
                start, state = got
                print(f"resumed from step {start}")

        t0 = time.time()
        for step in range(start + 1, args.steps + 1):
            batch, state["data"] = data_pipeline.next_batch(cfg,
                                                            state["data"])
            if args.task == "copy":
                batch = {"tokens": batch["tokens"],
                         "labels": batch["tokens"]}
            state["params"], state["opt"], metrics = step_fn(
                state["params"], state["opt"], batch)
            state["step"] = torch.tensor(step, dtype=torch.int32,
                                         device=device)
            losses.append(float(metrics["loss"]))
            if step % args.log_every == 0:
                dt = (time.time() - t0) / args.log_every
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f} ms/step")
                t0 = time.time()
            if step % args.ckpt_every == 0:
                mgr.save(step, state)
    finally:
        mgr.close()
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
