"""A hybrid model's serving state, restored: prefill, ``decode_first``
decode steps, a scrutiny of ``resume_fn(horizon)`` at pos + ``headroom``,
then a base and ``deltas`` deltas ``steps_between`` decode steps apart in
set-up; the window restores the newest step into fresh tensors on the card
over and over (repeated reads come from the page cache) and times each
restore.

The state holds leaves of two kinds, told apart by name:

- position-indexed, the attention layers' KV cache (``.../k``, ``.../v``,
  (L, B, S, K, D)): a decode step at position p writes slot p and reads
  slots <= p, so the slots below the probe are critical and the rest are
  not; stored as a region table, scattered by K4;
- whole, the Mamba-2 layers' SSM state and conv history (``.../ssm``,
  ``.../conv``) and ``pos``, ``tokens``: the next decode step reads each
  element, so all of it is critical; stored ``full``, every delta carries
  the recurrent state whole, and the restore expands it on the host.

The judge holds the restored tensors to that mask (``restore_mismatch``,
exact) and what was served to ``reference/hybrid.py``, at every position
of the first episode that chose a served token (the prompt's last, each
decode step's):

- ``logit_rms``: over those positions, the median of the distance of the
  program's logits from the float32 reference's, relative to the spread
  of the reference's (the norm of its logits less their mean); the limit
  sits between the program's readings and the control's (the reference
  with its products in float8 e4m3);
- ``served_mismatch``: served tokens that are not the greedy choice of
  the logits the program computed for them; exact;
- reported beside them, with no limit: ``served_gap``, the widest gap of
  a served token's logit below the reference's best.  Under the
  benchmark's seeded weights this model's greedy tokens mostly lead by a
  wide margin (the embedding times 12 and a tied head favour the token
  just read): the program reads 0 on most seeds, yet a near tie flips
  now and then in bfloat16, and the control reads 0 on some seeds, so no
  limit sits between the two.
"""

from __future__ import annotations

import json
import os

import torch

from portbench import judge as J
from portbench.loops.snapshot import _manager
from portbench.metrics import arith
from portbench.reference import hybrid
from portbench.serving import Reservoir

POSITIONAL = ("k", "v")          # cache leaves indexed by slot on axis 2
WHOLE = ("ssm", "conv")          # cache leaves read whole


def kind(name: str) -> str:
    """'slots' or 'whole' by the leaf's name; anything else raises."""
    if not name.startswith("cache/"):
        return "whole"
    last = name.rsplit("/", 1)[-1]
    if last in POSITIONAL:
        return "slots"
    if last in WHOLE:
        return "whole"
    raise ValueError(f"leaf {name}: no kind for a hybrid state's leaf")


def _encodings(root: str, step: int) -> dict:
    """{leaf: stored encoding} of the base a step's chain starts from."""
    def manifest(s):
        with open(os.path.join(root, f"step_{s}", "manifest.json")) as f:
            return json.load(f)
    chain = (manifest(step).get("chain") or {}).get("delta_chain") or [step]
    return {e["name"]: e["encoding"]
            for e in manifest(int(chain[0]))["leaves"]}


def run(host, window, root, keep: int = 2) -> dict:
    from portbench.reference.store import chain_of, step_bytes
    from repro_torch import _tree
    tr = host.traffic
    logits = _serve(host, tr["decode_first"])
    crit = host.pos + tr["headroom"]
    rep = host.scrutinize(crit)
    mgr = _manager(host, root, rep, tr["deltas"], keep_n=tr["deltas"] + 2)
    mgr.save(0, host.state, block=True)
    for step in range(1, tr["deltas"] + 1):
        logits += _serve(host, tr["steps_between"], start=False)
        mgr.save(step, host.state, block=True)
    saved, newest = host.state, tr["deltas"]
    named, treedef = _tree.flatten_with_names(saved)
    window.counts["stored_bytes"] = step_bytes(root, chain_of(root, newest))
    window.counts["state_bytes"] = host.state_bytes()
    stored = _encodings(root, newest)
    k4 = 0
    for name, t in named:
        if stored[name] not in ("regions", "bitmap"):
            continue                    # full: restore.expand, not K4
        crit_n = (t.numel() * crit // t.shape[2] if kind(name) == "slots"
                  else t.numel())
        k4 += arith.scatter_bytes(t.numel(), crit_n, t.element_size())
    kept = Reservoir(keep, host.rng)
    # what restore() is handed for the shapes: ones, not the saved state,
    # so a restore that hands it back shows
    like = _tree.unflatten(treedef, [torch.ones_like(t) for _, t in named])

    def once() -> None:
        with window.op("restore", host.device) as op:
            step, out = mgr.restore(like)
            op.record("restore", mgr.last_restore_stats)
        if step != newest:
            raise RuntimeError(f"restored step {step}, not {newest}")
        if window.started is None:
            return
        window.add("work", "k4_bytes", k4)
        window.add("work", "restore_bytes",
                   k4 + mgr.last_restore_stats["h2d_bytes"])
        kept.offer(out)

    once()                                          # warm
    window.open()
    while window.is_open():
        once()
    mgr.close()
    return {"restored": kept.sample(), "saved": saved, "crit": crit,
            "host": host, "logits": torch.stack(logits, dim=1)}


def _serve(host, steps: int, start: bool = True) -> list:
    """``host.start()`` (when ``start``) and ``host.decode(steps)`` of the
    first episode, keeping the logits (B, V) of each token served."""
    out = []
    if start:
        out_logits, host.state = host.engine.prefill(
            {"tokens": host.prompts})
        host.pos = host.prompts.shape[1]
        host.episodes += 1
        host.served.append(host.state["tokens"][:, 0])
        out.append(out_logits.float())
    for _ in range(steps):
        out_logits, host.state = host.engine.decode(host.state)
        host.pos += 1
        host.served.append(host.state["tokens"][:, 0])
        out.append(out_logits.float())
    return out


def restore_mismatch(restored, saved, crit: int) -> dict:
    """{leaf: elements of the restored tensors that differ from the saved
    state where the mask by kind is set, or from the fill (0) where it is
    not}, the leaves with any; a missing or extra leaf counts under its
    name whole."""
    from repro_torch import _tree
    want = dict(_tree.flatten_with_names(saved)[0])
    bad: dict = {}
    for out in restored:
        got = dict(_tree.flatten_with_names(out)[0])
        for name in set(got) - set(want):
            bad[name] = bad.get(name, 0) + got[name].numel()
        for name, w in want.items():
            g = got.get(name)
            if g is None or g.shape != w.shape or g.dtype != w.dtype:
                n = w.numel()
            else:
                gb, wb = J._as_bits(g), J._as_bits(w)
                if kind(name) == "slots":
                    m = J.slot_mask(tuple(w.shape), crit, w.device)
                    wb = torch.where(m, wb, torch.zeros_like(wb))
                n = int((gb != wb).sum())
            if n:
                bad[name] = bad.get(name, 0) + n
    return bad


def _served_numbers(ref, logits, tokens) -> dict:
    """``logit_rms`` of ``logits`` (B, N, V) and ``served_gap`` of
    ``tokens`` (B, N) against the reference's logits ``ref``, and
    ``served_mismatch``: tokens that are not ``logits``' greedy choice."""
    chosen = ref.gather(-1, tokens.long()[..., None])[..., 0]
    gap = ref.max(-1).values - chosen
    spread = (ref - ref.mean(-1, keepdim=True)).norm(dim=-1)
    rel = (logits - ref).norm(dim=-1) / spread
    return {"logit_rms": float(rel.median()),
            "served_gap": float(gap.max()),
            "served_mismatch": int((logits.argmax(-1) != tokens).sum())}


def judge(kept: dict, control: bool):
    host = kept["host"]
    served = host.served_tokens()
    args = (host.config, host.named, host.prompts, served)
    with torch.no_grad():
        ref = hybrid.served_logits(*args)
        bad = restore_mismatch(kept["restored"], kept["saved"], kept["crit"])
        numbers = {"restore_mismatch": sum(bad.values()),
                   "restore_mismatch_leaves": bad,
                   **_served_numbers(ref, kept["logits"], served)}
        controls = {}
        if control:
            fp8 = hybrid.served_logits(*args, quant="fp8")
            bad = restore_mismatch([J.fp8_state(kept["saved"])],
                                   kept["saved"], kept["crit"])
            controls = {"restore_mismatch": sum(bad.values()),
                        **_served_numbers(ref, fp8, fp8.argmax(-1))}
    return numbers, controls
