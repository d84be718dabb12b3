"""The comparisons that decide ``correct``: what the timed path produced,
held against the plain reference once the window has closed.

Numbers, each against the cell's limit (``portbench/limits/<cell>.json``):

- ``mask_mismatch``: elements whose mask, in a seeded sample of the timed
  re-scrutinies (and the last), differs from the reference's.  The
  reference's read set of ``resume_fn(h)`` probed at position P: a decode
  step at position p writes slot p and then reads slots <= p, so the state's
  cache slots < P are read and the rest are not; integer leaves are always
  critical.  Exact: limit 0.
- ``durable_mismatch``: in a seeded sample of the timed snapshots (and the
  last), read back from disk by ``reference/store.py``: stored mask
  elements that differ from the reference's, plus critical elements whose
  stored bits differ from the state the snapshot was taken of.  Exact.
- ``restore_mismatch``: in a seeded sample of the timed restores (and the
  last): elements of the restored tensors that differ from the saved state
  where the reference's mask is set, or from the fill (0) where it is not.
  Exact.
- ``logit_gap``: over every token served in the window's first episode,
  the widest gap by which the float32 reference's logit of the served
  token lies below its best (``reference/model.py``).
- ``gaps_over_<t>``: the number of those tokens whose gap exceeds ``t``,
  for a cell whose widest gap does not separate the program from its
  control (PERF.md says which and why); one wrong token adds one.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from portbench.reference import model as ref_model
from portbench.reference import store as ref_store


def _bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """``np.packbits`` bytes → n bools (element 8k: byte k's top bit)."""
    shifts = torch.arange(7, -1, -1, device=words.device, dtype=torch.uint8)
    return ((words[:, None] >> shifts) & 1).reshape(-1)[:n].bool()


def slot_mask(shape, crit: int, device) -> torch.Tensor:
    """The reference's mask of a cache leaf (L, B, S, K, D): slots < crit."""
    slots = torch.arange(shape[2], device=device) < crit
    return slots.view(1, 1, -1, *([1] * (len(shape) - 3))).expand(shape)


def mask_mismatch(masks, cache_shapes: Dict[str, tuple]) -> int:
    bad = 0
    for m in masks:
        for name, (words, all_critical) in m["words"].items():
            if name in cache_shapes:
                shape = cache_shapes[name]
                n = int(np.prod(shape))
                got = _bits(words, n).view(shape)
                want = slot_mask(shape, m["probe"], words.device)
                bad += int((got != want).sum())
            elif not all_critical:
                bad += 1
    return bad


def _as_bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's elements as integers of their width, for exact equality."""
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(view[t.element_size()])


def durable_mismatch(root: str, snapshots) -> int:
    from repro_torch import _tree
    bad = 0
    for snap in snapshots:
        stored = ref_store.read_step(root, snap["step"])
        leaves = dict(_tree.flatten_with_names(snap["state"])[0])
        if set(stored) != set(leaves):
            bad += 1
        for name, leaf in leaves.items():
            if name not in stored:
                continue
            shape, _, mask, payload = stored[name]
            want_bits = _as_bits(leaf).reshape(-1)
            if name.startswith("cache/"):
                want = slot_mask(tuple(shape), snap["crit"], leaf.device)
                want = want.reshape(-1)
                got = (torch.ones_like(want) if mask is None else
                       torch.from_numpy(mask).to(leaf.device))
                bad += int((got != want).sum())
                want_bits = want_bits[want]
            raw = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
            got_bits = _as_bits(raw.to(leaf.device).view(leaf.dtype))
            if got_bits.numel() != want_bits.numel():
                bad += abs(got_bits.numel() - want_bits.numel())
                k = min(got_bits.numel(), want_bits.numel())
                got_bits, want_bits = got_bits[:k], want_bits[:k]
            bad += int((got_bits != want_bits).sum())
    return bad


def restore_mismatch(restored, saved, crit: int) -> int:
    from repro_torch import _tree
    want = dict(_tree.flatten_with_names(saved)[0])
    bad = 0
    for out in restored:
        got = dict(_tree.flatten_with_names(out)[0])
        if set(got) != set(want):
            bad += 1
        for name, w in want.items():
            g = got.get(name)
            if g is None or g.shape != w.shape or g.dtype != w.dtype:
                bad += w.numel()
                continue
            gb, wb = _as_bits(g), _as_bits(w)
            if name.startswith("cache/"):
                m = slot_mask(tuple(w.shape), crit, w.device)
                wb = torch.where(m, wb, torch.zeros_like(wb))
            bad += int((gb != wb).sum())
    return bad


def fp8_state(state):
    """The control of a restore: the state as a store that keeps its cache
    in float8 e4m3 (one step below the cache's bfloat16) would give it
    back."""
    from repro_torch import _tree
    named, treedef = _tree.flatten_with_names(state)
    return _tree.unflatten(treedef, [
        ref_model.fp8_round(t.float()).to(t.dtype)
        if n.startswith("cache/") else t for n, t in named])


def served_gap_numbers(config: dict, params: Dict[str, torch.Tensor],
                       prompts: torch.Tensor, served: torch.Tensor,
                       quant: Optional[str] = None,
                       thresholds=()) -> Dict[str, float]:
    """``logit_gap``, the widest gap over the served tokens, and
    ``gaps_over_<t>``, the count of gaps above each threshold ``t``."""
    with torch.no_grad():
        gaps = ref_model.served_gaps(config, params, prompts, served, quant)
    out = {"logit_gap": float(gaps.max())}
    for t in thresholds:
        out[f"gaps_over_{t}"] = int((gaps > float(t)).sum())
    return out


def gap_thresholds(limits: Dict[str, float]):
    """The thresholds ``t`` of a cell's ``gaps_over_<t>`` limits."""
    return tuple(k[len("gaps_over_"):] for k in limits
                 if k.startswith("gaps_over_"))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} of every number the cell compares; every
    limit has to have its number."""
    missing = set(limits) - set(numbers)
    if missing:
        raise ValueError(f"no reading for the limits {sorted(missing)}")
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
