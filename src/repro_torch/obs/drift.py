"""Criticality-drift tracker: how much do the masks move between sweeps?
(port of ``repro.obs.drift``)

Each time a new criticality report is computed the tracker diffs every
leaf's bitmask against the previous sweep's:

* **device reports** — the diff runs *on the words' device* over the
  bit-packed mask words (``words_dev``): bitwise XOR, then a 256-entry
  uint8 table of set-bit counts indexed by each byte (torch has no
  popcount), summed per leaf, with one batched D2H of every leaf's
  counts for the whole report.  Tail pad bits are zero in both operands
  so they never contribute.
* **host reports** — ``np.packbits`` + the same XOR/popcount in numpy
  (also the oracle the device path is tested against).
* **policy leaves** (no element mask, all-or-nothing) — a flip is the
  whole leaf changing its critical bit.

Per leaf it records the element **flip rate** (changed mask bits / n)
and **word churn** (packed 8-bit words containing ≥1 flip / total words).
History accumulates on the tracker (it rides into ``telemetry.json``)
and headline rates feed the metrics registry.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.uint8)
_TABLES: Dict[torch.device, torch.Tensor] = {}
# bytes counted per table lookup: bounds the int32 index temporary
_POP_CHUNK = 1 << 24


def _table(device: torch.device) -> torch.Tensor:
    t = _TABLES.get(device)
    if t is None:
        t = torch.from_numpy(_POPCOUNT).to(device)
        _TABLES[device] = t
    return t


def popcount_sum(words: torch.Tensor) -> torch.Tensor:
    """Set bits of a uint8 tensor, as a 0-dim int64 tensor on its device
    (no host sync)."""
    words = words.reshape(-1)
    table = _table(words.device)
    total = torch.zeros((), dtype=torch.int64, device=words.device)
    for lo in range(0, int(words.shape[0]), _POP_CHUNK):
        idx = words[lo:lo + _POP_CHUNK].to(torch.int32)
        total += table[idx].sum(dtype=torch.int64)
    return total


def _packed_words(leaf) -> Any:
    """Device ``words_dev`` if present, else host-packed mask, else None."""
    words = getattr(leaf, "words_dev", None)
    if words is not None:
        return words
    mask = getattr(leaf, "mask", None)
    if mask is None:
        return None
    return np.packbits(np.asarray(mask, dtype=bool))


def _is_device(words) -> bool:
    return isinstance(words, torch.Tensor)


def _host_words(words) -> np.ndarray:
    return words if isinstance(words, np.ndarray) else words.cpu().numpy()


class DriftTracker:
    """Diffs successive criticality reports; one instance per manager."""

    def __init__(self, registry=None):
        self.registry = registry
        self._prev: Dict[str, Any] = {}
        self._prev_leaves: Optional[Any] = None
        self.history: List[Dict[str, Any]] = []
        self.last: Optional[Dict[str, Any]] = None

    def _observe_identical(self, step: Optional[int]) -> Dict[str, Any]:
        """The same report object re-observed: every mask is bitwise
        unchanged by construction, so record a zero-flip sweep without
        re-packing or diffing anything."""
        rec_leaves: Dict[str, Dict[str, Any]] = {}
        for name, prev_e in self.last["leaves"].items():
            e = {k: prev_e[k] for k in
                 ("n", "words", "policy", "critical_count",
                  "critical_fraction") if k in prev_e}
            e.update(flips=0, flip_rate=0.0, word_churn=0.0)
            if "words" in prev_e:
                e["changed_words"] = 0
            rec_leaves[name] = e
        rec = {"step": step, "sweep": len(self.history),
               "leaves": rec_leaves, "total_flips": 0,
               "total_elements": self.last["total_elements"],
               "flip_rate": 0.0}
        self.history.append(rec)
        self.last = rec
        if self.registry is not None:
            self.registry.counter("drift.sweeps").inc()
            self.registry.histogram("drift.flip_rate").observe(0.0)
        return rec

    def observe(self, report, step: Optional[int] = None) -> Dict[str, Any]:
        """Record one report; returns the drift record for this sweep."""
        leaves = getattr(report, "leaves", report)
        if leaves is self._prev_leaves and self.last is not None:
            return self._observe_identical(step)
        self._prev_leaves = leaves
        rec_leaves: Dict[str, Dict[str, Any]] = {}
        # device counts, fetched in one transfer per device at the end
        pending: List[torch.Tensor] = []

        def defer(val: torch.Tensor) -> int:
            pending.append(val)
            return len(pending) - 1

        cur: Dict[str, Any] = {}
        for name, leaf in leaves.items():
            n = int(getattr(leaf, "n", 0) or
                    int(np.prod(getattr(leaf, "shape", ()) or (1,))))
            words = _packed_words(leaf)
            entry: Dict[str, Any] = {"n": n}
            if words is None:
                crit = bool(getattr(leaf, "critical", True))
                cur[name] = ("policy", crit, n)
                prev = self._prev.get(name)
                entry["policy"] = True
                entry["critical_fraction"] = 1.0 if crit else 0.0
                if prev is None or prev[0] != "policy":
                    entry["new"] = True
                    entry["flips"] = 0
                else:
                    entry["flips"] = n if prev[1] != crit else 0
                entry["flip_rate"] = entry["flips"] / max(n, 1)
                entry["word_churn"] = 1.0 if entry["flips"] else 0.0
                rec_leaves[name] = entry
                continue

            total_words = int(words.shape[0])
            entry["words"] = total_words
            dev = _is_device(words)
            if dev:
                entry["_crit_idx"] = defer(popcount_sum(words))
            else:
                entry["critical_count"] = int(
                    np.unpackbits(words)[:n].sum())
            cur[name] = ("words", words, n)
            prev = self._prev.get(name)
            same = (prev is not None and prev[0] == "words"
                    and prev[2] == n
                    and tuple(prev[1].shape) == tuple(words.shape))
            if not same:
                entry["new"] = True
                entry["flips"] = 0
                entry["changed_words"] = 0
            elif prev[1] is words:
                # identical words object reused: zero flips, no device work
                entry["flips"] = 0
                entry["changed_words"] = 0
            elif dev and _is_device(prev[1]) \
                    and prev[1].device == words.device:
                x = torch.bitwise_xor(words, prev[1])
                entry["_flips_idx"] = defer(popcount_sum(x))
                entry["_churn_idx"] = defer(
                    torch.count_nonzero(x).to(torch.int64))
            else:
                x = np.bitwise_xor(_host_words(prev[1]), _host_words(words))
                entry["flips"] = int(np.unpackbits(x).sum())
                entry["changed_words"] = int(np.count_nonzero(x))
            rec_leaves[name] = entry

        fetched: List[int] = [0] * len(pending)
        by_dev: Dict[torch.device, List[int]] = {}
        for i, t in enumerate(pending):
            by_dev.setdefault(t.device, []).append(i)
        for idxs in by_dev.values():
            vals = torch.stack([pending[i] for i in idxs]).cpu().tolist()
            for i, v in zip(idxs, vals):
                fetched[i] = int(v)

        total_flips = 0
        total_elements = 0
        for name, entry in rec_leaves.items():
            if "_crit_idx" in entry:
                entry["critical_count"] = fetched[entry.pop("_crit_idx")]
            if "_flips_idx" in entry:
                entry["flips"] = fetched[entry.pop("_flips_idx")]
                entry["changed_words"] = fetched[entry.pop("_churn_idx")]
            n = entry["n"]
            if "critical_count" in entry:
                entry["critical_fraction"] = entry["critical_count"] / max(n, 1)
            if "flip_rate" not in entry:
                entry["flip_rate"] = entry["flips"] / max(n, 1)
            if "word_churn" not in entry and "words" in entry:
                entry["word_churn"] = (entry.get("changed_words", 0)
                                       / max(entry["words"], 1))
            total_flips += entry["flips"]
            total_elements += n

        self._prev = cur
        rec = {
            "step": step,
            "sweep": len(self.history),
            "leaves": rec_leaves,
            "total_flips": int(total_flips),
            "total_elements": int(total_elements),
            "flip_rate": total_flips / max(total_elements, 1),
        }
        self.history.append(rec)
        self.last = rec
        if self.registry is not None:
            self.registry.counter("drift.sweeps").inc()
            self.registry.histogram("drift.flip_rate").observe(
                rec["flip_rate"])
            for name, entry in rec_leaves.items():
                if "critical_fraction" in entry:
                    self.registry.gauge(
                        f"scrutiny.critical_fraction.{name}").set(
                            entry["critical_fraction"])
                self.registry.gauge(f"drift.flip_rate.{name}").set(
                    entry["flip_rate"])
        return rec
