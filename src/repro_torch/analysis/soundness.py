"""Soundness cross-check: the static analyzer must cover the AD engine
(port of ``repro.analysis.soundness``).

In exact arithmetic a gradient can only be non-zero through elements the
program *reads*, so for every leaf the AD engine swept::

    AD-critical  ⊆  static-critical

``verify_soundness`` asserts exactly that, element-wise, between an AD
report (``scrutinize``) and a :class:`StaticReport`, and on a violation
names the aten graph nodes that read the leaf, with their taint-rule
class and source line (the report's provenance).

The gate cannot verify leaves ``static_prune`` removed from the sweep on
taint evidence: their AD mask is all-zero because no sweep ran.  They are
listed in ``SoundnessResult.pruned_leaf_names`` rather than counted as
checked; ``soundness_checker(..., check_pruned=True)`` re-sweeps without
the prune whenever a report carries such leaves.  Leaves pruned because no
output reads them need no flag: their gradient is zero by structure.

Only AD/HORIZON leaves are compared: ALWAYS_CRITICAL leaves carry a policy
verdict, not a gradient, and the static pass legitimately proves some of
them uncritical (int dataflow, e.g. NPB IS ``bucket_ptrs``).

``soundness_checker(fn)`` packages the check as a manager hook:
``CheckpointManager(..., soundness_check=soundness_checker(step_fn))``
verifies every fresh scrutiny against a static analysis (the trace is
shared through the cache, so the extra cost is one taint walk).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import numpy as np

from repro_torch.analysis.static import (ReaderRecord, StaticReport,
                                         analyze_static)
from repro_torch.core.criticality import CriticalityReport, scrutinize
from repro_torch.core.policy import LeafPolicy, ScrutinyConfig


@dataclasses.dataclass(frozen=True)
class Violation:
    """One leaf where an AD-critical element is statically uncritical."""

    leaf: str
    count: int                      # violating elements
    total: int
    example_indices: List[int]      # first few flat indices
    readers: List[ReaderRecord]     # provenance: nodes reading this leaf

    def __str__(self) -> str:
        where = ", ".join(str(r) for r in self.readers[:4]) or \
            "no direct readers"
        return (f"{self.leaf}: {self.count}/{self.total} AD-critical "
                f"elements statically uncritical (e.g. flat idx "
                f"{self.example_indices}); responsible rules: {where}")


@dataclasses.dataclass(frozen=True)
class SoundnessResult:
    checked_leaves: int
    checked_elements: int
    skipped_leaves: int             # non-AD-policy leaves (policy verdicts)
    violations: List[Violation]
    # leaves static_prune removed from the sweep on taint evidence: their
    # AD mask is vacuously empty, so the gate could not verify them
    pruned_leaves: int = 0
    pruned_leaf_names: tuple = ()

    @property
    def ok(self) -> bool:
        return not self.violations


class SoundnessError(AssertionError):
    """Static analysis declared an AD-critical element uncritical."""

    def __init__(self, result: SoundnessResult):
        self.result = result
        lines = ["static/AD soundness violation "
                 f"({len(result.violations)} leaf/leaves; a taint rule "
                 "under-approximated a read):"]
        lines += [f"  - {v}" for v in result.violations]
        super().__init__("\n".join(lines))


def verify_soundness(ad_report: CriticalityReport,
                     static_report: StaticReport, *,
                     raise_on_violation: bool = True,
                     max_examples: int = 8) -> SoundnessResult:
    """Assert AD-critical ⊆ static-critical element-wise.

    ``ad_report``: a ``scrutinize`` result (either engine; device masks
    materialize lazily).  ``static_report``: ``analyze_static`` on the
    same fn and state.  Raises :class:`SoundnessError` (with per-leaf
    provenance) unless ``raise_on_violation=False``.  Leaves the report's
    ``static_prune`` pre-pass skipped on taint evidence
    (``stats["static_taint_pruned_leaves"]``) are reported in
    ``pruned_leaf_names``, not counted as checked.
    """
    pruned = set((getattr(ad_report, "stats", None) or {})
                 .get("static_taint_pruned_leaves", ()))
    pruned_seen: List[str] = []
    violations: List[Violation] = []
    checked_leaves = checked_elements = skipped = 0
    for name, leaf in ad_report.leaves.items():
        if leaf.policy not in (LeafPolicy.AD, LeafPolicy.HORIZON):
            skipped += 1
            continue
        if name in pruned:
            pruned_seen.append(name)
            continue
        if name not in static_report.leaves:
            raise ValueError(
                f"soundness check: leaf {name!r} missing from the static "
                "report — the two reports were built on different states")
        ad_mask = np.asarray(leaf.mask, bool)
        st_mask = np.asarray(static_report[name].mask, bool)
        if ad_mask.shape != st_mask.shape:
            raise ValueError(
                f"soundness check: leaf {name!r} mask shapes differ "
                f"({ad_mask.shape} vs {st_mask.shape})")
        checked_leaves += 1
        checked_elements += ad_mask.size
        bad = ad_mask & ~st_mask
        if bad.any():
            idx = np.flatnonzero(bad)
            violations.append(Violation(
                leaf=name, count=int(bad.sum()), total=int(bad.size),
                example_indices=[int(i) for i in idx[:max_examples]],
                readers=list(static_report.provenance.get(name, ()))))
    result = SoundnessResult(checked_leaves, checked_elements, skipped,
                             violations, pruned_leaves=len(pruned_seen),
                             pruned_leaf_names=tuple(sorted(pruned_seen)))
    if raise_on_violation and violations:
        raise SoundnessError(result)
    return result


def soundness_checker(fn: Callable[[Any], Any], *,
                      config: ScrutinyConfig = ScrutinyConfig(),
                      int_dataflow: bool = True, check_pruned: bool = False,
                      device=None
                      ) -> Callable[[Any, CriticalityReport],
                                    SoundnessResult]:
    """Manager hook verifying every fresh scrutiny report against a static
    analysis of the same ``fn``: ``check(state, report)`` raises
    :class:`SoundnessError` on a violation and returns the
    :class:`SoundnessResult` otherwise.

    ``check_pruned=True``: when the report carries taint-pruned leaves
    (which the fast gate can only flag), re-run ``scrutinize`` with
    ``static_prune=False`` and gate *that* report, so every leaf is
    checked; it costs one un-pruned sweep per report that pruned
    something.  ``device``: the card unless ``"cpu"`` is asked for.
    """

    def check(state: Any, report: CriticalityReport) -> SoundnessResult:
        static = analyze_static(fn, state, config=config,
                                int_dataflow=int_dataflow, device=device)
        result = verify_soundness(report, static)
        if check_pruned and result.pruned_leaf_names:
            full = scrutinize(fn, state, config=dataclasses.replace(
                config, static_prune=False), device=device)
            result = verify_soundness(full, static)
        return result

    return check
