"""Static criticality analysis — the AD pipeline's free second opinion
(port of ``repro.analysis.static``).

``analyze_static(fn, state)`` answers the paper's question — *which
elements of the checkpointed state does the rest of the program need?* —
without running a backward pass: it walks the traced aten graph of ``fn``
with the participation taint rules (``repro_torch.core.taint``), exact
write-before-read clearing through ``slice_scatter`` / ``select_scatter``
/ ``index_put`` / ``copy`` included, and — unlike the AD engine —
**integer/bool dataflow**: an int leaf such as NPB IS's ``bucket_ptrs``
gets a real element mask (it is rebuilt before every read, hence
statically uncritical) instead of the AD path's ALWAYS_CRITICAL verdict.

The result is a :class:`StaticReport` with the per-leaf mask /
RegionTable interface of the AD engine's reports::

    grad-critical  ⊆  static-critical        (checked: repro_torch.
                                              analysis.verify_soundness)
    static == participation on inexact leaves; static also masks integer
    leaves by dataflow (int_dataflow=True).

Provenance: for every state leaf the report records the graph nodes that
read it directly, with the taint rule that handles each
(``taint.classify_rule``) and the source line the tracer recorded; the
soundness verifier names these on a violation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch._tensors import dtype_name, itemsize
from repro_torch.core.criticality import (CriticalityReport, LeafReport,
                                          TracedStep, traced_step)
from repro_torch.core.policy import LeafPolicy, ScrutinyConfig
from repro_torch.core.regions import RegionTable
from repro_torch.core.taint import (backward_taint, classify_rule,
                                    node_source, op_name, read_inputs)


@dataclasses.dataclass(frozen=True)
class ReaderRecord:
    """One aten graph node that reads a state leaf directly."""

    node_index: int    # position in the graph's node list
    node: str          # the node's name, e.g. "mm_3"
    op: str            # e.g. "aten.mm.default", "repro_torch.lru_scan.default"
    rule: str          # taint rule class (taint.classify_rule)
    source: str        # recorded source line, best-effort ("" if none)

    def __str__(self) -> str:
        loc = f" @ {self.source}" if self.source else ""
        return f"node[{self.node_index}] {self.node} {self.op} " \
               f"({self.rule}){loc}"


@dataclasses.dataclass(frozen=True)
class StaticReport(CriticalityReport):
    """Static-analysis result; the full :class:`CriticalityReport` API.

    ``provenance`` maps each leaf name to the nodes reading it directly —
    the graph-level evidence behind its mask.  A leaf with no record is
    never read (it may also be fully uncritical *with* readers, when every
    read comes after a write).
    """

    provenance: Dict[str, List[ReaderRecord]] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)


def _direct_readers(ts: TracedStep) -> Dict[Any, List[ReaderRecord]]:
    """placeholder → the nodes reading it."""
    nodes = list(ts.gm.graph.nodes)
    readers: Dict[Any, List[ReaderRecord]] = {
        n: [] for n in nodes if n.op == "placeholder"}
    for idx, node in enumerate(nodes):
        if node.op != "call_function":
            continue
        rec = None
        for n in read_inputs(node):
            if n in readers:
                if rec is None:
                    rec = ReaderRecord(idx, node.name, op_name(node),
                                       classify_rule(node),
                                       node_source(node))
                if rec not in readers[n]:
                    readers[n].append(rec)
    return readers


def analyze_static(fn: Callable[[Any], Any], state: Any, *,
                   config: ScrutinyConfig = ScrutinyConfig(),
                   int_dataflow: bool = True,
                   traced: Optional[TracedStep] = None,
                   device=None) -> StaticReport:
    """Static element criticality of ``fn`` at ``state`` (no AD).

    Same contract as :func:`repro_torch.core.scrutinize` / ``participation``:
    the mask marks an element critical iff the rest of the program
    transitively reads it before overwriting it.

    ``int_dataflow``: give integer/bool ALWAYS_CRITICAL leaves their
    dataflow mask instead of the policy verdict.  It overrides only
    non-inexact dtypes: an inexact leaf pinned ALWAYS_CRITICAL by
    ``leaf_policy`` keeps its all-ones mask.  AD/HORIZON leaves always get
    dataflow masks; ALWAYS_UNCRITICAL is honoured.

    ``traced``: an already-traced :class:`TracedStep` to reuse (the
    scrutiny pre-pass passes its own); omitted, the shared trace cache is
    consulted.  ``device``: the card unless ``"cpu"`` is asked for.
    """
    ts = traced if traced is not None else traced_step(fn, state,
                                                       device=device)
    in_taints = backward_taint(ts)
    readers = _direct_readers(ts)
    placeholders = [n for n in ts.gm.graph.nodes if n.op == "placeholder"]

    reports: Dict[str, LeafReport] = {}
    provenance: Dict[str, List[ReaderRecord]] = {}
    dataflow_leaves = 0
    for name, leaf, t, ph in zip(ts.names, ts.leaves, in_taints,
                                 placeholders):
        pol = config.leaf_policy(leaf)
        n = leaf.numel()
        inexact = leaf.is_floating_point() or leaf.is_complex()
        if pol == LeafPolicy.ALWAYS_UNCRITICAL:
            mask = np.zeros(n, dtype=bool)
        elif pol == LeafPolicy.ALWAYS_CRITICAL and (not int_dataflow
                                                    or inexact):
            mask = np.ones(n, dtype=bool)
        else:
            mask = t.reshape(-1).cpu().numpy().copy()
            dataflow_leaves += 1
        dt = dtype_name(leaf.dtype)
        table = RegionTable.from_mask(mask, itemsize=itemsize(dt))
        table.validate()
        reports[name] = LeafReport(name=name, shape=tuple(leaf.shape),
                                   dtype=dt, policy=pol, mask=mask,
                                   table=table, magnitude=None)
        provenance[name] = readers.get(ph, [])

    stats = {"engine": "static", "int_dataflow": bool(int_dataflow),
             "dataflow_leaves": dataflow_leaves, "trace_s": ts.trace_s,
             "trace_cached": ts.cached,
             "nodes": len(ts.gm.graph.nodes)}
    return StaticReport(leaves=reports, stats=stats, provenance=provenance)
