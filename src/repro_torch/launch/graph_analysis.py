"""Aten-level accounting of a step: FLOPs, HBM bytes, collective bytes
(the port's counterpart of ``repro.launch.hlo_analysis``).

The reference parses a compiled program's optimized HLO and multiplies
while-loop bodies by their trip counts.  The port has no compiled
program: a step is a sequence of aten ops, and a traced step is unrolled
(a Python loop over layers is one node a layer), so a graph has nothing
to multiply.  One counting rule (:meth:`Tally.add`) serves two front doors:

- :func:`analyze` over an aten FX graph (``make_fx``, any tracing mode):
  each ``call_function`` node is counted from its ``meta["val"]``;
- :class:`Accountant`, a ``TorchDispatchMode`` that counts each op as it
  runs, for steps too large to hold as a graph: over fake tensors (the
  dry run) or over a real step on the card.  ``Accountant.repeat(n)``
  counts what runs inside it n times: the dry run runs one step of an
  LSTM cell's time loop and counts it T times, the trip-count
  multiplication of the reference.

The rule:

- **FLOPs** are ``torch.utils.flop_counter``'s registry's, the formulas
  ``FlopCounterMode`` uses: matrix products and convolutions, and K6's
  forward and backward, whose formulas are registered beside their op
  definitions (``kernels/flash_attention/ops.py``; the causal or
  window-effective context, as ``model_flops`` counts it).  Elementwise ops
  count zero, K7's scan included, as the reference's "elementwise ignored".
- **Bytes**: each op reads its inputs and writes its output.  Views
  (``select``, ``t``, ``view``, ``_unsafe_view``, …) and bare allocations
  (``empty``) move nothing; slice-like ops (``index``, ``gather``,
  ``cat``, ``_to_copy``, ``clone``, ``copy_``, …) cost twice their result,
  as the reference's ``_SLICE_LIKE``.  Nothing is fused, so the count is an
  upper bound on a step's HBM traffic.
- **Collectives**: the result bytes of the ``_c10d_functional``
  collectives, under the reference's names (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``).

``n_nodes`` (ops counted) takes the place of the reference's ``n_whiles``.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Any, Dict

import torch
from torch.fx.node import map_arg
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# K6's FLOP formulas live beside its op definitions; importing the ops
# registers them
from repro_torch.kernels.flash_attention import ops as _fa_ops  # noqa: F401

aten = torch.ops.aten
_c10d = torch.ops._c10d_functional

_FREE = {aten._unsafe_view, aten.alias, aten.lift_fresh, aten.detach,
         aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
         aten.new_empty_strided, _c10d.wait_tensor}
_SLICE_LIKE = {aten.index, aten._unsafe_index, aten.index_select,
               aten.gather, aten.embedding, aten.cat, aten.stack,
               aten.constant_pad_nd, aten.flip, aten.roll, aten.repeat,
               aten._to_copy, aten.clone, aten.copy, aten.copy_,
               aten.arange, aten.expand_copy, aten.slice_copy,
               aten.select_copy, aten.permute_copy, aten.transpose_copy,
               aten.t_copy, aten.view_copy, aten.unfold_copy}
COLLECTIVES = {_c10d.all_reduce: "all-reduce",
               _c10d.all_reduce_: "all-reduce",
               _c10d.all_reduce_coalesced: "all-reduce",
               _c10d.all_gather_into_tensor: "all-gather",
               _c10d.all_gather_into_tensor_coalesced: "all-gather",
               _c10d.reduce_scatter_tensor: "reduce-scatter",
               _c10d.reduce_scatter_tensor_coalesced: "reduce-scatter",
               _c10d.all_to_all_single: "all-to-all"}


def tensor_bytes(x) -> int:
    """Bytes of every tensor in ``x`` (a tensor, or a nest of them)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


class Tally:
    """The counting rule and its running totals."""

    def __init__(self):
        self.scale = 1          # each op counts this many times
        self.flops = 0
        self.hbm_bytes = 0
        self.coll_bytes: Dict[str, int] = {}
        self.n_nodes = 0
        self.flops_by_op: Dict[str, int] = collections.Counter()

    def add(self, func, args, kwargs, out) -> None:
        """Count one aten op (``func``, an ``OpOverload``) called on
        ``args``/``kwargs`` that gave ``out``."""
        if func.namespace == "prim":        # metadata queries (.device)
            return
        packet = func.overloadpacket
        n = self.scale
        self.n_nodes += n
        formula = flop_registry.get(packet)
        if formula is not None:
            f = n * int(formula(*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[str(packet)] += f
        kind = COLLECTIVES.get(packet)
        if kind is not None:
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + \
                n * tensor_bytes(out)
        if func.is_view or packet in _FREE:
            return
        if packet in _SLICE_LIKE:
            self.hbm_bytes += n * 2 * tensor_bytes(out)
        else:
            self.hbm_bytes += n * (tensor_bytes((args, kwargs))
                                   + tensor_bytes(out))

    def result(self) -> Dict[str, Any]:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "coll_bytes": dict(self.coll_bytes), "n_nodes": self.n_nodes,
                "flops_by_op": dict(self.flops_by_op)}


def analyze(gm: torch.fx.GraphModule) -> Dict[str, Any]:
    """Account an aten FX graph node by node, from each node's
    ``meta["val"]`` (what ``make_fx`` records in every tracing mode)."""
    t = Tally()
    for node in gm.graph.nodes:
        if node.op != "call_function" or \
                not isinstance(node.target, torch._ops.OpOverload):
            continue
        args, kwargs = map_arg((node.args, node.kwargs),
                               lambda n: n.meta.get("val"))
        t.add(node.target, args, kwargs, node.meta.get("val"))
    return t.result()


class Accountant(TorchDispatchMode):
    """Counts every aten op that runs under it, by :class:`Tally`'s rule.
    Over fake tensors (``FakeTensorMode`` entered first) it accounts a step
    that no device could hold; over real tensors, the step as it runs."""

    def __init__(self):
        super().__init__()
        self.tally = Tally()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.tally.add(func, args, kwargs, out)
        return out

    def result(self) -> Dict[str, Any]:
        return self.tally.result()

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count each op run inside as ``n`` ops (a loop body run once for
        a loop of ``n`` iterations)."""
        old = self.tally.scale
        self.tally.scale = old * n
        try:
            yield
        finally:
            self.tally.scale = old
