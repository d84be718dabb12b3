"""Structural participation analysis — backward taint over an aten graph
(port of ``repro.core.taint``).

The paper's definition of *uncritical* is "no impact on the output",
measured as a zero derivative.  AD computes that derivative in floating
point, so an element whose influence cancels exactly in real arithmetic
(NPB-FT's checksum reads 4,096 frequencies; every other one gets a
gradient of FFT round-off) still comes out critical.  Every number in the
paper's Table II is a **participation** result: an element is critical
iff the rest of the program *reads* it (transitively, before overwriting
it).

``participation(fn, state)`` computes exactly that, element-granular, in
one backward sweep over the aten graph of ``fn``:

- **The graph.** ``fn`` is traced with ``make_fx`` in ``tracing_mode=
  "real"`` (under ``no_grad``), wrapped in ``torch.func.functionalize``,
  so in-place writes become ``slice_scatter`` / ``select_scatter`` /
  ``index_put`` / ``copy`` nodes and views become view nodes.  The graph
  replaces the reference's jaxpr (``repro_torch.core.criticality.
  traced_step``).  Python loops unroll in it, so the reference's
  ``scan``/``while`` OR-fixpoints (and its call-primitive recursion) have
  no counterpart here: every iteration is its own nodes.
- **Concrete indices.** The graph runs once on the state's device under
  an ``fx.Interpreter`` that keeps the values of the nodes feeding an
  index operand (the reference's ``_forward_env``), so gather/scatter
  windows are exact.
- Seed every output element as tainted; walk the nodes in reverse; each
  aten op maps its output taint to its inputs' taint.  A node's taint is
  freed once it has been propagated (all its readers come after it).
- **Write-before-read is exact**: ``slice_scatter`` / ``select_scatter``
  / ``index_put`` clear the written window of the base, ``copy`` and
  ``fill`` read nothing of the tensor they overwrite, nor do the random
  fills (``uniform``, ``normal``, ``bernoulli`` with a float ``p``: a
  dropout mask), and ``zeros_like`` and its kin read no value at all.
- **Linear structural ops** (views, slices, ``cat``, ``roll``, ``sum``,
  ``cumsum``, ...) propagate exactly: the taint moves as a 0/1 cotangent
  would through the op's own vjp (the reference's ``_vjp_structural``);
  the common ones are written out, the rest run ``torch.autograd.grad``
  on f64 zeros with the taint as the cotangent.  Ops with index operands
  (``index``, ``index_select``, ``gather``, ``index_add``, ``index_put``,
  ``scatter``, ``scatter_add``, ``embedding``) do the same with the
  concrete indices; the index operands themselves are control state and
  come out fully tainted.
- **Value coupling** (``mm``/``bmm``/``mv``/``dot`` and the ``einsum``
  and ``matmul`` that decompose into them, FFT over its ``dim``,
  max/min/prod/norm/softmax reductions, ``sort``/``topk``, ``cumprod``
  and its kin): any tainted output along the coupled axes taints all
  coupled inputs, value-independent, as in the reference.
- **Pointwise** ops (``torch.Tag.pointwise``) pass the taint through,
  OR-reduced over the dimensions an input was broadcast along (the
  reference taints an operand broadcast through a size-1 dimension whole;
  the NPB programs' masks are equal either way).
- **Anything else** — an unknown op, or a kernel registered as a custom
  op (``repro_torch::flash_attention``, ``repro_torch::lru_scan`` and
  their backwards) — falls back to any→all, the reference's fallback for
  an unknown primitive (and so for a ``pallas_call``).  Sound, never an
  under-report.
- **A tensor the graph cannot attribute raises.**  A kernel launched on
  raw pointers outside a custom op writes into memory the tracer saw
  allocated by ``empty`` and never written; taint that reaches an
  ``empty``-family node (a read of memory no recorded op wrote) raises
  :class:`UnattributedTensorError` instead of calling its inputs
  uncritical.

Relationship to the AD engine (``criticality.py``)::

    grad-critical  ⊆  participation-critical   (exact arithmetic)
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch
import torch.fx as fx
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._tensors import dtype_name, itemsize
from repro_torch.core.criticality import (CriticalityReport, LeafReport,
                                          TracedStep, traced_step)
from repro_torch.core.policy import LeafPolicy, ScrutinyConfig
from repro_torch.core.regions import RegionTable

aten = torch.ops.aten


class UnattributedTensorError(RuntimeError):
    """An output read memory that no op recorded in the graph wrote: a
    kernel launched outside its custom op, invisible to the tracer."""


# Ops whose tensor inputs give only shape, dtype and device: no value read.
_CREATORS = {
    aten.zeros, aten.ones, aten.full, aten.arange, aten.scalar_tensor,
    aten.zeros_like, aten.ones_like, aten.full_like, aten.new_zeros,
    aten.new_ones, aten.new_full, aten.rand, aten.randn, aten.rand_like,
    aten.randn_like, aten.randint, aten.randint_like, aten.linspace,
    aten.eye, aten.zero, aten.tensor}
# Random fills (the functional forms of ``uniform_``, ``normal_``, ...)
# overwrite their first input, whose values they never read; so does
# ``bernoulli`` with a float ``p`` (dropout's mask).
_RANDOM_FILLS = {aten.uniform, aten.normal_functional, aten.exponential,
                 aten.geometric, aten.cauchy, aten.log_normal, aten.random}
# Ops that hand out uninitialized memory: a read of it is an error.
_UNINITIALIZED = {aten.empty, aten.empty_like, aten.new_empty,
                  aten.empty_strided, aten.new_empty_strided,
                  aten.empty_permuted}
_NO_READS = _CREATORS | _UNINITIALIZED
# Same-shape ops that pass their first input's taint through unchanged.
_IDENTITY = {aten.clone, aten._to_copy, aten.lift_fresh_copy,
             aten.lift_fresh, aten.alias, aten.detach, aten.real,
             aten.imag, aten._conj, aten._conj_physical}
_RESHAPES = {aten.view, aten._unsafe_view, aten.reshape,
             aten.squeeze, aten.unsqueeze, aten._reshape_alias}
_SUMS = {aten.sum, aten.mean, aten.nansum, aten.nanmean}
_COUPLED = {
    aten.amax, aten.amin, aten.max, aten.min, aten.prod, aten.argmax,
    aten.argmin, aten.all, aten.any, aten.logsumexp, aten.linalg_vector_norm,
    aten.norm, aten.var, aten.std, aten.var_mean, aten.std_mean,
    aten.median, aten.nanmedian, aten.mode, aten.aminmax, aten._softmax,
    aten._log_softmax, aten.sort, aten.topk, aten.kthvalue,
    aten.count_nonzero}
# Cumulative ops: output j reads inputs 0..j along ``dim``.
_CUMULATIVE = {aten.cumsum, aten.cumprod, aten.cummax, aten.cummin,
               aten.logcumsumexp}
_FFT = {aten._fft_c2c, aten._fft_r2c, aten._fft_c2r}
_MATMUL = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.dot,
           aten.vdot, aten.mv, aten.addmv}
# Ops with index operands (schema arguments ``index`` / ``indices``):
# exact through a vjp with the concrete indices.
_INDEXED = {aten.index, aten.index_select, aten.gather,
            aten.index_add, aten.index_put, aten.scatter,
            aten.scatter_add, aten.take, aten.index_fill, aten.index_copy,
            aten.embedding, aten._unsafe_index, aten._unsafe_index_put}
# Linear 0/1-coefficient ops without a written-out rule: through a vjp.
_VJP_STRUCTURAL = {
    aten.flip, aten.constant_pad_nd, aten.diagonal, aten.diagonal_scatter,
    aten.split, aten.split_with_sizes, aten.unbind, aten.repeat,
    aten.unfold, aten.as_strided, aten.as_strided_scatter, aten.diag_embed,
    aten.tril, aten.triu}
# Ops whose output *shape* depends on their inputs' values: tracing bakes
# the values in, so those inputs are value-consulted like index operands.
_SHAPE_BAKING = {aten.nonzero, aten.masked_select,
                 aten.repeat_interleave, aten._unique2,
                 aten.unique_dim, aten.unique_consecutive,
                 aten.bincount, aten.argwhere}
_INDEX_ARGS = ("index", "indices")


# --------------------------------------------------------------------------
# Node helpers
# --------------------------------------------------------------------------

def _packet(node: fx.Node):
    return getattr(node.target, "overloadpacket", None)


def _val(node: fx.Node):
    return node.meta.get("val")


def _shape(node: fx.Node, i: Optional[int] = None):
    v = _val(node)
    if i is not None:
        v = v[i]
    return tuple(v.shape)


def _is_tensor_node(x) -> bool:
    return isinstance(x, fx.Node) and isinstance(_val(x), torch.Tensor)


def _bound(node: fx.Node) -> Dict[str, Any]:
    """The node's arguments by schema name (defaults filled in)."""
    schema = node.target._schema
    out: Dict[str, Any] = {}
    for i, arg in enumerate(schema.arguments):
        if i < len(node.args):
            out[arg.name] = node.args[i]
        elif arg.name in node.kwargs:
            out[arg.name] = node.kwargs[arg.name]
        elif arg.has_default_value():
            out[arg.name] = arg.default_value
    return out


def _flat_nodes(x) -> List[fx.Node]:
    if isinstance(x, fx.Node):
        return [x]
    if isinstance(x, (list, tuple)):
        return [n for e in x for n in _flat_nodes(e)]
    if isinstance(x, dict):
        return [n for e in x.values() for n in _flat_nodes(e)]
    return []


def _input_nodes(node: fx.Node) -> List[fx.Node]:
    return [n for n in _flat_nodes((node.args, node.kwargs))
            if _is_tensor_node(n)]


def _index_nodes(node: fx.Node) -> List[fx.Node]:
    """The index operands of an indexed op (schema ``index``/``indices``)."""
    b = _bound(node)
    return [n for name in _INDEX_ARGS if name in b
            for n in _flat_nodes(b[name]) if _is_tensor_node(n)]


def node_source(node: fx.Node) -> str:
    """The innermost frame of the node's recorded stack trace, "" when the
    tracer recorded none (``make_fx`` records frames of module forwards
    only, so a functional program's nodes carry none)."""
    lines = [ln.strip() for ln in (node.meta.get("stack_trace") or "")
             .splitlines() if ln.strip().startswith("File ")]
    return lines[-1][len("File "):] if lines else ""


def op_name(node: fx.Node) -> str:
    """``aten.mm.default``-style name of a node's op."""
    if node.target is operator.getitem:
        return "getitem"
    return str(node.target)


# --------------------------------------------------------------------------
# Taint helpers (bool tensors on the state's device)
# --------------------------------------------------------------------------

def _full(shape, value, like: torch.Tensor) -> torch.Tensor:
    return torch.full(tuple(shape), bool(value), dtype=torch.bool,
                      device=like.device)


def _reduce_to(t: torch.Tensor, shape) -> torch.Tensor:
    """OR ``t`` over the dimensions along which ``shape`` was broadcast."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    lead = t.dim() - len(shape)
    if lead > 0:
        t = t.any(dim=tuple(range(lead)))
    dims = tuple(i for i, (a, b) in enumerate(zip(t.shape, shape))
                 if b == 1 and a != 1)
    if dims:
        t = t.any(dim=dims, keepdim=True)
    return t.reshape(shape)


def _dims(dim, nd: int) -> Optional[List[int]]:
    """A schema ``dim`` argument as a sorted list; None for all dims."""
    if dim is None:
        return None
    if isinstance(dim, int):
        dim = [dim]
    dims = sorted({int(d) % max(nd, 1) for d in dim})
    return dims or None


def _coupled(t: torch.Tensor, in_shape, dims) -> torch.Tensor:
    """Input taint of an op coupling ``dims``: any tainted output along
    them taints every input element along them (``dims`` None: all)."""
    in_shape = tuple(in_shape)
    nd = len(in_shape)
    if dims is None or nd == 0:
        return _full(in_shape, t.any(), t)
    if t.dim() < nd:                          # keepdim=False reduction
        for d in dims:
            t = t.unsqueeze(d)
    t = t.any(dim=tuple(dims), keepdim=True)
    return t.expand(in_shape)


def _suffix(t: torch.Tensor, dim: int) -> torch.Tensor:
    """in[i] = any(out[j] for j >= i) along ``dim``."""
    if t.dim() == 0:
        return t
    return t.flip(dim).to(torch.int32).cumsum(dim).flip(dim) > 0


def _any(outs) -> bool:
    if isinstance(outs, torch.Tensor):
        return bool(outs.any())
    return any(o is not None and bool(o.any()) for o in outs)


def _or(outs) -> torch.Tensor:
    """A node's output taint; a multi-output node's taints OR-ed into its
    first output's shape (an output of another shape counts as a whole)."""
    if isinstance(outs, torch.Tensor):
        return outs
    acc = outs[0]
    for o in outs[1:]:
        if o is not None:
            acc = acc | (o if o.shape == acc.shape else o.any())
    return acc


# --------------------------------------------------------------------------
# Rules: node + output taint → {input node: taint}
# --------------------------------------------------------------------------

def _rule_fallback(node, outs, env):
    any_out = _any(outs)
    ref = outs if isinstance(outs, torch.Tensor) else \
        next(o for o in outs if o is not None)
    return [(n, _full(_shape(n), any_out, ref)) for n in _input_nodes(node)]


def _rule_pointwise(node, outs, env):
    t = _or(outs)
    return [(n, _reduce_to(t, _shape(n))) for n in _input_nodes(node)]


def _rule_identity(node, outs, env):
    src = node.args[0]
    return [(src, _reduce_to(outs, _shape(src)))]


def _rule_structural(node, outs, env):
    """The written-out exact rules of the common linear ops."""
    p, b, t = _packet(node), _bound(node), outs
    src = node.args[0]
    if p in _RESHAPES:
        return [(src, t.reshape(_shape(src)))]
    if p is aten.permute:
        inv = np.argsort(list(b["dims"])).tolist()
        return [(src, t.permute(inv))]
    if p is aten.transpose:
        return [(src, t.transpose(b["dim0"], b["dim1"]))]
    if p is aten.t:
        return [(src, t.t() if t.dim() == 2 else t)]
    if p is aten.expand:
        return [(src, _reduce_to(t, _shape(src)))]
    if p is aten.slice:
        z = torch.zeros(_shape(src), dtype=torch.bool, device=t.device)
        return [(src, aten.slice_scatter(z, t, b["dim"], b["start"],
                                         b["end"], b["step"]))]
    if p is aten.select:
        z = torch.zeros(_shape(src), dtype=torch.bool, device=t.device)
        return [(src, aten.select_scatter(z, t, b["dim"], b["index"]))]
    if p is aten.slice_scatter:
        win = (b["dim"], b["start"], b["end"], b["step"])
        part = aten.slice(t, *win)
        return [(src, aten.slice_scatter(t, torch.zeros_like(part), *win)),
                (b["src"], part)]
    if p is aten.select_scatter:
        part = aten.select(t, b["dim"], b["index"])
        return [(src, aten.select_scatter(t, torch.zeros_like(part),
                                          b["dim"], b["index"])),
                (b["src"], part)]
    if p is aten.cat:
        tensors = [n for n in b["tensors"]]
        nd = t.dim()
        dim = int(b["dim"]) % max(nd, 1)
        res, lo = [], 0
        for n in tensors:
            shp = _shape(n)
            if len(shp) != nd:            # legacy empty 1-d operand
                continue
            res.append((n, t.narrow(dim, lo, shp[dim])))
            lo += shp[dim]
        return res
    if p is aten.stack:
        return list(zip(b["tensors"], t.unbind(int(b["dim"]) % t.dim())))
    if p is aten.roll:
        shifts, dims = list(b["shifts"]), list(b["dims"])
        back = [-int(s) for s in shifts]
        if dims:
            return [(src, torch.roll(t, back, dims))]
        return [(src, torch.roll(t.reshape(-1), back).reshape(t.shape))]
    if p is aten.copy:
        return [(b["src"], _reduce_to(t, _shape(b["src"])))]
    if p is aten.fill:
        v = b.get("value")
        return [(v, _full(_shape(v), t.any(), t))] if _is_tensor_node(v) \
            else []
    if p in _SUMS:
        return [(src, _coupled(t, _shape(src), _dims(b.get("dim"),
                                                    len(_shape(src)))))]
    raise AssertionError(p)


_STRUCTURAL = _RESHAPES | _SUMS | {
    aten.permute, aten.transpose, aten.t, aten.expand, aten.slice,
    aten.select, aten.slice_scatter, aten.select_scatter, aten.cat,
    aten.stack, aten.roll, aten.copy, aten.fill}


def _vjp(node: fx.Node, outs, env: Dict[fx.Node, Any],
         index_nodes: Sequence[fx.Node]):
    """Input taint through the op's own vjp: f64 zero primals for the
    tensor inputs, the concrete values for ``index_nodes``, the output
    taint as a 0/1 cotangent.  None when the op has no usable vjp."""
    data = [n for n in _input_nodes(node) if n not in index_nodes]
    dev = _or(outs).device
    if any(n not in env for n in index_nodes):
        return None
    primal = {n: torch.zeros(_shape(n), dtype=torch.float64, device=dev,
                             requires_grad=True) for n in data}

    def sub(x):
        if isinstance(x, fx.Node):
            return primal[x] if x in primal else env.get(x)
        if isinstance(x, (list, tuple)):
            return type(x)(sub(e) for e in x)
        return x

    kwargs = {k: sub(v) for k, v in node.kwargs.items() if k != "dtype"}
    try:
        with torch.enable_grad():
            res = node.target(*sub(node.args), **kwargs)
            if isinstance(res, torch.Tensor):
                res, cts = [res], [outs]
            else:
                res, cts = list(res), list(outs)
            pairs = [(r, c.to(torch.float64)) for r, c in zip(res, cts)
                     if c is not None and r.requires_grad]
            if not pairs or not data:
                grads = []
            else:
                grads = torch.autograd.grad(
                    [r for r, _ in pairs], [primal[n] for n in data],
                    [c for _, c in pairs], allow_unused=True)
    except (RuntimeError, TypeError, ValueError, NotImplementedError):
        return None
    res = [(n, g != 0 if g is not None else
            torch.zeros(_shape(n), dtype=torch.bool, device=dev))
           for n, g in zip(data, grads)]
    any_out = _any(outs)
    res += [(n, torch.full(_shape(n), any_out, dtype=torch.bool,
                           device=dev)) for n in index_nodes]
    return res


def _rule_indexed(node, outs, env):
    res = _vjp(node, outs, env, _index_nodes(node))
    return res if res is not None else _rule_fallback(node, outs, env)


def _rule_vjp(node, outs, env):
    res = _vjp(node, outs, env, ())
    return res if res is not None else _rule_fallback(node, outs, env)


def _rule_matmul(node, outs, env):
    p, t = _packet(node), outs
    args = [n for n in node.args if isinstance(n, fx.Node)]
    res = []
    if p in (aten.addmm, aten.baddbmm, aten.addmv):
        bias, args = args[0], args[1:]
        res.append((bias, _reduce_to(t, _shape(bias))))
    a, b = args[0], args[1]
    sa, sb = _shape(a), _shape(b)
    if p in (aten.mm, aten.addmm):
        res += [(a, t.any(1, keepdim=True).expand(sa)),
                (b, t.any(0, keepdim=True).expand(sb))]
    elif p in (aten.bmm, aten.baddbmm):
        res += [(a, t.any(2, keepdim=True).expand(sa)),
                (b, t.any(1, keepdim=True).expand(sb))]
    elif p in (aten.mv, aten.addmv):
        res += [(a, t.unsqueeze(1).expand(sa)), (b, _full(sb, t.any(), t))]
    else:                                     # dot, vdot
        res += [(a, _full(sa, t.any(), t)), (b, _full(sb, t.any(), t))]
    return res


def _rule_fft(node, outs, env):
    src = node.args[0]
    shp = _shape(src)
    return [(src, _coupled(outs, shp, _dims(_bound(node)["dim"], len(shp))))]


def _rule_coupled(node, outs, env):
    src = node.args[0]
    shp = _shape(src)
    b = _bound(node)
    p = _packet(node)
    if "dim" in b:
        dims = _dims(b["dim"], len(shp))
    elif p in (aten.max, aten.min, aten.all, aten.any, aten.prod,
               aten.argmax, aten.argmin, aten.median, aten.nanmedian,
               aten.count_nonzero, aten.aminmax):
        dims = None
    else:
        return _rule_fallback(node, outs, env)
    return [(src, _coupled(_or(outs), shp, dims))]


def _rule_cumulative(node, outs, env):
    src = node.args[0]
    t = _or(outs)
    return [(src, _suffix(t, int(_bound(node)["dim"]) % max(t.dim(), 1)))]


def _rule_uninitialized(node, outs, env):
    raise UnattributedTensorError(
        f"participation: an output reads memory allocated by "
        f"{op_name(node)} ({node.name}"
        + (f" at {node_source(node)}" if node_source(node) else "")
        + ") that no op in the traced graph wrote: a kernel launched "
        "outside a registered custom op?  Its inputs cannot be "
        "attributed, so no mask is given")


def classify_rule(node: fx.Node) -> str:
    """Which taint rule class handles ``node`` (for provenance: the
    static analyzer's reader records name it)."""
    if node.op != "call_function":
        return node.op
    if node.target is operator.getitem:
        return "getitem"
    p = _packet(node)
    if p is None:
        return "fallback"
    if p in _UNINITIALIZED:
        return "uninitialized"
    if p in _CREATORS or p in _RANDOM_FILLS or \
            node.target is aten.bernoulli.p:
        return "creator"
    if p in _IDENTITY:
        return "elementwise"
    if p in _STRUCTURAL:
        return "structural"
    if p in _INDEXED:
        return "indexed"
    if p in _VJP_STRUCTURAL:
        return "vjp_structural"
    if p in _MATMUL:
        return "matmul"
    if p in _FFT:
        return "fft"
    if p in _COUPLED:
        return "reduce_axes"
    if p in _CUMULATIVE:
        return "cumulative"
    if not str(p).startswith("aten."):
        return "custom_op"
    if torch.Tag.pointwise in getattr(node.target, "tags", ()):
        return "elementwise"
    return "fallback"


_RULES: Dict[str, Callable] = {
    "uninitialized": _rule_uninitialized,
    "creator": lambda node, outs, env: [],
    "elementwise": lambda node, outs, env: (
        _rule_identity(node, outs, env)
        if _packet(node) in _IDENTITY else _rule_pointwise(node, outs, env)),
    "structural": _rule_structural,
    "indexed": _rule_indexed,
    "vjp_structural": _rule_vjp,
    "matmul": _rule_matmul,
    "fft": _rule_fft,
    "reduce_axes": _rule_coupled,
    "cumulative": _rule_cumulative,
    "custom_op": _rule_fallback,
    "fallback": _rule_fallback,
}


# --------------------------------------------------------------------------
# Graph walks
# --------------------------------------------------------------------------

def read_inputs(node: fx.Node) -> List[fx.Node]:
    """The tensor inputs whose values ``node`` reads at all (the reads
    liveness walk's edges): creators read none, ``copy`` and ``fill`` not
    the tensor they overwrite."""
    rule = classify_rule(node)
    if rule in ("creator", "uninitialized"):
        return []
    p = _packet(node)
    if p is aten.copy:
        return [n for n in _flat_nodes(_bound(node)["src"])]
    if p is aten.fill:
        v = _bound(node).get("value")
        return [v] if _is_tensor_node(v) else []
    if node.target is operator.getitem:
        return [node.args[0]]
    return _input_nodes(node)


def _outputs(gm: fx.GraphModule) -> List[fx.Node]:
    out = next(n for n in gm.graph.nodes if n.op == "output")
    return [n for n in _flat_nodes(out.args) if _is_tensor_node(n)]


def _placeholders(gm: fx.GraphModule) -> List[fx.Node]:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def read_leaves(ts: TracedStep) -> List[bool]:
    """Per leaf: does any output read it (transitively)?  The cheap
    whole-leaf pre-pass; raises like the full walk when a live read
    reaches uninitialized memory."""
    live = set(_outputs(ts.gm))
    for node in reversed(list(ts.gm.graph.nodes)):
        if node not in live or node.op != "call_function":
            continue
        if classify_rule(node) == "uninitialized":
            _rule_uninitialized(node, None, None)
        live.update(read_inputs(node))
    return [p in live for p in _placeholders(ts.gm)]


def _storage_key(t: torch.Tensor):
    """The identity of ``t``'s memory (views share it); None for a tensor
    that holds no bytes."""
    if t.numel() == 0:
        return None
    return (t.device.type, t.device.index, t.untyped_storage().data_ptr())


class _ReadsMode(TorchDispatchMode):
    """Records, as ``fn`` runs, which state leaves the contents of each
    storage derive from: a bitset per storage, the OR of the op's inputs'
    sets on every output.  Coarser than the graph walk (a storage, not an
    element; every op reads all of its inputs but those a creator takes
    for their shape), so a leaf it calls unread is unread."""

    def __init__(self, leaves: Sequence[torch.Tensor]):
        super().__init__()
        self.tags: Dict[Any, int] = {}
        self.uninit: Dict[Any, str] = {}
        self.state: Dict[Any, int] = {}
        for i, leaf in enumerate(leaves):
            k = _storage_key(leaf)
            if k is not None:
                self.tags[k] = self.tags.get(k, 0) | (1 << i)
                self.state[k] = i

    def read(self, t: torch.Tensor, reader: str) -> int:
        k = _storage_key(t)
        if k in self.uninit:
            raise UnattributedTensorError(
                f"reads walk: {reader} reads memory allocated by "
                f"{self.uninit[k]} that no op wrote: a kernel launched "
                "outside a registered custom op?  Its inputs cannot be "
                "attributed")
        return self.tags.get(k, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view:
            return func(*args, **kwargs)
        bound = dict(zip((a.name for a in func._schema.arguments), args))
        bound.update(kwargs)
        written = [t for a in func._schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write
                   for t in _tensors(bound.get(a.name))]
        wkeys = {_storage_key(t) for t in written} - {None}
        for k in wkeys & self.state.keys():
            raise RuntimeError(
                f"reads walk: {func} writes state leaf {self.state[k]} in "
                "place; fn must be functional, as torch.func needs")
        ins = _tensors((args, kwargs))
        tag = 0
        if func.overloadpacket not in _NO_READS:
            for t in ins:
                # a written input's old contents may stay (a partial
                # write): its set is kept, an uninitialized one is not read
                if _storage_key(t) in wkeys:
                    tag |= self.tags.get(_storage_key(t), 0)
                else:
                    tag |= self.read(t, str(func))
        out = func(*args, **kwargs)
        for k in wkeys:
            self.tags[k] = self.tags.get(k, 0) | tag
            self.uninit.pop(k, None)
        in_keys = {_storage_key(t) for t in ins}
        for t in _tensors(out):
            k = _storage_key(t)
            if k is None or k in wkeys:
                continue
            if k in in_keys:
                self.tags[k] |= tag
                continue
            self.tags[k] = tag          # fresh memory: an old set is stale
            if func.overloadpacket in _UNINITIALIZED:
                self.uninit[k] = str(func)
            else:
                self.uninit.pop(k, None)
        return out


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def run_reads(fn: Callable[[Any], Any], treedef, leaves):
    """Per leaf: does any output read it (transitively)?  Found by running
    ``fn`` once under no_grad with a dispatch mode that follows every
    aten op's inputs to its outputs (:class:`_ReadsMode`), with no trace:
    the cost is one forward plus a few µs an op.  Host reads (``int(t)``,
    ``.item()``) run as they are, so any ``fn`` that the AD sweep can
    differentiate walks.  Returns (reads, whether an output is floating
    or complex).  Raises :class:`UnattributedTensorError` where an op reads
    ``empty`` memory no op wrote, and ``RuntimeError`` where ``fn`` writes
    a state leaf in place (before the write happens)."""
    from repro_torch import _tree

    mode = _ReadsMode(leaves)
    with torch.no_grad(), mode:
        out = _tree.leaves(fn(_tree.unflatten(treedef, list(leaves))))
    outs = [o for o in out if isinstance(o, torch.Tensor)]
    live = 0
    for o in outs:
        live |= mode.read(o, "an output")
    return ([bool(live >> i & 1) for i in range(len(leaves))],
            any(o.is_floating_point() or o.is_complex() for o in outs))


def _index_operands(node: fx.Node) -> List[fx.Node]:
    """Inputs whose concrete values the walk reads: index operands."""
    if node.op == "call_function" and _packet(node) in _INDEXED:
        return _index_nodes(node)
    return []


def _shape_operands(node: fx.Node) -> List[fx.Node]:
    """Inputs whose values the traced graph baked in as output shapes."""
    if node.op == "call_function" and _packet(node) in _SHAPE_BAKING:
        return _input_nodes(node)
    return []


def _feeding(ts: TracedStep, consulted) -> frozenset:
    """Leaf positions that (transitively) feed a ``consulted`` operand."""
    feeding: Set[fx.Node] = set()
    for node in reversed(list(ts.gm.graph.nodes)):
        feeding.update(consulted(node))
        if node in feeding:
            feeding.update(_flat_nodes((node.args, node.kwargs)))
    return frozenset(i for i, p in enumerate(_placeholders(ts.gm))
                     if p in feeding)


def index_feeding_leaves(ts: TracedStep) -> frozenset:
    """Leaf positions whose *values* can change the masks: those feeding
    an index operand or a value-dependent output shape.  A leaf outside
    the set changes no mask by changing value, so a value-sensitive cache
    (the static-prune cache) may key on a digest of exactly these."""
    return _feeding(ts, lambda n: _index_operands(n) + _shape_operands(n))


def shape_baking_leaves(ts: TracedStep) -> frozenset:
    """Leaf positions whose values the graph baked in as output shapes:
    the trace cache re-traces when they change."""
    return _feeding(ts, _shape_operands)


class _KeepInterpreter(fx.Interpreter):
    """Runs the graph once, keeping the values of the nodes in ``keep``."""

    def __init__(self, gm: fx.GraphModule, keep: Set[fx.Node]):
        super().__init__(gm, garbage_collect_values=True)
        self.keep = keep
        self.kept: Dict[fx.Node, Any] = {}

    def run_node(self, n: fx.Node) -> Any:
        val = super().run_node(n)
        if n in self.keep:
            self.kept[n] = val
        return val


def backward_taint(ts: TracedStep) -> List[torch.Tensor]:
    """The participation walk over a traced step: one shaped bool tensor
    per leaf (on the leaves' device), True == read (transitively, before
    overwrite) by some output.  Shared by :func:`participation` and the
    static analyzer (``repro_torch.analysis.analyze_static``)."""
    gm = ts.gm
    nodes = list(gm.graph.nodes)
    keep = {i for n in nodes if _packet(n) in _INDEXED
            for i in _index_nodes(n)}
    env: Dict[fx.Node, Any] = {}
    if keep:
        interp = _KeepInterpreter(gm, keep)
        with torch.no_grad():
            interp.run(*ts.leaves)
        env = interp.kept
    dev = ts.leaves[0].device if ts.leaves else torch.device("cpu")
    taint: Dict[fx.Node, Any] = {}

    def add(n, t):
        if not isinstance(n, fx.Node) or t is None or n.op == "get_attr":
            return
        cur = taint.get(n)
        taint[n] = t if cur is None else cur | t

    for n in _outputs(gm):
        add(n, torch.ones(_shape(n), dtype=torch.bool, device=dev))
    for node in reversed(nodes):
        if node.op != "call_function":
            continue
        t = taint.pop(node, None)
        if t is None:
            continue
        if node.target is operator.getitem:
            src, i = node.args
            outs = taint.get(src)
            if outs is None:
                outs = [None] * len(_val(src))
                taint[src] = outs
            outs[i] = t if outs[i] is None else outs[i] | t
            continue
        if not _any(t):
            continue
        if isinstance(t, list):
            t = [o if o is not None else
                 torch.zeros(_shape(node, i), dtype=torch.bool, device=dev)
                 if isinstance(_val(node)[i], torch.Tensor) else None
                 for i, o in enumerate(t)]
        for n, ct in _RULES[classify_rule(node)](node, t, env):
            add(n, ct)
    return [taint.get(p, torch.zeros(_shape(p), dtype=torch.bool,
                                     device=dev))
            for p in _placeholders(gm)]


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def participation(fn: Callable[[Any], Any], state: Any, *,
                  config: ScrutinyConfig = ScrutinyConfig(),
                  device=None) -> CriticalityReport:
    """Element-granular read-participation analysis of ``fn`` at ``state``.

    Same contract and report type as :func:`repro_torch.core.scrutinize`:
    the mask marks an element critical iff the rest of the program
    transitively reads it before overwriting it.  ``device``: where the
    graph runs and the walk's taints live; the card unless ``"cpu"`` is
    asked for.  Integer and bool leaves follow ``config.leaf_policy``.
    """
    ts = traced_step(fn, state, device=device)
    in_taints = backward_taint(ts)
    reports: Dict[str, LeafReport] = {}
    for name, leaf, t in zip(ts.names, ts.leaves, in_taints):
        pol = config.leaf_policy(leaf)
        n = leaf.numel()
        if pol in (LeafPolicy.AD, LeafPolicy.HORIZON):
            mask = t.reshape(-1).cpu().numpy().copy()
        else:
            mask = np.full(n, pol == LeafPolicy.ALWAYS_CRITICAL)
        dt = dtype_name(leaf.dtype)
        table = RegionTable.from_mask(mask, itemsize=itemsize(dt))
        table.validate()
        reports[name] = LeafReport(name=name, shape=tuple(leaf.shape),
                                   dtype=dt, policy=pol, mask=mask,
                                   table=table, magnitude=None)
    return CriticalityReport(leaves=reports)
