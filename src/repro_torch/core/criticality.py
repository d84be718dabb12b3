"""AD-based element criticality analysis (the paper's §III, in PyTorch).

``scrutinize(fn, state)`` treats ``fn`` — *the rest of the program after the
checkpoint* — as a function of the checkpointed state and computes, with
reverse-mode AD (``torch.func.vjp``), the derivative of the output w.r.t.
every element of every state leaf.  Elements whose derivative is zero under
every probe are **uncritical** and may be left out of the checkpoint.

K-probe union: K dense random output cotangents (and optionally jittered
primals); an element is uncritical only if its gradient vanishes under all.
Integer/bool leaves follow an explicit policy (ALWAYS_CRITICAL by default).

Device engine (the default): ``fn`` is linearized once (one
``torch.func.vjp``) and its ``vjp_fn`` is re-applied per probe; max-|grad|
accumulators stay on the leaves' device and are folded in place; the masks
are thresholded and bit-packed there by the K1 kernel
(``kernels/mask_pack.threshold_bitpack``).  Only 1 bit/element plus 4 B per
1024-element tile can cross D2H, and the result is a :class:`DeviceReport`
whose words stay resident for the device save path.  Host engine: every
probe's full gradients move to the host, as in the reference.  Both draw
their cotangents from the same seeded generators, so their masks agree
word for word.

``fn`` must be functional for ``torch.func``: an in-place op on a state
leaf inside ``fn`` raises.  A structural pre-pass (``scrutinize_graph_reads``;
``ScrutinyConfig.graph_prepass``, the reference's jaxpr pre-pass)
zero-masks the leaves that reach no output without running a backward
pass for them: it runs ``fn`` once under a dispatch mode that follows
each aten op's inputs to its outputs (``taint.run_reads``), with no trace.
``static_prune`` takes the full static analyzer instead, over a traced
aten graph; one trace per (fn, state structure) serves it, participation
(``core/taint.py``) and the static analyzer (``traced_step``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch import obs as obs_mod
from repro_torch._tensors import (check_on, dtype_name, itemsize,
                                  resolve_device)
from repro_torch.core.bitset import BitMask
from repro_torch.core.policy import LeafPolicy, ScrutinyConfig
from repro_torch.core.regions import RegionTable
from repro_torch.kernels.mask_pack import ops as mask_ops


# --------------------------------------------------------------------------
# Shared trace cache
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TracedStep:
    """One traced (fn, state-structure) pair, shared by every consumer.

    ``gm`` is ``fn`` as a flat leaves→leaves aten graph: traced with
    ``make_fx`` (``tracing_mode="real"``, under ``no_grad``) through
    ``torch.func.functionalize``, so it holds no in-place op; placeholders
    correspond 1:1 with the flattened state leaves, the output's tensors
    with the flattened outputs.  Participation, the static analyzer and
    the ``static_prune`` pre-pass consume the *same* trace (``trace_s``;
    ``cached`` marks a cache hit, which costs only the flatten).  ``sig``
    is the structure key within ``fn``'s caches (None when nothing is
    cached);
    value-sensitive caches layered on the trace (the static-prune cache)
    key on it plus a digest of the leaves whose values matter.
    """

    gm: Any                           # torch.fx.GraphModule
    names: List[str]
    treedef: Any
    leaves: List[torch.Tensor]
    trace_s: float
    cached: bool
    sig: Any = None


# Per-fn caches (traces, index-feeding sets, static prune sets), held
# weakly on fn: a trace's constants (a closure's tensors: an engine's
# parameters) live no longer than the fn that closes over them.
_FN_CACHES: "weakref.WeakKeyDictionary[Any, OrderedDict]" = \
    weakref.WeakKeyDictionary()
_FN_CACHE_MAX = 16


def _fn_cache(fn) -> Optional[OrderedDict]:
    """``fn``'s cache, None when ``fn`` cannot be held weakly."""
    try:
        return _FN_CACHES.setdefault(fn, OrderedDict())
    except TypeError:
        return None


def _cache_put(cache: OrderedDict, key, value) -> None:
    cache[key] = value
    while len(cache) > _FN_CACHE_MAX:
        cache.popitem(last=False)


def _value_digest(leaves, positions) -> tuple:
    """Digest of the leaves at ``positions`` (their values cross D2H)."""
    parts = []
    for i in sorted(positions):
        arr = leaves[i].detach().cpu().contiguous()
        parts.append((i, tuple(arr.shape), str(arr.dtype), hashlib.blake2b(
            arr.reshape(-1).view(torch.uint8).numpy().tobytes(),
            digest_size=16).digest()))
    return tuple(parts)


def _trace(fn, treedef, leaves):
    from torch.fx.experimental.proxy_tensor import make_fx

    def flat_fn(*ls):
        return tuple(_tree.leaves(fn(_tree.unflatten(treedef, list(ls)))))

    with torch.no_grad():
        return make_fx(torch.func.functionalize(flat_fn),
                       tracing_mode="real")(*leaves)


def traced_step(fn: Callable[[Any], Any], state: Any, *,
                device=None) -> TracedStep:
    """Trace ``fn`` as a flat leaves→leaves aten graph on ``device`` (the
    card unless ``"cpu"`` is asked for), cached per (fn, treedef, leaf
    shapes/dtypes, device) while ``fn`` lives.  The graph depends on leaf
    values only where
    an op's output shape does (``nonzero``, ``repeat_interleave``, ...;
    a value-dependent branch fails the trace); a cached graph is re-traced
    when the leaves feeding such an op changed value."""
    from repro_torch.core import taint

    dev = resolve_device(device)
    names, treedef, leaves = _flat_state(state, dev, "trace")
    cache = _fn_cache(fn)
    sig = None
    if cache is not None:
        try:
            sig = (treedef, tuple((tuple(l.shape), str(l.dtype))
                                  for l in leaves), str(dev))
            hash(sig)
        except TypeError:
            sig = None
    hit = cache.get(("trace", sig)) if sig is not None else None
    if hit is not None:
        graph, baked = hit
        if not baked or _value_digest(leaves, baked[0]) == baked[1]:
            cache.move_to_end(("trace", sig))
            return TracedStep(graph, names, treedef, leaves, trace_s=0.0,
                              cached=True, sig=sig)
    t0 = time.perf_counter()
    graph = _trace(fn, treedef, leaves)
    trace_s = time.perf_counter() - t0
    ts = TracedStep(graph, names, treedef, leaves, trace_s, cached=False,
                    sig=sig)
    if sig is not None:
        pos = taint.shape_baking_leaves(ts)
        _cache_put(cache, ("trace", sig),
                   (graph, (pos, _value_digest(leaves, pos)) if pos
                    else None))
    return ts


def scrutinize_graph_reads(fn: Callable[[Any], Any], state: Any, *,
                           traced: Optional[TracedStep] = None,
                           device=None) -> Dict[str, bool]:
    """Cheap structural pre-pass (the reference's
    ``scrutinize_jaxpr_reads``): which *whole leaves* any output reads.
    A leaf no output reads is uncritical in toto without a backward pass;
    element-granular analysis still needs AD (the paper's point).
    ``traced``: an already-traced :class:`TracedStep`, whose aten graph is
    walked; omitted, ``fn`` runs once under the reads walk's dispatch mode
    (``taint.run_reads``: no trace, and host reads run as they are)."""
    from repro_torch.core import taint

    if traced is not None:
        return dict(zip(traced.names, taint.read_leaves(traced)))
    names, treedef, leaves = _flat_state(state, resolve_device(device),
                                         "reads walk")
    return dict(zip(names, taint.run_reads(fn, treedef, leaves)[0]))


def _flat_state(state, dev: torch.device, what: str):
    """(names, treedef, leaves) of ``state``, every leaf on ``dev``."""
    named, treedef = _tree.flatten_with_names(state)
    leaves = []
    for name, leaf in named:
        check_on(leaf, dev, f"{what} leaf {name!r}")
        leaves.append(leaf.detach() if isinstance(leaf, torch.Tensor)
                      else torch.as_tensor(leaf, device=dev))
    return [n for n, _ in named], treedef, leaves


@dataclasses.dataclass
class _Prepass:
    """Per-call prepass result: the dead-leaf set plus its accounting."""

    dead: frozenset = frozenset()
    reads_s: float = 0.0
    trace_s: float = 0.0
    trace_cached: bool = False
    static_prune_s: float = 0.0
    static_prune_cached: bool = False
    static_pruned_elements: int = 0
    # leaves pruned on *taint* evidence only (read, but statically
    # all-dead): they never enter the vjp sweep, so the soundness gate
    # cannot verify them; it flags them instead.
    taint_pruned_names: Tuple[str, ...] = ()
    # whether the traced graph has a floating or complex output: checked
    # even when every AD leaf is pruned (the sweep would raise otherwise)
    differentiable: bool = True


def _prepass_for(fn, state, names, treedef, leaves, policies,
                 config: ScrutinyConfig, device) -> _Prepass:
    """The prepass dead-leaf set for *this* call's state values.

    The static prune set is never cached on structure alone: a ring-buffer
    pointer moving from an out-of-range slot to a live one changes which
    leaves the static analyzer proves dead.  The key is (trace signature,
    policies, digest of the index-feeding leaves' values): states that
    differ only in other values hit the cache."""
    pre = _Prepass()
    ad = [i for i, p in enumerate(policies)
          if p in (LeafPolicy.AD, LeafPolicy.HORIZON)]
    if not ad or not (config.graph_prepass or config.static_prune):
        return pre
    if not config.static_prune:
        from repro_torch.core.taint import run_reads

        t0 = time.perf_counter()
        used, pre.differentiable = run_reads(fn, treedef, leaves)
        pre.reads_s = time.perf_counter() - t0
        pre.dead = frozenset(i for i in ad if not used[i])
        return pre
    ts = traced_step(fn, state, device=device)
    pre.trace_s, pre.trace_cached = ts.trace_s, ts.cached
    out = next(n for n in ts.gm.graph.nodes if n.op == "output")
    pre.differentiable = any(
        isinstance(v, torch.Tensor) and (v.is_floating_point()
                                         or v.is_complex())
        for v in (getattr(n, "meta", {}).get("val")
                  for n in _tree.leaves(out.args)))
    used = scrutinize_graph_reads(fn, state, traced=ts)

    from repro_torch.analysis.static import analyze_static
    from repro_torch.core.taint import index_feeding_leaves

    t0 = time.perf_counter()
    cache = _fn_cache(fn) if ts.sig is not None else None
    cache_key = None
    if cache is not None:
        feed = cache.get(("feed", ts.sig))
        if feed is None:
            feed = index_feeding_leaves(ts)
            _cache_put(cache, ("feed", ts.sig), feed)
        cache_key = ("prune", ts.sig, tuple(policies),
                     _value_digest(ts.leaves, feed))
    if cache_key is not None and cache_key in cache:
        cache.move_to_end(cache_key)
        pre.dead, pre.taint_pruned_names = cache[cache_key]
        pre.static_prune_cached = True
    else:
        # the element-wise static masks prove more leaves dead than the
        # reads walk (state written before it is read is live to the
        # reads walk but all-False statically)
        static = analyze_static(fn, state, config=config, traced=ts)
        pre.dead = frozenset(i for i in ad
                             if not static[names[i]].mask.any())
        pre.taint_pruned_names = tuple(sorted(
            names[i] for i in pre.dead if used[names[i]]))
        if cache_key is not None:
            _cache_put(cache, cache_key, (pre.dead, pre.taint_pruned_names))
    pre.static_prune_s = time.perf_counter() - t0
    pre.static_pruned_elements = sum(leaves[i].numel() for i in pre.dead)
    return pre


@dataclasses.dataclass(frozen=True)
class LeafReport:
    """Criticality verdict for one state leaf (``dtype`` is its name)."""

    name: str
    shape: Tuple[int, ...]
    dtype: str
    policy: LeafPolicy
    mask: np.ndarray  # flat bool, True == critical
    table: RegionTable
    # max |∂out/∂x| over probes, flat; only kept when tiering is enabled.
    magnitude: Optional[np.ndarray] = None

    @property
    def total(self) -> int:
        return self.table.size

    @property
    def critical(self) -> int:
        return self.table.critical_count

    @property
    def uncritical(self) -> int:
        return self.table.uncritical_count

    @property
    def uncritical_rate(self) -> float:
        return self.table.uncritical_rate

    @property
    def all_critical(self) -> bool:
        return self.critical == self.total

    def device_mask(self, device) -> torch.Tensor:
        """Flat bool mask on ``device``.  Host reports upload it (1 B per
        element H2D); :class:`DeviceLeafReport` returns its resident one."""
        return torch.from_numpy(np.ascontiguousarray(self.mask)).to(device)

    def device_words(self, device) -> torch.Tensor:
        """The mask as ``np.packbits`` words on ``device`` (1 bit per
        element H2D), as K2 and K4 read it."""
        return torch.from_numpy(np.packbits(self.mask)).to(device)


@dataclasses.dataclass(frozen=True)
class CriticalityReport:
    """scrutinize() result: one LeafReport per state leaf, + aggregates."""

    leaves: Dict[str, LeafReport]
    # Engine accounting (probes run, measured D2H bytes, …); not part of
    # report equality.
    stats: Optional[Dict[str, Any]] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __getitem__(self, name: str) -> LeafReport:
        return self.leaves[name]

    @property
    def total_elements(self) -> int:
        return sum(l.total for l in self.leaves.values())

    @property
    def uncritical_elements(self) -> int:
        return sum(l.uncritical for l in self.leaves.values())

    @property
    def uncritical_rate(self) -> float:
        t = self.total_elements
        return self.uncritical_elements / t if t else 0.0

    @property
    def full_bytes(self) -> int:
        return sum(l.table.full_bytes for l in self.leaves.values())

    @property
    def optimized_bytes(self) -> int:
        return sum(l.table.optimized_bytes for l in self.leaves.values())

    @property
    def payload_bytes(self) -> int:
        return sum(l.table.payload_bytes for l in self.leaves.values())

    @property
    def storage_saved(self) -> float:
        """Engineering accounting (payload + aux structures)."""
        fb = self.full_bytes
        return 1.0 - self.optimized_bytes / fb if fb else 0.0

    @property
    def paper_storage_saved(self) -> float:
        """Paper Table III accounting (payload only; aux not charged)."""
        fb = self.full_bytes
        return 1.0 - self.payload_bytes / fb if fb else 0.0

    def masks(self) -> Dict[str, np.ndarray]:
        return {k: v.mask for k, v in self.leaves.items()}

    def summary_rows(self):
        for name, l in sorted(self.leaves.items()):
            yield (name, l.uncritical, l.total, l.uncritical_rate,
                   l.policy.value)


class DeviceLeafReport:
    """Criticality verdict for one leaf with the mask resident on device.

    Duck-types :class:`LeafReport`: ``mask`` / ``table`` / ``magnitude``
    materialize to the host lazily (and cache), costing one D2H of
    1 bit/element (packed words) resp. one accumulator-width transfer
    (magnitudes) on first access, recorded in the report's
    ``stats["d2h_bytes"]``.  ``device_words()`` hands the resident words to
    the device save path as they are; ``device_mask()`` expands them on
    device (and caches the byte mask) for K5 and the NPB restart.  A leaf
    with no critical element (a training state's Adam moments) gives an
    empty result: zero words, mask and region table made on the host
    without reading the resident words.
    """

    __slots__ = ("name", "shape", "dtype", "policy", "n", "device",
                 "words_dev", "magnitude_dev", "_critical", "_stats",
                 "_words_host", "_mask", "_mask_dev", "_table", "_magnitude")

    def __init__(self, name: str, shape, dtype: str, policy: LeafPolicy,
                 n: int, critical: int, device, words_dev=None,
                 magnitude_dev=None, stats: Optional[Dict[str, Any]] = None):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = str(dtype)
        self.policy = policy
        self.n = int(n)
        self.device = torch.device(device)
        self._critical = int(critical)
        self.words_dev = words_dev          # bit-packed uint8 (or None)
        self.magnitude_dev = magnitude_dev  # flat max-|grad| (or None)
        self._stats = stats if stats is not None else {}
        self._words_host = None
        self._mask = None
        self._mask_dev = None
        self._table = None
        self._magnitude = None

    @property
    def total(self) -> int:
        return self.n

    @property
    def critical(self) -> int:
        return self._critical

    @property
    def uncritical(self) -> int:
        return self.n - self._critical

    @property
    def uncritical_rate(self) -> float:
        return self.uncritical / self.n if self.n else 0.0

    @property
    def all_critical(self) -> bool:
        return self._critical == self.n

    def device_mask(self, device=None) -> torch.Tensor:
        """Flat bool mask on the report's device (cached).  Policy leaves
        build theirs directly; AD leaves expand the resident words."""
        del device                       # the mask is resident already
        if self._mask_dev is None:
            if self.words_dev is not None:
                self._mask_dev = mask_ops.expand_mask_bits(self.words_dev,
                                                           n=self.n)
            else:
                fill = self.all_critical and self.n > 0
                self._mask_dev = torch.full((self.n,), fill,
                                            dtype=torch.bool,
                                            device=self.device)
        return self._mask_dev

    def device_words(self, device=None) -> torch.Tensor:
        """The mask as ``np.packbits`` words on the report's device: the
        resident words of an AD leaf, full or empty words (tail bits 0,
        as ``BitMask.full``) for a policy leaf.  Nothing is cached."""
        del device                       # the words are resident already
        if self.words_dev is not None:
            return self.words_dev
        full = self.all_critical and self.n > 0
        words = torch.full(((self.n + 7) // 8,), 0xFF if full else 0,
                           dtype=torch.uint8, device=self.device)
        if full and self.n % 8:
            words[-1] = (0xFF << (8 - self.n % 8)) & 0xFF
        return words

    @property
    def mask_words(self) -> np.ndarray:
        """Bit-packed mask words on the host (``np.packbits`` order — also
        the checkpoint bitmap aux encoding)."""
        if self._words_host is None:
            if self.words_dev is not None and self._critical:
                w = self.words_dev.cpu().numpy()
                self._stats["d2h_bytes"] = \
                    self._stats.get("d2h_bytes", 0) + w.nbytes
            else:
                w = BitMask.full(self.n, self.all_critical and self.n > 0).words
            self._words_host = w
        return self._words_host

    def bitmask(self) -> BitMask:
        return BitMask.from_words(self.mask_words, self.n)

    @property
    def mask(self) -> np.ndarray:
        if self._mask is None:
            self._mask = (np.unpackbits(self.mask_words, count=self.n)
                          .astype(bool) if self._critical
                          else np.zeros(self.n, bool))
        return self._mask

    @property
    def table(self) -> RegionTable:
        if self._table is None:
            if not self._critical:
                self._table = RegionTable(np.zeros((0, 2), np.int64),
                                          self.n, itemsize(self.dtype))
                return self._table
            t = RegionTable.from_words(self.mask_words, self.n,
                                       itemsize(self.dtype))
            t.validate()
            self._table = t
        return self._table

    @property
    def magnitude(self) -> Optional[np.ndarray]:
        if self._magnitude is None and self.magnitude_dev is not None:
            m = self.magnitude_dev.cpu().numpy()
            self._stats["d2h_bytes"] = \
                self._stats.get("d2h_bytes", 0) + m.nbytes
            self._magnitude = m
        return self._magnitude


class DeviceReport(CriticalityReport):
    """``scrutinize()`` result with device-resident masks (device engine).

    Satisfies the :class:`CriticalityReport` API through the lazy host
    materialization of :class:`DeviceLeafReport`, while
    ``leaves[name].device_words()`` stay resident for the checkpoint
    manager's device save path.
    """

    def __init__(self, leaves: Dict[str, DeviceLeafReport],
                 stats: Optional[Dict[str, Any]] = None):
        # bypass the frozen-dataclass parent's __setattr__
        object.__setattr__(self, "leaves", dict(leaves))
        object.__setattr__(self, "stats",
                           stats if stats is not None else {})

    def materialize(self) -> "DeviceReport":
        """Force host masks for every leaf; returns self."""
        for leaf in self.leaves.values():
            leaf.mask  # noqa: B018 - touching the lazy property is the point
        return self

    def reuse_unchanged(self, previous: CriticalityReport
                        ) -> "CriticalityReport":
        """Incremental re-scrutiny: compare this report's mask words with
        ``previous`` on device and reuse the previous leaf objects (with
        their cached host masks and tables) wherever they are equal.
        Returns ``previous`` itself when nothing changed, so the manager's
        differential chains (keyed on report identity) survive."""
        if not isinstance(previous, DeviceReport) or \
                set(self.leaves) != set(previous.leaves):
            return self
        verdict: Dict[str, bool] = {}
        for name, leaf in self.leaves.items():
            old = previous.leaves[name]
            if (not isinstance(old, DeviceLeafReport)
                    or old.shape != leaf.shape or old.dtype != leaf.dtype
                    or old.policy is not leaf.policy or old.n != leaf.n):
                verdict[name] = False
            elif leaf.critical != old.critical:
                verdict[name] = False       # count summaries already differ
            elif leaf.words_dev is None or old.words_dev is None:
                verdict[name] = (leaf.words_dev is None
                                 and old.words_dev is None)
            else:
                verdict[name] = torch.equal(leaf.words_dev, old.words_dev)
        unchanged = sum(verdict.values())
        self.stats["reused_leaves"] = unchanged
        self.stats["changed_leaves"] = len(verdict) - unchanged
        if unchanged == len(verdict):
            previous.stats.update(self.stats)
            return previous
        merged = {}
        for name, ok in verdict.items():
            leaf = previous.leaves[name] if ok else self.leaves[name]
            if ok and isinstance(leaf, DeviceLeafReport):
                # later lazy D2H of reused leaves lands in the live stats
                leaf._stats = self.stats
            merged[name] = leaf
        return DeviceReport(merged, self.stats)


# --------------------------------------------------------------------------
# Probe schedule + accumulation helpers (shared by both engines, so the
# host and device paths produce identical masks)
# --------------------------------------------------------------------------

def _generator(device: torch.device, seed: int, probe: int,
               stream: int) -> torch.Generator:
    """Generator for one probe's cotangents (stream 0) or jitter (1)."""
    digest = hashlib.blake2b(f"{seed}:{probe}:{stream}".encode(),
                             digest_size=8).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest, "little") >> 1)
    return gen


def _random_like_output(gen: torch.Generator, out_leaves):
    """Dense random cotangents for the differentiable output leaves."""
    return tuple(torch.randn(o.shape, dtype=o.dtype, device=o.device,
                             generator=gen) for o in out_leaves)


def _jitter_leaf(gen: torch.Generator, leaf: torch.Tensor, rel: float):
    noise = torch.randn(leaf.shape, dtype=torch.float32, device=leaf.device,
                        generator=gen).to(leaf.dtype)
    scale = leaf.abs().clamp_min(1.0).to(leaf.dtype)
    return leaf + rel * scale * noise


def _accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Max-|grad| accumulator dtype: f32, widened to f64 only for
    double-precision leaves so exact-zero semantics survive."""
    if dtype in (torch.float64, torch.complex128):
        return torch.float64
    return torch.float32


def _abs_mag(grad: torch.Tensor, accum: torch.dtype) -> torch.Tensor:
    """|grad| (complex → real magnitude; bf16 upcast after the abs)."""
    return grad.abs().to(accum).reshape(-1)


# --------------------------------------------------------------------------
# Sweep engine
# --------------------------------------------------------------------------

class _SweepEngine:
    """The multi-probe vjp sweep for one (fn, structure, config)."""

    def __init__(self, fn, treedef, leaves, policies, config: ScrutinyConfig,
                 device: torch.device, dead: frozenset = frozenset()):
        self.fn = fn
        self.treedef = treedef
        self.device = device
        self.seed = int(config.seed)
        self.probes = max(1, config.probes)
        self.jitter = float(config.input_jitter)
        ad = [i for i, p in enumerate(policies)
              if p in (LeafPolicy.AD, LeafPolicy.HORIZON)]
        self.dead = frozenset(dead) & set(ad)
        self.ad_idx: Tuple[int, ...] = tuple(i for i in ad
                                             if i not in self.dead)
        self.sizes = tuple(leaves[i].numel() for i in self.ad_idx)
        self.accum_dtypes = tuple(_accum_dtype(leaves[i].dtype)
                                  for i in self.ad_idx)

    def _g(self, diff_leaves, leaves):
        full = list(leaves)
        for i, leaf in zip(self.ad_idx, diff_leaves):
            full[i] = leaf
        out = self.fn(_tree.unflatten(self.treedef, full))
        out_leaves = tuple(o for o in _tree.leaves(out)
                           if isinstance(o, torch.Tensor)
                           and (o.is_floating_point() or o.is_complex()))
        if not out_leaves:
            raise ValueError(
                "scrutinize: fn produced no differentiable outputs; "
                "criticality via AD is undefined.")
        return out_leaves

    def sweep(self, leaves, fold: Callable[[int, torch.Tensor], None]):
        """Run every probe; ``fold(j, grad)`` consumes the gradient of the
        j-th swept leaf.  With ``input_jitter == 0`` ``fn`` is linearized
        once and its ``vjp_fn`` is reused for every probe; jittered probes
        (all but probe 0) re-linearize at their perturbed primal."""
        diff = [leaves[i] for i in self.ad_idx]

        def g(*dl):
            return self._g(dl, leaves)

        out, vjp_fn = torch.func.vjp(g, *diff)
        for p in range(self.probes):
            if self.jitter > 0.0 and p > 0:
                jgen = _generator(self.device, self.seed, p, 1)
                primal = [_jitter_leaf(jgen, l, self.jitter) for l in diff]
                out, vjp_fn = torch.func.vjp(g, *primal)
            cts = _random_like_output(
                _generator(self.device, self.seed, p, 0), out)
            for j, grad in enumerate(vjp_fn(cts)):
                fold(j, grad)


# --------------------------------------------------------------------------
# scrutinize
# --------------------------------------------------------------------------

def scrutinize(fn: Callable[[Any], Any], state: Any, *,
               config: ScrutinyConfig = ScrutinyConfig(),
               device=None) -> CriticalityReport:
    """Run the paper's AD criticality analysis on ``fn`` at ``state``.

    ``fn``: checkpoint-state → program output (pytree with at least one
    floating or complex tensor); functional, as ``torch.func`` needs.
    ``state``: pytree of tensors — the variables necessary for
    checkpointing.  ``device``: where the sweep runs; the card unless
    ``"cpu"`` is asked for.  Tensors on another device raise; numpy arrays
    and Python scalars are uploaded to ``device``.

    Returns a :class:`DeviceReport` (device engine) or a plain
    :class:`CriticalityReport` (``config.engine == "host"``).
    """
    dev = resolve_device(device)
    engine = config.engine
    if engine == "auto":
        engine = "device"
    if engine not in ("device", "host"):
        raise ValueError(f"unknown scrutiny engine {config.engine!r}")

    names, treedef, leaves = _flat_state(state, dev, "scrutinize")
    policies = [config.leaf_policy(l) for l in leaves]

    obs = obs_mod.get_obs()
    with obs.tracer.span("scrutiny.prepass", leaves=len(leaves)):
        pre = _prepass_for(fn, state, names, treedef, leaves, policies,
                           config, dev)
    eng = _SweepEngine(fn, treedef, leaves, policies, config, dev, pre.dead)
    if eng.dead and not pre.differentiable:
        raise ValueError("scrutinize: fn produced no differentiable "
                         "outputs; criticality via AD is undefined.")
    with obs.tracer.span("scrutiny.sweep", engine=engine,
                         probes=eng.probes, leaves=len(eng.ad_idx)):
        if engine == "host":
            rep = _scrutinize_host(eng, names, leaves, policies, config, pre)
        else:
            rep = _scrutinize_device(eng, names, leaves, policies, config,
                                     pre)
    if obs.enabled:
        obs.registry.counter("scrutiny.d2h_bytes").inc(
            int(rep.stats["d2h_bytes"]))
    return rep


def _base_stats(eng: _SweepEngine, engine: str,
                pre: _Prepass) -> Dict[str, Any]:
    return {"engine": engine, "probes": eng.probes, "d2h_bytes": 0,
            "sweep_leaves": len(eng.ad_idx), "dead_leaves": len(eng.dead),
            "sweep_elements": sum(eng.sizes),
            "prepass_reads_s": pre.reads_s,
            "prepass_trace_s": pre.trace_s,
            "prepass_trace_cached": pre.trace_cached,
            "static_prune_s": pre.static_prune_s,
            "static_prune_cached": pre.static_prune_cached,
            "static_pruned_elements": pre.static_pruned_elements,
            "static_taint_pruned_leaves": list(pre.taint_pruned_names)}


def _scrutinize_device(eng: _SweepEngine, names, leaves, policies,
                       config: ScrutinyConfig, pre: _Prepass) -> DeviceReport:
    stats = _base_stats(eng, "device", pre)
    mags: Dict[int, torch.Tensor] = {}
    if eng.ad_idx:
        accums = [torch.zeros(s, dtype=d, device=eng.device)
                  for s, d in zip(eng.sizes, eng.accum_dtypes)]

        def fold(j, grad):
            torch.maximum(accums[j], _abs_mag(grad, accums[j].dtype),
                          out=accums[j])

        eng.sweep(leaves, fold)
        mags = dict(zip(eng.ad_idx, accums))

    words: Dict[int, torch.Tensor] = {}
    counts: Dict[int, torch.Tensor] = {}
    for i, mag in mags.items():
        words[i], counts[i] = mask_ops.threshold_bitpack(mag, config.zero_tol)
    # one host sync for every per-tile count summary (4 B per tile)
    critical: Dict[int, int] = {}
    if counts:
        flat = torch.cat([counts[i] for i in mags]).cpu()
        stats["d2h_bytes"] += flat.numel() * flat.element_size()
        lo = 0
        for i in mags:
            k = counts[i].shape[0]
            critical[i] = int(flat[lo:lo + k].sum())
            lo += k

    reports: Dict[str, DeviceLeafReport] = {}
    for i, (name, leaf, pol) in enumerate(zip(names, leaves, policies)):
        n = leaf.numel()
        common = dict(name=name, shape=tuple(leaf.shape),
                      dtype=dtype_name(leaf.dtype), policy=pol, n=n,
                      device=leaf.device, stats=stats)
        if i in words:
            reports[name] = DeviceLeafReport(
                critical=critical[i], words_dev=words[i],
                magnitude_dev=mags[i], **common)
        elif pol == LeafPolicy.ALWAYS_CRITICAL:
            reports[name] = DeviceLeafReport(critical=n, **common)
        else:  # ALWAYS_UNCRITICAL, or an AD leaf no output reads
            reports[name] = DeviceLeafReport(critical=0, **common)
    return DeviceReport(reports, stats)


def _scrutinize_host(eng: _SweepEngine, names, leaves, policies,
                     config: ScrutinyConfig,
                     pre: _Prepass) -> CriticalityReport:
    """Reference engine: every probe's full gradients move to the host."""
    stats = _base_stats(eng, "host", pre)
    magnitudes: Dict[int, np.ndarray] = {}
    if eng.ad_idx:
        accum = [np.zeros(s, dtype=dtype_name(d))
                 for s, d in zip(eng.sizes, eng.accum_dtypes)]

        def fold(j, grad):
            gh = grad.detach().cpu()                 # D2H: the full gradient
            stats["d2h_bytes"] += gh.numel() * gh.element_size()
            mag = _abs_mag(gh, eng.accum_dtypes[j]).numpy()
            np.maximum(accum[j], mag, out=accum[j])

        eng.sweep(leaves, fold)
        magnitudes = dict(zip(eng.ad_idx, accum))

    reports: Dict[str, LeafReport] = {}
    for i, (name, leaf, pol) in enumerate(zip(names, leaves, policies)):
        n = leaf.numel()
        if i in magnitudes:
            mag = magnitudes[i]
            mask = mag > np.asarray(config.zero_tol, mag.dtype)
        elif pol == LeafPolicy.ALWAYS_CRITICAL:
            mask, mag = np.ones(n, dtype=bool), None
        else:  # ALWAYS_UNCRITICAL, or an AD leaf no output reads
            mask, mag = np.zeros(n, dtype=bool), None
        name_dt = dtype_name(leaf.dtype)
        table = RegionTable.from_mask(mask, itemsize=itemsize(name_dt))
        table.validate()
        reports[name] = LeafReport(
            name=name, shape=tuple(leaf.shape), dtype=name_dt, policy=pol,
            mask=mask, table=table, magnitude=mag)
    return CriticalityReport(leaves=reports, stats=stats)
