"""Per-arch partition rules, the leading-axis layout stand-in, and the
scrutinized scatter of one leaf (port of ``repro.distributed.sharding``).

**Partition rules.**  The mesh has axes (data, model) per pod, plus a
leading ``pod`` axis in the multi-pod configuration.  Data parallelism runs
over (pod, data); tensor parallelism over ``model``; experts shard their
leading expert axis over ``model``; FSDP additionally shards large
parameter matrices over the data axes.  The rules are the reference's,
name-based over the flattened parameter tree, written as plain functions
of a config, a leaf name, a shape and a mesh-shape dict
(``{"data": 8, "model": 4}``): each returns the spec as a tuple with one
entry per dim, ``None``, an axis name, or a tuple of axis names, as
``tuple(PartitionSpec)`` gives it.

**Layouts.**  A torch tensor lives on one device, so the port describes a
leaf split along its leading axis with ``LeadingAxisSharding``: row bounds,
a device and a process for each piece.  It answers
``devices_indices_map`` / ``addressable_devices_indices_map`` as the
reference's ``NamedSharding`` does for such a layout, which is what
ownership (``collective.process_segments``) and the coordinator's
restore targets (``leading_axis_device_segments``) read.

**Scatter.**  ``scatter_sharded_payload`` moves a leaf's critical payload
H2D and expands it with K4 on one device, under mask words the caller has
put there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch import obs as obs_mod
from repro_torch._tensors import from_host, host_copy_nbytes
from repro_torch.kernels.mask_pack import ops as mask_ops
from repro_torch.kernels.mask_pack.ref import BLOCK

Spec = Tuple[Any, ...]


def data_axes(mesh_shape: Dict[str, int]) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_shape else ("data",)


def param_spec(cfg, mesh_shape: Dict[str, int], name: str,
               shape: Sequence[int]) -> Spec:
    """Partition spec of one parameter leaf (name = '/'-joined path),
    before :func:`fit_spec`."""
    dp = data_axes(mesh_shape)
    fs = dp if cfg.fsdp else None  # FSDP shard axis group (or None)
    nd = len(shape)
    last = name.rsplit("/", 1)[-1]
    has_stack = "segments" in name or "blocks" in name  # leading scan dim

    def spec(*dims):
        """dims for the *logical* (unstacked) shape; None first if
        stacked."""
        return ((None,) + dims) if has_stack else dims

    logical_nd = nd - 1 if has_stack else nd

    if name == "embed":
        return ("model", fs)               # vocab over TP, d over FSDP
    if name == "lm_head":
        return (fs, "model")
    if last in ("scale", "bias", "lambda") or logical_nd <= 1:
        return spec(*(None,) * logical_nd)
    if "/moe/" in name or name.endswith("/moe"):
        if last == "router":
            return spec(None, None)
        if "shared" in name:
            if last in ("wi", "wg"):
                return spec(None, fs, "model")
            return spec(None, "model", fs)
        if last in ("wi", "wg"):       # (E, d, f)
            return spec("model", fs, None)
        if last == "wo":               # (E, f, d)
            return spec("model", None, fs)
    if last in ("wq", "wk", "wv", "wz", "wi", "wf", "wg",
                "wq_b", "wk_b", "wv_b", "w_in", "w_gate"):
        return spec(fs, "model")           # column parallel
    if last in ("wo", "w_out"):
        return spec("model", fs)           # row parallel
    if last in ("wq_a", "wkv_a"):
        return spec(fs, None)              # low-rank down-proj
    if last in ("bq", "bk", "bv"):
        return spec("model")
    if last == "conv":
        return spec(None, "model")
    if last in ("w_a", "w_x"):             # (r, r) LRU gates
        return spec(None, "model")
    if last in ("rz", "ri", "rf", "ro"):   # (H, hd, hd) sLSTM recurrent
        return spec("model", None, None)
    return spec(*(None,) * logical_nd)


def fit_spec(mesh_shape: Dict[str, int], spec: Spec, shape) -> Spec:
    """Drop axes whose size does not divide the dim, keeping the longest
    divisible prefix of a tuple entry; one entry per dim of ``shape``."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for d, n in zip(dims, shape):
        if d is None:
            out.append(None)
            continue
        axes = d if isinstance(d, tuple) else (d,)
        kept = []
        prod = 1
        for a in axes:
            sz = mesh_shape[a]
            if n % (prod * sz) == 0:
                kept.append(a)
                prod *= sz
            else:
                break
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    return tuple(out)


def _map_tree(tree, fn):
    named, treedef = _tree.flatten_with_names(tree)
    return _tree.unflatten(treedef, [fn(n, tuple(l.shape))
                                     for n, l in named])


def params_shardings(cfg, mesh_shape: Dict[str, int], params) -> Any:
    """The params tree (tensors, or ``device="meta"`` shapes) mapped to
    fitted specs."""
    return _map_tree(params, lambda name, shape: fit_spec(
        mesh_shape, param_spec(cfg, mesh_shape, name, shape), shape))


def batch_shardings(cfg, mesh_shape: Dict[str, int], batch, *,
                    seq_shard: bool = False) -> Any:
    """Batch dim over (pod, data); optional SP shards the seq dim over
    ``model``."""
    dp = data_axes(mesh_shape)
    sp = "model" if seq_shard else None

    def one(name, shape):
        nd = len(shape)
        if nd == 0:
            return ()
        if nd == 1:
            spec = (None,)
        elif nd == 2:   # (B, T)
            spec = (dp, sp)
        else:           # (B, T, d) embeddings / (B, T, 3) positions
            spec = (dp, sp) + (None,) * (nd - 2)
        return fit_spec(mesh_shape, spec, shape)

    return _map_tree(batch, one)


def cache_shardings(cfg, mesh_shape: Dict[str, int], cache) -> Any:
    """KV caches: batch over (pod, data), heads/latent dim over model."""
    dp = data_axes(mesh_shape)

    def one(name, shape):
        last = name.rsplit("/", 1)[-1]
        nd = len(shape)
        pre = (None,) if "seg" in name else ()    # stacked scan dim
        lnd = nd - len(pre)
        if last in ("k", "v", "xk", "xv") and lnd == 4:   # (B,S,K,hd)
            spec = pre + (dp, None, "model", None)
        elif last in ("c_kv", "k_pe") and lnd == 3:       # MLA latent
            spec = pre + (dp, None, None)
        elif last == "C" and lnd == 4:                    # (B,H,hd,hd)
            spec = pre + (dp, "model", None, None)
        elif lnd >= 2:
            spec = pre + (dp,) + (None,) * (lnd - 1)
        else:
            spec = pre + (None,) * lnd
        return fit_spec(mesh_shape, spec, shape)

    return _map_tree(cache, one)


def describe_shardings(cfg, mesh_shape: Dict[str, int], tree, shardings,
                       limit: int = 40) -> str:
    named = _tree.flatten_with_names(tree)[0]
    specs = _spec_leaves(shardings)
    lines = []
    for (name, leaf), sh in list(zip(named, specs))[:limit]:
        spec = getattr(sh, "spec", sh)
        lines.append(f"{name:<60} {str(tuple(leaf.shape)):<24} {spec}")
    return "\n".join(lines)


def _spec_leaves(tree) -> List[Any]:
    """Leaves of a tree of specs or layouts: a spec tuple, a layout and
    ``None`` are leaves; dicts (sorted keys) and lists are containers."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


# --------------------------------------------------------------------------
# The leading-axis layout stand-in
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardPiece:
    """One piece of a leading-axis layout: rows ``[start, stop)`` held on
    ``device`` by process ``process_index``."""
    start: int
    stop: int
    device: str
    process_index: int = 0


@dataclasses.dataclass(frozen=True)
class LeadingAxisSharding:
    """A leaf split along its leading axis: one ``ShardPiece`` per piece,
    seen from process ``process`` (its pieces are the addressable ones).
    Pieces of several processes may cover the same rows (replicas)."""
    pieces: Tuple[ShardPiece, ...]
    process: int = 0

    @classmethod
    def even(cls, rows: int, devices: Sequence[str],
             processes: Optional[Sequence[int]] = None,
             process: int = 0) -> "LeadingAxisSharding":
        """``rows`` split into ``len(devices)`` near-equal contiguous
        pieces, piece ``i`` on ``devices[i]`` held by ``processes[i]``
        (default: process ``i``)."""
        k = len(devices)
        procs = list(processes) if processes is not None else list(range(k))
        base, rem = divmod(int(rows), k)
        out, start = [], 0
        for i in range(k):
            stop = start + base + (1 if i < rem else 0)
            out.append(ShardPiece(start, stop, str(devices[i]), procs[i]))
            start = stop
        return cls(tuple(out), process)

    @property
    def spec(self):
        return ("leading",)

    def _indices(self, shape, pieces):
        shape = tuple(shape)
        if not shape:
            raise ValueError("a leading-axis layout needs a leading axis")
        if max(p.stop for p in self.pieces) != shape[0]:
            raise ValueError(f"layout over {max(p.stop for p in self.pieces)}"
                             f" rows does not fit shape {shape}")
        rest = tuple(slice(None) for _ in shape[1:])
        return {p: (slice(p.start, p.stop),) + rest for p in pieces}

    def devices_indices_map(self, shape):
        return self._indices(shape, self.pieces)

    def addressable_devices_indices_map(self, shape):
        return self._indices(shape, [p for p in self.pieces
                                     if p.process_index == self.process])


def scrutiny_words_shardings(state, shardings) -> Dict[str, Any]:
    """Per-leaf layouts of the scrutiny engine's bit-packed mask words.

    For every leaf whose layout tiles only the leading axis into several
    byte-aligned flat pieces, the flat word array ``(ceil(n/8),)`` can
    carry the same split: piece ``[a, b)`` rows → words
    ``[a*row/8, b*row/8)``.  Leaves with any other layout map to ``None``.
    """
    named = _tree.flatten_with_names(state)[0]
    flat_s = _spec_leaves(shardings)
    out: Dict[str, Any] = {}
    for (name, leaf), sh in zip(named, flat_s):
        out[name] = None
        shape = tuple(leaf.shape)
        if not isinstance(sh, LeadingAxisSharding) or not shape:
            continue
        row = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        if len({(p.start, p.stop) for p in sh.pieces}) <= 1:
            continue
        if any((p.start * row) % 8 or (p.stop * row) % 8
               for p in sh.pieces):
            continue  # a piece boundary splits a word byte
        out[name] = LeadingAxisSharding(
            tuple(dataclasses.replace(p, start=p.start * row // 8,
                                      stop=p.stop * row // 8)
                  for p in sh.pieces), sh.process)
    return out


def _leading_axis_segments(sharding, shape
                           ) -> Optional[List[Tuple[int, int, Any]]]:
    """Per-device leading-axis segments of a target ``sharding`` over a
    global ``shape``: [(start, stop, device)], one entry per addressable
    piece; None if the layout slices any non-leading dim."""
    if not shape or not hasattr(sharding, "addressable_devices_indices_map"):
        return None
    try:
        idx_map = sharding.addressable_devices_indices_map(tuple(shape))
    except (TypeError, ValueError):
        return None
    out = []
    for dev, idx in idx_map.items():
        if idx is None or len(idx) != len(shape):
            return None
        for d, sl in enumerate(idx[1:], start=1):
            if sl.step not in (None, 1) or sl.start not in (None, 0):
                return None
            if sl.stop is not None and sl.stop != shape[d]:
                return None
        sl0 = idx[0]
        if sl0.step not in (None, 1):
            return None
        s = sl0.start or 0
        e = shape[0] if sl0.stop is None else sl0.stop
        out.append((s, e, torch.device(getattr(dev, "device", dev))))
    return out


def leading_axis_device_segments(sharding, shape
                                 ) -> Optional[List[Tuple[int, int, Any]]]:
    """Per-device ``[(row_start, row_stop, device)]`` of ``sharding`` over a
    global ``shape`` (the coordinator's restore targets), or None when the
    layout slices a non-leading dim."""
    return _leading_axis_segments(sharding, shape)


# --------------------------------------------------------------------------
# Scrutinized restore path: scatter after a payload-only H2D
# --------------------------------------------------------------------------

def scatter_sharded_payload(payload: np.ndarray,
                            words: Optional[torch.Tensor], shape,
                            dtype: str, device, *, fill=0,
                            block: int = BLOCK, tracer=None):
    """Move only the critical ``payload`` (host array of dtype ``dtype``)
    H2D and scatter it under the mask's ``np.packbits`` ``words``, already
    on ``device``, into a fill-initialized tensor there (K4 reads the words
    as they are).  The caller brings the words: the manager builds them
    from a leaf's stored aux, the coordinator packs and moves a range's
    host mask.  A leaf with no critical element reads no words (they may
    be None) and runs no K4.  Returns ``(tensor, h2d_bytes)``: the
    payload's bytes, the only ones moved here.

    Spans on ``tracer`` (the process's by default): ``restore.h2d``, the
    payload's move, with ``from_host``'s host copy of a read-only payload;
    ``restore.scatter``, K4's launch."""
    if tracer is None:
        tracer = obs_mod.get_obs().tracer
    shape = tuple(shape)
    n = int(np.prod(shape)) if shape else 1
    payload = np.asarray(payload).reshape(-1)
    with tracer.span("restore.h2d", bytes=payload.nbytes,
                     host_copy_bytes=host_copy_nbytes(payload)):
        payload_dev = from_host(payload, dtype, device)
    with tracer.span("restore.scatter"):
        out = mask_ops.mask_scatter(payload_dev, words, n=n, fill=fill,
                                    block=block)
    return out.reshape(shape), payload.nbytes
