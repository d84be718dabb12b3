"""NPB checkpoint-analysis harness (paper §IV; port of ``repro.npb.common``).

A benchmark is packaged as:

- ``checkpoint_state()``: the state pytree at the checkpoint instant
  (mid-run, after ``ckpt_iter`` of ``total_iters`` main-loop iterations),
  the paper's Table-I "variables necessary for checkpointing", with
  matching names, on the benchmark's device.
- ``resume(state)``: the rest of the program, remaining iterations plus
  the verification computation.  ``scrutinize(resume, state)`` is the
  paper's AD analysis.  It is functional (writes go into fresh clones or
  ``torch.cat``), as ``torch.func.vjp`` needs.
- ``reference()``: outputs of an uninterrupted full run.
- ``verify(out, ref)``: the benchmark's own success criterion (§IV-C).
- ``expected``: paper Table-II (uncritical, total) per variable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch._tensors import resolve_device, to_host
from repro_torch.core import (CriticalityReport, ScrutinyConfig,
                              participation, scrutinize)
from repro_torch.kernels.mask_pack import ops as mask_ops

EPSILON = 1e-8  # NPB verification tolerance


@dataclasses.dataclass
class Benchmark:
    name: str
    total_iters: int
    ckpt_iter: int
    checkpoint_state: Callable[[], Any]
    resume: Callable[[Any], Any]
    reference: Callable[[], Any]
    expected: Dict[str, Optional[Tuple[int, int]]]
    device: torch.device
    rtol: float = EPSILON

    def verify(self, out, ref) -> bool:
        for o, r in zip(_tree.leaves(out), _tree.leaves(ref)):
            o = to_host(o)
            o = o.astype(np.complex128 if np.iscomplexobj(o) else np.float64)
            r = to_host(r).astype(o.dtype)
            denom = np.maximum(np.abs(r), 1.0)
            if not (np.abs(o - r) / denom <= self.rtol).all():
                return False
        return True

    def scrutinize(self, config: Optional[ScrutinyConfig] = None
                   ) -> CriticalityReport:
        return scrutinize(self.resume, self.checkpoint_state(),
                          config=config or ScrutinyConfig(),
                          device=self.device)

    def participation(self, config: Optional[ScrutinyConfig] = None
                      ) -> CriticalityReport:
        """Structural read-participation masks (paper Table II
        semantics)."""
        return participation(self.resume, self.checkpoint_state(),
                             config=config or ScrutinyConfig(),
                             device=self.device)


def verify_restart(bench: Benchmark, report: CriticalityReport,
                   corrupt: Optional[str] = None, seed: int = 0) -> bool:
    """Paper §IV-C: restart from a critical-elements-only checkpoint.

    ``corrupt``:
      None          – rebuild every leaf from its critical-only tiled pack
                      (K2 tiled, a launch per leaf) and its mask's words,
                      all of the program's leaves in one K5 launch (fill
                      0) on the state's device: critical elements
                      restored, uncritical zero.  No mask is widened.
      'uncritical'  – additionally overwrite every uncritical element with
                      garbage; verification must still PASS.
      'critical'    – corrupt random critical float elements; verification
                      must FAIL (proves those elements really matter).

    The garbage and the corrupted indices come from
    ``np.random.RandomState(seed)`` in the reference's order, so both
    packages corrupt the same elements.
    """
    state = bench.checkpoint_state()
    rng = np.random.RandomState(seed)
    named, treedef = _tree.flatten_with_names(state)
    if corrupt is None:
        words = [report[name].device_words(leaf.device)
                 for name, leaf in named]
        packs = [mask_ops.pack(leaf.reshape(-1), w)[0]
                 for (_, leaf), w in zip(named, words)]
        flats = mask_ops.unpack_group(packs, words,
                                      [leaf.numel() for _, leaf in named],
                                      fill=0)
        restored = [f.reshape(leaf.shape) for f, (_, leaf) in
                    zip(flats, named)]
        out = bench.resume(_tree.unflatten(treedef, restored))
        return bench.verify(out, bench.reference())
    restored = []
    corrupted_any_critical = False
    for name, leaf in named:
        rep = report[name]
        flat = leaf.reshape(-1)
        n = flat.shape[0]
        if corrupt == "uncritical":
            garbage = rng.uniform(-1e6, 1e6, size=n)
            if leaf.is_complex():
                garbage = garbage + 1j * rng.uniform(-1e6, 1e6, size=n)
            g = torch.from_numpy(garbage).to(device=leaf.device,
                                             dtype=leaf.dtype)
            flat = torch.where(rep.device_mask(leaf.device), flat, g)
        elif corrupt == "critical":
            crit_idx = np.nonzero(rep.mask)[0]
            if crit_idx.size and (leaf.is_floating_point()
                                  or leaf.is_complex()):
                # Large multiplicative+additive corruption of several
                # elements so it cannot hide below verification tolerance.
                hit = rng.choice(crit_idx, size=min(8, crit_idx.size),
                                 replace=False)
                hit = torch.from_numpy(hit).to(leaf.device)
                flat = flat.clone()
                flat[hit] = flat[hit] * 1e3 + 1e3
                corrupted_any_critical = True
        else:
            raise ValueError(f"unknown corruption {corrupt!r}")
        restored.append(flat.reshape(leaf.shape))

    if corrupt == "critical" and not corrupted_any_critical:
        raise RuntimeError(f"{bench.name}: no float critical elements to "
                           "corrupt")
    out = bench.resume(_tree.unflatten(treedef, restored))
    return bench.verify(out, bench.reference())


_REGISTRY: Dict[str, Callable[[torch.device], Benchmark]] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def get_benchmark(name: str, device=None) -> Benchmark:
    """The benchmark ``name`` with its state on ``device``: the card unless
    ``"cpu"`` is asked for."""
    dev = resolve_device(device)
    _ensure_loaded()
    return _REGISTRY[name](dev)


def _ensure_loaded():
    # Import benchmark modules lazily to avoid import cycles.
    from repro_torch.npb import bt, sp, lu, mg, cg, ft, ep, is_  # noqa: F401


class _AllBenchmarks:
    def __iter__(self):
        _ensure_loaded()
        return iter(sorted(_REGISTRY.keys()))


ALL_BENCHMARKS = _AllBenchmarks()


def f64(x, device) -> torch.Tensor:
    """A float64 tensor of ``x`` on ``device``."""
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def i32(x, device) -> torch.Tensor:
    """An int32 tensor of ``x`` on ``device``."""
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def set_region(x: torch.Tensor, index, value: torch.Tensor) -> torch.Tensor:
    """``x.at[index].set(value)``: a fresh clone with ``index`` written."""
    out = x.clone()
    out[index] = value
    return out


def add_region(x: torch.Tensor, index, value: torch.Tensor) -> torch.Tensor:
    """``x.at[index].add(value)``: a fresh clone, ``x[index] + value`` there."""
    return set_region(x, index, x[index] + value)
