"""Per-leaf criticality policies (port of ``repro.core.policy``).

``AD``               – run the multi-probe vjp analysis (floating/complex).
``ALWAYS_CRITICAL``  – skip AD, mark every element critical (default for
                       integer / bool leaves: AD is undefined on them and they
                       are control state — the paper's ``step``, keys, …).
``ALWAYS_UNCRITICAL``– skip AD, drop the leaf entirely (caller-asserted dead
                       state, e.g. scratch buffers; used sparingly).
``HORIZON``          – AD over the analysis window only; never a default.

``PrecisionPolicy`` maps |∂out/∂x| quantiles of critical elements onto
storage dtypes (beyond-paper tiers); ``tiers=()`` disables tiering.  A
tier's ``dtype`` is a name (``"bfloat16"``) or None for the native dtype.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch


class LeafPolicy(enum.Enum):
    AD = "ad"
    ALWAYS_CRITICAL = "always_critical"
    ALWAYS_UNCRITICAL = "always_uncritical"
    HORIZON = "horizon"


@dataclasses.dataclass(frozen=True)
class PrecisionTier:
    """Storage tier for a sensitivity quantile band: ``quantile`` is the
    upper |grad| quantile boundary in (0, 1]; ``dtype`` the storage dtype
    name (None keeps the native dtype); ``mantissa_bits`` optionally
    truncates the mantissa further."""

    quantile: float
    dtype: Any
    mantissa_bits: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    tiers: Sequence[PrecisionTier] = ()

    @property
    def enabled(self) -> bool:
        return len(self.tiers) > 0


DEFAULT_PRECISION = PrecisionPolicy()

TIERED_BF16 = PrecisionPolicy(
    tiers=(
        PrecisionTier(quantile=0.5, dtype=None),  # None == keep native dtype
        PrecisionTier(quantile=1.0, dtype="bfloat16"),
    )
)


def default_leaf_policy(leaf: Any) -> LeafPolicy:
    """Paper-faithful default: AD for floating and complex dtypes, critical
    otherwise."""
    if isinstance(leaf, torch.Tensor):
        inexact = leaf.is_floating_point() or leaf.is_complex()
    else:
        dtype = getattr(leaf, "dtype", None)
        dtype = np.result_type(type(leaf)) if dtype is None else dtype
        inexact = np.issubdtype(dtype, np.inexact)
    return LeafPolicy.AD if inexact else LeafPolicy.ALWAYS_CRITICAL


@dataclasses.dataclass(frozen=True)
class ScrutinyConfig:
    """Configuration for a scrutinize() run.

    ``probes``: number of random output cotangents; the union of non-zero
    gradient masks over probes is the critical set.
    ``input_jitter``: optional relative perturbation of the state between
    probes, to move off gradient zero-crossings.
    ``zero_tol``: |grad| ≤ zero_tol counts as zero, applied in the
    accumulator dtype (f32, or f64 for double-precision leaves).
    ``leaf_policy``: leaf → LeafPolicy map (see default_leaf_policy).
    ``precision``: beyond-paper sensitivity tiering of critical elements.
    ``engine``: "device" (default via "auto") keeps max-|grad| accumulators
    on the leaves' device, thresholds and bit-packs the masks there (K1)
    and returns a ``DeviceReport``; "host" moves every probe's full
    gradients to the host (the two give identical masks).
    ``seed``: seeds the probe cotangents and jitter — probe ``p`` draws
    from a ``torch.Generator`` on the state's device seeded from
    ``(seed, p)``, shared by both engines.
    ``graph_prepass``: the counterpart of the reference's
    ``jaxpr_prepass``: run ``scrutinize_graph_reads`` first and skip the
    vjp sweep for leaves no output reads (an all-zero mask without a
    backward pass).  It runs ``fn`` once under a dispatch mode that follows
    each aten op's inputs to its outputs, with no trace, so it costs about
    one forward and takes every ``fn`` the sweep takes.  On by default, as
    there.
    ``static_prune``: run the full static analyzer
    (``repro_torch.analysis.analyze_static``) as the pre-pass instead:
    leaves it proves element-wise uncritical (written before they are
    read) skip the sweep too.  Static masks depend on concrete index
    values, so the dead set is recomputed per call, cached under a digest
    of exactly the index-feeding leaves' values.  Stats gain
    ``static_prune_s`` / ``static_prune_cached`` /
    ``static_pruned_elements`` / ``static_taint_pruned_leaves``.
    """

    probes: int = 3
    input_jitter: float = 0.0
    zero_tol: float = 0.0
    leaf_policy: Callable[[Any], LeafPolicy] = default_leaf_policy
    precision: PrecisionPolicy = DEFAULT_PRECISION
    engine: str = "auto"               # auto | device | host
    seed: int = 0
    graph_prepass: bool = True
    static_prune: bool = False
