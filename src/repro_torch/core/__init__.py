"""repro_torch.core — AD-based checkpoint criticality on PyTorch.

Public API:
    scrutinize(fn, state, config=..., device=...)  -> CriticalityReport
    participation(fn, state, config=..., device=...) -> CriticalityReport
    traced_step(fn, state, device=...) -> TracedStep (the shared trace)
    CriticalityReport / LeafReport / DeviceReport / DeviceLeafReport
    RegionTable, mask_to_regions, regions_to_mask
    ScrutinyConfig, LeafPolicy, PrecisionPolicy
"""

from repro_torch.core.criticality import (
    CriticalityReport,
    DeviceLeafReport,
    DeviceReport,
    LeafReport,
    TracedStep,
    scrutinize,
    scrutinize_graph_reads,
    traced_step,
)
from repro_torch.core.policy import (
    LeafPolicy,
    PrecisionPolicy,
    PrecisionTier,
    ScrutinyConfig,
    TIERED_BF16,
    default_leaf_policy,
)
from repro_torch.core.taint import UnattributedTensorError, participation
from repro_torch.core.regions import (
    RegionTable,
    mask_to_regions,
    pack_with_regions,
    regions_to_mask,
    unpack_with_regions,
)

__all__ = [
    "CriticalityReport",
    "DeviceLeafReport",
    "DeviceReport",
    "LeafReport",
    "TracedStep",
    "UnattributedTensorError",
    "participation",
    "scrutinize",
    "scrutinize_graph_reads",
    "traced_step",
    "LeafPolicy",
    "PrecisionPolicy",
    "PrecisionTier",
    "ScrutinyConfig",
    "TIERED_BF16",
    "default_leaf_policy",
    "RegionTable",
    "mask_to_regions",
    "regions_to_mask",
    "pack_with_regions",
    "unpack_with_regions",
]
