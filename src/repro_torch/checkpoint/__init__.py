"""Scrutinized checkpoint/restart on PyTorch: region-packed, sharded,
async, multi-level, partner-redundant, elastic, differential, and
multi-host coordinated (two-phase commit + global manifests + resharded
restore)."""

from repro_torch.checkpoint.coordinator import (CoordinatedCheckpointManager,
                                                GlobalManifest,
                                                StateShapeError)
from repro_torch.checkpoint.levels import (FAILURE_MATRIX, L1_RESIDENT,
                                           L2_PARTNER, L3_PARITY, L4_STORE,
                                           LEVEL_ORDER, L2Stack, PartnerStore,
                                           ResidentCache, partner_map,
                                           partner_of)
from repro_torch.checkpoint.manager import CheckpointManager, Level
from repro_torch.checkpoint.packing import (DeltaLeaf, PackedLeaf,
                                            apply_delta, delta_encode_host,
                                            leaf_mask, pack_leaf,
                                            pack_leaf_from_payload,
                                            packed_leaf_stub, unpack_leaf)
from repro_torch.checkpoint.store import (StreamLeaf, chain_steps,
                                          is_step_committed, list_steps,
                                          load_checkpoint,
                                          load_checkpoint_raw, read_manifest,
                                          restore_state, save_checkpoint,
                                          save_delta_checkpoint,
                                          step_of_entry, tmp_owner_of_entry,
                                          tmp_step_of_entry)

__all__ = [
    "CheckpointManager", "CoordinatedCheckpointManager", "GlobalManifest",
    "StateShapeError", "Level", "PackedLeaf", "DeltaLeaf", "StreamLeaf",
    "pack_leaf", "pack_leaf_from_payload", "packed_leaf_stub",
    "unpack_leaf", "leaf_mask", "apply_delta",
    "delta_encode_host", "list_steps", "load_checkpoint",
    "load_checkpoint_raw", "restore_state", "save_checkpoint",
    "save_delta_checkpoint", "step_of_entry", "tmp_step_of_entry",
    "tmp_owner_of_entry", "is_step_committed", "read_manifest",
    "chain_steps",
    "LEVEL_ORDER", "FAILURE_MATRIX", "L1_RESIDENT", "L2_PARTNER",
    "L3_PARITY", "L4_STORE", "PartnerStore", "L2Stack", "ResidentCache",
    "partner_of", "partner_map",
]
