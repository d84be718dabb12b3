"""Scrutinized checkpoint/restart on PyTorch: region-packed, sharded,
async, multi-level, partner-redundant and differential."""

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
    "CheckpointManager", "Level", "PackedLeaf", "DeltaLeaf", "StreamLeaf",
    "pack_leaf", "pack_leaf_from_payload", "packed_leaf_stub",
    "unpack_leaf", "leaf_mask", "apply_delta", "delta_encode_host",
    "list_steps", "load_checkpoint", "load_checkpoint_raw",
    "restore_state", "save_checkpoint", "save_delta_checkpoint",
    "step_of_entry", "tmp_step_of_entry", "tmp_owner_of_entry",
    "is_step_committed", "read_manifest", "chain_steps",
]
