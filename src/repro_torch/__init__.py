"""repro_torch — the paper's scrutinized checkpointing on PyTorch and CUDA.

The port of ``repro`` (JAX) to an NVIDIA H100: AD scrutiny of checkpoint
state, the device-packed save, differential chains and the device restore,
with the mask kernels written by hand in CUDA (``csrc/mask_pack.cu``);
participation and the static analyzer over the traced aten graph
(``core/taint.py``, ``analysis/``); the serving path of the dense GQA
models (``Engine``), whose prefill runs
the flash-attention kernel (``csrc/flash_attention.cu``); training
(``launch.train``); the multi-host coordinated save with its resilience
levels (``CoordinatedCheckpointManager``); and the paper's NPB evaluation
(``repro_torch.npb``), whose §IV-C restart runs the unpack kernel.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from repro_torch.checkpoint import (CheckpointManager,
                                    CoordinatedCheckpointManager, Level,
                                    load_checkpoint, restore_state,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core import ScrutinyConfig, participation, scrutinize
from repro_torch.serve import Engine

__all__ = ["scrutinize", "participation", "ScrutinyConfig", "CheckpointManager",
           "CoordinatedCheckpointManager", "Level",
           "save_checkpoint", "load_checkpoint", "restore_state", "Engine",
           "get_config"]
