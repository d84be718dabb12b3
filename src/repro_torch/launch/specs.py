"""Input and state specs per (arch × shape) cell (port of
``repro.launch.specs``).

Nothing here allocates: every spec is a ``device="meta"`` tensor, with the
shape and dtype of the tensor a real launch would hand the step.  The
parameters, optimizer state and caches come from the real init functions
(``init_params``, ``init_opt``, ``init_cache``) on the meta device, the
batch is synthesized, as the reference builds its ``ShapeDtypeStruct``s
with ``jax.eval_shape``.  Leaf names and tree layout are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import torch

from repro_torch.models import init_cache, init_params

N_PATCHES = 256     # vlm stub patches prepended to the text sequence

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    B, T = cell.global_batch, cell.seq_len
    if cell.kind == "decode":
        return {"tokens": _spec((B, 1), torch.int32)}
    specs = {"tokens": _spec((B, T), torch.int32)}
    if cell.kind == "train":
        specs["labels"] = _spec((B, T), torch.int32)
    if cfg.family == "vlm":
        specs["patch_embeds"] = _spec((B, N_PATCHES, cfg.d_model),
                                      torch.float32)
        specs["positions"] = _spec((B, T + N_PATCHES, 3), torch.int32)
    if cfg.enc_dec:
        specs["frames"] = _spec((B, cfg.encoder_len, cfg.d_model),
                                torch.float32)
    return specs


def params_specs(cfg):
    return init_params(cfg, None, device=META)


def cache_specs(cfg, cell: ShapeCell):
    return init_cache(cfg, cell.global_batch, cell.seq_len, device=META)


def opt_specs(cfg, params_meta, kind: str):
    from repro_torch.train.optim import OptConfig, init_opt
    return init_opt(OptConfig(kind=kind), params_meta)


def optimizer_kind(cfg) -> str:
    """Adafactor where AdamW state cannot fit (deepseek-scale / fsdp)."""
    return "adafactor" if cfg.fsdp else "adamw"


def input_specs(cfg, shape: Union[str, ShapeCell]) -> Dict[str, Any]:
    """The full spec bundle the dry run runs against: for a cell of
    ``SHAPES`` by name, or for a ``ShapeCell`` of the caller's own."""
    cell = shape if isinstance(shape, ShapeCell) else SHAPES[shape]
    p = params_specs(cfg)
    out = {"cell": cell, "params": p, "batch": batch_specs(cfg, cell)}
    if cell.kind == "train":
        out["opt"] = opt_specs(cfg, p, optimizer_kind(cfg))
    if cell.kind == "decode":
        out["cache"] = cache_specs(cfg, cell)
        out["pos"] = _spec((), torch.int32)
    return out
