"""The benchmark's yardstick arithmetic: operations and bytes from shapes,
and the peaks of the card they are held against.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): 989e12
FLOP/s in bf16 on the tensor cores, 3.35e12 B/s of HBM.  A card set below
700 W runs slower under load; the harness prints the card's power limit
beside every run.

Model FLOPs count each product once as 2 * m * n * k, the decode's
attention over the slots it may read (causal: slots <= position) and not
over the whole cache it masks.  Bytes count each input byte read once and
each output byte written once.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _moe(cfg: dict) -> bool:
    return "num_experts" in cfg


def decode_step_flops(cfg: dict, batch: int, pos: int) -> dict:
    """One decode step at position ``pos`` for ``batch`` rows:
    {"dense": the products with weight matrices, "attn": QK^T and PV}."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, K, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
               cfg["head_dim"])
    per_layer = 2 * d * (H * D + 2 * K * D) + 2 * H * D * d
    if _moe(cfg):
        f, k = cfg["intermediate_size"], cfg["num_experts_per_tok"]
        per_layer += 2 * d * cfg["num_experts"] + k * 3 * 2 * d * f
    else:
        per_layer += 3 * 2 * d * cfg["intermediate_size"]
    dense = batch * (L * per_layer + 2 * d * cfg["vocab_size"])
    attn = batch * L * H * 2 * 2 * D * (pos + 1)
    return {"dense": float(dense), "attn": float(attn)}


def scrutiny_flops(cfg: dict, batch: int, pos: int, horizon: int,
                   probes: int) -> float:
    """Model FLOPs of one scrutiny of ``resume_fn(horizon)`` at ``pos``:
    the pre-pass's forward, the sweep's forward (one linearization), and a
    backward with respect to the state for each probe.  A backward with
    respect to activations only costs one product a weight matrix (dX = dY
    W^T) and two an attention product (both operands)."""
    fwd = bwd = 0.0
    for s in range(horizon):
        f = decode_step_flops(cfg, batch, pos + s)
        fwd += f["dense"] + f["attn"]
        bwd += f["dense"] + 2 * f["attn"]
    return 2 * fwd + probes * bwd


def bitpack_bytes(n: int) -> int:
    """K1 over one leaf of n elements: its float32 max-|grad| accumulator
    read, the n/8 mask bytes and one int32 count a 1024-element tile
    written."""
    return 4 * n + (n + 7) // 8 + 4 * ((n + 1023) // 1024)


def scatter_bytes(n: int, critical: int, itemsize: int) -> int:
    """K4 over one leaf: the critical payload and the n/8 mask bytes read,
    the whole leaf written."""
    return critical * itemsize + (n + 7) // 8 + n * itemsize


def delta_bytes(payload: int, chunk: int) -> int:
    """K3 over one payload: it and its predecessor read, one flag byte a
    chunk written."""
    return 2 * payload + (payload + chunk - 1) // chunk


def pack_bytes(n: int, critical: int, itemsize: int) -> int:
    """K2 over one leaf: the critical elements and the n/8 mask bytes read,
    the payload written."""
    return 2 * critical * itemsize + (n + 7) // 8


def roofline_share(bytes_moved: float, seconds: float,
                   flops: float = 0.0) -> float:
    """The least time the card could take (the larger of the FLOP and the
    byte bound) over the time taken."""
    bound = max(flops / PEAK_BF16_FLOPS, bytes_moved / PEAK_HBM_BYTES)
    return bound / seconds
