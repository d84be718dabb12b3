"""Architecture configuration (one instance per assigned arch); a copy of
``repro.configs.base``, since the port imports nothing of the reference.

Every assigned architecture is expressed as an ``ArchConfig``; the model
substrate (repro_torch.models) consumes nothing else.  ``reduced()`` derives
the CPU smoke-test variant (same family/topology, tiny dims).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden dim
    num_shared: int = 0            # always-on shared experts (deepseek)
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # --- attention flavour ---
    rope_theta: float = 10000.0
    qkv_bias: bool = False          # qwen1.5 / qwen2-vl
    logit_softcap: Optional[float] = None       # gemma2 final logits
    attn_softcap: Optional[float] = None        # gemma2 attention logits
    # sliding-window pattern: None = all global; else per-layer window size
    # (an int w applied on layers where pattern says local).
    window: Optional[int] = None
    # layer pattern string, cycled over layers: 'g' global attn, 'l' local
    # (windowed) attn, 'r' recurrent (RG-LRU), 'm' mLSTM, 's' sLSTM.
    layer_pattern: str = "g"
    # --- FFN flavour ---
    ffn: str = "swiglu"             # swiglu | geglu | gelu
    # --- MoE / MLA ---
    moe: Optional[MoEConfig] = None
    moe_layer_pattern: str = "e"    # cycled; 'e' expert layer, 'd' dense layer
    mla: Optional[MLAConfig] = None
    # --- recurrent (RG-LRU / xLSTM) ---
    lru_dim: Optional[int] = None   # recurrence width (defaults d_model)
    # --- embeddings ---
    tie_embeddings: bool = True
    embed_scale: bool = False       # gemma multiplies embeddings by sqrt(d)
    mrope: bool = False             # qwen2-vl multimodal 3-axis RoPE
    # --- enc-dec (whisper) ---
    enc_dec: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500         # whisper 30 s @ 50 Hz after conv stub
    # --- norm ---
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    post_norm: bool = False         # gemma2 uses pre+post block norms
    # --- numerics / parallelism knobs (overridable per run) ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    fsdp: bool = False              # shard params+opt over the data axis too
    remat: bool = True
    scan_layers: bool = True
    # assigned input shapes this arch skips (e.g. long_500k for quadratic
    # attention archs), with the reason recorded in DESIGN.md.
    skip_shapes: Tuple[str, ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def pattern_at(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def moe_at(self, layer: int) -> bool:
        if self.moe is None:
            return False
        return self.moe_layer_pattern[layer % len(self.moe_layer_pattern)] == "e"

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 8),
                top_k=min(self.moe.top_k, 2),
                d_expert=64,
                num_shared=min(self.moe.num_shared, 1),
            )
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                            qk_nope_head_dim=8, qk_rope_head_dim=8,
                            v_head_dim=8)
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab=512,
            head_dim=16,
            window=min(self.window, 32) if self.window else None,
            lru_dim=64 if self.lru_dim else None,
            moe=moe,
            mla=mla,
            encoder_len=32 if self.enc_dec else self.encoder_len,
            dtype="float32",
            param_dtype="float32",
            fsdp=False,
            remat=False,
        )
