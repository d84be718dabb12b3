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

    # The fields of ``PortArchConfig``, which the model reads for every
    # architecture: here class attributes holding the defaults, so that an
    # ArchConfig's fields (and ``dataclasses.asdict``) stay the reference's.
    mamba = None                    # Mamba2Config of the 'M' layers
    rope = True                     # False: no positional encoding (NoPE)
    attn_scale = None               # None: head_dim ** -0.5
    embed_mult = 1.0                # muP: embeddings times this
    residual_mult = 1.0             # muP: each residual branch times this
    logits_div = 1.0                # muP: logits over this
    norm_eps = 1e-6                 # RMSNorm / LayerNorm epsilon

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


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    """Mamba-2 mixer widths (``models/mamba2.py``)."""
    n_heads: int = 64
    head_dim: int = 64
    d_state: int = 128
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256               # SSD scan chunk (prefill, training)

    @property
    def d_inner(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


@dataclasses.dataclass(frozen=True)
class PortArchConfig(ArchConfig):
    """An architecture only the port runs (``configs.port_only_arch_names``):
    ``ArchConfig`` and the fields the reference's has no counterpart of.
    Layer flavour ``'M'`` is a Mamba-2 mixer (``mamba``)."""
    mamba: Optional[Mamba2Config] = None
    rope: bool = True
    attn_scale: Optional[float] = None
    embed_mult: float = 1.0
    residual_mult: float = 1.0
    logits_div: float = 1.0
    norm_eps: float = 1e-6

    def reduced(self) -> "PortArchConfig":
        """``ArchConfig.reduced``, keeping one whole period of the layer
        pattern; the Mamba-2 widths cut too (chunk 8, so that a short
        prompt spans several chunks)."""
        mamba = None
        if self.mamba is not None:
            mamba = Mamba2Config(n_heads=4, head_dim=16, d_state=16,
                                 n_groups=self.mamba.n_groups,
                                 conv_width=self.mamba.conv_width, chunk=8)
        return dataclasses.replace(
            super().reduced(),
            n_layers=min(self.n_layers, max(4, len(self.layer_pattern))),
            mamba=mamba)
