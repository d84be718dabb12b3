"""granite-4.0-h-micro [hybrid] — Mamba-2 + GQA without positions, 9:1,
dense SwiGLU MLP in every layer, muP multipliers (IBM Granite 4.0,
huggingface.co/ibm-granite/granite-4.0-h-micro, config.json).

40L d_model=2048; Mamba-2 64 heads x 64 (d_inner 4096), d_state 128,
1 group, conv 4, scan chunk 256; attention (NoPE) at layers 5, 15, 25, 35,
32H (kv=8) x 64; d_ff=8192 vocab=100352, tied embeddings; embeddings x 12,
residual branches x 0.22, attention scale 1/64, logits / 8; RMSNorm eps
1e-5.  A port-only architecture: the reference has no Mamba-2 layer.
"""

from repro_torch.configs.base import Mamba2Config, PortArchConfig

CONFIG = PortArchConfig(
    name="granite-4.0-h-micro",
    family="hybrid",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=100352,
    layer_pattern="MMMMMgMMMM",    # attention at 5, 15, 25, 35
    ffn="swiglu",
    tie_embeddings=True,
    mamba=Mamba2Config(n_heads=64, head_dim=64, d_state=128, n_groups=1,
                       conv_width=4, chunk=256),
    rope=False,
    attn_scale=0.015625,
    embed_mult=12.0,
    residual_mult=0.22,
    logits_div=8.0,
    norm_eps=1e-5,
)
