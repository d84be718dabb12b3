"""gemma2-27b [dense] — alternating local/global attention, logit softcaps,
pre+post block norms (arXiv:2408.00118).

46L d_model=4608 32H (kv=16) d_ff=36864 vocab=256000, head_dim=128,
window 4096 on local layers, attn softcap 50, final softcap 30.
Global layers are quadratic → skips long_500k.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    head_dim=128,
    layer_pattern="lg",
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    ffn="geglu",
    post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    fsdp=True,
    skip_shapes=("long_500k",),
)
