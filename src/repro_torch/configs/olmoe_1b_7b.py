"""olmoe-1b-7b [moe] — 64 experts top-8 every layer (arXiv:2409.02060).

16L d_model=2048 16H (kv=16) d_expert=1024 vocab=50304.
Full attention → skips long_500k.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024),
    moe_layer_pattern="e",
    ffn="swiglu",
    tie_embeddings=False,
    skip_shapes=("long_500k",),
)
