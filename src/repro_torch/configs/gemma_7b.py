"""gemma-7b [dense] — GeGLU, head_dim=256 (arXiv:2403.08295).

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.
Full attention → skips long_500k.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab=256000,
    head_dim=256,
    ffn="geglu",
    embed_scale=True,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
