"""recurrentgemma-2b [hybrid] — RG-LRU + local attention 2:1 (arXiv:2402.19427).

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, window 2048.
Sub-quadratic (local attention only) → runs long_500k.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    layer_pattern="rrl",       # 2 recurrent blocks per local-attention block
    window=2048,
    lru_dim=2560,
    ffn="geglu",
    embed_scale=True,
    tie_embeddings=True,
)
