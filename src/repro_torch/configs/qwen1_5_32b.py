"""qwen1.5-32b [dense] — QKV bias (hf:Qwen/Qwen1.5 family).

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064.
Full attention → skips long_500k.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    ffn="swiglu",
    tie_embeddings=False,
    fsdp=True,
    skip_shapes=("long_500k",),
)
