"""qwen2-vl-7b [vlm] — M-RoPE backbone; vision frontend is a stub
(arXiv:2409.12191).  28L d_model=3584 28H (kv=4) d_ff=18944 vocab=152064.
``input_specs`` provides precomputed patch embeddings per the assignment.
Full attention → skips long_500k.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    mrope=True,
    rope_theta=1e6,
    ffn="swiglu",
    tie_embeddings=False,
    skip_shapes=("long_500k",),
)
