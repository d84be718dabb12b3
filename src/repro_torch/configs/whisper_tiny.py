"""whisper-tiny [audio] — encoder-decoder; conv frontend is a stub
(arXiv:2212.04356).  4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536
vocab=51865.  ``input_specs`` provides precomputed frame embeddings
(post-conv, 1500 frames) per the assignment.
Full attention → skips long_500k.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                 # decoder layers
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    enc_dec=True,
    encoder_len=1500,
    ffn="gelu",
    norm="layernorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
