"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517).

12L d_model=768 4H (kv=4) d_ff=0 (xLSTM blocks carry their own up/down
projections) vocab=50304.  Attention-free: runs long_500k.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                    # no separate FFN; mLSTM/sLSTM blocks project
    vocab=50304,
    head_dim=192,
    layer_pattern="msmmsmmsmmsm"[:12],  # 7:1-flavoured mLSTM/sLSTM mix
    lru_dim=768,
    ffn="swiglu",
    tie_embeddings=True,
    fsdp=False,
)
