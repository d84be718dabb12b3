"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8 (arXiv:2412.19437).

61L d_model=7168 128H vocab=129280; first 3 layers dense (d_ff=18432),
remaining 58 MoE with d_expert=2048.  MTP is out of scope (noted in
DESIGN.md).  Requires fsdp + scan + remat to fit 256 chips.
Full attention (MLA) → skips long_500k.
"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                # dense-layer FFN width (layers 0-2)
    vocab=129280,
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1),
    moe_layer_pattern="ddd" + "e" * 58,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    ffn="swiglu",
    tie_embeddings=False,
    fsdp=True,
    skip_shapes=("long_500k",),
)
