"""qwen3-1.7b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
"""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    layer_pattern=(ATTN,),
    ffn_pattern=(DENSE,),
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
)
