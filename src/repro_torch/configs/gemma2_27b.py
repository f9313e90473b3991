"""gemma2-27b — local+global alternating, logit softcap [arXiv:2408.00118; hf].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Sliding window 4096 on local layers; attn softcap 50, final softcap 30.
"""
from repro_torch.configs.base import ATTN, DENSE, LOCAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    layer_pattern=(LOCAL_ATTN, ATTN),
    ffn_pattern=(DENSE,),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    # gemma2-27b scales queries by 1/sqrt(d_model/num_heads)=1/12, not head_dim.
    attn_scale=1.0 / 12.0,
    activation="gelu",
    post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
)
