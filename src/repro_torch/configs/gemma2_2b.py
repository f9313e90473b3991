"""gemma2-2b — local+global alternating, logit softcap [arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import ATTN, DENSE, LOCAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern=(LOCAL_ATTN, ATTN),
    ffn_pattern=(DENSE,),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    activation="gelu",
    post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
)
