"""internvl2-26b — InternViT + InternLM2 [arXiv:2404.16821; hf].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553. The InternViT
frontend is a STUB per the assignment: ``input_specs()`` provides precomputed
patch embeddings (num_patch_tokens per sample) that are concatenated ahead of
the text embeddings; the transformer backbone here is the InternLM2-20B-style
decoder (GQA, SwiGLU).
"""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    layer_pattern=(ATTN,),
    ffn_pattern=(DENSE,),
    rope_theta=1_000_000.0,
    num_patch_tokens=256,
)
