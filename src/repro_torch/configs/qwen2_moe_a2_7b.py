"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4.
The 4 shared experts are fused into a single shared FFN of width 4*1408=5632
(mathematically identical to 4 parallel always-on experts summed).
"""
from repro_torch.configs.base import ATTN, MOE, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    layer_pattern=(ATTN,),
    ffn_pattern=(MOE,),
    num_experts=60,
    num_experts_per_tok=4,
    moe_d_ff=1408,
    shared_expert_d_ff=5632,
)
