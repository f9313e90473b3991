"""jamba-1.5-large-398b — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
One attention layer per 8 (attn at slot 3 of each period, per the Jamba
paper's l=8, a=1 with the attention layer mid-block); MoE every other layer
(e=2 in Jamba notation). Mamba layers have O(1) state and the single
attention layer per period uses a cache whose per-step decode cost is linear,
but for the long_500k rule we classify by the presence of full attention:
Jamba is `hybrid` and the assignment explicitly lists hybrid as eligible.
"""
from repro_torch.configs.base import ATTN, DENSE, MAMBA, MOE, ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    layer_pattern=(MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA, MAMBA),
    ffn_pattern=(DENSE, MOE),
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=24576,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    use_rope=False,  # Jamba: no positional embeddings (Mamba layers carry position)
)
