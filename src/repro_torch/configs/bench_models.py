"""The paper's own evaluation models (§5: Llama3-8B, Qwen2.5-7B).

These are *benchmark* configs (not part of the assigned 10-arch grid): the
goodput/violation experiments replicate the paper's setup with these models'
cost profiles on the serving simulator.
"""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig

LLAMA3_8B = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    layer_pattern=(ATTN,),
    ffn_pattern=(DENSE,),
    rope_theta=500_000.0,
)

QWEN25_7B = ModelConfig(
    name="qwen2.5-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    layer_pattern=(ATTN,),
    ffn_pattern=(DENSE,),
    rope_theta=1_000_000.0,
)

BENCH_MODELS = {"llama3-8b": LLAMA3_8B, "qwen2.5-7b": QWEN25_7B}
