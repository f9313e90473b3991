"""deepseek-v3-671b — MLA, 1 shared+256 routed top-8, MTP [arXiv:2412.19437; hf].

61L d_model=7168 128H (kv=128: MLA latent shared, per-head keys expanded from
the 512-dim compressed cache) d_ff=2048 (per routed expert) vocab=129280,
MoE 256e top-8 + 1 shared expert; first 3 layers dense (d_ff 18432);
aux-loss-free bias routing; 1 MTP module.
"""
from repro_torch.configs.base import DENSE, MLA, MOE, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,  # dense-prefix layers
    vocab_size=129280,
    layer_pattern=(MLA,),
    ffn_pattern=(MOE,),
    first_k_dense=3,
    num_experts=256,
    num_experts_per_tok=8,
    moe_d_ff=2048,
    shared_expert_d_ff=2048,
    router_aux_free=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp_depth=1,
)
