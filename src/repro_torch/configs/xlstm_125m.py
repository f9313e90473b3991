"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304. xLSTM blocks carry their own
up/down projections, so there is no separate FFN (d_ff=0). We alternate
mLSTM/sLSTM 1:1 (the paper's xLSTM[a:b] notation; 1:1 exercises both cells).
Fully recurrent -> O(1) state -> long_500k applies.
"""
from repro_torch.configs.base import MLSTM, NONE, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=(MLSTM, SLSTM),
    ffn_pattern=(NONE,),
    tie_embeddings=True,
)
