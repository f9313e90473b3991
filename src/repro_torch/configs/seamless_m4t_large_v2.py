"""seamless-m4t-large-v2 — enc-dec, multimodal [arXiv:2308.11596; hf].

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206. Encoder-decoder:
24 encoder + 24 decoder layers. The speech frontend is a STUB per the
assignment — ``input_specs()`` provides precomputed frame embeddings for the
encoder. For the LM shape grid, a cell's seq_len S is split S/2 encoder
frames + S/2 decoder tokens so total token work matches the other archs
(documented in DESIGN.md §5).
"""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    layer_pattern=(ATTN,),
    ffn_pattern=(DENSE,),
    enc_dec=True,
    num_encoder_layers=24,
    audio_frames_ratio=2,
    activation="gelu",
)
