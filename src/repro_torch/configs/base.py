"""Model/architecture configuration.

Every assigned architecture is expressed as a ``ModelConfig``. The transformer
stack is described by a repeating ``layer_pattern`` (sequence-mixer kind per
layer slot) and ``ffn_pattern`` (channel-mixer kind per layer slot); the stack
runs as a loop over repetitions of the pattern period.

This is the PyTorch port's own copy of the reference ``configs/base.py``: the
fields and the ``smoke()`` sizes are the reference's, and ``dtype`` /
``param_dtype`` hold ``torch.dtype`` values.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch

# Sequence-mixer kinds.
ATTN = "attn"          # full (causal) GQA attention
LOCAL_ATTN = "local"   # sliding-window GQA attention
MLA = "mla"            # DeepSeek multi-head latent attention
MAMBA = "mamba"        # Mamba-1 selective SSM
MLSTM = "mlstm"        # xLSTM matrix-memory LSTM
SLSTM = "slstm"        # xLSTM scalar-memory LSTM

# Channel-mixer kinds.
DENSE = "dense"        # gated-GLU MLP
MOE = "moe"            # routed (+ optional shared) experts
NONE = "none"          # block has no separate FFN (xLSTM blocks self-contain)

INFERENCE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # Repeating structural patterns (period divides num_layers unless a dense
    # prefix is configured via ``first_k_dense``).
    layer_pattern: Tuple[str, ...] = (ATTN,)
    ffn_pattern: Tuple[str, ...] = (DENSE,)
    first_k_dense: int = 0  # leading layers forced to (attn, dense) (DeepSeek)

    # Attention details.
    rope_theta: float = 10_000.0
    sliding_window: int = 4_096
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qk_norm: bool = False
    attn_scale: float = 0.0  # 0 -> 1/sqrt(head_dim)
    use_rope: bool = True
    post_norm: bool = False     # gemma2-style post-sublayer norms
    embed_scale: bool = False   # gemma-style sqrt(d_model) embedding scaling

    # MoE.
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_free: bool = False  # DeepSeek-v3 aux-loss-free bias routing

    # MLA (DeepSeek-v3).
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # Mamba.
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # Multi-token prediction (DeepSeek-v3).
    mtp_depth: int = 0

    # Encoder-decoder (seamless-m4t).
    enc_dec: bool = False
    num_encoder_layers: int = 0

    # Modality frontend stub sizes.
    num_patch_tokens: int = 0   # vlm: image patch embeddings per sample
    audio_frames_ratio: int = 0  # audio: enc frames = seq_len // ratio (>0 => enc-dec split)

    # Numerics.
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    activation: str = "silu"

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def period(self) -> int:
        return int(math.lcm(len(self.layer_pattern), len(self.ffn_pattern)))

    def layer_kinds(self) -> list[Tuple[str, str]]:
        """(mixer, ffn) kind for every layer index (after the dense prefix)."""
        p = self.period
        out = []
        n = self.num_layers - self.first_k_dense
        for i in range(n):
            out.append(
                (
                    self.layer_pattern[i % len(self.layer_pattern)],
                    self.ffn_pattern[i % len(self.ffn_pattern)],
                )
            )
        return out

    @property
    def num_pattern_reps(self) -> int:
        n = self.num_layers - self.first_k_dense
        if n % self.period:
            raise ValueError(
                f"{self.name}: {n} scanned layers not divisible by period {self.period}"
            )
        return n // self.period

    def uses_kv_cache(self) -> bool:
        return any(k in (ATTN, LOCAL_ATTN, MLA) for k in self.layer_pattern) or self.first_k_dense > 0

    def is_subquadratic(self) -> bool:
        """True when every sequence mixer keeps O(1)/windowed state (long_500k rule)."""
        quad = {ATTN, MLA}
        return not any(k in quad for k in self.layer_pattern) and self.first_k_dense == 0

    # Parameter count (for 6ND model-flops accounting).
    def param_count(self, active_only: bool = False) -> int:
        d, h = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        kinds = [(ATTN, DENSE)] * self.first_k_dense_pairs() + self.layer_kinds()
        for mixer, ffn in kinds:
            if mixer in (ATTN, LOCAL_ATTN):
                total += d * (self.num_heads * h) + d * (2 * self.num_kv_heads * h)
                total += (self.num_heads * h) * d
            elif mixer == MLA:
                total += d * self.q_lora_rank + self.q_lora_rank * self.num_heads * (
                    self.qk_nope_head_dim + self.qk_rope_head_dim
                )
                total += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                total += self.kv_lora_rank * self.num_heads * (
                    self.qk_nope_head_dim + self.v_head_dim
                )
                total += self.num_heads * self.v_head_dim * d
            elif mixer == MAMBA:
                di = self.mamba_expand * d
                total += d * 2 * di + di * self.mamba_d_conv
                total += di * (self.mamba_d_state * 2 + di // 16) + di * d
            elif mixer in (MLSTM, SLSTM):
                di = 2 * d
                total += d * 4 * di + di * d  # qkv/gates up + down
            if ffn == DENSE:
                total += 3 * d * self.d_ff
            elif ffn == MOE:
                e = self.num_experts_per_tok if active_only else self.num_experts
                total += 3 * d * self.moe_d_ff * e
                total += 3 * d * self.shared_expert_d_ff
                total += d * self.num_experts  # router
        if self.enc_dec:
            # decoder cross-attention per decoder layer
            total += self.num_layers * (
                d * (self.num_heads + 2 * self.num_kv_heads) * h + self.num_heads * h * d
            )
        return total

    def first_k_dense_pairs(self) -> int:
        return self.first_k_dense

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        p = self.period
        changes = dict(
            num_layers=self.first_k_dense + p * (2 if self.first_k_dense == 0 else 1),
            d_model=64,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            dtype=torch.float32,
            param_dtype=torch.float32,
        )
        if self.num_experts:
            changes.update(
                num_experts=max(4, self.num_experts_per_tok + 1),
                moe_d_ff=96,
                shared_expert_d_ff=96 if self.shared_expert_d_ff else 0,
                num_experts_per_tok=min(self.num_experts_per_tok, 2),
                capacity_factor=4.0,
            )
        if self.q_lora_rank:
            changes.update(
                q_lora_rank=32,
                kv_lora_rank=32,
                qk_nope_head_dim=16,
                qk_rope_head_dim=8,
                v_head_dim=16,
            )
        if self.enc_dec:
            changes.update(num_encoder_layers=2, num_layers=2)
        if self.num_patch_tokens:
            changes.update(num_patch_tokens=16)
        return dataclasses.replace(self, **changes)
