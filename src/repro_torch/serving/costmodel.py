"""Analytic iteration-latency model (the simulator's ground truth).

The paper measures real GPU batch latencies on RTX3090/A6000/A100; this repo
targets TPU v5e, where we cannot measure wall-clock in this container. The
simulator therefore executes batches against a *roofline-derived* latency
model: per-iteration time is ``overhead + max(T_compute, T_memory)`` with

    T_compute = FLOPs(batch)   / (chips * peak_flops * eff)
    T_memory  = bytes(batch)   / (chips * hbm_bw * eff)

FLOPs/bytes are computed from the (c_i, u_i) batch composition exactly as the
paper's feature table decomposes them (linear-proj term ~ S, prefill attention
~ sum c_i (u_i + c_i), KV reads ~ sum u_i, weight reads once per batch). The
model is intentionally *nonlinear* in the scheduler's features (the max() and
the per-scene regimes) — the per-scene linear predictor has to learn it from
observed samples, which is precisely the paper's setting.

Multiplicative lognormal noise models runtime jitter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ATTN, LOCAL_ATTN, MAMBA, MLA, MLSTM, MOE, SLSTM, ModelConfig


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12          # bf16 per chip
    hbm_bw: float = 819e9               # bytes/s per chip
    ici_bw: float = 50e9                # bytes/s per link
    hbm_bytes: float = 16e9
    chips: int = 1                      # model-parallel group size
    eff_compute: float = 0.6            # achievable fraction of peak
    eff_mem: float = 0.75
    iter_overhead: float = 3e-4         # dispatch/sync per iteration (s)


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Scalar coefficients for batch cost, derived from a ModelConfig."""

    name: str
    param_bytes: float            # weight bytes read per iteration (active set)
    flops_per_token: float        # 2 * N_active (linear/proj work per token)
    attn_flops_coef: float        # FLOPs per c*(u+c) unit (QK^T + PV, all layers)
    kv_bytes_per_token: float     # KV-cache bytes per cached token (all layers)
    state_bytes_per_req: float    # fixed recurrent state bytes (mamba/xlstm)
    window: int = 0               # sliding-window cap on attention context

    @staticmethod
    def from_config(cfg: ModelConfig, bytes_per_param: float = 2.0) -> "ModelProfile":
        Dh = cfg.resolved_head_dim
        n_active = cfg.param_count(active_only=True)
        kinds = [(ATTN, "dense")] * cfg.first_k_dense + cfg.layer_kinds()
        attn_coef = 0.0
        kv_bytes = 0.0
        state_bytes = 0.0
        window = 0
        for mixer, _ in kinds:
            if mixer in (ATTN, LOCAL_ATTN):
                attn_coef += 2 * 2 * cfg.num_heads * Dh
                kv_bytes += 2 * cfg.num_kv_heads * Dh * bytes_per_param
                if mixer == LOCAL_ATTN:
                    window = cfg.sliding_window
            elif mixer == MLA:
                attn_coef += 2 * 2 * cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
                kv_bytes += (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * bytes_per_param
            elif mixer == MAMBA:
                di = cfg.mamba_expand * cfg.d_model
                state_bytes += di * (cfg.mamba_d_state * 4 + cfg.mamba_d_conv * 2)
            elif mixer in (MLSTM, SLSTM):
                di = 2 * cfg.d_model
                state_bytes += (di // cfg.num_heads) * di * 4 if mixer == MLSTM else di * 16
        return ModelProfile(
            name=cfg.name,
            param_bytes=n_active * bytes_per_param,
            flops_per_token=2.0 * n_active,
            attn_flops_coef=float(attn_coef),
            kv_bytes_per_token=float(kv_bytes),
            state_bytes_per_req=float(state_bytes),
            window=window,
        )


class CostModel:
    """Ground-truth batch latency. Batch = [(c_i, u_i)] per paper §3.2."""

    def __init__(self, profile: ModelProfile, hw: HardwareSpec,
                 noise_sigma: float = 0.03, seed: int = 0):
        self.profile = profile
        self.hw = hw
        self.noise_sigma = noise_sigma
        self._rng = np.random.default_rng(seed)

    # ---- deterministic terms -------------------------------------------------
    def flops(self, batch: Sequence[Tuple[int, int]]) -> float:
        p = self.profile
        total = 0.0
        for c, u in batch:
            ctx = u + c
            if p.window:
                ctx = min(ctx, p.window)  # banded layers cap context (approx.)
            total += c * p.flops_per_token + p.attn_flops_coef * c * ctx
        return total

    def bytes_moved(self, batch: Sequence[Tuple[int, int]]) -> float:
        p = self.profile
        total = p.param_bytes  # weights stream once per iteration
        for c, u in batch:
            total += p.kv_bytes_per_token * (u + c)     # KV read + write
            total += p.state_bytes_per_req               # recurrent state r/w
            total += c * 2 * 4096.0                      # activations (approx)
        return total

    def latency(self, batch: Sequence[Tuple[int, int]], noisy: bool = True) -> float:
        if not batch:
            return 0.0
        hw = self.hw
        t_comp = self.flops(batch) / (hw.chips * hw.peak_flops * hw.eff_compute)
        t_mem = self.bytes_moved(batch) / (hw.chips * hw.hbm_bw * hw.eff_mem)
        t = hw.iter_overhead + max(t_comp, t_mem)
        if noisy and self.noise_sigma > 0:
            t *= float(self._rng.lognormal(0.0, self.noise_sigma))
        return t

    def exclusive_prefill_time(self, prompt_len: int) -> float:
        """Latency of prefilling the whole prompt alone (TTFT slowdown base)."""
        return self.latency([(prompt_len, 0)], noisy=False)

    def decode_token_time(self, context: int) -> float:
        return self.latency([(1, context)], noisy=False)
