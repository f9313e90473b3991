"""Shared building blocks: norms, RoPE, gated MLP (port of the reference
``models/layers.py``; same operations in the same order, fp32 inside the
norm and RoPE)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import shard_utils as su

Params = dict  # nested dicts of tensors


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, D]; positions: [..., T] (broadcastable batch dims).
    Half-split layout: the first D/2 channels rotate against the last D/2."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)            # [D/2]
    angles = positions[..., None].float() * freqs                  # [..., T, D/2]
    cos = torch.cos(angles)[..., None, :]                          # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(params: Params, x: torch.Tensor, activation: str,
        tp=None) -> torch.Tensor:
    """The gated MLP. With ``tp`` (a ``shard_utils.Axis``) the weights are
    this rank's shards, Megatron-style: ``wi_gate``/``wi_up`` its columns,
    ``wo`` its rows; the input enters through ``copy_to`` and the output
    is summed over the axis."""
    x = su.copy_to(x, tp)
    gate = act_fn(activation)(x @ params["wi_gate"])
    return su.reduce_from((gate * (x @ params["wi_up"])) @ params["wo"], tp)


def dense_init(gen: torch.Generator, shape, in_dim: int, dtype,
               device) -> torch.Tensor:
    """normal * 1/sqrt(in_dim), drawn in fp32 then cast (the reference's
    ``dense_init`` distribution). ``shape`` may carry a leading stack axis;
    each leading slice is drawn separately to bound the fp32 scratch. On
    the meta device there is nothing to draw: the empty leaf is its
    shape."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    flat = out.view(-1, *shape[-2:])
    scale = 1.0 / math.sqrt(in_dim)
    for i in range(flat.shape[0]):
        flat[i] = torch.randn(shape[-2:], generator=gen, device=device,
                              dtype=torch.float32).mul_(scale)
    return out


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device) -> torch.Tensor:
    return torch.randn((vocab, dim), generator=gen, device=device,
                       dtype=torch.float32).mul_(0.02).to(dtype)
