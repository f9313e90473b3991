"""Int8 gradient compression with error feedback (port of the reference
``runtime/compression.py``).

Each leaf is quantized per block of ``BLOCK`` values to int8 with an fp32
scale (max |value| / 127), and the quantization error of step t is added
back into the gradient of step t+1, so the accumulated update is unbiased.
``torch.round`` rounds half to even as ``jnp.round`` does, and every
division is elementwise by a tensor, so ``q`` and the scales equal the
reference's bit for bit on the same fp32 input.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.train import tree as T

BLOCK = 256


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    return F.pad(x.reshape(-1), (0, (-x.numel()) % mult))


def compress_leaf(g: torch.Tensor, ef: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8 [n_blocks, BLOCK], scales fp32 [n_blocks], new_ef)."""
    gf = g.float() + ef
    flat = _pad_to(gf, BLOCK).reshape(-1, BLOCK)
    scale = torch.amax(flat.abs(), dim=1) / torch.full(
        (), 127.0, device=g.device)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(flat / scale[:, None]), -127, 127).to(
        torch.int8)
    deq = (q.float() * scale[:, None]).reshape(-1)[:g.numel()].reshape(
        g.shape)
    return q, scale, gf - deq


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    deq = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return deq[:n].reshape(shape).to(dtype)


def init_error_feedback(grads) -> Any:
    return T.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device), grads)


def compress_tree(grads, ef_state):
    """Round-trips every leaf through int8; returns (decompressed grads,
    new error-feedback state)."""
    outs, new_efs = [], []
    for g, ef in zip(T.leaves(grads), T.leaves(ef_state)):
        q, scale, new_ef = compress_leaf(g, ef)
        outs.append(decompress_leaf(q, scale, g.shape, g.dtype))
        new_efs.append(new_ef)
    return T.unflatten(grads, outs), T.unflatten(ef_state, new_efs)
