"""Int8 gradient compression with error feedback (port of the reference
``runtime/compression.py``).

Each leaf is quantized per block of ``BLOCK`` values to int8 with an fp32
scale (max |value| / 127), and the quantization error of step t is added
back into the gradient of step t+1, so the accumulated update is unbiased.
``torch.round`` rounds half to even as ``jnp.round`` does, and every
division is elementwise by a tensor, so ``q`` and the scales equal the
reference's bit for bit on the same fp32 input.

On a mesh (``layout``, a ``train.train_step.TrainLayout``) each rank holds
slices of the leaves, and the blocks are still those of each whole leaf's
flat order, as the reference compresses the whole gradient: every rank
takes the maxima of its elements' blocks, one MAX all-reduce gives each
block's, and each element is quantized with its block's scale.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.train import tree as T

BLOCK = 256


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    return F.pad(x.reshape(-1), (0, (-x.numel()) % mult))


def _quantize(x: torch.Tensor, amax: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 block format: ``x`` fp32 and ``amax`` the max |value| of
    each element's block, broadcast against ``x``. Returns (q int8 of
    ``x``'s shape, the scales of ``amax``'s shape)."""
    scale = torch.clamp(amax / torch.full((), 127.0, device=x.device),
                        min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_leaf(g: torch.Tensor, ef: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8 [n_blocks, BLOCK], scales fp32 [n_blocks], new_ef)."""
    gf = g.float() + ef
    flat = _pad_to(gf, BLOCK).reshape(-1, BLOCK)
    q, scale = _quantize(flat, torch.amax(flat.abs(), dim=1, keepdim=True))
    deq = (q.float() * scale).reshape(-1)[:g.numel()].reshape(g.shape)
    return q, scale[:, 0], gf - deq


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


def compress_tree(grads, ef_state, layout=None):
    """Round-trips every leaf through int8; returns (decompressed grads,
    new error-feedback state). With ``layout`` the leaves are this rank's
    slices (see the module docstring)."""
    if layout is not None:
        return _compress_sliced(grads, ef_state, layout)
    outs, new_efs = [], []
    for g, ef in zip(T.leaves(grads), T.leaves(ef_state)):
        q, scale, new_ef = compress_leaf(g, ef)
        outs.append(decompress_leaf(q, scale, g.shape, g.dtype))
        new_efs.append(new_ef)
    return T.unflatten(grads, outs), T.unflatten(ef_state, new_efs)


def _compress_sliced(grads, ef_state, layout):
    gfs, bids, amax = [], [], []
    for i, (g, ef) in enumerate(zip(T.leaves(grads), T.leaves(ef_state))):
        gf = g.float() + ef
        bid = layout.block_ids(i, BLOCK, g.device).reshape(-1)
        n_blocks = -(-math.prod(layout.shapes[i]) // BLOCK)
        amax.append(torch.zeros(n_blocks, dtype=torch.float32,
                                device=g.device).scatter_reduce_(
            0, bid, gf.reshape(-1).abs(), "amax"))
        gfs.append(gf)
        bids.append(bid)
    outs, new_efs = [], []
    for g, gf, bid, m in zip(T.leaves(grads), gfs, bids,
                             layout.max_blocks(amax)):
        q, scale = _quantize(gf, m[bid].reshape(g.shape))
        deq = q.float() * scale
        outs.append(deq.to(g.dtype))
        new_efs.append(gf - deq)
    return T.unflatten(grads, outs), T.unflatten(ef_state, new_efs)
