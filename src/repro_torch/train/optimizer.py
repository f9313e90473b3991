"""AdamW with fp32 master weights for bf16 params (port of the reference
``train/optimizer.py``).

The state mirrors the parameter tree: ``{"step": int32 scalar, "m", "v":
fp32 moments, "master": an fp32 copy of each non-fp32 leaf, None for fp32
leaves}``, the reference's structure, so it checkpoints in the reference's
format. ``adamw_update`` keeps the reference's signature and return value
``(params, state, metrics)`` but updates the parameters, the moments and
the master copies **in place** (under ``torch.no_grad()``), in the
reference's order of operations: clip, moments, bias correction, ``base -
lr * (mhat / (sqrt(vhat) + eps) + wd * base)``, then the cast. Scalars
are fp32 tensors on the parameters' device, and every division is by a
tensor, as XLA divides (PyTorch's CUDA kernels turn a division by a
Python number into a product by its reciprocal).

On a mesh (``layout``, a ``train.train_step.TrainLayout``) the state is
ZeRO-sharded: each rank's ``m``/``v``/``master`` are its slice of
``launch/sharding.opt_state_specs`` (the parameter's model shard, cut
again over the data-parallel axes), the gradients come in at that slice,
the global norm adds each leaf's squares once over the mesh, AdamW
updates the local slices, and the new parameter shards are gathered over
the data-parallel axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.train import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x: float, device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=device)


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay; ``step`` an integer or an integer
    tensor. Returns an fp32 scalar tensor on the step's device."""
    step = torch.as_tensor(step)
    dev = step.device
    warm = torch.clamp(step.to(torch.float32)
                       / _f32(max(cfg.warmup_steps, 1), dev), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).to(torch.float32)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1),
                              dev), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def adamw_init(params, layout=None) -> dict:
    """The state of ``params``; with ``layout`` each leaf at this rank's
    ZeRO slice (``master`` the slice of the rank's parameter shard)."""
    dev = T.leaves(params)[0].device
    own = T.unflatten(params, layout.dp_slices(params)) if layout else params

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": T.tree_map(zeros, own),
        "v": T.tree_map(zeros, own),
        "master": T.tree_map(lambda p: p.detach().to(torch.float32, copy=True)
                             if p.dtype != torch.float32 else None, own),
    }


def global_norm(tree, layout=None) -> torch.Tensor:
    """The norm of the whole gradient. With ``layout`` ``tree`` holds this
    rank's slices: each leaf's squares are added once, by the ranks at
    coordinate 0 of every axis the leaf is copied over, and summed over
    the mesh."""
    if layout is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in T.leaves(tree)))
    return torch.sqrt(layout.sum_once(
        [torch.sum(torch.square(g.float())) for g in T.leaves(tree)]))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, layout=None
                 ) -> Tuple[Any, dict, dict]:
    """Returns (params, state, metrics): the same objects, updated in place
    (``state["step"]`` is replaced by a new scalar tensor). With
    ``layout`` the gradients and the state are this rank's ZeRO slices and
    the parameters its shards."""
    step = state["step"] + 1
    dev = step.device
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads, layout)
    clip = torch.clamp(_f32(cfg.grad_clip, dev)
                       / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(cfg.beta1, dev), stepf)
    bc2 = 1.0 - torch.pow(_f32(cfg.beta2, dev), stepf)

    pl = T.leaves(params)
    own = layout.dp_slices(params) if layout else pl
    for i, (p, o, g, m, v, master) in enumerate(zip(
            pl, own, T.leaves(grads), T.leaves(state["m"]),
            T.leaves(state["v"]), T.flatten_up_to(params, state["master"]))):
        g = g.float() * clip
        m.mul_(cfg.beta1).add_(g * (1 - cfg.beta1))
        v.mul_(cfg.beta2).add_(g.square_().mul_(1 - cfg.beta2))
        del g
        base = master if master is not None else o     # fp32 either way
        upd = m / bc1                                  # mhat
        upd.div_((v / bc2).sqrt_().add_(cfg.eps))      # / (sqrt(vhat) + eps)
        upd.add_(base * cfg.weight_decay)
        base.sub_(upd.mul_(lr))
        del upd
        if master is not None:
            o.copy_(master)                            # the cast
        if layout is not None:
            layout.gather_dp(i, p, o)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
