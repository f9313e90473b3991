"""Train-step factory: loss + gradients + AdamW update (+ optional int8
gradient compression), with the context's remat policy and gradient
accumulation (port of the reference ``train/train_step.py``).

Gradients come from ``torch.autograd.grad`` over every parameter leaf (a
leaf the loss does not reach, such as DeepSeek-v3's router bias, gets
zeros, as JAX gives it). With ``grad_accum > 1`` the batch is split along
B into micro-batches whose fp32 gradients are summed and scaled by
``1/grad_accum``, as the reference's ``lax.scan`` does. The update is in
place (``train/optimizer.py``): ``train_step`` returns the same parameter
tree and state it was given.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import RunCtx, loss_fn
from repro_torch.runtime import compression
from repro_torch.train import tree as T
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    grad_accum: int = 1
    compress_grads: bool = False


def init_train_state(cfg: ModelConfig, params, train_cfg: TrainConfig):
    state = {"opt": adamw_init(params)}
    if train_cfg.compress_grads:
        state["ef"] = compression.init_error_feedback(params)
    return state


def make_train_step(cfg: ModelConfig, rctx: RunCtx, train_cfg: TrainConfig):
    """Returns train_step(params, state, batch) -> (params, state, metrics).

    ``batch["tokens"]``: [B, S] (plus optional modality-frontend entries:
    "extra_embeds", "enc_embeds"), on the parameters' device."""

    def value_and_grad(params, batch):
        leaves = [p.requires_grad_() for p in T.leaves(params)]
        loss = loss_fn(cfg, params, batch, rctx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def compute_grads(params, batch):
        ga = train_cfg.grad_accum
        if ga == 1:
            loss, grads = value_and_grad(params, batch)
            return loss, T.unflatten(params, grads)
        B = batch["tokens"].shape[0]
        if B % ga:
            raise ValueError(f"batch {B} does not split into {ga} "
                             f"micro-batches")
        mb = B // ga
        loss_sum, acc = None, None
        for i in range(ga):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, grads = value_and_grad(params, micro)
            if acc is None:
                loss_sum, acc = loss, [g.float() for g in grads]
            else:
                loss_sum = loss_sum + loss
                for a, g in zip(acc, grads):
                    a.add_(g.float())
        inv = 1.0 / ga
        return loss_sum * inv, T.unflatten(params, [a.mul_(inv) for a in acc])

    def train_step(params, state, batch):
        loss, grads = compute_grads(params, batch)
        if train_cfg.compress_grads:
            grads, state["ef"] = compression.compress_tree(grads, state["ef"])
        params, state["opt"], metrics = adamw_update(
            train_cfg.optimizer, params, grads, state["opt"])
        return params, state, dict(metrics, loss=loss)

    return train_step
