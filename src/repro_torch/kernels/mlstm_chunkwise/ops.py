"""Dispatch of the mLSTM chunkwise kernel, as the model calls it (port of
the reference ``mlstm_chunkwise/ops.py``, with the carried state; PyTorch
runs eagerly, so there is no jit and no static-argument list), and its
gradient from a fresh state.

Training runs the mLSTM from a fresh state (C 0, n 0, m -1e30) through
``MlstmChunkwiseFresh``: its forward allocates that state itself and
launches the wrapper on it (the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor), so the kernel's in-place write of C never
touches a tensor that autograd saved; its backward recomputes the plain
version (``ref.py``) from the saved inputs under autograd and returns
their gradients. That backward is the only place the plain version runs
when a card is present. It runs there because the reference has no
backward kernel to port: JAX differentiates the jnp quadratic form the
reference trains through. A hand-written chunkwise backward kernel is
later work. The Function is used only when grad mode is on and an input
requires grad; serving calls the wrapper directly."""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import grads_of_plain
from repro_torch.kernels.mlstm_chunkwise.kernel import cost, mlstm_chunkwise
from repro_torch.kernels.mlstm_chunkwise.ref import (NEG_INF,
                                                     mlstm_chunkwise_ref)


def mlstm_chunkwise_op(q, k, v, log_i, log_f, C, n, m, *, rows=None):
    """The CUDA kernel for tensors on the GPU, its plain PyTorch version for
    tensors on the CPU. The chunk length is a runtime integer."""
    return mlstm_chunkwise(q, k, v, log_i, log_f, C, n, m, rows=rows)


def _fresh_state(q):
    B, _, H, D = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros((B, H, D, D), **f32), torch.zeros((B, H, D), **f32),
            torch.full((B, H), NEG_INF, **f32))


class MlstmChunkwiseFresh(torch.autograd.Function):
    """#7 from a fresh state with a gradient: the kernel forward, the plain
    backward. Returns (h, the new state C, n, m), the state outside the
    graph."""

    @staticmethod
    def forward(ctx, q, k, v, log_i, log_f):
        ctx.save_for_backward(q, k, v, log_i, log_f)
        C, n, m = _fresh_state(q)
        h, n_new, m_new = mlstm_chunkwise(q, k, v, log_i, log_f, C, n, m)
        ctx.mark_non_differentiable(C, n_new, m_new)
        return h, C, n_new, m_new

    @staticmethod
    def backward(ctx, grad_h, *_grad_state):
        saved = ctx.saved_tensors          # unpacked once (checkpoints)
        return tuple(grads_of_plain(
            lambda *a: mlstm_chunkwise_ref(*a, *_fresh_state(saved[0]))[0],
            saved, ctx.needs_input_grad, grad_h, "mlstm_chunkwise",
            cost(*saved[0].shape, saved[0].dtype)))


def mlstm_chunkwise_fresh_op(q, k, v, log_i, log_f):
    """The mLSTM from a fresh state; returns (h, C, n, m), the new state.
    Differentiable (through ``MlstmChunkwiseFresh``) when grad mode is on
    and an input requires grad."""
    ins = (q, k, v, log_i, log_f)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return MlstmChunkwiseFresh.apply(*ins)
    C, n, m = _fresh_state(q)
    h, n_new, m_new = mlstm_chunkwise(*ins, C, n, m)
    return h, C, n_new, m_new
