"""Dispatch of the chunked-prefill attention kernel, as the model calls it
(port of the reference ``chunked_prefill_attention/ops.py``; PyTorch runs
eagerly, so there is no jit and no static-argument list), and its
gradient.

The kernel is a ctypes call that writes a fresh tensor, which autograd
cannot see, so training goes through ``ChunkedPrefillAttention``: its
forward is the wrapper (the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor); its backward recomputes the plain version
(``ref.py``) from the saved inputs under autograd and returns the
gradients of q, k and v. That backward is the only place the plain version
runs when a card is present. It runs there because the reference has no
backward kernel to port: JAX differentiates the XLA attention the
reference trains through. A hand-written backward kernel is later work.
The Function is used only when grad mode is on and q, k or v requires
grad; serving calls the wrapper directly, with the same launches and
bits as before."""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import grads_of_plain
from repro_torch.kernels.chunked_prefill_attention.kernel import (
    chunked_prefill_attention, cost)
from repro_torch.kernels.chunked_prefill_attention.ref import (
    chunked_prefill_attention_ref)


class ChunkedPrefillAttention(torch.autograd.Function):
    """#5 with a gradient: the kernel forward, the plain backward."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale, q_offset, causal, window,
                softcap):
        ctx.save_for_backward(q, k, v, lengths)
        ctx.opts = dict(scale=scale, q_offset=q_offset, causal=causal,
                        window=window, softcap=softcap)
        return chunked_prefill_attention(q, k, v, lengths, **ctx.opts)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, lengths = ctx.saved_tensors
        o = ctx.opts
        grads = grads_of_plain(
            lambda q, k, v: chunked_prefill_attention_ref(
                q, k, v, lengths, **ctx.opts),
            (q, k, v), ctx.needs_input_grad[:3], grad_out,
            "chunked_prefill_attention", cost(
                *q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                q.shape[3], v.shape[3], q.dtype, q_offset=o["q_offset"],
                causal=o["causal"], window=o["window"]))
        return (*grads, None, None, None, None, None, None)


def chunked_prefill_attention_op(q, k, v, lengths, *, scale, q_offset=0,
                                 causal=True, window=0, softcap=0.0):
    """The CUDA kernel for tensors on the GPU, its plain PyTorch version for
    tensors on the CPU: q [B, H, Sq, D] over k [B, Hkv, Sk, D] and v [B,
    Hkv, Sk, Dv] (values may be narrower than keys), out [B, H, Sq, Dv].
    ``q_offset`` is a runtime integer. Differentiable (through
    ``ChunkedPrefillAttention``) when grad mode is on and q, k or v
    requires grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return ChunkedPrefillAttention.apply(q, k, v, lengths, scale,
                                             q_offset, causal, window,
                                             softcap)
    return chunked_prefill_attention(q, k, v, lengths, scale=scale,
                                     q_offset=q_offset, causal=causal,
                                     window=window, softcap=softcap)
