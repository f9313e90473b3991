"""Dispatch of the chunked-prefill attention kernel, as the model calls it
(port of the reference ``chunked_prefill_attention/ops.py``; PyTorch runs
eagerly, so there is no jit and no static-argument list)."""
from __future__ import annotations

from repro_torch.kernels.chunked_prefill_attention.kernel import (
    chunked_prefill_attention)


def chunked_prefill_attention_op(q, k, v, lengths, *, scale, q_offset=0,
                                 causal=True, window=0, softcap=0.0):
    """The CUDA kernel for tensors on the GPU, its plain PyTorch version for
    tensors on the CPU: q [B, H, Sq, D] over k [B, Hkv, Sk, D] and v [B,
    Hkv, Sk, Dv] (values may be narrower than keys), out [B, H, Sq, Dv].
    ``q_offset`` is a runtime integer."""
    return chunked_prefill_attention(q, k, v, lengths, scale=scale,
                                     q_offset=q_offset, causal=causal,
                                     window=window, softcap=softcap)
