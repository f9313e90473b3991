"""Dispatch of the paged-attention decode kernel, as the model calls it
(port of the reference ``paged_attention/ops.py``, single device only: the
head- and sequence-sharded mesh paths are not ported yet)."""
from __future__ import annotations

from repro_torch.kernels.paged_attention.kernel import paged_attention_fused


def paged_attention_auto(q, kv_pages, block_tables, lengths, *, scale,
                         window=0, softcap=0.0):
    """Single-device dispatch: the CUDA kernel for tensors on the GPU, its
    plain PyTorch version for tensors on the CPU."""
    return paged_attention_fused(q, kv_pages, block_tables, lengths,
                                 scale=scale, window=window, softcap=softcap)
