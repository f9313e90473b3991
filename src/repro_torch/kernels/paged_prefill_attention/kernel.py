"""Wrapper of the CUDA paged-prefill kernel
(``csrc/paged_prefill_attention.cu``), the port of the TPU kernel
``paged_prefill_attention_fused`` of the reference package. It serves the
engine's ragged prefill rows and its speculative-verify rows.

A tensor on the CPU goes to the plain PyTorch version (``ref.py``); a CUDA
tensor goes to the kernel, or the wrapper raises. Launches are counted in
``paged_prefill_attention_fused.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.kernel import check_operands
from repro_torch.kernels.paged_prefill_attention.ref import (
    paged_prefill_attention_fused_ref, paged_prefill_attention_partial_ref)


def paged_prefill_attention_fused(q, kv_pages, block_tables, row_pos,
                                  lengths, *, scale, window=0, softcap=0.0,
                                  partial=False):
    """Ragged chunked prefill: q [R, Sq, Hkv, G, D] at cache offsets
    row_pos [R] int32 with post-chunk lengths [R] int32, over kv_pages
    [Hkv, P, 2, ps, D] through block_tables [R, n] int32. Returns
    [R, Sq, Hkv, G, D] in q's dtype, or with ``partial=True`` the fp32 state
    ``(acc [R,Sq,Hkv,G,D], m [R,Sq,Hkv,G], l [R,Sq,Hkv,G])``."""
    if q.device.type == "cpu":
        fn = (paged_prefill_attention_partial_ref if partial
              else paged_prefill_attention_fused_ref)
        return fn(q, kv_pages, block_tables, row_pos, lengths, scale=scale,
                  window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_prefill_attention kernel for {q.device}")
    R, Sq, Hkv, G, D = q.shape
    _, P, _, ps, _ = kv_pages.shape
    if kv_pages.shape[0] != Hkv:
        raise ValueError(f"q has {Hkv} kv heads, kv_pages {kv_pages.shape[0]}")
    check_operands(q, kv_pages, {"block_tables": block_tables,
                                 "row_pos": row_pos, "lengths": lengths})
    n = block_tables.shape[1]
    if (block_tables.shape[0] != R or row_pos.shape != (R,)
            or lengths.shape != (R,)):
        raise ValueError("block_tables must be [R, n], row_pos and lengths [R]")
    out = torch.empty(q.shape, device=q.device,
                      dtype=torch.float32 if partial else q.dtype)
    m = l = None
    if partial:
        m = torch.empty((R, Sq, Hkv, G), device=q.device, dtype=torch.float32)
        l = torch.empty((R, Sq, Hkv, G), device=q.device, dtype=torch.float32)
    lib = build.library("paged_prefill_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.paged_prefill_attention_fused_launch(
            q.data_ptr(), kv_pages.data_ptr(), block_tables.data_ptr(),
            row_pos.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            m.data_ptr() if partial else None,
            l.data_ptr() if partial else None,
            R, Sq, Hkv, G, D, P, ps, n, float(scale), int(window),
            float(softcap), int(partial), int(q.dtype == torch.bfloat16),
            stream)
    build.check("paged_prefill_attention", code)
    paged_prefill_attention_fused.launches += 1
    return (out, m, l) if partial else out


paged_prefill_attention_fused.launches = 0
