"""Wrapper of the CUDA paged-attention decode kernel
(``csrc/paged_attention.cu``), the port of the TPU kernel
``paged_attention_fused`` of the reference package.

``paged_attention_fused`` takes the fused pool ``[Hkv, P, 2, ps, D]``. A
tensor on the CPU goes to the plain PyTorch version (``ref.py``); a CUDA
tensor goes to the kernel, or the wrapper raises. The wrapper allocates the
outputs, launches on the current stream and counts its launches in
``paged_attention_fused.launches``.

The launch geometry (threads, query rows and pages per block, shared
memory) is chosen by the C launcher, which owns the block's layout; a
launch whose grouped heads do not fit a block fails with CUDA's
"invalid argument".
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_fused_ref, paged_attention_partial_ref)

DTYPES = (torch.bfloat16, torch.float32)


def check_operands(q, kv_pages, int_args) -> None:
    """Device, dtype, contiguity and shape checks of a kernel launch."""
    D = q.shape[-1]
    if kv_pages.dim() != 5 or kv_pages.shape[2] != 2 or kv_pages.shape[4] != D:
        raise ValueError(f"kv_pages must be [Hkv, P, 2, ps, {D}], got "
                         f"{tuple(kv_pages.shape)}")
    if q.dtype not in DTYPES or kv_pages.dtype != q.dtype:
        raise TypeError(f"q and kv_pages must share a dtype in {DTYPES}, got "
                        f"{q.dtype} and {kv_pages.dtype}")
    if D % 16 or not 16 <= D <= 256:
        raise ValueError(f"head_dim {D} must be a multiple of 16 up to 256")
    for name, t in [("q", q), ("kv_pages", kv_pages)] + list(int_args.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in int_args and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if q.data_ptr() % 16 or kv_pages.data_ptr() % 16:
        raise ValueError("q and kv_pages must be 16-byte aligned")


def paged_attention_fused(q, kv_pages, block_tables, lengths, *, scale,
                          window=0, softcap=0.0, partial=False):
    """Decode attention: q [B, H, D] over kv_pages [Hkv, P, 2, ps, D]
    through block_tables [B, n] int32 with lengths [B] int32 (counting the
    token just written). Returns [B, H, D] in q's dtype, or with
    ``partial=True`` the fp32 state ``(acc [B,H,D], m [B,H], l [B,H])``."""
    if q.device.type == "cpu":
        fn = paged_attention_partial_ref if partial else paged_attention_fused_ref
        return fn(q, kv_pages, block_tables, lengths, scale=scale,
                  window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention kernel for device {q.device}")
    B, H, D = q.shape
    Hkv, P, _, ps, _ = kv_pages.shape
    if H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv}")
    G = H // Hkv
    check_operands(q, kv_pages, {"block_tables": block_tables,
                                 "lengths": lengths})
    n = block_tables.shape[1]
    if block_tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError("block_tables must be [B, n] and lengths [B]")
    out = torch.empty((B, H, D), device=q.device,
                      dtype=torch.float32 if partial else q.dtype)
    m = l = None
    if partial:
        m = torch.empty((B, H), device=q.device, dtype=torch.float32)
        l = torch.empty((B, H), device=q.device, dtype=torch.float32)
    lib = build.library("paged_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.paged_attention_fused_launch(
            q.data_ptr(), kv_pages.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            m.data_ptr() if partial else None,
            l.data_ptr() if partial else None,
            B, Hkv, G, D, P, ps, n, float(scale), int(window),
            float(softcap), int(partial), int(q.dtype == torch.bfloat16),
            stream)
    build.check("paged_attention", code)
    paged_attention_fused.launches += 1
    return (out, m, l) if partial else out


paged_attention_fused.launches = 0
