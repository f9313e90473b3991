"""Wrappers of the CUDA paged-attention decode kernels
(``csrc/paged_attention.cu``), the ports of the TPU kernels
``paged_attention_fused`` and ``paged_attention`` of the reference
package.

``paged_attention_fused`` takes the fused pool ``[Hkv, P, 2, ps, D]`` (the
serving path); ``paged_attention`` takes split K and V pools, each ``[Hkv,
P, ps, D]``, and has no partial mode. A tensor on the CPU goes to the plain
PyTorch version (``ref.py``); a CUDA tensor goes to the kernel, or the
wrapper raises. Each wrapper allocates the outputs, launches on the current
stream and counts its launches in ``<wrapper>.launches``.

The launch geometry (threads, query rows and pages per block, shared
memory) is chosen by the C launcher, which owns the block's layout; a
launch whose grouped heads do not fit a block fails with CUDA's
"invalid argument".
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_fused_ref, paged_attention_partial_ref,
    paged_attention_ref)

DTYPES = (torch.bfloat16, torch.float32)


def check_operands(q, pools, int_args) -> None:
    """Device, dtype, contiguity and shape checks of a kernel launch over
    the fused pool (``pools = (kv_pages,)``) or split pools (``(k_pages,
    v_pages)``)."""
    D = q.shape[-1]
    if len(pools) == 1:
        kv = pools[0]
        if kv.dim() != 5 or kv.shape[2] != 2 or kv.shape[4] != D:
            raise ValueError(f"kv_pages must be [Hkv, P, 2, ps, {D}], got "
                             f"{tuple(kv.shape)}")
        named = {"kv_pages": kv}
    else:
        k, v = pools
        if k.dim() != 4 or k.shape[3] != D or v.shape != k.shape:
            raise ValueError(f"k_pages and v_pages must both be [Hkv, P, "
                             f"ps, {D}], got {tuple(k.shape)} and "
                             f"{tuple(v.shape)}")
        named = {"k_pages": k, "v_pages": v}
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in pools):
        raise TypeError(f"q and the pools must share a dtype in {DTYPES}, "
                        f"got {q.dtype} and "
                        f"{', '.join(str(t.dtype) for t in pools)}")
    if D % 16 or not 16 <= D <= 256:
        raise ValueError(f"head_dim {D} must be a multiple of 16 up to 256")
    for name, t in [("q", q)] + list(named.items()) + list(int_args.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in int_args and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if q.data_ptr() % 16 or any(t.data_ptr() % 16 for t in pools):
        raise ValueError("q and the pools must be 16-byte aligned")


def _decode_dims(q, Hkv, block_tables, lengths):
    B, H, D = q.shape
    if H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv}")
    if block_tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError("block_tables must be [B, n] and lengths [B]")
    return B, H, D, H // Hkv, block_tables.shape[1]


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
    check_operands(q, (kv_pages,), {"block_tables": block_tables,
                                    "lengths": lengths})
    Hkv, P, _, ps, _ = kv_pages.shape
    B, H, D, G, n = _decode_dims(q, Hkv, block_tables, lengths)
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


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *, scale,
                    window=0, softcap=0.0):
    """Decode attention over split pools: q [B, H, D] over k_pages and
    v_pages [Hkv, P, ps, D] through block_tables [B, n] int32 with lengths
    [B] int32 (counting the token just written). Returns [B, H, D] in q's
    dtype."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                   scale=scale, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention kernel for device {q.device}")
    check_operands(q, (k_pages, v_pages), {"block_tables": block_tables,
                                           "lengths": lengths})
    Hkv, P, ps, _ = k_pages.shape
    B, H, D, G, n = _decode_dims(q, Hkv, block_tables, lengths)
    out = torch.empty((B, H, D), device=q.device, dtype=q.dtype)
    lib = build.library("paged_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.paged_attention_split_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, Hkv, G, D, P, ps, n, float(scale), int(window),
            float(softcap), int(q.dtype == torch.bfloat16), stream)
    build.check("paged_attention", code)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
