"""Wrappers of the CUDA paged-prefill kernels
(``csrc/paged_prefill_attention.cu``), the ports of the TPU kernels
``paged_prefill_attention_fused`` (the fused pool; it serves the engine's
ragged prefill rows and its speculative-verify rows) and
``paged_prefill_attention`` (split K and V pools, no partial mode).

A tensor on the CPU goes to the plain PyTorch version (``ref.py``); a CUDA
tensor goes to the kernel, or the wrapper raises. Launches are counted in
``<wrapper>.launches``. In bf16 both kernels run on the tensor cores (one
tile loop, one block shape: the split-pool kernel gives the fused one's
bits on the same keys) and take head_dim 64, 128 or 256 and at most a
block's rows of query heads per kv head (``build.check_mma_geometry`` asks
the library); fp32 keeps the scalar loop.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost as C
from repro_torch.kernels.paged_attention.kernel import check_operands
from repro_torch.kernels.paged_prefill_attention.ref import (
    paged_prefill_attention_fused_ref, paged_prefill_attention_partial_ref,
    paged_prefill_attention_ref)


def _prefill_dims(q, Hkv, block_tables, row_pos, lengths):
    R, Sq, qHkv, G, D = q.shape
    if qHkv != Hkv:
        raise ValueError(f"q has {qHkv} kv heads, the pool {Hkv}")
    if (block_tables.shape[0] != R or row_pos.shape != (R,)
            or lengths.shape != (R,)):
        raise ValueError("block_tables must be [R, n], row_pos and lengths [R]")
    return R, Sq, G, D, block_tables.shape[1]


def cost(R, Sq, Hkv, G, D, page_size, n, dtype, row_pos=None, lengths=None,
         window=0, partial=False) -> C.Work:
    """#2/#4's work (``kernels/cost.py``): q and the output once (the fp32
    state with ``partial``), each row's pages up to its chunk's end once
    per KV head, the block table, offsets and lengths; Q.K^T and P.V over
    the (query, key) pairs that the causal, window and length masks leave
    (without data, each row a whole table of ``n`` pages with the chunk at
    its end)."""
    import numpy as np
    lens = np.full(R, n * page_size) if lengths is None else np.asarray(
        lengths, dtype=np.int64).reshape(-1)
    pos = lens - Sq if row_pos is None else np.asarray(
        row_pos, dtype=np.int64).reshape(-1)
    pages = pairs = 0
    for p_, l_ in zip(pos, lens):
        if l_ > 0:
            pages += min(-(-l_ // page_size), -(-(p_ + Sq) // page_size), n)
        qp = p_ + np.arange(Sq)
        qp = qp[qp < l_]
        hi = np.minimum(qp + 1, l_)
        lo = np.maximum(qp - window + 1, 0) if window > 0 else 0
        pairs += int(np.maximum(hi - lo, 0).sum())
    elt = torch.empty((), dtype=dtype).element_size()
    q_n = R * Sq * Hkv * G * D
    out = q_n * 4 + 2 * R * Sq * Hkv * G * 4 if partial else q_n * elt
    return C.Work(flops=4 * D * Hkv * G * pairs,
                  bytes=q_n * elt + out + int(pages) * page_size * Hkv * 2
                  * D * elt + R * n * 4 + 2 * R * 4,
                  dtype=C.dtype_name(dtype))


def _fake(q, ps, block_tables, partial):
    """The outputs of a call on tensors that hold no data, its work
    counted (``kernels/cost.py``)."""
    R, Sq, Hkv, G, D = q.shape
    C.record("paged_prefill_attention", cost(
        R, Sq, Hkv, G, D, ps, block_tables.shape[1], q.dtype,
        partial=partial))
    if not partial:
        return torch.empty(q.shape, device=q.device, dtype=q.dtype)
    f32 = dict(device=q.device, dtype=torch.float32)
    return (torch.empty(q.shape, **f32), torch.empty(q.shape[:4], **f32),
            torch.empty(q.shape[:4], **f32))


def paged_prefill_attention_fused(q, kv_pages, block_tables, row_pos,
                                  lengths, *, scale, window=0, softcap=0.0,
                                  partial=False):
    """Ragged chunked prefill: q [R, Sq, Hkv, G, D] at cache offsets
    row_pos [R] int32 with post-chunk lengths [R] int32, over kv_pages
    [Hkv, P, 2, ps, D] through block_tables [R, n] int32. Returns
    [R, Sq, Hkv, G, D] in q's dtype, or with ``partial=True`` the fp32 state
    ``(acc [R,Sq,Hkv,G,D], m [R,Sq,Hkv,G], l [R,Sq,Hkv,G])``."""
    if C.is_fake(q):
        return _fake(q, kv_pages.shape[3], block_tables, partial)
    if q.device.type == "cpu":
        fn = (paged_prefill_attention_partial_ref if partial
              else paged_prefill_attention_fused_ref)
        return fn(q, kv_pages, block_tables, row_pos, lengths, scale=scale,
                  window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_prefill_attention kernel for {q.device}")
    check_operands(q, (kv_pages,), {"block_tables": block_tables,
                                    "row_pos": row_pos, "lengths": lengths})
    Hkv, P, _, ps, _ = kv_pages.shape
    R, Sq, G, D, n = _prefill_dims(q, Hkv, block_tables, row_pos, lengths)
    if q.dtype == torch.bfloat16:
        build.check_mma_geometry("paged_prefill_attention", G, D)
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


def paged_prefill_attention(q, k_pages, v_pages, block_tables, row_pos,
                            lengths, *, scale, window=0, softcap=0.0):
    """Ragged chunked prefill over split pools: q [R, Sq, Hkv, G, D] (any
    Sq) at cache offsets row_pos [R] int32 with post-chunk lengths [R]
    int32, over k_pages and v_pages [Hkv, P, ps, D] through block_tables
    [R, n] int32. Returns [R, Sq, Hkv, G, D] in q's dtype."""
    if C.is_fake(q):
        return _fake(q, k_pages.shape[2], block_tables, False)
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(q, k_pages, v_pages, block_tables,
                                           row_pos, lengths, scale=scale,
                                           window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_prefill_attention kernel for {q.device}")
    check_operands(q, (k_pages, v_pages),
                   {"block_tables": block_tables, "row_pos": row_pos,
                    "lengths": lengths})
    Hkv, P, ps, _ = k_pages.shape
    R, Sq, G, D, n = _prefill_dims(q, Hkv, block_tables, row_pos, lengths)
    if q.dtype == torch.bfloat16:
        build.check_mma_geometry("paged_prefill_attention", G, D)
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    lib = build.library("paged_prefill_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.paged_prefill_attention_split_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), row_pos.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), R, Sq, Hkv, G, D, P, ps, n, float(scale),
            int(window), float(softcap), int(q.dtype == torch.bfloat16),
            stream)
    build.check("paged_prefill_attention", code)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
