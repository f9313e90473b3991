"""Wrapper of the CUDA chunked-prefill attention kernel
(``csrc/chunked_prefill_attention.cu``), the port of the TPU kernel
``chunked_prefill_attention`` of the reference package. It serves the slot
engine's prompt chunks (``_chunk_attend`` of ``models/model.py``).

A tensor on the CPU goes to the plain PyTorch version (``ref.py``); a CUDA
tensor goes to the kernel, or the wrapper raises. Every operand may be a
strided view whose last axis is contiguous: the kernel reads q, k and v in
place through their strides. Launches are counted in
``chunked_prefill_attention.launches``. The launch geometry (query tokens
per block, keys per tile, shared memory) is chosen by the C launcher.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunked_prefill_attention.ref import (
    chunked_prefill_attention_ref)
from repro_torch.kernels.paged_attention.kernel import DTYPES


def _check(q, k, v, lengths) -> None:
    B, H, Sq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"k and v must be [{B}, Hkv, Sk, {D}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[1]}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype in {DTYPES}, got "
                        f"{q.dtype}, {k.dtype} and {v.dtype}")
    if D % 16 or not 16 <= D <= 256:
        raise ValueError(f"head_dim {D} must be a multiple of 16 up to 256")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous int32 [B] tensor")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if name == "lengths":
            continue
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous last axis")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned, with strides "
                             f"that are multiples of {vec} elements")


def chunked_prefill_attention(q, k, v, lengths, *, scale, q_offset=0,
                              causal=True, window=0, softcap=0.0):
    """Attention of a query chunk q [B, H, Sq, D] at positions
    ``q_offset + t`` over k/v [B, Hkv, Sk, D] with valid lengths [B] int32.
    Returns [B, H, Sq, D] in q's dtype (a view of a [B, Sq, H, D] tensor on
    the GPU)."""
    if q.device.type == "cpu":
        return chunked_prefill_attention_ref(
            q, k, v, lengths, scale=scale, q_offset=q_offset, causal=causal,
            window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no chunked_prefill_attention kernel for {q.device}")
    _check(q, k, v, lengths)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    lib = build.library("chunked_prefill_attention")
    out = torch.empty((B, Sq, H, D), device=q.device,
                      dtype=q.dtype).permute(0, 2, 1, 3)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.chunked_prefill_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], B, Sq, Sk, Hkv, H // Hkv, D,
            int(q_offset), int(causal), int(window), float(scale),
            float(softcap), int(q.dtype == torch.bfloat16), stream)
    build.check("chunked_prefill_attention", code)
    chunked_prefill_attention.launches += 1
    return out


chunked_prefill_attention.launches = 0
