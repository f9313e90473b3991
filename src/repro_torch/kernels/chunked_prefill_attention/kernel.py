"""Wrapper of the CUDA chunked-prefill attention kernel
(``csrc/chunked_prefill_attention.cu``), the port of the TPU kernel
``chunked_prefill_attention`` of the reference package. It serves the slot
engine's prompt chunks (``_chunk_attend`` of ``models/model.py``).

A tensor on the CPU goes to the plain PyTorch version (``ref.py``); a CUDA
tensor goes to the kernel, or the wrapper raises; a tensor that holds no
data (a fake tensor) gives an empty output and counts :func:`cost`
(``kernels/cost.py``). Every operand may be a
strided view whose last axis is contiguous: the kernel reads q, k and v in
place through their strides. Launches are counted in
``chunked_prefill_attention.launches``. The launch geometry (query tokens
per block, keys per tile, shared memory) is chosen by the C launcher.

The values may be narrower than the keys (v [B, Hkv, Sk, Dv], Dv <= D;
deepseek-v3's MLA attends with keys of 192 and values of 128). In bf16 the
kernel runs on the tensor cores (wgmma fed by TMA,
``csrc/attend_wgmma.cuh``), at the (D, Dv) pairs that the C source names
(``mma_launch``: attention's head dims and MLA's pair), reading K and V
through tensor maps of their strides (bases and strides multiples of 16
bytes), and may split the key range (split-K): ``split_plan`` chooses the
number of splits from the grid and the card's SM count, the wrapper
allocates the fp32 partial state of the splits as scratch, and a second
kernel, ``chunked_prefill_attention_combine``, merges them; its launches
are counted in ``chunked_prefill_attention.combine_launches``. fp32 keeps
the scalar loop (any D and Dv that are multiples of 8 up to 256) and never
splits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost as C
from repro_torch.kernels.chunked_prefill_attention.ref import (
    chunked_prefill_attention_ref)
from repro_torch.kernels.paged_attention.kernel import DTYPES

KERNEL = "chunked_prefill_attention"

# The split plan (bf16). A block of the tensor-core kernel fills an SM
# alone, so a grid of `blocks` blocks runs in ceil(blocks / sms) waves, each
# as long as its blocks' key walks. split_plan takes the count of splits
# whose modelled time is least: waves x (key tiles a split + a split's own
# cost, SPLIT_OVERHEAD_TILES: its Q tile, its ring's first tiles, its
# partial state) + the combine's COMBINE_TILES when split, in key tiles'
# worth of a block's time.
SPLIT_OVERHEAD_TILES = 2
COMBINE_TILES = 4
# Key tiles a split walks, at least.
MIN_SPLIT_TILES = 2
# Key tiles a chunk must see before it is split at all. A split call costs
# the host more (the scratch, the combine's launch), which a short key walk
# does not earn back on a host-bound path such as llama3.2-3b's slot
# serving, where a 512-token chunk at offset 0 (4 tiles of 128 keys) is the
# first chunk of every long prompt.
SPLIT_FROM_TILES = 8


@functools.lru_cache(maxsize=4096)
def split_plan(B, Hkv, q_tiles, key_tiles, sms) -> int:
    """Key splits of a bf16 launch of B x Hkv x q_tiles blocks whose chunk
    sees key_tiles key tiles, on a card of ``sms`` SMs: 1 when the grid
    already gives every SM a block or the chunk sees fewer than
    SPLIT_FROM_TILES tiles, else the count from 1 to key_tiles //
    MIN_SPLIT_TILES that the wave model above gives the least time (the
    fewest on a tie), so that blocks x splits fills whole waves of the
    card. The launcher cuts split s at tile s * key_tiles // n, so every
    split walks MIN_SPLIT_TILES tiles or more and none is empty by
    construction."""
    blocks = B * Hkv * q_tiles
    if blocks <= 0 or blocks >= sms or key_tiles < SPLIT_FROM_TILES:
        return 1

    def model(n):
        waves = -(-blocks * n // sms)
        return (waves * (key_tiles / n + SPLIT_OVERHEAD_TILES)
                + (COMBINE_TILES if n > 1 else 0))
    return min(range(1, key_tiles // MIN_SPLIT_TILES + 1),
               key=lambda n: (model(n), n))


@functools.lru_cache(maxsize=4096)
def _grid(Sq, Sk, G, D, Dv, q_offset, causal, window):
    """(q tiles, key tiles) of a bf16 launch, as the library computes them
    (``chunked_prefill_attention_mma_plan``), cached per shape."""
    info = (ctypes.c_int * 2)()
    build.check(KERNEL, build.library(KERNEL).chunked_prefill_attention_mma_plan(
        Sq, Sk, G, D, Dv, q_offset, causal, window, info))
    return info[0], info[1]


def planned_splits(q, k, v, *, q_offset=0, causal=True, window=0) -> int:
    """The key splits the wrapper launches for these operands: 1 for fp32,
    else ``split_plan`` at q's card, from the q tiles and key tiles that the
    library computes for the launch (``chunked_prefill_attention_mma_plan``:
    the block's shape and the split range are the library's own)."""
    if q.dtype != torch.bfloat16:
        return 1
    B, H, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    q_tiles, key_tiles = _grid(Sq, Sk, H // Hkv, D, Dv, int(q_offset),
                               int(causal), int(window))
    return split_plan(B, Hkv, q_tiles, key_tiles, build.sm_count(q.device))


def cost(B, H, Hkv, Sq, Sk, D, Dv, dtype, lengths=None, q_offset=0,
         causal=True, window=0) -> C.Work:
    """#5's work (``kernels/cost.py``): q and the output once, each row's
    visible key range once per KV head; Q.K^T and P.V over the (query,
    key) pairs that the causal, window and length masks leave (every key
    of a row valid when ``lengths`` is None)."""
    import numpy as np
    lens = np.full(B, Sk) if lengths is None else np.minimum(
        np.asarray(lengths, dtype=np.int64).reshape(-1), Sk)
    qp = int(q_offset) + np.arange(Sq, dtype=np.int64)
    pairs = span = 0
    for n in lens:
        hi = np.minimum(qp + 1, n) if causal else np.full(Sq, n)
        lo = np.maximum(qp - window + 1, 0) if window > 0 else np.zeros(
            Sq, np.int64)
        live = hi > lo
        pairs += int((hi - lo)[live].sum())
        span += int(hi[live].max() - lo[live].min()) if live.any() else 0
    elt = torch.empty((), dtype=dtype).element_size()
    return C.Work(flops=2 * (D + Dv) * H * pairs,
                  bytes=B * Sq * H * (D + Dv) * elt
                  + span * Hkv * (D + Dv) * elt + B * 4,
                  dtype=C.dtype_name(dtype))


def _check(q, k, v, lengths) -> None:
    B, H, Sq, D = q.shape
    if k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3] \
            or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k must be [{B}, Hkv, Sk, {D}] and v [{B}, Hkv, "
                         f"Sk, Dv], got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    Dv = v.shape[3]
    if H % k.shape[1]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[1]}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype in {DTYPES}, got "
                        f"{q.dtype}, {k.dtype} and {v.dtype}")
    if D % 8 or Dv % 8 or not 8 <= Dv <= D <= 256:
        raise ValueError(f"head_dim {D} and value width {Dv} must be "
                         f"multiples of 8 with value width <= head_dim <= "
                         f"256")
    if q.dtype == torch.bfloat16:
        build.check_mma_geometry(KERNEL, H // k.shape[1], D, Dv)
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
                             f"that are multiples of {vec} elements (16 "
                             f"bytes: the cp.async rows of q, the TMA "
                             f"tensor maps of k and v)")


def chunked_prefill_attention(q, k, v, lengths, *, scale, q_offset=0,
                              causal=True, window=0, softcap=0.0):
    """Attention of a query chunk q [B, H, Sq, D] at positions
    ``q_offset + t`` over k [B, Hkv, Sk, D] and v [B, Hkv, Sk, Dv] with
    valid lengths [B] int32. Returns [B, H, Sq, Dv] in q's dtype (a view of
    a [B, Sq, H, Dv] tensor on the GPU)."""
    if C.is_fake(q):
        B, H, Sq, D = q.shape
        Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
        C.record(KERNEL, cost(B, H, Hkv, Sq, Sk, D, Dv, q.dtype,
                              q_offset=q_offset, causal=causal,
                              window=window))
        return torch.empty((B, Sq, H, Dv), device=q.device,
                           dtype=q.dtype).permute(0, 2, 1, 3)
    if q.device.type == "cpu":
        return chunked_prefill_attention_ref(
            q, k, v, lengths, scale=scale, q_offset=q_offset, causal=causal,
            window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no chunked_prefill_attention kernel for {q.device}")
    _check(q, k, v, lengths)
    B, H, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    lib = build.library("chunked_prefill_attention")
    out = torch.empty((B, Sq, H, Dv), device=q.device,
                      dtype=q.dtype).permute(0, 2, 1, 3)
    n_split = planned_splits(q, k, v, q_offset=q_offset, causal=causal,
                             window=window)
    ptrs = [None, None, None]
    if n_split > 1:   # fp32 partial state of the splits, one allocation:
        rows = n_split * B * Sq * H            # acc [rows, Dv], then m, l
        part = torch.empty(rows * (Dv + 2), device=q.device,
                           dtype=torch.float32)
        ptrs = [part.data_ptr() + 4 * rows * x for x in (0, Dv, Dv + 1)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.chunked_prefill_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), *ptrs,
            *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], B, Sq, Sk, Hkv, H // Hkv, D,
            Dv, int(q_offset), int(causal), int(window), float(scale),
            float(softcap), n_split, int(q.dtype == torch.bfloat16), stream)
    build.check("chunked_prefill_attention", code)
    chunked_prefill_attention.launches += 1
    if n_split > 1:
        chunked_prefill_attention.combine_launches += 1
    return out


chunked_prefill_attention.launches = 0
chunked_prefill_attention.combine_launches = 0
