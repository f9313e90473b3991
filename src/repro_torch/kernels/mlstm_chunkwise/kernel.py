"""Wrapper of the CUDA mLSTM chunkwise kernels (``csrc/mlstm_chunkwise.cu``),
the port of the TPU kernel ``mlstm_chunkwise`` of the reference package,
with the carried state in and out. It is the recurrence core of every
``mlstm_mix`` call (``models/ssm.py``): the slot engine's prompt chunks and
its decode steps.

A tensor on the CPU goes to the plain PyTorch version (``ref.py``); a CUDA
tensor goes to the kernels, or the wrapper raises. q, k and v are read in
place through their strides (unit last stride). ``C`` is updated in place
at the state rows; the new ``n`` and ``m`` come back in fresh tensors,
because every tile of a head reads the old ones. The C launcher picks the
path: a decode step (S = 1) is one streaming kernel in either dtype; an
fp32 chunk runs the scalar chunk loop (chunks of ``LOOP_CHUNK`` = 64
tokens); a bf16 chunk runs three passes on the tensor cores (``wgmma``
fed by TMA through ``mbarrier`` rings) in chunks of ``CHUNK`` = 128
tokens (``SHORT_CHUNK`` = 64 up to ``SHORT_S`` = 512 tokens;
``ref.chunk_length``): the gate pass (per chunk, in parallel: the raw
scores Q K^T and the per-token gates), the state pass (per 64 x 128 tile
of C, the chunks in order: each chunk's starting C stored to scratch as
bf16 hi/lo planes by TMA, then C <- decay * C + (k w)^T V, the next
chunks' k*w formed by a warpgroup of their own) and the output pass (per
chunk and 128 columns of h, in parallel, from the gates, the raw scores
and the chunk-start states). Their scratch, which this wrapper allocates at the
sizes ``mlstm_chunkwise_plan`` gives, is the chunk-start states (nc x 2 x
D x D bf16 and nc x D fp32 a (row, head): 37.7 MB at B1 S2048 D 384) and
the gate pass's per-token values and raw scores. q, k and v go through
tensor maps of their strides, which the library encodes at first use and
caches. Counters: ``launches`` (wrapper calls that launched),
``kernel_launches`` (CUDA kernels they launched) and ``decode_launches``
(calls with S = 1).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cost import Work, dtype_name, is_fake, record
from repro_torch.kernels.mlstm_chunkwise.ref import (chunk_length,
                                                     mlstm_chunkwise_ref)

DTYPES = (torch.bfloat16, torch.float32)
MAX_D = 1024


def _check(q, k, v, log_i, log_f, C, n, m, rows) -> None:
    B, S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must share a shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype in {DTYPES}, got "
                        f"{q.dtype}, {k.dtype} and {v.dtype}")
    if S < 1:
        raise ValueError("the chunk must hold at least one token")
    if D % 32 or D > MAX_D:
        raise ValueError(f"head_dim {D} must be a multiple of 32 up to "
                         f"{MAX_D}")
    for name, t in (("log_i", log_i), ("log_f", log_f)):
        if t.shape != (B, S, H) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 [{B}, {S}, {H}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    Bs = C.shape[0]
    if C.shape != (Bs, H, D, D) or n.shape != (Bs, H, D) \
            or m.shape != (Bs, H):
        raise ValueError(f"state must be C [Bs, {H}, {D}, {D}], n [Bs, {H}, "
                         f"{D}], m [Bs, {H}]; got {tuple(C.shape)}, "
                         f"{tuple(n.shape)}, {tuple(m.shape)}")
    if any(t.dtype != torch.float32 for t in (C, n, m)):
        raise TypeError("the state (C, n, m) must be fp32")
    if C.stride()[1:] != (D * D, D, 1) or n.stride()[1:] != (D, 1) \
            or m.stride(1) != 1:
        raise ValueError("each state row of C, n and m must be contiguous")
    if rows is None:
        if Bs != B:
            raise ValueError(f"{Bs} state rows for {B} batch rows")
    elif rows.shape != (B,) or rows.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"rows must be an integer [{B}] tensor")
    for name, t in (("q", q), ("k", k), ("v", v), ("log_i", log_i),
                    ("log_f", log_f), ("C", C), ("n", n), ("m", m),
                    ("rows", rows)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if name in ("q", "k", "v") and t.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous last axis")
    if C.data_ptr() % 16 or C.stride(0) % 4:
        raise ValueError("C must be 16-byte aligned at every state row")
    if q.dtype == torch.bfloat16 and S > 1:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(x % 8 for x in t.stride()[:3]):
                raise ValueError(f"bf16 chunks read {name} through a tensor "
                                 f"map: it must be 16-byte aligned with "
                                 f"strides of multiples of 8 elements")


@functools.lru_cache(maxsize=None)
def plan(S: int, D: int, bf16: bool):
    """(kernels a call launches, scratch per (batch row, head): gate
    floats, bf16 elements of the chunk-start C planes, floats of the
    chunk-start n), as the C launcher reports them."""
    info = (ctypes.c_longlong * 4)()
    build.check("mlstm_chunkwise", build.library("mlstm_chunkwise")
                .mlstm_chunkwise_plan(S, D, int(bf16), info))
    return tuple(info)


PASSES = ("gate", "state", "output")


@functools.lru_cache(maxsize=None)
def pass_attributes(S: int, D: int):
    """{pass: registers, spill bytes, dynamic shared memory, resident
    blocks per SM, tokens a chunk ("rows") and columns a block ("key_tile":
    its products' N)} of the three bf16 passes over S tokens at head dim
    D, as the library and the CUDA runtime report them (needs a card)."""
    lib = build.library("mlstm_chunkwise")
    out = {}
    for i, name in enumerate(PASSES):
        info = (ctypes.c_int * len(build.MMA_ATTRIBUTES))()
        build.check("mlstm_chunkwise",
                    lib.mlstm_chunkwise_pass_attributes(S, D, i, info))
        out[name] = dict(zip(build.MMA_ATTRIBUTES, info))
    return out


def cost(B, S, H, D, dtype) -> Work:
    """#7's work (``kernels/cost.py``): q, k, v, the gates and h once,
    the batch's C rows read and written, n and m read and the new ones
    written; per (row, head) and chunk of L tokens (the kernel's chunks
    for ``dtype``), 4*L*D*(L + D) (q.k and s.v over the chunk, q.C and the
    k v^T update)."""
    elt = torch.empty((), dtype=dtype).element_size()
    chunk = chunk_length(dtype, S)
    flops = sum(4 * L * D * (L + D) for L in
                (min(chunk, S - t0) for t0 in range(0, S, chunk)))
    return Work(flops=B * H * flops,
                bytes=4 * B * S * H * D * elt + 2 * B * S * H * 4
                + 2 * B * H * (D * D + D + 1) * 4, dtype=dtype_name(dtype))


def mlstm_chunkwise(q, k, v, log_i, log_f, C, n, m, *, rows=None):
    """mLSTM over a chunk q/k/v [B, S, H, D] (k already divided by sqrt(D))
    with log gates [B, S, H] fp32, from the fp32 state C [Bs, H, D, D],
    n [Bs, H, D], m [Bs, H] at state rows ``rows`` [B] (``0..B-1`` when
    None; distinct). Updates ``C`` in place at those rows and returns
    (h [B, S, H, D] in q's dtype, n_new [B, H, D], m_new [B, H])."""
    if is_fake(q):
        B, S, H, D = q.shape
        record("mlstm_chunkwise", cost(B, S, H, D, q.dtype))
        f32 = dict(device=q.device, dtype=torch.float32)
        return (torch.empty((B, S, H, D), device=q.device, dtype=q.dtype),
                torch.empty((B, H, D), **f32), torch.empty((B, H), **f32))
    if q.device.type == "cpu":
        return mlstm_chunkwise_ref(q, k, v, log_i, log_f, C, n, m, rows=rows,
                                   chunk=chunk_length(q.dtype, q.shape[1]))
    if q.device.type != "cuda":
        raise ValueError(f"no mlstm_chunkwise kernel for {q.device}")
    _check(q, k, v, log_i, log_f, C, n, m, rows)
    B, S, H, D = q.shape
    lib = build.library("mlstm_chunkwise")
    bf16 = q.dtype == torch.bfloat16
    h = torch.empty((B, S, H, D), device=q.device, dtype=q.dtype)
    n_out = torch.empty((B, H, D), device=q.device, dtype=torch.float32)
    m_out = torch.empty((B, H), device=q.device, dtype=torch.float32)
    kernels, g_n, c_n, n_n = plan(S, D, bf16)
    rows32 = None if rows is None else rows.to(torch.int32).contiguous()
    scratch = [None, None, None]
    if c_n:
        scratch = [torch.empty(B * H * g_n, device=q.device,
                               dtype=torch.float32),
                   torch.empty(B * H * c_n, device=q.device,
                               dtype=torch.bfloat16),
                   torch.empty(B * H * n_n, device=q.device,
                               dtype=torch.float32)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mlstm_chunkwise_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
            log_f.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *log_i.stride(), *log_f.stride(),
            C.data_ptr(), n.data_ptr(), m.data_ptr(),
            None if rows32 is None else rows32.data_ptr(),
            C.stride(0), n.stride(0), m.stride(0), h.data_ptr(),
            n_out.data_ptr(), m_out.data_ptr(),
            *(None if t is None else t.data_ptr() for t in scratch),
            B, S, H, D, int(bf16), stream)
    build.check("mlstm_chunkwise", code)
    mlstm_chunkwise.launches += 1
    mlstm_chunkwise.kernel_launches += kernels
    mlstm_chunkwise.decode_launches += int(S == 1)
    return h, n_out, m_out


mlstm_chunkwise.launches = 0
mlstm_chunkwise.kernel_launches = 0
mlstm_chunkwise.decode_launches = 0
