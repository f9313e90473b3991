"""Wrapper of the CUDA Mamba-1 selective-scan kernel (``csrc/mamba_scan.cu``),
the port of the TPU kernel ``mamba_scan`` of the reference package, with
the carried state in and out. It is the recurrence core of every
``mamba_mix`` call (``models/ssm.py``): the slot engine's prompt chunks and
its decode steps.

A tensor on the CPU goes to the plain PyTorch version (``ref.py``); a CUDA
tensor goes to the kernel, or the wrapper raises. x, dt, Bc and Cc are
read in place through their strides (unit last stride: Bc and Cc may be
column slices of the x_proj output). The state ``h`` is updated in place at
the state rows. The kernel is picked by S: S = 1 (the engine's decode
steps) launches the streaming decode kernel, S >= 2 (prompt chunks) the
chunk kernel. Launches are counted in ``mamba_scan.launches``, the decode
ones also in ``mamba_scan.decode_launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost as C
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

DTYPES = (torch.bfloat16, torch.float32)
MAX_N = 16          # states per channel the kernel keeps in registers


def _check(x, dt, Bc, Cc, A, D, h, rows) -> None:
    B, S, d = x.shape
    n = A.shape[-1]
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be one of {DTYPES}, got {x.dtype}")
    if S < 1:
        raise ValueError("the chunk must hold at least one token")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"d_state {n} must be in 1..{MAX_N}")
    for name, t, shape in (("dt", dt, (B, S, d)), ("Bc", Bc, (B, S, n)),
                           ("Cc", Cc, (B, S, n)), ("A", A, (d, n)),
                           ("D", D, (d,))):
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 {list(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError("A and D must be contiguous")
    Bs = h.shape[0]
    if h.shape != (Bs, d, n) or h.dtype != torch.float32:
        raise ValueError(f"h must be fp32 [Bs, {d}, {n}], got {h.dtype} "
                         f"{tuple(h.shape)}")
    if h.stride()[1:] != (n, 1):
        raise ValueError("each state row of h must be contiguous")
    if rows is None:
        if Bs != B:
            raise ValueError(f"{Bs} state rows for {B} batch rows")
    elif rows.shape != (B,) or rows.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"rows must be an integer [{B}] tensor")
    for name, t in (("x", x), ("dt", dt), ("Bc", Bc), ("Cc", Cc), ("A", A),
                    ("D", D), ("h", h), ("rows", rows)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if name in ("x", "dt", "Bc", "Cc") and t.stride(2) != 1:
            raise ValueError(f"{name} needs a contiguous last axis")


def cost(B, S, d, n, dtype) -> C.Work:
    """#6's work (``kernels/cost.py``): x, dt, Bc, Cc and y once, A and D,
    the batch's h rows read and written; per (token, channel) 7 operations
    a state (dt*A, exp, da*h, dtx*B, the add, h*C as multiply-add) and 3
    (dt*x, D*x and its add), in fp32 whatever x's dtype."""
    elt = torch.empty((), dtype=dtype).element_size()
    return C.Work(flops=B * S * d * (7 * n + 3),
                  bytes=B * S * d * (2 * elt + 4) + 2 * B * S * n * 4
                  + d * (n + 1) * 4 + 2 * B * d * n * 4, dtype="float32")


def mamba_scan(x, dt, Bc, Cc, A, D, h, *, rows=None):
    """Selective scan over a chunk: x [B, S, d], dt (softplus'd), Bc, Cc
    fp32, A = -exp(A_log) [d, n], D [d], from the fp32 state h [Bs, d, n]
    at state rows ``rows`` [B] (``0..B-1`` when None; distinct). Updates
    ``h`` in place at those rows and returns y [B, S, d] in x's dtype."""
    if C.is_fake(x):
        B, S, d = x.shape
        C.record("mamba_scan", cost(B, S, d, A.shape[1], x.dtype))
        return torch.empty((B, S, d), device=x.device, dtype=x.dtype)
    if x.device.type == "cpu":
        return mamba_scan_ref(x, dt, Bc, Cc, A, D, h, rows=rows)
    if x.device.type != "cuda":
        raise ValueError(f"no mamba_scan kernel for {x.device}")
    _check(x, dt, Bc, Cc, A, D, h, rows)
    B, S, d = x.shape
    lib = build.library("mamba_scan")
    y = torch.empty((B, S, d), device=x.device, dtype=x.dtype)
    rows32 = None if rows is None else rows.to(torch.int32).contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mamba_scan_launch(
            x.data_ptr(), *x.stride()[:2], dt.data_ptr(), *dt.stride()[:2],
            Bc.data_ptr(), *Bc.stride()[:2], Cc.data_ptr(), *Cc.stride()[:2],
            A.data_ptr(), D.data_ptr(), h.data_ptr(), h.stride(0),
            None if rows32 is None else rows32.data_ptr(), y.data_ptr(),
            B, S, d, A.shape[1], int(x.dtype == torch.bfloat16), stream)
    build.check("mamba_scan", code)
    mamba_scan.launches += 1
    mamba_scan.decode_launches += int(S == 1)
    return y


mamba_scan.launches = 0
mamba_scan.decode_launches = 0

ATTRIBUTES = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm",
              "threads", "lanes", "stages", "poly_of_8")
KERNELS = ("chunk bf16", "chunk fp32", "decode bf16", "decode fp32")


def attributes():
    """Registers, spill bytes, dynamic shared memory, resident blocks per
    SM, threads a block, lanes a channel, ring stages and states of every 8
    whose exponential is the polynomial, of each kernel of the library
    (``KERNELS``), as the library and the CUDA runtime report them (needs a
    card)."""
    lib = build.library("mamba_scan")
    out = {}
    for which, name in enumerate(KERNELS):
        info = (ctypes.c_int * len(ATTRIBUTES))()
        build.check("mamba_scan", lib.mamba_scan_attributes(which, info))
        out[name] = dict(zip(ATTRIBUTES, info))
    return out
