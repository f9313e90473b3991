"""Wrappers of the CUDA paged-prefill kernels
(``csrc/paged_prefill_attention.cu``), the ports of the TPU kernels
``paged_prefill_attention_fused`` (the fused pool; it serves the engine's
ragged prefill rows and its speculative-verify rows) and
``paged_prefill_attention`` (split K and V pools, no partial mode).

A tensor on the CPU goes to the plain PyTorch version (``ref.py``); a CUDA
tensor goes to the kernel, or the wrapper raises. Launches are counted in
``<wrapper>.launches``. In bf16 both pool layouts run one kernel on the
tensor cores (wgmma fed by TMA, ``csrc/attend_wgmma.cuh``; the split pools
give the fused pool's bits on the same keys) and take head_dim 64, 128 or
256, at most a block's rows of query heads per kv head
(``build.check_mma_geometry`` asks the library) and a page size that is a
multiple of 8 dividing the key tile; fp32 keeps the scalar loop.

bf16 splits the keys when the grid of rows x kv heads x q tiles is short
of the card: ``split_plan`` chooses the number of splits from shapes alone
(never ``lengths`` or ``row_pos``, which stay on the card), each block cuts
its q tile's page range on the device, and the last block of each (row,
kv head, q tile) merges the splits in the same launch, through fp32 scratch
that the wrapper allocates and the per-device tickets of the decode kernel
(``paged_attention.kernel``), which the kernel leaves zero. A call stays
one launch, and ``partial=True`` returns the merged state.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost as C
from repro_torch.kernels.paged_attention.kernel import (check_operands,
                                                        tickets_for)
from repro_torch.kernels.paged_prefill_attention.ref import (
    paged_prefill_attention_fused_ref, paged_prefill_attention_partial_ref,
    paged_prefill_attention_ref)

KERNEL = "paged_prefill_attention"

# The split plan, from shapes alone: a block of the tensor-core kernel fills
# an SM alone, so a grid of `blocks` blocks runs in ceil(blocks / sms)
# waves, each as long as its blocks' key walks, and a q tile walks at most
# the table's n * ps keys. split_plan takes the count of splits whose
# modelled time is least: waves x (key tiles a split + a split's own cost,
# SPLIT_OVERHEAD_TILES: its Q tile, its ring's first tiles, its partial
# state and the merge), in key tiles' worth of a block's time. A table of
# fewer than SPLIT_FROM_TILES key tiles is never split (the split blocks'
# fixed costs outweigh a short walk), a split covers MIN_SPLIT_PAGES table
# columns or more, and the merge keeps a weight a split and query row in
# shared memory, so at most MAX_SPLITS.
SPLIT_OVERHEAD_TILES = 2
SPLIT_FROM_TILES = 12
MIN_SPLIT_PAGES = 8
MAX_SPLITS = 64


def split_plan(R, Hkv, q_tiles, n, ps, key_tile, sms) -> int:
    """Key splits of a bf16 launch over R rows, Hkv kv heads and q_tiles q
    tiles a row, through block tables n columns of ps keys wide, with key
    tiles of key_tile keys, on a card of ``sms`` SMs: 1 when the grid
    already gives every SM a block or the table holds fewer than
    SPLIT_FROM_TILES key tiles, else the count from 1 to n //
    MIN_SPLIT_PAGES (and MAX_SPLITS) that the wave model above gives the
    least time (the fewest on a tie). Shapes only: a q tile whose pages are
    fewer than the splits leaves some of them empty, and they cost a block
    that exits early."""
    blocks = R * Hkv * q_tiles
    tiles = -(-n * ps // key_tile)
    if blocks <= 0 or blocks >= sms or tiles < SPLIT_FROM_TILES:
        return 1

    def model(k):
        return -(-blocks * k // sms) * (tiles / k + SPLIT_OVERHEAD_TILES)
    return min(range(1, max(1, min(n // MIN_SPLIT_PAGES, MAX_SPLITS)) + 1),
               key=lambda k: (model(k), k))


def q_tiles(Sq, G, D) -> int:
    """q tiles a row of a bf16 launch: the block's rows (the library's) //
    G tokens each."""
    return -(-Sq // (build.mma_attributes(KERNEL, D)["rows"] // G))


@functools.lru_cache(maxsize=None)
def _planned(device, R, Sq, Hkv, G, D, n, ps) -> int:
    return split_plan(R, Hkv, q_tiles(Sq, G, D), n, ps,
                      build.mma_attributes(KERNEL, D)["key_tile"],
                      build.sm_count(device))


def planned_splits(q, block_tables, page_size) -> int:
    """The key splits the wrappers launch for q [R, Sq, Hkv, G, D] through
    ``block_tables`` [R, n] over pages of ``page_size`` keys on q's card: 1
    for fp32 (cached per shape)."""
    if q.dtype != torch.bfloat16:
        return 1
    R, Sq, Hkv, G, D = q.shape
    return _planned(q.device, R, Sq, Hkv, G, D, block_tables.shape[1],
                    page_size)


@functools.lru_cache(maxsize=None)
def _check_bf16(G, D, ps) -> None:
    """Raise ValueError for a bf16 launch the tensor-core kernel does not
    take: the head dim, G, or a page size that is not a multiple of 8
    dividing the key tile (a page is one TMA box of the tile)."""
    build.check_mma_geometry(KERNEL, G, D)
    kt = build.mma_attributes(KERNEL, D)["key_tile"]
    if ps % 8 or kt % ps:
        raise ValueError(f"{KERNEL}: bf16 takes a page size that is a "
                         f"multiple of 8 dividing {kt} at head_dim {D}, got "
                         f"{ps}")


def _split_scratch(q, block_tables, page_size):
    """(n_split, scratch pointer, tickets pointer) of a launch: with more
    than one split, the fp32 partial state of every split (acc [S, rows,
    D], then m and l [S, rows], rows = R*Sq*Hkv*G; one allocation) and the
    device's tickets, one for each (row, kv head, q tile)."""
    n_split = planned_splits(q, block_tables, page_size)
    if n_split == 1:
        return 1, None, None
    R, Sq, Hkv, G, D = q.shape
    rows = R * Sq * Hkv * G
    part = torch.empty(n_split * rows * (D + 2), device=q.device,
                       dtype=torch.float32)
    # freeing `part` on return is safe: the caching allocator hands its
    # block only to work queued later on this stream
    tickets = tickets_for(q.device, R * Hkv * q_tiles(Sq, G, D))
    return n_split, part.data_ptr(), tickets.data_ptr()


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
        _check_bf16(G, D, ps)
    out = torch.empty(q.shape, device=q.device,
                      dtype=torch.float32 if partial else q.dtype)
    m = l = None
    if partial:
        m = torch.empty((R, Sq, Hkv, G), device=q.device, dtype=torch.float32)
        l = torch.empty((R, Sq, Hkv, G), device=q.device, dtype=torch.float32)
    lib = build.library(KERNEL)
    with torch.cuda.device(q.device):
        n_split, part, tickets = _split_scratch(q, block_tables, ps)
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.paged_prefill_attention_fused_launch(
            q.data_ptr(), kv_pages.data_ptr(), block_tables.data_ptr(),
            row_pos.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            m.data_ptr() if partial else None,
            l.data_ptr() if partial else None, part, tickets,
            R, Sq, Hkv, G, D, P, ps, n, float(scale), int(window),
            float(softcap), int(partial), n_split,
            int(q.dtype == torch.bfloat16), stream)
    build.check(KERNEL, code)
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
        _check_bf16(G, D, ps)
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    lib = build.library(KERNEL)
    with torch.cuda.device(q.device):
        n_split, part, tickets = _split_scratch(q, block_tables, ps)
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.paged_prefill_attention_split_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), row_pos.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part, tickets, R, Sq, Hkv, G, D, P, ps, n,
            float(scale), int(window), float(softcap), n_split,
            int(q.dtype == torch.bfloat16), stream)
    build.check(KERNEL, code)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
