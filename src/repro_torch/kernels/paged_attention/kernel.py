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

The library holds two blocks and the launcher picks one from the shapes:
bf16 at head_dim 64, 128 or 256 over pages of a multiple of 8 keys dividing
the key tile runs the tensor-core block (scores and P.V on ``wgmma`` with
the keys as the M rows, K/V tiles by TMA through an ``mbarrier`` ring;
``wgmma_attributes`` gives its geometry), everything else the scalar block
(``cp.async`` rings, fp32 FMAs). Both launch one kernel,
split-K over each row's live pages, so the split pools give the fused
pool's output bit for bit on the same keys. The split plan reads shapes
alone (never ``lengths``, which stay on the card): ``wgmma_split_plan`` by
waves of the tensor-core block's occupancy, ``split_plan`` for the scalar
block. Each block cuts its row's page range on the device, and the last
block of each (row, head group) merges the splits in the same launch,
through fp32 scratch that the wrapper allocates and a per-device buffer of
tickets that the kernel leaves zero (so calls on one stream share it). Any
number of query heads per kv head is taken, HEADS_PER_BLOCK a block.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost as C
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_fused_ref, paged_attention_partial_ref,
    paged_attention_ref)

KERNEL = "paged_attention"
DTYPES = (torch.bfloat16, torch.float32)

# The query heads one block holds (kHeadsPerBlock, the N of the tensor-core
# block's products; more heads take more head groups of the grid), as in
# csrc/paged_attention.cu.
HEADS_PER_BLOCK = 8

# The scalar block's split plan: blocks an SM the grid aims at and the
# fewest table columns a split may cover (one page for each of the block's
# kWarps warps). It keeps this plan, tuned for its 8 cp.async warps, rather
# than wgmma_split_plan's waves: its fp32 code is unchanged, and a wave
# plan for it would need its occupancy from the card and a re-tune of the
# fp32 cases against these constants.
SPLIT_BLOCKS_PER_SM = 2
MIN_SPLIT_PAGES = 8

# The tensor-core block's split plan, from shapes alone: blocks_per_sm of
# them run on an SM at once, so a grid of `blocks` blocks runs in
# ceil(blocks / (sms * blocks_per_sm)) waves, each as long as its blocks'
# key walks, and a block walks at most the table's n * ps keys a row.
# wgmma_split_plan takes the count of splits whose modelled time is least:
# waves x (key tiles a split + a split's own cost, SPLIT_OVERHEAD_TILES: its
# ring's first tiles, its partial state and the merge), in key tiles' worth
# of a block's time. A split covers a key tile or more, and at most
# MAX_SPLITS: the last block of a (row, head group) reads every split's
# state behind the slowest one, eight at a time (on an H100, llama3.2-3b's
# B1 over 4093 keys took 0.0105 ms of device time in 16 splits against
# 0.0128 in 33).
SPLIT_OVERHEAD_TILES = 2
MAX_SPLITS = 16


def split_plan(B, Hkv, G, n, sms) -> int:
    """Key splits of a scalar-block launch over B rows, Hkv kv heads with G
    query heads each, through block tables n columns wide, on a card of
    ``sms`` SMs: 1 when the grid of B x Hkv x head groups blocks already
    gives every SM SPLIT_BLOCKS_PER_SM blocks, else enough splits for that,
    at most n // MIN_SPLIT_PAGES. Shapes only: a row shorter than the
    splits leaves some of them empty, and they cost a block that exits
    early."""
    blocks = B * Hkv * -(-G // HEADS_PER_BLOCK)
    want = SPLIT_BLOCKS_PER_SM * sms
    if blocks <= 0 or blocks >= want:
        return 1
    return max(1, min(-(-want // blocks), n // MIN_SPLIT_PAGES))


def wgmma_split_plan(B, Hkv, G, n, ps, key_tile, blocks_per_sm, sms) -> int:
    """Key splits of a tensor-core launch over B rows, Hkv kv heads with G
    query heads each, through block tables n columns of ps keys wide, with
    key tiles of key_tile keys and blocks_per_sm resident blocks on each of
    ``sms`` SMs: 1 when the grid fills every SM's blocks already, else the
    count from 1 to the table's key tiles (and MAX_SPLITS) that the wave
    model above gives the least time (the fewest on a tie)."""
    blocks = B * Hkv * -(-G // HEADS_PER_BLOCK)
    slots = sms * blocks_per_sm
    tiles = -(-n * ps // key_tile)
    if blocks <= 0 or blocks >= slots:
        return 1

    def model(k):
        return -(-blocks * k // slots) * (tiles / k + SPLIT_OVERHEAD_TILES)
    return min(range(1, max(1, min(tiles, MAX_SPLITS)) + 1),
               key=lambda k: (model(k), k))


@functools.lru_cache(maxsize=None)
def wgmma_attributes(dtype, D, ps):
    """``build.mma_attributes`` of the tensor-core block a launch in
    ``dtype`` at head_dim D over pages of ps keys runs (needs a card), or
    None where the launch takes the scalar block (fp32, a head dim the
    library has no tensor-core instantiation for, or pages that are not a
    multiple of 8 keys dividing the key tile, as the launcher's
    takes_wgmma)."""
    if dtype != torch.bfloat16 or ps % 8:
        return None
    try:
        attr = build.mma_attributes(KERNEL, D)
    except ValueError:
        return None
    return None if attr["key_tile"] % ps else attr


@functools.lru_cache(maxsize=None)
def _planned(device, dtype, B, Hkv, G, D, n, ps) -> int:
    sms = build.sm_count(device)
    attr = wgmma_attributes(dtype, D, ps)
    if attr is None:
        return split_plan(B, Hkv, G, n, sms)
    return wgmma_split_plan(B, Hkv, G, n, ps, attr["key_tile"],
                            attr["blocks_per_sm"], sms)


def planned_splits(q, block_tables, Hkv, page_size) -> int:
    """The key splits the wrappers launch for q [B, H, D] over Hkv kv heads
    through ``block_tables`` [B, n] over pages of ``page_size`` keys on q's
    card (cached per shape)."""
    B, H, D = q.shape
    return _planned(q.device, q.dtype, B, Hkv, H // Hkv, D,
                    block_tables.shape[1], page_size)


_tickets = {}


def tickets_for(device, count):
    """At least ``count`` zeroed int32 tickets on ``device``; one buffer a
    device, grown when a launch needs more, which the kernels that merge
    their splits in the launch (this decode kernel, the paged prefill
    kernel) leave zero."""
    t = _tickets.get(device)
    if t is None or t.numel() < count:
        size = max(count, 0 if t is None else 2 * t.numel())
        t = _tickets[device] = torch.zeros(size, dtype=torch.int32,
                                           device=device)
    return t


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


def _split_scratch(q, block_tables, Hkv, page_size):
    """(n_split, scratch pointer, tickets pointer) of a launch: with more
    than one split, the fp32 partial state of every split (acc [S, B*H, D],
    then m and l [S, B*H]; one allocation) and the device's tickets."""
    n_split = planned_splits(q, block_tables, Hkv, page_size)
    if n_split == 1:
        return 1, None, None
    B, H, D = q.shape
    part = torch.empty(n_split * B * H * (D + 2), device=q.device,
                       dtype=torch.float32)
    # freeing `part` on return is safe: the caching allocator hands its
    # block only to work queued later on this stream
    return n_split, part.data_ptr(), tickets_for(q.device, B * H).data_ptr()


def cost(B, H, Hkv, D, page_size, n, dtype, lengths=None,
         partial=False) -> C.Work:
    """#1/#3's work (``kernels/cost.py``): q and the output once (the
    fp32 state with ``partial``), each row's live pages once per KV head,
    the block table and lengths; Q.K^T and P.V over each row's keys (a
    whole table of ``n`` pages a row when ``lengths`` is None)."""
    lens = [n * page_size] * B if lengths is None else [int(x) for x in
                                                         lengths]
    elt = torch.empty((), dtype=dtype).element_size()
    pages = sum(-(-x // page_size) for x in lens if x > 0)
    out = B * H * (D * 4 + 8) if partial else B * H * D * elt
    return C.Work(flops=4 * D * H * sum(lens),
                  bytes=B * H * D * elt + out
                  + pages * page_size * Hkv * 2 * D * elt + B * n * 4 + B * 4,
                  dtype=C.dtype_name(dtype))


def _fake(q, Hkv, ps, block_tables, partial):
    """The outputs of a call on tensors that hold no data, its work
    counted (``kernels/cost.py``)."""
    B, H, D = q.shape
    C.record("paged_attention", cost(B, H, Hkv, D, ps,
                                     block_tables.shape[1], q.dtype,
                                     partial=partial))
    if not partial:
        return torch.empty((B, H, D), device=q.device, dtype=q.dtype)
    f32 = dict(device=q.device, dtype=torch.float32)
    return (torch.empty((B, H, D), **f32), torch.empty((B, H), **f32),
            torch.empty((B, H), **f32))


def paged_attention_fused(q, kv_pages, block_tables, lengths, *, scale,
                          window=0, softcap=0.0, partial=False):
    """Decode attention: q [B, H, D] over kv_pages [Hkv, P, 2, ps, D]
    through block_tables [B, n] int32 with lengths [B] int32 (counting the
    token just written). Returns [B, H, D] in q's dtype, or with
    ``partial=True`` the fp32 state ``(acc [B,H,D], m [B,H], l [B,H])``."""
    if C.is_fake(q):
        return _fake(q, kv_pages.shape[0], kv_pages.shape[3], block_tables,
                     partial)
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
    n_split, part, tickets = _split_scratch(q, block_tables, Hkv, ps)
    lib = build.library(KERNEL)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.paged_attention_fused_launch(
            q.data_ptr(), kv_pages.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            m.data_ptr() if partial else None,
            l.data_ptr() if partial else None, part, tickets,
            B, Hkv, G, D, P, ps, n, float(scale), int(window),
            float(softcap), int(partial), n_split,
            int(q.dtype == torch.bfloat16), stream)
    build.check(KERNEL, code)
    paged_attention_fused.launches += 1
    return (out, m, l) if partial else out


paged_attention_fused.launches = 0


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *, scale,
                    window=0, softcap=0.0):
    """Decode attention over split pools: q [B, H, D] over k_pages and
    v_pages [Hkv, P, ps, D] through block_tables [B, n] int32 with lengths
    [B] int32 (counting the token just written). Returns [B, H, D] in q's
    dtype."""
    if C.is_fake(q):
        return _fake(q, k_pages.shape[0], k_pages.shape[2], block_tables,
                     False)
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
    n_split, part, tickets = _split_scratch(q, block_tables, Hkv, ps)
    lib = build.library(KERNEL)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.paged_attention_split_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part, tickets, B, Hkv, G, D, P, ps, n, float(scale),
            int(window), float(softcap), n_split,
            int(q.dtype == torch.bfloat16), stream)
    build.check(KERNEL, code)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
