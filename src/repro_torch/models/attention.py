"""Attention of the reference ``models/attention.py``:
``blockwise_attention`` (through the chunked-prefill attention kernel), the
paged KV helpers (``gather_pages``, ``write_pages_fused``), the slot-cache
writes (``update_kv_cache``, ``update_kv_cache_ragged``),
``decode_attention`` and ``mla_decode_attention`` (plain PyTorch, as they
are plain jnp in the reference), and their flash partials over one block
of a sequence-sharded cache (``decode_attention_partials``,
``mla_decode_partials``). Writes go **in place** where the
reference returns a new buffer."""
from __future__ import annotations

import torch

from repro_torch.kernels import ref_common as rc
from repro_torch.kernels.chunked_prefill_attention.ops import (
    chunked_prefill_attention_op)


def blockwise_attention(
    q: torch.Tensor,  # [B, Sq, Hkv, G, Dh]
    k: torch.Tensor,  # [B, Sk, Hkv, Dh]
    v: torch.Tensor,  # [B, Sk, Hkv, Dv]
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_valid_len=None,  # [B] or scalar; None => all Sk keys
) -> torch.Tensor:
    """Attention of queries at positions ``q_offset + t`` over keys
    ``0 .. Sk-1``: causal or not, a sliding window, softcap, and keys at or
    past ``kv_valid_len`` masked. Computed by the chunked-prefill attention
    kernel on the GPU (its plain version for CPU tensors), on permuted
    views of q, k and v. The reference's ``block_q``, ``block_k`` and
    ``unroll`` are XLA tiling controls with nothing to do here. Returns
    [B, Sq, Hkv, G, Dv]."""
    B, Sq, Hkv, G, D = q.shape
    Sk, Dv = k.shape[1], v.shape[3]
    if torch.is_tensor(kv_valid_len):
        lengths = kv_valid_len.to(device=q.device, dtype=torch.int32)
        lengths = lengths.reshape(-1).expand(B).contiguous()
    else:   # filled on the device: no host-to-device copy, no sync
        lengths = torch.full((B,), Sk if kv_valid_len is None
                             else int(kv_valid_len), dtype=torch.int32,
                             device=q.device)
    o = chunked_prefill_attention_op(
        q.reshape(B, Sq, Hkv * G, D).permute(0, 2, 1, 3),
        k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), lengths, scale=scale,
        q_offset=int(q_offset), causal=causal, window=window,
        softcap=softcap)
    return o.permute(0, 2, 1, 3).reshape(B, Sq, Hkv, G, Dv)


def gather_pages(
    pages: torch.Tensor,         # [Hkv, P, ps, D] physical pages
    block_tables: torch.Tensor,  # [R, n] logical->physical page map
) -> torch.Tensor:
    """Materialize each row's logical KV view: returns [R, n*ps, Hkv, D].
    Positions past a row's valid length are masked by the caller (they may
    alias freed or trash pages)."""
    g = pages[:, block_tables.long()]               # [Hkv, R, n, ps, D]
    Hkv, R, n, ps, D = g.shape
    return g.permute(1, 2, 3, 0, 4).reshape(R, n * ps, Hkv, D)


def write_pages_fused(
    kv_pages: torch.Tensor,  # [Hkv, P, 2, ps, D] fused head-interleaved pool
    k_new: torch.Tensor,     # [R, L, Hkv, D] new keys (row-major tokens)
    v_new: torch.Tensor,     # [R, L, Hkv, D] new values
    slots: torch.Tensor,     # [R*L] flat destinations (page*ps + offset)
) -> torch.Tensor:
    """Scatter K and V into the fused pool with one indexed copy, **in
    place** (the reference donates the pool buffer to the jitted step
    instead). Token slot ``p*ps + o`` lands at flat index ``p*(2*ps) + o``
    for K and ``p*(2*ps) + ps + o`` for V. Padding tokens target the
    engine's trash page; that is the only place indices repeat, and which
    duplicate wins there does not matter because the page is never read.
    Returns ``kv_pages``."""
    Hkv, P, two, ps, D = kv_pages.shape
    flat = kv_pages.view(Hkv, P * two * ps, D)
    slots = slots.long()
    k_idx = (slots // ps) * (two * ps) + slots % ps
    idx = torch.cat([k_idx, k_idx + ps])
    upd = torch.cat([k_new.reshape(-1, Hkv, D),
                     v_new.reshape(-1, Hkv, D)]).transpose(0, 1)
    flat.index_copy_(1, idx, upd.to(flat.dtype))
    return kv_pages


def update_kv_cache(
    cache: torch.Tensor,  # [B, S, ...]
    new: torch.Tensor,    # [B, n, ...]
    pos: int,             # uniform write offset
) -> torch.Tensor:
    """Write ``new`` at positions ``pos .. pos+n-1`` of every row, in place.
    The start is clamped to ``[0, S - n]`` as ``jax.lax.dynamic_update_slice``
    clamps it: a bucket-padded chunk that would end past ``S`` lands at
    ``S - n`` instead, as in the reference. Returns ``cache``."""
    n, S = new.shape[1], cache.shape[1]
    start = min(max(int(pos), 0), S - n)
    cache[:, start:start + n] = new.to(cache.dtype)
    return cache


def update_kv_cache_ragged(
    cache: torch.Tensor,    # [B, S, ...]
    new: torch.Tensor,      # [B, n, ...]
    offsets: torch.Tensor,  # [B] per-row write offsets
    rows: torch.Tensor = None,  # row indices to write (all when None)
) -> torch.Tensor:
    """Per-row write at ``offsets[b]`` (clamped to ``[0, S - n]`` per row,
    as the reference's per-row ``dynamic_update_slice``), in place, for
    ``rows`` only: the slot engine's decode step runs every slot but keeps
    the writes of the rows that are really decoding. Returns ``cache``."""
    B, n, S = new.shape[0], new.shape[1], cache.shape[1]
    if rows is None:
        rows = torch.arange(B, device=cache.device)
    starts = offsets.to(cache.device).long().clamp(0, S - n)[rows]
    pos = starts[:, None] + torch.arange(n, device=cache.device)[None, :]
    cache[rows[:, None], pos] = new[rows].to(cache.dtype)
    return cache


def decode_attention(
    q: torch.Tensor,        # [B, Hkv, G, Dh]
    k_cache: torch.Tensor,  # [B, S, Hkv, Dh]
    v_cache: torch.Tensor,  # [B, S, Hkv, Dv]
    length,                 # int or [B]: number of valid cache entries
    *,
    scale: float,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """One-token attention read of the cache, in the reference's order:
    fp32 scores, scale, softcap, mask (``k_pos < length``, and
    ``k_pos >= length - window``), ``exp(s - max) / max(l, 1e-30)`` rounded
    to V's dtype, fp32 P.V. Returns [B, Hkv, G, Dv] in q's dtype."""
    B, Hkv, G, D = q.shape
    if not torch.is_tensor(length):
        length = torch.full((B,), int(length), device=q.device)
    s = rc.decode_scores(q.reshape(B, Hkv * G, D), k_cache.permute(0, 2, 1, 3),
                         scale=scale, softcap=softcap)     # [B, Hkv, G, S]
    s = rc.decode_mask(s, length.to(q.device).reshape(-1).expand(B),
                       window=window,
                       k_pos=torch.arange(k_cache.shape[1], device=q.device))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    p = (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype)
    out = torch.einsum("bhgs,bshd->bhgd", p.float(), v_cache.float())
    return out.to(q.dtype)


def mla_decode_attention(
    q_lat: torch.Tensor,   # [B, H, R]   q_nope absorbed through W_UK
    q_rope: torch.Tensor,  # [B, H, Dr]
    ckv: torch.Tensor,     # [B, S, R]   compressed KV latent cache
    k_rope: torch.Tensor,  # [B, S, Dr]  shared rope key cache
    length,                # int or [B]: number of valid cache entries
    *,
    scale: float,
) -> torch.Tensor:
    """Weight-absorbed MLA decode, in the reference's order: fp32 scores
    ``q_lat . ckv + q_rope . k_rope``, scale, mask ``k_pos < length``,
    ``exp(s - max) / max(l, 1e-30)`` rounded to ckv's dtype, fp32 P.ckv.
    Returns the latent output [B, H, R] in q_lat's dtype (the caller
    expands it through W_UV)."""
    B, S, _ = ckv.shape
    s = torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv.float())
    s = s + torch.einsum("bhd,bsd->bhs", q_rope.float(), k_rope.float())
    s = s * scale
    if torch.is_tensor(length) and length.dim():
        length = length.to(ckv.device).reshape(-1, 1, 1)
    k_pos = torch.arange(S, device=ckv.device)[None, None, :]
    s = torch.where(k_pos < length, s, torch.full_like(s, rc.NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhs,bsr->bhr", p.to(ckv.dtype).float(), ckv.float())
    return out.to(q_lat.dtype)


def decode_attention_partials(
    q: torch.Tensor,        # [B, Hkv, G, Dh]
    k_cache: torch.Tensor,  # [B, S_loc, Hkv, Dh]: one block of the sequence
    v_cache: torch.Tensor,  # [B, S_loc, Hkv, Dv]
    length: torch.Tensor,   # [B]: valid entries of the whole sequence
    offset: int,            # the block's first position
    *,
    scale: float,
    window: int = 0,
    softcap: float = 0.0,
):
    """:func:`decode_attention` over one block of a sequence-sharded
    cache, as un-normalized flash partials (``ref_common.decode_partials``:
    fp32 ``acc`` [B, H, Dv], the row maxima ``m`` and sums ``l`` [B, H])
    that ``shard_utils.combine_partials`` merges over the blocks. A block
    whose keys all lie past a row's length holds ``m = -1e30`` there."""
    B, Hkv, G, D = q.shape
    s = rc.decode_scores(q.reshape(B, Hkv * G, D), k_cache.permute(0, 2, 1, 3),
                         scale=scale, softcap=softcap)
    s = rc.decode_mask(s, length.reshape(-1).expand(B), window=window,
                       k_pos=offset + torch.arange(k_cache.shape[1],
                                                   device=q.device))
    return rc.decode_partials(s, v_cache.permute(0, 2, 1, 3))


def mla_decode_partials(q_lat, q_rope, ckv, k_rope, length: torch.Tensor,
                        offset: int, *, scale: float):
    """:func:`mla_decode_attention` over one block of the sequence-sharded
    latents (ckv [B, S_loc, R], k_rope [B, S_loc, Dr], positions from
    ``offset``), as flash partials: fp32 ``acc`` [B, H, R], ``m`` and
    ``l`` [B, H]."""
    S = ckv.shape[1]
    s = torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv.float())
    s = s + torch.einsum("bhd,bsd->bhs", q_rope.float(), k_rope.float())
    s = s * scale
    k_pos = offset + torch.arange(S, device=ckv.device)[None, None, :]
    s = torch.where(k_pos < length.to(ckv.device).reshape(-1, 1, 1), s,
                    torch.full_like(s, rc.NEG_INF))
    m = torch.amax(s, dim=-1)
    e = torch.exp(s - m[..., None])
    l = torch.sum(e, dim=-1)
    acc = torch.einsum("bhs,bsr->bhr", e.to(ckv.dtype).float(), ckv.float())
    return acc, m, l
