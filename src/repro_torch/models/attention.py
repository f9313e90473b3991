"""Paged KV helpers (port of ``gather_pages`` and ``write_pages_fused`` of
the reference ``models/attention.py``)."""
from __future__ import annotations

import torch


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
