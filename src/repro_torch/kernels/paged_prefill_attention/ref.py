"""Plain PyTorch versions of the paged-prefill (ragged chunked prefill)
kernels (port of the reference ``paged_prefill_attention/ref.py``): over
split K and V pools, and over the fused pool, which is the split version on
the fused pool's two planes (so the two agree bit for bit on the same
keys)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ref_common as rc


def _prefill_masked_scores(q, k_pages, block_tables, row_pos, lengths, *,
                           scale, window, softcap):
    k_all = rc.gather_rows(k_pages, block_tables)   # [R, n*ps, Hkv, D]
    s = rc.prefill_scores(q, k_all, scale=scale, softcap=softcap)
    return rc.prefill_mask(s, row_pos, lengths, window=window,
                           k_pos=torch.arange(k_all.shape[1], device=q.device),
                           Sq=q.shape[1])


def paged_prefill_attention_ref(q, k_pages, v_pages, block_tables,
                                row_pos, lengths, *, scale, window=0,
                                softcap=0.0):
    """q [R, Sq, Hkv, G, D] chunk queries; k_pages, v_pages [Hkv, P, ps,
    D]; block_tables [R, n]; row_pos [R] cache offset of each row's chunk;
    lengths [R] post-chunk valid length. Returns [R, Sq, Hkv, G, D]. Query
    t of row r sees keys ``k <= row_pos[r] + t``, ``k < lengths[r]`` and
    the window; padding rows (lengths == 0) give values the caller
    discards."""
    s = _prefill_masked_scores(q, k_pages, block_tables, row_pos, lengths,
                               scale=scale, window=window, softcap=softcap)
    v_all = rc.gather_rows(v_pages, block_tables)
    return rc.prefill_softmax_v(s, v_all)


def paged_prefill_attention_fused_ref(q, kv_pages, block_tables, row_pos,
                                      lengths, *, scale, window=0,
                                      softcap=0.0):
    """As ``paged_prefill_attention_ref``, over the fused pool kv_pages
    [Hkv, P, 2, ps, D]."""
    k_pages, v_pages = rc.split_fused(kv_pages)
    return paged_prefill_attention_ref(q, k_pages, v_pages, block_tables,
                                       row_pos, lengths, scale=scale,
                                       window=window, softcap=softcap)


def paged_prefill_attention_partial_ref(q, kv_pages, block_tables, row_pos,
                                        lengths, *, scale, window=0,
                                        softcap=0.0):
    """Partial-softmax version: ``(acc [R,Sq,Hkv,G,D], m [R,Sq,Hkv,G],
    l [R,Sq,Hkv,G])`` in fp32. ``row_pos``/``lengths`` may be shard-local
    (and negative): every mask depends only on position differences."""
    k_pages, v_pages = rc.split_fused(kv_pages)
    s = _prefill_masked_scores(q, k_pages, block_tables, row_pos, lengths,
                               scale=scale, window=window, softcap=softcap)
    v_all = rc.gather_rows(v_pages, block_tables)
    return rc.prefill_partials(s, v_all)
