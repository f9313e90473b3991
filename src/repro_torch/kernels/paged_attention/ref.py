"""Plain PyTorch versions of the paged-attention decode kernels (port of
the reference ``paged_attention/ref.py``): over split K and V pools, and
over the fused pool, which is the split version on the fused pool's two
planes (so the two agree bit for bit on the same keys)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ref_common as rc


def _decode_masked_scores(q, k_pages, block_tables, lengths, *, scale,
                          window, softcap):
    k_seq = rc.gather_seq(k_pages, block_tables)
    s = rc.decode_scores(q, k_seq, scale=scale, softcap=softcap)
    return rc.decode_mask(s, lengths, window=window,
                          k_pos=torch.arange(k_seq.shape[2], device=q.device))


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        scale, window=0, softcap=0.0):
    """q [B, H, D]; k_pages, v_pages [Hkv, P, ps, D]; block_tables [B, n];
    lengths [B]. Returns [B, H, D] in q's dtype."""
    s = _decode_masked_scores(q, k_pages, block_tables, lengths, scale=scale,
                              window=window, softcap=softcap)
    v_seq = rc.gather_seq(v_pages, block_tables)
    return rc.decode_softmax_v(s, v_seq, q.dtype)


def paged_attention_fused_ref(q, kv_pages, block_tables, lengths, *,
                              scale, window=0, softcap=0.0):
    """q [B, H, D]; kv_pages [Hkv, P, 2, ps, D]; block_tables [B, n];
    lengths [B]. Returns [B, H, D] in q's dtype."""
    k_pages, v_pages = rc.split_fused(kv_pages)
    return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                               scale=scale, window=window, softcap=softcap)


def paged_attention_partial_ref(q, kv_pages, block_tables, lengths, *,
                                scale, window=0, softcap=0.0):
    """Partial-softmax version: ``(acc [B,H,D], m [B,H], l [B,H])`` in fp32.
    ``lengths`` may be shard-local (global length minus the shard's key
    offset): both masks depend only on ``length - k_pos``."""
    k_pages, v_pages = rc.split_fused(kv_pages)
    s = _decode_masked_scores(q, k_pages, block_tables, lengths, scale=scale,
                              window=window, softcap=softcap)
    v_seq = rc.gather_seq(v_pages, block_tables)
    return rc.decode_partials(s, v_seq)
