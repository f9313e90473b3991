"""Plain PyTorch version of the chunked-prefill attention kernel (port of
the reference ``chunked_prefill_attention/ref.py``), in the reference's
order of operations: fp32 scores, softcap, mask (``NEG_INF = -1e30``), full
softmax, ``p`` rounded to V's dtype, then the P.V product in fp32.

This is what the kernel wrapper runs for a tensor on the CPU, and what
``chip_smoke.py`` holds the CUDA kernel against on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def chunked_prefill_attention_ref(q, k, v, lengths, *, scale, q_offset=0,
                                  causal=True, window=0, softcap=0.0):
    """q [B, H, Sq, D]; k [B, Hkv, Sk, D]; v [B, Hkv, Sk, Dv]; lengths [B]
    (strided views are fine). Query t sits at position ``q_offset + t`` and
    sees keys ``k_pos < lengths[b]``, ``k_pos <= q_pos`` when ``causal``
    and ``q_pos - k_pos < window`` when ``window > 0``; query head h reads
    kv head ``h // (H // Hkv)``. Returns [B, H, Sq, Dv] in q's dtype."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)[:, None]
    k_pos = torch.arange(Sk, device=dev)[None, :]
    mask = k_pos[None] < lengths.to(dev).long().reshape(B, 1, 1)  # [B,1,Sk]
    if causal:
        mask = mask & (q_pos >= k_pos)[None]
    if window > 0:
        mask = mask & (q_pos - k_pos < window)[None]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.float(), v.float())
    return out.reshape(B, H, Sq, v.shape[-1]).to(q.dtype)
