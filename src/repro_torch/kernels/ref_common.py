"""Plain PyTorch versions of the two paged-attention kernels.

Port of the reference ``kernels/ref_common.py``: gather each row's pages
through the block table, then dense masked softmax, in the reference's order
of operations (scale, softcap, mask; softmax first in the full versions, the
division last in the partials; ``NEG_INF = -1e30``; ``max(l, 1e-30)``).
Products take bf16 operands to fp32 before the contraction, which is what
``preferred_element_type=float32`` does in the reference.

These functions are what the kernel wrappers run for a tensor on the CPU,
and what ``chip_smoke.py`` holds the CUDA kernels against on the card.

Layout: the fused head-interleaved pool ``[Hkv, P, 2, ps, D]``, K at
interleave index 0 and V at 1.

Partials: ``(acc, m, l)`` with ``acc = sum(exp(s - m) @ v)``, ``m`` the row
max and ``l = sum(exp(s - m))``; ``finalize_partials`` divides,
``combine_partials`` merges partials of disjoint key ranges.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30

K_IDX, V_IDX = 0, 1   # interleave positions inside a fused page


def split_fused(kv_pages: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Views of the K and V planes of a fused pool [Hkv, P, 2, ps, D]."""
    return kv_pages[:, :, K_IDX], kv_pages[:, :, V_IDX]


# ---------------------------------------------------------------------------
# gathers
# ---------------------------------------------------------------------------
def gather_seq(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """[Hkv, P, ps, D] + [B, n] -> each row's logical view [B, Hkv, n*ps, D]."""
    g = pages[:, block_tables.long()]           # [Hkv, B, n, ps, D]
    Hkv, B, n, ps, D = g.shape
    return g.permute(1, 0, 2, 3, 4).reshape(B, Hkv, n * ps, D)


def gather_rows(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """[Hkv, P, ps, D] + [R, n] -> [R, n*ps, Hkv, D]."""
    g = pages[:, block_tables.long()]           # [Hkv, R, n, ps, D]
    Hkv, R, n, ps, D = g.shape
    return g.permute(1, 2, 3, 0, 4).reshape(R, n * ps, Hkv, D)


# ---------------------------------------------------------------------------
# decode (one query token per sequence)
# ---------------------------------------------------------------------------
def decode_scores(q: torch.Tensor, k_seq: torch.Tensor, *, scale: float,
                  softcap: float) -> torch.Tensor:
    """[B, H, D] x [B, Hkv, Sk, D] -> scores [B, Hkv, G, Sk] (fp32)."""
    B, H, D = q.shape
    Hkv = k_seq.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_seq.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    return s


def decode_mask(s: torch.Tensor, lengths: torch.Tensor, *, window: int,
                k_pos: torch.Tensor) -> torch.Tensor:
    """Valid-length + sliding-window mask at key positions ``k_pos`` [Sk];
    masked entries become NEG_INF."""
    lengths = lengths.long()
    mask = k_pos[None, None, None, :] < lengths[:, None, None, None]
    if window > 0:
        mask &= k_pos[None, None, None, :] >= (lengths - window)[:, None, None, None]
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def decode_softmax_v(s: torch.Tensor, v_seq: torch.Tensor,
                     out_dtype) -> torch.Tensor:
    """Full (normalized) softmax @ V: [B, Hkv, G, Sk] -> [B, H, D]."""
    B, Hkv, G, _ = s.shape
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p.to(v_seq.dtype).float(),
                       v_seq.float())
    return out.reshape(B, Hkv * G, v_seq.shape[-1]).to(out_dtype)


def decode_partials(s: torch.Tensor, v_seq: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Un-normalized flash state: acc [B, H, D], m [B, H], l [B, H] (fp32)."""
    B, Hkv, G, _ = s.shape
    m = torch.amax(s, dim=-1)                               # [B, Hkv, G]
    e = torch.exp(s - m[..., None])
    l = torch.sum(e, dim=-1)
    acc = torch.einsum("bhgk,bhkd->bhgd", e.to(v_seq.dtype).float(),
                       v_seq.float())
    D = v_seq.shape[-1]
    return (acc.reshape(B, Hkv * G, D), m.reshape(B, Hkv * G),
            l.reshape(B, Hkv * G))


def finalize_partials(acc: torch.Tensor, l: torch.Tensor,
                      out_dtype) -> torch.Tensor:
    """The kernels' finalize step: acc / max(l, 1e-30)."""
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(out_dtype)


def combine_partials(parts, out_dtype):
    """Merge flash partials from disjoint key ranges: ``parts`` is a
    sequence of (acc, m, l) triples."""
    m_glob = parts[0][1]
    for _, m, _ in parts[1:]:
        m_glob = torch.maximum(m_glob, m)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for a, m, s in parts:
        c = torch.exp(m - m_glob)
        acc = acc + a * c[..., None]
        l = l + s * c
    return finalize_partials(acc, l, out_dtype)


# ---------------------------------------------------------------------------
# ragged chunked prefill (rows of Sq queries at per-row cache offsets)
# ---------------------------------------------------------------------------
def prefill_scores(q: torch.Tensor, k_all: torch.Tensor, *, scale: float,
                   softcap: float) -> torch.Tensor:
    """[R, Sq, Hkv, G, D] x [R, Sk, Hkv, D] -> scores [R, Hkv, G, Sq, Sk]."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k_all.float()) * scale
    if softcap and softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    return s


def prefill_mask(s: torch.Tensor, row_pos: torch.Tensor, lengths: torch.Tensor,
                 *, window: int, k_pos: torch.Tensor, Sq: int) -> torch.Tensor:
    """Causal-at-offset + sliding-window + valid-length mask at key
    positions ``k_pos`` [Sk]."""
    q_pos = row_pos.long().reshape(-1, 1) + torch.arange(Sq, device=s.device)[None, :]
    mask = k_pos[None, None, :] <= q_pos[:, :, None]          # [R, Sq, Sk]
    if window and window > 0:
        mask = mask & (q_pos[:, :, None] - k_pos[None, None, :] < window)
    mask = mask & (k_pos[None, None, :] < lengths.long().reshape(-1, 1, 1))
    mask = mask[:, None, None]                                # [R,1,1,Sq,Sk]
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def prefill_softmax_v(s: torch.Tensor, v_all: torch.Tensor) -> torch.Tensor:
    """Full softmax @ V: -> [R, Sq, Hkv, G, D] in V's dtype."""
    p = torch.softmax(s, dim=-1).to(v_all.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.float(),
                        v_all.float()).to(v_all.dtype)


def prefill_partials(s: torch.Tensor, v_all: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Un-normalized flash state for the prefill shape: acc
    [R, Sq, Hkv, G, D], m/l [R, Sq, Hkv, G] (fp32, query-major)."""
    m = torch.amax(s, dim=-1)                                 # [R, Hkv, G, Sq]
    e = torch.exp(s - m[..., None])
    l = torch.sum(e, dim=-1)
    acc = torch.einsum("bhgqk,bkhd->bqhgd", e.to(v_all.dtype).float(),
                       v_all.float())
    return acc, m.permute(0, 3, 1, 2), l.permute(0, 3, 1, 2)
