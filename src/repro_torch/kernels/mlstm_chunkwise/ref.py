"""Plain PyTorch versions of the mLSTM chunkwise kernel.

* ``mlstm_ref`` is the port of the reference ``mlstm_chunkwise/ref.py``:
  the stabilized quadratic (parallel) form over the whole sequence from a
  fresh state, q/k/v ``[B, H, S, D]``.
* ``mlstm_chunkwise_ref`` is what the CUDA kernel computes, in its order
  of operations: chunks walked in order from a carried state ``(C, n,
  m)``, which it reads and writes, in the kernel's own chunks
  (``chunk_length``: for bf16 its passes' ``CHUNK`` tokens, or
  ``SHORT_CHUNK`` up to ``SHORT_S`` tokens; for fp32 its scalar loop's
  ``LOOP_CHUNK``) unless the caller names a length. It is the core of the
  reference ``mlstm_mix`` (``models/ssm.py``) from q, k/sqrt(D), v and the
  log gates to h before the group norm: the row stabilizer is
  ``max(F_t + m0, max_s(F_t - F_s + log_i_s))``, the score ``s`` stays fp32
  in ``s.v``, the denominator is ``max(|n.q|, exp(-min(m, 30)))`` then
  ``max(., 1e-30)``, and masked logits are ``NEG_INF = -1e30``. With a
  zero ``C``, zero ``n`` and ``m = NEG_INF`` it is the TPU kernel's
  function.

This is what the kernel wrapper runs for a tensor on the CPU, and what
``chip_smoke.py`` holds the CUDA kernel against on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30
CHUNK = 128         # tokens per chunk of csrc/mlstm_chunkwise.cu's bf16 passes
SHORT_CHUNK = 64    # and of those passes over at most SHORT_S tokens
SHORT_S = 512
LOOP_CHUNK = 64     # and of its fp32 loop (128 would not fit its shared memory)


def chunk_length(dtype, S: int) -> int:
    """The chunk length the CUDA kernel walks over S tokens of ``dtype`` (a
    decode step, S = 1, is one chunk at any length)."""
    if dtype != torch.bfloat16:
        return LOOP_CHUNK
    return SHORT_CHUNK if S <= SHORT_S else CHUNK


def mlstm_ref(q, k, v, log_i, log_f):
    """q/k/v: [B, H, S, D]; log_i/log_f: [B, H, S]. Returns [B, H, S, D]
    in q's dtype."""
    S = q.shape[2]
    F = torch.cumsum(log_f.float(), dim=-1)                     # [B,H,S]
    e = F[..., :, None] - F[..., None, :] + log_i.float()[..., None, :]
    tri = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    e = torch.where(tri, e, torch.full_like(e, NEG_INF))
    m = e.max(dim=-1).values                                    # [B,H,S]
    d = torch.exp(e - m[..., None])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d
    nrm = torch.maximum(s.sum(dim=-1).abs(),
                        torch.exp(-torch.clamp(m, max=30.0)))
    out = torch.einsum("bhqk,bhkd->bhqd", s, v.float())
    return (out / torch.clamp(nrm, min=1e-30)[..., None]).to(q.dtype)


def mlstm_chunkwise_ref(q, k, v, log_i, log_f, C, n, m, *, rows=None,
                        chunk=None):
    """The mLSTM of a chunk of S >= 1 tokens from a carried state.

    q, k, v: [B, S, H, D] (k already divided by sqrt(D)); log_i, log_f:
    [B, S, H] fp32 (input-gate logits and log-sigmoid forget gates).
    C [Bs, H, D, D], n [Bs, H, D], m [Bs, H]: fp32 state; batch entry b
    starts from state row ``rows[b]`` (``b`` when ``rows`` is None).
    ``C`` is updated **in place** at those rows. Chunks of ``chunk``
    tokens (``chunk_length(q.dtype, S)`` when None). Returns (h [B, S, H, D]
    in q's dtype, n_new [B, H, D], m_new [B, H])."""
    B, S, H, D = q.shape
    chunk = chunk_length(q.dtype, S) if chunk is None else chunk
    idx = torch.arange(B, device=q.device) if rows is None else rows.long()
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    li = log_i.float().permute(0, 2, 1)                          # [B,H,S]
    lf = log_f.float().permute(0, 2, 1)
    Cs, ns, ms = C[idx].float(), n[idx].float(), m[idx].float()
    h = torch.empty((B, H, S, D), dtype=torch.float32, device=q.device)
    for t0 in range(0, S, chunk):
        L = min(chunk, S - t0)
        qc, kc, vc = (t[:, :, t0:t0 + L] for t in (qf, kf, vf))
        lic = li[..., t0:t0 + L]
        b = torch.cumsum(lf[..., t0:t0 + L], dim=-1)             # [B,H,L]
        e = b[..., :, None] - b[..., None, :] + lic[..., None, :]
        tri = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                    device=q.device))
        e = torch.where(tri, e, torch.full_like(e, NEG_INF))
        inter = b + ms[..., None]                                # [B,H,L]
        m_row = torch.maximum(inter, e.max(dim=-1).values)
        g = torch.exp(inter - m_row)
        s = (qc @ kc.transpose(-1, -2)) * torch.exp(e - m_row[..., None])
        nrm = g * (qc @ ns[..., None])[..., 0] + s.sum(dim=-1)
        acc = g[..., None] * (qc @ Cs) + s @ vc
        denom = torch.maximum(nrm.abs(),
                              torch.exp(-torch.clamp(m_row, max=30.0)))
        h[:, :, t0:t0 + L] = acc / torch.clamp(denom, min=1e-30)[..., None]
        # carry: the chunk's last row stabilizer is the new m
        m_new = m_row[..., -1].contiguous()
        w = torch.exp(b[..., -1:] - b + lic - m_new[..., None])   # [B,H,L]
        decay = torch.exp(b[..., -1] + ms - m_new)                # [B,H]
        kw = kc * w[..., None]
        Cs = decay[..., None, None] * Cs + kw.transpose(-1, -2) @ vc
        ns = decay[..., None] * ns + kw.sum(dim=-2)
        ms = m_new
    C.index_copy_(0, idx, Cs)
    return h.permute(0, 2, 1, 3).to(q.dtype), ns, ms
