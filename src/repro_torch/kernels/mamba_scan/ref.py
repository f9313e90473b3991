"""Plain PyTorch version of the Mamba-1 selective-scan kernel.

Port of the reference ``mamba_scan/ref.py`` with the carried state: a loop
over time in the reference's order, ``da = exp(dt * A)``, ``h = da * h +
(dt * x) * B``, ``y = h . C``, then ``y + D * x`` cast to x's dtype (as
the TPU kernel and the reference ``mamba_mix`` compute it). The state ``h``
is read at the state rows and the final one is written back there, in
place. With a zero ``h`` it is the TPU kernel's function.

This is what the kernel wrapper runs for a tensor on the CPU, and what
``chip_smoke.py`` holds the CUDA kernel against on the card."""
from __future__ import annotations

from typing import Optional

import torch


def mamba_scan_ref(x, dt, Bc, Cc, A, D, h, *,
                   rows: Optional[torch.Tensor] = None):
    """x [B, S, d] (model dtype); dt (already softplus'd), Bc, Cc [B, S, n]
    fp32; A = -exp(A_log) [d, n] fp32; D [d] fp32; h [Bs, d, n] fp32, the
    state of state row ``rows[b]`` (``b`` when None) for batch row b,
    updated in place. Returns y [B, S, d] in x's dtype."""
    xf = x.float()
    dtf, Bf, Cf = dt.float(), Bc.float(), Cc.float()
    Af = A.float()
    # a copy even for all rows: the final write into h must not touch the
    # tensor the first step read (autograd saved it in a training backward)
    hh = (h.clone() if rows is None else h.index_select(0, rows)).float()
    ys = []
    for t in range(x.shape[1]):
        da = torch.exp(dtf[:, t, :, None] * Af)                  # [B, d, n]
        hh = da * hh + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", hh, Cf[:, t]))
    if rows is None:
        h.copy_(hh)
    else:
        h.index_copy_(0, rows, hh)
    y = torch.stack(ys, dim=1) + D.float() * xf
    return y.to(x.dtype)
