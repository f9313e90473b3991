"""Multi-Level Priority Sorter (paper §3.3, Eq. 6-13).

Lexicographic key K_i(t) = (1 - g_i, 1 - e_i(t), r_i(t)):

1. safeguard priority (g_i) — protected requests first;
2. urgency priority — e_i = 1[u_i(t) > alpha] with normalized urgency
   u_i = r_i / (rho_t * max(s_i, eps)) (Eq. 10): remaining work relative to
   remaining slack, measured in recent system throughput rho_t;
3. short-remaining priority — fewer remaining prefill tokens first.

One addition taken from the paper's §5.2 discussion ("lowering the scheduling
priority of requests that have already violated their SLOs"): an outermost
*relegation* level pushes already-expired requests behind everything else, so
capacity is reserved for requests that can still meet their deadline.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.serving.request import Request

EPS = 1e-6


def normalized_urgency(req: Request, t: float, rho: float, eps: float = EPS) -> float:
    """u_i(t) of Eq. 10."""
    r = req.remaining_prefill()
    s = req.ttft_slack(t)
    return r / (max(rho, 1.0) * max(s, eps))


def priority_key(req: Request, t: float, rho: float, alpha: float,
                 relegate_expired: bool = True) -> Tuple:
    g = 1 if req.guard else 0
    u = normalized_urgency(req, t, rho)
    e = 1 if u > alpha else 0
    expired = 1 if (relegate_expired and req.ttft_slack(t) < 0) else 0
    # cache-aware tie-break (after remaining work, before FIFO): among equal
    # remaining-prefill candidates, prefer the larger frozen-prefix hit —
    # its KV is already resident, so finishing it frees budget soonest and
    # keeps the shared chain hot.
    return (expired, 1 - g, 1 - e, req.remaining_prefill(),
            -req.cached_prefix, req.arrival)


def sort_candidates(prefilling: Sequence[Request], waiting: Sequence[Request],
                    t: float, rho: float, alpha: float = 1.0,
                    relegate_expired: bool = True) -> List[Request]:
    """Eq. 6 + Eq. 13: merge and LexSort ascending."""
    cands = list(prefilling) + list(waiting)
    return sorted(cands, key=lambda r: priority_key(r, t, rho, alpha, relegate_expired))
