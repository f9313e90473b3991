"""BatchConstructor (paper §3.5, Algorithm 2).

When the maximal candidate batch would TTFT-violate some prefill requests,
batch construction becomes capacity-constrained request selection: each risky
request is tried as an *anchor* whose TTFT slack caps the batch execution time
(T_a = s_a -> capacity C_a via TimeToBudget); the anchor is forced in and the
remaining capacity is filled by a 0/1 knapsack over requests with slack >= s_a
(weights = remaining prefill tokens r_j, values = Eq. 18). The winning anchor
solution is picked by the lexicographic COMPARER (Eq. 21): most requests
completing prefill, then total value, then utilized budget. Selected prefill
requests receive their full remaining tokens (Eq. 22) so they emit their first
token this round.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.forwarder import Alloc, BatchForwarder
from repro_torch.serving.request import Request


def knapsack_01(items: Sequence[Tuple[int, float]], capacity: int,
                granularity: int = 16) -> List[int]:
    """0/1 knapsack -> indices of chosen items.

    items: (weight, value). Weights/capacity are quantized to ``granularity``
    tokens (weights rounded *up*, so the solution never overfills).
    """
    if capacity <= 0 or not items:
        return []
    g = max(1, granularity)
    cap_q = capacity // g
    if cap_q <= 0:
        return []
    n = len(items)
    w_q = [max(1, -(-w // g)) for w, _ in items]  # ceil division
    vals = [v for _, v in items]
    NEG = -math.inf
    dp = [0.0] + [NEG] * cap_q
    keep = [[False] * (cap_q + 1) for _ in range(n)]
    for i in range(n):
        wi, vi = w_q[i], vals[i]
        for c in range(cap_q, wi - 1, -1):
            cand = dp[c - wi] + vi
            if dp[c - wi] > NEG and cand > dp[c]:
                dp[c] = cand
                keep[i][c] = True
    # best reachable capacity
    best_c = max(range(cap_q + 1), key=lambda c: (dp[c] if dp[c] > NEG else NEG))
    if dp[best_c] <= 0.0 and best_c == 0:
        pass
    chosen = []
    c = best_c
    for i in range(n - 1, -1, -1):
        if keep[i][c]:
            chosen.append(i)
            c -= w_q[i]
    return chosen[::-1]


def value_fn(requests: Sequence[Request], slacks: Dict[int, float]) -> Dict[int, float]:
    """Eq. 18: v_j = 1 / (sum_k s_k + r_j / sum_k r_k) over the anchor set."""
    s_sum = sum(max(slacks[r.rid], 0.0) for r in requests)
    r_sum = float(sum(r.remaining_prefill() for r in requests)) or 1.0
    out = {}
    for r in requests:
        denom = s_sum + r.remaining_prefill() / r_sum
        out[r.rid] = 1.0 / max(denom, 1e-9)
    return out


def batch_constructor(
    decoding: Sequence[Request],
    prefill_sorted: Sequence[Request],
    max_budget: int,
    t: float,
    F: BatchForwarder,
    *,
    granularity: int = 16,
    decode_guard: bool = True,
) -> Optional[Tuple[int, Alloc]]:
    """Algorithm 2. Returns (B_star, A_star) or None when there is no risk.

    ``decode_guard`` (beyond-paper, see DESIGN.md): Alg. 2 bounds batch time
    only by the anchor's TTFT slack, which can be hundreds of ms — every
    active decode then misses TBT deadlines. The guard additionally caps the
    anchor time at min_i(decode slack + one TBT period), i.e. BC may eat at
    most one recoverable TBT period from the tightest decode stream.
    """
    t_full, _ = F.forward(decoding, prefill_sorted, max_budget)
    slacks = {r.rid: r.ttft_slack(t) for r in prefill_sorted}
    risky = [r for r in prefill_sorted if slacks[r.rid] < t_full]
    if not risky:
        return None
    guard_cap = math.inf
    if decode_guard and decoding:
        guard_cap = min(r.sched_decode_slack(t) + r.tbt_slo for r in decoding)

    cands = sorted(prefill_sorted, key=lambda r: (slacks[r.rid], r.remaining_prefill()))
    a_dec: Alloc = [(r, 1) for r in decoding]
    b_dec = len(decoding)

    best_key = (-1, -math.inf, -math.inf)
    best: Optional[Tuple[int, Alloc]] = None

    for anchor in risky:
        t_a = min(slacks[anchor.rid], guard_cap)
        if t_a <= 0:
            continue  # already expired: no batch can save it
        b_a = F.time_to_budget(decoding, prefill_sorted, t_a)
        c_a = min(max_budget, b_a) - b_dec
        r_a = anchor.remaining_prefill()
        if c_a <= 0 or r_a > c_a:
            continue
        s_a = [r for r in cands if slacks[r.rid] >= t_a]
        if anchor not in s_a:
            s_a.append(anchor)
        values = value_fn(s_a, slacks)
        others = [r for r in s_a if r.rid != anchor.rid]
        items = [(r.remaining_prefill(), values[r.rid]) for r in others]
        chosen_idx = knapsack_01(items, c_a - r_a, granularity)
        selected = [others[i] for i in chosen_idx] + [anchor]
        total_v = sum(values[r.rid] for r in selected)
        total_r = sum(r.remaining_prefill() for r in selected)
        key = (len(selected), total_v, total_r)      # COMPARER, Eq. 21
        if key > best_key:
            best_key = key
            alloc = a_dec + [(r, r.remaining_prefill()) for r in selected]
            best = (b_dec + total_r, alloc)
    return best
