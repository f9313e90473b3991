"""SlidingChunker (paper §3.4, Algorithm 1).

Instead of greedily taking the largest budget the current iteration's decode
slack allows, jointly optimize the budget across a sliding window of two
consecutive iterations. Window bounds follow Eq. 14/15 over the safeguarded
decode set:

    T_cur  = min_i s_i(t)
    T_next = min_i (s_i(t) - T_cur + L_tbt_i)

Two selectable objectives, both driven by Alg. 1's skeleton (TimeToBudget
inversion, discrete ternary search, candidate set {l0, r0, m}, prefer-larger
tie-break):

* ``objective="tokens"`` (default) — maximize tokens processed across BOTH
  windows subject to both deadlines, window 2 evaluated on the post-window-1
  queue with its *actual* remaining time T_next(b) = min_i(s_i + L_tbt) -
  T_hat(b). This is Figure 1's semantics ("processes 100 more tokens ...
  before the next iteration's deadline"): an over-greedy window 1 eats window
  2's slack; an over-timid one wastes window 1. Ties (within ``tie_tol``)
  break toward lower total time, then larger b.
* ``objective="paper"`` — the literal Alg. 1 objective
  min_b T_hat(b) + T_hat(B_sigma - b). Note that under light load (pending
  work < B_sigma) this is degenerate: both windows draw from the same queue,
  so deferring work is always predicted (spuriously) to be free; it is kept
  for the fidelity ablation and behaves like the paper's setting under
  saturation.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.forwarder import Alloc, BatchForwarder
from repro_torch.serving.request import Request


def window_bounds(decoding: Sequence[Request], t: float,
                  default_cur: float = 1.0) -> Tuple[float, float]:
    """Eq. 14 / Eq. 15 over the safeguarded decode set."""
    safe = [r for r in decoding if r.is_decoding()]
    if not safe:
        return default_cur, default_cur
    t_cur = min(r.sched_decode_slack(t) for r in safe)
    t_cur = max(t_cur, 1e-4)
    t_next = min(r.sched_decode_slack(t) - t_cur + r.tbt_slo for r in safe)
    t_next = max(t_next, 1e-4)
    return t_cur, t_next


def sliding_chunker(
    decoding: Sequence[Request],
    prefill_sorted: Sequence[Request],
    max_budget: int,
    t: float,
    t_cur: float,
    t_next: float,
    F: BatchForwarder,
    *,
    ternary_stop: int = 30,
    clamp_current: bool = True,
    objective: str = "tokens",
    deviate_margin: float = 0.08,
) -> Tuple[int, Alloc, float]:
    """Algorithm 1. Returns (B_star, A_star, predicted_time_cur)."""
    b_cur = F.time_to_budget(decoding, prefill_sorted, t_cur)
    b_next = F.time_to_budget(decoding, prefill_sorted, t_next)
    b_sum = b_cur + b_next

    # window-2 deadline base: T_next(b) = slack_min_with_tbt - T_hat(b)
    safe = [r for r in decoding if r.is_decoding()]
    next_deadline_base = (min(r.sched_decode_slack(t) + r.tbt_slo for r in safe)
                          if safe else t_cur + t_next)

    total_work = len(decoding) + sum(r.remaining_prefill() for r in prefill_sorted)
    l = len(decoding)
    r = min(max_budget, b_cur) if clamp_current else max_budget
    r = min(r, total_work)   # budget beyond pending work buys nothing
    r = max(r, l)
    l0, r0 = l, r

    def evaluate(b: int):
        """Returns (neg_tokens, total_time, t_b, alloc) for ranking."""
        t_b, alloc = F.forward(decoding, prefill_sorted, b)
        if objective == "paper":
            t_n = F.pred(max(b_sum - b, len(decoding)), decoding, prefill_sorted)
            return (0.0, t_b + t_n, t_b, alloc)
        t2_limit = max(next_deadline_base - t_b, 1e-4)
        b2 = F.time_to_budget_next(decoding, prefill_sorted, alloc, t2_limit)
        t_n, tokens2 = F.forward_next(decoding, prefill_sorted, alloc, b2)
        tokens1 = sum(n for _, n in alloc)
        return (-(tokens1 + tokens2), t_b + t_n, t_b, alloc)

    lo, hi = l, r
    while hi - lo > ternary_stop:
        m1 = lo + (hi - lo) // 3
        m2 = hi - (hi - lo) // 3
        if evaluate(m1)[:2] <= evaluate(m2)[:2]:
            hi = m2 - 1
        else:
            lo = m1 + 1
    m = (lo + hi) // 2

    # The maximal clamped budget r0 is the incumbent (Alg. 1's prefer-larger
    # tie-break, generalized to float predictions): a smaller budget is chosen
    # only when the two-window evaluation shows a *strict* token win by
    # ``deviate_margin`` — window 1 is the only window that actually executes,
    # so marginal/artifactual "wins" for deferral (which would starve prefill
    # or even deadlock the server) never outrank greedy. On a flat latency
    # landscape the chunker thus degrades gracefully to clamped greedy; it
    # activates exactly when the predictor sees real convexity (long-chunk
    # self-attention, overhead-dominated regimes).
    best_b = r0
    best = evaluate(r0)
    for b in sorted({l0, m} - {r0}, reverse=True):
        sc = evaluate(b)
        if sc[0] < best[0] - deviate_margin * max(abs(best[0]), 1.0):
            best, best_b = sc, b
    return best_b, best[3], best[2]


def single_step_budget(decoding, prefill_sorted, t_cur: float,
                       F: BatchForwarder) -> int:
    """The greedy strawman (paper §2.2): maximal budget under current slack."""
    return F.time_to_budget(decoding, prefill_sorted, t_cur)
