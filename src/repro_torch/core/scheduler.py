"""SlidingServe closed-loop scheduler (paper Fig. 3) + the Violation Checker.

Each round: (1) sort candidates with the Multi-Level Priority Sorter, (2)
build the *maximal candidate batch* under the server budget, (3) submit it to
the Violation Checker, (4) route to BatchConstructor (risk) or SlidingChunker
(no risk), (5) emit the executable batch (request-level token allocation).

``observe`` closes the loop: real batch latencies feed the online predictor
refit and the throughput estimate rho_t the sorter's urgency uses.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.batch_constructor import batch_constructor
from repro_torch.core.forwarder import Alloc, BatchForwarder, DEFAULT_CLASS_SHARES
from repro_torch.core.predictor import BatchLatencyPredictor
from repro_torch.core.sliding_chunker import sliding_chunker, window_bounds
from repro_torch.core.sorter import sort_candidates
from repro_torch.serving.request import Request


@dataclasses.dataclass
class Decision:
    alloc: Alloc                      # [(request, tokens this round)]
    predicted_time: float
    budget: int
    route: str                        # "sliding" | "construct" | baseline name

    def batch(self) -> List[Tuple[int, int]]:
        return [(n, r.context_len()) for r, n in self.alloc]


@dataclasses.dataclass(frozen=True)
class KVPressure:
    """Paged-KV memory state the executor surfaces to the scheduler each
    round, so chunk budgets can back off before allocation failures force
    evict-and-recompute churn.

    ``free_tokens`` — new tokens storable without evicting a *live* request
    (free pages, owners' tail-page slack, and reclaimable cached pages).
    ``reclaimable_tokens`` — the prefix-cache slice of ``free_tokens``:
    refcount-0 frozen pages the allocator reclaims LRU-first before any live
    request is relegated. The split matters for backoff: ``utilization``
    counts only live-referenced tokens, so a pool whose idle capacity sits
    in reclaimable cached pages (a warm prefix cache) does not read as
    pressure. ``evictions`` — live-request evictions since the previous
    ``schedule`` call (not lifetime)."""

    utilization: float = 0.0
    free_tokens: int = 1 << 30
    evictions: int = 0
    reclaimable_tokens: int = 0


class SchedulerBase:
    """Common interface + shared observation machinery."""

    name = "base"
    # back off hard once this fraction of KV is resident (pre-eviction guard)
    kv_backoff_util = 0.92

    def __init__(self, predictor: Optional[BatchLatencyPredictor] = None,
                 max_budget: int = 4096, budget_quantum: int = 1,
                 max_iter_time: float = 0.05, class_shares=None):
        self.predictor = predictor or BatchLatencyPredictor()
        # class_shares: rank -> weight for the within-round chunk-budget
        # split (see forwarder.DEFAULT_CLASS_SHARES); None = class-blind.
        self.F = BatchForwarder(self.predictor, max_budget, budget_quantum,
                                class_shares=class_shares)
        self.max_budget = max_budget
        # Responsiveness guard: cap a single iteration's target duration so a
        # large chunk scheduled during a lull cannot blind the server to
        # arrivals (static-chunk systems get this implicitly from their chunk
        # size; dynamic chunking needs it explicitly).
        self.max_iter_time = max_iter_time
        self.rho = 1000.0          # tokens/s EMA (Eq. 9's rho_t)
        self._rho_beta = 0.9
        self.last_kv: Optional[KVPressure] = None

    def schedule(self, t: float, waiting: Sequence[Request],
                 prefilling: Sequence[Request],
                 decoding: Sequence[Request],
                 kv: Optional[KVPressure] = None) -> Optional[Decision]:
        raise NotImplementedError

    def _budget_cap(self, decoding: Sequence[Request],
                    kv: Optional[KVPressure]) -> int:
        """Effective token budget under KV pressure: every scheduled token
        becomes a cache entry, so never schedule more than fits free, and
        halve the target while evictions are happening (churn costs full
        recompute of the victim)."""
        self.last_kv = kv
        if kv is None:
            return self.max_budget
        floor = len(decoding) + 1          # liveness: decodes + 1 prefill token
        cap = max(floor, kv.free_tokens)
        if kv.evictions > 0 or kv.utilization > self.kv_backoff_util:
            cap = max(floor, cap // 2)
        return min(self.max_budget, cap)

    def observe(self, batch: Sequence[Tuple], latency: float,
                kv: Optional[KVPressure] = None) -> None:
        if kv is not None:
            self.last_kv = kv
        self.predictor.observe(batch, latency)
        if latency > 0:
            # rho_t estimates how fast *prefill* work drains (Eq. 9 divides
            # remaining prefill tokens by it), so measure prefill-token
            # throughput on rounds that carry prefill work; decode-only
            # rounds would bias the estimate far low. Entries may be (c, u)
            # or (c, u, s) — speculative verify rows (base width c - s <= 1)
            # are decode work and must not count as prefill drain.
            prefill_tokens = sum(
                e[0] for e in batch
                if e[0] - (e[2] if len(e) > 2 else 0) > 1)
            if prefill_tokens > 0:
                tput = prefill_tokens / latency
                self.rho = self._rho_beta * self.rho + (1 - self._rho_beta) * tput


class SlidingServeScheduler(SchedulerBase):
    name = "slidingserve"

    def __init__(self, predictor=None, max_budget: int = 4096,
                 alpha: float = 0.5, budget_quantum: int = 1,
                 enable_mlps: bool = True, enable_bc: bool = True,
                 enable_sliding: bool = True, clamp_current: bool = True,
                 knapsack_granularity: int = 16, max_iter_time: float = 0.05,
                 objective: str = "tokens",
                 class_shares=DEFAULT_CLASS_SHARES):
        # SlidingServe defaults to class-aware budget shares (the baselines
        # stay class-blind: that is what they are baselines *of*).
        super().__init__(predictor, max_budget, budget_quantum,
                         max_iter_time=max_iter_time,
                         class_shares=class_shares)
        self.objective = objective
        self.alpha = alpha
        self.enable_mlps = enable_mlps
        self.enable_bc = enable_bc
        self.enable_sliding = enable_sliding
        self.clamp_current = clamp_current
        self.knapsack_granularity = knapsack_granularity

    def _sorted(self, t, waiting, prefilling):
        if self.enable_mlps:
            return sort_candidates(prefilling, waiting, t, self.rho, self.alpha)
        cands = list(prefilling) + list(waiting)
        return sorted(cands, key=lambda r: r.ttft_deadline())   # EDF fallback

    def schedule(self, t, waiting, prefilling, decoding, kv=None):
        if not (waiting or prefilling or decoding):
            return None
        P = self._sorted(t, waiting, prefilling)
        D = list(decoding)
        t_cur, t_next = window_bounds(D, t, default_cur=self.max_iter_time)
        t_cur = min(t_cur, self.max_iter_time)
        # KV pressure (paged engine): cap the token budget at what the cache
        # can absorb so SlidingChunker/BatchConstructor never schedule chunks
        # whose KV writes would immediately evict an active request.
        max_budget = self._budget_cap(D, kv)

        # (4) Violation Checker on the maximal candidate batch. The paper's
        # risk test (slack < T_full) is refined with the Eq.-10 urgency gate:
        # a request is at *actionable* risk only if it also cannot complete at
        # the observed prefill pace — otherwise normal capped rounds will
        # finish it and a dedicated BC batch would pay its cost for nothing.
        route = "sliding"
        if self.enable_bc and P:
            t_full, _ = self.F.forward(D, P, max_budget)
            from repro_torch.core.sorter import normalized_urgency
            if any(r.ttft_slack(t) < t_full and r.ttft_slack(t) > 0
                   and normalized_urgency(r, t, self.rho) > 1.0 for r in P):
                res = batch_constructor(D, P, max_budget, t, self.F,
                                        granularity=self.knapsack_granularity)
                if res is not None:
                    budget, alloc = res
                    pred = self.predictor.predict(self.F.to_batch(alloc))
                    return Decision(alloc, pred, budget, "construct")

        # (4b) Speculation risk: verify rows pay fixed multi-token cost for a
        # variable token yield, so accepted-length *variance* is TBT risk —
        # a volatile acceptance rate means some rows' TBT gains evaporate
        # while their verify cost stays in the round. Tighten the current
        # window by the time one std of at-risk draft tokens per decode row
        # costs at the observed pace, shrinking chunk budgets exactly when
        # speculation is least dependable. (Expected verify *cost* is already
        # priced by F.to_batch widening decode rows; this handles the risk.)
        if getattr(self.F, "spec_draft_tokens", 0.0) > 0 and D:
            risk_tokens = self.F.spec_len_std * len(D)
            t_cur = max(t_cur - risk_tokens / max(self.rho, 1e-6), 1e-4)

        # (5) SlidingChunker branch (or single-step when ablated off).
        if self.enable_sliding:
            budget, alloc, pred = sliding_chunker(
                D, P, max_budget, t, t_cur, t_next, self.F,
                clamp_current=self.clamp_current, objective=self.objective)
        else:
            # single-step ablation honors the same KV cap as the other paths,
            # else its ablated runs pay eviction churn the baselines don't
            budget = min(self.F.time_to_budget(D, P, t_cur), max_budget)
            pred, alloc = self.F.forward(D, P, budget)
        if not alloc and (D or P):
            # liveness guard: never idle while work is pending
            budget = max(self.F.time_to_budget(D, P, t_cur), len(D) + 1)
            pred, alloc = self.F.forward(D, P, budget)
        if not alloc:
            return None
        return Decision(alloc, pred, budget, route)
