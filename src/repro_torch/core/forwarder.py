"""BatchForwarder F (paper Alg. 1/2): Forward / Pred / TimeToBudget.

``Forward(D, P, b)`` materializes the batch a budget of ``b`` tokens buys
under vLLM's allocation rule — every decode request gets 1 token, then
prefill/waiting requests take ``min(remaining, budget_left)`` in priority
order — and predicts its execution time. ``TimeToBudget`` inverts the
predictor by binary search (the paper's stated implementation).

``class_shares`` makes the within-round prefill split **SLO-class-aware**:
instead of handing the whole chunk budget to the priority order class-blind,
each class rank present gets a weighted share (interactive > standard >
batch by default), consumed in priority order within the class; whatever a
class cannot use spills over to the global priority order (work-conserving,
so the round never runs under-budget because one class ran dry). A
single-class round reduces exactly to the legacy split.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.request import ReqState, Request

Alloc = List[Tuple[Request, int]]

# Weighted chunk-budget shares by SLO class rank (see request.SLO_CLASS_RANK:
# 0 = interactive, 1 = standard/dialogue, 2 = batch/summarization).
DEFAULT_CLASS_SHARES: Dict[int, int] = {0: 4, 1: 2, 2: 1}


class BatchForwarder:
    def __init__(self, predictor, max_budget: int, budget_quantum: int = 1,
                 class_shares: Optional[Dict[int, int]] = None):
        self.predictor = predictor
        self.max_budget = max_budget
        self.quantum = budget_quantum  # beyond-paper: bucket budgets for JIT warmth
        self.class_shares = class_shares   # None = class-blind legacy split
        # Speculation price signals, written by the serving engine each
        # speculative round and read here + by the scheduler: expected draft
        # tokens riding each decode row (so to_batch prices decode rows as
        # (1+s)-wide verify rows), and the std of the accepted length (the
        # chunker's TBT-risk input — verify cost is paid up front while its
        # token yield varies). Both 0.0 means plain decode pricing.
        self.spec_draft_tokens = 0.0
        self.spec_len_std = 0.0

    # ---- batch materialization ------------------------------------------------
    def allocate(self, decoding: Sequence[Request], prefill_sorted: Sequence[Request],
                 budget: int) -> Alloc:
        alloc: Alloc = [(r, 1) for r in decoding]
        left = budget - len(decoding)
        if left <= 0:
            return alloc
        if self.class_shares is not None:
            ranks = {r.class_rank() for r in prefill_sorted}
            if len(ranks) > 1:
                return alloc + self._allocate_shares(prefill_sorted, left,
                                                     ranks)
        for r in prefill_sorted:
            if left <= 0:
                break
            take = min(r.remaining_prefill(), left)
            if take > 0:
                alloc.append((r, take))
                left -= take
        return alloc

    def _allocate_shares(self, prefill_sorted: Sequence[Request], left: int,
                         ranks) -> Alloc:
        """Weighted per-class shares, then work-conserving spillover.

        Pass 1 caps each class at ``left * w_c / sum(w)`` (consumed in the
        caller's priority order within the class); pass 2 hands every token
        pass 1 could not place back to the plain priority order, topping up
        earlier grants first. Exactly ``min(left, pending)`` tokens are
        placed — the split never costs throughput, only rearranges it."""
        w = {k: self.class_shares.get(k, 1) for k in ranks}
        total_w = sum(w.values())
        share = {k: (left * w[k]) // total_w for k in ranks}
        taken: Dict[int, int] = {}
        for r in prefill_sorted:
            k = r.class_rank()
            give = min(r.remaining_prefill(), share[k])
            if give > 0:
                taken[id(r)] = give
                share[k] -= give
        spill = left - sum(taken.values())
        for r in prefill_sorted:
            if spill <= 0:
                break
            give = min(r.remaining_prefill() - taken.get(id(r), 0), spill)
            if give > 0:
                taken[id(r)] = taken.get(id(r), 0) + give
                spill -= give
        return [(r, taken[id(r)]) for r in prefill_sorted if id(r) in taken]

    def _spec_s(self) -> int:
        """Expected drafts per decode row, rounded to the batch-entry grain."""
        return int(round(self.spec_draft_tokens))

    def to_batch(self, alloc: Alloc) -> List[Tuple]:
        """(c_i, u_i[, s_i]) entries for the predictor/features; decode rows
        widen to expected verify width when the engine is speculating."""
        s = self._spec_s()
        out: List[Tuple] = []
        for r, n in alloc:
            if n <= 1 and s > 0 and r.state == ReqState.DECODING:
                out.append((1 + s, r.context_len(), s))
            else:
                out.append((n, r.context_len()))
        return out

    # ---- F.Forward / F.Pred / F.TimeToBudget -----------------------------------
    def forward(self, decoding, prefill_sorted, budget: int) -> Tuple[float, Alloc]:
        budget = self._q(budget)
        alloc = self.allocate(decoding, prefill_sorted, budget)
        return self.predictor.predict(self.to_batch(alloc)), alloc

    def pred(self, budget: int, decoding, prefill_sorted) -> float:
        budget = self._q(budget)
        alloc = self.allocate(decoding, prefill_sorted, budget)
        return self.predictor.predict(self.to_batch(alloc))

    def forward_next(self, decoding, prefill_sorted, alloc1: Alloc,
                     budget2: int):
        """(predicted_time, scheduled_tokens) of the next iteration's batch,
        with the queue advanced past window 1 (see pred_next)."""
        batch = self._next_batch(decoding, prefill_sorted, alloc1, budget2)
        return self.predictor.predict(batch), sum(e[0] for e in batch)

    def time_to_budget_next(self, decoding, prefill_sorted, alloc1: Alloc,
                            t_limit: float) -> int:
        """TimeToBudget evaluated on the post-window-1 queue."""
        lo = len(decoding)
        hi = self.max_budget
        pred = lambda b: self.predictor.predict(
            self._next_batch(decoding, prefill_sorted, alloc1, b))
        if pred(hi) <= t_limit:
            return hi
        if pred(lo) > t_limit:
            return lo
        while hi - lo > max(1, self.quantum):
            mid = (lo + hi) // 2
            if pred(mid) <= t_limit:
                lo = mid
            else:
                hi = mid
        return lo

    def _next_batch(self, decoding, prefill_sorted, alloc1: Alloc, budget2: int):
        taken = {id(r): n for r, n in alloc1}
        s = self._spec_s()
        if s > 0:
            batch = [(1 + s, r.context_len() + 1, s) for r in decoding]
        else:
            batch = [(1, r.context_len() + 1) for r in decoding]
        left = budget2 - len(batch)
        for r in prefill_sorted:
            got = taken.get(id(r), 0)
            rem = r.remaining_prefill() - got
            if rem <= 0:
                if left > 0:
                    batch.append((1, r.prompt_len))
                    left -= 1
                continue
            if left <= 0:
                continue
            take = min(rem, left)
            batch.append((take, r.context_len() + got))
            left -= take
        return batch

    def pred_next(self, decoding, prefill_sorted, alloc1: Alloc, budget2: int) -> float:
        """Predicted time of the *next* iteration's batch, with the queue
        advanced past window 1: chunks allocated in window 1 are subtracted
        and prefills that complete become decodes. (Alg. 1 writes
        Pred(B_sigma - b, D, P) on the unchanged queue; taken literally both
        windows would allocate the same work twice and deferral would always
        look free.)"""
        return self.predictor.predict(
            self._next_batch(decoding, prefill_sorted, alloc1, budget2))

    def time_to_budget(self, decoding, prefill_sorted, t_limit: float) -> int:
        """Largest budget whose predicted time fits in ``t_limit``."""
        lo = len(decoding)
        hi = self.max_budget
        if self.pred(hi, decoding, prefill_sorted) <= t_limit:
            return hi
        if self.pred(lo, decoding, prefill_sorted) > t_limit:
            return lo
        while hi - lo > max(1, self.quantum):
            mid = (lo + hi) // 2
            if self.pred(mid, decoding, prefill_sorted) <= t_limit:
                lo = mid
            else:
                hi = mid
        return lo

    def _q(self, budget: int) -> int:
        if self.quantum <= 1:
            return budget
        return max(0, budget // self.quantum * self.quantum)
