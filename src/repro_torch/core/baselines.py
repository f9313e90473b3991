"""Baseline schedulers the paper evaluates against (§5 Baselines).

* ``FCFSStaticScheduler`` — vLLM-style: static token budget, FCFS order.
* ``SarathiEDFScheduler`` — Sarathi chunked prefill with a *TBT-calibrated*
  static token budget; candidates ordered earliest-TTFT-deadline-first.
  Sarathi-serve derives its fixed chunk size from the deployment's TBT
  target by offline profiling; mirroring that here (the largest pure-prefill
  chunk the predictor says fits the tightest TBT SLO present) replaced a
  hardcoded 512 that overshot the 40 ms dialogue TBT by ~70% per round —
  every decode token sharing a round with a full chunk missed its deadline,
  collapsing measured goodput to the QPS search bracket's lower edge on
  sharegpt/mixed-v1 (the BENCH_goodput.json ``sarathi-edf`` anomaly). Pass
  ``chunk_budget`` explicitly to pin the legacy fixed budget.
* ``SingleStepGreedyScheduler`` — the §2.2 strawman: dynamic chunking that
  greedily maximizes the *current* iteration's budget under the tightest
  decode TBT slack (no look-ahead).
* ``QoServeLikeScheduler`` — a QoServe-style SOTA stand-in: single-step
  dynamic chunking + hybrid prioritization (deadline urgency blended with
  estimated remaining processing time) + proactive relegation of requests
  whose SLO already expired.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.scheduler import Decision, SchedulerBase
from repro_torch.core.sliding_chunker import window_bounds
from repro_torch.serving.request import Request


class FCFSStaticScheduler(SchedulerBase):
    name = "vllm-fcfs"

    def __init__(self, predictor=None, max_budget: int = 4096, chunk_budget: int = 512):
        super().__init__(predictor, max_budget)
        self.chunk_budget = chunk_budget

    def schedule(self, t, waiting, prefilling, decoding, kv=None):
        P = sorted(list(prefilling) + list(waiting), key=lambda r: r.arrival)
        budget = min(self.chunk_budget, self._budget_cap(decoding, kv))
        pred, alloc = self.F.forward(list(decoding), P, budget)
        if not alloc:
            return None
        return Decision(alloc, pred, budget, self.name)


class SarathiEDFScheduler(SchedulerBase):
    name = "sarathi-edf"

    def __init__(self, predictor=None, max_budget: int = 4096,
                 chunk_budget: Optional[int] = None):
        super().__init__(predictor, max_budget)
        self.chunk_budget = chunk_budget

    def _derived_budget(self, tbt: float) -> int:
        """Sarathi-serve's offline TBT calibration, on the live predictor:
        the largest pure-prefill chunk whose predicted round time fits the
        TBT target. Like the real system's profiling, the canonical batch
        ignores the round's decode composition — under heavy decode load the
        fixed chunk still overshoots, which is exactly the behaviour
        SlidingServe's look-ahead improves on; unlike the slack-driven
        dynamic baselines, the target is the static SLO constant, not the
        current deadline gap."""
        lo, hi = 16, self.max_budget
        if self.predictor.predict([(hi, 0)]) <= tbt:
            return hi
        while hi - lo > 16:
            mid = (lo + hi) // 2
            if self.predictor.predict([(mid, 0)]) <= tbt:
                lo = mid
            else:
                hi = mid
        return lo

    def schedule(self, t, waiting, prefilling, decoding, kv=None):
        P = sorted(list(prefilling) + list(waiting), key=lambda r: r.ttft_deadline())
        D = list(decoding)
        if self.chunk_budget is not None:
            static = self.chunk_budget
        else:
            tbt = min((r.tbt_slo for r in D + P), default=None)
            if tbt is None:
                return None
            static = self._derived_budget(tbt)
        budget = min(static, self._budget_cap(D, kv))
        pred, alloc = self.F.forward(D, P, budget)
        if not alloc:
            return None
        return Decision(alloc, pred, budget, self.name)


class SingleStepGreedyScheduler(SchedulerBase):
    name = "single-step"

    def schedule(self, t, waiting, prefilling, decoding, kv=None):
        P = sorted(list(prefilling) + list(waiting), key=lambda r: r.ttft_deadline())
        D = list(decoding)
        t_cur, _ = window_bounds(D, t, default_cur=self.max_iter_time)
        t_cur = min(t_cur, self.max_iter_time)
        budget = min(self.F.time_to_budget(D, P, t_cur), self._budget_cap(D, kv))
        pred, alloc = self.F.forward(D, P, budget)
        if not alloc:
            return None
        return Decision(alloc, pred, budget, self.name)


class QoServeLikeScheduler(SchedulerBase):
    name = "qoserve"

    def __init__(self, predictor=None, max_budget: int = 4096, urgency_weight: float = 1.0,
                 max_iter_time: float = 0.05):
        super().__init__(predictor, max_budget, max_iter_time=max_iter_time)
        self.urgency_weight = urgency_weight

    def _key(self, r: Request, t: float):
        expired = 1 if r.ttft_slack(t) < 0 else 0
        est_time = r.remaining_prefill() / max(self.rho, 1.0)
        # hybrid: deadline urgency blended with estimated processing time
        score = r.ttft_slack(t) - self.urgency_weight * est_time
        return (expired, score, r.remaining_prefill())

    def schedule(self, t, waiting, prefilling, decoding, kv=None):
        P = sorted(list(prefilling) + list(waiting), key=lambda r: self._key(r, t))
        D = list(decoding)
        t_cur, _ = window_bounds(D, t, default_cur=self.max_iter_time)
        t_cur = min(t_cur, self.max_iter_time)
        budget = min(self.F.time_to_budget(D, P, t_cur), self._budget_cap(D, kv))
        pred, alloc = self.F.forward(D, P, budget)
        if not alloc:
            return None
        return Decision(alloc, pred, budget, self.name)


ALL_BASELINES = (FCFSStaticScheduler, SarathiEDFScheduler,
                 SingleStepGreedyScheduler, QoServeLikeScheduler)
