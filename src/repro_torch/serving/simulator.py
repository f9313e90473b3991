"""Event-driven serving simulator (the paper's evaluation harness).

Executes a scheduler against the analytic ground-truth cost model: each round
the scheduler emits a request-level token allocation; the simulator charges
the batch's (noisy) latency, advances request state — chunked prefill
progress, first-token emission when prefill completes, one token per decode
request (or ``1 + accepted`` with speculative decoding on: verify rows are
priced at ``1 + spec_k`` tokens and serve a sampled accepted chain) —
enforces paged-KV admission/preemption, and feeds the observed latency back
to the scheduler's online predictor. Wall-clock in the simulated
timeline is exact; the Python loop itself is cheap.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.scheduler import Decision, KVPressure, SchedulerBase
from repro_torch.serving.block_allocator import BlockAllocator
from repro_torch.serving.costmodel import CostModel
from repro_torch.serving.request import ReqState, Request


@dataclasses.dataclass
class SimResult:
    requests: List[Request]
    duration: float
    iterations: int
    route_counts: Dict[str, int]
    trace: List[Tuple[float, float, int]]  # (t, latency, scheduled_tokens)


class ServingSimulator:
    def __init__(self, scheduler: SchedulerBase, cost_model: CostModel,
                 workload: Sequence[Request], *,
                 kv_capacity_tokens: int = 512 * 1024,
                 block_size: int = 16,
                 decode_reserve_tokens: int = 64,
                 max_sim_time: float = 1e9,
                 warmup_predictor: bool = True,
                 collect_trace: bool = False,
                 spec_k: int = 0,
                 spec_acceptance: float = 0.0,
                 spec_seed: int = 0):
        self.sched = scheduler
        self.cost = cost_model
        self.workload = sorted(workload, key=lambda r: r.arrival)
        self.alloc = BlockAllocator(kv_capacity_tokens, block_size)
        self.decode_reserve = decode_reserve_tokens
        self.max_sim_time = max_sim_time
        self.collect_trace = collect_trace
        self._last_round_evictions = 0
        # speculative decoding: each decode row is priced as a (1 + spec_k)-
        # token verify row (the drafted tokens ride the dispatch whether or
        # not they are accepted) and serves 1 + a tokens, a drawn as a chain
        # of per-draft accepts at ``spec_acceptance`` — the engine-measured
        # rate (see bench_goodput --spec-k, which feeds it in)
        self.spec_k = int(spec_k)
        self.spec_acceptance = float(spec_acceptance)
        self.spec_rows = 0
        self.spec_emitted = 0
        if self.spec_k:
            import numpy as np
            self._spec_rng = np.random.default_rng(spec_seed)
        if warmup_predictor:
            self._offline_calibration()

    # ---- offline predictor init (paper §3.2 "offline initialization") ---------
    def _offline_calibration(self, n: int = 600, seed: int = 1234):
        import numpy as np
        rng = np.random.default_rng(seed)
        samples = []
        for _ in range(n):
            nd = int(rng.integers(0, 48))
            np_ = int(rng.integers(0, 5))
            batch = [(1, int(rng.integers(16, 8192))) for _ in range(nd)]
            batch += [(int(rng.integers(2, 2048)), int(rng.integers(0, 8192)))
                      for _ in range(np_)]
            if not batch:
                continue
            samples.append((batch, self.cost.latency(batch, noisy=True)))
        self.sched.predictor.fit_offline(samples)

    # ---- main loop --------------------------------------------------------------
    def run(self) -> SimResult:
        t = 0.0
        pending = list(self.workload)   # not yet arrived
        waiting: List[Request] = []
        active: List[Request] = []      # prefilling or decoding, KV-resident
        iterations = 0
        route_counts: Dict[str, int] = {}
        trace: List[Tuple[float, float, int]] = []

        def admit_arrivals(now: float):
            while pending and pending[0].arrival <= now:
                waiting.append(pending.pop(0))

        while (pending or waiting or active) and t < self.max_sim_time:
            admit_arrivals(t)

            # KV admission: move waiting -> active when the prompt + reserve
            # fits; the blocks are *reserved* at admit time so concurrent
            # admits are gated by the same free pool.
            still_waiting: List[Request] = []
            for r in waiting:
                if self.alloc.admit(r.rid,
                                    r.remaining_prefill() + self.decode_reserve):
                    active.append(r)
                else:
                    still_waiting.append(r)
            waiting = still_waiting

            # admitted-but-unstarted requests are offered as ``waiting`` so
            # MLPS ordering applies to them; KV pressure lets the scheduler
            # cap chunk budgets before growth failures force evictions.
            wait_adm = [r for r in active if r.state == ReqState.WAITING]
            prefilling = [r for r in active if r.state == ReqState.PREFILLING]
            decoding = [r for r in active if r.state == ReqState.DECODING]
            # pressure tracks tokens actually computed, not reservations —
            # reserved prompt space is what scheduled prefill consumes
            capacity = self.alloc.num_blocks * self.alloc.block_size
            computed = sum(r.context_len() for r in active)
            kv = KVPressure(utilization=computed / capacity,
                            free_tokens=capacity - computed,
                            evictions=self._last_round_evictions)

            decision = self.sched.schedule(t, wait_adm, prefilling, decoding,
                                           kv=kv)
            if decision is None or not decision.alloc:
                if pending:
                    t = max(t, pending[0].arrival)
                    continue
                break

            batch = decision.batch()
            if self.spec_k:
                batch = [(n + (self.spec_k if r.state == ReqState.DECODING
                               else 0), r.context_len())
                         for r, n in decision.alloc]
            latency = self.cost.latency(batch, noisy=True)
            t += latency
            iterations += 1
            route_counts[decision.route] = route_counts.get(decision.route, 0) + 1
            if self.collect_trace:
                trace.append((t, latency, sum(c for c, _ in batch)))

            finished: List[Request] = []
            ev0 = self.alloc.evictions
            for req, n in decision.alloc:
                if req.rid not in self.alloc.owners:
                    continue   # evicted by an earlier entry's growth this round
                if req.state == ReqState.DECODING:
                    serve = 1
                    if self.spec_k:
                        while (serve <= self.spec_k and self._spec_rng.random()
                               < self.spec_acceptance):
                            serve += 1
                        self.spec_rows += 1
                        self.spec_emitted += serve
                    for _ in range(serve):
                        if req.state != ReqState.DECODING:
                            break   # accepted tail past max_output: dropped
                        if not self.alloc.grow(req.rid, req.context_len() + 1):
                            self._evict_for(req, active, waiting)
                            if not self.alloc.grow(req.rid,
                                                   req.context_len() + 1):
                                break   # capacity exhausted: token not served
                        req.emit_token(t)
                else:
                    self.alloc.grow(req.rid, req.prefilled + n)
                    req.advance_prefill(n)
                    if req.remaining_prefill() == 0:
                        req.emit_token(t)  # prefill completion emits token 1
                if req.state == ReqState.FINISHED:
                    finished.append(req)
            for req in finished:
                self.alloc.free(req.rid)
                active.remove(req)

            self._last_round_evictions = self.alloc.evictions - ev0
            computed = sum(r.context_len() for r in active)
            self.sched.observe(batch, latency,
                               kv=KVPressure(computed / capacity,
                                             capacity - computed,
                                             self._last_round_evictions))
            self.alloc.check_invariants()

        return SimResult(requests=list(self.workload), duration=t,
                         iterations=iterations, route_counts=route_counts,
                         trace=trace)

    # ---- preemption ---------------------------------------------------------------
    def _evict_for(self, needy: Request, active: List[Request],
                   waiting: List[Request]) -> None:
        """Free blocks by relegating the lowest-priority non-needy owner
        (allocator ``pick_victim``: newest arrival first — the shared
        vLLM-style recompute policy): its cache is dropped, prefill restarts."""
        by_rid = {r.rid: r for r in active}
        # always free at least one block (the caller's grow just failed);
        # decode_reserve may be 0 or below the block size
        target = max(self.decode_reserve, 1)
        while self.alloc.free_blocks * self.alloc.block_size < target:
            vid = self.alloc.pick_victim(
                needy.rid, priority=lambda rid: by_rid[rid].arrival
                if rid in by_rid else -1.0)
            if vid is None or vid not in by_rid:
                return
            v = by_rid.pop(vid)
            self.alloc.evict(v.rid)
            active.remove(v)
            v.state = ReqState.WAITING
            v.prefilled = 0
            waiting.append(v)
