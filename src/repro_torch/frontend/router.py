"""Prefix-affine multi-engine router: N replicas behind one submit surface.

One engine is one KV pool; a deployment runs many. The router's job is the
placement decision a load balancer cannot make: *which replica already holds
this prompt's prefix*. It keeps a shared :class:`PrefixDirectory` (hashed
page-granular token chains, mirrored from every replica's commit/reclaim
events) and steers each request to the replica holding the longest frozen
prefix — turning the per-engine radix cache into a fleet-wide one without
moving a single KV page across engines.

Affinity alone herds every popular prefix onto one replica until it melts,
so placement is **load-aware**: each replica's load is its outstanding token
work (uncomputed prefill + remaining decode budget) priced by an EWMA of its
measured per-token step cost, and the affine choice is overridden — spilled
to the least-loaded replica — when its load, net of the prefill the directory
hit would save, exceeds ``spill_factor`` times the cheapest alternative.
Ties break **SLO-class-aware**: among near-equal candidates, an interactive
request avoids the replica with the most latency-critical work already ahead
of it.

Replicas are pluggable: :class:`LocalReplica` wraps an in-process
:class:`InferenceServer`; ``repro_torch.frontend.client.HttpReplica`` speaks the
same protocol to a remote HTTP backend, so the identical router class fronts
either. The router owns the global rid space (replicas must never collide)
and routes cancels/stats by rid ownership.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.frontend.prefix_directory import PrefixDirectory
from repro_torch.serving.request import Request, class_rank
from repro_torch.serving.server import InferenceServer

POLICIES = ("prefix-affine", "round-robin")


class LocalReplica:
    """In-process replica: one :class:`InferenceServer` (one engine) plus the
    router-facing gauges — load cost, per-token cost EWMA, SLO-class queue
    depth — and the directory listener hookup."""

    # prior for the per-token step cost EWMA (seconds/token); the first
    # measured rounds wash it out quickly (alpha below)
    COST_PRIOR_S = 2e-4
    COST_ALPHA = 0.2

    def __init__(self, index: int, server: InferenceServer):
        self.index = index
        self.server = server
        self.cost_per_token = self.COST_PRIOR_S
        self._last_work = 0        # prefill+decode tokens at last step()
        self.peak_queue_depth = 0  # max admission-queue depth observed

    @classmethod
    def build(cls, index: int, cfg, scheduler=None, slo_classes=None,
              **engine_kw) -> "LocalReplica":
        return cls(index, InferenceServer.build(
            cfg, scheduler=scheduler, slo_classes=slo_classes, **engine_kw))

    # ---- directory hookup ----------------------------------------------------
    @property
    def page_size(self) -> int:
        return getattr(self.server.core, "page_size", 0)

    @property
    def paged(self) -> bool:
        return self.server.core.cache_mode == "paged"

    def attach_directory(self, directory: PrefixDirectory) -> None:
        """Mirror this replica's committed pages into the shared directory
        (the allocator fires on_commit/on_reclaim as pages freeze/drop)."""
        if self.paged:
            self.server.core.alloc.listener = directory.listener_for(
                self.index)

    # ---- submit / cancel -----------------------------------------------------
    def submit_request(self, req: Request, prompt: Sequence[int]):
        return self.server.submit_request(req, prompt)

    def cancel(self, rid: int) -> bool:
        return self.server.cancel(rid)

    # ---- pumping + cost estimation -------------------------------------------
    def has_work(self) -> bool:
        return self.server.has_work()

    def step(self) -> List:
        """One engine round; folds the measured wall/token ratio into the
        per-token cost EWMA the router prices load with."""
        t0 = time.perf_counter()
        evts = self.server.step()
        dt = time.perf_counter() - t0
        st = self.server.core.stats
        self.peak_queue_depth = max(self.peak_queue_depth,
                                    self.server.core.queue_depth)
        work = st.prefill_tokens + st.decode_tokens
        done = work - self._last_work
        self._last_work = work
        if done > 0:
            obs = dt / done
            self.cost_per_token += self.COST_ALPHA * (obs - self.cost_per_token)
        return evts

    def progress(self) -> str:
        return self.server.core.progress

    def stalled(self) -> bool:
        return self.server.core.stalled()

    def flush(self) -> None:
        self.server._route(self.server.core.flush())

    # ---- router gauges -------------------------------------------------------
    def outstanding_tokens(self) -> int:
        return self.server.core.outstanding_tokens()

    def load_cost(self) -> float:
        """Estimated seconds of token-work this replica still owes — the
        router's load signal (queue depth x predictor-estimated cost)."""
        return self.outstanding_tokens() * self.cost_per_token

    def class_ahead(self, max_rank: int) -> int:
        return self.server.core.class_queue_depth(max_rank)

    def now(self) -> float:
        return self.server.core.now()

    # ---- lifecycle / reporting -----------------------------------------------
    def close(self, drain_s: float = 30.0) -> Dict:
        return self.server.close(drain_s)

    def stats_snapshot(self) -> Dict:
        return self.server.stats_snapshot()


class EngineRouter:
    """Submit/cancel surface over N replicas with prefix-affine dispatch.

    ``policy`` is ``"prefix-affine"`` (directory match -> deepest holder,
    load-aware spillover, class-aware tie-break) or ``"round-robin"`` (the
    cache-blind baseline the bench compares against). The router owns the
    global rid space; replicas only ever see router-assigned rids.
    """

    def __init__(self, replicas: Sequence[LocalReplica],
                 policy: str = "prefix-affine",
                 spill_factor: float = 2.0,
                 directory: Optional[PrefixDirectory] = None):
        assert replicas, "router needs at least one replica"
        assert policy in POLICIES, f"policy {policy!r}; options: {POLICIES}"
        self.replicas = list(replicas)
        self.policy = policy
        self.spill_factor = float(spill_factor)
        ps = max((r.page_size for r in self.replicas), default=0)
        self.directory = directory or PrefixDirectory(max(ps, 1))
        for rep in self.replicas:
            rep.attach_directory(self.directory)
        self._next_rid = 0
        self._owner: Dict[int, int] = {}       # rid -> replica index
        self.handles: Dict[int, object] = {}
        self._rr = 0
        # placement accounting (the bench's imbalance metric reads these)
        self.routed = [0] * len(self.replicas)
        self.work_tokens = [0] * len(self.replicas)
        self.spills = 0                        # affine choice overridden
        self.affine_hits = 0                   # routed onto a directory holder

    # ---- placement -----------------------------------------------------------
    def _least_loaded(self, rank: int) -> int:
        """Cheapest replica; near-ties (within 25%) break by how much work at
        this SLO rank or more critical is already ahead, then by load, then
        by cumulative routed work (so an idle fleet still spreads — without
        it, every idle-tie lands on index 0 and serial traffic stacks one
        replica)."""
        loads = [rep.load_cost() for rep in self.replicas]
        lo = min(loads)
        cands = [i for i, l in enumerate(loads) if l <= lo * 1.25 + 1e-9]
        return min(cands, key=lambda i: (self.replicas[i].class_ahead(rank),
                                         loads[i], self.work_tokens[i], i))

    def _choose(self, prompt: np.ndarray, rank: int,
                est_tokens: int) -> Tuple[int, int]:
        """Pick a replica for ``prompt``; returns ``(index, matched_tokens)``
        where matched_tokens > 0 means the target already holds that much of
        the prefix."""
        n = len(self.replicas)
        if n == 1:
            return 0, 0
        if self.policy == "round-robin":
            i, self._rr = self._rr, (self._rr + 1) % n
            return i, 0
        # prefix-affine: deepest directory holder, unless saturated
        matched = self.directory.match(prompt, max_tokens=len(prompt) - 1)
        fallback = self._least_loaded(rank)
        if not matched:
            return fallback, 0
        best = max(matched, key=lambda i: (matched[i],
                                           -self.replicas[i].load_cost()))
        if best == fallback:
            return best, matched[best]
        rep = self.replicas[best]
        # net load if routed here: the hit saves `matched` prefill tokens
        eff = rep.load_cost() - matched[best] * rep.cost_per_token
        alt = self.replicas[fallback]
        alt_cost = alt.load_cost() + est_tokens * alt.cost_per_token
        if eff > self.spill_factor * alt_cost:
            self.spills += 1
            return fallback, 0
        return best, matched[best]

    def _place(self, req: Request, prompt: np.ndarray) -> int:
        idx, hit = self._choose(prompt, req.class_rank(),
                                req.prompt_len + req.max_output)
        self._owner[req.rid] = idx
        self.routed[idx] += 1
        self.work_tokens[idx] += req.prompt_len + req.max_output
        if hit > 0:
            self.affine_hits += 1
            self.directory.note_routed_hit(hit)
        return idx

    # ---- submission ----------------------------------------------------------
    def _alloc_rid(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        return rid

    def submit(self, prompt: Sequence[int], slo_class: str = "standard",
               max_output: int = 64, eos_id: Optional[int] = None,
               stop_ids: Tuple[int, ...] = (),
               rid: Optional[int] = None):
        """Route and submit a prompt; returns the target replica's stream
        handle (its ``tokens()`` pumps that replica)."""
        prompt = np.asarray(prompt, np.int32)
        rid = self._alloc_rid() if rid is None else rid
        self._next_rid = max(self._next_rid, rid + 1)
        # placement needs the request's class rank and size before the
        # Request object exists; resolve the class the same way submit() does
        rank = class_rank(slo_class)
        idx, hit = self._choose(prompt, rank, len(prompt) + max_output)
        self._owner[rid] = idx
        self.routed[idx] += 1
        self.work_tokens[idx] += len(prompt) + max_output
        if hit > 0:
            self.affine_hits += 1
            self.directory.note_routed_hit(hit)
        h = self.replicas[idx].server.submit(
            prompt, slo_class=slo_class, max_output=max_output,
            eos_id=eos_id, stop_ids=stop_ids, rid=rid)
        self.handles[rid] = h
        return h

    def submit_request(self, req: Request, prompt: Sequence[int]):
        """Route and submit a pre-built request (workload replay). The
        request's ``arrival`` is interpreted as *lateness-preserving*: it
        must already be on the target replica's clock or in the past —
        ``run_open_loop`` rebases it before calling here."""
        prompt = np.asarray(prompt, np.int32)
        self._next_rid = max(self._next_rid, req.rid + 1)
        idx = self._place(req, prompt)
        h = self.replicas[idx].submit_request(req, prompt)
        self.handles[req.rid] = h
        return h

    def cancel(self, rid: int) -> bool:
        idx = self._owner.get(rid)
        if idx is None:
            return False
        return self.replicas[idx].cancel(rid)

    def owner_of(self, rid: int) -> Optional[int]:
        return self._owner.get(rid)

    # ---- pumping -------------------------------------------------------------
    def has_work(self) -> bool:
        return any(rep.has_work() for rep in self.replicas)

    def step(self) -> List:
        """One round on every replica that has work; returns their events."""
        evts: List = []
        for rep in self.replicas:
            if rep.has_work():
                evts.extend(rep.step())
        return evts

    def subscribe(self, fn) -> None:
        """Event tap across all replicas (rids are globally unique, so one
        callback serves the whole fleet)."""
        for rep in self.replicas:
            rep.server.subscribe(fn)

    def run(self, max_wall_s: float = 600.0) -> None:
        """Pump every replica until the fleet drains (or the wall budget /
        a fleet-wide wedge stops it)."""
        t_end = time.perf_counter() + max_wall_s
        stall = 0
        while self.has_work() and time.perf_counter() < t_end:
            self.step()
            if any(rep.progress() == "executed" for rep in self.replicas
                   if rep.has_work()):
                stall = 0
                continue
            stall = stall + 1 if all(rep.stalled() or not rep.has_work()
                                     for rep in self.replicas) else 0
            if stall >= 8:
                break
            time.sleep(1e-3)
        for rep in self.replicas:
            rep.flush()

    def run_open_loop(self, requests: Sequence[Request],
                      prompts: Dict[int, np.ndarray],
                      max_wall_s: float = 300.0) -> Dict:
        """Open-loop replay across the fleet: submit each request at its
        wall-clock arrival offset (routing it then — placement must see the
        directory as it is at arrival time, not at workload build time) and
        pump every replica in between.

        Each replica runs its own engine clock, so arrivals are rebased
        per-placement preserving *lateness*: a request submitted ``d``
        seconds after its scheduled arrival lands with ``arrival = now - d``
        on its replica's clock, keeping queueing-time SLO accounting exactly
        as the single-engine driver measures it."""
        order = sorted(requests, key=lambda r: r.arrival)
        t0 = time.perf_counter()
        i = 0
        t_end = t0 + max_wall_s
        while i < len(order) and time.perf_counter() < t_end:
            now = time.perf_counter() - t0
            while i < len(order) and order[i].arrival <= now:
                r = order[i]
                lateness = now - r.arrival
                prompt = prompts[r.rid]
                idx = self._place(r, np.asarray(prompt, np.int32))
                r.arrival = self.replicas[idx].now() - lateness
                self.handles[r.rid] = self.replicas[idx].submit_request(
                    r, prompt)
                i += 1
            if i == len(order):
                break
            if not self.has_work():
                time.sleep(max(order[i].arrival - (time.perf_counter() - t0),
                               0.0) + 1e-4)
                continue
            self.step()
            if not any(rep.progress() == "executed"
                       for rep in self.replicas):
                time.sleep(1e-3)
        self.run(max_wall_s=max(t_end - time.perf_counter(), 0.0))
        finished = [h for h in self.handles.values()
                    if h.finished and not h.aborted]
        return {
            "handles": self.handles,
            "finished": finished,
            "unfinished": [h for h in self.handles.values()
                           if not h.finished],
            "wall": time.perf_counter() - t0,
        }

    # ---- lifecycle / reporting -----------------------------------------------
    def close(self, drain_s: float = 30.0) -> Dict:
        """Drain and close every replica (each verifies its pages/slots are
        fully reclaimed); returns the aggregated drain report."""
        reports = [rep.close(drain_s) for rep in self.replicas]
        return {
            "drained": all(r["drained"] for r in reports),
            "finished": sum(r["finished"] for r in reports),
            "aborted": sum(r["aborted"] for r in reports),
            "replicas": reports,
        }

    def routing_report(self) -> Dict:
        """Placement summary: per-replica routed counts and token work, the
        max/min work imbalance (the bench's headline metric), spill and
        affinity counters, and the directory's own accounting."""
        work = [max(w, 0) for w in self.work_tokens]
        lo = min(work) if work else 0
        hi = max(work) if work else 0
        return {
            "policy": self.policy,
            "replicas": len(self.replicas),
            "routed": list(self.routed),
            "work_tokens": list(work),
            "imbalance": (hi / lo) if lo > 0 else float("inf") if hi else 1.0,
            "spills": self.spills,
            "affine_hits": self.affine_hits,
            "directory": self.directory.stats(),
        }

    def stats_snapshot(self) -> Dict:
        return {
            "routing": self.routing_report(),
            "replicas": [rep.stats_snapshot() for rep in self.replicas],
        }
