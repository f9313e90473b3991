"""Streaming inference frontend over the step-based :class:`EngineCore`.

``InferenceServer`` is the online entry point the paper's setting actually
needs: requests **arrive continuously** (``submit`` at any time, no upfront
request list), tokens **stream incrementally** to each caller
(``handle.tokens()`` yields ids as the engine's per-round readbacks surface
them), and requests **leave early** (``handle.cancel()`` frees KV pages /
slots mid-prefill or mid-decode). Tenants are mixed in one engine through
named **SLO classes** — ``interactive`` / ``standard`` / ``batch`` — each a
(ttft, tbt) deadline pair the scheduler's MLPS sorter and violation checker
consume, so one paged KV pool serves chatbots next to offline summarizers.

The server is cooperative and single-threaded, like the engine itself: every
``step()``/``run()``/``tokens()`` call pumps ``EngineCore.step()`` and routes
the returned :class:`EngineEvent` stream into per-request handles. Nothing
here syncs with the device beyond the engine's one deferred readback per
round — streaming keeps the zero-sync hot path intact (token events simply
surface one round after dispatch).

    server = InferenceServer.build(cfg, cache_mode="paged")
    h = server.submit(prompt_ids, slo_class="interactive", max_output=32)
    for tok in h.tokens():      # pumps the engine; yields ids incrementally
        ...
    h2.cancel()                 # aborts; pages return to the BlockAllocator
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import SlidingServeScheduler
from repro_torch.serving.engine import EngineCore, EngineEvent, EventKind
from repro_torch.serving.request import ReqState, Request


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A named tenant class: deadlines every request of the class inherits.

    ``ttft_slo`` seconds from arrival to the first token, ``tbt_slo`` seconds
    between subsequent tokens (paper Eq. 1 per-token deadlines)."""

    name: str
    ttft_slo: float
    tbt_slo: float


# Default tenant classes. The paper's Table-3 workload SLOs (``dialogue``,
# ``summarization``) are *dataset*-derived; these are the serving-facing
# knobs an operator names at submit time.
SLO_CLASSES: Dict[str, SLOClass] = {
    "interactive": SLOClass("interactive", ttft_slo=1.0, tbt_slo=0.05),
    "standard": SLOClass("standard", ttft_slo=5.0, tbt_slo=0.25),
    "batch": SLOClass("batch", ttft_slo=60.0, tbt_slo=2.0),
}


class StreamHandle:
    """One submitted request's streaming view.

    ``tokens()`` is an incremental iterator fed by the engine's TOKEN events:
    it yields ids already buffered, and when the buffer runs dry it pumps the
    server until more arrive or the request finishes. ``cancel()`` aborts the
    request (idempotent; buffered tokens remain readable)."""

    def __init__(self, server: "InferenceServer", request: Request):
        self._server = server
        self.request = request
        self.rid = request.rid
        self.collected: List[int] = []     # every token id received so far
        self._buf: collections.deque = collections.deque()
        self.finished = False
        self.finish_reason = ""            # "length" | "stop" | "aborted"
        self.first_token_t: Optional[float] = None

    # ---- event sink (called by the server's router) -------------------------
    def _on_event(self, ev: EngineEvent) -> None:
        if ev.kind in (EventKind.FIRST_TOKEN, EventKind.TOKEN):
            if ev.kind is EventKind.FIRST_TOKEN:
                self.first_token_t = ev.t
            self.collected.append(ev.token)
            self._buf.append(ev.token)
        elif ev.kind is EventKind.FINISHED:
            self.finished = True
            self.finish_reason = ev.reason or "length"
        elif ev.kind is EventKind.ABORTED:
            self.finished = True
            self.finish_reason = "aborted"

    # ---- client surface ------------------------------------------------------
    @property
    def aborted(self) -> bool:
        return self.finish_reason == "aborted"

    def cancel(self) -> None:
        self._server.cancel(self.rid)

    def poll(self) -> List[int]:
        """Non-blocking drain of tokens already routed to this handle — no
        engine pumping, no waiting (the HTTP transport and the router pump
        the engine from one place and poll handles from another)."""
        out: List[int] = []
        while self._buf:
            out.append(self._buf.popleft())
        return out

    def tokens(self, max_wall_s: float = 600.0) -> Iterator[int]:
        """Yield output token ids as they stream in, pumping the engine while
        waiting. Returns when the request finishes (length / stop / cancel);
        raises TimeoutError if the engine cannot produce progress in time and
        RuntimeError if the request can never be admitted (wedged queue)."""
        deadline = time.perf_counter() + max_wall_s
        stall = 0
        while True:
            while self._buf:
                yield self._buf.popleft()
            if self.finished:
                return
            if time.perf_counter() > deadline:
                raise TimeoutError(f"rid {self.rid}: no progress")
            core = self._server.core
            self._server.step()
            if core.stalled():
                # nothing can progress (queue won't fit / request outgrew
                # capacity): fail fast instead of busy-polling the budget
                stall += 1
                if stall >= 8:
                    raise RuntimeError(
                        f"rid {self.rid}: engine wedged (work cannot be "
                        f"admitted or fit — prompt larger than the KV pool?)")
            else:
                stall = 0
            if not self._buf and not self.finished:
                self._server._idle_wait()

    def result(self, max_wall_s: float = 600.0) -> List[int]:
        """Block until finished; returns the complete output id list."""
        for _ in self.tokens(max_wall_s):
            pass
        return list(self.collected)


class InferenceServer:
    """Submit/cancel frontend driving ``EngineCore.step()``.

    One server wraps one engine. ``submit`` assigns rids, stamps arrivals on
    the engine clock, and maps an :data:`SLO_CLASSES` name onto the request's
    (ttft, tbt) deadlines; ``step``/``run`` pump the engine and fan events
    out to handles.

    Lifetime note: finished handles (with their token lists) and the
    ``events`` log are retained for inspection — per-run drivers and
    benchmarks read them after the fact. A service wrapper holding one
    server for days should ``release(rid)`` handles it has consumed and
    truncate ``events`` periodically; the engine frees the expensive state
    (KV pages, prompt arrays) at retirement on its own."""

    def __init__(self, core: EngineCore,
                 slo_classes: Optional[Dict[str, SLOClass]] = None):
        self.core = core
        self.slo_classes = dict(slo_classes or SLO_CLASSES)
        self.handles: Dict[int, StreamHandle] = {}
        self.events: List[EngineEvent] = []    # full event log (diagnostics)
        self._next_rid = 0
        self._subscribers: List = []           # event taps (HTTP transport)
        self._draining = False                 # close() in progress/complete
        self._close_report: Optional[Dict] = None

    def subscribe(self, fn) -> None:
        """Register an event tap: ``fn(event)`` is called for every routed
        :class:`EngineEvent`, in order, from whichever thread pumps the
        server. The HTTP transport uses this to feed per-request SSE queues
        without polling handles."""
        self._subscribers.append(fn)

    def has_work(self) -> bool:
        return self.core.has_work()

    @classmethod
    def build(cls, cfg, scheduler=None, slo_classes=None, **engine_kw
              ) -> "InferenceServer":
        """Convenience constructor: engine + default SlidingServe scheduler."""
        sched = scheduler or SlidingServeScheduler(max_budget=512,
                                                   max_iter_time=2.0)
        return cls(EngineCore(cfg, sched, **engine_kw),
                   slo_classes=slo_classes)

    # ---- submission ----------------------------------------------------------
    def submit(self, prompt: Sequence[int], slo_class: str = "standard",
               max_output: int = 64, eos_id: Optional[int] = None,
               stop_ids: Tuple[int, ...] = (),
               rid: Optional[int] = None) -> StreamHandle:
        """Submit a prompt under a named SLO class; returns its stream handle.
        The request arrives *now* on the engine clock — deadlines run from
        this call. ``rid`` pins an externally assigned request id (the
        multi-replica router owns the global id space); default is the
        server's own counter."""
        cls = self.slo_classes[slo_class]
        prompt = np.asarray(prompt, np.int32)
        req = Request(rid=self._alloc_rid() if rid is None else rid,
                      arrival=self.core.now(),
                      prompt_len=len(prompt), max_output=max_output,
                      ttft_slo=cls.ttft_slo, tbt_slo=cls.tbt_slo,
                      slo_class=cls.name, eos_id=eos_id,
                      stop_ids=tuple(stop_ids))
        return self.submit_request(req, prompt)

    def submit_request(self, req: Request, prompt: Sequence[int]
                       ) -> StreamHandle:
        """Submit a pre-built :class:`Request` (workload replay: the request
        carries its own SLOs and an engine-clock ``arrival``). A *past*
        arrival is kept — SLO clocks then run from the scheduled arrival, so
        submission delay counts as queueing time exactly as ``serve()``
        measures it; a future arrival is clamped to now (the streaming API
        has no scheduled future — submit when the request exists)."""
        if self._draining:
            raise RuntimeError("InferenceServer is draining/closed: "
                               "no new admissions")
        req.arrival = min(req.arrival, self.core.now())
        self._next_rid = max(self._next_rid, req.rid + 1)
        handle = StreamHandle(self, req)
        self.handles[req.rid] = handle
        self.core.add_request(req, prompt)
        return handle

    def _alloc_rid(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        return rid

    def release(self, rid: int) -> None:
        """Forget a finished/aborted handle (long-running servers call this
        after consuming a stream so handle memory doesn't accumulate)."""
        h = self.handles.get(rid)
        if h is not None and h.finished:
            del self.handles[rid]

    # ---- engine pumping ------------------------------------------------------
    def cancel(self, rid: int) -> bool:
        """Abort ``rid`` (frees its KV pages / slot). True if it was live."""
        h = self.handles.get(rid)
        was_live = h is not None and not h.finished
        self._route(self.core.abort(rid))
        return was_live and h.finished

    def step(self) -> List[EngineEvent]:
        """One engine round; routes and returns its events."""
        evts = self.core.step()
        self._route(evts)
        return evts

    def _route(self, evts: List[EngineEvent]) -> None:
        self.events.extend(evts)
        for ev in evts:
            h = self.handles.get(ev.rid)
            if h is not None:
                h._on_event(ev)
            for fn in self._subscribers:
                fn(ev)

    def _idle_wait(self) -> None:
        """Pacing between unproductive rounds, mirroring serve(): wait for
        the next scheduled arrival when idle, yield briefly otherwise."""
        p = self.core.progress
        if p == "executed":
            return
        nxt = self.core.next_arrival()
        if p == "idle" and nxt is not None:
            time.sleep(max(nxt - self.core.now(), 0.0) + 1e-4)
        else:
            time.sleep(1e-3)

    def run(self, max_wall_s: float = 600.0) -> List[EngineEvent]:
        """Drive the engine until it drains (or the wall budget expires);
        returns the events of this run segment."""
        n0 = len(self.events)
        t_end = time.perf_counter() + max_wall_s
        stall = 0
        while self.core.has_work() and time.perf_counter() < t_end:
            self.step()
            if self.core.progress == "executed":
                stall = 0
                continue
            # wedge guard (the engine's shared predicate, as serve() uses):
            # unprogressable work must not spin to the wall clock.
            stall = stall + 1 if self.core.stalled() else 0
            if stall >= 8:
                break
            self._idle_wait()
        # abnormal exits (wall budget, wedge) can leave the last dispatched
        # round unread; settle it so its tokens reach the handles.
        self._route(self.core.flush())
        return self.events[n0:]

    # ---- graceful shutdown ---------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining

    def close(self, drain_s: float = 30.0) -> Dict:
        """Graceful shutdown: stop admitting, drain in-flight requests to
        completion (or the ``drain_s`` deadline), then abort stragglers —
        with KV pages / slots verifiably reclaimed either way. Idempotent;
        returns ``{"drained", "finished", "aborted"}``. After close, every
        handle is settled (finished or aborted) and ``submit`` raises."""
        if self._close_report is not None:
            return self._close_report
        self._draining = True
        t_end = time.perf_counter() + max(drain_s, 0.0)
        stall = 0
        while self.core.has_work() and time.perf_counter() < t_end:
            self.step()
            if self.core.progress == "executed":
                stall = 0
                continue
            stall = stall + 1 if self.core.stalled() else 0
            if stall >= 8:
                break               # wedged: fall through to the abort sweep
            self._idle_wait()
        self._route(self.core.flush())
        stragglers = [rid for rid, h in self.handles.items()
                      if not h.finished]
        for rid in stragglers:
            self.cancel(rid)
        # every page/slot must be back in the pool — a leak here would stay
        # invisible until the *next* deployment's admissions start failing.
        core = self.core
        if core.cache_mode == "paged":
            assert core.alloc.free_blocks == core.alloc.num_blocks, \
                "close(): KV pages leaked past drain+abort"
            core.alloc.check_invariants()
        else:
            assert len(core.free_slots) == core.max_slots, \
                "close(): slots leaked past drain+abort"
        self._close_report = {
            "drained": not stragglers,
            "finished": sum(1 for h in self.handles.values()
                            if h.finished and not h.aborted),
            "aborted": len(stragglers),
        }
        return self._close_report

    # ---- reporting -----------------------------------------------------------
    def summary(self) -> Dict:
        from repro_torch.serving.metrics import summarize_by_class
        reqs = [h.request for h in self.handles.values()]
        fin = [r for r in reqs if r.state == ReqState.FINISHED]
        return {
            "submitted": len(reqs),
            "finished": len(fin),
            "aborted": sum(1 for r in reqs if r.state == ReqState.ABORTED),
            "violations": sum(r.violations()["violated"] for r in fin),
            "per_class": summarize_by_class(reqs, max(self.core.now(), 1e-9)),
            "stats": self.core.stats,
        }

    def stats_snapshot(self) -> Dict:
        """JSON-able operational snapshot (the HTTP ``GET /v1/stats`` body):
        EngineStats counters, prefix-cache accounting, per-class metrics and
        live queue/outstanding-work gauges."""
        core = self.core
        summ = self.summary()
        return {
            "engine": dataclasses.asdict(summ.pop("stats")),
            "cache_info": core.cache_info(),
            "sharding": core.shard_info(),
            "queue_depth": core.queue_depth,
            "outstanding_tokens": core.outstanding_tokens(),
            "draining": self._draining,
            **summ,
        }
