"""Unified request model with SLO constraints (paper §2.1).

TTFT/TBT are modeled exactly as the paper does: TBT is a set of *per-token
deadlines* (Eq. 1): the (k+1)-th output token of request i is due at

    d_{i,k+1} = a_i + L_ttft + k * L_tbt.

TTFT SLOs in the evaluation are specified as *max TTFT slowdown* relative to
exclusive service (paper Table 3), so ``ttft_slo`` is materialized per request
as ``slowdown * exclusive_prefill_time`` by the workload generator.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class ReqState(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    ABORTED = "aborted"          # cancelled by the client (EngineCore.abort)


# Admission/eviction rank of the named SLO classes (lower = more
# latency-critical). The engine admits lower ranks first (FIFO preserved
# within a class) and never evicts a lower-rank owner to grow a higher-rank
# request — concretely: never evict ``interactive`` to grow ``batch``.
# Unknown/legacy class names rank with ``standard`` so single-class
# workloads behave exactly as before.
SLO_CLASS_RANK = {
    "interactive": 0,
    "dialogue": 1,        # the paper's dataset-derived classes
    "standard": 1,
    "summarization": 2,
    "batch": 2,
}
DEFAULT_CLASS_RANK = 1


def class_rank(name: str) -> int:
    return SLO_CLASS_RANK.get(name, DEFAULT_CLASS_RANK)


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    prompt_len: int
    max_output: int
    ttft_slo: float                  # seconds from arrival to first token
    tbt_slo: float                   # seconds between subsequent tokens
    guard: bool = False              # safeguard flag g_i (paper §3.3)
    slo_class: str = "dialogue"
    # stop-token termination: generation ends early when the sampled token is
    # ``eos_id`` or any member of ``stop_ids`` (the stop token itself is the
    # final emitted token). ``max_output`` stays the hard length cap. The
    # engine checks these against the token ids of its one deferred readback
    # per round, so stop termination adds no device→host sync.
    eos_id: Optional[int] = None
    stop_ids: Tuple[int, ...] = ()

    # --- runtime state -------------------------------------------------------
    state: ReqState = ReqState.WAITING
    prefilled: int = 0               # c_i(t): prompt tokens already computed
    cached_prefix: int = 0           # prompt tokens served by the prefix cache
                                     # at admission (counted inside prefilled)
    generated: int = 0               # output tokens emitted
    recomputed: int = 0              # emitted tokens folded into the prompt by
                                     # evict-and-recompute (still in generated)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    exclusive_ttft: float = 0.0      # prefill time under exclusive service

    # ---- paper quantities ---------------------------------------------------
    def remaining_prefill(self) -> int:
        """r_i(t) = p_i - c_i(t)  (Eq. 7)."""
        return self.prompt_len - self.prefilled

    def ttft_deadline(self) -> float:
        return self.arrival + self.ttft_slo

    def ttft_slack(self, t: float) -> float:
        """s_i(t) = a_i + L_ttft - t  (Eq. 8)."""
        return self.ttft_deadline() - t

    def token_deadline(self, k: int) -> float:
        """Deadline of the k-th output token, k >= 1  (Eq. 1)."""
        return self.arrival + self.ttft_slo + (k - 1) * self.tbt_slo

    def next_token_deadline(self) -> float:
        return self.token_deadline(self.generated + 1)

    def decode_slack(self, t: float) -> float:
        return self.next_token_deadline() - t

    def sched_decode_slack(self, t: float) -> float:
        """Slack used for *scheduling* (not metrics): once a request has
        fallen behind its absolute Eq.-1 schedule, the recoverable target is
        one TBT after its last emitted token — otherwise a single late token
        would pin the whole system's iteration window at ~0 forever."""
        d = self.next_token_deadline()
        if self.token_times:
            d = max(d, self.token_times[-1] + self.tbt_slo)
        return d - t

    # ---- lifecycle ----------------------------------------------------------
    def context_len(self) -> int:
        """u_i: tokens already computed & cached. Tokens an eviction folded
        into the prompt would otherwise be counted by both ``prefilled`` and
        ``generated``."""
        return self.prefilled + self.generated - self.recomputed

    def is_decoding(self) -> bool:
        return self.state == ReqState.DECODING

    def class_rank(self) -> int:
        """Admission/eviction rank of this request's SLO class (lower = more
        latency-critical; see :data:`SLO_CLASS_RANK`)."""
        return class_rank(self.slo_class)

    def hits_stop(self, token: int) -> bool:
        """True when ``token`` terminates generation (EOS / stop set)."""
        return ((self.eos_id is not None and token == self.eos_id)
                or token in self.stop_ids)

    def ttft_violated(self, t: float) -> bool:
        if self.first_token_time is not None:
            return self.first_token_time > self.ttft_deadline()
        return t > self.ttft_deadline()

    def advance_prefill(self, n: int) -> None:
        self.prefilled += n
        assert self.prefilled <= self.prompt_len, (self.rid, self.prefilled, self.prompt_len)
        if self.state == ReqState.WAITING:
            self.state = ReqState.PREFILLING

    def emit_token(self, t: float) -> None:
        self.generated += 1
        self.token_times.append(t)
        if self.first_token_time is None:
            self.first_token_time = t
        self.state = ReqState.DECODING
        if self.generated >= self.max_output:
            self.state = ReqState.FINISHED
            self.finish_time = t

    # ---- SLO accounting (used by metrics) -----------------------------------
    def violations(self) -> dict:
        """Counts of missed deadlines for this (finished or not) request."""
        ttft_miss = (self.first_token_time is None
                     or self.first_token_time > self.ttft_deadline() + 1e-9)
        tbt_misses = sum(
            1 for k, tt in enumerate(self.token_times[1:], start=2)
            if tt > self.token_deadline(k) + 1e-9
        )
        return {
            "ttft_miss": int(ttft_miss),
            "tbt_misses": tbt_misses,
            "violated": int(ttft_miss or tbt_misses > 0),
        }
