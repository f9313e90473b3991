"""Synthetic workloads matched to the paper's Table 2 statistics.

The paper uses ShareGPT (dialogue) and two arXiv-summarization subsets; those
HF datasets are not available offline, so we synthesize length distributions
whose (mean, P90) match Table 2 exactly:

    dataset     prompt mean/P90     output mean/P90     SLO class
    sharegpt      357 / 1724          89 / 184          dialogue
    arxiv-v1     3253 / 4382         356 / 542          summarization
    arxiv-v2     6267 / 7567         423 / 623          summarization
    mixed-v1     sharegpt : arxiv-v1 = 3 : 1
    mixed-v2     sharegpt : arxiv-v2 = 5 : 1

Lognormal when a single lognormal can hit both moments; otherwise (ShareGPT
prompts, whose P90/mean ratio exceeds any lognormal's) a two-component
lognormal mixture fit by moment matching. SLOs follow Table 3: TTFT is a max
*slowdown* over exclusive service, TBT a fixed per-token bound.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.costmodel import CostModel
from repro_torch.serving.request import Request

Z90 = 1.2815515655446004

TABLE2 = {
    "sharegpt": {"prompt": (357, 1724), "output": (89, 184), "slo": "dialogue"},
    "arxiv-v1": {"prompt": (3253, 4382), "output": (356, 542), "slo": "summarization"},
    "arxiv-v2": {"prompt": (6267, 7567), "output": (423, 623), "slo": "summarization"},
}
MIXES = {
    "mixed-v1": (("sharegpt", 3), ("arxiv-v1", 1)),
    "mixed-v2": (("sharegpt", 5), ("arxiv-v2", 1)),
}
# Table 3.
SLOS = {
    "dialogue": {"ttft_slowdown": 5.0, "tbt": 0.040},
    "summarization": {"ttft_slowdown": 10.0, "tbt": 0.080},
}
DATASETS = tuple(TABLE2) + tuple(MIXES)


def _lognormal_params(mean: float, p90: float) -> Optional[Tuple[float, float]]:
    """(mu, sigma) matching mean & p90, or None if infeasible."""
    L = math.log(mean / p90)
    disc = Z90 * Z90 + 2 * L
    if disc < 0:
        return None
    sigma = Z90 - math.sqrt(disc)
    mu = math.log(mean) - sigma * sigma / 2
    return mu, sigma


def _mixture_params(mean: float, p90: float,
                    sigma_s: float = 0.55, sigma_l: float = 0.35):
    """Two-lognormal mixture: a short body + a long tail near/above P90.

    Solved by scanning the tail weight q and tail location; short-component
    mean follows from the total-mean constraint; q is picked so the P90
    matches (tail mass just under 10% puts P90 at the tail's lower edge).
    """
    best = None
    for q in np.linspace(0.02, 0.20, 37):
        for m_l in np.linspace(p90, 4 * p90, 25):
            m_s = (mean - q * m_l) / (1 - q)
            if m_s <= 1:
                continue
            mu_s = math.log(m_s) - sigma_s ** 2 / 2
            mu_l = math.log(m_l) - sigma_l ** 2 / 2
            # numeric P90 of the mixture
            xs = np.exp(np.linspace(math.log(4), math.log(30 * p90), 512))
            from math import erf, sqrt
            cdf = (1 - q) * 0.5 * (1 + np.vectorize(erf)((np.log(xs) - mu_s) / (sigma_s * sqrt(2)))) \
                + q * 0.5 * (1 + np.vectorize(erf)((np.log(xs) - mu_l) / (sigma_l * sqrt(2))))
            p90_hat = float(np.interp(0.9, cdf, xs))
            err = abs(p90_hat - p90) / p90
            if best is None or err < best[0]:
                best = (err, q, mu_s, sigma_s, mu_l, sigma_l)
    return best[1:]


class LengthSampler:
    def __init__(self, mean: float, p90: float, lo: int = 4, hi: Optional[int] = None):
        self.lo, self.hi = lo, hi or int(20 * p90)
        ln = _lognormal_params(mean, p90)
        if ln is not None:
            self.kind = "lognormal"
            self.params = ln
        else:
            self.kind = "mixture"
            self.params = _mixture_params(mean, p90)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "lognormal":
            mu, sigma = self.params
            x = rng.lognormal(mu, sigma, n)
        else:
            q, mu_s, sig_s, mu_l, sig_l = self.params
            tail = rng.random(n) < q
            x = np.where(tail, rng.lognormal(mu_l, sig_l, n), rng.lognormal(mu_s, sig_s, n))
        return np.clip(x, self.lo, self.hi).astype(int)


@dataclasses.dataclass
class WorkloadSpec:
    dataset: str
    qps: float
    duration: float
    seed: int = 0


def make_workload(spec: WorkloadSpec, cost_model: CostModel) -> List[Request]:
    """Poisson arrivals with Table-2 lengths and Table-3 SLOs."""
    rng = np.random.default_rng(spec.seed)
    components: List[Tuple[str, float]] = []
    if spec.dataset in TABLE2:
        components = [(spec.dataset, 1.0)]
    elif spec.dataset in MIXES:
        total = sum(w for _, w in MIXES[spec.dataset])
        components = [(name, w / total) for name, w in MIXES[spec.dataset]]
    else:
        raise KeyError(f"unknown dataset {spec.dataset!r}; options: {DATASETS}")

    samplers = {
        name: (LengthSampler(*TABLE2[name]["prompt"]),
               LengthSampler(*TABLE2[name]["output"], lo=1))
        for name, _ in components
    }

    n_est = int(spec.qps * spec.duration * 1.2) + 16
    inter = rng.exponential(1.0 / spec.qps, n_est)
    arrivals = np.cumsum(inter)
    arrivals = arrivals[arrivals < spec.duration]

    names = [c[0] for c in components]
    probs = [c[1] for c in components]
    reqs: List[Request] = []
    for i, a in enumerate(arrivals):
        name = names[int(rng.choice(len(names), p=probs))]
        p_len = int(samplers[name][0].sample(rng, 1)[0])
        o_len = int(samplers[name][1].sample(rng, 1)[0])
        slo = SLOS[TABLE2[name]["slo"]]
        excl = cost_model.exclusive_prefill_time(p_len)
        reqs.append(Request(
            rid=i, arrival=float(a), prompt_len=p_len, max_output=o_len,
            ttft_slo=slo["ttft_slowdown"] * excl, tbt_slo=slo["tbt"],
            slo_class=TABLE2[name]["slo"], exclusive_ttft=excl,
        ))
    return reqs


# ---------------------------------------------------------------------------
# prefix-sharing scenarios (radix prefix cache: shared system prompts and
# multi-turn chat; these need real token ids, so they return prompts too)
# ---------------------------------------------------------------------------
def make_shared_prefix_workload(n: int, vocab_size: int, *,
                                system_len: int = 96, unique_len: int = 32,
                                max_output: int = 6, qps: float = 0.0,
                                slo_class: str = "standard",
                                ttft_slo: float = 60.0, tbt_slo: float = 60.0,
                                seed: int = 0, rid0: int = 0
                                ) -> Tuple[List[Request], Dict[int, np.ndarray]]:
    """The production shared-system-prompt scenario: ``n`` requests whose
    prompts share one ``system_len``-token prefix and differ only in a
    ``unique_len``-token suffix (few-shot templates, RAG headers, agent
    system prompts). With the engine's prefix cache on, every request after
    the first should prefill only its suffix plus the shared prefix's
    partial tail page. ``qps=0`` arrives everything at t=0 (a burst);
    otherwise arrivals are Poisson. Returns ``(requests, prompts)``."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab_size, system_len).astype(np.int32)
    arrivals = (np.zeros(n) if qps <= 0
                else np.cumsum(rng.exponential(1.0 / qps, n)))
    reqs, prompts = [], {}
    for i in range(n):
        rid = rid0 + i
        suffix = rng.integers(1, vocab_size, unique_len).astype(np.int32)
        prompts[rid] = np.concatenate([system, suffix])
        reqs.append(Request(rid=rid, arrival=float(arrivals[i]),
                            prompt_len=system_len + unique_len,
                            max_output=max_output, ttft_slo=ttft_slo,
                            tbt_slo=tbt_slo, slo_class=slo_class))
    return reqs, prompts


def make_router_workload(vocab_size: int, *, n_shared: int = 10,
                         system_len: int = 96, unique_len: int = 24,
                         shared_output: int = 6, n_batch: int = 4,
                         batch_prompt: int = 120, batch_output: int = 12,
                         heavy_prompt: int = 400, heavy_output: int = 48,
                         gap_s: float = 0.2, seed: int = 0
                         ) -> Tuple[List[Request], Dict[int, np.ndarray]]:
    """The multi-replica routing scenario: a **shared-prefix interactive
    stream** riding next to **background batch work**, shaped so the two
    routing policies separate.

    One heavy batch request arrives first (token mass a count-based router
    cannot compensate for), then ``n_shared`` interactive requests sharing a
    ``system_len``-token prefix arrive at ``gap_s`` spacing (the spacing
    lets the first one commit its pages before the rest route, so the
    directory steers the whole stream to one replica where all but the
    first prefill only their suffix), then ``n_batch`` medium batch
    requests arrive last — free mass a load-aware router places opposite
    the heavy request. Round-robin spreads the shared prefix across
    replicas (each pays its own cold prefill) and stacks the heavy request
    with half the stream regardless of cost; prefix-affine concentrates
    the (cheap, cached) stream on one replica and levels the rest by
    measured load — which is exactly the computed-token imbalance gap
    ``bench_goodput --replicas`` measures. Returns ``(requests, prompts)``."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab_size, system_len).astype(np.int32)
    reqs: List[Request] = []
    prompts: Dict[int, np.ndarray] = {}
    rid = 0

    def add(prompt: np.ndarray, arrival: float, max_output: int,
            slo_class: str) -> None:
        nonlocal rid
        prompts[rid] = prompt
        reqs.append(Request(rid=rid, arrival=arrival,
                            prompt_len=len(prompt), max_output=max_output,
                            ttft_slo=60.0, tbt_slo=60.0,
                            slo_class=slo_class))
        rid += 1

    add(rng.integers(1, vocab_size, heavy_prompt).astype(np.int32),
        0.0, heavy_output, "batch")
    t = gap_s
    for _ in range(n_shared):
        suffix = rng.integers(1, vocab_size, unique_len).astype(np.int32)
        add(np.concatenate([system, suffix]), t, shared_output,
            "interactive")
        t += gap_s
    for _ in range(n_batch):
        add(rng.integers(1, vocab_size, batch_prompt).astype(np.int32),
            t, batch_output, "batch")
        t += gap_s
    return reqs, prompts


def multiturn_followup(prompt: np.ndarray, output_ids: Sequence[int],
                       rng: np.random.Generator, vocab_size: int,
                       turn_len: int = 24) -> np.ndarray:
    """Next-turn prompt of a chat conversation: the full transcript so far
    (previous prompt + generated reply) plus a fresh ``turn_len``-token user
    turn. Submitted against a warm prefix cache, everything but the new turn
    (and the transcript's partial tail page) should match frozen pages —
    including pages frozen *during decode* of the previous turn."""
    turn = rng.integers(1, vocab_size, turn_len).astype(np.int32)
    return np.concatenate([np.asarray(prompt, np.int32),
                           np.asarray(list(output_ids), np.int32), turn])


# ---------------------------------------------------------------------------
# open-loop live-arrival driver (streaming frontend)
# ---------------------------------------------------------------------------
def run_open_loop(server, requests: Sequence[Request],
                  prompts: Optional[Dict[int, np.ndarray]] = None,
                  max_wall_s: float = 300.0, seed: int = 0) -> Dict:
    """Replay a workload through an :class:`InferenceServer` the way live
    traffic hits a deployment: **open-loop** — each request is submitted at
    its wall-clock ``arrival`` offset regardless of how far the engine has
    gotten (arrivals never wait on completions), and the server is pumped in
    between so admitted work streams continuously.

    This is the live-arrival counterpart of ``EngineCore.serve``: ``serve``
    hands the engine the complete schedule up front (offline replay), while
    this driver only reveals each request when its arrival time passes —
    exactly what the streaming submit API experiences in production.

    SLO clocks run from each request's *scheduled* arrival (``t0 +
    r.arrival`` on the engine clock), not from when this loop got around to
    submitting it — submission delay counts as queueing time, exactly as
    offline ``serve()`` measures it.

    The request objects are **consumed**: their runtime state advances and
    ``arrival`` is rewritten onto the engine clock. Rebuild the workload
    list to replay it (as ``bench_goodput`` does); re-passing the same
    objects would compound the arrival rebase.

    Returns ``{"handles", "finished", "unfinished", "wall", "events"}``;
    per-request tokens are on each handle (``handle.collected``).
    """
    rng = np.random.default_rng(seed)
    vocab = server.core.cfg.vocab_size
    prompts = prompts or {
        r.rid: rng.integers(0, vocab, r.prompt_len).astype(np.int32)
        for r in requests
    }
    order = sorted(requests, key=lambda r: r.arrival)
    t0 = server.core.now()
    n_ev0 = len(server.events)
    handles: Dict[int, object] = {}
    i = 0
    t_end = time.perf_counter() + max_wall_s
    while i < len(order) and time.perf_counter() < t_end:
        now = server.core.now() - t0
        while i < len(order) and order[i].arrival <= now:
            r = order[i]
            r.arrival = t0 + r.arrival   # workload offset -> engine clock
            handles[r.rid] = server.submit_request(r, prompts[r.rid])
            i += 1
        if i == len(order):
            break
        if not server.core.has_work():
            # nothing to run yet: sleep the gap to the next arrival
            time.sleep(max(order[i].arrival - (server.core.now() - t0), 0.0)
                       + 1e-4)
            continue
        server.step()
        if server.core.progress != "executed":
            # bounded yield so the arrival scan stays responsive (unlike
            # server.run(), arrivals here are revealed by *this* loop)
            time.sleep(1e-3)
    # drain: no more arrivals; server.run finishes what the engine holds
    # (its stall guard stops a wedged queue from spinning to the wall clock)
    server.run(max_wall_s=max(t_end - time.perf_counter(), 0.0))
    finished = [h for h in handles.values()
                if h.finished and not h.aborted]
    return {
        "handles": handles,
        "finished": finished,
        "unfinished": [h for h in handles.values() if not h.finished],
        "wall": server.core.now() - t0,
        "events": server.events[n_ev0:],
    }


def run_open_loop_http(client, requests: Sequence[Request],
                       prompts: Dict[int, np.ndarray],
                       max_wall_s: float = 300.0) -> Dict:
    """Open-loop replay against a **network** front door: each request is
    POSTed to ``/v1/generate`` at its wall-clock arrival offset and its SSE
    stream is consumed on a reader thread (the blocking client needs one
    reader per in-flight stream; the server itself stays single-threaded).

    The HTTP counterpart of :func:`run_open_loop` — the engine runs in the
    server process, so this driver only paces arrivals and collects tokens.
    ``client`` is a ``repro_torch.frontend.client.EngineHttpClient``. Returns
    ``{"handles", "finished", "unfinished", "wall"}`` keyed by *workload*
    rid (the server assigns its own rids; ``handle.rid`` has the remote
    one)."""
    import threading

    order = sorted(requests, key=lambda r: r.arrival)
    t0 = time.perf_counter()
    t_end = t0 + max_wall_s
    handles: Dict[int, object] = {}
    readers: List[threading.Thread] = []
    for r in order:
        wait = r.arrival - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(min(wait, max(t_end - time.perf_counter(), 0.0)))
        if time.perf_counter() >= t_end:
            break
        h = client.generate(prompts[r.rid].tolist(),
                            slo_class=r.slo_class, max_output=r.max_output,
                            eos_id=r.eos_id, stop_ids=r.stop_ids)
        handles[r.rid] = h
        th = threading.Thread(target=h.result, daemon=True)
        th.start()
        readers.append(th)
    for th in readers:
        th.join(timeout=max(t_end - time.perf_counter(), 0.0))
    finished = [h for h in handles.values()
                if h.finished and not h.aborted]
    return {
        "handles": handles,
        "finished": finished,
        "unfinished": [h for h in handles.values() if not h.finished],
        "wall": time.perf_counter() - t0,
    }
