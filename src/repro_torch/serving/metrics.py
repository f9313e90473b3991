"""SLO metrics: violation rates, latency percentiles, goodput (paper §5).

Goodput follows the paper's definition: requests served per second while
meeting latency targets, allowing at most ``violation_cap`` (1%) of requests
to violate their SLO; the *maximum* goodput is found by searching QPS.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.request import Request


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else math.nan


def summarize(requests: Sequence[Request], duration: float) -> Dict:
    done = [r for r in requests if r.first_token_time is not None]
    viol = [r.violations() for r in requests]
    ttft = [r.first_token_time - r.arrival for r in done]
    e2e = [r.finish_time - r.arrival for r in requests if r.finish_time is not None]
    # Dimensionless TTFT slowdown: measured TTFT over the request's
    # exclusive-service prefill time. Only requests whose generator stamped
    # a real baseline participate — ``exclusive_ttft`` defaults to 0.0, and
    # dividing by the old 1e-9 guard inflated the percentile to ~1e9 for
    # every workload that never set it. Exclusive service is a lower bound
    # on TTFT, so the ratio is clamped at 1.0 (timer jitter can measure a
    # hair under it).
    ttft_slowdown = [
        max((r.first_token_time - r.arrival) / r.exclusive_ttft, 1.0)
        for r in done if r.exclusive_ttft > 0.0
    ]
    n = max(len(requests), 1)
    ok = sum(1 - v["violated"] for v in viol)
    finished = [r for r in requests if r.finish_time is not None]
    return {
        "n_requests": len(requests),
        "n_finished": len(finished),
        "violation_rate": sum(v["violated"] for v in viol) / n,
        "ttft_miss_rate": sum(v["ttft_miss"] for v in viol) / n,
        "tbt_miss_tokens": sum(v["tbt_misses"] for v in viol),
        "goodput_rps": ok / max(duration, 1e-9),
        "throughput_rps": len(finished) / max(duration, 1e-9),
        "ttft_p50": _pct(ttft, 50), "ttft_p95": _pct(ttft, 95), "ttft_p99": _pct(ttft, 99),
        "e2e_p50": _pct(e2e, 50), "e2e_p95": _pct(e2e, 95), "e2e_p99": _pct(e2e, 99),
        "ttft_slowdown_p50": _pct(ttft_slowdown, 50),
        "ttft_slowdown_p99": _pct(ttft_slowdown, 99),
        "duration": duration,
    }


def summarize_by_class(requests: Sequence[Request], duration: float) -> Dict:
    """Per-SLO-class violation / goodput breakdown: :func:`summarize` on each
    named class's subset. The aggregate number hides *which tenant class*
    pays the violations — with class-weighted admission/eviction in one
    engine, the per-class split is the signal (``interactive`` should hold
    its SLO while ``batch`` absorbs the pressure)."""
    return {
        cls: summarize([r for r in requests if r.slo_class == cls], duration)
        for cls in sorted({r.slo_class for r in requests})
    }


def cumulative_violations(requests: Sequence[Request], horizon: float,
                          step: float = 10.0) -> List:
    """Violation count over time (paper Fig. 6): a request counts at the
    moment its first deadline is irrecoverably missed."""
    times = []
    for r in requests:
        v = r.violations()
        if v["ttft_miss"]:
            times.append(r.first_token_time if r.first_token_time is not None
                         else r.ttft_deadline())
        elif v["tbt_misses"]:
            for k, tt in enumerate(r.token_times[1:], start=2):
                if tt > r.token_deadline(k) + 1e-9:
                    times.append(tt)
                    break
    times.sort()
    grid = np.arange(0.0, horizon + step, step)
    counts = np.searchsorted(times, grid)
    return list(zip(grid.tolist(), counts.tolist()))


def max_goodput(run_at_qps: Callable[[float], Dict], lo: float, hi: float,
                violation_cap: float = 0.01, iters: int = 7) -> Dict:
    """Binary-search the highest QPS whose violation rate stays under cap.

    ``run_at_qps(qps) -> summarize(...) dict``. Returns the frontier point.
    """
    best = None
    res_lo = run_at_qps(lo)
    if res_lo["violation_rate"] > violation_cap:
        return {"qps": 0.0, "summary": res_lo}
    best = (lo, res_lo)
    res_hi = run_at_qps(hi)
    if res_hi["violation_rate"] <= violation_cap:
        return {"qps": hi, "summary": res_hi}
    for _ in range(iters):
        mid = (lo + hi) / 2
        res = run_at_qps(mid)
        if res["violation_rate"] <= violation_cap:
            lo, best = mid, (mid, res)
        else:
            hi = mid
    return {"qps": best[0], "summary": best[1]}
