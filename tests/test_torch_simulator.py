"""PyTorch port: the event-driven serving simulator (a verbatim copy, with
the copied scheduler, allocator and cost model) gives the reference's
results for every scheduler in ``core/`` on the same ``make_workload``
seed: equal ``summarize`` and ``summarize_by_class`` summaries, rounds,
duration, Violation-Checker routes and per-request timelines; also under
KV pressure (preemption) and with speculative verify rows."""
import math

import pytest

pytest.importorskip("torch")

import repro.core as JC  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro.configs.bench_models import QWEN25_7B as JQWEN  # noqa: E402
from repro.serving import costmodel as JCM  # noqa: E402
from repro.serving import metrics as JMET  # noqa: E402
from repro.serving import simulator as JSIM  # noqa: E402
from repro.serving import workloads as JW  # noqa: E402
from repro_torch.configs.bench_models import QWEN25_7B as TQWEN  # noqa: E402
from repro_torch.serving import costmodel as TCM  # noqa: E402
from repro_torch.serving import metrics as TMET  # noqa: E402
from repro_torch.serving import simulator as TSIM  # noqa: E402
from repro_torch.serving import workloads as TW  # noqa: E402

SCHEDULERS = ("SlidingServeScheduler", "SarathiEDFScheduler",
              "QoServeLikeScheduler", "FCFSStaticScheduler",
              "SingleStepGreedyScheduler")


def _simulate(core, cm, met, sim, wl, qwen, sched, *, kv, spec_k,
              dataset="sharegpt", qps=5.0, duration=12.0):
    cost = cm.CostModel(cm.ModelProfile.from_config(qwen),
                        cm.HardwareSpec(chips=1), seed=7)
    workload = wl.make_workload(wl.WorkloadSpec(dataset=dataset, qps=qps,
                                                duration=duration, seed=1),
                                cost)
    s = sim.ServingSimulator(getattr(core, sched)(max_budget=2048), cost,
                             workload, kv_capacity_tokens=kv, spec_k=spec_k,
                             spec_acceptance=0.6 if spec_k else 0.0,
                             spec_seed=3)
    res = s.run()
    return {
        "summary": met.summarize(res.requests, res.duration),
        "by_class": met.summarize_by_class(res.requests, res.duration),
        "iterations": res.iterations,
        "duration": res.duration,
        "routes": dict(res.route_counts),
        "timeline": [(r.rid, r.first_token_time, r.finish_time, r.generated,
                      r.state.name) for r in res.requests],
        "spec": (s.spec_rows, s.spec_emitted),
        "evictions": s.alloc.evictions,
    }


def _same(a, b):
    """Equal, with NaN equal to NaN (an empty class's percentile)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return a == b


@pytest.mark.parametrize("sched", SCHEDULERS)
@pytest.mark.parametrize("kv,spec_k", [(512 * 1024, 0), (2048, 0),
                                       (512 * 1024, 4)])
def test_simulator_matches_reference(sched, kv, spec_k):
    want = _simulate(JC, JCM, JMET, JSIM, JW, JQWEN, sched, kv=kv,
                     spec_k=spec_k)
    got = _simulate(TC, TCM, TMET, TSIM, TW, TQWEN, sched, kv=kv,
                    spec_k=spec_k)
    assert want["summary"]["n_requests"] > 20
    assert want["iterations"] > 0
    assert (want["evictions"] > 0) == (kv == 2048)   # pressure bites
    assert (want["spec"][0] > 0) == bool(spec_k)
    assert _same(got, want), {k: (got[k], want[k]) for k in got
                              if not _same(got[k], want[k])}
