"""End-to-end driver of the PyTorch port: serve a real model with batched
requests (the port's counterpart of ``examples/serve_slo_engine.py``), on
the GPU unless ``--device cpu``.

SlidingServe schedules chunked prefill + continuous-batching decode over
the port's forward passes (the smoke llama3.2 config). Wall-clock latencies
feed the online batch-latency predictor; generated tokens are
greedy-decoded.

    PYTHONPATH=src python examples/serve_slo_engine_torch.py [--arch llama3.2-3b]
    PYTHONPATH=src python examples/serve_slo_engine_torch.py --device cpu

``serve_requests(cfg, requests, **engine_kw)`` prints the reference's
lines and returns what it printed; the keywords go to the engine
(``device``, ``params``, ``cache_mode``, ``kv_capacity_tokens``). The CLI
serves seed 0's weights as the CPU draws them (``init_params_on_host``),
so the card prints the CPU's tokens.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import SlidingServeScheduler
from repro_torch.params import init_params_on_host
from repro_torch.serving.engine import ServingEngine, resolve_device
from repro_torch.serving.request import Request


def serve_requests(cfg, requests=6, **engine_kw):
    """``requests`` arrivals 0.3 s apart through ``ServingEngine.serve``;
    returns each finished request's tokens and the run's counters."""
    sched = SlidingServeScheduler(max_budget=512, max_iter_time=2.0)
    engine = ServingEngine(cfg, sched, max_slots=4, max_len=512, **engine_kw)

    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, arrival=0.3 * i,
                prompt_len=int(rng.integers(16, 120)),
                max_output=int(rng.integers(4, 12)),
                ttft_slo=30.0, tbt_slo=30.0)
        for i in range(requests)
    ]
    print(f"serving {len(reqs)} requests on {cfg.name} "
          f"({engine.cache_mode} KV cache, reduced config, "
          f"{engine.device})...")
    out = engine.serve(reqs, max_wall_s=240.0)
    for r in out["finished"]:
        toks = out["outputs"][r.rid]
        print(f"  req {r.rid}: prompt={r.prompt_len} ttft="
              f"{(r.first_token_time - r.arrival):.2f}s tokens={toks}")
    st = out["stats"]
    print(f"iterations={st.iterations} prefill_calls={st.prefill_calls} "
          f"decode_calls={st.decode_calls} jit_shapes={st.compiled_shapes} "
          f"max_round_calls={st.max_round_calls} "
          f"max_concurrency={st.max_concurrency} wall={out['wall']:.1f}s")
    print(f"predictor saw {engine.sched.predictor.observed} real batch "
          f"latencies")
    return {"requests": len(reqs), "cache_mode": engine.cache_mode,
            "tokens": {r.rid: list(out["outputs"][r.rid])
                       for r in out["finished"]},
            "max_output": {r.rid: r.max_output for r in reqs},
            "iterations": st.iterations, "readbacks": st.token_readbacks,
            "calls": {"decode_calls": st.decode_calls,
                      "prefill_calls": st.prefill_calls,
                      "spec_calls": st.spec_calls},
            "max_round_calls": st.max_round_calls,
            "max_concurrency": st.max_concurrency, "wall": out["wall"],
            "observed": engine.sched.predictor.observed}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--cache-mode", default="auto",
                    choices=["auto", "slot", "paged"])
    ap.add_argument("--kv-tokens", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default GPU raises when absent")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).smoke()
    device = resolve_device(args.device)
    # seed 0's weights as the CPU draws them, on every device
    return serve_requests(cfg, args.requests, cache_mode=args.cache_mode,
                          kv_capacity_tokens=args.kv_tokens, device=device,
                          params=init_params_on_host(cfg, 0, device))


if __name__ == "__main__":
    main()
