#!/usr/bin/env python3
"""Greedy token streams of full-width llama3.2-3b paged serving, at
spec_k 0 and 4, from one checkout; and the comparison of two such runs:

    python3 tools/paged_streams.py OLD [float32] > chiprun_out/old.json
    python3 tools/paged_streams.py .   [float32] > chiprun_out/new.json
    python3 tools/paged_streams.py --compare chiprun_out/old.json \
        chiprun_out/new.json

A run imports the checkout's ``chip_smoke.py`` (which puts its ``src/``
first on the path) and serves its full-width phase's 8 requests with its
random weights (seed 0) through ``InferenceServer(EngineCore(...))``, as
that phase does, on the card; in bf16, the config's dtype, or in fp32
(weights and activations), where a kernel's summation order moves the
logits by far less than bf16 rounding does. The comparison prints, for each spec_k,
how many requests gave the same tokens and where the others first differ.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path


def streams(root: str, dtype: str = "bfloat16") -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import chip_smoke as cs
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SlidingServeScheduler
    from repro_torch.serving.engine import EngineCore
    from repro_torch.serving.server import InferenceServer
    if not torch.cuda.is_available():
        raise SystemExit("paged_streams: no CUDA device")
    cfg = get_config("llama3.2-3b")
    if dtype != "bfloat16":
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype),
                                  param_dtype=getattr(torch, dtype))
    params = cs.load_params(torch, cfg)
    prompts, outputs = cs.serving_workload(cfg)
    out = {}
    for spec_k in (0, 4):
        core = EngineCore(cfg, SlidingServeScheduler(max_budget=512,
                                                     max_iter_time=2.0),
                          kv_capacity_tokens=65536, spec_k=spec_k,
                          params=params, device="cuda")
        server = InferenceServer(core)
        handles = [server.submit(p, max_output=o)
                   for p, o in zip(prompts, outputs)]
        server.run(max_wall_s=600.0)
        out[str(spec_k)] = [[int(x) for x in h.collected] for h in handles]
    return {"root": root, "dtype": dtype, "device": cs.device_line(),
            "streams": out}


def compare(a: dict, b: dict) -> None:
    for spec_k, sa in a["streams"].items():
        sb = b["streams"][spec_k]
        firsts = []
        for x, y in zip(sa, sb):
            i = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v),
                     None if len(x) == len(y) else min(len(x), len(y)))
            firsts.append(i)
        same = sum(i is None for i in firsts)
        print(f"spec_k {spec_k}: {same} of {len(sa)} requests give the same "
              f"tokens; first differing token of the others: "
              f"{[i for i in firsts if i is not None]}")


def main(argv) -> int:
    if len(argv) == 4 and argv[1] == "--compare":
        # the run's JSON is its last line (loading prints before it)
        compare(*(json.loads(Path(p).read_text().strip().splitlines()[-1])
                  for p in argv[2:]))
        return 0
    print(json.dumps(streams(*(argv[1:] or ["."]))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
