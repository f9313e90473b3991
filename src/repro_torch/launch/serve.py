"""Serving launcher of the PyTorch port: the streaming InferenceServer on a
real model, on the GPU.

Requests are submitted through the online API at their arrival times
(open loop) and tokens stream back through per-request handles.

    python -m repro_torch.launch.serve --arch llama3.2-3b --requests 8
    python -m repro_torch.launch.serve --no-smoke      # full-width model
    python -m repro_torch.launch.serve --device cpu    # smoke config on CPU
    python -m repro_torch.launch.serve --cache-mode slot   # contiguous rows
    python -m repro_torch.launch.serve --arch xlstm-125m   # slot (auto)
    python -m repro_torch.launch.serve --arch jamba-1.5-large-398b --device cpu
    python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --device cpu
    python -m repro_torch.launch.serve --arch gemma2-2b --device cpu
    python -m repro_torch.launch.serve --arch deepseek-v3-671b --device cpu

jamba (Mamba + attention + MoE) and deepseek-v3 (MLA) serve in slot mode
(auto picks it); at full width their 398 B and 671 B parameters do not fit
one card, so ``--no-smoke`` serves them only where the memory holds them.

``--serve-http`` puts the network front door over the server instead
(``repro_torch.frontend.http_server``: HTTP/SSE on ``--port``, 0 picks a
free one); with ``--replicas N`` it fronts N engines behind the
prefix-affine router (each draws the same weights from the default seed):

    python -m repro_torch.launch.serve --device cpu --serve-http --port 0 \
        --replicas 2

``--mesh N`` (or ``REPRO_FORCE_MESH``) serves over a mesh of the ranks
that ``torchrun`` starts, one process a rank (the paged cache's KV heads,
or its sequence, sharded on the ``model`` axis; see
``serving/engine.py``): rank 0 prints the shard banner and serves, the
other ranks run the worker loop. The data plane is NCCL when every rank
has a card of its own and gloo when ranks share one (or on the CPU):

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 2
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 2 \
        --device cpu

``--serve-http`` stays single-process, as in the reference (it reads no
mesh). Flags follow the reference launcher. The model's weights are
random, drawn from the engine's default seed on every rank.
seamless-m4t (the encoder-decoder) is refused before anything is
allocated, as the engine refuses it: the reference engine cannot serve it
either.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import SlidingServeScheduler
from repro_torch.launch.mesh import (add_mesh_argument, init_distributed,
                                     make_serving_mesh, serving_mesh_spec)
from repro_torch.serving.engine import EngineCore
from repro_torch.serving.request import Request
from repro_torch.serving.server import SLO_CLASSES, InferenceServer
from repro_torch.serving.workloads import run_open_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--qps", type=float, default=2.0)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduce the model config for smoke runs "
                         "(--no-smoke serves the full-size architecture)")
    ap.add_argument("--max-budget", type=int, default=512)
    ap.add_argument("--slo-class", default="standard",
                    choices=sorted(SLO_CLASSES),
                    help="named tenant class (ttft/tbt SLO pair) submitted "
                         "requests run under")
    ap.add_argument("--cache-mode", default="auto",
                    choices=["auto", "slot", "paged"],
                    help="paged = block-table KV (production layout); "
                         "slot = contiguous rows (recurrent/MLA archs)")
    ap.add_argument("--kv-tokens", type=int, default=4096,
                    help="paged KV capacity in tokens")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reuse frozen KV pages across requests sharing a "
                         "token prefix (greedy tokens are the same either way)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft up to K tokens per "
                         "decode-eligible request per round (n-gram "
                         "prompt-lookup drafter)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k sampling cutoff (0 = full vocabulary)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="seed of the sampling generator (runs are "
                         "deterministic per seed)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default GPU raises when absent")
    ap.add_argument("--serve-http", action="store_true",
                    help="expose the server over HTTP/SSE instead of "
                         "replaying a synthetic workload (SIGINT drains "
                         "gracefully; see repro_torch.frontend.http_server)")
    ap.add_argument("--port", type=int, default=8763,
                    help="HTTP port for --serve-http (0 picks a free one)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="with --serve-http: >1 runs N engine replicas "
                         "behind the prefix-affine router")
    add_mesh_argument(ap)
    args = ap.parse_args(argv)

    if args.serve_http:
        # the network front door owns engine construction (it builds N
        # replicas for the router)
        import asyncio

        from repro_torch.frontend.http_server import (HttpFrontend,
                                                      build_backend)
        backend = build_backend(
            arch=args.arch, smoke=args.smoke, replicas=args.replicas,
            cache_mode=args.cache_mode, kv_tokens=args.kv_tokens,
            page_size=args.page_size, max_budget=args.max_budget,
            prefix_cache=args.prefix_cache, spec_k=args.spec_k,
            temperature=args.temperature, top_k=args.top_k,
            sample_seed=args.sample_seed, device=args.device)
        frontend = HttpFrontend(backend, port=args.port)
        asyncio.run(frontend.serve_forever())
        return None

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    device, mesh = args.device, None
    if serving_mesh_spec(args.mesh):
        device = init_distributed(args.device).device
        mesh = make_serving_mesh(args.mesh)
    try:
        return _serve(args, cfg, device, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _serve(args, cfg, device, mesh):
    sched = SlidingServeScheduler(max_budget=args.max_budget, max_iter_time=2.0)
    core = EngineCore(cfg, sched, cache_mode=args.cache_mode,
                      max_slots=4, max_len=512,
                      kv_capacity_tokens=args.kv_tokens,
                      page_size=args.page_size,
                      prefix_cache=args.prefix_cache, spec_k=args.spec_k,
                      temperature=args.temperature, top_k=args.top_k,
                      sample_seed=args.sample_seed,
                      device=device, mesh=mesh)
    if core.mesh is not None:
        if not core.is_driver:
            core.serve_as_worker()
            return None
        print(core.shard_banner(), flush=True)
    elif mesh is not None and mesh.get_rank() != 0:
        return None     # slot mode ignores the mesh: rank 0 serves alone
    try:
        return _drive(args, core)
    finally:
        core.close()


def _drive(args, core):
    st = core.stats
    server = InferenceServer(core)
    slo = SLO_CLASSES[args.slo_class]
    rng = np.random.default_rng(0)
    inter = rng.exponential(1.0 / args.qps, args.requests)
    arrivals = np.cumsum(inter)
    reqs = [Request(rid=i, arrival=float(arrivals[i]),
                    prompt_len=int(rng.integers(16, 128)),
                    max_output=int(rng.integers(4, 12)),
                    ttft_slo=slo.ttft_slo, tbt_slo=slo.tbt_slo,
                    slo_class=slo.name)
            for i in range(args.requests)]
    out = run_open_loop(server, reqs, max_wall_s=300.0)
    print(f"finished {len(out['finished'])}/{len(reqs)} "
          f"[{core.cache_mode} cache on {core.device}, slo={args.slo_class}]; "
          f"iterations={st.iterations} "
          f"max_concurrency={st.max_concurrency} evictions={st.evictions} "
          f"wall={out['wall']:.1f}s")
    if core.spec_k:
        si = core.spec_info()
        print(f"speculation: acceptance {si['acceptance_rate']:.0%} "
              f"({si['accepted_tokens']}/{si['draft_tokens']} drafts), "
              f"{si['tokens_per_verify_row']:.2f} tokens/verify row")
    if core.prefix_cache:
        ci = core.cache_info()
        print(f"prefix cache: hit {ci['hit_tokens']}/{ci['prompt_tokens']} "
              f"prompt tokens ({ci['hit_rate']:.0%}), "
              f"{ci['cached_pages']} pages cached")
    for h in out["finished"]:
        r = h.request
        print(f"  req {r.rid}: ttft={(r.first_token_time - r.arrival):.2f}s "
              f"out={h.collected}")
    return out


if __name__ == "__main__":
    main()
