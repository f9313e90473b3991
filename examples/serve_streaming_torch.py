"""Streaming online-serving demo of the PyTorch port: submit / stream /
cancel on a live engine (the port's counterpart of
``examples/serve_streaming.py``), on the GPU unless ``--device cpu``.

Exercises the step-based online API end to end on the smoke config:

* ``InferenceServer.submit`` mixes tenants with different SLO classes
  (interactive / standard / batch) in one paged-KV engine;
* ``handle.tokens()`` streams ids incrementally (tokens surface one round
  after dispatch — the zero-sync deferred readback);
* ``handle.cancel()`` aborts one stream mid-generation and its KV pages go
  straight back to the BlockAllocator;
* a stop-token request terminates early via the EOS check that rides the
  per-round readback.

    PYTHONPATH=src python examples/serve_streaming_torch.py [--cache-mode paged]
    PYTHONPATH=src python examples/serve_streaming_torch.py --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        examples/serve_streaming_torch.py --mesh 2x2 --device cpu

``--mesh``/``REPRO_FORCE_MESH`` (the shared helper in ``launch/mesh.py``,
same flag as ``launch/serve.py``) serves the paged executor over a mesh of
the ranks that ``torchrun`` starts, one process a rank: every rank builds
each server a scenario needs, in the same order; rank 0 drives it and
prints, the others run ``serve_as_worker()`` until the driver closes the
engine. Slot mode ignores the mesh, so there rank 0 serves alone.
Everything the demo asserts — streaming, cancel, stop tokens, one readback
per round, page-leak freedom — must hold unchanged.

``--shared-prefix`` runs the radix-prefix-cache smoke instead: requests
sharing one system prompt are served twice, cache on and cache off; the
run asserts a non-zero hit rate, fewer computed prefill tokens, exact
greedy-token parity between the two runs, and no page leak — also on a
mesh.

``--spec-k K`` (K > 0) runs the speculative-decoding smoke instead:
periodic prompts are served with n-gram drafting at K and again at 0; the
run asserts non-zero acceptance, more than one emitted token per verify
row, exact greedy-token parity between the two runs, one readback per
round, and no page leak. ``--temperature/--top-k/--sample-seed`` switch
the smoke to non-greedy sampling, where the assertion becomes same-seed
determinism instead of spec-on/off parity.

Each scenario is a function of ``(cfg, **engine_kw)`` (the keywords go to
every ``EngineCore`` it builds: ``device``, ``mesh``, ``params``,
``kv_capacity_tokens``, ...). It prints the reference's lines and returns
what it printed as a record (None on a worker rank); ``check_*`` applies
the reference's assertions to the record and prints the lines that follow
them. The CLI serves seed 0's weights as the CPU draws them
(``init_params_on_host``), so the card prints the CPU's streams.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.mesh import (add_mesh_argument, init_distributed,
                                     make_serving_mesh, serving_mesh_spec)
from repro_torch.params import init_params_on_host
from repro_torch.serving.engine import resolve_device
from repro_torch.serving.server import InferenceServer
from repro_torch.serving.workloads import multiturn_followup


def _drive(server, mesh, body):
    """``body(server)`` on the driver, which closes the engine after it; a
    worker rank of the engine's mesh loops until that close and returns
    None. An engine that ignores the mesh (slot mode) is driven by rank 0
    alone."""
    core = server.core
    if core.mesh is not None and not core.is_driver:
        core.serve_as_worker()
        return None
    if core.mesh is None and mesh is not None and mesh.get_rank() != 0:
        return None
    try:
        return body(server)
    finally:
        core.close()


def _calls(core):
    """The run's dispatches by kind (each launches the attention kernel
    once a layer)."""
    st = core.stats
    return {k: getattr(st, k)
            for k in ("decode_calls", "prefill_calls", "spec_calls")}


def _pool(core):
    """(free pages, pages) after the allocator's own invariant check."""
    core.alloc.check_invariants()
    return core.alloc.free_blocks, core.alloc.num_blocks


def shared_prefix_smoke(cfg, **engine_kw):
    """Serve a shared-system-prompt tenant mix with the prefix cache on and
    off; returns both runs' streams, ``cache_info`` and counters."""
    mesh = engine_kw.get("mesh")
    rng0 = np.random.default_rng(42)
    system = rng0.integers(1, cfg.vocab_size, 80).astype(np.int32)
    suffixes = [rng0.integers(1, cfg.vocab_size, 24).astype(np.int32)
                for _ in range(4)]

    def run(pc):
        def body(server):
            core = server.core
            if pc and core.mesh is not None:
                print(core.shard_banner())
            toks = []
            # sequential submits: each request arrives after the previous
            # one prefilled, so its system prompt should match frozen pages
            for sfx in suffixes:
                h = server.submit(np.concatenate([system, sfx]),
                                  slo_class="standard", max_output=5)
                toks.append(h.result())
            # one multi-turn follow-up: matches across generated tokens too
            p2 = multiturn_followup(np.concatenate([system, suffixes[0]]),
                                    toks[0], np.random.default_rng(7),
                                    cfg.vocab_size, turn_len=16)
            toks.append(server.submit(p2, max_output=5).result())
            ci = core.cache_info()
            st = core.stats
            print(f"prefix_cache={pc}: hit {ci['hit_tokens']}/"
                  f"{ci['prompt_tokens']} prompt tokens "
                  f"({ci['hit_rate']:.0%}), computed "
                  f"{ci['prefill_tokens_computed']}")
            return {"tokens": toks, "cache_info": ci,
                    "iterations": st.iterations,
                    "readbacks": st.token_readbacks, "calls": _calls(core),
                    "pool": _pool(core)}

        server = InferenceServer.build(cfg, cache_mode="paged",
                                       prefix_cache=pc, **engine_kw)
        return _drive(server, mesh, body)

    runs = {pc: run(pc) for pc in (True, False)}
    return None if runs[True] is None else {"runs": runs}


def check_shared_prefix(rec):
    """The reference's assertions on :func:`shared_prefix_smoke`'s
    record."""
    for run in rec["runs"].values():
        assert run["readbacks"] == run["iterations"], \
            "prefix cache broke the one-readback-per-round property"
        assert run["pool"][0] == run["pool"][1], "KV leaked"
    on, off = rec["runs"][True], rec["runs"][False]
    assert on["tokens"] == off["tokens"], "prefix cache changed greedy tokens"
    assert on["cache_info"]["hit_rate"] > 0, \
        "shared system prompt never hit the cache"
    assert (on["cache_info"]["prefill_tokens_computed"]
            < off["cache_info"]["prefill_tokens_computed"]), \
        "cache hits did not reduce prefill work"
    print(f"token parity OK across {len(on['tokens'])} streams; prefill "
          f"tokens {off['cache_info']['prefill_tokens_computed']} -> "
          f"{on['cache_info']['prefill_tokens_computed']}")


def spec_smoke(cfg, **engine_kw):
    """Serve periodic prompts with speculative decoding at ``spec_k`` (an
    engine keyword) and, greedy, at 0 (sampled: at ``spec_k`` twice);
    returns both runs' streams, counters and ``spec_info``."""
    mesh = engine_kw.get("mesh")
    k = engine_kw.pop("spec_k")
    rng = np.random.default_rng(11)
    prompts = []
    for _ in range(4):
        base = rng.integers(1, cfg.vocab_size, 12)
        prompts.append(np.tile(base, 32 // 12 + 1)[:32].astype(np.int32))
    temperature = engine_kw.get("temperature", 0.0)
    sampled = temperature > 0
    # sampled mode compares two identical spec runs (determinism); greedy
    # mode compares spec_k=K against spec_k=0 (bit-identical streams)
    ks = (k, k) if sampled else (k, 0)

    def run(kk):
        def body(server):
            core = server.core
            if kk == ks[0] and core.mesh is not None:
                print(core.shard_banner())
            handles = [server.submit(p, slo_class="standard", max_output=6)
                       for p in prompts]
            toks = [h.result() for h in handles]
            st = core.stats
            out = {"spec_k": kk, "tokens": toks, "iterations": st.iterations,
                   "readbacks": st.token_readbacks, "calls": _calls(core),
                   "pool": _pool(core),
                   "spec_info": core.spec_info() if kk else None}
            if kk:
                si = out["spec_info"]
                print(f"spec_k={kk}: acceptance {si['acceptance_rate']:.0%} "
                      f"({si['accepted_tokens']}/{si['draft_tokens']} "
                      f"drafts), {si['tokens_per_verify_row']:.2f} "
                      f"tokens/verify row, {st.iterations} rounds")
            return out

        server = InferenceServer.build(cfg, cache_mode="paged", spec_k=kk,
                                       **engine_kw)
        return _drive(server, mesh, body)

    runs = [run(kk) for kk in ks]
    if runs[0] is None:
        return None
    return {"spec_k": k, "sampled": sampled, "temperature": temperature,
            "streams": len(prompts), "runs": runs}


def check_spec(rec):
    """The reference's assertions on :func:`spec_smoke`'s record."""
    sampled = rec["sampled"]
    for run in rec["runs"]:
        assert run["readbacks"] == run["iterations"], \
            "speculation broke the one-readback-per-round property"
        assert run["pool"][0] == run["pool"][1], "KV leaked"
        si = run["spec_info"]
        if si is None:
            continue
        assert si["draft_tokens"] > 0, "drafter never fired"
        if not sampled:
            # a sampled stream legitimately rejects every lookup draft;
            # the acceptance bar is a greedy-mode assertion
            assert si["accepted_tokens"] > 0, \
                "drafter never had a token accepted"
            assert si["tokens_per_verify_row"] > 1.0, \
                "verify rows emitted no extra tokens"
    a, b = rec["runs"]
    assert a["tokens"] == b["tokens"], (
        "sampled speculative run is not deterministic" if sampled
        else "speculation changed the greedy stream")
    mode = (f"temperature={rec['temperature']} determinism" if sampled
            else f"greedy parity (spec_k={rec['spec_k']} vs 0)")
    print(f"{mode} OK across {rec['streams']} streams")


def streaming_demo(cfg, **engine_kw):
    """Three tenants in one engine: stream the interactive one, cancel the
    long one after 3 tokens, a stop-token request, drain the batch one;
    returns the streams, the finish reasons and the counters."""
    mesh = engine_kw.get("mesh")

    def body(server):
        core = server.core
        print(f"online API demo on {cfg.name} ({core.cache_mode} KV cache)")
        if core.mesh is not None:
            print(core.shard_banner())

        rng = np.random.default_rng(0)

        def mk(n):
            return rng.integers(1, cfg.vocab_size, n).astype(np.int32)

        # --- three tenants in one engine ---------------------------------
        chat = server.submit(mk(48), slo_class="interactive", max_output=8)
        summ = server.submit(mk(96), slo_class="batch", max_output=12)
        spam = server.submit(mk(64), slo_class="standard", max_output=64)

        # stream the interactive request token by token
        print(f"req {chat.rid} [interactive] streaming: ", end="",
              flush=True)
        for tok in chat.tokens():
            print(tok, end=" ", flush=True)
        print(f"<done: {chat.finish_reason}>")

        # cancel the long-running one mid-decode; its pages free at once
        for tok in spam.tokens():
            if len(spam.collected) >= 3:
                spam.cancel()
                break
        print(f"req {spam.rid} [standard] cancelled after "
              f"{len(spam.collected)} tokens (reason={spam.finish_reason})")

        # stop-token request: terminate when the model emits a known id.
        # Greedy decode is deterministic, so reuse the chat request's
        # second token as the stop id for an identical prompt — it must
        # stop there.
        stop_tok = chat.collected[1]
        rng2 = np.random.default_rng(0)
        same_prompt = rng2.integers(1, cfg.vocab_size, 48).astype(np.int32)
        eos = server.submit(same_prompt, slo_class="standard", max_output=8,
                            stop_ids=(stop_tok,))
        out = eos.result()
        print(f"req {eos.rid} [stop_ids=({stop_tok},)] -> {out} "
              f"(reason={eos.finish_reason})")

        # drain the batch tenant
        summ.result()
        print(f"req {summ.rid} [batch] -> {summ.collected}")

        st = core.stats
        print(f"iterations={st.iterations} readbacks={st.token_readbacks} "
              f"aborted={st.aborted} evictions={st.evictions} "
              f"max_concurrency={st.max_concurrency}")
        return {"cache_mode": core.cache_mode, "chat": list(chat.collected),
                "chat_reason": chat.finish_reason,
                "spam": list(spam.collected), "spam_reason":
                spam.finish_reason, "stop_tok": stop_tok, "stop_out": out,
                "stop_reason": eos.finish_reason,
                "batch": list(summ.collected),
                "batch_reason": summ.finish_reason,
                "iterations": st.iterations,
                "readbacks": st.token_readbacks, "aborted": st.aborted,
                "evictions": st.evictions,
                "max_concurrency": st.max_concurrency,
                "calls": _calls(core),
                "pool": _pool(core) if core.cache_mode == "paged" else None}

    server = InferenceServer.build(cfg, max_slots=4, max_len=512, **engine_kw)
    return _drive(server, mesh, body)


def check_demo(rec):
    """The reference's assertions on :func:`streaming_demo`'s record."""
    assert rec["stop_out"] == rec["chat"][:2], \
        "stop-token run diverged from greedy"
    if rec["cache_mode"] == "paged":
        assert rec["readbacks"] == rec["iterations"], \
            "streaming frontend broke the one-readback-per-round property"
        free, total = rec["pool"]
        assert free == total, "KV pages leaked"
        print(f"KV pool fully released ({free}/{total} pages free)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--cache-mode", default="auto",
                    choices=["auto", "slot", "paged"])
    ap.add_argument("--kv-tokens", type=int, default=4096)
    ap.add_argument("--shared-prefix", action="store_true",
                    help="run the prefix-cache smoke (hit rate + parity "
                         "assertions) instead of the streaming demo")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="run the speculative-decoding smoke (acceptance + "
                         "parity assertions) with K drafted tokens per row")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="with --spec-k: sample instead of greedy decode "
                         "(asserts same-seed determinism, not parity)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default GPU raises when absent")
    add_mesh_argument(ap)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).smoke()
    device, mesh = resolve_device(args.device), None
    if serving_mesh_spec(args.mesh):
        device = init_distributed(args.device).device
        mesh = make_serving_mesh(args.mesh)
    # seed 0's weights as the CPU draws them, on every device and rank
    engine_kw = dict(kv_capacity_tokens=args.kv_tokens, device=device,
                     mesh=mesh, params=init_params_on_host(cfg, 0, device))
    try:
        if args.shared_prefix:
            rec = shared_prefix_smoke(cfg, **engine_kw)
            check = check_shared_prefix
        elif args.spec_k > 0:
            rec = spec_smoke(cfg, spec_k=args.spec_k,
                             temperature=args.temperature, top_k=args.top_k,
                             sample_seed=args.sample_seed, **engine_kw)
            check = check_spec
        else:
            rec = streaming_demo(cfg, cache_mode=args.cache_mode,
                                 **engine_kw)
            check = check_demo
        if rec is not None:
            check(rec)
        return rec
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
