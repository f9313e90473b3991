#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py``: sharded paged serving on one card, over
ranks that share it. Alone (it builds the kernels first):

    python3 tools/sharded_phase.py

Each world is spawned processes (``repro_torch.launch.local_world``), every
rank on the one card, joined by a ``file://`` store; the serving mesh is
``"W"`` over the world of W ranks (``launch/mesh.make_serving_mesh``).
World 1's data plane is NCCL. Worlds 2-4 share the card, which NCCL
refuses (two ranks on one device), so their data plane is gloo, which
takes CUDA tensors: the phase tests the sharded dispatch, the combine and
the driver/worker protocol, not NCCL between cards. A rank that raises
fails its world, and the phase raises.

(a) Smoke llama3.2-3b (fp32, Hkv 2) and its 8-KV-head variant at worlds
    1-4: the driver's greedy tokens equal the mesh-less engine's on the
    card (the reference sharded test's prompts, ``decode_reserve_tokens``
    8), one readback per round, the pool whole afterwards, every rank's
    dispatches the driver's; ``spec_k`` 4 on looping prompts at world 3
    gives the unspeculated tokens. World 2 shards heads (Hkv 2 and 8),
    world 3 the sequence (both), world 4 the sequence (Hkv 2: block tables
    of 2 and 4 columns, pad and non-pad) and heads (Hkv 8).
(b) #1 and #2 at llama3.2-3b's heads (bf16, 24 query heads over 8 KV
    heads, D 128, page 16) on phase 3's decode and prefill cases, at world
    2 (heads, 4 a rank) and world 3 (sequence: ``partial=True`` at
    shard-local lengths), against the plain single-device version at phase
    3's bf16 limit; a shard whose keys all lie past a row's length must
    give ``m = -1e30``, ``l = 0``. Each rank's kernel is timed alone (the
    other ranks wait at a barrier) with CUDA events, rank 0's also from a
    profiler trace; the op's collectives alone (the head gather, or the
    combine, on that kernel's outputs) and the whole op (kernel and
    collectives), every rank at once, with CUDA events. Under gloo the
    collectives' events span the host copies and the ranks' contention for
    the one card: they are the collectives' time on the card's clock, not
    device time of a collective kernel (gloo reduces on the host).
(c) Full-width llama3.2-3b (bf16, 28 layers, random weights from seed 0)
    with ``chip_smoke.cut_workload``'s part of phase 5's requests (4 of
    8, a quarter of their output tokens) and its 65536-token KV pool at
    world 2 (heads) and world 3 (sequence): every request finishes, each
    rank's #1/#2 counters (set to 0 just before, read through the control
    plane just after) equal 28 x that rank's dispatches of each kind, the
    driver's readbacks equal its rounds. Prints the backend, tokens/s, the mean
    round time and the control plane's cost a dispatch.
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

WORLDS = {1: ("smoke",), 2: ("smoke", "ops", "full"),
          3: ("smoke", "spec", "ops", "full"), 4: ("smoke",)}
TIMEOUT = {1: 180.0, 2: 420.0, 3: 420.0, 4: 180.0}
SMOKE_SPEC = [(37, "interactive"), (64, "batch"), (18, "standard"),
              (5, "interactive")]
LAYERS = 28


def smoke_prompts(cfg, loopy=False):
    """tests/test_sharded_serving.py's prompts (and its looping ones)."""
    import numpy as np
    rng = np.random.default_rng(0)
    if loopy:
        return [(np.tile(rng.integers(1, cfg.vocab_size, 12), 3)
                 .astype(np.int32), c) for _, c in SMOKE_SPEC]
    return [(rng.integers(1, cfg.vocab_size, n).astype(np.int32), c)
            for n, c in SMOKE_SPEC]


def smoke_cfgs():
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-3b").smoke()
    return {"Hkv2": cfg, "Hkv8": dataclasses.replace(cfg, num_heads=8,
                                                     num_kv_heads=8)}


def smoke_engine(cfg, mesh=None, **kw):
    from repro_torch.core import SlidingServeScheduler
    from repro_torch.params import init_params
    from repro_torch.serving.engine import EngineCore
    return EngineCore(cfg, SlidingServeScheduler(max_budget=256,
                                                 max_iter_time=5.0),
                      cache_mode="paged", kv_capacity_tokens=2048,
                      decode_reserve_tokens=8,
                      params=init_params(cfg, seed=0, device=cs.DEVICE),
                      device=cs.DEVICE, mesh=mesh, **kw)


def drive(core, prompt_list, max_output=5, wall=300.0):
    """Serve ``prompt_list`` through InferenceServer on the driver (workers
    loop until the driver closes). The driver returns its record."""
    from repro_torch.serving.server import InferenceServer
    if not core.is_driver:
        core.serve_as_worker()
        return None
    import torch
    try:
        server = InferenceServer(core)
        outs = ([max_output] * len(prompt_list) if isinstance(max_output, int)
                else max_output)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = [server.submit(p.copy(), slo_class=c, max_output=o)
              for (p, c), o in zip(prompt_list, outs)]
        server.run(max_wall_s=wall)
        torch.cuda.synchronize()
        st = core.stats
        rec = {"wall_s": time.perf_counter() - t0,
               "tokens": {h.rid: list(h.collected) for h in hs},
               "finished": all(h.finished and not h.aborted for h in hs),
               "iterations": st.iterations,
               "readbacks": st.token_readbacks,
               "spec_rounds": st.spec_rounds,
               "control_s": st.control_s,
               "pool_whole": core.alloc.free_blocks == core.alloc.num_blocks,
               "shard_info": core.shard_info(),
               "banner": core.shard_banner()}
        rec["counters"] = core.mesh_counters() if core.mesh else None
        return rec
    finally:
        core.close()


# ---- rank side ----------------------------------------------------------------
def reset_counters():
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_fused)
    from repro_torch.kernels.paged_prefill_attention.kernel import (
        paged_prefill_attention_fused)
    paged_attention_fused.launches = 0
    paged_prefill_attention_fused.launches = 0


def smoke_part(world, mesh):
    out = {}
    for name, cfg in smoke_cfgs().items():
        out[name] = drive(smoke_engine(cfg, mesh), smoke_prompts(cfg))
    return out


def spec_part(world, mesh):
    cfg = smoke_cfgs()["Hkv2"]
    return drive(smoke_engine(cfg, mesh, spec_k=4),
                 smoke_prompts(cfg, loopy=True))


DECODE_CASES = [   # (name, lengths, window, softcap): phase 3's shapes
    ("B8 ctx<=4096 bf16", [4096, 16, 13, 4088, 1500, 2900, 77, 3000], 0,
     0.0),
    ("B8 window1000 softcap30 bf16", [4096, 16, 13, 4088, 1500, 2900, 77,
                                      3000], 1000, 30.0),
    ("B1 ctx4093 bf16", [4093], 0, 0.0)]
PREFILL_CASES = [  # (name, row offsets, lengths, Sq, window, softcap)
    ("R4 Sq512 bf16", [0, 1000, 1029, 0], [512, 1509, 1541, 0], 512, 0,
     0.0),
    ("R4 Sq128 window300 softcap30 bf16", [0, 500, 900, 0],
     [128, 620, 1028, 0], 128, 300, 30.0),
    ("R2 Sq4 verify-rows bf16", [1500, 700], [1504, 702], 4, 0, 0.0)]


def _timed_alone(torch, rank, world, fn, iters):
    """``fn``'s time a call on this rank while the others wait at a
    barrier: (CUDA events ms, profiler device ms on rank 0 else None)."""
    import torch.distributed as dist
    got = (None, None)
    for r in range(world):
        dist.barrier()
        if r == rank:
            got = (cs.cuda_ms(torch, fn, iters),
                   cs.device_ms(torch, fn, iters) if rank == 0 else None)
            torch.cuda.synchronize()
    dist.barrier()
    return got


def ops_part(world, mesh, rank):
    """(b): one row per case."""
    import torch
    from repro_torch.kernels import ref_common as rc
    from repro_torch.kernels import shard_utils as su
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_fused)
    from repro_torch.kernels.paged_attention.ops import paged_attention_auto
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_fused_ref)
    from repro_torch.kernels.paged_prefill_attention.kernel import (
        paged_prefill_attention_fused)
    from repro_torch.kernels.paged_prefill_attention.ops import (
        paged_prefill_attention_auto)
    from repro_torch.kernels.paged_prefill_attention.ref import (
        paged_prefill_attention_fused_ref)
    bf, Hkv, G, D, ps = torch.bfloat16, 8, 3, 128, cs.PAGE
    cases = cs.Cases(torch)          # one seed: the same inputs on every rank
    shards = su.head_shards(Hkv, mesh, "model")
    i = su.shard_index(mesh, "model")
    rows = []

    def local_pool(kv):
        per = Hkv // shards
        return kv[i * per:(i + 1) * per].contiguous() if shards > 1 else kv

    def empty_shard_check(name, m, l, live_len):
        """The rows whose shard-local length is <= 0: all their keys on this
        shard lie past their length, so the kernel must give the empty
        range's (0, -1e30, 0) there. Returns the (row, head) cells seen."""
        dead = live_len <= 0
        while dead.dim() < m.dim():
            dead = dead[..., None]
        dead = dead.expand_as(m)
        if bool(dead.any()) and not (bool((m[dead] == rc.NEG_INF).all())
                                     and bool((l[dead] == 0).all())):
            raise AssertionError(f"{name}: an empty shard's m/l are not "
                                 f"-1e30/0 (m {m[dead].unique()[:4]}, l "
                                 f"{l[dead].unique()[:4]})")
        return int(dead.sum())

    for name, lens, window, cap in DECODE_CASES:
        B = len(lens)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=cs.DEVICE)
        n = 1 << max(math.ceil(max(lens) / ps) - 1, 0).bit_length()
        kv, bt, _ = cases.pool_and_tables(lens, n, Hkv, D, bf)
        q = cases.randn((B, Hkv * G, D), bf)
        kw = dict(scale=D ** -0.5, window=window, softcap=cap)
        want = paged_attention_fused_ref(q, kv, bt, lens_t, **kw)
        kvp = local_pool(kv)

        def op():
            return paged_attention_auto(q, kvp, bt, lens_t, mesh=mesh,
                                        kv_heads=Hkv, **kw)
        err, share = cs.check(f"sharded decode {name} w{world}", op(), want,
                              cs.vec_limit(want, "bfloat16"))
        empty = 0
        if shards > 1:
            heads = su.local_heads(Hkv * G, Hkv, mesh, "model")
            ql = q[:, heads].contiguous()

            def kern():
                return paged_attention_fused(ql, kvp, bt, lens_t, **kw)
            part = kern()

            def coll():
                return su.gather_heads(part, 1, mesh, "model")
        else:
            cols, off = su.column_shard(bt, mesh, "model")
            ln_loc = lens_t - off * ps

            def kern():
                return paged_attention_fused(q, kvp, cols, ln_loc,
                                             partial=True, **kw)
            acc, m, l = kern()
            empty = empty_shard_check(f"decode {name}", m, l, ln_loc)

            def coll():
                return su.combine_partials(acc, m, l, bf, mesh, "model")
        rows.append(_op_row(torch, rank, world, "paged_attention_fused",
                            name, err, share, empty, kern, coll, op, 20))

    for name, pos, lens, Sq, window, cap in PREFILL_CASES:
        R = len(pos)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=cs.DEVICE)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=cs.DEVICE)
        n = 1 << max(math.ceil(max(lens) / ps) - 1, 0).bit_length()
        kv, bt, _ = cases.pool_and_tables(lens, n, Hkv, D, bf)
        q = cases.randn((R, Sq, Hkv, G, D), bf)
        valid = ((pos_t[:, None] + torch.arange(Sq, device=cs.DEVICE)[None])
                 < lens_t[:, None])
        kw = dict(scale=D ** -0.5, window=window, softcap=cap)
        want = paged_prefill_attention_fused_ref(q, kv, bt, pos_t, lens_t,
                                                 **kw)
        kvp = local_pool(kv)

        def op():
            return paged_prefill_attention_auto(q, kvp, bt, pos_t, lens_t,
                                                mesh=mesh, **kw)
        err, share = cs.check(f"sharded prefill {name} w{world}", op(), want,
                              cs.vec_limit(want, "bfloat16"), valid)
        empty = 0
        if shards > 1:
            ql = q[:, :, su.local_heads(Hkv, Hkv, mesh, "model")].contiguous()

            def kern():
                return paged_prefill_attention_fused(ql, kvp, bt, pos_t,
                                                     lens_t, **kw)
            part = kern()

            def coll():
                return su.gather_heads(part, 2, mesh, "model")
        else:
            cols, off = su.column_shard(bt, mesh, "model")
            off *= ps

            def kern():
                return paged_prefill_attention_fused(
                    q, kvp, cols, pos_t - off, lens_t - off, partial=True,
                    **kw)
            acc, m, l = kern()
            empty = empty_shard_check(f"prefill {name}", m, l, lens_t - off)

            def coll():
                return su.combine_partials(acc, m, l, bf, mesh, "model")
        rows.append(_op_row(torch, rank, world,
                            "paged_prefill_attention_fused", name, err,
                            share, empty, kern, coll, op, 10))
    return rows


def _op_row(torch, rank, world, kernel, name, err, share, empty, kern,
            coll, op, iters):
    k_ms, k_dev = _timed_alone(torch, rank, world, kern, iters)
    coll_ms = cs.cuda_ms(torch, coll, iters)
    op_ms = cs.cuda_ms(torch, op, iters)
    return {"kernel": kernel, "case": name, "world": world,
            "max_abs_err": err, "limit_share": share,
            "empty_shard_cells": empty, "kernel_ms": k_ms,
            "kernel_device_ms": k_dev, "collectives_ms": coll_ms,
            "op_ms": op_ms}


def full_part(world, mesh, rank):
    """(c): the driver's record (workers return None)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SlidingServeScheduler
    from repro_torch.params import init_params
    from repro_torch.serving.engine import EngineCore
    cfg = get_config("llama3.2-3b")
    params = init_params(cfg, seed=0, device=cs.DEVICE)
    prompts, outputs = cs.cut_workload(*cs.serving_workload(cfg))
    core = EngineCore(cfg, SlidingServeScheduler(max_budget=512,
                                                 max_iter_time=2.0),
                      kv_capacity_tokens=65536, params=params, device=cs.DEVICE,
                      mesh=mesh)
    reset_counters()
    rec = drive(core, [(p, "standard") for p in prompts], outputs, 600.0)
    if rec is not None:
        rec["outputs"] = outputs
        rec["prompt_tokens"] = sum(len(p) for p in prompts)
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del core, params
    return rec


def world_rank(rank, world, parts):
    """Every part of ``parts`` on this rank, over the mesh ``"world"``."""
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh(str(world))
    out = {}
    for part in parts:
        t0 = time.perf_counter()
        if part == "smoke":
            out[part] = smoke_part(world, mesh)
        elif part == "spec":
            out[part] = spec_part(world, mesh)
        elif part == "ops":
            out[part] = ops_part(world, mesh, rank)
        else:
            out[part] = full_part(world, mesh, rank)
        out[part + "_s"] = time.perf_counter() - t0
    return out


# ---- the phase ------------------------------------------------------------------
def _check_driver(what, rec, world, layers=None):
    if rec is None or not rec["finished"]:
        raise AssertionError(f"{what}: unfinished requests")
    if rec["readbacks"] != rec["iterations"]:
        raise AssertionError(f"{what}: {rec['readbacks']} readbacks for "
                             f"{rec['iterations']} rounds")
    if not rec["pool_whole"]:
        raise AssertionError(f"{what}: KV pages leaked")
    cnt = rec["counters"]
    if len(cnt) != world:
        raise AssertionError(f"{what}: counters of {len(cnt)} ranks")
    calls = [(c["decode_calls"], c["prefill_calls"], c["spec_calls"])
             for c in cnt]
    if len(set(calls)) != 1:
        raise AssertionError(f"{what}: the ranks' dispatches differ: {calls}")
    if layers is not None:
        for r, c in enumerate(cnt):
            pa, ppa = c["paged_attention_fused"], \
                c["paged_prefill_attention_fused"]
            if pa != layers * c["decode_calls"] or ppa != layers * (
                    c["prefill_calls"] + c["spec_calls"]) or not pa or not ppa:
                raise AssertionError(
                    f"{what}: rank {r} launched decode {pa} / prefill {ppa} "
                    f"for {layers} x dispatches decode {c['decode_calls']}, "
                    f"chunk {c['prefill_calls']}, spec {c['spec_calls']}")


def sharded_phase(torch, device_line=None):
    """Phase 16 (see the module docstring). Returns its record, with the
    launches of (c) by world and rank."""
    from repro_torch.launch.local_world import spawn_world
    device_line = device_line or cs.device_line()
    cs.release(torch)
    # the mesh-less engine on the card: the tokens every world must give
    base = {name: drive(smoke_engine(cfg), smoke_prompts(cfg))["tokens"]
            for name, cfg in smoke_cfgs().items()}
    cfg = smoke_cfgs()["Hkv2"]
    base["spec"] = drive(smoke_engine(cfg), smoke_prompts(cfg, loopy=True))[
        "tokens"]
    cs.release(torch)
    rec = {"device": device_line, "worlds": {}}
    launches = {}
    for world, parts in WORLDS.items():
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            ranks = spawn_world(world_rank, world, tmp, device=cs.DEVICE,
                                timeout=TIMEOUT[world], group_timeout=300.0,
                                parts=parts)
        wall = time.perf_counter() - t0
        drv = ranks[0]
        wrec = {"seconds": wall,
                "part_seconds": {p: drv[p + "_s"] for p in parts}}
        for name, res in drv["smoke"].items():
            what = f"world {world} smoke {name}"
            _check_driver(what, res, world)
            if res["tokens"] != base[name]:
                raise AssertionError(f"{what}: tokens {res['tokens']} != the "
                                     f"mesh-less engine's {base[name]}")
            print(f"  {what}: {res['banner']}; tokens == mesh-less card "
                  f"engine's; {res['iterations']} rounds, one readback each",
                  flush=True)
        wrec["smoke"] = {k: {x: v[x] for x in ("shard_info", "banner",
                                               "iterations", "counters")}
                         for k, v in drv["smoke"].items()}
        if "spec" in parts:
            res = drv["spec"]
            _check_driver(f"world {world} spec_k 4", res, world)
            if res["spec_rounds"] <= 0 or res["tokens"] != base["spec"]:
                raise AssertionError(f"world {world} spec_k 4: spec rounds "
                                     f"{res['spec_rounds']}, tokens "
                                     f"{res['tokens']} vs {base['spec']}")
            print(f"  world {world} smoke spec_k 4: {res['spec_rounds']} "
                  f"spec rounds, tokens == unspeculated", flush=True)
        if "ops" in parts:
            wrec["ops"] = [r["ops"] for r in ranks]
            for r, rows in enumerate(wrec["ops"]):
                for row in rows:
                    dev = (f", device {row['kernel_device_ms']:.4f} ms"
                           if row["kernel_device_ms"] is not None else "")
                    print(f"  w{world} rank {r} {row['kernel']:<30} "
                          f"{row['case']:<36} err {row['max_abs_err']:.3e} "
                          f"({row['limit_share']:.3f} of limit), empty-shard "
                          f"cells {row['empty_shard_cells']}; kernel alone "
                          f"{row['kernel_ms']:.4f} ms{dev}; collectives "
                          f"alone {row['collectives_ms']:.4f} ms; op "
                          f"{row['op_ms']:.4f} ms [{device_line}]",
                          flush=True)
        if "full" in parts:
            res = drv["full"]
            what = f"world {world} full-width llama3.2-3b"
            _check_driver(what, res, world, layers=LAYERS)
            if [len(t) for t in res["tokens"].values()] != res["outputs"]:
                raise AssertionError(f"{what}: output lengths")
            cnt = res["counters"]
            dispatches = sum(cnt[0][k] for k in ("decode_calls",
                                                 "prefill_calls",
                                                 "spec_calls"))
            n_out = sum(res["outputs"])
            full = {"banner": res["banner"], "wall_s": res["wall_s"],
                    "iterations": res["iterations"],
                    "round_ms": 1e3 * res["wall_s"] / res["iterations"],
                    "output_tok_per_s": n_out / res["wall_s"],
                    "total_tok_per_s": (n_out + res["prompt_tokens"])
                    / res["wall_s"],
                    "control_ms_per_dispatch": 1e3 * res["control_s"]
                    / dispatches,
                    "dispatches": dispatches, "counters": cnt,
                    "shard_info": res["shard_info"],
                    "peak_mem_gb_driver": res["peak_mem_gb"]}
            wrec["full"] = full
            for r, c in enumerate(cnt):
                for k in ("paged_attention_fused",
                          "paged_prefill_attention_fused"):
                    launches.setdefault(k, {})[
                        f"llama3.2-3b sharded w{world} rank {r}"] = c[k]
            print(f"  {what}: {res['banner']}; {len(res['outputs'])} "
                  f"requests, {res['prompt_tokens']} prompt + {n_out} output "
                  f"tokens in {res['wall_s']:.3f}s: "
                  f"{full['output_tok_per_s']:.1f} output tok/s, "
                  f"{full['total_tok_per_s']:.1f} total tok/s; "
                  f"{res['iterations']} rounds of {full['round_ms']:.2f} ms"
                  f"; control plane {full['control_ms_per_dispatch']:.3f}"
                  f" ms a dispatch over {dispatches} dispatches; launches "
                  f"by rank {[(c['paged_attention_fused'], c['paged_prefill_attention_fused']) for c in cnt]} "
                  f"= {LAYERS} x dispatches [{device_line}]", flush=True)
        parts_s = ", ".join(f"{p} {t:.1f}s"
                            for p, t in wrec["part_seconds"].items())
        print(f"  world {world}: {wall:.1f}s ({parts_s}) [{device_line}]",
              flush=True)
        rec["worlds"][world] = wrec
    return rec, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sharded_phase: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    dev = cs.device_line()
    print(f"{dev}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    rec, launches = sharded_phase(torch, device_line=dev)
    rec["seconds"] = time.perf_counter() - t0
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "sharded_phase.json").write_text(json.dumps(
        {"record": rec, "launches": launches}, indent=1, default=str))
    print(f"phase 16: {rec['seconds']:.1f}s [{dev}]")
    print(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
