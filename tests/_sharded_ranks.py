"""Rank bodies of the sharded-serving tests of the PyTorch port.

``repro_torch.launch.local_world.spawn_world`` runs them on spawned ranks
(gloo on CPU tensors, a ``file://`` store, each collective bounded by the
group's timeout and the world by a deadline); what a rank returns is
pickled back to the test. This module imports torch and the port only
(never JAX), so a rank starts quickly; the tests hold what the ranks
return against the JAX package.
"""
from __future__ import annotations

import numpy as np

SPEC = [(37, "interactive"), (64, "batch"), (18, "standard"),
        (5, "interactive")]        # tests/test_sharded_serving.py's prompts


def prompts(cfg, loopy=False):
    """The reference sharded-serving test's prompts: four random ones, or
    (``loopy``) four 12-token segments repeated three times."""
    rng = np.random.default_rng(0)
    if loopy:
        return [(np.tile(rng.integers(1, cfg.vocab_size, 12), 3)
                 .astype(np.int32), cls) for _, cls in SPEC]
    return [(rng.integers(1, cfg.vocab_size, n).astype(np.int32), cls)
            for n, cls in SPEC]


def ops_inputs(Hkv, n):
    """The reference ops test's inputs (``B 3, G 2, D 16, P 32, ps 8``) at
    ``Hkv`` KV heads and ``n`` block-table columns, as numpy arrays:
    q [B, H, D], the fused pool [Hkv, P, 2, ps, D], tables, lengths, the
    prefill q [B, 4, Hkv, G, D] and its row offsets."""
    rng = np.random.default_rng(1000 * Hkv + n)
    B, G, D, Pg, ps = 3, 2, 16, 32, 8
    q = rng.normal(size=(B, Hkv * G, D)).astype(np.float32)
    kp = rng.normal(size=(Hkv, Pg, ps, D)).astype(np.float32)
    vp = rng.normal(size=(Hkv, Pg, ps, D)).astype(np.float32)
    bt = rng.integers(0, Pg, size=(B, n)).astype(np.int32)
    ln = np.asarray([1, min(11, n * ps), n * ps - 3], np.int32)
    qp = rng.normal(size=(B, 4, Hkv, G, D)).astype(np.float32)
    rp = np.maximum(ln - 4, 0).astype(np.int32)
    return {"q": q, "kvp": np.stack([kp, vp], axis=2), "bt": bt, "ln": ln,
            "qp": qp, "rp": rp}


OPS_N = (2, 6, 8)                   # 2 and 6 take the pad path at M 4
OPS_WC = ((0, 0.0), (7, 0.0), (0, 30.0), (7, 30.0))


# ---- rank bodies ----------------------------------------------------------------
def _ops(rank, world, meshes, heads):
    """The sharded #1 and #2 dispatch on every (mesh, Hkv, n, window,
    softcap): {key: (decode out, prefill out, partition)}."""
    import torch
    from repro_torch.kernels import shard_utils as su
    from repro_torch.kernels.paged_attention.ops import paged_attention_auto
    from repro_torch.kernels.paged_prefill_attention.ops import (
        paged_prefill_attention_auto)
    from repro_torch.launch.mesh import make_serving_mesh
    out = {}
    for spec in meshes:
        mesh = make_serving_mesh(spec, device_type="cpu")
        for Hkv in heads:
            shards = su.head_shards(Hkv, mesh, "model")
            part = "heads" if shards > 1 else "sequence"
            for n in OPS_N:
                x = {k: torch.from_numpy(v) for k, v in
                     ops_inputs(Hkv, n).items()}
                kvp = x["kvp"]
                if shards > 1:     # this rank's head slice of the pool
                    per = Hkv // shards
                    i = su.shard_index(mesh, "model")
                    kvp = kvp[i * per:(i + 1) * per].contiguous()
                for window, cap in OPS_WC:
                    kw = dict(scale=0.25, window=window, softcap=cap,
                              mesh=mesh)
                    dec = paged_attention_auto(x["q"], kvp, x["bt"], x["ln"],
                                               kv_heads=Hkv, **kw)
                    pre = paged_prefill_attention_auto(
                        x["qp"], kvp, x["bt"], x["rp"], x["ln"], **kw)
                    out[spec, Hkv, n, window, cap] = (dec.numpy(),
                                                      pre.numpy(), part)
    return out


def _serve(core, cfg, prompt_list):
    """The reference test's ``run``: the prompts through InferenceServer on
    the driver (5 tokens each); workers loop until the driver closes."""
    from repro_torch.serving.server import InferenceServer
    if not core.is_driver:
        core.serve_as_worker()
        return None
    try:
        server = InferenceServer(core)
        hs = [server.submit(p.copy(), slo_class=cls, max_output=5)
              for p, cls in prompt_list]
        server.run(max_wall_s=200.0)
        st = core.stats
        return {"tokens": {h.rid: list(h.collected) for h in hs},
                "readbacks": st.token_readbacks,
                "iterations": st.iterations,
                "spec_rounds": st.spec_rounds,
                "pool_whole": core.alloc.free_blocks == core.alloc.num_blocks,
                "shard_info": core.shard_info(),
                "banner": core.shard_banner(),
                "counters": core.mesh_counters()}
    finally:
        core.close()


def engine(cfg, params, mesh=None, device="cpu", **kw):
    from repro_torch.core import SlidingServeScheduler
    from repro_torch.serving.engine import EngineCore
    kw.setdefault("cache_mode", "paged")
    return EngineCore(cfg, SlidingServeScheduler(max_budget=256,
                                                 max_iter_time=5.0),
                      kv_capacity_tokens=2048, decode_reserve_tokens=8,
                      params=params, device=device, mesh=mesh, **kw)


def _engines(rank, world, params_path, meshes):
    """Every engine case of the world: greedy (Hkv 2 and 8), spec_k 4 on
    looping prompts, the sampled stream, per mesh; then the refusals."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.engine import EngineCore
    from repro_torch.core import SlidingServeScheduler
    saved = torch.load(params_path, weights_only=False)
    cfg, params = saved["cfg"], saved["params"]
    cfg8, params8 = saved["cfg8"], saved["params8"]
    out = {}
    for spec in meshes:
        mesh = make_serving_mesh(spec)
        runs = {"greedy": (cfg, params, prompts(cfg), {}),
                "greedy8": (cfg8, params8, prompts(cfg8), {}),
                "spec": (cfg, params, prompts(cfg, loopy=True),
                         {"spec_k": 4}),
                "sampled": (cfg, params, prompts(cfg),
                            dict(temperature=0.7, top_k=20, sample_seed=11))}
        for name, (c, p, pl, kw) in runs.items():
            out[spec, name] = _serve(engine(c, p, mesh, **kw), c, pl)
    # ---- refusals ---------------------------------------------------------------
    mesh = make_serving_mesh(meshes[0])
    refused = {}
    try:
        make_serving_mesh("2")
    except ValueError as e:
        refused["mesh_size"] = str(e)
    slot = engine(cfg, params, mesh, cache_mode="slot", max_slots=2,
                  max_len=128)
    refused["slot_mesh"] = (slot.mesh, slot.shard_info())
    core = engine(cfg, params, mesh)   # no dispatch: no worker loop
    try:
        if core.is_driver:
            core.serve_as_worker()
        else:
            core.step()
    except RuntimeError as e:
        refused["scheduler"] = str(e)
    try:        # replicas that disagree: each rank draws from its own seed
        EngineCore(cfg, SlidingServeScheduler(max_budget=256), seed=rank,
                   cache_mode="paged", kv_capacity_tokens=256, device="cpu",
                   mesh=mesh)
    except RuntimeError as e:
        refused["replicas"] = str(e)
    out["refused"] = refused
    return out


def mesh_of_one(rank, world, params_path):
    """``tests/test_sharded_serving.py::test_mesh_of_one_device_is_bit_identical``
    on the port: mesh "1" against mesh=None, outputs and invariants."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.request import Request
    cfg = torch.load(params_path, weights_only=False)["cfg"]
    params = torch.load(params_path, weights_only=False)["params"]

    def run(mesh):
        eng = engine(cfg, params, mesh)
        reqs = [Request(rid=i, arrival=0.0, prompt_len=24 + 7 * i,
                        max_output=4, ttft_slo=60.0, tbt_slo=60.0)
                for i in range(3)]
        res = eng.serve(reqs, max_wall_s=120.0)
        eng.close()
        return (res["outputs"], not res["unfinished"],
                eng.stats.token_readbacks == eng.stats.iterations,
                eng.shard_info())

    return run(None), run(make_serving_mesh("1"))


def world4(rank, world, meshes, heads, params_path):
    """World 4's cases: the ops, then the engines."""
    return {"ops": _ops(rank, world, meshes, heads),
            "engines": _engines(rank, world, params_path, meshes)}
