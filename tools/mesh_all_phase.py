#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py``: every arch on a mesh, and the dry run.
Alone (it builds the kernels first):

    python3 tools/mesh_all_phase.py

Ranks are spawned processes on the one card (``launch/local_world``),
joined by a ``file://`` store; ranks that share a card run gloo, which
copies CUDA tensors through the host. TF32 is off in every rank.

(a) World 4, fp32 smoke configs (weights drawn on the CPU from seed 0):
    - one AdamW step of deepseek-v3 (MLA on the rank's heads, MTP, the MoE
      expert-parallel at a capacity that drops no token), seamless-m4t
      (encoder frames) and internvl2 (patch embeddings) at mesh ``2x2``,
      and smoke llama with 2 query heads over 1 KV head at ``4`` (half a
      head a rank), each against the card's world-1 step on the same
      weights and batch within phase 15's limits (the loss and the
      gradient norm 2e-5 + 2e-5 |ref|, each leaf of the first moment 1e-4
      max |m_ref|); on every rank #5/#6/#7 launch twice a layer (forward
      and recompute) and their plain versions run in the backward only;
    - every arch's ``prefill`` of 2 x 20 tokens and 4 greedy
      ``decode_step``s at ``2x2`` (and the 2-head llama at ``4``), the
      cache this rank's shards: the greedy tokens equal the card's world-1
      tokens, and the largest logit difference is reported.
(b) Full width at mesh ``2`` (two ranks on the card, bf16, random weights
    from a seed):
    - seamless-m4t-large-v2 (nothing cut): one AdamW step on B 2 x 512
      tokens with 512 encoder frames: step ms, tokens/s, each rank's peak;
    - deepseek-v3-671b cut to 4 layers (``chip_smoke.deepseek_cut``; the
      rank's shards drawn on the card, leaf by leaf): ``prefill`` of 2 x
      512 and 32 ``decode_step``s: each rank's peak, ms a decode step, #5
      launches, and the time in ``combine_partials`` (MLA decode over the
      sequence-sharded latents).
(c) ``launch.dryrun.run_cell`` on this torch: the CPU test's four cells
    and deepseek-v3 ``train_4k`` at 16x16, each row with its wall seconds;
    and the roofline's ``analytic_memory_bytes`` and
    ``model_flops_estimate`` for phase 15 (c)'s step (llama3.2-3b, B 2 x
    S 2048, world 1) beside that phase's measured peak and 6 N tokens (when
    run inside ``chip_smoke.py``). Printed, not gated. ``chip_smoke.py``
    runs (c) in a process of its own (:func:`start_host_part`; the fake
    process group is process-wide, and the dry run needs only the host)
    from phase 16 on, beside the phases that use the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

TRAIN_CASES = (("deepseek-v3-671b", "2x2", None),
               ("seamless-m4t-large-v2", "2x2", None),
               ("internvl2-26b", "2x2", None),
               ("llama3.2-3b", "4", {"num_heads": 2, "num_kv_heads": 1}))
SLOT_B, SLOT_PROMPT, SLOT_STEPS, SLOT_LEN, SLOT_ENC = 2, 20, 4, 32, 8
SEAMLESS_S = 512
DS_B, DS_PROMPT, DS_STEPS, DS_LEN = 2, 512, 32, 1024
DRY_CELLS = (("llama3.2-3b", "decode_32k", "2x4", False),
             ("qwen2-moe-a2.7b", "decode_32k", "2x4", False),
             ("xlstm-125m", "train_4k", "2x4", False),
             ("gemma2-2b", "decode_32k", "2x2x4", True),
             ("deepseek-v3-671b", "train_4k", None, False))
KERNELS = ("chunked_prefill_attention", "mamba_scan", "mlstm_chunkwise")


def _kernels():
    from repro_torch.kernels.chunked_prefill_attention import kernel as k5
    from repro_torch.kernels.mamba_scan import kernel as k6
    from repro_torch.kernels.mlstm_chunkwise import kernel as k7
    return {"chunked_prefill_attention": k5.chunked_prefill_attention,
            "mamba_scan": k6.mamba_scan,
            "mlstm_chunkwise": k7.mlstm_chunkwise}


def _setup(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _cfg(arch, changes):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).smoke(), **(changes or {}))


def _no_drop(rctx, cfg):
    """The MoE expert-parallel at a capacity that drops no token (the
    world-1 step routes every token densely)."""
    if not cfg.num_experts:
        return rctx
    from repro_torch.models.model import _moe_pad
    return dataclasses.replace(rctx, moe=dataclasses.replace(
        rctx.moe, capacity_factor=float(_moe_pad(cfg))))


def _rows(mesh, B):
    from repro_torch.kernels import shard_utils as su
    dp = su.mesh_axis(mesh, ("pod", "data")) if mesh is not None else None
    if dp is None or B % dp.size:
        return slice(None)
    n = B // dp.size
    return slice(dp.index * n, (dp.index + 1) * n)


# ---- (a) train steps ---------------------------------------------------------
def train_step(torch, cfg, device, mesh, seed):
    """One AdamW step (weights drawn on the CPU from seed 0, the batch of
    ``cs.smoke_train_batch``) on ``mesh`` (None: one device). Returns the
    loss, the gradient norm, the first moment (whole, numpy, on rank 0 or
    without a mesh), and this rank's #5/#6/#7 launches and plain calls."""
    import torch.distributed as dist
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import make_rctx
    from repro_torch.params import init_params
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, TrainLayout,
                                              init_train_state,
                                              make_train_step)
    rctx = _no_drop(make_rctx(cfg, mesh, train=True, seq_len=cs.TRAIN_S),
                    cfg)
    params = init_params(cfg, seed=0, device="cpu")
    layout = TrainLayout(cfg, mesh) if mesh is not None else None
    batch = cs.smoke_train_batch(torch, cfg, seed)
    if layout is not None:
        params = shd.shard_tree(params, layout.pspecs, mesh)
        rows = _rows(mesh, cs.TRAIN_B)
        batch = {k: v[rows].contiguous() for k, v in batch.items()}
    params = T.tree_map(lambda x: x.to(device), params)
    batch = {k: v.to(device) for k, v in batch.items()}
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=0,
                                             total_steps=100))
    state = init_train_state(cfg, params, tcfg, layout)
    step = make_train_step(cfg, rctx, tcfg, layout)
    kernels = _kernels()
    cs.reset_counts(kernels)
    with cs.plain_calls() as plain:
        params, state, m = step(params, state, batch)
        _sync(torch, device)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "launches": {k: kernels[k].launches for k in KERNELS},
           "plain": dict(plain)}
    mom = state["opt"]["m"]
    if layout is not None:
        mom = shd.gather_tree(mom, layout.ospecs["m"], mesh)
    if layout is None or dist.get_rank() == 0:
        out["m"] = {p: x.detach().cpu().numpy().copy()
                    for p, x in T.leaves_with_paths(mom)}
    return out


# ---- (a) slot steps ----------------------------------------------------------
def slot_run(torch, cfg, device, mesh, seed, fsdp=False):
    """``prefill`` of SLOT_B x SLOT_PROMPT tokens and SLOT_STEPS greedy
    ``decode_step``s (weights from seed 0 on the CPU, the cache this rank's
    shards on ``mesh``; ``fsdp``: the parameters at ZeRO-3 slices, gathered
    at use). Returns this rank's rows' logits and tokens, its kernel
    launches, and whether its cache leaves have ``cache_specs``' local
    shapes."""
    import numpy as np
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import make_rctx
    from repro_torch.models import model as TM
    from repro_torch.params import init_params
    from repro_torch.train import tree as T
    rctx = _no_drop(make_rctx(cfg, mesh, train=False, seq_len=SLOT_LEN,
                              fsdp=fsdp), cfg) if mesh is not None else None
    params = init_params(cfg, seed=0, device="cpu")
    if mesh is not None:
        params = shd.shard_tree(params, shd.param_specs(cfg, params, mesh,
                                                        fsdp=fsdp), mesh)
    params = T.tree_map(lambda x: x.to(device), params)
    enc = SLOT_ENC if cfg.enc_dec else 0
    cache = TM.init_cache(cfg, SLOT_B, SLOT_LEN, enc_len=enc, device=device,
                          mesh=mesh)
    shapes_ok = True
    if mesh is not None:
        whole = TM.init_cache(cfg, SLOT_B, SLOT_LEN, device="meta",
                              enc_len=enc)
        rule = shd.with_data_axis(mesh)
        shapes_ok = all(tuple(x.shape) == shd.local_shape(w.shape, s, rule)
                        for x, w, s in zip(T.leaves(cache), T.leaves(whole),
                                           T.leaves(shd.cache_specs(
                                               cfg, whole, rule))))
    rows = _rows(mesh, SLOT_B)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        SLOT_B, SLOT_PROMPT)).astype(np.int32))[rows].contiguous().to(device)
    extra = {}
    if cfg.num_patch_tokens:
        extra["extra_embeds"] = torch.from_numpy((rng.normal(size=(
            SLOT_B, cfg.num_patch_tokens, cfg.d_model)) * 0.02).astype(
                np.float32))[rows].contiguous().to(device)
    if cfg.enc_dec:
        extra["enc_embeds"] = torch.from_numpy((rng.normal(size=(
            SLOT_B, SLOT_ENC, cfg.d_model)) * 0.02).astype(np.float32))[
                rows].contiguous().to(device)
    kernels = _kernels()
    cs.reset_counts(kernels)
    with torch.no_grad():
        logits, cache = TM.prefill(cfg, params, toks, cache, rctx=rctx,
                                   **extra)
        outs, tokens = [logits], []
        for i in range(SLOT_STEPS):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            tokens.append(tok)
            logits, cache = TM.decode_step(cfg, params, tok, cache,
                                           SLOT_PROMPT + i, rctx=rctx)
            outs.append(logits)
        _sync(torch, device)
    return {"logits": torch.stack(outs).cpu().numpy(),
            "tokens": torch.cat(tokens, 1).cpu().numpy(),
            "launches": {k: kernels[k].launches for k in KERNELS},
            "shapes_ok": shapes_ok}


def _slot_cases():
    from repro_torch.configs import ARCHS
    return ([(a, "2x2", None) for a in ARCHS]
            + [("llama3.2-3b", "4", {"num_heads": 2, "num_kv_heads": 1})])


def _name(arch, mesh, changes):
    return f"{arch}{' 2 heads' if changes else ''} {mesh}"


def world4_rank(rank, world, dev):
    """(a) on this rank: the train steps, then the slot runs."""
    import torch
    from repro_torch.launch.mesh import make_train_mesh
    _setup(torch)
    meshes = {}

    def mesh(spec):
        if spec not in meshes:
            meshes[spec] = make_train_mesh(spec, device_type="cpu")
        return meshes[spec]
    out = {"train": {}, "slot": {}}
    for arch, spec, ch in TRAIN_CASES:
        out["train"][_name(arch, spec, ch)] = train_step(
            torch, _cfg(arch, ch), dev, mesh(spec), zlib.crc32(arch.encode()))
    for arch, spec, ch in _slot_cases():
        out["slot"][_name(arch, spec, ch)] = slot_run(
            torch, _cfg(arch, ch), dev, mesh(spec), zlib.crc32(arch.encode()))
    return out


def compare_train(name, got, want):
    """Phase 15's limits; returns the worst leaf's share of its limit."""
    import numpy as np
    for k in ("loss", "grad_norm"):
        if not abs(got[k] - want[k]) <= 2e-5 + 2e-5 * abs(want[k]):
            raise AssertionError(f"phase 18 (a) {name} {k} {got[k]} "
                                 f"against world 1's {want[k]}")
    if set(got["m"]) != set(want["m"]):
        raise AssertionError(f"phase 18 (a) {name}: the moments' leaves")
    worst = 0.0
    for p, w in want["m"].items():
        lim = 1e-4 * float(np.abs(w).max())
        err = float(np.abs(got["m"][p] - w).max())
        if not np.isfinite(got["m"][p]).all() or err > lim:
            raise AssertionError(f"phase 18 (a) {name} m{p}: {err} over "
                                 f"{lim}")
        worst = max(worst, err / lim if lim else 0.0)
    return worst


def world4_part(torch, device, device_line):
    """(a): the card's world-4 runs against the card's world-1 runs."""
    import numpy as np
    from repro_torch.launch.local_world import spawn_world
    _setup(torch)
    cuda = torch.device(device).type == "cuda"
    base_train = {_name(a, m, ch): train_step(torch, _cfg(a, ch), device,
                                              None, zlib.crc32(a.encode()))
                  for a, m, ch in TRAIN_CASES}
    base_slot = {_name(a, m, ch): slot_run(torch, _cfg(a, ch), device, None,
                                           zlib.crc32(a.encode()))
                 for a, m, ch in _slot_cases()}
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_world(world4_rank, 4, tmp, device=device,
                            timeout=600.0, group_timeout=540.0, dev=device)
    rec = {"train": {}, "slot": {}}
    for arch, spec, ch in TRAIN_CASES:
        name = _name(arch, spec, ch)
        got = ranks[0]["train"][name]
        worst = compare_train(name, got, base_train[name])
        calls = cs.train_kernel_calls(_cfg(arch, ch), True)
        for r, res in enumerate(ranks):
            res = res["train"][name]
            for k, n in calls.items():
                back = res["plain"].get(f"{k} backward", 0)
                if cuda and (res["launches"][k] != 2 * n or back != n):
                    raise AssertionError(
                        f"phase 18 (a) {name} rank {r}: {k} launched "
                        f"{res['launches'][k]}, plain backward {back}; "
                        f"expected {2 * n} and {n}")
            if cuda and any("forward" in k for k in res["plain"]):
                raise AssertionError(f"phase 18 (a) {name} rank {r}: plain "
                                     f"versions ran forward")
        rec["train"][name] = {
            "loss": got["loss"], "world1_loss": base_train[name]["loss"],
            "grad_norm": got["grad_norm"], "worst_share": worst,
            "launches_by_rank": [r["train"][name]["launches"]
                                 for r in ranks]}
        print(f"  (a) {name} train step (world 4): loss {got['loss']:.6f} "
              f"(world 1 {base_train[name]['loss']:.6f}), m worst "
              f"{worst:.3f} of its limit; #5 a rank "
              f"{got['launches']['chunked_prefill_attention']} "
              f"[{device_line}]", flush=True)
    for arch, spec, ch in _slot_cases():
        name = _name(arch, spec, ch)
        want = base_slot[name]
        diff = 0.0
        for r, res in enumerate(ranks):
            res = res["slot"][name]
            rows = _rows_of(spec, r)
            if not res["shapes_ok"]:
                raise AssertionError(f"phase 18 (a) {name} rank {r}: cache "
                                     f"shapes")
            if not np.array_equal(res["tokens"], want["tokens"][rows]):
                raise AssertionError(f"phase 18 (a) {name} rank {r}: greedy "
                                     f"tokens {res['tokens'].tolist()} "
                                     f"against world 1's "
                                     f"{want['tokens'][rows].tolist()}")
            diff = max(diff, float(np.abs(res["logits"]
                                          - want["logits"][:, rows]).max()))
        rec["slot"][name] = {"max_logit_diff": diff,
                             "launches_by_rank": [r["slot"][name]["launches"]
                                                  for r in ranks]}
        print(f"  (a) {name} prefill + {SLOT_STEPS} decode steps (world 4): "
              f"greedy tokens equal world 1's, logits within {diff:.2e}; "
              f"launches rank 0 {ranks[0]['slot'][name]['launches']} "
              f"[{device_line}]", flush=True)
    return rec


def _rows_of(spec, rank):
    """Rank ``rank``'s batch rows of SLOT_B on mesh ``spec`` (row-major
    ranks, the data axes first)."""
    dims = [int(x) for x in spec.split("x")]
    n_dp = math.prod(dims[:-1])
    if n_dp == 1 or SLOT_B % n_dp:
        return slice(None)
    i = rank // dims[-1]
    n = SLOT_B // n_dp
    return slice(i * n, (i + 1) * n)


# ---- (b) full width at mesh 2 ------------------------------------------------
def random_local_params(torch, cfg, mesh, device, seed=0):
    """This rank's shards of random weights, drawn on ``device`` leaf by
    leaf (the whole tree never exists): a leaf's replicated blocks alike on
    every rank, its sharded blocks from the shard's coordinates; norms 1,
    biases 0, matrices normal / sqrt(fan in)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.params import init_params
    from repro_torch.train import tree as T
    whole = init_params(cfg, device="meta")
    specs = shd.param_specs(cfg, whole, mesh)
    coords = {a: int(mesh.get_local_rank(a)) for a in mesh.mesh_dim_names}
    out = []
    for (path, x), spec in zip(T.leaves_with_paths(whole), T.leaves(specs)):
        shape = shd.local_shape(x.shape, spec, mesh)
        key = zlib.crc32(path.encode()) ^ seed
        for e in spec:
            for a in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                key = key * 31 + coords[a] + 1
        if path.endswith(("ln']", "norm']")):
            out.append(torch.ones(shape, dtype=x.dtype, device=device))
        elif "bias" in path:
            out.append(torch.zeros(shape, dtype=x.dtype, device=device))
        else:
            g = torch.Generator(device=device)
            g.manual_seed(key % (1 << 62))
            fan_in = x.shape[-2] if len(x.shape) >= 2 else 1
            out.append((torch.randn(shape, generator=g, device=device,
                                    dtype=torch.float32)
                        / math.sqrt(fan_in)).to(x.dtype))
    return T.unflatten(whole, out)


def _peak_gb(torch):
    return torch.cuda.max_memory_allocated() / 1e9


def seamless_train(torch, device, mesh):
    """seamless-m4t-large-v2 at full width: one AdamW step at mesh 2."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_rctx
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, TrainLayout,
                                              init_train_state,
                                              make_train_step)
    cfg = get_config("seamless-m4t-large-v2")
    torch.cuda.reset_peak_memory_stats()
    params = random_local_params(torch, cfg, mesh, device)
    layout = TrainLayout(cfg, mesh)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-5, warmup_steps=0,
                                             total_steps=100))
    state = init_train_state(cfg, params, tcfg, layout)
    step = make_train_step(cfg, make_rctx(cfg, mesh, train=True,
                                          seq_len=SEAMLESS_S), tcfg, layout)
    rng = np.random.default_rng(18)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, SEAMLESS_S)).astype(np.int32)).to(device),
        "enc_embeds": (torch.from_numpy(rng.normal(size=(
            2, SEAMLESS_S, cfg.d_model)).astype(np.float32)) * 0.02).to(
                device, cfg.dtype)}
    kernels = _kernels()
    cs.reset_counts(kernels)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    params, state, m = step(params, state, batch)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b)
    return {"loss": float(m["loss"]), "step_ms": ms,
            "tokens_per_s": 2 * SEAMLESS_S / (ms / 1e3),
            "peak_gb": _peak_gb(torch),
            "cpa_launches": kernels["chunked_prefill_attention"].launches}


def deepseek_serve(torch, device, mesh):
    """The 4-layer deepseek-v3 cut: prefill 2 x 512, 32 decode steps, at
    mesh 2; the time in ``combine_partials`` (CUDA events around each)."""
    import numpy as np
    from repro_torch.kernels import shard_utils as su
    from repro_torch.launch.steps import make_rctx
    from repro_torch.models import model as TM
    cfg = cs.deepseek_cut()
    torch.cuda.reset_peak_memory_stats()
    params = random_local_params(torch, cfg, mesh, device)
    rctx = make_rctx(cfg, mesh, train=False, seq_len=DS_LEN)
    cache = TM.init_cache(cfg, DS_B, DS_LEN, device=device, mesh=mesh)
    rng = np.random.default_rng(18)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        DS_B, DS_PROMPT)).astype(np.int32)).to(device)
    comb = []
    orig = su.combine_partials

    def timed(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(*args, **kw)
        b.record()
        comb.append((a, b))
        return out
    kernels = _kernels()
    cs.reset_counts(kernels)
    su.combine_partials = timed
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, cache = TM.prefill(cfg, params, toks, cache, rctx=rctx)
            torch.cuda.synchronize()
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            prefill_cpa = kernels["chunked_prefill_attention"].launches
            step_ms = []
            for i in range(DS_STEPS):
                tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                logits, cache = TM.decode_step(cfg, params, tok, cache,
                                               DS_PROMPT + i, rctx=rctx)
                b.record()
                b.synchronize()
                step_ms.append(a.elapsed_time(b))
    finally:
        su.combine_partials = orig
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("phase 18 (b) deepseek-v3: non-finite logits")
    comb_ms = sum(a.elapsed_time(b) for a, b in comb)
    return {"prefill_ms": prefill_ms, "decode_ms": step_ms,
            "decode_ms_median": sorted(step_ms)[len(step_ms) // 2],
            "peak_gb": _peak_gb(torch), "cpa_launches_prefill": prefill_cpa,
            "combine_calls": len(comb), "combine_ms_total": comb_ms,
            "combine_ms_per_step": comb_ms / DS_STEPS}


def full_rank(rank, world, dev):
    import torch
    from repro_torch.launch.mesh import make_train_mesh
    _setup(torch)
    mesh = make_train_mesh("2", device_type="cpu")
    out = {"seamless": seamless_train(torch, dev, mesh)}
    cs.release(torch)
    out["deepseek"] = deepseek_serve(torch, dev, mesh)
    return out


def full_part(torch, device, device_line):
    from repro_torch.launch.local_world import spawn_world
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_world(full_rank, 2, tmp, device=device, timeout=600.0,
                            group_timeout=540.0, dev=device)
    s = [r["seamless"] for r in ranks]
    d = [r["deepseek"] for r in ranks]
    if not all(math.isfinite(x["loss"]) for x in s) or \
            len({x["loss"] for x in s}) != 1:
        raise AssertionError(f"phase 18 (b) seamless losses "
                             f"{[x['loss'] for x in s]}")
    rec = {"seamless": {"reduced": [], "batch": 2, "seq": SEAMLESS_S,
                        "enc_frames": SEAMLESS_S, "loss": s[0]["loss"],
                        "step_ms": max(x["step_ms"] for x in s),
                        "tokens_per_s": min(x["tokens_per_s"] for x in s),
                        "peak_gb_by_rank": [x["peak_gb"] for x in s],
                        "cpa_launches_by_rank": [x["cpa_launches"]
                                                 for x in s]},
           "deepseek": {"reduced": cs.DEEPSEEK_REDUCED, "batch": DS_B,
                        "prompt": DS_PROMPT, "steps": DS_STEPS,
                        "by_rank": d}}
    print(f"  (b) seamless-m4t-large-v2 full width (nothing cut) at mesh 2: "
          f"one step {rec['seamless']['step_ms']:.1f} ms, "
          f"{rec['seamless']['tokens_per_s']:.0f} tokens/s, peak by rank "
          f"{[round(x, 2) for x in rec['seamless']['peak_gb_by_rank']]} GB, "
          f"#5 by rank {rec['seamless']['cpa_launches_by_rank']} "
          f"[{device_line}]", flush=True)
    print(f"  (b) deepseek-v3 4-layer cut at mesh 2: prefill 2x{DS_PROMPT} "
          f"{[round(x['prefill_ms'], 1) for x in d]} ms, decode "
          f"{[round(x['decode_ms_median'], 2) for x in d]} ms a step "
          f"(median), combine_partials "
          f"{[round(x['combine_ms_per_step'], 3) for x in d]} ms a step "
          f"({d[0]['combine_calls']} calls), #5 at prefill "
          f"{[x['cpa_launches_prefill'] for x in d]}, peak "
          f"{[round(x['peak_gb'], 2) for x in d]} GB [{device_line}]",
          flush=True)
    return rec


# ---- (c) the dry run on this torch -------------------------------------------
def dryrun_part(device_line, phase15=None):
    import torch

    from repro_torch.analysis import roofline as rl
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES, ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell
    from torch._subclasses.fake_tensor import FakeTensorMode
    rows = {}
    saved = os.environ.get("REPRO_FORCE_MESH")
    try:
        for arch, shape, spec, multi_pod in DRY_CELLS:
            if spec:
                os.environ["REPRO_FORCE_MESH"] = spec
            else:
                os.environ.pop("REPRO_FORCE_MESH", None)
            t0 = time.perf_counter()
            r = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                                verbose=False)
            wall = time.perf_counter() - t0
            rows[f"{arch} {shape} {spec or '16x16'}"] = row = {
                k: r[k] for k in ("mem_per_dev_gb", "analytic_gb",
                                  "fits_hbm", "flops_per_dev",
                                  "bytes_per_dev", "collective_bytes_per_dev",
                                  "collective_ops", "kernel_calls")}
            row.update(wall_s=wall, roofline=r["roofline"].row())
            print(f"  (c) dry run {arch} {shape} at {spec or '16x16'}: "
                  f"{r['roofline'].row()} ({wall:.1f} s on the host; "
                  f"device figures are the H100 SXM5 spec sheet's) "
                  f"[{device_line}]", flush=True)
        os.environ["REPRO_FORCE_MESH"] = "1x1"
        cfg = get_config("llama3.2-3b")
        shape = ShapeSpec(name="phase15_c", seq_len=cs.FULL_S,
                          global_batch=cs.FULL_B, kind="train")
        SHAPES[shape.name] = shape
        with dryrun.fake_world(1):
            mesh = make_production_mesh(device_type="cpu")
            with FakeTensorMode():
                cell = build_cell("llama3.2-3b", shape.name, mesh,
                                  device=dryrun.trace_device())
                counts = rl.trace(cell.fn, *cell.inputs)
        analytic = rl.analytic_memory_bytes(cell.inputs, cfg, shape, 1,
                                            accum=1)
        mf = rl.model_flops_estimate(cfg, shape)
        p15 = phase15 or {}
        rows["phase15_c"] = {"analytic": analytic, "model_flops": mf,
                             "traced_flops": counts.flops,
                             "traced_peak_gb": counts.peak_bytes / 1e9,
                             "measured_peak_gb": p15.get("peak_mem_gb"),
                             "measured_6N_tokens": p15.get("flops")}
        print(f"  (c) phase 15 (c)'s step (llama3.2-3b B{cs.FULL_B} x "
              f"S{cs.FULL_S}, world 1): analytic_memory_bytes "
              f"{analytic['total_bytes'] / 1e9:.2f} GB (args "
              f"{analytic['args_bytes'] / 1e9:.2f}), traced peak "
              f"{counts.peak_bytes / 1e9:.2f} GB, measured peak "
              f"{p15.get('peak_mem_gb', 'not measured in this run')} GB; "
              f"model_flops_estimate {mf:.4e}, traced {counts.flops:.4e}, "
              f"phase 15's 6 N tokens "
              f"{p15.get('flops', 'not measured in this run')} "
              f"[{device_line}]", flush=True)
    finally:
        SHAPES.pop("phase15_c", None)
        if saved is None:
            os.environ.pop("REPRO_FORCE_MESH", None)
        else:
            os.environ["REPRO_FORCE_MESH"] = saved
    return rows


def start_host_part(script, device_line, *args, env=None):
    """``script --dry-run-only OUT --device-line LINE *args`` in a process
    of its own: a dry run, which needs only the host. Returns (the
    process, OUT)."""
    fd, out = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    proc = subprocess.Popen([sys.executable, str(script), "--dry-run-only",
                             out, "--device-line", device_line, *args],
                            env=env)
    return proc, out


def finish_host_part(proc, out, what):
    """The rows that a :func:`start_host_part` process wrote, once it has
    ended; raises if it failed."""
    try:
        code = proc.wait(timeout=1200)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if code != 0:
        raise RuntimeError(f"{what}: the dry run exited {code}")
    with open(out) as f:
        rows = json.load(f)
    os.unlink(out)
    return rows


def start_dryrun(device_line, phase15=None):
    """(c) in a process of its own (:func:`start_host_part`)."""
    return start_host_part(Path(__file__).resolve(), device_line,
                           "--phase15", json.dumps(phase15 or {}))


def mesh_all_phase(torch, phase15=None, device_line=None, dryrun=None):
    """Phase 18 (see the module docstring). Returns its record and the
    launches of its main paths by kernel. ``dryrun``: (c) already started
    (:func:`start_dryrun`); its rows are read after (b)."""
    device_line = device_line or cs.device_line()
    cs.release(torch)
    t0 = time.perf_counter()
    a = world4_part(torch, cs.DEVICE, device_line)
    t1 = time.perf_counter()
    b = full_part(torch, cs.DEVICE, device_line)
    t2 = time.perf_counter()
    c = (dryrun_part(device_line, phase15) if dryrun is None
         else finish_host_part(*dryrun, "phase 18 (c)"))
    rec = {"device": device_line, "world4": a, "full": b, "dryrun": c,
           "seconds": {"a": t1 - t0, "b": t2 - t1,
                       "c": time.perf_counter() - t2}}
    launches = {}
    for part in ("train", "slot"):
        for name, r in a[part].items():
            for k in KERNELS:
                n = sum(x[k] for x in r["launches_by_rank"])
                if n:
                    launches.setdefault(k, {})[
                        f"mesh {part} {name} (4 ranks)"] = n
    launches.setdefault("chunked_prefill_attention", {})[
        "seamless-m4t full-width training step at mesh 2 (2 ranks)"] = sum(
        b["seamless"]["cpa_launches_by_rank"])
    launches["chunked_prefill_attention"][
        "deepseek-v3 cut prefill at mesh 2 (2 ranks)"] = sum(
        x["cpa_launches_prefill"] for x in b["deepseek"]["by_rank"])
    print(f"  phase 18: {sum(rec['seconds'].values()):.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in rec["seconds"].items())
          + f") [{device_line}]", flush=True)
    return rec, launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry-run-only", metavar="OUT",
                    help="(c) alone, its rows as JSON into OUT")
    ap.add_argument("--device-line", help="the card's name and power limit")
    ap.add_argument("--phase15", default="{}",
                    help="phase 15 (c)'s peak_mem_gb and flops, as JSON")
    args = ap.parse_args()
    if args.dry_run_only:
        rows = dryrun_part(args.device_line, json.loads(args.phase15))
        with open(args.dry_run_only, "w") as f:
            json.dump(rows, f)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("mesh_all_phase: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    dev = cs.device_line()
    print(f"{dev}; torch {torch.__version__}", flush=True)
    _setup(torch)
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    rec, launches = mesh_all_phase(torch, device_line=dev)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mesh_all_phase.json").write_text(json.dumps(
        {"record": rec, "launches": launches}, indent=1, default=str))
    print(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
