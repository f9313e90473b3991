#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py``: ZeRO-3 parameters (``fsdp``) and the wide
data-parallel batch (``wide_dp``). Alone (it builds the kernels first):

    python3 tools/fsdp_phase.py

Ranks are spawned processes on the one card (``launch/local_world``),
joined by a ``file://`` store; ranks that share a card run gloo, which
copies CUDA tensors through the host, so the gathers and reduce-scatters
here are gloo's, not NCCL's between cards. TF32 is off in every rank.

(a) World 4, mesh ``2x2``, fp32 smoke configs (weights drawn on the CPU
    from seed 0), one AdamW step on a batch of 4 x 32:
    - llama3.2-3b, jamba (14 leaves sliced along their repetitions, the
      MoE expert-parallel) and deepseek-v3 (MLA, MTP, the MoE
      expert-parallel) with the parameters and AdamW's state at
      ``param_specs(..., fsdp=True)``'s slices: the loss, the gradient norm
      and every leaf of the first moment (gathered) against the card's
      world-1 step (llama) or the same world-4 step on the CPU (the
      expert-parallel archs, whose loss is not the dense one), at phase
      15's limits (2e-5 + 2e-5 |ref|; each leaf 1e-4 max |m_ref|); on
      every rank each parameter leaf and each state slice still at its
      local shape after the step; #5/#6/#7 twice a layer a rank (forward
      and the remat recompute), their plain versions in the backward
      only;
    - xlstm-125m with the batch's rows on ``("data", "model")`` (a row a
      rank): the same against the card's world-1 step, #7 twice a layer a
      rank;
    - llama3.2-3b and jamba under ``fsdp``: ``prefill`` of 2 x 20 tokens
      and 4 greedy ``decode_step``s (``mesh_all_phase.slot_run``) give the
      card's world-1 tokens.
(b) Full-width llama3.2-3b (bf16, phase 15's weights from seed 0 and its
    batch, B2 x S2048, a row a rank) at mesh ``2x1`` (data 2) under
    ``fsdp``, each rank capped at half the card
    (``set_per_process_memory_fraction(0.5)``): two AdamW steps, the
    first loss within 1e-2 of phase 15's (a one-rank forward here when
    run alone), #5 56 launches a step on each rank; each step's time
    (CUDA events), tokens/s, each rank's peak memory, and the all-gather
    and reduce-scatter time a step (CUDA events around each). Then, in
    the same world with the fsdp state freed, one ZeRO-1 step at the same
    mesh and cap for its peak, or, where two ZeRO-1 ranks do not fit in
    the card's halves, its out-of-memory error (both ranks run the same
    allocations, so both raise at the same one).
(c) ``launch.dryrun.run_cell(..., fsdp=True)`` for deepseek-v3
    ``train_4k`` at 16x16 (jamba's cell, 95 s more, is left out for the
    time limit of ``chip_smoke.py``; ``--dry-archs`` names others): rank
    0's traced peak and ``analytic_memory_bytes``, beside the analytic
    figure without ``fsdp`` (built, not traced) and phase 18 (c)'s traced
    deepseek-v3 row when run inside ``chip_smoke.py``. Counts of the
    traced program, not device measurements. It runs in a process of its
    own (the fake process group is process-wide; ``chip_smoke.py`` starts
    it before phase 16) while (a) and (b) run, with no card visible, so
    that it holds none of the card's memory: its fake tensors lie on the
    CPU device, which changes no count (phase 18 (c) traces on "cuda" and
    gives the sandbox's counts to the digit).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import mesh_all_phase as ma  # noqa: E402
import train_sharded_phase as ts  # noqa: E402

FSDP_ARCHS = ("llama3.2-3b", "jamba-1.5-large-398b", "deepseek-v3-671b")
EP_ARCHS = ("jamba-1.5-large-398b", "deepseek-v3-671b")
WIDE_ARCH = "xlstm-125m"
SLOT_ARCHS = ("llama3.2-3b", "jamba-1.5-large-398b")
B, S = 4, 32
FULL_STEPS = 2
DRY_ARCHS = ("deepseek-v3-671b",)
KERNELS = ma.KERNELS


def _name(arch, option):
    return f"{arch} {option}"


def _batch(torch, cfg, arch):
    import numpy as np
    rng = np.random.default_rng(zlib.crc32(arch.encode()))
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32))


def train_step(torch, arch, device, mesh, fsdp=False, wide_dp=False):
    """One AdamW step of ``arch``'s smoke config (weights from seed 0 on the
    CPU) on ``mesh`` (None: one device). Returns the loss, the gradient
    norm, the first moment (whole, numpy, on rank 0 or without a mesh),
    whether every parameter leaf and state slice is at its local shape
    after the step, and this rank's #5/#6/#7 launches and plain calls."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import shard_utils as su
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import make_rctx
    from repro_torch.params import init_params
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, TrainLayout,
                                              init_train_state,
                                              make_train_step)
    cfg = get_config(arch).smoke()
    rctx = make_rctx(cfg, mesh, train=True, seq_len=S)
    params = init_params(cfg, seed=0, device="cpu")
    tokens = _batch(torch, cfg, arch)
    layout = None
    if mesh is not None:
        layout = TrainLayout(cfg, mesh, fsdp=fsdp, wide_dp=wide_dp)
        params = shd.shard_tree(params, layout.pspecs, mesh)
        ax = su.mesh_axis(mesh, shd.batch_axes(mesh, B, wide_dp))
        n = B // ax.size
        tokens = tokens[ax.index * n:(ax.index + 1) * n]
    params = T.tree_map(lambda x: x.to(device), params)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=0,
                                             total_steps=100))
    state = init_train_state(cfg, params, tcfg, layout)
    step = make_train_step(cfg, rctx, tcfg, layout)
    kernels = ma._kernels()
    cs.reset_counts(kernels)
    with cs.plain_calls() as plain:
        params, state, m = step(params, state,
                                {"tokens": tokens.contiguous().to(device)})
        ma._sync(torch, device)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "launches": {k: kernels[k].launches for k in KERNELS},
           "plain": dict(plain), "shapes_ok": True}
    mom = state["opt"]["m"]
    if layout is not None:
        pairs = [(T.leaves(params), T.leaves(layout.pspecs))] + [
            (T.flatten_up_to(params, state["opt"][k]),
             T.flatten_up_to(params, layout.ospecs[k]))
            for k in ("m", "v", "master")]
        out["shapes_ok"] = all(
            x is None or tuple(x.shape) == shd.local_shape(full, s, mesh)
            for xs, specs in pairs
            for x, s, full in zip(xs, specs, layout.shapes))
        mom = shd.gather_tree(mom, layout.ospecs["m"], mesh)
    if layout is None or dist.get_rank() == 0:
        out["m"] = {p: x.detach().cpu().numpy().copy()
                    for p, x in T.leaves_with_paths(mom)}
    return out


def world4_rank(rank, world, dev, archs, wide, slot):
    """(a) on this rank: the fsdp steps of ``archs``, the wide step (when
    ``wide``), the fsdp slot runs (when ``slot``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_train_mesh
    ma._setup(torch)
    mesh = make_train_mesh("2x2", device_type="cpu")
    out = {"train": {}, "slot": {}}
    for arch in archs:
        out["train"][_name(arch, "fsdp")] = train_step(torch, arch, dev,
                                                       mesh, fsdp=True)
    if wide:
        out["train"][_name(WIDE_ARCH, "wide_dp")] = train_step(
            torch, WIDE_ARCH, dev, mesh, wide_dp=True)
    if slot:
        for arch in SLOT_ARCHS:
            out["slot"][arch] = ma.slot_run(
                torch, get_config(arch).smoke(), dev, mesh,
                zlib.crc32(arch.encode()), fsdp=True)
    return out


def compare(name, got, want):
    """Phase 15's limits; returns the worst leaf's share of its limit."""
    import numpy as np
    for k in ("loss", "grad_norm"):
        if not abs(got[k] - want[k]) <= 2e-5 + 2e-5 * abs(want[k]):
            raise AssertionError(f"phase 19 (a) {name} {k} {got[k]} "
                                 f"against {want[k]}")
    if set(got["m"]) != set(want["m"]):
        raise AssertionError(f"phase 19 (a) {name}: the moments' leaves")
    worst = 0.0
    for p, w in want["m"].items():
        lim = 1e-4 * float(np.abs(w).max())
        err = float(np.abs(got["m"][p] - w).max())
        if not np.isfinite(got["m"][p]).all() or err > lim:
            raise AssertionError(f"phase 19 (a) {name} m{p}: {err} over "
                                 f"{lim}")
        worst = max(worst, err / lim if lim else 0.0)
    return worst


def world4_part(torch, device, device_line):
    """(a): the card's world-4 runs against the card's world-1 runs (dense)
    or the CPU's world-4 steps (expert-parallel)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.local_world import spawn_world
    from concurrent.futures import ThreadPoolExecutor
    ma._setup(torch)
    cuda = torch.device(device).type == "cuda"
    # the card's world and the CPU's run at once, each a spawned world
    # that a thread waits on, while this process runs the world-1 steps
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as ex:
        card = ex.submit(spawn_world, world4_rank, 4, os.path.join(
            tmp, "card"), device=device, timeout=600.0, group_timeout=540.0,
            dev=device, archs=FSDP_ARCHS, wide=True, slot=True)
        cpu = ex.submit(spawn_world, world4_rank, 4, os.path.join(
            tmp, "cpu"), device="cpu", timeout=600.0, group_timeout=540.0,
            dev="cpu", archs=EP_ARCHS, wide=False, slot=False)
        base = {_name(a, o): train_step(torch, a, device, None)
                for a, o in (("llama3.2-3b", "fsdp"),
                             (WIDE_ARCH, "wide_dp"))}
        base_slot = {a: ma.slot_run(torch, get_config(a).smoke(), device,
                                    None, zlib.crc32(a.encode()))
                     for a in SLOT_ARCHS}
        ranks, cpu = card.result(), cpu.result()[0]["train"]
    base.update({_name(a, "fsdp"): cpu[_name(a, "fsdp")] for a in EP_ARCHS})
    rec = {"train": {}, "slot": {}}
    for name in list(ranks[0]["train"]):
        arch = name.split()[0]
        got = ranks[0]["train"][name]
        where = ("the CPU's world-4 step" if arch in EP_ARCHS
                 else "the card's world-1 step")
        worst = compare(name, got, base[name])
        calls = cs.train_kernel_calls(get_config(arch).smoke(), False)
        for r, res in enumerate(ranks):
            res = res["train"][name]
            if not res["shapes_ok"]:
                raise AssertionError(f"phase 19 (a) {name} rank {r}: a leaf "
                                     f"left its local shape")
            for k, n in calls.items():
                back = res["plain"].get(f"{k} backward", 0)
                if cuda and (res["launches"][k] != 2 * n or back != n):
                    raise AssertionError(
                        f"phase 19 (a) {name} rank {r}: {k} launched "
                        f"{res['launches'][k]}, plain backward {back}; "
                        f"expected {2 * n} and {n}")
            if cuda and any("forward" in k for k in res["plain"]):
                raise AssertionError(f"phase 19 (a) {name} rank {r}: plain "
                                     f"versions ran forward")
        rec["train"][name] = {
            "loss": got["loss"], "ref_loss": base[name]["loss"],
            "against": where, "grad_norm": got["grad_norm"],
            "worst_share": worst,
            "launches_by_rank": [r["train"][name]["launches"]
                                 for r in ranks]}
        print(f"  (a) {name} train step at 2x2 (world 4): loss "
              f"{got['loss']:.6f} ({where} {base[name]['loss']:.6f}), m "
              f"worst {worst:.3f} of its limit, every leaf at its local "
              f"shape; launches a rank "
              + ", ".join(f"{k.split('_')[0]} {got['launches'][k]}"
                          for k in KERNELS if got["launches"][k])
              + f" [{device_line}]", flush=True)
    for arch in SLOT_ARCHS:
        want = base_slot[arch]
        diff = 0.0
        for r, res in enumerate(ranks):
            res = res["slot"][arch]
            rows = ma._rows_of("2x2", r)
            if not res["shapes_ok"]:
                raise AssertionError(f"phase 19 (a) {arch} slot rank {r}: "
                                     f"cache shapes")
            if not np.array_equal(res["tokens"], want["tokens"][rows]):
                raise AssertionError(
                    f"phase 19 (a) {arch} fsdp slot rank {r}: greedy tokens "
                    f"{res['tokens'].tolist()} against world 1's "
                    f"{want['tokens'][rows].tolist()}")
            diff = max(diff, float(np.abs(res["logits"]
                                          - want["logits"][:, rows]).max()))
        rec["slot"][arch] = {"max_logit_diff": diff,
                             "launches_by_rank": [r["slot"][arch]["launches"]
                                                  for r in ranks]}
        print(f"  (a) {arch} fsdp prefill + {ma.SLOT_STEPS} decode steps "
              f"(world 4): greedy tokens equal world 1's, logits within "
              f"{diff:.2e}; launches rank 0 "
              f"{ranks[0]['slot'][arch]['launches']} [{device_line}]",
              flush=True)
    return rec


# ---- (b) full width at mesh 2x1 ------------------------------------------------
def full_rank(rank, world, dev, steps):
    """(b) on this rank, the rank capped at half the card: the fsdp run
    (:func:`full_steps`), then one ZeRO-1 step."""
    import torch
    from repro_torch.launch.mesh import make_train_mesh
    ma._setup(torch)
    if torch.device(dev).type == "cuda":
        torch.cuda.set_per_process_memory_fraction(0.5)
    mesh = make_train_mesh("2x1", device_type="cpu")
    return {"fsdp": full_steps(torch, rank, dev, mesh, True, steps),
            "zero1": full_steps(torch, rank, dev, mesh, False, 1)}


def full_steps(torch, rank, dev, mesh, fsdp, steps):
    """``steps`` AdamW steps of full-width llama3.2-3b on ``mesh`` on this
    rank's row of phase 15's batch. Returns its losses, step times, #5
    launches, collectives' ms by kind, its peak memory; or, for a ZeRO-1
    step that ran out of memory, the error."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import make_rctx
    from repro_torch.params import init_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, TrainLayout,
                                              init_train_state,
                                              make_train_step)
    cuda = torch.device(dev).type == "cuda"
    cfg = get_config("llama3.2-3b")
    rctx = make_rctx(cfg, mesh, train=True, seq_len=cs.FULL_S)
    layout = TrainLayout(cfg, mesh, fsdp=fsdp)
    params = shd.shard_tree(init_params(cfg, seed=0, device=dev),
                            layout.pspecs, mesh)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=cs.FULL_LR, warmup_steps=0,
                                             total_steps=1000))
    state = init_train_state(cfg, params, tcfg, layout)
    step = make_train_step(cfg, rctx, tcfg, layout)
    batch = {"tokens": ts.full_batch(torch, cfg, dev)["tokens"][
        rank:rank + 1].contiguous()}
    kernels = ma._kernels()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rec = {"fsdp": fsdp, "loss": [], "step_ms": [], "cpa_launches": [],
           "collectives_ms": []}
    for _ in range(steps):
        cs.reset_counts(kernels)
        try:
            with ts.instrumented(torch) as (events, _), \
                    ts.Clock(torch, dev) as clk:
                params, state, m = step(params, state, batch)
        except torch.cuda.OutOfMemoryError as e:   # ZeRO-1's fit only
            if fsdp:
                raise
            rec["oom"] = str(e).splitlines()[0]
            break
        rec["loss"].append(float(m["loss"]))
        rec["step_ms"].append(clk.ms)
        rec["cpa_launches"].append(
            kernels["chunked_prefill_attention"].launches)
        rec["collectives_ms"].append({k: sum(a.elapsed_time(b) for a, b in v)
                                      for k, v in events.items()})
    rec["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9 if cuda
                          else None)
    del params, state, step
    if cuda:
        torch.cuda.empty_cache()
    return rec


def full_part(torch, device, device_line, phase15_loss=None,
              steps=FULL_STEPS):
    """(b): the fsdp world, then the ZeRO-1 world, each of 2 ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch.local_world import spawn_world
    cfg = get_config("llama3.2-3b")
    cuda = torch.device(device).type == "cuda"
    ref = phase15_loss if phase15_loss is not None else ts.one_rank_loss(
        torch, cfg, device)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_world(full_rank, 2, tmp, device=device, timeout=900.0,
                            group_timeout=600.0, dev=device, steps=steps)
    recs = [r["fsdp"] for r in ranks]
    losses = [r["loss"] for r in recs]
    if any(x != losses[0] for x in losses):
        raise AssertionError(f"phase 19 (b): the ranks' losses differ: "
                             f"{losses}")
    losses = losses[0]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 19 (b): losses {losses}")
    if not abs(losses[0] - ref) <= 1e-2 * abs(ref):
        raise AssertionError(f"phase 19 (b): first loss {losses[0]} "
                             f"against phase 15's {ref}")
    want = 2 * cfg.num_layers
    if cuda and any(n != want for r in recs for n in r["cpa_launches"]):
        raise AssertionError(f"phase 19 (b): #5 launched "
                             f"{[r['cpa_launches'] for r in recs]} a step "
                             f"by rank, expected {want}")
    step_ms = [max(r["step_ms"][i] for r in recs) for i in range(steps)]
    coll = [{k: max(r["collectives_ms"][i].get(k, 0.0) for r in recs)
             for k in set().union(*(r["collectives_ms"][i] for r in recs))}
            for i in range(steps)]
    zero1 = [r["zero1"] for r in ranks]
    rec = {"arch": cfg.name, "mesh": "2x1", "batch": cs.FULL_B,
           "seq": cs.FULL_S, "losses": losses, "phase15_loss": ref,
           "step_ms": step_ms,
           "tokens_per_s": [cs.FULL_B * cs.FULL_S / (t / 1e3)
                            for t in step_ms],
           "collectives_ms": coll,
           "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in recs],
           "cpa_launches_by_rank": [r["cpa_launches"] for r in recs],
           "zero1_peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in zero1],
           "zero1_oom": [r.get("oom") for r in zero1],
           "zero1_step_ms": [r["step_ms"] for r in zero1],
           # half the bf16 parameters and half their bf16 gradient
           "reckoned_saving_gb": cfg.param_count() * 2 / 1e9}
    z = ("out of memory in the card's half: " + "; ".join(
        str(e) for e in rec["zero1_oom"]) if any(rec["zero1_oom"])
        else f"peak by rank {rec['zero1_peak_mem_gb_by_rank']} GB, a step "
             f"{rec['zero1_step_ms']} ms")
    print(f"  (b) llama3.2-3b full width, fsdp at mesh 2x1 (data 2, B"
          f"{cs.FULL_B} x S{cs.FULL_S}, a row a rank): losses "
          f"{[round(x, 5) for x in losses]} (phase 15's first {ref:.5f}); "
          f"steps {[round(t, 1) for t in step_ms]} ms, "
          f"{rec['tokens_per_s'][-1]:.0f} tokens/s; collectives a step "
          f"{[{k: round(v, 1) for k, v in c.items()} for c in coll]} ms; "
          f"peak by rank {rec['peak_mem_gb_by_rank']} GB; ZeRO-1 at 2x1: "
          f"{z}; reckoned saving {rec['reckoned_saving_gb']:.2f} GB a rank;"
          f" #5 launches by rank {rec['cpa_launches_by_rank']} "
          f"[{device_line}]", flush=True)
    return rec


# ---- (c) the dry run under fsdp ---------------------------------------------------
def start_dryrun(device_line, archs=DRY_ARCHS):
    """(c) in a process of its own with no card visible
    (``mesh_all_phase.start_host_part``)."""
    return ma.start_host_part(Path(__file__).resolve(), device_line,
                              "--dry-archs", *archs,
                              env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def finish_dryrun(proc, out, device_line, phase18=None):
    """(c)'s rows, with phase 18 (c)'s traced peak without ``fsdp``."""
    rows = ma.finish_host_part(proc, out, "phase 19 (c)")
    for arch, row in rows.items():
        traced = (phase18 or {}).get(f"{arch} train_4k 16x16", {})
        row["traced_gb_without"] = traced.get("mem_per_dev_gb")
        print(f"  (c) {arch} train_4k at 16x16: traced peak "
              f"{row['mem_per_dev_gb']:.2f} GB a rank with fsdp, "
              f"{row['traced_gb_without'] or 'not traced in this run'} "
              f"without (phase 18 (c)) [{device_line}]", flush=True)
    return rows


def dryrun_part(device_line, archs=DRY_ARCHS):
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import roofline as rl
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell
    rows = {}
    saved = os.environ.pop("REPRO_FORCE_MESH", None)
    try:
        for arch in archs:
            t0 = time.perf_counter()
            r = dryrun.run_cell(arch, "train_4k", multi_pod=False,
                                verbose=False, fsdp=True)
            wall = time.perf_counter() - t0
            with dryrun.fake_world(256):
                mesh = make_production_mesh(device_type="cpu")
                dryrun._warm_groups(mesh)
                with FakeTensorMode():
                    cell = build_cell(arch, "train_4k", mesh,
                                      device=dryrun.trace_device())
            plain = rl.analytic_memory_bytes(cell.inputs, cell.cfg,
                                             cell.shape, 16, accum=4)
            del cell
            rows[arch] = row = {
                k: r[k] for k in ("mem_per_dev_gb", "analytic_gb",
                                  "args_gb", "fits_hbm", "flops_per_dev",
                                  "collective_bytes_per_dev",
                                  "collective_ops", "collective_by_kind")}
            row.update(wall_s=wall,
                       analytic_gb_without=plain["total_bytes"] / 1e9)
            print(f"  (c) dry run {arch} train_4k at 16x16 --fsdp: traced "
                  f"peak {r['mem_per_dev_gb']:.2f} GB a rank, analytic "
                  f"{r['analytic_gb']:.2f} GB (args {r['args_gb']:.2f}); "
                  f"without fsdp analytic {row['analytic_gb_without']:.2f}"
                  f" GB; collectives {r['collective_by_kind']} "
                  f"({wall:.1f} s on the host; counts of the traced "
                  f"program) [{device_line}]", flush=True)
    finally:
        if saved is not None:
            os.environ["REPRO_FORCE_MESH"] = saved
    return rows


def fsdp_phase(torch, phase15_loss=None, phase18=None, device_line=None,
               dryrun=None):
    """Phase 19 (see the module docstring). Returns its record and the
    launches of its main paths by kernel. ``dryrun``: (c) already started
    (:func:`start_dryrun`)."""
    device_line = device_line or cs.device_line()
    cs.release(torch)
    t0 = time.perf_counter()
    proc, out = dryrun or start_dryrun(device_line)
    try:
        a = world4_part(torch, cs.DEVICE, device_line)
        t1 = time.perf_counter()
        b = full_part(torch, cs.DEVICE, device_line,
                      phase15_loss=phase15_loss)
        t2 = time.perf_counter()
        c = finish_dryrun(proc, out, device_line, phase18)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rec = {"device": device_line, "world4": a, "full": b, "dryrun": c,
           "seconds": {"a": t1 - t0, "b": t2 - t1,
                       "c after b": time.perf_counter() - t2}}
    launches = {}
    for part in ("train", "slot"):
        for name, r in a[part].items():
            for k in KERNELS:
                n = sum(x[k] for x in r["launches_by_rank"])
                if n:
                    launches.setdefault(k, {})[
                        f"fsdp/wide {part} {name} (4 ranks)"] = n
    launches.setdefault("chunked_prefill_attention", {})[
        f"llama3.2-3b fsdp training at 2x1, {FULL_STEPS} steps (2 ranks)"] \
        = sum(sum(x) for x in b["cpa_launches_by_rank"])
    print(f"  phase 19: {sum(rec['seconds'].values()):.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in rec["seconds"].items())
          + f") [{device_line}]", flush=True)
    return rec, launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry-run-only", metavar="OUT",
                    help="(c) alone, its rows as JSON into OUT")
    ap.add_argument("--dry-archs", nargs="+", default=list(DRY_ARCHS))
    ap.add_argument("--device-line", help="the card's name and power "
                    "limit, for (c)'s lines")
    args = ap.parse_args()
    if args.dry_run_only:        # the host alone, fake tensors on the CPU
        from repro_torch.launch import dryrun
        dryrun.trace_device = lambda: "cpu"
        rows = dryrun_part(args.device_line, args.dry_archs)
        with open(args.dry_run_only, "w") as f:
            json.dump(rows, f)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("fsdp_phase: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    dev = cs.device_line()
    print(f"{dev}; torch {torch.__version__}", flush=True)
    ma._setup(torch)
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    rec, launches = fsdp_phase(torch, device_line=dev)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fsdp_phase.json").write_text(json.dumps(
        {"record": rec, "launches": launches}, indent=1, default=str))
    print(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
