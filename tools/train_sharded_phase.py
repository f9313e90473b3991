#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py``: sharded training on one card, over ranks
that share it. Alone (it builds the kernels first):

    python3 tools/train_sharded_phase.py

Each world is spawned processes (``repro_torch.launch.local_world``), every
rank on the one card, joined by a ``file://`` store. Ranks that share a
card cannot use NCCL, so the data plane is gloo, which takes CUDA
tensors for every collective of ``kernels/shard_utils.py`` and copies them
through the host: the phase tests the sharded step's dispatch and
collectives, not NCCL between cards. TF32 is off in every rank.

(a) Every slice arch's smoke config (fp32; the weights drawn on the CPU
    from seed 0) at world 4, mesh ``2x2``, one AdamW step on a batch of 4
    x 32: the loss, the gradient norm and every leaf of the first moment
    (gathered) against the card's world-1 step on the same weights and
    batch (the dense archs: the sharded step computes the same function),
    or against the same world-4 step on the CPU (qwen2-moe-a2.7b and
    jamba: their expert-parallel loss is not the dense one), within phase
    15's limits (the loss 2e-5 + 2e-5 |ref|, each leaf 1e-4 max |m_ref|).
    On every rank #5/#6/#7 launch twice a layer (forward and the remat
    recompute) and no plain version runs forward.
(b) Full-width llama3.2-3b (bf16, 28 layers, weights from seed 0 as phase
    15's, its batch: ``PackedSyntheticData`` B2 x S2048) at world 2, mesh
    ``2`` (``model`` 2: 12 q / 4 kv heads a rank, #5 at G 3; the MLP, the
    embedding and the loss's vocabulary halved), two AdamW steps (phase
    15's rate): the first loss within 1e-2 relative of the one-rank loss
    on the same weights and batch (phase 15's when given, else a no-grad
    forward here), #5 56 launches a step on each rank. Reports each
    step's time (CUDA events), tokens/s, each rank's peak memory and the
    time in collectives a step (CUDA events around each).
(c) qwen2-moe-a2.7b at every published width, ``num_layers`` 24 -> 4
    (what two ranks sharing the card hold with AdamW's state; 3.04 B
    parameters, 24 GB of state a rank), expert-parallel at world 2, mesh
    ``2`` (32 of the 64 padded experts a rank), the same batch, two
    steps: every loss finite, the last below the first. Reports the
    tokens dropped by capacity and the ``all_to_all`` time a step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import sys
import tempfile
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SMOKE_ARCHS = ("llama3.2-3b", "gemma2-2b", "gemma2-27b", "qwen3-1.7b",
               "qwen2-moe-a2.7b", "jamba-1.5-large-398b", "xlstm-125m")
EP_ARCHS = ("qwen2-moe-a2.7b", "jamba-1.5-large-398b")
SMOKE_B, SMOKE_S, SMOKE_LR = 4, 32, 1e-3
FULL_STEPS = 2
MOE_LAYERS, MOE_LR = 4, 1e-4
MOE_REDUCED = ["num_layers 24 -> 4 (MoE layers 24 -> 4)"]
KERNELS = ("chunked_prefill_attention", "mamba_scan", "mlstm_chunkwise")


def _kernels():
    from repro_torch.kernels.chunked_prefill_attention import kernel as k5
    from repro_torch.kernels.mamba_scan import kernel as k6
    from repro_torch.kernels.mlstm_chunkwise import kernel as k7
    return {"chunked_prefill_attention": k5.chunked_prefill_attention,
            "mamba_scan": k6.mamba_scan,
            "mlstm_chunkwise": k7.mlstm_chunkwise}


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Clock:
    """CUDA events on the card, the host clock on the CPU (rehearsals)."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.a = self.torch.cuda.Event(enable_timing=True)
            self.b = self.torch.cuda.Event(enable_timing=True)
            self.a.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            self.ms = self.a.elapsed_time(self.b)
        else:
            self.ms = 1e3 * (time.perf_counter() - self.t0)


def smoke_batch(cfg, arch):
    import numpy as np
    rng = np.random.default_rng(zlib.crc32(arch.encode()))
    return rng.integers(0, cfg.vocab_size, (SMOKE_B, SMOKE_S)).astype(
        np.int32)


def _setup_rank(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def smoke_step(torch, arch, device, mesh):
    """One AdamW step of ``arch``'s smoke config (weights drawn on the CPU
    from seed 0, moved to ``device``) on ``mesh`` (None: one device).
    Returns the loss, the gradient norm, the first moment (whole, as numpy,
    on rank 0 or without a mesh), and this rank's #5/#6/#7 launches and
    plain-version calls."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import make_rctx
    from repro_torch.params import init_params
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, TrainLayout,
                                              init_train_state,
                                              make_train_step)
    cfg = get_config(arch).smoke()
    rctx = make_rctx(cfg, mesh, train=True, seq_len=SMOKE_S)
    params = init_params(cfg, seed=0, device="cpu")
    layout = TrainLayout(cfg, mesh) if mesh is not None else None
    tokens = smoke_batch(cfg, arch)
    if layout is not None:
        params = shd.shard_tree(params, layout.pspecs, mesh)
        dp = layout.dp
        n = SMOKE_B // dp.size
        tokens = tokens[dp.index * n:(dp.index + 1) * n]
    params = T.tree_map(lambda x: x.to(device), params)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=SMOKE_LR, warmup_steps=0,
                                             total_steps=100))
    state = init_train_state(cfg, params, tcfg, layout)
    step = make_train_step(cfg, rctx, tcfg, layout)
    batch = {"tokens": torch.from_numpy(np.ascontiguousarray(tokens)).to(
        device)}
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


def smoke_rank(rank, world, archs, dev):
    """(a) on this rank: every arch at mesh 2x2 on ``dev``."""
    import torch
    from repro_torch.launch.mesh import make_train_mesh
    _setup_rank(torch)
    mesh = make_train_mesh("2x2", device_type="cpu")
    out = {}
    for arch in archs:
        t0 = time.perf_counter()
        out[arch] = smoke_step(torch, arch, dev, mesh)
        out[arch]["seconds"] = time.perf_counter() - t0
    return out


def expected_launches(cfg):
    from repro_torch.configs.base import ATTN, LOCAL_ATTN, MAMBA, MLSTM
    return {"chunked_prefill_attention": sum(cs.count_mixers(cfg, k) for k in
                                             (ATTN, LOCAL_ATTN)),
            "mamba_scan": cs.count_mixers(cfg, MAMBA),
            "mlstm_chunkwise": cs.count_mixers(cfg, MLSTM)}


def check_smoke_launches(arch, cfg, res, r):
    """Twice a layer (forward + recompute) on this rank, the plain version
    only in the backward (once a layer), never forward."""
    for k, n in expected_launches(cfg).items():
        got = res["launches"][k]
        back = res["plain"].get(f"{k} backward", 0)
        if got != 2 * n or back != n:
            raise AssertionError(f"phase 17 (a) {arch} rank {r}: {k} "
                                 f"launched {got}, plain backward {back}; "
                                 f"expected {2 * n} and {n}")
    if any("forward" in k for k in res["plain"]):
        raise AssertionError(f"phase 17 (a) {arch} rank {r}: plain "
                             f"versions ran forward: {res['plain']}")


def compare_smoke(arch, got, want, where):
    """The loss and the gradient norm to 2e-5 + 2e-5 |ref|, each leaf of
    the first moment to 1e-4 max |m_ref|. Returns the worst leaf's share
    of its limit."""
    import numpy as np
    for k in ("loss", "grad_norm"):
        if not abs(got[k] - want[k]) <= 2e-5 + 2e-5 * abs(want[k]):
            raise AssertionError(f"phase 17 (a) {arch} {k} {got[k]} "
                                 f"against {where} {want[k]}")
    if set(got["m"]) != set(want["m"]):
        raise AssertionError(f"phase 17 (a) {arch}: the moments' leaves")
    worst = 0.0
    for p, w in want["m"].items():
        lim = 1e-4 * float(np.abs(w).max())
        err = float(np.abs(got["m"][p] - w).max())
        if not np.isfinite(got["m"][p]).all() or err > lim:
            raise AssertionError(f"phase 17 (a) {arch} m{p}: {err} over "
                                 f"{lim} against {where}")
        worst = max(worst, err / lim if lim else 0.0)
    return worst


def smoke_part(torch, device, device_line, archs=SMOKE_ARCHS):
    """(a): the card's world-4 steps against the card's world-1 steps (the
    dense archs) or the CPU's world-4 steps (the EP archs)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.local_world import spawn_world
    _setup_rank(torch)
    base = {a: smoke_step(torch, a, device, None) for a in archs
            if a not in EP_ARCHS}
    with tempfile.TemporaryDirectory() as tmp:
        card = spawn_world(smoke_rank, 4, tmp, device=device, timeout=300.0,
                           group_timeout=240.0, archs=archs, dev=device)
    ep = [a for a in archs if a in EP_ARCHS]
    cpu = {}
    if ep:
        with tempfile.TemporaryDirectory() as tmp:
            cpu = spawn_world(smoke_rank, 4, tmp, device="cpu",
                              timeout=300.0, group_timeout=240.0, archs=ep,
                              dev="cpu")[0]
    rec = {}
    for arch in archs:
        cfg = get_config(arch).smoke()
        got = card[0][arch]
        want, where = ((cpu[arch], "the CPU's world-4 step") if arch in ep
                       else (base[arch], "the card's world-1 step"))
        worst = compare_smoke(arch, got, want, where)
        if torch.device(device).type == "cuda":
            for r, res in enumerate(card):
                check_smoke_launches(arch, cfg, res[arch], r)
        rec[arch] = {"loss": got["loss"], "ref_loss": want["loss"],
                     "grad_norm": got["grad_norm"], "against": where,
                     "worst_share": worst,
                     "launches_by_rank": [res[arch]["launches"]
                                          for res in card],
                     "seconds": got["seconds"]}
        print(f"  (a) {arch} smoke at 2x2 (world 4, gloo on the card): loss "
              f"{got['loss']:.6f} ({where}: {want['loss']:.6f}), grad norm "
              f"{got['grad_norm']:.5f}; m worst {worst:.3f} of its limit; "
              f"launches a rank "
              + ", ".join(f"{k.split('_')[0]} {card[0][arch]['launches'][k]}"
                          for k in KERNELS
                          if card[0][arch]['launches'][k])
              + f" [{device_line}]", flush=True)
    return rec


def moe_cut():
    """qwen2-moe-a2.7b at every published width, 4 of its 24 layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                               num_layers=MOE_LAYERS)


def full_batch(torch, cfg, device):
    """Phase 15 (c)'s batch: ``PackedSyntheticData`` B2 x S2048, seed 0."""
    from repro_torch.train.data import DataConfig, PackedSyntheticData
    data = PackedSyntheticData(DataConfig(cfg.vocab_size, cs.FULL_S,
                                          cs.FULL_B, seed=0))
    return {"tokens": torch.from_numpy(data.batch(0)).to(device)}


@contextlib.contextmanager
def instrumented(torch):
    """For the block: CUDA events around every collective of
    ``kernels/shard_utils.py`` on a CUDA tensor, by kind, and the (token,
    expert) choices the EP dispatch routed and dropped past capacity (a
    device sync a layer). Yields (events, counts); restores the names on
    exit."""
    from repro_torch.kernels import shard_utils as su
    from repro_torch.models import moe as M
    events, counts = {}, {"routed": 0, "dropped": 0}
    saved = []

    def timed(kind, fn):
        def run(x, *a, **k):
            if not x.is_cuda:
                return fn(x, *a, **k)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(x, *a, **k)
            end.record()
            events.setdefault(kind, []).append((start, end))
            return out
        return run

    def dispatch(t, ids, w, E, cap, _fn=M._dispatch_local):
        buf, meta = _fn(t, ids, w, E, cap)
        counts["routed"] += ids.numel()
        counts["dropped"] += int((~meta[2]).sum())
        return buf, meta

    for name in ("all_reduce", "all_gather", "_all_to_all",
                 "reduce_scatter"):
        saved.append((su, name, getattr(su, name)))
        setattr(su, name, timed(name.strip("_"), getattr(su, name)))
    saved.append((M, "_dispatch_local", M._dispatch_local))
    M._dispatch_local = dispatch
    try:
        yield events, counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_full(torch, cfg, device, lr, steps, tag):
    """``steps`` AdamW steps of ``cfg`` on mesh ``"2"`` over this rank's
    shards (drawn whole from seed 0 on ``device``, then cut). Returns this
    rank's per-step losses, times, #5 launches, collectives' ms by kind
    (:func:`instrumented`), the MoE's routed and dropped choices, and its
    peak memory."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.launch.steps import make_rctx
    from repro_torch.params import init_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, TrainLayout,
                                              init_train_state,
                                              make_train_step)
    cuda = torch.device(device).type == "cuda"
    mesh = make_train_mesh("2", device_type="cpu")
    rctx = make_rctx(cfg, mesh, train=True, seq_len=cs.FULL_S)
    layout = TrainLayout(cfg, mesh)
    t0 = time.perf_counter()
    params = shd.shard_tree(init_params(cfg, seed=0, device=device),
                            layout.pspecs, mesh)
    if cuda:
        torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=lr, warmup_steps=0,
                                             total_steps=1000))
    state = init_train_state(cfg, params, tcfg, layout)
    step = make_train_step(cfg, rctx, tcfg, layout)
    batch = full_batch(torch, cfg, device)
    kernels = _kernels()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rec = {"tag": tag, "init_s": init_s, "loss": [], "step_ms": [],
           "cpa_launches": [], "collectives_ms": [], "moe": []}
    for _ in range(steps):
        cs.reset_counts(kernels)
        with instrumented(torch) as (events, moe), \
                Clock(torch, device) as clk:
            params, state, m = step(params, state, batch)
        rec["loss"].append(float(m["loss"]))
        rec["step_ms"].append(clk.ms)
        rec["cpa_launches"].append(
            kernels["chunked_prefill_attention"].launches)
        rec["collectives_ms"].append({k: sum(a.elapsed_time(b) for a, b in v)
                                      for k, v in events.items()})
        rec["moe"].append(moe)
    rec["grad_norm_last"] = float(m["grad_norm"])
    rec["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9 if cuda
                          else None)
    del params, state, m, step
    if cuda:
        torch.cuda.empty_cache()
    return rec


def full_rank(rank, world, llama, moe, dev, steps):
    """(b) then (c) on this rank (world 2, mesh "2")."""
    import torch
    _setup_rank(torch)
    return {"llama": train_full(torch, llama, dev, cs.FULL_LR, steps, "tp"),
            "moe": train_full(torch, moe, dev, MOE_LR, steps, "ep")}


def one_rank_loss(torch, cfg, device):
    """The one-rank loss of ``cfg`` (weights from seed 0) on phase 15's
    batch: a no-grad forward, remat off (the same function)."""
    from repro_torch.models.model import RunCtx, loss_fn
    from repro_torch.params import init_params
    params = init_params(cfg, seed=0, device=device)
    with torch.no_grad():
        loss = float(loss_fn(cfg, params, full_batch(torch, cfg, device),
                             RunCtx(loss_vocab_blocks=16)))
    del params
    if torch.device(device).type == "cuda":
        cs.release(torch)
    return loss


def full_part(torch, device, device_line, llama=None, moe=None,
              phase15_loss=None, steps=FULL_STEPS):
    """(b) and (c) in one world of 2."""
    from repro_torch.configs import get_config
    from repro_torch.launch.local_world import spawn_world
    llama = llama or get_config("llama3.2-3b")
    moe = moe or moe_cut()
    cuda = torch.device(device).type == "cuda"
    ref = phase15_loss if phase15_loss is not None else one_rank_loss(
        torch, llama, device)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_world(full_rank, 2, tmp, device=device, timeout=600.0,
                            group_timeout=540.0, llama=llama, moe=moe,
                            dev=device, steps=steps)
    tokens = cs.FULL_B * cs.FULL_S
    out = {}
    for part, cfg in (("llama", llama), ("moe", moe)):
        recs = [r[part] for r in ranks]
        r0 = recs[0]
        losses = r0["loss"]
        if any(r["loss"] != losses for r in recs):
            raise AssertionError(f"phase 17 {part}: the ranks' losses "
                                 f"differ: {[r['loss'] for r in recs]}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"phase 17 {part}: losses {losses}")
        step_ms = [max(r["step_ms"][i] for r in recs)
                   for i in range(steps)]
        coll = [{k: max(r["collectives_ms"][i].get(k, 0.0) for r in recs)
                 for k in set().union(*(r["collectives_ms"][i]
                                        for r in recs))}
                for i in range(steps)]
        rec = {"arch": cfg.name, "layers": cfg.num_layers, "mesh": "2",
               "batch": cs.FULL_B, "seq": cs.FULL_S, "losses": losses,
               "step_ms": step_ms, "tokens_per_s": [
                   tokens / (t / 1e3) for t in step_ms],
               "collectives_ms": coll,
               "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in recs],
               "cpa_launches_by_rank": [r["cpa_launches"] for r in recs],
               "init_s": r0["init_s"]}
        if part == "llama":
            rec["one_rank_loss"] = ref
            if not abs(losses[0] - ref) <= 1e-2 * abs(ref):
                raise AssertionError(f"phase 17 (b): first loss "
                                     f"{losses[0]} against one rank's {ref}")
            want = 2 * cfg.num_layers
            if cuda and any(n != want for r in recs
                            for n in r["cpa_launches"]):
                raise AssertionError(
                    f"phase 17 (b): #5 launched "
                    f"{[r['cpa_launches'] for r in recs]} a step by rank, "
                    f"expected {want}")
        else:
            rec["reduced"] = MOE_REDUCED
            if not losses[-1] < losses[0]:
                raise AssertionError(f"phase 17 (c): losses {losses}")
            # the routing runs in the forward and the remat recompute
            rec["moe_routed"] = [sum(r["moe"][i].get("routed", 0)
                                     for r in recs) // 2
                                 for i in range(steps)]
            rec["moe_dropped"] = [sum(r["moe"][i].get("dropped", 0)
                                      for r in recs) // 2
                                  for i in range(steps)]
        out[part] = rec
        what = ("(b) llama3.2-3b full width, TP at mesh 2" if part == "llama"
                else f"(c) qwen2-moe-a2.7b full width ({MOE_REDUCED[0]}), "
                     f"EP at mesh 2")
        extra = (f"; first loss against one rank's {ref:.5f}"
                 if part == "llama" else
                 f"; dropped by capacity {rec['moe_dropped']} of "
                 f"{rec['moe_routed']} choices a step")
        print(f"  {what}: losses {[round(x, 5) for x in losses]}; steps "
              f"{[round(t, 1) for t in step_ms]} ms, "
              f"{rec['tokens_per_s'][-1]:.0f} tokens/s; collectives a step "
              f"{[{k: round(v, 1) for k, v in c.items()} for c in coll]} ms;"
              f" peak memory by rank {rec['peak_mem_gb_by_rank']} GB; #5 "
              f"launches by rank {rec['cpa_launches_by_rank']}{extra} "
              f"[{device_line}]", flush=True)
    return out


def train_sharded_phase(torch, phase15_loss=None, device_line=None):
    """Phase 17 (see the module docstring). Returns its record and the
    launches of its main paths by kernel."""
    device_line = device_line or cs.device_line()
    cs.release(torch)
    t0 = time.perf_counter()
    smoke = smoke_part(torch, cs.DEVICE, device_line)
    t1 = time.perf_counter()
    full = full_part(torch, cs.DEVICE, device_line,
                     phase15_loss=phase15_loss)
    rec = {"device": device_line, "smoke": smoke, "full": full,
           "seconds": {"smoke": t1 - t0,
                       "full": time.perf_counter() - t1}}
    launches = {}
    for arch, r in smoke.items():
        for k in KERNELS:
            n = sum(x[k] for x in r["launches_by_rank"])
            if n:
                launches.setdefault(k, {})[
                    f"smoke sharded training {arch} (4 ranks)"] = n
    launches.setdefault("chunked_prefill_attention", {})[
        f"llama3.2-3b sharded training w2, {FULL_STEPS} steps (2 ranks)"] = \
        sum(sum(x) for x in full["llama"]["cpa_launches_by_rank"])
    launches["chunked_prefill_attention"][
        f"qwen2-moe-a2.7b EP training w2, {FULL_STEPS} steps (2 ranks)"] = \
        sum(sum(x) for x in full["moe"]["cpa_launches_by_rank"])
    return rec, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_sharded_phase: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    dev = cs.device_line()
    print(f"{dev}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    rec, launches = train_sharded_phase(torch, device_line=dev)
    rec["total_s"] = time.perf_counter() - t0
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_sharded_phase.json").write_text(json.dumps(
        {"record": rec, "launches": launches}, indent=1, default=str))
    print(f"phase 17: {rec['total_s']:.1f}s [{dev}]")
    print(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
