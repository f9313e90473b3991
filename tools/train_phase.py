#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` (training) alone on the card, for
iterating without the serving phases:

    python3 tools/train_phase.py                 # (a), (b), the backward
                                                 # timings and (c)
    python3 tools/train_phase.py --full-only --lr 1e-4 1e-5 3e-6
    python3 tools/train_phase.py --full-only --cut-lr 1e-4 3e-6

Builds the kernels, then runs ``chip_smoke.py``'s ``train_smoke_phase``
(every arch's smoke gradients on the card against the CPU),
``train_supervisor_phase`` (the supervised run with a restart),
``backward_timings``, ``train_bf16_witness`` (the depth-cut full-width
llama's bf16 gradients against fp32) and ``train_full_phase`` (full-width
llama3.2-3b), the last once per ``--lr`` (the learning rate of its AdamW;
the script's own is ``chip_smoke.FULL_LR``). ``--cut-lr`` first runs six
AdamW steps of the witness's depth-cut llama on the batch of (c), in bf16
and in fp32 from the same weights, at each rate given, and prints each
step's loss and gradient norm: whether a rise of the loss at a rate shows
in fp32 as well. A phase that fails raises, and the script exits
non-zero. Each run's record goes to ``chiprun_out/train_phase.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def cut_steps(torch, cs, lr, steps=6):
    """Six AdamW steps (lr ``lr``, no warmup) of ``chip_smoke.witness_cfg``
    on the batch of part (c), in bf16 and in fp32 from the same weights.
    Returns {dtype: [(loss, grad norm), ...]}."""
    from repro_torch.models import model as TM
    from repro_torch.params import init_params
    from repro_torch.train import tree as T
    from repro_torch.train.data import DataConfig, PackedSyntheticData
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)
    cfg = cs.witness_cfg()
    data = PackedSyntheticData(DataConfig(cfg.vocab_size, cs.FULL_S,
                                          cs.FULL_B, seed=0))
    batch = {"tokens": torch.from_numpy(data.batch(0)).to("cuda")}
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=lr, warmup_steps=0,
                                             total_steps=1000))
    step_fn = make_train_step(cfg, TM.RunCtx(remat="full",
                                             loss_vocab_blocks=16), tcfg)
    out = {}
    for name in ("bf16", "fp32"):
        params = init_params(cfg, seed=0, device="cuda")
        if name == "fp32":
            params = T.tree_map(lambda t: t.float(), params)
        state = init_train_state(cfg, params, tcfg)
        traj = []
        for _ in range(steps):
            params, state, m = step_fn(params, state, batch)
            traj.append((float(m["loss"]), float(m["grad_norm"])))
        print(f"  cut ({cfg.num_layers} layers) {name} lr {lr:g}: " + ", ".join(
            f"{x:.4f} (|g| {g:.3f})" for x, g in traj), flush=True)
        out[name] = traj
        del params, state, m
        cs.release(torch)
    return out


def main() -> int:
    import torch
    import chip_smoke as cs
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-only", action="store_true",
                    help="run part (c) alone")
    ap.add_argument("--lr", type=float, nargs="+", default=[cs.FULL_LR])
    ap.add_argument("--cut-lr", type=float, nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_phase: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.chunked_prefill_attention import kernel as CK
    from repro_torch.kernels.mamba_scan import kernel as MK
    from repro_torch.kernels.mlstm_chunkwise import kernel as LK
    print(cs.device_line(), torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    kernels = {"chunked_prefill_attention": CK.chunked_prefill_attention,
               "mamba_scan": MK.mamba_scan,
               "mlstm_chunkwise": LK.mlstm_chunkwise}
    out = {"device": cs.device_line()}
    t0 = time.perf_counter()
    try:
        import msgpack
        out["msgpack"] = msgpack.version
    except ImportError as e:
        out["msgpack"] = f"missing: {e}"
    print(f"msgpack: {out['msgpack']}", flush=True)
    out["cut_steps"] = {str(lr): cut_steps(torch, cs, lr)
                        for lr in args.cut_lr}
    if not args.full_only:
        out["smoke_launches"] = cs.train_smoke_phase(torch, kernels)
        out["supervised"] = cs.train_supervisor_phase(torch)
        out["backward"] = cs.backward_timings(torch)
        out["witness"] = cs.train_bf16_witness(torch)
    out["full"] = {}
    default_lr = cs.FULL_LR
    for lr in args.lr:
        cs.FULL_LR = lr
        try:
            out["full"][str(lr)] = cs.train_full_phase(torch, kernels)
        except AssertionError as e:     # a rate under study, not the script's
            if lr == default_lr:
                raise
            out["full"][str(lr)] = {"failed": str(e)}
            print(f"  lr {lr:g}: {e}", flush=True)
        cs.release(torch)
    out["seconds"] = time.perf_counter() - t0
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "train_phase.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(f"done in {out['seconds']:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
