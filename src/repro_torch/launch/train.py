"""Training launcher of the PyTorch port, on one device (port of the
reference ``launch/train.py`` without its mesh: no ``--multi-pod`` and no
``--single-device``, since one device is all the port runs on yet).

    python -m repro_torch.launch.train --arch llama3.2-3b --steps 100 \\
        --global-batch 16 --seq 256 --smoke --ckpt-dir build/ckpt
    python -m repro_torch.launch.train --device cpu --smoke --steps 3

It builds the reference's training context (``make_rctx(train=True)``:
remat "full", ``loss_vocab_blocks`` 16; the reference's tiling fields
mean nothing here), draws random weights from seed 0, and runs the train loop under
``TrainingSupervisor`` when ``--ckpt-dir`` is given, resuming from its
latest checkpoint as the reference does. The supervisor restores and
replays a step that raised ``RuntimeError``, and ``torch.cuda.
OutOfMemoryError`` is one: a step that runs out of device memory would
run out again on every replay. So the step function re-raises it as
``MemoryError``, which the supervisor lets through.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models.model import RunCtx
from repro_torch.params import init_params
from repro_torch.runtime.fault_tolerance import TrainingSupervisor
from repro_torch.train.checkpoint import latest_step, restore
from repro_torch.train.data import DataConfig, PackedSyntheticData
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)


def make_rctx() -> RunCtx:
    """The reference's ``make_rctx(cfg, None, train=True, seq_len)``."""
    return RunCtx(remat="full", loss_vocab_blocks=16)


def oom_as_memory_error(step_fn):
    """``step_fn`` with ``torch.cuda.OutOfMemoryError`` (a
    ``RuntimeError``, which ``TrainingSupervisor`` restores and replays)
    re-raised as ``MemoryError``, which the supervisor lets through."""
    def run(state, step):
        try:
            return step_fn(state, step)
        except torch.cuda.OutOfMemoryError as e:
            raise MemoryError(f"out of device memory at step {step}: "
                              f"{e}") from e
    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    rctx = make_rctx()
    params = init_params(cfg, seed=0, device=args.device)
    tcfg = TrainConfig(optimizer=AdamWConfig(total_steps=args.steps),
                       compress_grads=args.compress_grads)
    tstate = init_train_state(cfg, params, tcfg)
    step_fn = make_train_step(cfg, rctx, tcfg)
    data = PackedSyntheticData(DataConfig(cfg.vocab_size, args.seq,
                                          args.global_batch, seed=0))
    state = {"params": params, "train": tstate}

    def one_step(st, i):
        batch = {"tokens": torch.from_numpy(data.batch(i)).to(args.device)}
        p, t, m = step_fn(st["params"], st["train"], batch)
        if i % 10 == 0:
            print(f"step {i} loss={float(m['loss']):.4f}", flush=True)
        return {"params": p, "train": t}

    one_step = oom_as_memory_error(one_step)
    t0 = time.time()
    if args.ckpt_dir:
        sup = TrainingSupervisor(args.ckpt_dir, save_every=args.save_every)
        start = latest_step(args.ckpt_dir) or 0
        if start:
            state = restore(args.ckpt_dir, start, state)
            print(f"resumed from step {start}")
        state, end, restarts = sup.run(one_step, state, start, args.steps)
        print(f"finished at step {end} ({restarts} restarts)")
    else:
        for i in range(args.steps):
            state = one_step(state, i)
    print(f"wall: {time.time() - t0:.1f}s")
    return state


if __name__ == "__main__":
    main()
