"""Train the reference example's scaled-down llama (6 layers, d_model 512,
vocab 32000, fp32; 40 M parameters with its tied embeddings) for a few
hundred steps with the PyTorch port, with checkpoint/restart fault
tolerance and (optional) int8 gradient compression: the training
substrate end to end (the port's counterpart of
``examples/train_small.py``), on the GPU unless ``--device cpu``.

    PYTHONPATH=src python examples/train_small_torch.py --steps 200
    PYTHONPATH=src python examples/train_small_torch.py --fail-at 120 \\
        --compress-grads
"""
import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import oom_as_memory_error
from repro_torch.models.model import RunCtx
from repro_torch.params import init_params
from repro_torch.runtime.fault_tolerance import TrainingSupervisor
from repro_torch.train import tree
from repro_torch.train.data import DataConfig, PackedSyntheticData
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a failure at this step (tests restart)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # the reference example's config: a scaled-down llama3.2 family member
    cfg = dataclasses.replace(
        get_config("llama3.2-3b"),
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=32000, dtype=torch.float32,
        param_dtype=torch.float32)
    params = init_params(cfg, seed=0, device=args.device)
    n = sum(x.numel() for x in tree.leaves(params))
    print(f"model: {n / 1e6:.1f}M params")

    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps),
        compress_grads=args.compress_grads)
    step_fn = make_train_step(cfg, RunCtx(), tcfg)
    data = PackedSyntheticData(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                          seed=0))

    state = {"params": params, "train": init_train_state(cfg, params, tcfg)}

    def one_step(st, i):
        batch = {"tokens": torch.from_numpy(data.batch(i)).to(args.device)}
        p, t, m = step_fn(st["params"], st["train"], batch)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.2f}",
                  flush=True)
        return {"params": p, "train": t}

    with tempfile.TemporaryDirectory() as ckpt_dir:
        sup = TrainingSupervisor(ckpt_dir, save_every=50)
        fired = {"done": False}

        def fail_at(step):
            if args.fail_at and step == args.fail_at and not fired["done"]:
                fired["done"] = True
                print(f"!! injecting failure at step {step}; restoring from "
                      f"checkpoint", flush=True)
                return True
            return False

        t0 = time.time()
        state, end, restarts = sup.run(oom_as_memory_error(one_step), state,
                                       0, args.steps, fail_at=fail_at)
        print(f"done: {end} steps, {restarts} restart(s), "
              f"{time.time() - t0:.0f}s wall")


if __name__ == "__main__":
    main()
