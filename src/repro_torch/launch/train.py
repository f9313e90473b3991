"""Training launcher of the PyTorch port (port of the reference
``launch/train.py``): one device by default, or a mesh of ranks under
``torchrun``.

    python -m repro_torch.launch.train --arch llama3.2-3b --steps 100 \\
        --global-batch 16 --seq 256 --smoke --ckpt-dir build/ckpt
    python -m repro_torch.launch.train --device cpu --smoke --steps 3
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 \\
        --device cpu --smoke --steps 3

It builds the reference's training context (``launch/steps.make_rctx``:
remat "full", ``loss_vocab_blocks`` 16, the MoE expert-parallel on a mesh;
the reference's tiling fields mean nothing here), draws random weights
from seed 0, and runs the train loop under ``TrainingSupervisor`` when
``--ckpt-dir`` is given, resuming from its latest checkpoint as the
reference does.

``--mesh SPEC`` (``"2x2"`` is data x model; else ``REPRO_FORCE_MESH``) or
``--multi-pod`` trains on a mesh over the ranks of ``torchrun``
(``launch/mesh.init_distributed``: NCCL with a card a rank, gloo on the
CPU or when ranks share a card). Each rank keeps its shards of the
parameters (``launch/sharding.param_specs``) and its ZeRO slices of
AdamW's state, takes its data-parallel rows of each ``PackedSyntheticData``
batch (all of them when the batch does not split, as ``build_cell``'s
``bspec``), and runs the sharded step (``train/train_step.py``); rank 0
prints the losses and the checkpoints are the whole tree, written by rank
0 (``train/checkpoint.Sharded``), which every rank restores from under
``runtime/elastic.MeshSupervisor``. A
feature the sharded step does not compute is refused before anything is
allocated, and a mesh without a process group raises.

The supervisor restores and replays a step that raised ``RuntimeError``,
and ``torch.cuda.OutOfMemoryError`` is one: a step that runs out of device
memory would run out again on every replay. So the step function re-raises
it as ``MemoryError``, which the supervisor lets through.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (init_distributed, make_train_mesh,
                                     serving_mesh_spec)
from repro_torch.launch.steps import make_rctx
from repro_torch.params import init_params
from repro_torch.runtime.elastic import MeshSupervisor
from repro_torch.runtime.fault_tolerance import TrainingSupervisor
from repro_torch.train import checkpoint
from repro_torch.train.data import DataConfig, PackedSyntheticData
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, TrainLayout,
                                          init_train_state, make_train_step)


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
    ap.add_argument("--mesh", default=None,
                    help="training mesh over torchrun's ranks, e.g. 2x2 "
                         "(data x model); defaults to $REPRO_FORCE_MESH, "
                         "else one device")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the production mesh of two pods (2x16x16)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    mesh, rank, device = None, 0, args.device
    if serving_mesh_spec(args.mesh) or args.multi_pod:
        info = init_distributed(args.device)
        rank, device = info.rank, info.device
        mesh = make_train_mesh(args.mesh, multi_pod=args.multi_pod)
    rctx = make_rctx(cfg, mesh, train=True, seq_len=args.seq)
    layout = TrainLayout(cfg, mesh) if mesh is not None else None
    params = init_params(cfg, seed=0, device=device)
    if layout is not None:
        params = shd.shard_tree(params, layout.pspecs, mesh)
    tcfg = TrainConfig(optimizer=AdamWConfig(total_steps=args.steps),
                       compress_grads=args.compress_grads)
    tstate = init_train_state(cfg, params, tcfg, layout)
    step_fn = make_train_step(cfg, rctx, tcfg, layout)
    data = PackedSyntheticData(DataConfig(cfg.vocab_size, args.seq,
                                          args.global_batch, seed=0))
    dp = layout.dp if layout is not None else None
    rows = ((dp.index, dp.size) if dp is not None
            and args.global_batch % dp.size == 0 else (0, 1))
    state = {"params": params, "train": tstate}
    if rank == 0 and mesh is not None:
        print(f"mesh {'x'.join(map(str, mesh.shape))} "
              f"{tuple(mesh.mesh_dim_names)}: {rctx.moe.impl} MoE, "
              f"data-parallel rows {args.global_batch // rows[1]} a rank",
              flush=True)

    def one_step(st, i):
        batch = {"tokens": torch.from_numpy(data.batch(i, *rows)).to(device)}
        p, t, m = step_fn(st["params"], st["train"], batch)
        if rank == 0 and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i} loss={float(m['loss']):.4f}", flush=True)
        return {"params": p, "train": t}

    one_step = oom_as_memory_error(one_step)
    ckpt = (checkpoint if mesh is None else
            checkpoint.Sharded(layout.state_specs(state), mesh))
    t0 = time.time()
    if args.ckpt_dir:
        sup = (TrainingSupervisor(args.ckpt_dir, save_every=args.save_every)
               if mesh is None else MeshSupervisor(
                   args.ckpt_dir, ckpt, save_every=args.save_every))
        start = ckpt.latest_step(args.ckpt_dir) or 0
        if start:
            state = ckpt.restore(args.ckpt_dir, start, state)
            if rank == 0:
                print(f"resumed from step {start}"
                      + (f" ({ckpt.plan})" if mesh is not None else ""))
        state, end, restarts = sup.run(one_step, state, start, args.steps)
        if rank == 0:
            print(f"finished at step {end} ({restarts} restarts)")
    else:
        for i in range(args.steps):
            state = one_step(state, i)
    if rank == 0:
        print(f"wall: {time.time() - t0:.1f}s")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
