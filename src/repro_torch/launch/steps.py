"""Per-(arch x shape) step builders for the dry run and the launchers (port
of the reference ``launch/steps.py``).

``make_rctx`` picks the reference's runtime context for a step: the MoE
routes expert-parallel on a mesh (masked-dense without one), training
rematerializes each period repetition ("full"), and the loss runs in 16
sequence blocks. Every arch runs on a mesh.

``build_cell`` returns a cell's step function with this rank's stand-ins
for every input: empty tensors at each leaf's local shape under the
partition rules (``launch/sharding.shardings_of``), made under the
caller's ``FakeTensorMode`` so that they hold no memory, and the indices
of the inputs the step updates in place (the reference's donation):

* ``train_4k``    -> train_step(params, opt_state, batch) (loss + AdamW)
* ``prefill_32k`` -> prefill_step(params, tokens, cache, extras)
* ``decode_32k`` / ``long_500k`` -> serve_step(params, cache, tokens, pos)

``fsdp`` (ZeRO-3: the parameters at ``param_specs(..., fsdp=True)``'s
slices, gathered over the data-parallel axes at use) and ``wide_dp`` (the
batch over the model axis too) are the reference's options. The
reference gets both from GSPMD's resharding; the port has explicit
collectives (``models/model.py`` ``RunCtx.fsdp``,
``train/train_step.TrainLayout``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs import cell_skip_reason, get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.launch.mesh import axis_sizes, dp_axes, dp_size
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import RunCtx


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    fn: Callable
    inputs: Tuple[Any, ...]          # this rank's stand-ins
    donate: Tuple[int, ...]          # inputs the step updates in place
    cfg: ModelConfig
    reps_for_roofline: int           # total layer reps (see analysis)


def make_rctx(cfg: ModelConfig, mesh: Optional[Any], *, train: bool,
              seq_len: int, fsdp: Any = False) -> RunCtx:
    """The reference's choices, plus ``RunCtx.mesh``: the mesh whose shards
    the step's parameters are (the reference's GSPMD needs no such field;
    the reference's ``block_q``/``block_k``/``mlstm_block`` are XLA tiling
    controls, which the port's kernels choose themselves). ``fsdp``: True
    for the parameters at ZeRO-3 slices (``RunCtx.fsdp`` from
    ``launch/sharding.fsdp_dims``), or such a tree of dims itself."""
    moe_ctx = moe_mod.MoEContext(
        impl="ep" if (mesh is not None and cfg.num_experts) else "dense",
        mesh=mesh,
        dp_axes=dp_axes(mesh) if mesh is not None else (),
        tp_axis="model",
    )
    from repro_torch.launch.sharding import fsdp_of
    dims = fsdp_of(cfg, fsdp, mesh)
    return RunCtx(moe=moe_ctx, remat="full" if train else "none",
                  loss_vocab_blocks=16, mesh=mesh, fsdp=dims,
                  dp_axes=dp_axes(mesh) if dims is not None else ())


def _enc_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    if not cfg.enc_dec:
        return 0
    if shape.kind == "train":
        return shape.seq_len // 2
    return shape.seq_len


def _dec_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    if cfg.enc_dec and shape.kind == "train":
        return shape.seq_len // 2
    return shape.seq_len


def build_cell(arch: str, shape_name: str, mesh, check_skip: bool = True,
               fsdp: Any = False, cfg_override: Optional[ModelConfig] = None,
               wide_dp: bool = False, device=None) -> Optional[Cell]:
    """The cell of ``arch`` x ``shape_name`` on ``mesh`` (a ``DeviceMesh``:
    the step's collectives run over its groups), its inputs this rank's
    stand-ins on ``device`` (call it under a ``FakeTensorMode``); None for
    a cell the assignment skips. The batch rule, the grad accumulation (4
    micro-batches where ``B // n_dp >= 4``), the cache lengths and
    ``reps_for_roofline`` are the reference's.

    ``fsdp``: the parameters (and the optimizer state) at ZeRO-3 slices,
    which the step gathers a repetition at a time; True for
    ``param_specs(..., fsdp=True)``'s, or a ``fsdp_dims`` tree (the
    extrapolation's probes take the full model's). ``wide_dp``: where the
    data-parallel axes and ``model`` divide the global batch, its rows lie
    on all of them (and ``grad_accum`` is 1), as in the reference. Where
    the blocks are whole on ``model`` (xlstm-125m) each rank trains on
    its own rows; otherwise, and in the prefill and decode cells (whose
    caches keep the reference's ``cache_specs``, the batch on the
    data-parallel axes), the step gathers the rows over ``model`` at its
    entry and then computes what the data-parallel cell computes, as
    GSPMD's resharding does in the reference."""
    from repro_torch.kernels import shard_utils as su
    from repro_torch.launch import sharding as shd
    from repro_torch.models.model import (build_stacks, check_cache_layout,
                                          decode_step, init_cache, prefill)
    from repro_torch.params import init_params
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    if check_skip and cell_skip_reason(arch, shape):
        return None
    train = shape.kind == "train"
    params_shape = init_params(cfg, device="meta")
    dims = shd.fsdp_of(cfg, fsdp, mesh, params_shape)
    rctx = make_rctx(cfg, mesh, train=train, seq_len=shape.seq_len,
                     fsdp=dims)

    pspecs = shd.param_specs(cfg, params_shape, mesh)
    if dims is not None:
        pspecs = shd.with_fsdp(pspecs, dims, mesh)
    params_in = shd.shardings_of(params_shape, pspecs, mesh, device)
    n_dp = dp_size(mesh)
    reps = sum(r for _, r in build_stacks(cfg))

    B = shape.global_batch
    rows = shd.batch_axes(mesh, B, wide_dp)       # the reference's bspec
    wide = "model" in rows
    b_loc = B // math.prod(axis_sizes(mesh)[a] for a in rows)
    tp = su.mesh_axis(mesh, "model")

    def entry(batch):
        """The rows of a wide batch gathered over ``model``."""
        return {k: su.all_gather(v, 0, tp) for k, v in batch.items()} \
            if wide and tp is not None else batch

    def frontend_inputs():
        """Modality-frontend stubs (input_specs provides embeddings)."""
        extras = {}
        if cfg.num_patch_tokens:
            extras["extra_embeds"] = torch.empty(
                (b_loc, cfg.num_patch_tokens, cfg.d_model), dtype=cfg.dtype,
                device=device)
        if cfg.enc_dec:
            extras["enc_embeds"] = torch.empty(
                (b_loc, _enc_len(cfg, shape), cfg.d_model), dtype=cfg.dtype,
                device=device)
        return extras

    def tokens(n):
        return torch.empty((b_loc, n), dtype=torch.int32, device=device)

    if train:
        from repro_torch.train.optimizer import AdamWConfig
        from repro_torch.train.train_step import (TrainConfig, TrainLayout,
                                                  init_train_state,
                                                  make_train_step)
        # Microbatching: 4 gradient-accumulation steps bound activation
        # memory (saved layer inputs scale with the microbatch).
        accum = 4 if B // n_dp >= 4 and not wide else 1
        tcfg = TrainConfig(optimizer=AdamWConfig(), grad_accum=accum)
        layout = TrainLayout(cfg, mesh, fsdp=dims, wide_dp=wide)
        inner_step = make_train_step(cfg, rctx, tcfg, layout)

        def train_step(params, opt_state, batch):
            new_params, new_state, metrics = inner_step(
                params, {"opt": opt_state}, batch)
            return new_params, new_state["opt"], metrics

        opt_in = init_train_state(cfg, params_in, tcfg, layout)["opt"]
        batch_in = {"tokens": tokens(_dec_len(cfg, shape)),
                    **frontend_inputs()}
        return Cell(arch, shape, train_step, (params_in, opt_in, batch_in),
                    donate=(0, 1), cfg=cfg, reps_for_roofline=reps)

    enc_len = _enc_len(cfg, shape)

    def cache_in(max_len):
        check_cache_layout(cfg, max_len, enc_len, mesh)
        whole = init_cache(cfg, B, max_len, device="meta", enc_len=enc_len)
        return shd.shardings_of(whole, shd.cache_specs(cfg, whole, mesh),
                                mesh, device)

    if shape.kind == "prefill":
        def prefill_step(params, tokens, cache, extras):
            got = entry({"tokens": tokens, **extras})
            tokens = got.pop("tokens")
            return prefill(cfg, params, tokens, cache, rctx=rctx, **got)

        dec_prompt = 1 if cfg.enc_dec else shape.seq_len
        return Cell(arch, shape, prefill_step,
                    (params_in, tokens(dec_prompt), cache_in(dec_prompt),
                     frontend_inputs()),
                    donate=(2,), cfg=cfg, reps_for_roofline=reps)

    # decode shapes: one new token against a cache of seq_len
    seq = shape.seq_len

    def serve_step(params, cache, tokens, pos):
        tokens = entry({"tokens": tokens})["tokens"]
        return decode_step(cfg, params, tokens, cache, pos, rctx=rctx)

    # room for the new token, rounded so the seq dim stays shardable
    max_len = (seq + 8 + 255) // 256 * 256
    return Cell(arch, shape, serve_step,
                (params_in, cache_in(max_len), tokens(1), seq),
                donate=(1,), cfg=cfg, reps_for_roofline=reps)
