"""Per-arch step context for the launchers (port of the reference
``launch/steps.py``'s ``make_rctx``, ``_enc_len`` and ``_dec_len``).

``make_rctx`` picks the reference's runtime context for a step: the MoE
routes expert-parallel on a mesh (masked-dense without one), training
rematerializes each period repetition ("full"), and the loss runs in 16
sequence blocks. On a mesh it first refuses the features the sharded step
does not compute (``models.model.check_shardable``), before anything is
allocated. The reference's ``build_cell`` (the dry-run's abstract cells
with sharded stand-ins for every input) comes with the port of the
dry-run, ``launch/dryrun.py``, in a later slice.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import RunCtx, check_shardable


def make_rctx(cfg: ModelConfig, mesh: Optional[Any], *, train: bool,
              seq_len: int) -> RunCtx:
    """The reference's choices, plus ``RunCtx.mesh``: the mesh whose shards
    the step's parameters are (the reference's GSPMD needs no such field;
    the reference's ``block_q``/``block_k``/``mlstm_block`` are XLA tiling
    controls, which the port's kernels choose themselves)."""
    if mesh is not None:
        check_shardable(cfg)
    moe_ctx = moe_mod.MoEContext(
        impl="ep" if (mesh is not None and cfg.num_experts) else "dense",
        mesh=mesh,
        dp_axes=dp_axes(mesh) if mesh is not None else (),
        tp_axis="model",
    )
    return RunCtx(moe=moe_ctx, remat="full" if train else "none",
                  loss_vocab_blocks=16, mesh=mesh)


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
