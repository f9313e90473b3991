"""Train-step factory: loss + gradients + AdamW update (+ optional int8
gradient compression), with the context's remat policy and gradient
accumulation (port of the reference ``train/train_step.py``).

Gradients come from ``torch.autograd.grad`` over every parameter leaf (a
leaf the loss does not reach, such as DeepSeek-v3's router bias, gets
zeros, as JAX gives it). With ``grad_accum > 1`` the batch is split along
B into micro-batches whose fp32 gradients are summed and scaled by
``1/grad_accum``, as the reference's ``lax.scan`` does. The update is in
place (``train/optimizer.py``): ``train_step`` returns the same parameter
tree and state it was given.

On a mesh (``rctx.mesh``; one process a rank) the step is the reference's
sharded step as ``launch/steps.build_cell`` lays it out. The parameters
are this rank's shards (``launch/sharding.param_specs``: tensor and
expert parallelism on ``model``), the batch is this rank's data-parallel
rows, and :class:`TrainLayout` holds every leaf's placement. Each rank
differentiates the loss of its rows (every rank of the ``model`` axis the
whole of it; ``grad_accum`` splits the rank's rows); the gradients are
averaged over the data-parallel axes, reduce-scattered into the rank's
ZeRO slice where ``opt_state_specs`` cuts the leaf over them (else
all-reduced); compression and AdamW work on the slices, and the new
parameter shards are gathered over the data-parallel axes. The loss it
reports is the mean over those axes.

ZeRO-3 (``TrainLayout(..., fsdp=True)``, the reference's ``fsdp``): the
parameters live at ``param_specs(..., fsdp=True)``'s slices, and the
optimizer state at the same slices (``opt_state_specs`` adds nothing to
a spec that has a data-parallel axis). The model gathers each slice at
use (``RunCtx.fsdp``), and the gather's backward reduce-scatters the
gradient: it arrives summed over the data-parallel axes at the rank's
slice, so the step only divides it (a leaf that FSDP leaves whole is
all-reduced as before), and AdamW updates the slices in place with
nothing gathered after it. The wide batch (``wide_dp=True``, the
reference's ``wide_dp``: the rows over the data-parallel axes and
``model``): where the blocks are whole on the model axis (xlstm-125m)
each rank computes its own rows, with the vocab-parallel embedding and
head gathered whole over ``model`` (``RunCtx.vocab_whole``), and the
gradients and the loss are averaged over both; otherwise the step
gathers the rows over ``model`` at its entry and computes what the
data-parallel batch computes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import shard_utils as su
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import dp_axes
from repro_torch.models.model import RunCtx, loss_fn
from repro_torch.runtime import compression
from repro_torch.train import tree as T
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    grad_accum: int = 1
    compress_grads: bool = False


class TrainLayout:
    """Where every leaf of the sharded train step lives on this rank:
    ``pspecs`` (the parameters' specs), ``ospecs`` (the optimizer state's),
    the whole shapes, and per parameter leaf the dim its ZeRO slice cuts
    over the data-parallel axes (None where ``zero_shard`` found none).
    Built from the config alone (shapes on the meta device); ``mesh`` a
    ``DeviceMesh``. ``fsdp``: the parameters at ZeRO-3 slices, True for
    ``param_specs(..., fsdp=True)``'s, or a ``fsdp_dims`` tree (the tree
    ``RunCtx.fsdp`` takes). ``wide_dp``: the batch's rows lie on the
    model axis too (the caller has checked that the axes divide it);
    ``rows_own`` says whether each rank then computes its own rows (blocks
    whole on the model axis), else ``gather_rows`` is the axis the step
    gathers them over first."""

    def __init__(self, cfg: ModelConfig, mesh, fsdp=False,
                 wide_dp: bool = False):
        from repro_torch.params import init_params
        self.mesh = mesh
        shapes = init_params(cfg, device="meta")
        self.shapes = [tuple(x.shape) for x in T.leaves(shapes)]
        self.fsdp_dims = shd.fsdp_of(cfg, fsdp, mesh, shapes)
        if self.fsdp_dims is not None and not dp_axes(mesh):
            raise ValueError("fsdp slices the parameters over the "
                             "data-parallel axes: the mesh has none")
        self.pspecs = shd.param_specs(cfg, shapes, mesh)
        if self.fsdp_dims is not None:
            self.pspecs = shd.with_fsdp(self.pspecs, self.fsdp_dims, mesh)
        opt = adamw_init(shapes)
        if dp_axes(mesh):
            self.ospecs = shd.opt_state_specs(cfg, opt, self.pspecs, mesh)
        else:   # no data-parallel axis (mesh "4"): the state as the params
            # (the reference's zero_shard has no axis to add and raises)
            self.ospecs = {"step": shd.Spec(), "m": self.pspecs,
                           "v": self.pspecs, "master": T.tree_map(
                               lambda _, s: s, opt["master"], self.pspecs)}
        self.dp = su.mesh_axis(mesh, dp_axes(mesh))
        self._ps = T.leaves(self.pspecs)
        self._os = T.leaves(self.ospecs["m"])
        self.dp_dims: List[Optional[int]] = []
        for ps, os_ in zip(self._ps, self._os):
            dims = [i for i, (a, b) in enumerate(zip(
                tuple(os_), tuple(ps) + (None,) * len(os_))) if a != b]
            self.dp_dims.append(dims[0] if dims and self.dp else None)
        # the leaves whose gradient the FSDP gather's backward has summed
        # over the data-parallel axes already
        self._fsdp_summed = [d is not None for d in T.flatten_up_to(
            shapes, self.fsdp_dims)]
        self.tp = su.mesh_axis(mesh, "model")
        self.rows_own = wide_dp and shd.blocks_replicated(cfg, shapes, mesh)
        self.gather_rows = self.tp if wide_dp and not self.rows_own \
            else None
        # rows on the model axis: the blocks' gradients are summed over it
        # (the vocab-parallel leaves, gathered whole over it at use, have
        # theirs summed by the gather's backward)
        self._model_sum = [self.rows_own and self.tp is not None and not any(
            "model" in shd._entry_axes(e) for e in ps) for ps in self._ps]
        self.rows = su.mesh_axis(mesh, dp_axes(mesh) + (
            ("model",) if self.rows_own else ()))

    def rctx(self, rctx: RunCtx) -> RunCtx:
        """``rctx`` with this layout's ZeRO-3 dims and row placement."""
        return dataclasses.replace(
            rctx, fsdp=self.fsdp_dims, dp_axes=dp_axes(self.mesh),
            vocab_whole=self.rows_own)

    # ---- the tree's placement ------------------------------------------------
    def state_specs(self, state) -> dict:
        """The specs of the launcher's state ``{"params", "train": {"opt",
        "ef"?}}`` (the error feedback mirrors the moments)."""
        train = {"opt": self.ospecs}
        if "ef" in state["train"]:
            train["ef"] = self.ospecs["m"]
        return {"params": self.pspecs, "train": train}

    def dp_slices(self, params) -> list:
        """Views of this rank's ZeRO slice of each parameter shard."""
        return [p if d is None else su.own_slice(p, d, self.dp)
                for p, d in zip(T.leaves(params), self.dp_dims)]

    def gather_dp(self, i: int, p: torch.Tensor, own: torch.Tensor) -> None:
        """Leaf ``i``'s shard ``p`` from every data-parallel rank's updated
        slice ``own`` (a view of ``p``), in place."""
        d = self.dp_dims[i]
        if d is not None:
            p.copy_(su.all_gather(own, d, self.dp))

    def reduce_grads(self, grads) -> list:
        """The mean over the batch's axes (the data-parallel ones, and the
        model axis for a wide batch's own rows) of each rank's gradient, at
        the rank's ZeRO slice. An FSDP slice's gradient comes summed over
        the data-parallel axes already."""
        out = []
        for g, d, fs, ms in zip(T.leaves(grads), self.dp_dims,
                                self._fsdp_summed, self._model_sum):
            if ms:
                g = su.all_reduce(g, self.tp)
            if self.dp is not None and not fs:
                g = (su.all_reduce(g, self.dp) if d is None
                     else su.reduce_scatter(g, d, self.dp))
            if self.rows is not None:
                g = g / self.rows.size
            out.append(g)
        return out

    def dp_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the batch's axes."""
        if self.rows is None:
            return x
        return su.all_reduce(x, self.rows) / self.rows.size

    # ---- sums over the mesh ----------------------------------------------------
    def _holder(self, spec) -> bool:
        """Whether this rank holds the first copy of a leaf of ``spec``: its
        coordinate is 0 on every axis the leaf is copied over."""
        split = {a for e in spec for a in shd._entry_axes(e)}
        return all(int(self.mesh.get_local_rank(a)) == 0
                   for a in self.mesh.mesh_dim_names if a not in split)

    def sum_once(self, per_leaf: list) -> torch.Tensor:
        """The sum over the whole tree of per-leaf values of the rank's
        slices (``opt_state_specs``' placement), each slice counted once."""
        import torch.distributed as dist
        total = torch.zeros((), dtype=torch.float32,
                            device=per_leaf[0].device)
        for x, spec in zip(per_leaf, self._os):
            if self._holder(spec):
                total = total + x
        dist.all_reduce(total)
        return total

    def block_ids(self, i: int, block: int, device) -> torch.Tensor:
        """The whole leaf ``i``'s flat index // ``block`` of each element of
        this rank's slice (the reference compresses the whole leaf in
        blocks of its flat order)."""
        shape, spec = self.shapes[i], self._os[i]
        local = shd.local_shape(shape, spec, self.mesh)
        idx = torch.zeros(local, dtype=torch.int64, device=device)
        stride = 1
        for d in reversed(range(len(shape))):
            ax = su.mesh_axis(self.mesh, shd._entry_axes(
                spec[d] if d < len(spec) else None))
            off = (ax.index if ax else 0) * local[d]
            r = torch.arange(off, off + local[d], device=device) * stride
            idx += r.reshape((-1,) + (1,) * (len(shape) - 1 - d))
            stride *= shape[d]
        return idx // block

    def max_blocks(self, amax: list) -> list:
        """The elementwise maximum over the mesh of each leaf's block
        maxima (one all-reduce)."""
        import torch.distributed as dist
        flat = torch.cat([a.reshape(-1) for a in amax])
        dist.all_reduce(flat, op=dist.ReduceOp.MAX)
        return list(torch.split(flat, [a.numel() for a in amax]))


def init_train_state(cfg: ModelConfig, params, train_cfg: TrainConfig,
                     layout: Optional[TrainLayout] = None):
    """AdamW's state (and the error feedback when compressing) of
    ``params``; with ``layout`` at this rank's ZeRO slices."""
    state = {"opt": adamw_init(params, layout)}
    if train_cfg.compress_grads:
        state["ef"] = compression.init_error_feedback(state["opt"]["m"])
    return state


def make_train_step(cfg: ModelConfig, rctx: RunCtx, train_cfg: TrainConfig,
                    layout: Optional[TrainLayout] = None):
    """Returns train_step(params, state, batch) -> (params, state, metrics).

    ``batch["tokens"]``: [B, S] (plus optional modality-frontend entries:
    "extra_embeds", "enc_embeds"), on the parameters' device; on a mesh,
    this rank's data-parallel rows, the parameters its shards and the
    state its slices (``layout``, built from ``rctx.mesh`` when not
    given)."""
    if rctx.mesh is not None:
        layout = layout or TrainLayout(cfg, rctx.mesh)
        rctx = layout.rctx(rctx)

    def value_and_grad(params, batch):
        leaves = [p.requires_grad_() for p in T.leaves(params)]
        loss = loss_fn(cfg, params, batch, rctx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def compute_grads(params, batch):
        ga = train_cfg.grad_accum
        if ga == 1:
            loss, grads = value_and_grad(params, batch)
            return loss, grads
        B = batch["tokens"].shape[0]
        if B % ga:
            raise ValueError(f"batch {B} does not split into {ga} "
                             f"micro-batches")
        mb = B // ga
        loss_sum, acc = None, None
        for i in range(ga):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, grads = value_and_grad(params, micro)
            if acc is None:
                loss_sum, acc = loss, [g.float() for g in grads]
            else:
                loss_sum = loss_sum + loss
                for a, g in zip(acc, grads):
                    a.add_(g.float())
        inv = 1.0 / ga
        return loss_sum * inv, [a.mul_(inv) for a in acc]

    def train_step(params, state, batch):
        if layout is not None and layout.gather_rows is not None:
            batch = {k: su.all_gather(v, 0, layout.gather_rows)
                     for k, v in batch.items()}
        loss, grads = compute_grads(params, batch)
        if layout is not None:
            grads = layout.reduce_grads(grads)
            loss = layout.dp_mean(loss)
        grads = T.unflatten(params, grads)
        if train_cfg.compress_grads:
            grads, state["ef"] = compression.compress_tree(
                grads, state["ef"], layout)
        params, state["opt"], metrics = adamw_update(
            train_cfg.optimizer, params, grads, state["opt"], layout)
        return params, state, dict(metrics, loss=loss)

    return train_step
