"""Mixture-of-Experts channel mixer (port of the reference
``models/moe.py``).

Two implementations selected by ``MoEContext.impl``:

* ``dense`` -- every expert on every token and a masked combine, as the
  reference's ``moe_ffn_dense`` computes it.
* ``ep`` -- expert parallelism over the mesh's ``model`` axis, on the
  rank's own experts (``w_gate``/``w_up``/``w_down`` are this rank's
  ``E/M`` experts, as ``launch/sharding.param_specs`` shards them): the
  rank's tokens are its sequence block (``S/M`` of its data-parallel
  rows), routed into per-expert capacity buffers ``[E, cap, d]`` with the
  Switch-style cumsum (``_dispatch_local``), exchanged with ``all_to_all``
  over the axis, run through the local experts, exchanged back, combined
  (``_combine_local``) and gathered over the axis. When ``S`` does not
  split over the axis (``_moe_ep_replicated``) every rank routes every
  token and applies its own experts' gates, and the outputs are summed.
  The aux loss is the mean of each shard's own, as the reference's
  ``pmean`` over the data and model axes gives it (the data-parallel part
  of that mean is the gradient average of the train step).

Both add the optional shared expert (column-parallel in, row-parallel
out under the mesh). Routing follows the arch: softmax top-k (Jamba, Qwen)
or DeepSeek-v3's aux-loss-free sigmoid routing with a correction bias,
which ``update_router_bias`` moves outside the gradient. Expert slots past
``num_real`` (``pad_experts``) are masked at ``-1e30``.

Gradients (``kernels/shard_utils.py``): every rank of the ``model`` axis
computes the whole loss of its rows, so the replicated router enters the
rank-specific routing through ``copy_to``, the tokens through
``scatter_to`` (or ``copy_to`` on the replicated route), the output leaves
through ``gather_from`` (or ``reduce_from``), and the exchange is its own
inverse.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import shard_utils as su
from repro_torch.models.layers import act_fn, dense_init, mlp


@dataclasses.dataclass(frozen=True)
class MoEContext:
    """Runtime distribution context for the MoE block."""

    impl: str = "dense"                      # "dense" | "ep"
    mesh: Any = None
    dp_axes: Tuple[str, ...] = ()            # e.g. ("pod", "data") or ("data",)
    tp_axis: str = "model"
    capacity_factor: float = 1.25

NEG_INF = -1e30


def pad_experts(num_experts: int, multiple: int = 16) -> int:
    return (num_experts + multiple - 1) // multiple * multiple


def init_moe(gen: torch.Generator, reps: int, d_model: int, moe_d_ff: int,
             num_experts: int, num_experts_padded: int, shared_d_ff: int,
             dtype, device, aux_free: bool = False) -> dict:
    """MoE block params with a leading ``[reps]`` axis, in the reference's
    distributions: a fp32 router, expert weights normal * 1/sqrt(fan_in)
    (drawn one expert at a time, so the fp32 scratch is one expert's
    matrix), a zero fp32 router bias with ``aux_free``, and the shared
    expert's MLP when ``shared_d_ff``."""
    E = num_experts_padded

    def dense(fan_in, fan_out, lead=(), dt=dtype):
        return dense_init(gen, (reps, *lead, fan_in, fan_out), fan_in, dt,
                          device)

    params = {
        "router": dense(d_model, E, dt=torch.float32),
        "w_gate": dense(d_model, moe_d_ff, (E,)),
        "w_up": dense(d_model, moe_d_ff, (E,)),
        "w_down": dense(moe_d_ff, d_model, (E,)),
    }
    if aux_free:
        params["router_bias"] = torch.zeros((reps, E), dtype=torch.float32,
                                            device=device)
    if shared_d_ff:
        params["shared"] = {"wi_gate": dense(d_model, shared_d_ff),
                            "wi_up": dense(d_model, shared_d_ff),
                            "wo": dense(shared_d_ff, d_model)}
    return params


def _route(params, t, num_real: int, top_k: int, aux_free: bool):
    """t: [T, d]. Returns (ids [T, K], weights [T, K] fp32, aux loss)."""
    E = params["router"].shape[-1]
    logits = t.float() @ params["router"]                        # [T, E]
    pad = torch.arange(E, device=t.device) >= num_real
    if E > num_real:
        logits = logits.masked_fill(pad, NEG_INF)
    if aux_free:
        scores = torch.sigmoid(logits)
        sel = scores + params["router_bias"]
        if E > num_real:
            sel = sel.masked_fill(pad, NEG_INF)
        ids = torch.topk(sel, top_k, dim=-1).indices
        w = torch.gather(scores, 1, ids)
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
        aux = torch.zeros((), device=t.device)
    else:
        probs = torch.softmax(logits, dim=-1)
        top_p, ids = torch.topk(probs, top_k, dim=-1)
        w = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
        # Switch-style load-balance loss on the real experts
        me = probs[:, :num_real].mean(dim=0)
        ce = F.one_hot(ids[:, 0], E)[:, :num_real].float().mean(dim=0)
        aux = num_real * torch.sum(me * ce)
    return ids, w, aux


def _expert_ffn(x, w_gate, w_up, w_down, activation: str):
    """x: [E, C, d]; weights [E, d, f] / [E, f, d]."""
    g = act_fn(activation)(torch.bmm(x, w_gate))
    return torch.bmm(g * torch.bmm(x, w_up), w_down)


def moe_ffn_dense(params, x, num_real: int, top_k: int, activation: str,
                  aux_free: bool):
    """Masked-dense MoE, every expert on every token: [B, S, d] ->
    ([B, S, d], aux)."""
    B, S, d = x.shape
    E = params["w_gate"].shape[0]
    t = x.reshape(-1, d)
    ids, w, aux = _route(params, t, num_real, top_k, aux_free)
    gates = torch.zeros((t.shape[0], E), dtype=torch.float32,
                        device=x.device).scatter_(1, ids, w)
    h = _expert_ffn(t.expand(E, *t.shape), params["w_gate"], params["w_up"],
                    params["w_down"], activation)                # [E, T, d]
    y = torch.einsum("etd,te->td", h.float(), gates)
    return y.reshape(B, S, d).to(x.dtype), aux


def _dispatch_local(t, ids, w, E: int, cap: int):
    """Token->expert capacity dispatch on one shard: t [T, d], ids/w [T,
    K]. Each (token, choice) takes the next free row of its expert's
    buffer; past ``cap`` rows it is dropped (written to a spare row that is
    cut off). Returns (buf [E, cap, d], meta for ``_combine_local``)."""
    T, K = ids.shape
    flat_ids = ids.reshape(-1)                                   # [T*K]
    oh = F.one_hot(flat_ids, E).to(torch.int32)                  # [T*K, E]
    pos_all = torch.cumsum(oh, dim=0, dtype=torch.int32) - 1     # in expert
    pos = torch.gather(pos_all, 1, flat_ids[:, None])[:, 0]
    keep = pos < cap
    safe_pos = torch.where(keep, pos, torch.full_like(pos, cap))
    t_rep = torch.repeat_interleave(t, K, dim=0)                 # [T*K, d]
    buf = t.new_zeros((E, cap + 1, t.shape[1])).index_put(
        (flat_ids, safe_pos.long()), t_rep)
    return buf[:, :cap], (flat_ids, safe_pos, keep)


def _combine_local(buf_out, meta, w, T: int, K: int):
    """Each token's expert outputs from ``buf_out`` [E, cap, d] (zero where
    dropped), weighted by ``w`` [T, K] and summed: [T, d]."""
    flat_ids, safe_pos, keep = meta
    rows = torch.clamp(safe_pos, max=buf_out.shape[1] - 1).long()
    gathered = buf_out[flat_ids, rows]                           # [T*K, d]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=gathered.device))
    wf = w.reshape(-1)[:, None].to(gathered.dtype)
    return (gathered * wf).reshape(T, K, -1).sum(dim=1)


def _ep_axis(params, ctx: MoEContext):
    """The model axis of the EP route and the expert counts: (axis, E,
    E/M). Raises where the expert weights are not this rank's ``E/M``
    experts (the reference asserts ``E % M == 0``)."""
    ax = su.mesh_axis(ctx.mesh, ctx.tp_axis)
    M = ax.size if ax else 1
    E = params["router"].shape[-1]
    El = params["w_gate"].shape[0]
    if E % M or El * M != E:
        raise ValueError(f"experts {E} not divisible by model axis {M} "
                         f"(this rank holds {El})")
    return ax, E, El


def moe_ffn_ep(params, x, num_real: int, top_k: int, activation: str,
               aux_free: bool, ctx: MoEContext):
    """Expert-parallel MoE on this rank: x [B, S, d] its data-parallel rows
    (replicated over the model axis), the expert weights its own ``E/M``.
    Returns (y [B, S, d], the mean over the model axis of each shard's
    aux loss)."""
    ax, E, El = _ep_axis(params, ctx)
    M = ax.size if ax else 1
    if x.shape[1] % M != 0:
        # sequences too short to split over the model axis (decode):
        # every rank routes every token, runs its own experts densely
        return _moe_ep_replicated(params, x, num_real, top_k, activation,
                                  aux_free, ctx)
    B, S, d = x.shape
    x_loc = su.scatter_to(x, 1, ax)                              # [B, S/M, d]
    t = x_loc.reshape(-1, d)
    T = t.shape[0]
    local = {"router": su.copy_to(params["router"], ax)}
    if "router_bias" in params:
        local["router_bias"] = params["router_bias"]
    ids, w, aux = _route(local, t, num_real, top_k, aux_free)
    cap = max(8, int(math.ceil(T * top_k * ctx.capacity_factor / E / 8)) * 8)
    buf, meta = _dispatch_local(t, ids, w, E, cap)               # [E, cap, d]
    # exchange: block j of the experts to rank j; back the same way
    recv = su.all_to_all(buf.reshape(M, El, cap, d), ax)         # [M, El, ...]
    xin = recv.transpose(0, 1).reshape(El, M * cap, d)
    h = _expert_ffn(xin, params["w_gate"], params["w_up"], params["w_down"],
                    activation)
    back = h.reshape(El, M, cap, d).transpose(0, 1)
    buf_out = su.all_to_all(back, ax).reshape(E, cap, d)
    y = _combine_local(buf_out, meta, w, T, top_k)
    y = su.gather_from(y.reshape(B, S // M, d), 1, ax)
    return y.to(x.dtype), _mean_over(aux, ax)


def _mean_over(aux, ax):
    """The mean over the model axis of each rank's ``aux`` (sum forward,
    identity backward: each rank's share of the mean's gradient)."""
    if ax is None:
        return aux
    return su.reduce_from(aux, ax) / torch.full((), float(ax.size),
                                                device=aux.device)


def _moe_ep_replicated(params, x, num_real: int, top_k: int,
                       activation: str, aux_free: bool, ctx: MoEContext):
    """EP over tokens replicated across the model axis: every rank routes
    all of them, applies the gates of its own experts only, and the
    outputs are summed over the axis."""
    ax, E, El = _ep_axis(params, ctx)
    B, S, d = x.shape
    xr = su.copy_to(x, ax)
    t = xr.reshape(-1, d)
    local = {"router": su.copy_to(params["router"], ax)}
    if "router_bias" in params:
        local["router_bias"] = params["router_bias"]
    ids, w, aux = _route(local, t, num_real, top_k, aux_free)
    lo = (ax.index if ax else 0) * El
    mine = (ids >= lo) & (ids < lo + El)
    idx = torch.clamp(ids - lo, 0, El - 1)
    # gate weights of this rank's experts; everything else contributes 0
    local_gate = torch.zeros((t.shape[0], El), dtype=torch.float32,
                             device=x.device)
    for kk in range(top_k):
        local_gate = local_gate.index_put(
            (torch.arange(t.shape[0], device=x.device), idx[:, kk]),
            torch.where(mine[:, kk], w[:, kk], torch.zeros_like(w[:, kk])),
            accumulate=True)
    h = _expert_ffn(t.expand(El, *t.shape), params["w_gate"],
                    params["w_up"], params["w_down"], activation)  # [El, T, d]
    y = su.reduce_from(torch.einsum("etd,te->td", h.float(), local_gate), ax)
    return y.reshape(B, S, d).to(x.dtype), _mean_over(aux, ax)


def _tp_axis(ctx: MoEContext, sp, d_ff: int):
    """The model axis when the shared expert's weights are this rank's
    columns/rows (its local width below ``d_ff``), else None."""
    if sp["wi_gate"].shape[-1] == d_ff:
        return None
    return su.mesh_axis(ctx.mesh, ctx.tp_axis)


def moe_ffn(params, x, *, num_real: int, top_k: int, activation: str,
            aux_free: bool, ctx: MoEContext = MoEContext(),
            shared_d_ff: int = 0):
    """Full MoE block: routed experts plus the optional shared expert
    (``shared_d_ff`` its full width: a narrower weight is this rank's
    tensor-parallel shard). Returns (y [B, S, d], aux)."""
    if ctx.impl == "ep":
        y, aux = moe_ffn_ep(params, x, num_real, top_k, activation,
                            aux_free, ctx)
    elif ctx.impl == "dense":
        y, aux = moe_ffn_dense(params, x, num_real, top_k, activation,
                               aux_free)
    else:
        raise ValueError(f"MoE impl {ctx.impl!r}: dense or ep")
    if "shared" in params:
        sp = params["shared"]
        y = y + mlp(sp, x, activation,
                    _tp_axis(ctx, sp, shared_d_ff or sp["wi_gate"].shape[-1]))
    return y, aux


def update_router_bias(params, expert_load, num_real: int,
                       step_size: float = 1e-3):
    """DeepSeek-v3 aux-loss-free balancing: nudge the bias against load
    imbalance, outside the gradient. ``expert_load``: [E] fraction of
    tokens routed to each expert this step. Returns a new dict."""
    target = 1.0 / num_real
    real = torch.arange(expert_load.shape[0],
                        device=expert_load.device) < num_real
    err = torch.where(real, target - expert_load,
                      torch.zeros((), dtype=expert_load.dtype,
                                  device=expert_load.device))
    return dict(params, router_bias=params["router_bias"]
                + step_size * torch.sign(err))
