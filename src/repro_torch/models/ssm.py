"""Recurrent sequence mixers: Mamba-1 selective SSM, xLSTM mLSTM and sLSTM
(port of the reference ``models/ssm.py``).

* Mamba (selective SSM): the projections, the causal depthwise conv and
  the softplus of dt in PyTorch, the recurrence through the selective-scan
  kernel (``kernels/mamba_scan``), which reads the carried ``ssm`` state
  and writes the new one. The reference's ``mamba_mix`` computes the same
  recurrence with ``lax.scan``.
* mLSTM (matrix memory): the projections, the causal depthwise conv, the
  gates and the group norm in PyTorch, the recurrence through the mLSTM
  chunkwise kernel (``kernels/mlstm_chunkwise``), which reads the carried
  state ``(C, n, m)`` and writes the new one. The reference's
  ``mlstm_mix`` computes the same function as a stabilized quadratic form
  over tile pairs plus the carried-state term.
* sLSTM (scalar memory with recurrent gate feedback): inherently
  sequential, with no TPU kernel; a PyTorch loop over time, the input
  gates projected once per chunk and one ``h @ R`` per step.

Every mixer takes the state of the rows it runs and updates it **in
place** (the reference returns a new state): pass ``rows`` to run a subset
of a larger state's batch rows (the slot engine's decoding rows); the other
rows stay bit-identical. ``state=None`` starts from a fresh state and
returns the new one outside the autograd graph: that is training's path,
where the Mamba and mLSTM kernels run through their ``autograd.Function``
(``mamba_scan_fresh_op``, ``mlstm_chunkwise_fresh_op``: the kernel
forward, the plain version's gradient) and the sLSTM loop is
differentiated by autograd as it runs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import cost as C
from repro_torch.kernels import shard_utils as su
from repro_torch.kernels.mamba_scan.ops import (mamba_scan_fresh_op,
                                                mamba_scan_op)
from repro_torch.kernels.mlstm_chunkwise.ops import (mlstm_chunkwise_fresh_op,
                                                     mlstm_chunkwise_op)
from repro_torch.models.layers import dense_init

NEG_INF = -1e30
CONV_K = 4          # the mLSTM's causal conv width (init_mlstm's conv_w)


def _mamba_conv_full(x, w, b, init_state: Optional[torch.Tensor]):
    """Causal depthwise conv over [B, S, d]; returns (silu(y + b), new conv
    state = the last K-1 inputs). ``init_state`` is the last K-1 inputs of
    the previous chunk [B, K-1, d], or None at sequence start."""
    B, S, d = x.shape
    K = w.shape[0]
    if init_state is None:
        init_state = torch.zeros((B, K - 1, d), dtype=x.dtype, device=x.device)
    xp = torch.cat([init_state.to(x.dtype), x], dim=1)           # [B,S+K-1,d]
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return F.silu(y + b), xp[:, S:S + K - 1]


def _group_norm_heads(x, scale, H: int, eps: float = 1e-6):
    """Per-head group norm of [B, S, di] (di = H*Dh), fp32 inside."""
    B, S, di = x.shape
    xh = x.reshape(B, S, H, di // H).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, unbiased=False)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    out = xh.reshape(B, S, di) * (1.0 + scale.float())
    return out.to(x.dtype)


def _gather(t, rows):
    return t if rows is None else t.index_select(0, rows)


def _put(dst, rows, src):
    """Write ``src`` into the state leaf ``dst`` (at ``rows``), in place."""
    if rows is None:
        dst.copy_(src)
    else:
        dst.index_copy_(0, rows, src.to(dst.dtype))


# =============================================================================
# Mamba-1 selective SSM
# =============================================================================
def init_mamba(gen: torch.Generator, reps: int, d_model: int, d_inner: int,
               d_state: int, d_conv: int, dtype, device) -> dict:
    """Mamba block params with a leading ``[reps]`` axis, in the reference's
    distributions: S4D-real ``A_log``, ``dt_bias`` the inverse softplus of
    a log-uniform dt in [0.001, 0.1]; ``A_log``, ``dt_bias`` and ``D`` are
    fp32."""
    dt_rank = max(1, math.ceil(d_model / 16))

    def dense(fan_in, fan_out):
        return dense_init(gen, (reps, fan_in, fan_out), fan_in, dtype, device)

    f32 = dict(dtype=torch.float32, device=device)
    A = torch.arange(1, d_state + 1, **f32).expand(reps, d_inner, d_state)
    dt = torch.exp(torch.rand((reps, d_inner), generator=gen, **f32)
                   * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "in_proj": dense(d_model, 2 * d_inner),
        "conv_w": (torch.randn((reps, d_conv, d_inner), generator=gen,
                               **f32) * 0.1).to(dtype),
        "conv_b": torch.zeros((reps, d_inner), dtype=dtype, device=device),
        "x_proj": dense(d_inner, dt_rank + 2 * d_state),
        "dt_proj": dense(dt_rank, d_inner),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "A_log": torch.log(A),
        "D": torch.ones((reps, d_inner), **f32),
        "out_proj": dense(d_inner, d_model),
    }


def init_mamba_state(B: int, d_inner: int, d_state: int, d_conv: int, dtype,
                     device=None) -> dict:
    return {"conv": torch.zeros((B, d_conv - 1, d_inner), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((B, d_inner, d_state), dtype=torch.float32,
                               device=device)}


def mamba_mix(params, x, state: Optional[dict], *,
              rows: Optional[torch.Tensor] = None, tp=None):
    """Mamba over a chunk x [B, S, d_model] from the carried state.

    state = {"conv": [Bs, K-1, d_inner], "ssm": [Bs, d_inner, d_state]
    f32}, or None for a fresh one; batch row b runs on state row
    ``rows[b]`` (b when None). The state is updated in place; a fresh one
    is returned outside the autograd graph. Returns (out [B, S, d_model],
    state). With ``tp`` (a ``shard_utils.Axis``: the parameters are this
    rank's shards) the layer runs on this rank's ``d_inner`` channels
    (:func:`_mamba_mix_sharded`), and so does the state."""
    if tp is not None:
        return _mamba_mix_sharded(params, x, tp, state, rows)
    d_state = params["A_log"].shape[-1]
    dt_rank = params["dt_proj"].shape[0]
    fresh = state is None

    xm, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)
    xm, new_conv = _mamba_conv_full(xm, params["conv_w"], params["conv_b"],
                                    None if fresh else
                                    _gather(state["conv"], rows))
    dbc = xm @ params["x_proj"]
    Bm = dbc[..., dt_rank:dt_rank + d_state].float()             # [B,S,n]
    Cm = dbc[..., dt_rank + d_state:].float()
    # jax.nn.softplus is logaddexp(v, 0); F.softplus turns linear above 20
    v = (dbc[..., :dt_rank] @ params["dt_proj"]).float() + params["dt_bias"]
    dt = torch.logaddexp(v, v.new_zeros(()))                      # [B,S,d]
    A = -torch.exp(params["A_log"])
    if fresh:
        y, h = mamba_scan_fresh_op(xm, dt, Bm, Cm, A, params["D"])
        state = {"conv": new_conv.detach(), "ssm": h}
    else:
        y = mamba_scan_op(xm, dt, Bm, Cm, A, params["D"], state["ssm"],
                          rows=rows)
        _put(state["conv"], rows, new_conv)
    return (y * F.silu(z)) @ params["out_proj"], state


def _mamba_mix_sharded(params, x, tp, state=None, rows=None):
    """Mamba on this rank's ``d_inner`` channels ``[lo, lo + dl)``, under
    the reference's rules: the conv, ``A_log`` and ``D`` are the rank's
    channels, and the projections and ``dt_bias`` are replicated (``proj``
    and ``bias`` match the replicated pattern first). The scan (#6) runs on
    the local channels, from a fresh state (training) or from ``state``,
    the rank's channels of the carried one (``conv`` [Bs, K-1, dl], ``ssm``
    [Bs, dl, n], as ``cache_specs`` places them), updated in place.
    ``in_proj``'s product and the dt/B/C projection feed this rank's
    channels, so they enter through ``copy_to``; the conv's and the scan's
    channel blocks are gathered for the replicated ``x_proj`` and
    ``out_proj``. Returns (out [B, S, d_model], the state of the local
    channels)."""
    d_state = params["A_log"].shape[-1]
    dt_rank = params["dt_proj"].shape[0]
    dl = params["conv_w"].shape[-1]
    di = dl * tp.size
    lo = tp.index * dl
    if params["x_proj"].shape[-2] != di or params["D"].shape[-1] != dl:
        raise NotImplementedError("a Mamba layer sharded other than the "
                                  "conv, A_log and D on d_inner")
    fresh = state is None
    xz = su.copy_to(x @ params["in_proj"], tp)
    xm, z = xz[..., lo:lo + dl], xz[..., di + lo:di + lo + dl]
    xm, new_conv = _mamba_conv_full(xm, params["conv_w"], params["conv_b"],
                                    None if fresh else
                                    _gather(state["conv"], rows))
    dbc = su.copy_to(su.gather_from(xm, 2, tp) @ params["x_proj"], tp)
    Bm = dbc[..., dt_rank:dt_rank + d_state].float()             # [B,S,n]
    Cm = dbc[..., dt_rank + d_state:].float()
    v = (dbc[..., :dt_rank] @ su.copy_to(params["dt_proj"], tp)[
        :, lo:lo + dl]).float() + su.copy_to(params["dt_bias"], tp)[lo:lo + dl]
    dt = torch.logaddexp(v, v.new_zeros(()))                      # [B,S,dl]
    A = -torch.exp(params["A_log"])
    if fresh:
        y, h = mamba_scan_fresh_op(xm, dt, Bm, Cm, A, params["D"])
        state = {"conv": new_conv.detach(), "ssm": h}
    else:
        y = mamba_scan_op(xm, dt, Bm, Cm, A, params["D"], state["ssm"],
                          rows=rows)
        _put(state["conv"], rows, new_conv)
    out = su.gather_from(y * F.silu(z), 2, tp) @ params["out_proj"]
    return out, state


# =============================================================================
# mLSTM
# =============================================================================
def init_mlstm(gen: torch.Generator, reps: int, d_model: int, num_heads: int,
               dtype, device) -> dict:
    """mLSTM block params with a leading ``[reps]`` axis, in the reference's
    distributions (inner dim di = 2*d_model)."""
    di = 2 * d_model

    def dense(fan_in, fan_out):
        return dense_init(gen, (reps, fan_in, fan_out), fan_in, dtype, device)

    bias = torch.cat([torch.zeros(num_heads),
                      torch.linspace(3.0, 6.0, num_heads)]).float()
    return {
        "up_proj": dense(d_model, 2 * di),
        "conv_w": (torch.randn((reps, CONV_K, di), generator=gen,
                               device=device) * 0.1).to(dtype),
        "conv_b": torch.zeros((reps, di), dtype=dtype, device=device),
        "wq": dense(di, di),
        "wk": dense(di, di),
        "wv": dense(di, di),
        "w_gates": dense(di, 2 * num_heads),
        "gate_bias": bias.to(device).expand(reps, -1).clone(),
        "gn_scale": torch.zeros((reps, di), dtype=dtype, device=device),
        "down_proj": dense(di, d_model),
    }


def init_mlstm_state(B: int, d_model: int, num_heads: int, dtype,
                     device=None) -> dict:
    di = 2 * d_model
    Dh = di // num_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((B, num_heads, Dh, Dh), **f32),
            "n": torch.zeros((B, num_heads, Dh), **f32),
            "m": torch.full((B, num_heads), NEG_INF, **f32),
            "conv": torch.zeros((B, CONV_K - 1, di), dtype=dtype,
                                device=device)}


def mlstm_mix(params, x, state: Optional[dict], num_heads: int, *,
              rows: Optional[torch.Tensor] = None):
    """mLSTM over a chunk x [B, S, d_model] from the carried state.

    state = {"C": [Bs,H,Dh,Dh] f32, "n": [Bs,H,Dh] f32, "m": [Bs,H] f32,
    "conv": [Bs, 3, di]}, or None for a fresh one; batch row b runs on
    state row ``rows[b]`` (b when None). The state is updated in place; a
    fresh one is returned outside the autograd graph. Returns (out [B, S,
    d_model], state)."""
    B, S, d_model = x.shape
    H = num_heads
    di = 2 * d_model
    Dh = di // H
    fresh = state is None

    xz = x @ params["up_proj"]
    xm, z = torch.chunk(xz, 2, dim=-1)
    xc, new_conv = _mamba_conv_full(xm, params["conv_w"], params["conv_b"],
                                    None if fresh else
                                    _gather(state["conv"], rows))
    q = (xc @ params["wq"]).reshape(B, S, H, Dh)
    k = (xc @ params["wk"]).reshape(B, S, H, Dh) / math.sqrt(Dh)
    v = (xm @ params["wv"]).reshape(B, S, H, Dh)
    gates = (xm @ params["w_gates"]).float() + params["gate_bias"]
    log_i = gates[..., :H]                                       # [B,S,H]
    log_f = F.logsigmoid(gates[..., H:])
    if fresh:
        h, C, n_new, m_new = mlstm_chunkwise_fresh_op(q, k, v, log_i, log_f)
        state = {"C": C, "n": n_new, "m": m_new, "conv": new_conv.detach()}
    else:
        h, n_new, m_new = mlstm_chunkwise_op(q, k, v, log_i, log_f,
                                             state["C"], state["n"],
                                             state["m"], rows=rows)
        _put(state["n"], rows, n_new)
        _put(state["m"], rows, m_new)
        _put(state["conv"], rows, new_conv)

    h = _group_norm_heads(h.reshape(B, S, di).to(x.dtype), params["gn_scale"],
                          H)
    return (h * F.silu(z)) @ params["down_proj"], state


def mlstm_decode(params, x, state: dict, num_heads: int, *, rows=None):
    """Single-token mLSTM step. x: [B, 1, d_model]."""
    return mlstm_mix(params, x, state, num_heads, rows=rows)


# =============================================================================
# sLSTM
# =============================================================================
def init_slstm(gen: torch.Generator, reps: int, d_model: int, num_heads: int,
               dtype, device) -> dict:
    """sLSTM block params with a leading ``[reps]`` axis, in the reference's
    distributions."""
    Dh = d_model // num_heads
    ff = ((4 * d_model // 3) + 63) // 64 * 64

    def dense(fan_in, fan_out):
        return dense_init(gen, (reps, fan_in, fan_out), fan_in, dtype, device)

    bias = torch.cat([torch.zeros(2 * d_model), torch.ones(d_model) * 2.0,
                      torch.zeros(d_model)]).float()
    return {
        "w_gates": dense(d_model, 4 * d_model),                 # z, i, f, o
        "r_gates": (torch.randn((reps, num_heads, Dh, 4 * Dh), generator=gen,
                                device=device) / math.sqrt(Dh)).to(dtype),
        "gate_bias": bias.to(device).expand(reps, -1).clone(),
        "gn_scale": torch.zeros((reps, d_model), dtype=dtype, device=device),
        "up_proj": dense(d_model, 2 * ff),
        "down_proj": dense(ff, d_model),
    }


def init_slstm_state(B: int, d_model: int, num_heads: int, dtype=None,
                     device=None) -> dict:
    Dh = d_model // num_heads
    return {name: torch.zeros((B, num_heads, Dh), dtype=torch.float32,
                              device=device) for name in ("c", "n", "h", "m")}


def _slstm_loop(gx, R, c, n, h, m):
    """The sLSTM's loop over time: gate inputs gx [B, S, 4, H, Dh] fp32,
    the recurrent weights R [H, Dh, 4 Dh] fp32, from the state (c, n, h,
    m). Returns (h of every step [B, S, H, Dh], and the final c, n, h,
    m)."""
    B, S, _, H, Dh = gx.shape
    ys = []
    for t in range(S):
        gr = torch.bmm(h.transpose(0, 1), R).transpose(0, 1)     # [B,H,4Dh]
        g = gx[:, t] + gr.reshape(B, H, 4, Dh).transpose(1, 2)   # [B,4,H,Dh]
        z_t = torch.tanh(g[:, 0])
        i_t = g[:, 1]
        f_t = F.logsigmoid(g[:, 2])
        o_t = torch.sigmoid(g[:, 3])
        m_new = torch.maximum(f_t + m, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(f_t + m - m_new)
        c = f_p * c + i_p * z_t
        n = f_p * n + i_p
        h = o_t * (c / torch.clamp(n, min=1e-6))
        m = m_new
        ys.append(h)
    return torch.stack(ys, dim=1), c, n, h, m


def slstm_cost(B: int, S: int, H: int, Dh: int, backward: bool = False
               ) -> C.Work:
    """The work of :func:`_slstm_loop` (fp32): a step's ``h @ R`` (8 B H
    Dh^2) and about 22 elementwise operations an element of the state;
    each step reads R, its gate inputs and the state and writes the state
    and h. The backward counts twice the forward."""
    flops = S * (8 * B * H * Dh * Dh + 22 * B * H * Dh)
    nbytes = S * 4 * (4 * H * Dh * Dh + 4 * B * H * Dh + B * H * Dh
                      + 8 * B * H * Dh)
    k = 2 if backward else 1
    return C.Work(flops=k * flops, bytes=k * nbytes, dtype="float32")


class _SlstmLoopNoData(torch.autograd.Function):
    """:func:`_slstm_loop` on tensors that hold no data (a traced program,
    such as the dry run's): empty outputs of its shapes, its work counted
    (``kernels/cost.py``) forward and backward, as a kernel's is. Tracing
    the loop step by step would take the dry run's tracer about an hour
    at xlstm-125m's 4096 steps."""

    @staticmethod
    def forward(ctx, gx, R, c, n, h, m):
        B, S, _, H, Dh = gx.shape
        ctx.dims = (B, S, H, Dh)
        C.record("slstm_loop", slstm_cost(B, S, H, Dh))
        return (gx.new_empty((B, S, H, Dh)), *(torch.empty_like(t)
                                               for t in (c, n, h, m)))

    @staticmethod
    def backward(ctx, *grads):
        C.record("slstm_loop", slstm_cost(*ctx.dims, backward=True))
        g = grads[0]
        B, S, H, Dh = ctx.dims
        return (g.new_empty((B, S, 4, H, Dh)), g.new_empty((H, Dh, 4 * Dh)),
                *(g.new_empty((B, H, Dh)) for _ in range(4)))


def slstm_mix(params, x, state: Optional[dict], num_heads: int, *,
              rows: Optional[torch.Tensor] = None):
    """sLSTM over x [B, S, d]: a loop over time (recurrent gate feedback).
    state = {"c", "n", "h", "m": [Bs, H, Dh] f32} or None; batch row b runs
    on state row ``rows[b]`` (b when None). The state is updated in place;
    a fresh one is returned outside the autograd graph. Returns (out [B, S,
    d], state)."""
    B, S, d = x.shape
    H = num_heads
    Dh = d // H
    fresh = state is None
    if fresh:
        state = init_slstm_state(B, d, H, device=x.device)
    gx = (x @ params["w_gates"]).float() + params["gate_bias"]   # [B,S,4d]
    gx = gx.reshape(B, S, 4, H, Dh)
    c, n, h, m = (_gather(state[k], rows) for k in ("c", "n", "h", "m"))
    R = params["r_gates"].float()                                # [H,Dh,4Dh]
    loop = _SlstmLoopNoData.apply if C.is_fake(gx) else _slstm_loop
    ys, c, n, h, m = loop(gx, R, c, n, h, m)
    if fresh:
        state = {"c": c.detach(), "n": n.detach(), "h": h.detach(),
                 "m": m.detach()}
    else:
        for name, val in (("c", c), ("n", n), ("h", h), ("m", m)):
            _put(state[name], rows, val)
    y = ys.reshape(B, S, d).to(x.dtype)
    y = _group_norm_heads(y, params["gn_scale"], H)
    a, b = torch.chunk(y @ params["up_proj"], 2, dim=-1)
    return (F.gelu(a, approximate="tanh") * b) @ params["down_proj"], state
