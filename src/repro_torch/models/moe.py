"""Mixture-of-Experts channel mixer (port of the single-device route of the
reference ``models/moe.py``).

``moe_ffn`` with ``impl="dense"``: every expert on every token and a
masked combine, as the reference's ``moe_ffn_dense`` computes it, plus the
optional shared expert. Routing follows the arch: softmax top-k (Jamba,
Qwen) or DeepSeek-v3's aux-loss-free sigmoid routing with a correction
bias. Expert slots past ``num_real`` (``pad_experts``) are masked at
``-1e30``. The expert-parallel route (``impl="ep"``) needs several GPUs and
is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import act_fn, dense_init

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


def moe_ffn(params, x, *, num_real: int, top_k: int, activation: str,
            aux_free: bool, impl: str = "dense"):
    """The MoE block: routed experts plus the optional shared expert.
    Returns (y [B, S, d], aux)."""
    if impl != "dense":
        raise NotImplementedError(
            f"MoE impl {impl!r} (expert parallelism) is not ported")
    y, aux = moe_ffn_dense(params, x, num_real, top_k, activation, aux_free)
    if "shared" in params:
        sp = params["shared"]
        g = act_fn(activation)(x @ sp["wi_gate"])
        y = y + (g * (x @ sp["wi_up"])) @ sp["wo"]
    return y, aux
