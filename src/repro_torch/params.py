"""Model parameters of the PyTorch port.

* ``init_params(cfg, seed, device)`` draws the reference's distributions
  (``models/layers.py`` ``dense_init``/``embed_init`` and ``init_params`` in
  ``models/model.py``) with a ``torch.Generator``, directly on the device:
  normal * 1/sqrt(fan_in) for dense weights, normal * 0.02 for the
  embedding, zeros for norm weights (applied as ``1 + w``); the fp32
  leaves of the reference (Mamba's ``A_log``, ``dt_bias`` and ``D``, the
  MoE router) stay fp32. Large weights are drawn one matrix at a time (each
  expert of an MoE layer too), so the fp32 scratch stays one matrix. This
  is how the full-width model gets its weights on the card; the numbers
  differ from JAX's for the same seed, and a card's generator draws
  other numbers than the CPU's.
* ``init_params_on_host(cfg, seed, device)`` draws them on the CPU and
  moves them to ``device``: the same numbers on every device, so a smoke
  run on the card serves the CPU's weights (the examples do).
* ``from_jax_numpy(cfg, tree)`` carries the reference's ``init_params``
  pytree (or a cache: paged from ``init_paged_cache``, or slot from
  ``init_cache`` with its KV rows and recurrent state, possibly already
  written), given as numpy arrays, across unchanged (dtypes kept), so the
  tests can feed both frameworks the same weights and start both from the
  same cache. Stacks keep their ``[reps, ...]`` leading axis.

Both carry the reference's ``mtp`` subtree (DeepSeek-v3's
multi-token-prediction module: ``proj`` [2d, d], a one-repetition ``block``
stack of the first mixer with a dense FFN, ``ln``), which only the
training loss ``_mtp_loss`` reads; serving never reads it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import (ATTN, DENSE, MAMBA, MLA, MLSTM, MOE,
                                      SLSTM, ModelConfig)
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.layers import dense_init, embed_init
from repro_torch.models.model import _moe_pad, build_stacks, check_supported


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return _tensor(tree, device)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def from_jax_numpy(cfg: ModelConfig, tree, device="cpu"):
    """Nested dicts/lists of numpy arrays -> the same structure of tensors
    on ``device`` (dtypes kept; bf16 arrays included). For a parameter tree
    (a dict with ``"stacks"``) or a cache (a list of stacks), every
    stacked leaf must carry ``cfg``'s repetition count as its leading axis
    (one for the ``mtp`` block)."""
    out = _convert(tree, device)
    stacks = out.get("stacks") if isinstance(out, dict) else out
    if isinstance(stacks, list):
        _check_reps(cfg, stacks, build_stacks(cfg))
    if isinstance(out, dict) and "encoder" in out:
        _check_reps(cfg, out["encoder"]["stacks"],
                    [(((ATTN, DENSE),), cfg.num_encoder_layers)])
    if isinstance(out, dict) and "mtp" in out:
        _check_reps(cfg, [out["mtp"]["block"]],
                    [(((cfg.layer_pattern[0], DENSE),), 1)])
    return out


def init_params_on_host(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """:func:`init_params` drawn by the CPU's generator, then moved to
    ``device``: the same values on every device."""
    from repro_torch.train.tree import tree_map
    return tree_map(lambda x: x.to(device), init_params(cfg, seed, "cpu"))


def _check_reps(cfg: ModelConfig, stacks, built) -> None:
    if len(stacks) != len(built):
        raise ValueError(f"{len(stacks)} stacks, {cfg.name} has "
                         f"{len(built)}")
    for (_, reps), stack in zip(built, stacks):
        for leaf in _leaves(stack):
            if leaf.shape[0] != reps:
                raise ValueError(f"stacked leaf of shape "
                                 f"{tuple(leaf.shape)}: {cfg.name} "
                                 f"repeats its period {reps} times")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random parameters in the reference's structure and distributions,
    for the configs the port computes (attention with its q/k norms and
    post-norms where the config has them, MLA, Mamba, mLSTM or sLSTM
    mixers; dense MLP, MoE or no FFN; an encoder-decoder's ``encoder``
    stack and final norm, and each decoder slot's ``cross`` attention,
    which has no q/k norms), with the ``mtp`` subtree where the config has
    ``mtp_depth`` (drawn last, so the other leaves do not depend on it).
    On ``device="meta"`` the tree holds shapes only (the sharding rules
    read a full-width model's without allocating it)."""
    check_supported(cfg)
    device = torch.device(device)
    gen = None      # the meta device: the tree's shapes, nothing drawn
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    Dh, dt = cfg.resolved_head_dim, cfg.param_dtype

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def dense(reps, fan_in, fan_out):
        return dense_init(gen, (reps, fan_in, fan_out), fan_in, dt, device)

    params = {"embed": embed_init(gen, cfg.vocab_size, d, dt, device),
              "final_norm": zeros(d), "stacks": []}

    def attn(reps, qk_norm):
        out = {"ln": zeros(reps, d),
               "wq": dense(reps, d, H * Dh),
               "wk": dense(reps, d, Hkv * Dh),
               "wv": dense(reps, d, Hkv * Dh),
               "wo": dense(reps, H * Dh, d)}
        if qk_norm:
            out.update(q_norm=zeros(reps, Dh), k_norm=zeros(reps, Dh))
        if cfg.post_norm:
            out["post_ln"] = zeros(reps, d)
        return out

    def slot(mixer, ffn, reps, cross=False):
        if mixer == MAMBA:
            out = {"mamba": {"ln": zeros(reps, d), **S.init_mamba(
                gen, reps, d, cfg.mamba_expand * d, cfg.mamba_d_state,
                cfg.mamba_d_conv, dt, device)}}
        elif mixer == MLSTM:
            out = {"mlstm": {"ln": zeros(reps, d), **S.init_mlstm(
                gen, reps, d, H, dt, device)}}
        elif mixer == SLSTM:
            out = {"slstm": {"ln": zeros(reps, d), **S.init_slstm(
                gen, reps, d, H, dt, device)}}
        elif mixer == MLA:
            qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
            dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
            dv = cfg.v_head_dim
            out = {"mla": {"ln": zeros(reps, d),
                           "wq_a": dense(reps, d, qr),
                           "q_ln": zeros(reps, qr),
                           "wq_b": dense(reps, qr, H * (dn + dr)),
                           "wkv_a": dense(reps, d, kvr + dr),
                           "kv_ln": zeros(reps, kvr),
                           "wkv_b": dense(reps, kvr, H * (dn + dv)),
                           "wo": dense(reps, H * dv, d)}}
        else:
            out = {"attn": attn(reps, cfg.qk_norm)}
        if cross:
            out["cross"] = attn(reps, qk_norm=False)
        if ffn == DENSE:
            out["ffn"] = {"ln": zeros(reps, d),
                          "wi_gate": dense(reps, d, cfg.d_ff),
                          "wi_up": dense(reps, d, cfg.d_ff),
                          "wo": dense(reps, cfg.d_ff, d)}
            if cfg.post_norm:
                out["ffn"]["post_ln"] = zeros(reps, d)
        elif ffn == MOE:
            out["moe"] = {"ln": zeros(reps, d), **M.init_moe(
                gen, reps, d, cfg.moe_d_ff, cfg.num_experts, _moe_pad(cfg),
                cfg.shared_expert_d_ff, dt, device,
                aux_free=cfg.router_aux_free)}
        return out

    for period, reps in build_stacks(cfg):
        params["stacks"].append([slot(mixer, ffn, reps, cross=cfg.enc_dec)
                                 for mixer, ffn in period])
    if cfg.enc_dec:
        params["encoder"] = {
            "stacks": [[slot(ATTN, DENSE, cfg.num_encoder_layers)]],
            "final_norm": zeros(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(1, d, cfg.vocab_size)[0]
    if cfg.mtp_depth:
        params["mtp"] = {"proj": dense(1, 2 * d, d)[0],
                         "block": [slot(cfg.layer_pattern[0], DENSE, 1)],
                         "ln": zeros(d)}
    return params
