"""Decoder and encoder-decoder LM over the paged KV cache and over the slot
cache (port of the serving modes of the reference ``models/model.py``).

Parameters are nested dicts mirroring the reference pytree: a list of
*stacks*, each a list over the repeating period's slots whose leaves carry a
leading ``[reps, ...]`` axis. ``forward`` loops over stacks and repetitions
in Python where the reference uses ``lax.scan``. Both caches mirror the same
structure: one fused pool ``{"kv_pages": [reps, Hkv, P, 2, ps, D]}`` per slot
(paged), or per slot (slot cache) contiguous rows ``{"k", "v": [reps, B,
Smax, Hkv, D]}`` for attention, the MLA latents ``{"ckv": [reps, B, Smax,
kv_lora_rank], "kr": [reps, B, Smax, qk_rope_head_dim]}``, and the
recurrent state ``{"mamba": {"conv", "ssm"}}`` / ``{"mlstm": {"C", "n",
"m", "conv"}}`` / ``{"slstm": {"c", "n", "h", "m"}}`` with leaves ``[reps,
B, ...]`` for the recurrent mixers; an encoder-decoder's decoder slots
also hold the cross-attention cache ``{"cross_k", "cross_v": [reps, B,
enc_len, Hkv, D]}``. The steps write them **in place** (the reference
donates them).

Modes: "paged_chunk" and "paged_decode" over the paged cache; "chunk",
"decode" and "prefill" (the whole prompt from an empty cache, written at
0) over the slot cache; "encode" (the encoder, no cache); "train" (no
cache: causal attention over the call's own keys, the recurrent mixers
from a fresh state, the MoE aux loss kept), which ``loss_fn`` drives.
Ported:
attention mixers (ATTN, LOCAL_ATTN) on both caches, with the per-head q/k
norm (qwen3), the post-norms and the embedding scale (gemma2); MLA
(deepseek-v3), Mamba, mLSTM and sLSTM mixers on the slot cache; dense,
MoE (masked-dense, or expert-parallel on a mesh) or no FFN; the encoder
and the decoder's cross
attention of an encoder-decoder (seamless-m4t), and the patch embeddings
that replace a prompt's first tokens (internvl2). Every attention over
contiguous keys (a chunk, a prefill, the encoder, cross attention, every
attention of training) runs through ``blockwise_attention``, that is the
chunked-prefill kernel.

Training (``loss_fn``): next-token cross-entropy in sequence blocks, each
under ``torch.utils.checkpoint`` (``_blocked_ce``), plus 0.01 x the MoE
aux loss and deepseek-v3's multi-token-prediction loss (``_mtp_loss``),
as in the reference. The kernels on this path (#5 attention, #6 Mamba, #7
mLSTM) run forward on the card and are differentiated through their
``autograd.Function`` (``kernels/*/ops.py``). ``RunCtx.remat`` wraps one
repetition of a period (the reference's scan body) in a checkpoint.

Sharded training (``RunCtx.mesh`` a training mesh, the parameters this
rank's shards as ``launch/sharding.param_specs`` places them): a leaf
narrower than the config's width is a shard, and the block computes on it
Megatron-style with the collectives of ``kernels/shard_utils.py`` over the
``model`` axis: attention on the rank's heads (``_qkv``; a K/V projection
split inside a head is gathered and the rank's KV heads taken), the
row-parallel ``wo`` and MLP down projection summed, the Mamba mixer on the
rank's ``d_inner`` channels (``models/ssm.py``), the embedding and the
cross-entropy vocab-parallel (``_embed``, ``_block_ce``), the MoE through
``RunCtx.moe`` (expert parallelism, ``models/moe.py``). A leaf of full
width is replicated and computed whole on every rank. Query heads that
split inside a head (or inside a KV group) are gathered over the axis and
attended as whole groups, each rank's ``wo`` rows taking their own
columns of the output (``_qkv``). MLA runs on the rank's heads of
``wq_b``/``wkv_b``/``wo``; the MTP block and the encoder-decoder's encoder
and cross attention run as the decoder's blocks do; patch embeddings
replace the first positions after the vocab-parallel sum.

The slot path on a mesh (``prefill``/``decode_step`` with ``rctx.mesh``,
the cache this rank's shards, ``init_cache(..., mesh=)``): a K/V cache
(and the cross cache) holds the rank's KV heads when they divide the
``model`` axis, else the rank's block of the sequence, as
``launch/sharding.cache_specs`` places them; MLA's latents are always
sharded on the sequence. A prefill writes only the rank's sequence range;
a decode step over a sequence-sharded cache gathers every query head,
attends over the rank's keys as flash partials and merges them with
``shard_utils.combine_partials``. Mamba's state is the rank's channels;
an xLSTM's is the rank's batch rows only.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, DENSE, LOCAL_ATTN, MAMBA, MLA,
                                      MLSTM, MOE, NONE, SLSTM, ModelConfig)
from repro_torch.kernels import shard_utils as su
from repro_torch.kernels.paged_attention.ops import paged_attention_auto
from repro_torch.kernels.paged_prefill_attention.ops import (
    paged_prefill_attention_auto)
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.layers import apply_rope, mlp, rms_norm, softcap


# =============================================================================
# stack structure
# =============================================================================
def build_stacks(cfg: ModelConfig) -> list:
    """Returns [(period_kinds, reps)] covering cfg.num_layers decoder layers."""
    stacks = []
    if cfg.first_k_dense:
        mixer0 = cfg.layer_pattern[0]
        stacks.append((((mixer0, DENSE),), cfg.first_k_dense))
    period = tuple(
        (cfg.layer_pattern[i % len(cfg.layer_pattern)],
         cfg.ffn_pattern[i % len(cfg.ffn_pattern)])
        for i in range(cfg.period)
    )
    stacks.append((period, cfg.num_pattern_reps))
    return stacks


def unsupported_features(cfg: ModelConfig) -> list:
    """Config features this port does not compute (empty = supported)."""
    found = []
    for period, _ in build_stacks(cfg):
        for mixer, ffn in period:
            if mixer not in (ATTN, LOCAL_ATTN, MLA, MAMBA, MLSTM, SLSTM):
                found.append(f"mixer {mixer!r}")
            if ffn not in (DENSE, MOE, NONE):
                found.append(f"ffn {ffn!r}")
    return sorted(set(found))


def check_supported(cfg: ModelConfig) -> None:
    missing = unsupported_features(cfg)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port does not compute "
            f"{', '.join(missing)} yet")


def _moe_pad(cfg: ModelConfig) -> int:
    return M.pad_experts(cfg.num_experts, 16)


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """The reference's ``RunCtx`` fields the port uses: ``moe`` (the MoE
    routing context: masked-dense or expert-parallel), ``remat`` ("none" |
    "dots" | "full") and ``loss_vocab_blocks`` (the loss's sequence blocks)
    for training, and ``mesh``/``shard_axis``: the mesh whose shards this
    rank holds. In sharded serving the paged attention ops run their
    sharded dispatch (KV heads on ``shard_axis`` when they divide it, else
    the sequence-sharded fallback; ``kernels/shard_utils.py``), and each
    rank writes only its own heads' K/V into its shard of the pool; in
    sharded training and the slot path on a mesh the parameters are shards
    and the blocks compute on them, the latter on this rank's cache shards
    (the module docstring; the reference leaves this to GSPMD and
    keeps the field for serving). ``None`` is the exact single-device
    dispatch. The reference's ``block_q``/``block_k``/``mlstm_block``/
    ``unroll_layers`` are XLA tiling controls (the kernels here pick their
    own tiles).

    ``fsdp`` (ZeRO-3; a tree shaped like the parameters, from
    ``launch/sharding.fsdp_dims``) names each leaf's dim that is sliced
    over the data-parallel axes ``dp_axes``: the leaf is gathered over
    them at use (``_gathered_outer``, and per repetition in
    ``_apply_stack``). ``vocab_whole``: the vocab-parallel embedding and
    LM head are gathered whole over the model axis at use, for a wide
    batch whose rows differ between the model axis's ranks."""

    moe: M.MoEContext = dataclasses.field(default_factory=M.MoEContext)
    remat: str = "none"          # none | dots | full
    loss_vocab_blocks: int = 8
    mesh: Any = None
    shard_axis: str = "model"
    fsdp: Any = None
    dp_axes: tuple = ()
    vocab_whole: bool = False


def _tp_of(rctx: Optional[RunCtx], local: int, full: int):
    """The model axis (``shard_utils.Axis``) when a leaf of width ``local``
    against the config's ``full`` is this rank's shard, else None (a
    replicated leaf, computed whole)."""
    if local == full:
        return None
    ax = su.mesh_axis(rctx.mesh if rctx else None,
                      rctx.shard_axis if rctx else "model")
    if ax is None or local * ax.size != full:
        raise ValueError(f"a leaf of width {local} is no shard of {full} "
                         f"on this rank's mesh")
    return ax


def _dots_policy(ctx, op, *args, **kwargs):
    """"dots": keep the outputs of the matrix products (the reference keeps
    its dot_generals), recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(rctx: RunCtx, fn, *args):
    """``fn(*args)`` under the context's rematerialization, when autograd
    records: "full" keeps only the inputs and recomputes the rest in the
    backward (``torch.utils.checkpoint``), "dots" keeps the outputs of the
    matrix products and recomputes the rest (selective checkpointing)."""
    if rctx.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if rctx.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if rctx.remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        return checkpoint(fn, *args, use_reentrant=False, context_fn=(
            functools.partial(create_selective_checkpoint_contexts,
                              _dots_policy)))
    raise ValueError(f"remat {rctx.remat!r}: none, dots or full")


# ---- paged cache -------------------------------------------------------------
class PagedView(NamedTuple):
    """Per-call paged-cache addressing shared by all layers.

    ``block_tables``: [R, n] int32 logical->physical page map per batch row.
    ``write_slots``:  [R*L] flat destination slot (page*page_size + offset)
    for every token in the call, row-major; padding tokens point at the
    reserved trash page."""

    block_tables: torch.Tensor
    write_slots: torch.Tensor


def supports_paged_cache(cfg: ModelConfig) -> bool:
    """Paged KV covers pure-attention decoders (ATTN/LOCAL_ATTN mixers)."""
    return not cfg.enc_dec and set(cfg.layer_pattern) <= {ATTN, LOCAL_ATTN}


PAGED_KV_LAYOUT = "fused-head-interleaved-v1"   # cache/upload versioning tag


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype=None, device=None) -> list:
    """Zeroed fused KV page pools, one ``{"kv_pages": [reps, Hkv, num_pages,
    2, page_size, Dh]}`` per period slot of each stack. ``num_pages``
    includes any trash page the caller reserves."""
    dtype = dtype or cfg.dtype
    Hkv, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    out = []
    for period, reps in build_stacks(cfg):
        slots = []
        for mixer, _ in period:
            if mixer not in (ATTN, LOCAL_ATTN):
                raise ValueError(f"paged cache does not support mixer {mixer!r}")
            slots.append({"kv_pages": torch.zeros(
                (reps, Hkv, num_pages, 2, page_size, Dh), dtype=dtype,
                device=device)})
        out.append(slots)
    return out


# ---- slot cache -------------------------------------------------------------
def _mixer_cache(cfg: ModelConfig, mixer: str, reps: int, B: int,
                 max_len: int, dtype, device) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    if mixer in (ATTN, LOCAL_ATTN):
        Hkv, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
        return {n: torch.zeros((reps, B, max_len, Hkv, Dh), dtype=dtype,
                               device=device) for n in ("k", "v")}
    if mixer == MLA:
        return {n: torch.zeros((reps, B, max_len, w), dtype=dtype,
                               device=device)
                for n, w in (("ckv", cfg.kv_lora_rank),
                             ("kr", cfg.qk_rope_head_dim))}
    if mixer == MAMBA:
        state = S.init_mamba_state(B, cfg.mamba_expand * d,
                                   cfg.mamba_d_state, cfg.mamba_d_conv,
                                   dtype, device)
    elif mixer == MLSTM:
        state = S.init_mlstm_state(B, d, H, dtype, device)
    elif mixer == SLSTM:
        state = S.init_slstm_state(B, d, H, device=device)
    else:
        raise NotImplementedError(f"slot cache of mixer {mixer!r} is not "
                                  f"ported")
    return {mixer: {n: t.expand(reps, *t.shape).clone()
                    for n, t in state.items()}}


def _slot_cache(cfg: ModelConfig, mixer: str, reps: int, B: int,
                max_len: int, dtype, device, enc_len: int) -> dict:
    c = _mixer_cache(cfg, mixer, reps, B, max_len, dtype, device)
    if cfg.enc_dec:     # a decoder slot's cross-attention K/V
        Hkv, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
        c.update({n: torch.zeros((reps, B, enc_len, Hkv, Dh), dtype=dtype,
                                 device=device)
                  for n in ("cross_k", "cross_v")})
    return c


def init_cache(cfg: ModelConfig, B: int, max_len: int, dtype=None,
               device=None, enc_len: int = 0, mesh=None) -> list:
    """The reference's ``init_cache``: per period slot of each stack, zeroed
    contiguous KV rows ``{"k", "v": [reps, B, max_len, Hkv, Dh]}`` for an
    attention mixer, the zeroed latent rows ``{"ckv", "kr"}`` for MLA, or
    the fresh recurrent state (``m = -1e30`` for the
    mLSTM) for a Mamba or xLSTM mixer; one row per engine slot. An
    encoder-decoder's slots also hold zeroed ``{"cross_k", "cross_v":
    [reps, B, enc_len, Hkv, Dh]}``, which its prefill fills.

    With a ``mesh`` (a ``DeviceMesh`` or a ``launch.mesh.MeshShape``) the
    cache is this rank's shards of that whole cache, each leaf at
    ``launch/sharding.local_shape`` under ``cache_specs``, filled with its
    leaf's initial value (the value is the same along every dim). The
    model places a K/V cache whose heads do not divide the ``model`` axis
    on the sequence, and MLA's latents always: ``max_len`` and ``enc_len``
    must then divide it, or this raises."""
    dtype = dtype or cfg.dtype
    if mesh is not None:
        return _sharded_cache(cfg, B, max_len, dtype, device, enc_len, mesh)
    return [[_slot_cache(cfg, mixer, reps, B, max_len, dtype, device, enc_len)
             for mixer, _ in period] for period, reps in build_stacks(cfg)]


def check_cache_layout(cfg: ModelConfig, max_len: int, enc_len: int,
                       mesh) -> None:
    """Raise unless the slot cache's sequence dims divide ``mesh``'s model
    axis where the model places them on it: a K/V cache (and the cross
    cache) whose heads do not divide the axis, and MLA's latents."""
    from repro_torch.launch.sharding import axis_sizes
    M = axis_sizes(mesh).get("model", 1)
    mixers = {m for period, _ in build_stacks(cfg) for m, _ in period}
    kv_seq = M > 1 and bool(cfg.num_kv_heads % M)
    need = {"max_len": max_len if (kv_seq and mixers & {ATTN, LOCAL_ATTN})
            or (M > 1 and MLA in mixers) else 0,
            "enc_len": enc_len if kv_seq and cfg.enc_dec else 0}
    for name, size in need.items():
        if size % M:
            raise ValueError(f"{cfg.name}: the slot cache lies on the "
                             f"sequence on a model axis of {M}: {name} "
                             f"{size} must be a multiple of it")


def _sharded_cache(cfg, B, max_len, dtype, device, enc_len, mesh) -> list:
    from repro_torch.launch import sharding as shd
    from repro_torch.train import tree as T
    check_cache_layout(cfg, max_len, enc_len, mesh)
    whole = init_cache(cfg, B, max_len, dtype, "meta", enc_len)
    mesh = shd.with_data_axis(mesh)
    specs = shd.cache_specs(cfg, whole, mesh)
    fills = T.leaves(init_cache(cfg, 1, 1, dtype, "cpu", min(enc_len, 1)))
    local = [torch.full(shd.local_shape(x.shape, spec, mesh),
                        float(f.reshape(-1)[0]), dtype=x.dtype, device=device)
             for x, spec, f in zip(T.leaves(whole), T.leaves(specs), fills)]
    return T.unflatten(whole, local)


# =============================================================================
# blocks
# =============================================================================
def _maybe_post(cfg: ModelConfig, p, y):
    """gemma2's post-norm of a block's output, where the block has one."""
    return rms_norm(y, p["post_ln"], cfg.norm_eps) \
        if cfg.post_norm and "post_ln" in p else y


class _Heads(NamedTuple):
    """A block's projections on this rank: q [B, S, n, G', D] of the query
    heads ``[h0, h1)`` (kv-major, n KV groups), k/v [B, Sk, Hk, D] of the
    KV heads this rank holds, ``kv`` the slice of k/v's heads that q
    reads, ``cols`` the columns of the output [B, S, (h1 - h0) * D] that
    this rank's ``wo`` rows take, ``tp`` the model axis (None: the block's
    weights are whole)."""

    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    kv: slice
    cols: slice
    tp: Any


def _whole_groups(h0: int, n: int, G: int) -> bool:
    """Whether query heads ``[h0, h0 + n)`` read whole KV groups of ``G``,
    or lie inside one (every head of the rank then reads one KV head)."""
    kv0, kv1 = h0 // G, (h0 + n - 1) // G + 1
    return not (n % (kv1 - kv0) or (n >= G and h0 % G))


def _heads(cfg: ModelConfig, p, x, kv_x=None, rctx=None, *, q_all=False,
           kv_all=False, with_kv=True) -> _Heads:
    """The q, k and v projections of an attention block (queries of ``x``,
    keys and values of ``kv_x``, ``x`` when None) on this rank's heads.

    A ``wq`` narrower than the config's is the rank's columns ``[c0, c0 +
    wl)``. When they are whole query heads that fill whole KV groups (or
    lie inside one), q is the rank's own product. Otherwise (a head split
    inside, or heads that straddle groups) the q projection is gathered
    over the axis and q is the whole groups that cover the columns; the
    output's ``cols`` are then the rank's columns for its ``wo`` rows.
    ``q_all`` gathers every query head (a sequence-sharded decode attends
    them all). K/V are the rank's own heads where its columns of
    ``wk``/``wv`` hold the groups q reads, else the projection gathered
    (``kv_all``: every KV head, for a sequence-sharded cache's writes).
    ``with_kv=False`` projects q alone (k and v None: a step that reads
    its keys from a cache)."""
    B, Sq, _ = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G = H // Hkv
    wl = p["wq"].shape[-1]
    tp = _tp_of(rctx, wl, H * Dh)
    cols = slice(None)
    if tp is None:
        kv_x = x if kv_x is None else kv_x
        h0, h1 = 0, H
        q = (x @ p["wq"]).reshape(B, Sq, H, Dh)
    else:
        x = su.copy_to(x, tp)
        kv_x = x if kv_x is None else su.copy_to(kv_x, tp)
        c0 = tp.index * wl
        if not q_all and wl % Dh == 0 and _whole_groups(c0 // Dh, wl // Dh,
                                                        G):
            h0, h1 = c0 // Dh, (c0 + wl) // Dh
            q = (x @ p["wq"]).reshape(B, Sq, h1 - h0, Dh)
        else:
            h0, h1 = (0, H) if q_all else (
                c0 // Dh // G * G, -(-(-(-(c0 + wl) // Dh)) // G) * G)
            q = su.gather_to_own(x @ p["wq"], 2, tp)[..., h0 * Dh:h1 * Dh]
            q = q.reshape(B, Sq, h1 - h0, Dh)
            cols = slice(c0 - h0 * Dh, c0 + wl - h0 * Dh)
    kv0, kv1 = h0 // G, (h1 - 1) // G + 1
    Sk = kv_x.shape[1]

    def kv_proj(w):
        ktp = _tp_of(rctx, w.shape[-1], Hkv * Dh)
        if ktp is None:      # replicated: every head, on every rank
            return (kv_x @ su.copy_to(w, tp)).reshape(B, Sk, Hkv, Dh), 0
        n = w.shape[-1] // Dh
        k0 = ktp.index * n
        if not kv_all and w.shape[-1] % Dh == 0 and k0 <= kv0 \
                and kv1 <= k0 + n:                # the rank's own KV heads
            return (kv_x @ w).reshape(B, Sk, n, Dh), k0
        y = su.gather_to_own(kv_x @ w, 2, ktp)
        return y.reshape(B, Sk, Hkv, Dh), 0

    q = q.reshape(B, Sq, kv1 - kv0, (h1 - h0) // (kv1 - kv0), Dh)
    if not with_kv:
        return _Heads(q, None, None, slice(kv0, kv1), cols, tp)
    (k, k0), (v, _) = kv_proj(p["wk"]), kv_proj(p["wv"])
    return _Heads(q, k, v, slice(kv0 - k0, kv1 - k0), cols, tp)


def _qkv(cfg: ModelConfig, p, x, positions, rctx=None, *, q_all=False,
         kv_all=False) -> _Heads:
    """:func:`_heads` of a self-attention block, with the per-head q/k
    norm (replicated, applied to the rank's heads) and RoPE."""
    h = _heads(cfg, p, x, rctx=rctx, q_all=q_all, kv_all=kv_all)
    q, k = h.q, h.k
    if cfg.qk_norm:     # per head, before RoPE
        q = rms_norm(q, su.copy_to(p["q_norm"], h.tp), cfg.norm_eps)
        k = rms_norm(k, su.copy_to(p["k_norm"], h.tp), cfg.norm_eps)
    if cfg.use_rope:
        B, Sq, n, G, Dh = q.shape
        q = apply_rope(q.reshape(B, Sq, n * G, Dh), positions,
                       cfg.rope_theta).reshape(q.shape)
        k = apply_rope(k, positions, cfg.rope_theta)
    return h._replace(q=q, k=k)


def _slot_layout(cfg: ModelConfig, rctx, n_kv: int):
    """How a slot-cache leaf of ``n_kv`` heads (0: MLA's latents) lies on
    the model axis (``launch/sharding.cache_specs``' rule): (None, None)
    without a mesh or a model axis, ("heads", axis) when ``n_kv`` divides
    the axis, else ("seq", axis): the rank's block of the sequence."""
    ax = su.mesh_axis(rctx.mesh, rctx.shard_axis) \
        if rctx is not None and rctx.mesh is not None else None
    if ax is None:
        return None, None
    return ("heads" if n_kv and n_kv % ax.size == 0 else "seq"), ax


def _write_seq(cache, new, start, ax, rows=None):
    """Write ``new`` [B, n, ...] at global positions ``start ..`` into this
    rank's block of a sequence-sharded cache [B, S_loc, ...] (the rank
    holds ``[ax.index * S_loc, (ax.index + 1) * S_loc)``), in place: the
    part of the range that falls in the block. ``start`` is an integer, or
    per-row starts [B] of a single token (a ragged decode; ``rows`` limits
    the rows written)."""
    S = cache.shape[1]
    off = ax.index * S
    if torch.is_tensor(start) and start.dim():
        loc = start.to(cache.device).long() - off
        keep = (loc >= 0) & (loc < S)
        if rows is not None:
            keep &= torch.zeros_like(keep).index_fill_(0, rows, True)
        sel = keep.nonzero()[:, 0]
        cache[sel, loc[sel]] = new[sel, 0].to(cache.dtype)
        return cache
    start = int(start)
    lo, hi = max(start, off), min(start + new.shape[1], off + S)
    if lo < hi:
        cache[:, lo - off:hi - off] = new[:, lo - start:hi - start].to(
            cache.dtype)
    return cache


def _lengths_of(lengths, B: int, device) -> torch.Tensor:
    """``lengths`` as an int32 [B] tensor (a lockstep integer broadcast)."""
    if torch.is_tensor(lengths) and lengths.dim():
        return lengths.to(device=device, dtype=torch.int32)
    return torch.full((B,), int(lengths), dtype=torch.int32, device=device)


def _attend_seq_shard(q, k_loc, v_loc, lengths, ax, rctx, *, scale, window,
                      softcap):
    """One query token of every head, q [B, Hkv, G, D], over this rank's
    block of a sequence-sharded cache k_loc/v_loc [B, S_loc, Hkv, D] (key
    positions from ``ax.index * S_loc``), as flash partials merged over the
    axis (``shard_utils.combine_partials``). Returns [B, Hkv * G, Dv]."""
    B, S = k_loc.shape[:2]
    acc, m, l = A.decode_attention_partials(
        q, k_loc, v_loc, _lengths_of(lengths, B, q.device), ax.index * S,
        scale=scale, window=window, softcap=softcap)
    return su.combine_partials(acc, m, l, q.dtype, rctx.mesh,
                               rctx.shard_axis)


def _attn_scale(cfg: ModelConfig) -> float:
    return cfg.attn_scale or 1.0 / math.sqrt(cfg.resolved_head_dim)


def _positions(mode, pos, lengths, Sq, device):
    if mode == "paged_decode" or (mode == "decode" and torch.is_tensor(lengths)
                                  and lengths.dim()):
        return (lengths.long() - 1)[:, None]                 # [B, 1]
    if torch.is_tensor(pos) and pos.dim():                   # [B] offsets
        return pos.long()[:, None] + torch.arange(Sq, device=device)[None, :]
    return (int(pos) + torch.arange(Sq, device=device)[None, :])  # [1, Sq]


def attn_block(cfg, p, x, state, *, mode, pos, lengths, window, paged=None,
               rows=None, rctx=None):
    """Write the call's K/V into the layer's cache ``state`` (in place)
    first, then attend (decode ``lengths`` count the token being written).
    ``rows`` limits a slot decode's writes to the rows really decoding.
    With ``rctx.mesh`` the paged modes write this rank's KV heads into its
    shard of the pool and attend through the sharded dispatch; the slot
    modes write and read this rank's shard of the slot cache
    (``_slot_layout``): its KV heads, or its block of the sequence, which a
    prefill fills from the call's keys of every head and a decode step
    attends as partials of every query head.
    "prefill" attends over the call's own keys (causal, the window) and
    writes them at 0; "train" attends the same way without a cache;
    "encode" attends over them without a mask or a cache. Returns the
    block's output."""
    B, Sq, _ = x.shape
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    layout, ax = (_slot_layout(cfg, rctx, cfg.num_kv_heads)
                  if mode in ("prefill", "chunk", "decode") else (None, None))
    seq = layout == "seq"
    if seq and mode == "chunk":
        raise NotImplementedError("a chunk over a sequence-sharded slot "
                                  "cache is not ported (the slot engine "
                                  "runs without a mesh)")
    h = _qkv(cfg, p, xin, _positions(mode, pos, lengths, Sq, x.device), rctx,
             q_all=seq and mode == "decode", kv_all=seq)
    q, k, v, tp = h.q, h.k[:, :, h.kv], h.v[:, :, h.kv], h.tp
    scale = _attn_scale(cfg)
    cap = cfg.attn_logit_softcap
    if mode in ("paged_chunk", "paged_decode"):
        rctx = rctx or RunCtx()
        mesh, axis, Hkv = rctx.mesh, rctx.shard_axis, cfg.num_kv_heads
        mine = su.local_heads(Hkv, Hkv, mesh, axis)   # q stays whole
        kvp = A.write_pages_fused(state["kv_pages"], k[:, :, mine],
                                  v[:, :, mine], paged.write_slots)
    if mode == "paged_chunk":
        o = paged_prefill_attention_auto(
            q, kvp, paged.block_tables, pos, lengths, scale=scale,
            window=window, softcap=cap, mesh=mesh, axis=axis)
    elif mode == "paged_decode":
        H, Dh = cfg.num_heads, cfg.resolved_head_dim
        o = paged_attention_auto(q[:, 0].reshape(B, H, Dh), kvp,
                                 paged.block_tables, lengths, scale=scale,
                                 window=window, softcap=cap, mesh=mesh,
                                 axis=axis, kv_heads=Hkv)
    elif mode == "encode":
        o = A.blockwise_attention(q, k, v, scale=scale, causal=False,
                                  softcap=cap)
    elif mode == "train":
        o = A.blockwise_attention(q, k, v, scale=scale, causal=True,
                                  window=window, softcap=cap)
    elif mode == "prefill":
        o = A.blockwise_attention(q, k, v, scale=scale, causal=True,
                                  window=window, softcap=cap)
        if seq:
            _write_seq(state["k"], h.k, 0, ax)
            _write_seq(state["v"], h.v, 0, ax)
        else:
            A.update_kv_cache(state["k"], k, 0)
            A.update_kv_cache(state["v"], v, 0)
    elif mode == "chunk":
        A.update_kv_cache(state["k"], k, pos)
        A.update_kv_cache(state["v"], v, pos)
        o = _chunk_attend(cfg, q, state["k"], state["v"], pos, lengths,
                          window)
    elif mode == "decode":
        ragged = torch.is_tensor(lengths) and lengths.dim()
        if seq:
            start = lengths - 1 if ragged else pos
            _write_seq(state["k"], h.k, start, ax, rows)
            _write_seq(state["v"], h.v, start, ax, rows)
            o = _attend_seq_shard(q[:, 0], state["k"], state["v"], lengths,
                                  ax, rctx, scale=scale, window=window,
                                  softcap=cap)
        else:
            if ragged:
                A.update_kv_cache_ragged(state["k"], k, lengths - 1, rows)
                A.update_kv_cache_ragged(state["v"], v, lengths - 1, rows)
            else:
                A.update_kv_cache(state["k"], k, pos)
                A.update_kv_cache(state["v"], v, pos)
            o = A.decode_attention(q[:, 0], state["k"], state["v"], lengths,
                                   scale=scale, window=window, softcap=cap)
    else:
        raise ValueError(mode)
    o = o.reshape(B, Sq, -1)[..., h.cols]     # this rank's wo rows
    return _maybe_post(cfg, p, su.reduce_from(o @ p["wo"], tp))


def _chunk_attend(cfg, q, k_all, v_all, pos, lengths, window, scale=None):
    """A chunk of queries q [B, Sq, Hkv, G, D] at cache offset ``pos`` over
    the whole slot cache k_all [B, Smax, Hkv, D] / v_all [B, Smax, Hkv, Dv]:
    ``blockwise_attention`` causal at ``q_offset = pos``, with the window,
    and a per-row length mask ``lengths`` [B] where given (else ``pos +
    Sq``, which the causal mask already implies), at ``scale`` (the
    config's attention scale when None). Returns [B, Sq, Hkv, G, Dv]."""
    if torch.is_tensor(pos) and pos.dim():
        raise NotImplementedError(
            "_chunk_attend over ragged per-row offsets is not ported (the "
            "slot engine runs one request per chunk dispatch)")
    pos = int(pos)
    if not (torch.is_tensor(lengths) and lengths.dim()):
        lengths = pos + q.shape[1]
    return A.blockwise_attention(
        q, k_all, v_all, scale=_attn_scale(cfg) if scale is None else scale,
        causal=True, window=window, softcap=cfg.attn_logit_softcap,
        q_offset=pos, kv_valid_len=lengths)


def mla_block(cfg, p, x, state, *, mode, pos, lengths, rows=None,
              rctx=None):
    """DeepSeek-v3's multi-head latent attention on the slot cache (the
    reference's ``mla_block`` in modes "chunk", "decode", "prefill" and,
    without a cache, "train"): q through the
    LoRA pair ``wq_a``/``wq_b`` with the q latent normed, one shared
    ``k_rope`` and the normed kv latent ``ckv`` written to the cache
    (``state`` "kr" and "ckv", in place) at ``pos``, or at ``lengths - 1``
    for the ``rows`` of a ragged decode; scale ``1/sqrt(dn + dr)``.

    A chunk expands the latents through ``wkv_b`` (``w_uk`` | ``w_uv`` per
    head) into per-head keys ``[k_nope | kr]`` and values and attends
    through ``_chunk_attend`` (the chunked-prefill kernel, G 1, value width
    ``dv``). The reference expands the whole ``Smax`` buffer; this expands
    only the first ``pos + Sq`` rows, which gives the same result, since
    the causal mask hides every later row. "prefill" expands the call's
    own latents the same way, attends causally over them through
    ``blockwise_attention`` and writes the latents at 0; "train" does the
    same without writing. A decode step
    takes the weight-absorbed path: ``q_nope . w_uk`` against the latents
    (``mla_decode_attention``), then ``. w_uv``.

    On a mesh ``wq_b``'s columns, ``wkv_b``'s heads and ``wo``'s rows are
    the rank's heads' (``wq_a``, ``wkv_a`` and the norms are replicated;
    the latents enter the rank's heads through ``copy_to``), and the
    output is summed over the axis. The latent cache holds the rank's
    block of the sequence: a prefill writes the part of the call that
    falls in it, and a decode step gathers every head's absorbed query,
    attends over the block as partials, merges them
    (``combine_partials``) and expands the rank's heads. Returns the
    block's output."""
    if mode not in ("prefill", "chunk", "decode", "train"):
        raise ValueError(f"MLA runs on the slot cache only (and in "
                         f"training), not in mode {mode!r}")
    B, Sq, _ = x.shape
    dn, dr, dv, kvr = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                       cfg.v_head_dim, cfg.kv_lora_rank)
    H = p["wq_b"].shape[-1] // (dn + dr)       # this rank's heads
    tp = _tp_of(rctx, H, cfg.num_heads)
    _, ax = _slot_layout(cfg, rctx, 0) if mode != "train" else (None, None)
    if ax is not None and mode == "chunk":
        raise NotImplementedError("an MLA chunk over the sequence-sharded "
                                  "latents is not ported (the slot engine "
                                  "runs without a mesh)")
    eps, theta = cfg.norm_eps, cfg.rope_theta
    xin = rms_norm(x, p["ln"], eps)
    positions = _positions(mode, pos, lengths, Sq, x.device)
    scale = 1.0 / math.sqrt(dn + dr)
    qa = su.copy_to(rms_norm(xin @ p["wq_a"], p["q_ln"], eps), tp)
    qf = (qa @ p["wq_b"]).reshape(B, Sq, H, dn + dr)
    q_nope = qf[..., :dn]
    q_rope = apply_rope(qf[..., dn:], positions, theta)
    kv = xin @ p["wkv_a"]
    ckv = rms_norm(kv[..., :kvr], p["kv_ln"], eps)
    k_rope = apply_rope(kv[..., kvr:][:, :, None, :], positions, theta)[:, :, 0]
    ckv_h, k_rope_h = su.copy_to(ckv, tp), su.copy_to(k_rope, tp)
    if mode in ("prefill", "train"):
        kvb = (ckv_h @ p["wkv_b"]).view(B, Sq, H, dn + dv)
        k = torch.cat([kvb[..., :dn], k_rope_h[:, :, None].expand(
            B, Sq, H, dr)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]   # G 1
        o = A.blockwise_attention(q, k, kvb[..., dn:], scale=scale,
                                  causal=True).reshape(B, Sq, H * dv)
        if mode == "prefill" and ax is not None:
            _write_seq(state["ckv"], ckv, 0, ax)
            _write_seq(state["kr"], k_rope, 0, ax)
        elif mode == "prefill":
            A.update_kv_cache(state["ckv"], ckv, 0)
            A.update_kv_cache(state["kr"], k_rope, 0)
    elif mode == "chunk":
        A.update_kv_cache(state["ckv"], ckv, pos)
        A.update_kv_cache(state["kr"], k_rope, pos)
        n = min(int(pos) + Sq, state["ckv"].shape[1])
        kvb = (state["ckv"][:, :n] @ p["wkv_b"]).view(B, n, H, dn + dv)
        k_full = torch.cat([kvb[..., :dn], state["kr"][:, :n, None].expand(
            B, n, H, dr)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]   # G 1
        o = _chunk_attend(cfg, q, k_full, kvb[..., dn:], pos, lengths, 0,
                          scale=scale).reshape(B, Sq, H * dv)
    else:
        ragged = torch.is_tensor(lengths) and lengths.dim()
        if ax is not None:
            start = lengths - 1 if ragged else pos
            _write_seq(state["ckv"], ckv, start, ax, rows)
            _write_seq(state["kr"], k_rope, start, ax, rows)
        elif ragged:
            A.update_kv_cache_ragged(state["ckv"], ckv, lengths - 1, rows)
            A.update_kv_cache_ragged(state["kr"], k_rope, lengths - 1, rows)
        else:
            A.update_kv_cache(state["ckv"], ckv, pos)
            A.update_kv_cache(state["kr"], k_rope, pos)
        wkv_b = p["wkv_b"].reshape(kvr, H, dn + dv)
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wkv_b[..., :dn])
        if ax is None:
            o_lat = A.mla_decode_attention(q_lat, q_rope[:, 0], state["ckv"],
                                           state["kr"], lengths, scale=scale)
        else:       # every head over the rank's block of the sequence
            S_loc = state["ckv"].shape[1]
            acc, m, l = A.mla_decode_partials(
                su.gather_from(q_lat, 1, tp),
                su.gather_from(q_rope[:, 0], 1, tp), state["ckv"],
                state["kr"], _lengths_of(lengths, B, x.device),
                ax.index * S_loc, scale=scale)
            o_lat = su.combine_partials(acc, m, l, q_lat.dtype, rctx.mesh,
                                        rctx.shard_axis)
            h0 = tp.index * H if tp is not None else 0
            o_lat = o_lat[:, h0:h0 + H]
        o = torch.einsum("bhr,rhd->bhd", o_lat, wkv_b[..., dn:]).reshape(
            B, 1, H * dv)
    return su.reduce_from(o @ p["wo"], tp)


RECURRENT = (MAMBA, MLSTM, SLSTM)


def _recurrent_block(cfg, mixer, p, x, state, *, mode, rows=None,
                     rctx=None):
    """A Mamba, mLSTM or sLSTM block on the slot cache: the mixer of the
    normed input from the layer's state, which it updates in place (a
    prefill as a chunk at 0, from the state it is given). With
    ``rows`` (a slot decode) only those batch rows run and change their
    state; the block adds nothing to the other rows. In "train" the mixer
    runs from a fresh state and no cache is read or written. Returns the
    block's output."""
    if mode not in ("prefill", "chunk", "decode", "train"):
        raise ValueError(f"mixer {mixer!r} runs on the slot cache only "
                         f"(and in training), not in mode {mode!r}")
    if mode == "train":
        state = {mixer: None}
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    if rows is not None:
        xin = xin.index_select(0, rows)
    if mixer == MAMBA:
        tp = _tp_of(rctx, p["conv_w"].shape[-1], cfg.mamba_expand * cfg.d_model)
        y, _ = S.mamba_mix(p, xin, state[mixer], rows=rows, tp=tp)   # the
        # rank's channels of the state, on a mesh
    else:
        mix = S.mlstm_mix if mixer == MLSTM else S.slstm_mix
        y, _ = mix(p, xin, state[mixer], cfg.num_heads, rows=rows)
    if rows is None:
        return y
    return torch.zeros_like(x).index_copy_(0, rows, y)


def cross_block(cfg, p, x, enc_out, state, *, mode, rctx=None):
    """An encoder-decoder's cross attention: queries of the decoder's normed
    ``x`` (no RoPE) over every encoder position, without a mask. At
    "prefill" the keys and values come from ``enc_out`` and are written to
    the slot's ``cross_k``/``cross_v`` cache (cast to its dtype) while the
    block attends with the uncast ones, as the reference does; "train"
    takes them from ``enc_out`` without a cache; a decode or chunk step
    reads the cache. On a mesh the block runs on the rank's heads
    (``_heads``: ``wq``/``wk``/``wv`` columns, ``wo`` rows, the output
    summed), and the cross cache is placed as the self-attention cache is
    (``_slot_layout``): the rank's KV heads, or its block of the encoder
    positions, which a decode step attends as partials of every query
    head. Returns the block's output."""
    B, Sq, _ = x.shape
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    layout, ax = (_slot_layout(cfg, rctx, cfg.num_kv_heads)
                  if mode in ("prefill", "chunk", "decode") else (None, None))
    seq = layout == "seq"
    fresh = mode in ("prefill", "train")
    h = _heads(cfg, p, xin, enc_out if fresh else None, rctx,
               q_all=seq and not fresh, kv_all=seq, with_kv=fresh)
    q, tp = h.q, h.tp
    scale = _attn_scale(cfg)
    if fresh:
        k, v = h.k[:, :, h.kv], h.v[:, :, h.kv]
    if mode == "prefill":
        have = h.k if seq else k
        want = (have.shape[0], have.shape[1] // (ax.size if seq else 1),
                *have.shape[2:])
        if tuple(state["cross_k"].shape) != want:
            raise ValueError(
                f"the cross cache holds {tuple(state['cross_k'].shape)}, the "
                f"encoder gave {tuple(have.shape)}: build it with "
                f"init_cache(..., enc_len={have.shape[1]})")
        if seq:
            _write_seq(state["cross_k"], h.k, 0, ax)
            _write_seq(state["cross_v"], h.v, 0, ax)
        else:
            state["cross_k"].copy_(k)
            state["cross_v"].copy_(v)
    elif mode != "train":
        k, v = state["cross_k"], state["cross_v"]
    if seq and not fresh:
        if Sq != 1:
            raise NotImplementedError("a chunk over a sequence-sharded "
                                      "cross cache is not ported")
        S_loc = k.shape[1]
        o = _attend_seq_shard(q[:, 0], k, v, S_loc * ax.size, ax, rctx,
                              scale=scale, window=0, softcap=0.0)
    else:
        o = A.blockwise_attention(q, k, v, scale=scale, causal=False)
    o = o.reshape(B, Sq, -1)[..., h.cols]
    return su.reduce_from(o @ p["wo"], tp)


def _ffn_apply(cfg, slot, x, rctx=None):
    """The slot's channel mixer on the normed input: the dense MLP
    (post-normed where the config says so; on this rank's columns/rows
    where its weights are shards) or the MoE block under ``rctx.moe``.
    Returns (y, aux): the MoE load-balance loss, a training term (the
    number 0 for the MLP, so that a dense model's forward adds no kernel
    for it)."""
    if "moe" in slot:
        p = slot["moe"]
        return M.moe_ffn(p, rms_norm(x, p["ln"], cfg.norm_eps),
                         num_real=cfg.num_experts,
                         top_k=cfg.num_experts_per_tok,
                         activation=cfg.activation,
                         aux_free=cfg.router_aux_free,
                         ctx=rctx.moe if rctx else M.MoEContext(),
                         shared_d_ff=cfg.shared_expert_d_ff)
    p = slot["ffn"]
    tp = _tp_of(rctx, p["wi_gate"].shape[-1], cfg.d_ff)
    y = _maybe_post(cfg, p, mlp(p, rms_norm(x, p["ln"], cfg.norm_eps),
                                cfg.activation, tp))
    return y, 0.0


def _reps(tree, reps: int) -> list:
    """The ``reps`` repetitions of a tree of ``[reps, ...]`` leaves, as
    views (``torch.unbind`` of each leaf): a cache's writes land in the
    cache, and a parameter's gradient is one stack of the repetitions'
    gradients (indexing each repetition apart would add each into a
    full-size zero tensor: O(reps^2) traffic a training step)."""
    if isinstance(tree, dict):
        per = {k: _reps(v, reps) for k, v in tree.items()}
        return [{k: v[r] for k, v in per.items()} for r in range(reps)]
    return list(torch.unbind(tree, 0))


# ---- ZeRO-3: parameters gathered at use ----------------------------------------
def _dp_of(rctx: Optional[RunCtx]):
    """The data-parallel axis that FSDP slices lie on, or None."""
    if rctx is None or rctx.fsdp is None:
        return None
    return su.mesh_axis(rctx.mesh, rctx.dp_axes)


def _dims_at(rctx: Optional[RunCtx], *path):
    """The part of ``rctx.fsdp`` at ``path`` (None without FSDP)."""
    d = rctx.fsdp if rctx is not None else None
    for k in path:
        if d is None:
            return None
        d = d[k]
    return d


def _gather(x, dim, ax):
    """Leaf ``x`` whole along its FSDP ``dim`` over ``ax``: all-gather
    forward, reduce-scatter backward (each data-parallel rank's gradient
    of the gathered weight comes from its own rows, so the ranks' parts
    are summed into each one's slice)."""
    return x if dim is None or ax is None else su.gather_to_own(x, dim, ax)


def _map_pair(fn, p, d):
    """``fn(leaf, dim) -> (leaf', dim')`` over a dict tree ``p`` and its
    dims ``d`` (None: none for any leaf); returns the two new trees."""
    if isinstance(p, dict):
        out = {k: _map_pair(fn, v, None if d is None else d[k])
               for k, v in p.items()}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    return fn(p, d)


def _gathered_outer(cfg, params, rctx: Optional[RunCtx]):
    """(params, rctx) with the leaves outside the stacks (the embedding,
    the LM head, the final norms, the MTP module's projection and norm)
    gathered whole over the data-parallel axes where ``rctx.fsdp`` slices
    them, and over the model axis where ``rctx.vocab_whole`` asks for the
    embedding and LM head whole; the returned context's dims for them are
    None (a second call gathers nothing). The stacks stay sliced: they are
    gathered a repetition at a time (:func:`_apply_stack`)."""
    if rctx is None or (rctx.fsdp is None and not rctx.vocab_whole):
        return params, rctx
    ax = _dp_of(rctx)
    params, dims = _map_pair(
        lambda p, d: (p, d) if isinstance(p, list)     # a stack
        else (_gather(p, d, ax), None), params, rctx.fsdp)
    if rctx.vocab_whole:
        params = dict(params)
        for k, dim in (("embed", 0), ("lm_head", 1)):
            if k in params:
                w = params[k]
                tp = _tp_of(rctx, w.shape[dim], cfg.vocab_size)
                params[k] = su.gather_to_own(w, dim, tp) if tp else w
    return params, dataclasses.replace(
        rctx, fsdp=dims if rctx.fsdp is not None else None,
        vocab_whole=False)


def _gathered_stack(stack_params, dims, ax):
    """A stack's slots with the leaves that FSDP slices along their
    repetitions gathered whole (a rank then holds fewer repetitions than
    the stack has), and the per-repetition dims of the others (the leaf's
    dim less the stack's)."""
    def one(p, d):
        if d == 0:
            return _gather(p, 0, ax), None
        return p, None if d is None else d - 1

    pairs = [_map_pair(one, p, d) for p, d in zip(stack_params, dims)]
    return [p for p, _ in pairs], [d for _, d in pairs]


def _gathered_slot(slot, dims, ax):
    """One repetition's slot with every FSDP-sliced leaf gathered."""
    if isinstance(slot, dict):
        return {k: _gathered_slot(v, dims[k], ax) for k, v in slot.items()}
    return _gather(slot, dims, ax)


def _embed(cfg, params, tokens, extra_embeds=None, rctx=None):
    """Token embeddings (scaled by sqrt(d) where the config says so); with
    ``extra_embeds`` [B, P, d] on a config with patch tokens, those replace
    the first P positions (internvl2's image patches). An embedding of
    fewer rows than the vocabulary is this rank's block of it
    (vocab-parallel): tokens outside the block look up zeros, and the
    lookups are summed over the model axis. An id past the vocabulary
    reads its last row, as the reference's gather clamps it."""
    emb = params["embed"]
    tp = _tp_of(rctx, emb.shape[0], cfg.vocab_size)
    ids = tokens.long().clamp(max=cfg.vocab_size - 1)
    if tp is None:
        x = emb[ids]
    else:
        V = emb.shape[0]
        t = ids - tp.index * V
        own = (t >= 0) & (t < V)
        x = su.reduce_from(emb[t.clamp(0, V - 1)]
                           * own[..., None].to(emb.dtype), tp)
    if cfg.embed_scale:     # sqrt(d) rounded to the embedding's dtype first
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if extra_embeds is not None and cfg.num_patch_tokens:
        P = extra_embeds.shape[1]
        x = torch.cat([extra_embeds.to(x.dtype), x[:, P:]], dim=1)
    return x


def _apply_slot(cfg, slot, mixer, x, state, enc_out, *, mode, pos,
                lengths, paged, rows, rctx=None):
    """One period slot: its mixer, an encoder-decoder's cross attention,
    then its FFN. Returns (x, the FFN's aux loss)."""
    if mixer in RECURRENT:
        x = x + _recurrent_block(cfg, mixer, slot[mixer], x, state,
                                 mode=mode, rows=rows, rctx=rctx)
    elif mixer == MLA:
        x = x + mla_block(cfg, slot["mla"], x, state, mode=mode, pos=pos,
                          lengths=lengths, rows=rows, rctx=rctx)
    else:
        window = cfg.sliding_window if mixer == LOCAL_ATTN else 0
        x = x + attn_block(cfg, slot["attn"], x, state, mode=mode, pos=pos,
                           lengths=lengths, window=window, paged=paged,
                           rows=rows, rctx=rctx)
    if "cross" in slot and (enc_out is not None
                            or mode in ("decode", "chunk")):
        x = x + cross_block(cfg, slot["cross"], x, enc_out, state, mode=mode,
                            rctx=rctx)
    if "ffn" not in slot and "moe" not in slot:   # xLSTM blocks have none
        return x, 0.0
    y, aux = _ffn_apply(cfg, slot, x, rctx)
    return x + y, aux


def _apply_stack(cfg, stack_params, period, reps, x, cache, enc_out, *,
                 mode, pos, lengths, paged=None, rows=None, rctx=None,
                 dims=None):
    """The stack's repetitions in order (the reference's ``lax.scan``), one
    repetition of the period under ``rctx``'s rematerialization (the
    reference's scan body). ``cache`` is None for the encoder and in
    training. ``dims``: the stack's part of ``rctx.fsdp``; each
    repetition's sliced leaves are gathered inside the rematerialized
    body, so that under remat "full" the backward gathers them again
    instead of keeping whole weights. Returns (x, the summed aux loss:
    summed in "train" only, the number 0 in serving, which adds no kernel
    for it)."""
    rctx = rctx or RunCtx()
    ax = _dp_of(rctx) if dims is not None else None
    if ax is not None:
        stack_params, dims = _gathered_stack(stack_params, dims, ax)

    slots = [_reps(p, reps) for p in stack_params]
    states = [_reps(c, reps) for c in cache] if cache is not None else None

    def body(r, x, aux):
        for j, (mixer, _) in enumerate(period):
            slot = slots[j][r] if ax is None else _gathered_slot(
                slots[j][r], dims[j], ax)
            x, a = _apply_slot(cfg, slot, mixer, x,
                               None if states is None else states[j][r],
                               enc_out, mode=mode, pos=pos, lengths=lengths,
                               paged=paged, rows=rows, rctx=rctx)
            if mode == "train":
                aux = aux + a
        return x, aux

    aux = 0.0
    for r in range(reps):
        x, aux = _remat(rctx, functools.partial(body, r), x, aux)
    return x, aux


def _run_encoder(cfg, params, enc_embeds, rctx=None):
    """The encoder stack over ``enc_embeds`` [B, S_enc, d] (non-causal,
    RoPE at positions 0 .. S_enc-1 where the config uses it) and its own
    final norm. The frames are cast to the parameters' dtype (PyTorch does
    not promote a product of two dtypes as JAX does)."""
    params, rctx = _gathered_outer(cfg, params, rctx)
    enc = params["encoder"]
    x = enc_embeds.to(enc["final_norm"].dtype)
    x, _ = _apply_stack(cfg, enc["stacks"][0], ((ATTN, DENSE),),
                        cfg.num_encoder_layers, x, None, None, mode="encode",
                        pos=0, lengths=None, rctx=rctx,
                        dims=_dims_at(rctx, "encoder", "stacks", 0))
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def forward(cfg: ModelConfig, params, tokens, *, mode: str, cache=None,
            pos=None, lengths=None,
            paged: Optional[PagedView] = None, rows=None, extra_embeds=None,
            enc_embeds=None, rctx: Optional[RunCtx] = None):
    """Forward over the paged cache (``mode`` "paged_chunk" or
    "paged_decode"), the slot cache ("prefill", "chunk" or "decode"), or no
    cache ("train", under ``rctx``). ``rows`` limits a slot decode's cache
    and state writes to those rows. ``extra_embeds`` replace the first
    prompt positions' embeddings; ``enc_embeds`` run an encoder-decoder's
    encoder first, whose output the decoder's cross attention reads.
    Returns (final-normed hidden [B, S, d], cache updated in place), or in
    "train" (hidden, the MoE layers' summed aux loss: an fp32 scalar
    tensor, or the number 0 without MoE layers). Under ``rctx.fsdp`` the
    parameters are this rank's slices, gathered at use."""
    check_supported(cfg)
    params, rctx = _gathered_outer(cfg, params, rctx)
    train = mode == "train"
    enc_out = None
    if cfg.enc_dec and enc_embeds is not None:
        enc_out = _run_encoder(cfg, params, enc_embeds, rctx)
    x = _embed(cfg, params, tokens, extra_embeds, rctx)
    aux = 0.0
    for i, (period, reps) in enumerate(build_stacks(cfg)):
        x, a = _apply_stack(cfg, params["stacks"][i], period, reps, x,
                            None if train else cache[i], enc_out, mode=mode,
                            pos=pos, lengths=lengths, paged=paged, rows=rows,
                            rctx=rctx, dims=_dims_at(rctx, "stacks", i))
        if train:
            aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x, aux) if train else (x, cache)


# ---- sampling ---------------------------------------------------------------
def _head(cfg, params, x, rctx=None):
    """The logits of ``x``; a vocab-parallel head's blocks are gathered
    over the model axis (every rank gets the whole vocabulary)."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    tp = _tp_of(rctx, w.shape[-1], cfg.vocab_size)
    logits = softcap(su.copy_to(x, tp) @ w, cfg.final_logit_softcap)
    return su.gather_from(logits, logits.dim() - 1, tp)


def _greedy_sample(cfg: ModelConfig, params, hidden) -> torch.Tensor:
    """Greedy sampling fused over the LM head on the device: [..., d] ->
    int32 token ids [...]; the engine never reads logits back."""
    return torch.argmax(_head(cfg, params, hidden), dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Sampling:
    """On-device sampling spec for the paged steps. ``temperature <= 0`` is
    exact greedy argmax. Otherwise each dispatch draws Gumbel noise from a
    ``torch.Generator`` seeded from ``(seed, nonce)``: the engine passes a
    per-dispatch nonce, so a run is reproducible for a fixed seed (the
    stream differs from the reference's, whose generator is JAX's)."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def _sample_tokens(cfg: ModelConfig, params, hidden,
                   sampling: Optional[Sampling], nonce) -> torch.Tensor:
    """LM head + token selection on the device: ``hidden`` [..., d] ->
    int32 token ids [...]. Temperature / top-k sampling uses the Gumbel-max
    trick with noise independent per row and position."""
    if sampling is None or sampling.greedy or nonce is None:
        return _greedy_sample(cfg, params, hidden)
    logits = _head(cfg, params, hidden).float() / sampling.temperature
    if 0 < sampling.top_k < logits.shape[-1]:
        kth = torch.topk(logits, sampling.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits,
                             torch.full_like(logits, torch.finfo(logits.dtype).min))
    gen = torch.Generator(device=logits.device)
    gen.manual_seed((int(sampling.seed) << 32) ^ int(nonce))
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


# ---- training loss ----------------------------------------------------------
def loss_fn(cfg: ModelConfig, params, batch: dict, rctx: RunCtx):
    """Next-token cross-entropy (+ 0.01 x the MoE aux loss + 0.3 x the MTP
    loss where the params carry ``mtp``), as the reference's ``loss_fn``.
    ``batch``: "tokens" [B, S] (+ "extra_embeds" / "enc_embeds"). The
    labels are the tokens rolled by one, the last position masked."""
    tokens = batch["tokens"]
    params, rctx = _gathered_outer(cfg, params, rctx)
    x, aux = forward(cfg, params, tokens, mode="train", pos=0, rctx=rctx,
                     extra_embeds=batch.get("extra_embeds"),
                     enc_embeds=batch.get("enc_embeds"))
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(labels.shape, dtype=torch.float32, device=x.device)
    mask[:, -1] = 0.0
    loss = _blocked_ce(cfg, params, x, labels, mask, rctx)
    if cfg.mtp_depth and "mtp" in params:
        loss = loss + 0.3 * _mtp_loss(cfg, params, x, tokens, rctx)
    return loss + 0.01 * aux


def _block_ce(cap, tp, xb, lb, mb, w):
    """One block's summed cross-entropy. With ``tp`` the head ``w`` is this
    rank's vocabulary block: the log-sum-exp from a MAX and a SUM over the
    model axis, the gold logit from the rank that holds it."""
    if tp is None:
        logits = softcap(xb @ w, cap).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lb[..., None].long())[..., 0]
        return torch.sum((lse - gold) * mb)
    logits = softcap(su.copy_to(xb, tp) @ w, cap).float()      # [B, s, V/M]
    V = logits.shape[-1]
    m = su.max_over(logits.amax(dim=-1), tp)
    se = su.reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1), tp)
    lse = m + torch.log(se)
    t = lb.long() - tp.index * V
    own = (t >= 0) & (t < V)
    gold = torch.gather(logits, -1, t.clamp(0, V - 1)[..., None])[..., 0]
    gold = su.reduce_from(torch.where(own, gold, torch.zeros_like(gold)), tp)
    return torch.sum((lse - gold) * mb)


def _blocked_ce(cfg, params, x, labels, mask, rctx):
    """Cross-entropy in ``nb`` blocks of the sequence (``nb =
    min(loss_vocab_blocks, S)``, reduced until it divides S), each under
    ``torch.utils.checkpoint``, so the fp32 logits [B, S, V] never exist
    whole (2.1 GB for llama3.2-3b at B 2, S 2048): a block's are recomputed
    in the backward. A vocab-parallel head keeps only the rank's ``V/M``
    columns of each block's logits."""
    B, S, _ = x.shape
    nb = min(rctx.loss_vocab_blocks, S)
    while S % nb:
        nb -= 1
    xs = x.reshape(B, nb, S // nb, -1)
    ls = labels.reshape(B, nb, S // nb)
    ms = mask.reshape(B, nb, S // nb)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    ce = functools.partial(_block_ce, cfg.final_logit_softcap,
                           _tp_of(rctx, w.shape[-1], cfg.vocab_size))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nb):
        args = (xs[:, i], ls[:, i], ms[:, i], w)
        total = total + (checkpoint(ce, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else ce(*args))
    return total / torch.clamp(torch.sum(mask), min=1.0)


def _mtp_loss(cfg, params, hidden, tokens, rctx):
    """DeepSeek-v3's multi-token prediction: one extra block predicting
    token t+2 from the final hidden state and the embedding of t+1 (labels
    rolled by two, the last two positions masked)."""
    mtp = params["mtp"]
    emb_next = _embed(cfg, params, torch.roll(tokens, -1, dims=1),
                      rctx=rctx)
    h = torch.cat([rms_norm(hidden, mtp["ln"], cfg.norm_eps), emb_next],
                  dim=-1) @ mtp["proj"]
    h, _ = _apply_stack(cfg, mtp["block"], ((cfg.layer_pattern[0], DENSE),),
                        1, h, None, None, mode="train", pos=0, lengths=None,
                        rctx=rctx, dims=_dims_at(rctx, "mtp", "block"))
    labels2 = torch.roll(tokens, -2, dims=1)
    mask = torch.ones(labels2.shape, dtype=torch.float32, device=h.device)
    mask[:, -2:] = 0.0
    return _blocked_ce(cfg, params, h, labels2, mask, rctx)


# ---- user-facing steps ------------------------------------------------------
def paged_chunk_step(cfg: ModelConfig, params, tokens, cache, row_pos, *,
                     row_lens, block_tables, write_slots, logits_at,
                     sampling: Optional[Sampling] = None, nonce=None,
                     rctx: Optional[RunCtx] = None):
    """Fused ragged chunked-prefill step over the paged cache: ``tokens``
    [R, L] holds each request's (bucket-padded) chunk, ``row_pos`` [R] its
    cache offset, ``row_lens`` [R] its post-chunk length, ``logits_at`` [R]
    the index of its last real token. ``rctx`` carries the serving mesh
    (``cache`` is then this rank's shard). Returns (token_ids [R] int32,
    cache)."""
    x, cache = forward(cfg, params, tokens, cache=cache, mode="paged_chunk",
                       pos=row_pos, lengths=row_lens,
                       paged=PagedView(block_tables, write_slots), rctx=rctx)
    rows = torch.arange(x.shape[0], device=x.device)
    sel = x[rows, logits_at.long()]
    return _sample_tokens(cfg, params, sel, sampling, nonce), cache


def paged_decode_step(cfg: ModelConfig, params, tokens, cache, *, lengths,
                      block_tables, write_slots,
                      sampling: Optional[Sampling] = None, nonce=None,
                      rctx: Optional[RunCtx] = None):
    """One decode step for a ragged row batch over the paged cache.
    ``lengths`` [R] counts each row's tokens *including* the one being
    written. Returns (token_ids [R] int32, cache)."""
    x, cache = forward(cfg, params, tokens, cache=cache, mode="paged_decode",
                       lengths=lengths,
                       paged=PagedView(block_tables, write_slots), rctx=rctx)
    return _sample_tokens(cfg, params, x[:, -1], sampling, nonce), cache


def paged_spec_step(cfg: ModelConfig, params, tokens, cache, row_pos, *,
                    row_lens, block_tables, write_slots,
                    sampling: Optional[Sampling] = None, nonce=None,
                    rctx: Optional[RunCtx] = None):
    """Speculative **verify** step through the ragged paged-prefill path.

    ``tokens`` [R, S] holds each row's pending token followed by its draft
    candidates (bucket-padded past ``n_i = row_lens_i - row_pos_i``).
    ``out[:, j]`` is the model's choice given the context through input
    position ``j``; draft ``tokens[:, j+1]`` is accepted iff every earlier
    draft matched. Returns ``(payload int32 [R * (S+1)], cache)``: per row
    ``[accepted, out_0 .. out_{S-1}]``."""
    S = tokens.shape[1]
    x, cache = forward(cfg, params, tokens, cache=cache, mode="paged_chunk",
                       pos=row_pos, lengths=row_lens,
                       paged=PagedView(block_tables, write_slots), rctx=rctx)
    out = _sample_tokens(cfg, params, x, sampling, nonce)          # [R, S]
    n_real = (row_lens.long() - row_pos.long())[:, None]
    jidx = torch.arange(1, S, device=x.device)[None, :]
    matches = (tokens[:, 1:] == out[:, :-1]) & (jidx < n_real)
    accepted = torch.cumprod(matches.to(torch.int32), dim=1).sum(dim=1)
    payload = torch.cat([accepted[:, None].to(torch.int32), out], dim=1)
    return payload.reshape(-1).to(torch.int32), cache


def prefill(cfg: ModelConfig, params, tokens, cache, *, extra_embeds=None,
            enc_embeds=None, rctx: Optional[RunCtx] = None):
    """Full prefill of ``tokens`` [B, S] from an empty slot cache (written
    at 0), with an encoder-decoder's ``enc_embeds`` [B, enc_len, d] (the
    cache built with ``enc_len``) and internvl2's ``extra_embeds``. With
    ``rctx.mesh`` the parameters are this rank's shards, the cache its
    shards (``init_cache(..., mesh=)``) and the batch its data-parallel
    rows. Returns (the last position's logits [B, V], cache)."""
    params, rctx = _gathered_outer(cfg, params, rctx)
    x, cache = forward(cfg, params, tokens, cache=cache, mode="prefill",
                       pos=0, extra_embeds=extra_embeds,
                       enc_embeds=enc_embeds, rctx=rctx)
    return _head(cfg, params, x[:, -1], rctx), cache


def decode_step(cfg: ModelConfig, params, tokens, cache, pos, *,
                lengths=None, write_rows=None,
                rctx: Optional[RunCtx] = None):
    """One decode step over the slot cache. ``tokens`` [B, 1]; ``pos`` a
    lockstep offset, or ``lengths`` [B] each row's length *including* the
    token being written. ``write_rows`` limits the cache writes to those
    rows (the slot engine's decoding rows; every row when None): the KV of
    the other rows and their recurrent state stay bit-identical, and a
    recurrent block runs only the written rows. An encoder-decoder's cross
    attention reads the cross cache that its prefill wrote. ``rctx`` as
    :func:`prefill`'s. Returns (logits [B, V], cache)."""
    if lengths is None:
        lengths = pos + 1
    params, rctx = _gathered_outer(cfg, params, rctx)
    x, cache = forward(cfg, params, tokens, cache=cache, mode="decode",
                       pos=pos, lengths=lengths, rows=write_rows, rctx=rctx)
    return _head(cfg, params, x[:, -1], rctx), cache


def chunk_prefill_step(cfg: ModelConfig, params, tokens, cache, pos, *,
                       lengths=None, logits_at=-1):
    """Chunked-prefill step over the slot cache at offset ``pos`` (an
    integer): ``tokens`` [B, Sq] are written at ``pos .. pos+Sq-1`` and
    attend causally. ``logits_at`` is the chunk position whose logits to
    return (a bucket-padded chunk points at its last real token). Returns
    (logits [B, V], cache)."""
    x, cache = forward(cfg, params, tokens, cache=cache, mode="chunk",
                       pos=pos, lengths=lengths)
    return _head(cfg, params, x[:, logits_at]), cache
