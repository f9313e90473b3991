"""Rank bodies of ``tests/test_torch_slot_sharded.py``: the port's slot
path (``prefill`` and greedy-fed ``decode_step``s) on a mesh, and the
inputs both sides share. Imports numpy at the top and torch and the port
inside the bodies (never JAX)."""
from __future__ import annotations

import dataclasses
import pickle
import zlib

import numpy as np

import _sharded_train_ranks as W

B, PROMPT, STEPS, MAX_LEN, ENC_LEN = 2, 20, 8, 32, 8


def inputs(case, cfg):
    """(prompt tokens [B, PROMPT] int32, the prefill's modality inputs:
    patch embeddings [B, P, d] and encoder frames [B, ENC_LEN, d] where the
    config has them), from the case's name."""
    rng = np.random.default_rng(zlib.crc32(case["name"].encode()))
    toks = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    extra = {}
    if cfg.num_patch_tokens:
        extra["extra_embeds"] = (rng.normal(size=(
            B, cfg.num_patch_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.enc_dec:
        extra["enc_embeds"] = (rng.normal(size=(
            B, ENC_LEN, cfg.d_model)) * 0.02).astype(np.float32)
    return toks, extra


def decode_args(i):
    """Step i's position: a lockstep offset on even steps, per-row lengths
    (the ragged write) on odd ones. Returns (pos, lengths or None)."""
    pos = PROMPT + i
    return pos, (np.full((B,), pos + 1, np.int32) if i % 2 else None)


def slot_case(case, params_np):
    """The case on this rank: the logits of its batch rows after the
    prefill and after each decode step, the greedy tokens, and whether
    every cache leaf has ``cache_specs``' local shape. A case with
    ``"fsdp"`` holds the parameters at ``param_specs(..., fsdp=True)``'s
    slices (ZeRO-3), gathered at use."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import shard_utils as su
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.launch.steps import make_rctx
    from repro_torch.models import model as TM
    from repro_torch.params import from_jax_numpy
    from repro_torch.train import tree as T
    cfg = W.case_config(case, get_config)
    mesh = make_train_mesh(case["mesh"], device_type="cpu")
    fsdp = case.get("fsdp", False)
    rctx = make_rctx(cfg, mesh, train=False, seq_len=MAX_LEN, fsdp=fsdp)
    if cfg.num_experts:
        # a capacity that drops no token (cap >= T * top_k): the
        # single-device reference routes every token densely
        rctx = dataclasses.replace(rctx, moe=dataclasses.replace(
            rctx.moe, capacity_factor=float(TM._moe_pad(cfg))))
    full = from_jax_numpy(cfg, params_np)
    params = shd.shard_tree(full, shd.param_specs(cfg, full, mesh,
                                                  fsdp=fsdp), mesh)
    enc_len = ENC_LEN if cfg.enc_dec else 0
    cache = TM.init_cache(cfg, B, MAX_LEN, enc_len=enc_len, mesh=mesh)
    whole = TM.init_cache(cfg, B, MAX_LEN, device="meta", enc_len=enc_len)
    rule_mesh = shd.with_data_axis(mesh)
    specs = shd.cache_specs(cfg, whole, rule_mesh)
    shapes_ok = all(
        tuple(x.shape) == shd.local_shape(w.shape, s, rule_mesh)
        for x, w, s in zip(T.leaves(cache), T.leaves(whole), T.leaves(specs)))
    rows = W._rows(su.mesh_axis(mesh, ("pod", "data")), B)
    toks, extra = inputs(case, cfg)
    extra = {k: torch.from_numpy(np.ascontiguousarray(a[rows]))
             for k, a in extra.items()}
    with torch.no_grad():
        logits, cache = TM.prefill(cfg, params, torch.from_numpy(
            np.ascontiguousarray(toks[rows])), cache, rctx=rctx, **extra)
        out = [logits.numpy().copy()]
        for i in range(STEPS):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            pos, lengths = decode_args(i)
            kw = {} if lengths is None else {
                "lengths": torch.from_numpy(lengths[rows].copy())}
            logits, cache = TM.decode_step(cfg, params, tok, cache, pos,
                                           rctx=rctx, **kw)
            out.append(logits.numpy().copy())
    return {"rows": (rows.start, rows.stop), "logits": np.stack(out),
            "shapes_ok": shapes_ok,
            "cache_leaves": len(T.leaves(cache))}


def cases(rank, world, cases, params_path):
    """Every case on this rank (``spawn_world``'s body)."""
    with open(params_path, "rb") as f:
        params = pickle.load(f)
    return {c["name"]: slot_case(c, params[W.model_key(c)]) for c in cases}
