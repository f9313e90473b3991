"""Roofline accounting by two-point layer extrapolation (port of the
reference ``analysis/extrapolate.py``).

The layer stack is homogeneous (one repeating period per stack; dense
prefixes and embed/head/loss/optimizer are rep-independent "outer" work),
so per-device cost is affine in the rep count R:

    cost(R) = outer + R * body

Two traced probes at R=1 and R=2 recover both terms:

    body = cost(2) - cost(1);     cost(R) = cost(1) + (R - 1) * body

The reference needs it because XLA counts a loop body once and unrolling
61 layers does not compile on a CPU; the port traces every repetition
anyway (``analysis/roofline.trace``), so here the extrapolation is a
cheaper estimate of the full trace (two shallow traces instead of one
deep one), exact for flops, bytes and collective bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.analysis import roofline as rl
from repro_torch.configs import get_config


def _probe_fsdp(cfg, mesh, fsdp: bool):
    """The probes' ZeRO-3 placement: the full model's (``fsdp_dims``), so
    that a probe's stacked leaf is not sliced along a repetition dim that
    the full model's is not (a leaf whose only free dim is its stack of 2
    would be at R = 2, and not at R = 1 or at an odd R). A leaf that the
    full model slices along its repetitions is left whole in both probes
    (R = 1 cannot be sliced): its one gather of the whole leaf a step is
    then missing from the estimate. False without ``fsdp``."""
    if not fsdp:
        return False
    from repro_torch.launch.sharding import fsdp_dims
    from repro_torch.params import init_params
    dims = fsdp_dims(cfg, init_params(cfg, device="meta"), mesh)

    def walk(d, stacked):
        if isinstance(d, dict):
            return {k: walk(v, stacked or k in ("stacks", "block"))
                    for k, v in d.items()}
        if isinstance(d, list):
            return [walk(v, stacked) for v in d]
        return None if stacked and d == 0 else d

    return walk(dims, False)


def _probe_cfg(cfg, reps: int):
    """A config with ``reps`` repetitions of the main-stack period."""
    layers = cfg.first_k_dense + cfg.period * reps
    changes = {"num_layers": layers}
    if cfg.enc_dec:
        changes["num_encoder_layers"] = reps
    return dataclasses.replace(cfg, **changes)


def _probe_cost(arch: str, shape_name: str, mesh, cfg, fsdp,
                wide_dp: bool = False, device=None) -> Dict:
    """One traced probe (call under a ``FakeTensorMode``)."""
    from repro_torch.launch import steps
    cell = steps.build_cell(arch, shape_name, mesh, fsdp=fsdp,
                            cfg_override=cfg, wide_dp=wide_dp, device=device)
    counts = rl.trace(cell.fn, *cell.inputs)
    return {"flops": counts.flops, "bytes": counts.bytes,
            "coll": counts.collectives.total_bytes}


def extrapolated_cost(arch: str, shape_name: str, mesh, fsdp: bool = False,
                      wide_dp: bool = False, cfg=None, device=None) -> Dict:
    """Per-device (flops, bytes, collective bytes) of the full-depth cell
    (``cfg``: the arch's config when None), from probes at R = 1 and 2;
    call under a ``FakeTensorMode``."""
    cfg = cfg or get_config(arch)
    main_reps = cfg.num_pattern_reps
    dims = _probe_fsdp(cfg, mesh, fsdp)
    c1 = _probe_cost(arch, shape_name, mesh, _probe_cfg(cfg, 1), dims,
                     wide_dp, device)
    c2 = _probe_cost(arch, shape_name, mesh, _probe_cfg(cfg, 2), dims,
                     wide_dp, device)
    out = {}
    for k in ("flops", "bytes", "coll"):
        body = c2[k] - c1[k]
        out[k] = c1[k] + (main_reps - 1) * body
        out[f"{k}_body"] = body
        out[f"{k}_outer"] = c1[k] - body
    out["reps"] = main_reps
    out["probe1"] = c1
    out["probe2"] = c2
    return out
