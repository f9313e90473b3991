"""Architecture registry: one module per assigned architecture."""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, INFERENCE_SHAPES, ModelConfig, ShapeSpec

_ARCH_MODULES = {
    "xlstm-125m": "xlstm_125m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llama3.2-3b": "llama3_2_3b",
    "gemma2-27b": "gemma2_27b",
    "qwen3-1.7b": "qwen3_1_7b",
    "gemma2-2b": "gemma2_2b",
    "internvl2-26b": "internvl2_26b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCHS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    import importlib

    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def all_cells() -> list[tuple[str, ShapeSpec]]:
    """Every assigned (arch x shape) cell, including ones later marked skip."""
    return [(a, s) for a in ARCHS for s in SHAPES.values()]


def cell_skip_reason(arch: str, shape: ShapeSpec) -> str | None:
    """Assignment rules: long_500k runs for SSM/hybrid/linear-attention archs
    and is skipped for pure full-attention archs (see DESIGN.md §5)."""
    cfg = get_config(arch)
    if shape.name == "long_500k" and not (
            cfg.is_subquadratic() or cfg.family in ("ssm", "hybrid")):
        return "pure full-attention arch: long_500k requires sub-quadratic attention (see DESIGN.md §5)"
    return None
