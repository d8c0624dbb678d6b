"""Architecture registry: the 10 assigned configs + shape applicability."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "stablelm-3b": "stablelm_3b",
    "smollm-135m": "smollm_135m",
    "gemma2-27b": "gemma2_27b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a6_6b",
    "musicgen-medium": "musicgen_medium",
    "hymba-1.5b": "hymba_1_5b",
    "xlstm-350m": "xlstm_350m",
    "qwen2-vl-72b": "qwen2_vl_72b",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def applicable_shapes(cfg: ModelConfig) -> Dict[str, ShapeConfig]:
    """long_500k requires sub-quadratic decode."""
    shapes = dict(SHAPES)
    if not cfg.subquadratic:
        shapes.pop("long_500k")
    return shapes


def all_cells():
    """Every (arch, shape) cell in the assignment (skips noted)."""
    for name in list_archs():
        cfg = get_config(name)
        for shape in applicable_shapes(cfg).values():
            yield name, cfg, shape
