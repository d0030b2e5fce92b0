"""Architecture registry: --arch <id> → (config, shapes, reduced config)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.configs import lm_archs, other_archs
from repro_torch.configs.base import (GNN_SHAPES, LM_SHAPES, REC_SHAPES, ShapeSpec)


@dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str                 # lm | gnn | recsys
    config: Any
    shapes: tuple[ShapeSpec, ...]
    reduced: Callable[[Any], Any]


ARCHS: dict[str, ArchDef] = {}


def _reg(arch_id, family, config, shapes, reduced):
    ARCHS[arch_id] = ArchDef(arch_id, family, config, shapes, reduced)


_reg("qwen3-8b", "lm", lm_archs.QWEN3_8B, LM_SHAPES, lm_archs.reduced_lm)
_reg("smollm-135m", "lm", lm_archs.SMOLLM_135M, LM_SHAPES, lm_archs.reduced_lm)
_reg("starcoder2-7b", "lm", lm_archs.STARCODER2_7B, LM_SHAPES, lm_archs.reduced_lm)
_reg("deepseek-v2-lite-16b", "lm", lm_archs.DEEPSEEK_V2_LITE, LM_SHAPES,
     lm_archs.reduced_lm)
_reg("deepseek-v3-671b", "lm", lm_archs.DEEPSEEK_V3, LM_SHAPES, lm_archs.reduced_lm)
_reg("schnet", "gnn", other_archs.SCHNET, GNN_SHAPES, other_archs.reduced_gnn)
_reg("two-tower-retrieval", "recsys", other_archs.TWO_TOWER, REC_SHAPES,
     other_archs.reduced_recsys)
_reg("mind", "recsys", other_archs.MIND, REC_SHAPES, other_archs.reduced_recsys)
_reg("din", "recsys", other_archs.DIN, REC_SHAPES, other_archs.reduced_recsys)
_reg("dien", "recsys", other_archs.DIEN, REC_SHAPES, other_archs.reduced_recsys)


def get(arch_id: str) -> ArchDef:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def get_shape(arch: ArchDef, shape_name: str) -> ShapeSpec:
    for s in arch.shapes:
        if s.name == shape_name:
            return s
    raise KeyError(f"{arch.arch_id} has no shape {shape_name!r}; "
                   f"known: {[s.name for s in arch.shapes]}")


def all_cells():
    """All 40 (arch, shape) baseline cells."""
    return [(a, s) for a in ARCHS.values() for s in a.shapes]
