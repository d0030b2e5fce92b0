"""What the benchmark takes from the program: its model module, its
configuration object built from a configuration file, and its kernels'
build."""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parents[1] / "src"


def module(cfg: dict):
    """The program's model module that the configuration names."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    return importlib.import_module(cfg["program"])


def build(cfg: dict, device) -> None:
    """Build the program's kernel library, or load the one a run in this
    checkout built (``build/`` at its root), so that neither lands in the
    warm-up. Nothing to build off the card."""
    module(cfg)
    if torch.device(device).type == "cuda":
        from repro_torch import kernels
        kernels.library()


def recsys_config(cfg: dict):
    """The program's ``RecsysConfig`` for a configuration file."""
    module(cfg)
    from repro_torch.configs.base import FeatureField, RecsysConfig

    def fields(key):
        return tuple(FeatureField(f["name"], f["vocab"], f["bag"],
                                  f["combiner"]) for f in cfg[key])
    return RecsysConfig(
        name=cfg["name"], model=cfg["model"], embed_dim=cfg["embed_dim"],
        user_fields=fields("user_fields"), item_fields=fields("item_fields"),
        seq_len=cfg["seq_len"], attn_mlp=tuple(cfg["attn_mlp"]),
        gru_dim=cfg["gru_dim"], mlp=tuple(cfg["mlp"]),
        param_dtype=cfg["dtype"])
