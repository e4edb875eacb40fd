"""Architecture registry: the 10 assigned configs + reduced smoke variants.

``get_config("kimi-k2-1t-a32b")`` returns the full paper-table config;
``reduced_config(cfg)`` shrinks it to a CPU-runnable smoke config of the
same family (same code paths, tiny dims).  ``ARCHS`` holds the same data
as the JAX package's ``configs/``, copied.  ``SERVE_ONLY`` holds configs
the JAX package lacks, which the port serves on one device:
hymba-1.5b-base, Hymba at its published structure.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import SHAPES, InputShape, ModelConfig

from .granite_3_8b import CONFIG as granite_3_8b
from .qwen3_4b import CONFIG as qwen3_4b
from .olmo_1b import CONFIG as olmo_1b
from .starcoder2_7b import CONFIG as starcoder2_7b
from .internvl2_26b import CONFIG as internvl2_26b
from .whisper_medium import CONFIG as whisper_medium
from .kimi_k2_1t_a32b import CONFIG as kimi_k2_1t_a32b
from .mixtral_8x22b import CONFIG as mixtral_8x22b
from .xlstm_350m import CONFIG as xlstm_350m
from .hymba_1_5b import CONFIG as hymba_1_5b
from . import hymba_1_5b_base

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        granite_3_8b, qwen3_4b, olmo_1b, starcoder2_7b, internvl2_26b,
        whisper_medium, kimi_k2_1t_a32b, mixtral_8x22b, xlstm_350m,
        hymba_1_5b,
    ]
}


SERVE_ONLY: dict[str, ModelConfig] = {
    hymba_1_5b_base.CONFIG.name: hymba_1_5b_base.CONFIG,
}
_REDUCED_SERVE_ONLY = {hymba_1_5b_base.CONFIG.name: hymba_1_5b_base.REDUCED}


def get_config(name: str) -> ModelConfig:
    for registry in (ARCHS, SERVE_ONLY):
        if name in registry:
            return registry[name]
    raise KeyError(f"unknown arch {name!r}; have "
                   f"{sorted(ARCHS) + sorted(SERVE_ONLY)}")


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Same family/code paths, laptop-sized dims for smoke tests."""
    if cfg.name in _REDUCED_SERVE_ONLY:
        return _REDUCED_SERVE_ONLY[cfg.name]
    kv = 4 if cfg.n_kv_heads == cfg.n_heads else 2
    upd = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=kv, head_dim=16,
        d_ff=128, vocab_size=256,
    )
    if cfg.is_moe:
        upd.update(n_experts=4, top_k=2, moe_d_ff=32,
                   n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.family == "ssm":
        upd.update(slstm_every=2, mlstm_heads=2)
    if cfg.family == "hybrid":
        upd.update(ssm_state=4, sliding_window=8, global_attn_every=2)
    elif cfg.sliding_window is not None:
        upd.update(sliding_window=8)
    if cfg.encoder_layers:
        upd.update(encoder_layers=2, encoder_seq=16)
    if cfg.frontend_tokens:
        upd.update(frontend_tokens=8)
    return dataclasses.replace(cfg, **upd)


def shape_cells(cfg: ModelConfig) -> dict[str, InputShape | None]:
    """The 4 assigned shape cells for an arch; None marks a documented skip
    (long_500k on pure full-attention archs — DESIGN.md §4)."""
    cells: dict[str, InputShape | None] = {}
    for name, shape in SHAPES.items():
        if name == "long_500k" and not cfg.supports_long_context:
            cells[name] = None
        else:
            cells[name] = shape
    return cells


__all__ = ["ARCHS", "SERVE_ONLY", "get_config", "reduced_config", "shape_cells",
           "SHAPES", "ModelConfig", "InputShape"]
