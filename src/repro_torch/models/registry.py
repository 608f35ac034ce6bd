"""Model registry: one API over the ported architecture families (the
counterpart of ``src/repro/models/registry.py:24-53, 125-141, 184-188``).

``build(cfg)`` returns a ``ModelAPI`` of plain functions. ``loss`` and the
dry-run's ``input_specs``/``abstract_*`` arrive with training (ROADMAP
14b).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig, ShapeCell
from ..device import resolve_device
from . import transformer as tf


@dataclass
class ModelAPI:
    cfg: ModelConfig
    init: Callable[[], Any]         # () -> LM
    prefill: Callable[..., Any]     # (params, batch, t_max) -> (logits, cache)
    decode: Callable[..., Any]      # (params, batch, cache) -> (logits, cache')
    cache_init: Callable[..., Any]  # (batch, t_max) -> cache


def build(cfg: ModelConfig, compute_dtype=torch.bfloat16, param_dtype=torch.float32,
          device=None, generator: torch.Generator | None = None) -> ModelAPI:
    """The model's functions on ``device`` (None: the CUDA card). ``init``
    draws from ``generator`` (None: a generator on the device seeded 0). A
    family or segment kind not yet ported raises ``NotImplementedError``
    naming its ROADMAP item."""
    tf.check_ported(cfg)
    dev = resolve_device(device)
    gen = generator or torch.Generator(dev).manual_seed(0)
    return ModelAPI(
        cfg=cfg,
        init=lambda: tf.lm_init(gen, cfg, param_dtype),
        prefill=lambda p, b, t_max: tf.lm_prefill(p, cfg, b, t_max, compute_dtype),
        decode=lambda p, b, c: tf.lm_decode_step(p, cfg, b, c, compute_dtype),
        cache_init=lambda batch, t_max: tf.lm_cache_init(cfg, batch, t_max, device=dev),
    )


def make_prefill_step(cfg: ModelConfig, t_max: int, compute_dtype=torch.bfloat16,
                      device=None):
    api = build(cfg, compute_dtype=compute_dtype, device=device)

    def prefill_step(params, batch):
        return api.prefill(params, batch, t_max)

    return prefill_step


def make_decode_step(cfg: ModelConfig, compute_dtype=torch.bfloat16, device=None):
    api = build(cfg, compute_dtype=compute_dtype, device=device)

    def decode_step(params, batch, cache):
        return api.decode(params, batch, cache)

    return decode_step


def supports_cell(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """Assignment skip rules. Returns (runnable, reason-if-not)."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k dense KV decode is the quadratic regime the "
                       "assignment skips")
    return True, ""
