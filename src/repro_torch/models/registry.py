"""Model registry: one API over every architecture family (the
counterpart of ``src/repro/models/registry.py:24-141, 184-188``).

``build(cfg)`` returns a ``ModelAPI`` of plain functions;
``make_train_step`` the training step: ``grad_accum`` microbatches with
fp32 gradient accumulators, the global-norm clip, the warmup-cosine
learning rate and AdamW, all on the device. The reference's mesh anchors
(``perf_flags.SCATTER_GRADS``, the microbatch ``shard_act``) and the
dry-run's ``input_specs``/``abstract_*`` come with the port's
multi-device training (ROADMAP 14b-ii).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from .. import tree as T
from ..configs.base import ModelConfig, ShapeCell, TrainConfig
from ..device import resolve_device
from ..optim import adamw_update, clip_by_global_norm, warmup_cosine
from . import transformer as tf
from . import whisper as wh


@dataclass
class ModelAPI:
    cfg: ModelConfig
    init: Callable[[], Any]         # () -> LM | Whisper
    loss: Callable[..., Any]        # (params, batch) -> (loss, metrics)
    prefill: Callable[..., Any]     # (params, batch, t_max) -> (logits, cache)
    decode: Callable[..., Any]      # (params, batch, cache) -> (logits, cache')
    cache_init: Callable[..., Any]  # (batch, t_max) -> cache


def build(cfg: ModelConfig, compute_dtype=torch.bfloat16, param_dtype=torch.float32,
          remat: bool = True, device=None, generator: torch.Generator | None = None
          ) -> ModelAPI:
    """The model's functions on ``device`` (None: the CUDA card). ``init``
    draws from ``generator`` (None: a generator on the device seeded 0)."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(dev).manual_seed(0)
    if cfg.family == "audio":
        return ModelAPI(
            cfg=cfg,
            init=lambda: wh.whisper_init(gen, cfg, param_dtype),
            loss=lambda p, b: wh.whisper_loss(p, cfg, b, compute_dtype, remat),
            prefill=lambda p, b, t_max: wh.whisper_prefill(p, cfg, b, t_max, compute_dtype),
            decode=lambda p, b, c: wh.whisper_decode_step(p, cfg, b, c, compute_dtype),
            cache_init=lambda batch, t_max: wh.whisper_cache_init(cfg, batch, t_max, device=dev),
        )
    return ModelAPI(
        cfg=cfg,
        init=lambda: tf.lm_init(gen, cfg, param_dtype),
        loss=lambda p, b: tf.lm_loss(p, cfg, b, compute_dtype, remat),
        prefill=lambda p, b, t_max: tf.lm_prefill(p, cfg, b, t_max, compute_dtype),
        decode=lambda p, b, c: tf.lm_decode_step(p, cfg, b, c, compute_dtype),
        cache_init=lambda batch, t_max: tf.lm_cache_init(cfg, batch, t_max, device=dev),
    )


# ------------------------------------------------------------------- steps
def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, device=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the parameters and the optimizer state are updated in
    place (and returned); the metrics (``loss``, ``gnorm``, ``lr``, ``ce``,
    ``aux``) are () fp32 device tensors. Nothing is read back to the
    host."""
    api = build(cfg, compute_dtype=getattr(torch, tcfg.compute_dtype),
                param_dtype=getattr(torch, tcfg.param_dtype), remat=tcfg.remat, device=device)
    accum = max(tcfg.grad_accum, 1)

    def _grads(params, leaves, batch):
        if accum == 1:
            loss, metrics = api.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            return [g.float() for g in grads], loss.detach(), _detached(metrics)
        # microbatches: activations scale 1/accum; fp32 accumulators of the
        # parameters' size; microbatch i is rows [i·B/accum, (i+1)·B/accum)
        gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        ms = []
        for i in range(accum):
            b1 = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, metrics = api.loss(params, b1)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            gacc = [a + g.float() for a, g in zip(gacc, grads)]
            lsum = lsum + loss.detach()
            ms.append(_detached(metrics))
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return [g / accum for g in gacc], lsum / accum, metrics

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        leaves = T.leaves(params)
        grads, loss, metrics = _grads(params, leaves, batch)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, like=params)
        lr = warmup_cosine(opt_state["step"], tcfg.lr, tcfg.warmup, tcfg.total_steps)
        params, opt_state = adamw_update(params, grads, opt_state, lr,
                                         weight_decay=tcfg.weight_decay)
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr, **metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, t_max: int, compute_dtype=torch.bfloat16,
                      device=None):
    api = build(cfg, compute_dtype=compute_dtype, remat=False, device=device)

    def prefill_step(params, batch):
        return api.prefill(params, batch, t_max)

    return prefill_step


def make_decode_step(cfg: ModelConfig, compute_dtype=torch.bfloat16, device=None):
    api = build(cfg, compute_dtype=compute_dtype, remat=False, device=device)

    def decode_step(params, batch, cache):
        return api.decode(params, batch, cache)

    return decode_step


def supports_cell(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """Assignment skip rules. Returns (runnable, reason-if-not)."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k dense KV decode is the quadratic regime the "
                       "assignment skips")
    return True, ""
