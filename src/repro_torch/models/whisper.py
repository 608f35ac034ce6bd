"""Whisper-style encoder-decoder (the audio family; the counterpart of
``src/repro/models/whisper.py``).

The conv/mel frontend is the reference's stub: the batch carries frame
embeddings (B, enc_ctx, d_model). The encoder is a non-causal transformer
over the frames; the decoder a causal LM with cross-attention to the
encoder's output. LayerNorm and the non-gated tanh-GELU MLP throughout,
sinusoidal positions added to the inputs (and the attention's RoPE, as the
reference's ``gqa_forward`` applies it).

Parameters: a :class:`Whisper` of ``enc_blocks`` and ``dec_blocks``
(``Block``s, one a layer, where the reference stacks them), ``enc_norm``,
``dec_norm`` and the tied ``embed``. The decode cache keeps the
reference's stacked layout: ``self`` {k, v: (L, B, T_max, KV, dh)}, the
cross K/V (L, B, enc_ctx, H, dh) computed once at prefill, and ``len`` on
the device. Prefill and decode run under ``torch.inference_mode``;
``encode``, ``decode_train`` and ``whisper_loss`` are differentiable.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .attention import (cross_forward, cross_init, cross_kv, gqa_cache_init, gqa_decode,
                        gqa_forward, gqa_init)
from .layers import cross_entropy, embed_init, layernorm, layernorm_init, mlp, mlp_init
from .transformer import Block, ParamTree, remat_apply


class Whisper(ParamTree):
    """``enc_blocks`` and ``dec_blocks`` (``nn.ModuleList``s of ``Block``s),
    ``enc_norm``, ``dec_norm``, ``embed`` (V_pad, D)."""

    def __init__(self, cfg, tree: dict):
        stacks = ("enc_blocks", "dec_blocks")
        super().__init__({k: v for k, v in tree.items() if k not in stacks})
        for name in stacks:
            setattr(self, name, nn.ModuleList(Block(layer) for layer in tree[name]))


def _sinusoid(t: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block_init(generator: torch.Generator, cfg, dtype) -> dict:
    dev = generator.device
    return {
        "norm1": layernorm_init(cfg.d_model, dtype, dev),
        "attn": gqa_init(generator, cfg, dtype),
        "norm2": layernorm_init(cfg.d_model, dtype, dev),
        "ffn": mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, gated=False),
    }


def _dec_block_init(generator: torch.Generator, cfg, dtype) -> dict:
    dev = generator.device
    return {
        "norm1": layernorm_init(cfg.d_model, dtype, dev),
        "attn": gqa_init(generator, cfg, dtype),
        "norm_x": layernorm_init(cfg.d_model, dtype, dev),
        "cross": cross_init(generator, cfg, dtype),
        "norm2": layernorm_init(cfg.d_model, dtype, dev),
        "ffn": mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, gated=False),
    }


def whisper_init(generator: torch.Generator, cfg, dtype=torch.float32) -> Whisper:
    """Random parameters on the generator's device: the reference's shapes
    and scales (not its draws)."""
    dev = generator.device
    return Whisper(cfg, {
        "enc_blocks": [_enc_block_init(generator, cfg, dtype) for _ in range(cfg.n_enc_layers)],
        "enc_norm": layernorm_init(cfg.d_model, dtype, dev),
        "dec_blocks": [_dec_block_init(generator, cfg, dtype) for _ in range(cfg.n_layers)],
        "dec_norm": layernorm_init(cfg.d_model, dtype, dev),
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype),
    })


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, dtype=torch.int32, device=device).expand(b, t)


def _enc_layer(lp, cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    attn, _ = gqa_forward(lp["attn"], cfg, layernorm(lp["norm1"], x, cfg.norm_eps), positions,
                          ("none", 0))
    y = x + attn
    return y + mlp(lp["ffn"], layernorm(lp["norm2"], y, cfg.norm_eps), "gelu")


def encode(p: Whisper, cfg, frames: torch.Tensor, compute_dtype=torch.bfloat16,
           remat: bool = True) -> torch.Tensor:
    """frames: (B, enc_ctx, d_model) stub embeddings → the encoder output."""
    b, t, _ = frames.shape
    x = frames.to(compute_dtype) + _sinusoid(t, cfg.d_model, frames.device).to(compute_dtype)
    positions = _positions(b, t, frames.device)
    for lp in p["enc_blocks"]:
        x = remat_apply(_enc_layer, remat, lp, cfg, x, positions)
    return layernorm(p["enc_norm"], x, cfg.norm_eps)


def _dec_layer(lp, cfg, x: torch.Tensor, positions: torch.Tensor, enc_out: torch.Tensor):
    """One decoder layer: (x, its self (k, v), its cross (k, v))."""
    attn, kv = gqa_forward(lp["attn"], cfg, layernorm(lp["norm1"], x, cfg.norm_eps), positions,
                           ("causal", 0))
    y = x + attn
    ckv = cross_kv(lp["cross"], enc_out)
    y = y + cross_forward(lp["cross"], cfg, layernorm(lp["norm_x"], y, cfg.norm_eps), *ckv)
    return y + mlp(lp["ffn"], layernorm(lp["norm2"], y, cfg.norm_eps), "gelu"), kv, ckv


def _logits(p: Whisper, cfg, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    x = layernorm(p["dec_norm"], x, cfg.norm_eps)
    return (x.to(compute_dtype) @ p["embed"].to(compute_dtype).T).float()


def _decoder(p: Whisper, cfg, tokens: torch.Tensor, enc_out: torch.Tensor, compute_dtype,
             remat: bool, last_only: bool, keep_states: bool):
    b, t = tokens.shape
    dev = tokens.device
    x = p["embed"][tokens].to(compute_dtype) + _sinusoid(t, cfg.d_model, dev).to(compute_dtype)
    positions = _positions(b, t, dev)
    states = []
    for lp in p["dec_blocks"]:
        x, kv, ckv = remat_apply(_dec_layer, remat, lp, cfg, x, positions, enc_out)
        if keep_states:
            states.append((*kv, *ckv))
    if last_only:
        x = x[:, -1:]
    stacked = tuple(torch.stack(parts) for parts in zip(*states))
    return _logits(p, cfg, x, compute_dtype), stacked


def decode_train(p: Whisper, cfg, tokens: torch.Tensor, enc_out: torch.Tensor,
                 compute_dtype=torch.bfloat16, remat: bool = True, last_only: bool = False):
    """The teacher-forced decoder. Returns (logits fp32, the self (k, v),
    each stacked (L, B, T, KV, dh))."""
    logits, states = _decoder(p, cfg, tokens, enc_out, compute_dtype, remat, last_only, True)
    return logits, states[:2]


def whisper_loss(p: Whisper, cfg, batch: dict, compute_dtype=torch.bfloat16,
                 remat: bool = True):
    """(CE, {"ce", "aux": 0}) over the decoder's tokens, labels < 0 ignored."""
    enc = encode(p, cfg, batch["frames"], compute_dtype, remat)
    logits, _ = _decoder(p, cfg, batch["tokens"], enc, compute_dtype, remat, False, False)
    ce = cross_entropy(logits, batch["labels"], vocab_valid=cfg.vocab)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=ce.device)}


def whisper_cache_init(cfg, batch: int, t_max: int, dtype=torch.bfloat16, device=None) -> dict:
    """Self-attention k/v a decoder layer and the cross k/v a layer, stacked,
    on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    l, h, dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    self_c = gqa_cache_init(cfg, batch, t_max, dtype, device)
    self_c.pop("len")
    cross = (l, batch, cfg.enc_ctx, h, dh)
    return {
        "self": {name: t.new_zeros((l, *t.shape)) for name, t in self_c.items()},
        "cross_k": torch.zeros(cross, dtype=dtype, device=device),
        "cross_v": torch.zeros(cross, dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.inference_mode()
def whisper_prefill(p: Whisper, cfg, batch: dict, t_max: int, compute_dtype=torch.bfloat16,
                    cache_dtype=torch.bfloat16):
    """Encode, then the teacher-forced prompt → (the last position's logits
    (B, 1, V_pad), the decode cache: self k/v and the cross k/v in
    ``cache_dtype``, ``len`` = T)."""
    enc = encode(p, cfg, batch["frames"], compute_dtype, remat=False)
    logits, (k, v, ck, cv) = _decoder(p, cfg, batch["tokens"], enc, compute_dtype, False, True,
                                      True)
    b, t = batch["tokens"].shape
    dev = logits.device
    cache = whisper_cache_init(cfg, b, t_max, cache_dtype, device=dev)
    cache["self"]["k"][:, :, :t] = k.to(cache_dtype)
    cache["self"]["v"][:, :, :t] = v.to(cache_dtype)
    cache["cross_k"] = ck.to(cache_dtype)
    cache["cross_v"] = cv.to(cache_dtype)
    cache["len"] = torch.full((), t, dtype=torch.int32, device=dev)
    return logits, cache


@torch.inference_mode()
def whisper_decode_step(p: Whisper, cfg, batch: dict, cache: dict,
                        compute_dtype=torch.bfloat16):
    """One decoder token against the cached self and cross k/v. Writes the
    self cache in place; returns (logits (B, 1, V_pad) fp32, cache')."""
    tok = batch["tokens"]  # (B, 1)
    length = cache["len"]
    t_max = cache["self"]["k"].shape[2]
    at = length.reshape(1).clamp(max=t_max - 1).long()
    pos = _sinusoid(t_max, cfg.d_model, tok.device).index_select(0, at)
    x = p["embed"][tok].to(compute_dtype) + pos.to(compute_dtype)
    for i, lp in enumerate(p["dec_blocks"]):
        self_c = {"k": cache["self"]["k"][i], "v": cache["self"]["v"][i], "len": length}
        attn, _ = gqa_decode(lp["attn"], cfg, layernorm(lp["norm1"], x, cfg.norm_eps), self_c)
        y = x + attn
        hx = layernorm(lp["norm_x"], y, cfg.norm_eps)
        y = y + cross_forward(lp["cross"], cfg, hx, cache["cross_k"][i].to(y.dtype),
                              cache["cross_v"][i].to(y.dtype))
        x = y + mlp(lp["ffn"], layernorm(lp["norm2"], y, cfg.norm_eps), "gelu")
    return _logits(p, cfg, x, compute_dtype), {**cache, "len": length + 1}
