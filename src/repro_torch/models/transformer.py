"""LM assembly (the counterpart of ``src/repro/models/transformer.py``),
serving half, for every decoder family.

A model is a *program*: an ordered list of homogeneous segments
(``program(cfg)``). The reference stacks a segment's layers (L, ...) and
scans them; the port holds one ``Block`` module a layer in
``LM.segments`` and loops, with the reference's parameter names and
einsum layouts (``wq`` (d, h, dh), ``wo`` (h, dh, d)), so that
``state.lm_params_from_numpy`` only copies and unstacks. The prefill's
per-layer states and the decode cache keep the reference's stacked
(L, B, ...) layout. Segment kinds:

  attn_mlp    pre-norm GQA/MQA + (gated) MLP          dense / vlm backbones
  attn_moe    GQA + MoE FFN (shared + routed)         qwen2-moe
  mla_mlp     DeepSeek MLA + dense MLP                deepseek's leading layer
  mla_moe     DeepSeek MLA + MoE FFN                  deepseek-v2
  mamba       Mamba2 SSD block                        zamba2's backbone
  rwkv        RWKV6 time mix + channel mix            rwkv6
  site        zamba2's shared attention block: one weight set (``LM.site``)
              with per-site LoRA deltas; each site owns an unstacked cache

Decode writes the attention caches (GQA, MLA, the sites') in place and
returns new stacked Mamba2 and RWKV6 states; ``len`` stays on the device.
The serving entry points (``lm_prefill``, ``lm_decode_step``) run under
``torch.inference_mode``; ``lm_forward`` and ``lm_loss`` are the training
forward, differentiable, with each layer recomputed in the backward under
``remat`` (``torch.utils.checkpoint``, where the reference has
``jax.checkpoint``). Whisper's encoder-decoder (``whisper.py``) is built
from the same blocks.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import rwkv6 as rk
from . import ssm as mb
from .attention import (gqa_cache_init, gqa_decode, gqa_forward, gqa_init, mla_cache_init,
                        mla_decode, mla_forward, mla_init)
from .layers import (chunked_ce, cross_entropy, dense_init, embed_init, layernorm,
                     layernorm_init, mlp, mlp_init, rmsnorm, rmsnorm_init, unembed)
from .moe import moe_apply, moe_init

#: the attention segment kinds → their cache's tensor names
ATTN_CACHE = {"attn_mlp": ("k", "v"), "attn_moe": ("k", "v"), "mla_mlp": ("ckv", "kpe"),
              "mla_moe": ("ckv", "kpe")}


@dataclass(frozen=True)
class SegSpec:
    kind: str
    count: int


def program(cfg) -> list[SegSpec]:
    if cfg.family == "hybrid":
        segs, every, left = [], cfg.shared_attn_every, cfg.n_layers
        while left > 0:
            k = min(every, left)
            segs.append(SegSpec("mamba", k))
            left -= k
            if left > 0 or k == every:
                segs.append(SegSpec("site", 1))
        return segs
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return [SegSpec("rwkv", cfg.n_layers)]
    if cfg.ssm is not None:
        return [SegSpec("mamba", cfg.n_layers)]
    if cfg.moe is not None and cfg.mla is not None:
        segs = []
        if cfg.n_dense_layers:
            segs.append(SegSpec("mla_mlp", cfg.n_dense_layers))
        segs.append(SegSpec("mla_moe", cfg.n_layers - cfg.n_dense_layers))
        return segs
    if cfg.moe is not None:
        return [SegSpec("attn_moe", cfg.n_layers)]
    return [SegSpec("attn_mlp", cfg.n_layers)]


def n_sites(cfg) -> int:
    return sum(1 for s in program(cfg) if s.kind == "site")


# ------------------------------------------------------------------ modules
class ParamTree(nn.Module):
    """A nested dict of tensors as a module, read as the reference reads
    its pytree: ``p["attn"]["wq"]``, ``"bq" in p``; a None leaf (zamba2's
    ``lora`` when ``shared_attn_lora`` is 0) reads back as None. Parameters
    are made with ``requires_grad`` off (serving); a train step turns it on
    (``registry.make_train_step``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, None if val is None else nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


class Block(ParamTree):
    """One layer's parameters: the reference's block dict, unstacked."""


class LM(ParamTree):
    """The whole model: ``embed`` (V_pad, D), ``segments`` (one
    ``nn.ModuleList`` of ``Block``s a segment of ``program(cfg)``, empty for
    a ``site``), ``final_norm``, and ``unembed``, ``vis_proj`` and ``site``
    (the shared block and its LoRA) where the config has them."""

    def __init__(self, cfg, tree: dict):
        super().__init__({k: v for k, v in tree.items() if k != "segments"})
        self.segments = nn.ModuleList(nn.ModuleList(Block(layer) for layer in seg)
                                      for seg in tree["segments"])


# --------------------------------------------------------------- norm disp
def _norm_init(cfg, dtype, device):
    return (layernorm_init(cfg.d_model, dtype, device) if cfg.norm == "ln"
            else rmsnorm_init(cfg.d_model, dtype, device))


def _norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    return layernorm(p, x, cfg.norm_eps) if cfg.norm == "ln" else rmsnorm(p, x, cfg.norm_eps)


# -------------------------------------------------------------- block init
def block_init(generator: torch.Generator, cfg, dtype, kind: str) -> dict:
    dev = generator.device
    if kind in ATTN_CACHE:
        attn = mla_init if kind.startswith("mla") else gqa_init
        p = {"norm1": _norm_init(cfg, dtype, dev), "attn": attn(generator, cfg, dtype),
             "norm2": _norm_init(cfg, dtype, dev)}
        if kind.endswith("moe"):
            p["moe"] = moe_init(generator, cfg, dtype)
        else:
            p["ffn"] = mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, gated=cfg.gated_mlp)
        return p
    if kind == "mamba":
        return {"norm1": _norm_init(cfg, dtype, dev),
                "mixer": mb.mamba2_init(generator, cfg, dtype)}
    if kind == "rwkv":
        return {"norm1": _norm_init(cfg, dtype, dev),
                "tmix": rk.rwkv6_mix_init(generator, cfg, dtype),
                "norm2": _norm_init(cfg, dtype, dev),
                "cmix": rk.rwkv6_cmix_init(generator, cfg, dtype)}
    raise ValueError(kind)


def _site_init(generator: torch.Generator, cfg, dtype) -> dict:
    """Zamba2's shared attention block: one weight set, and per-site LoRA
    (``a`` (sites, D, r), ``b`` (sites, r, D), ``b`` zero) or None."""
    dev = generator.device
    shared = {"norm1": _norm_init(cfg, dtype, dev), "attn": gqa_init(generator, cfg, dtype),
              "norm2": _norm_init(cfg, dtype, dev),
              "ffn": mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, gated=cfg.gated_mlp)}
    r, d = cfg.shared_attn_lora, cfg.d_model
    lora = None
    if r:
        lora = {"a": dense_init(generator, (n_sites(cfg), d, r), dtype, scale=0.02),
                "b": torch.zeros((n_sites(cfg), r, d), dtype=dtype, device=dev)}
    return {"shared": shared, "lora": lora}


def lm_init(generator: torch.Generator, cfg, dtype=torch.float32) -> LM:
    """Random parameters on the generator's device: the reference's shapes
    and scales, drawn from ``generator`` (the draws are not the reference's:
    ``jax.random`` is not reproduced)."""
    segs = program(cfg)
    tree = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype),
        "segments": [[] if seg.kind == "site" else
                     [block_init(generator, cfg, dtype, seg.kind) for _ in range(seg.count)]
                     for seg in segs],
        "final_norm": _norm_init(cfg, dtype, generator.device),
    }
    if any(seg.kind == "site" for seg in segs):
        tree["site"] = _site_init(generator, cfg, dtype)
    if not cfg.tie_embed:
        tree["unembed"] = dense_init(generator, (cfg.d_model, cfg.padded_vocab), dtype,
                                     scale=0.02)
    if cfg.vis_ctx:
        tree["vis_proj"] = dense_init(generator, (cfg.vis_width, cfg.d_model), dtype)
    return LM(cfg, tree)


# ------------------------------------------------------------- block apply
def _ffn_part(p, cfg, x: torch.Tensor):
    """The FFN half: (x + FFN(norm2(x)), the MoE aux loss, or 0.0 without
    MoE: no zero tensor is made a layer)."""
    h = _norm(cfg, p["norm2"], x)
    if "moe" in p:
        out, aux = moe_apply(p["moe"], cfg, h)
    else:
        out, aux = mlp(p["ffn"], h, cfg.act), 0.0
    return x + out, aux


def block_apply(p, cfg, kind: str, x: torch.Tensor, positions: torch.Tensor, mask):
    """Full-sequence form of one layer. Returns (x, aux loss, the state the
    decode cache takes: (k, v), (ckv, kpe), (conv, ssm) or (wkv, tshift,
    cshift))."""
    if kind in ATTN_CACHE:
        fwd = mla_forward if kind.startswith("mla") else gqa_forward
        attn_out, kv = fwd(p["attn"], cfg, _norm(cfg, p["norm1"], x), positions, mask)
        x, aux = _ffn_part(p, cfg, x + attn_out)
        return x, aux, kv
    if kind == "mamba":
        out, state = mb.mamba2_forward(p["mixer"], cfg, _norm(cfg, p["norm1"], x))
        return x + out, 0.0, state
    if kind == "rwkv":
        tout, tstate = rk.rwkv6_mix_chunked(p["tmix"], cfg, _norm(cfg, p["norm1"], x))
        x = x + tout
        cout, cx = rk.rwkv6_cmix(p["cmix"], cfg, _norm(cfg, p["norm2"], x))
        return x + cout, 0.0, (*tstate, cx)
    raise ValueError(kind)


def _site_in(p, cfg, site_idx: int, x: torch.Tensor) -> torch.Tensor:
    """The site's attention input: norm1(x), plus its LoRA delta."""
    h = _norm(cfg, p["shared"]["norm1"], x)
    if p["lora"] is not None:
        a = p["lora"]["a"][site_idx].to(x.dtype)
        b = p["lora"]["b"][site_idx].to(x.dtype)
        h = h + (h @ a) @ b
    return h


def _site_out(p, cfg, x: torch.Tensor) -> torch.Tensor:
    return x + mlp(p["shared"]["ffn"], _norm(cfg, p["shared"]["norm2"], x), cfg.act)


def _site_apply(p, cfg, site_idx: int, x: torch.Tensor, positions: torch.Tensor, mask):
    """Full-sequence form of the ``site_idx``-th shared-attention site.
    Returns (x, (k, v))."""
    attn_out, kv = gqa_forward(p["shared"]["attn"], cfg, _site_in(p, cfg, site_idx, x),
                               positions, mask)
    return _site_out(p, cfg, x + attn_out), kv


def block_decode(p, cfg, kind: str, x: torch.Tensor, cache_l: dict, length: torch.Tensor):
    """One-token form; ``cache_l`` is this layer's cache (no length).
    Returns (x, cache_l'): an attention cache written in place, new Mamba2
    and RWKV6 states."""
    if kind in ATTN_CACHE:
        dec = mla_decode if kind.startswith("mla") else gqa_decode
        attn_out, new = dec(p["attn"], cfg, _norm(cfg, p["norm1"], x), {**cache_l, "len": length})
        new.pop("len")
        x, _ = _ffn_part(p, cfg, x + attn_out)
        return x, new
    if kind == "mamba":
        out, (conv, ssm) = mb.mamba2_decode(p["mixer"], cfg, _norm(cfg, p["norm1"], x),
                                            (cache_l["conv"], cache_l["ssm"]))
        return x + out, {"conv": conv, "ssm": ssm}
    if kind == "rwkv":
        tout, (s, xlast) = rk.rwkv6_mix_recurrent(p["tmix"], cfg, _norm(cfg, p["norm1"], x),
                                                  state=cache_l["wkv"], xlast=cache_l["tshift"])
        x = x + tout
        cout, cx = rk.rwkv6_cmix(p["cmix"], cfg, _norm(cfg, p["norm2"], x),
                                 xlast=cache_l["cshift"])
        return x + cout, {"wkv": s, "tshift": xlast, "cshift": cx}
    raise ValueError(kind)


# ----------------------------------------------------------------- assembly
def _logits(p, cfg, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    x = _norm(cfg, p["final_norm"], x)
    if cfg.tie_embed:
        return unembed(x, p["embed"], compute_dtype)
    return (x @ p["unembed"].to(compute_dtype)).float()


def _embed_inputs(p, cfg, batch: dict, compute_dtype):
    """tokens (+ vis) → x (B, T, D), the mask spec, positions (B, T)."""
    tok = batch["tokens"]
    x = p["embed"][tok].to(compute_dtype)
    if cfg.vis_ctx:
        vis = batch["vis"].to(compute_dtype) @ p["vis_proj"].to(compute_dtype)
        x = torch.cat([vis, x], dim=1)
    b, t, _ = x.shape
    mask = ("prefix", cfg.vis_ctx) if cfg.vis_ctx else ("causal", 0)
    positions = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
    return x, mask, positions


def remat_apply(fn, remat: bool, *args):
    """``fn(*args)``, its activations recomputed in the backward when
    ``remat`` and autograd records (the reference's ``jax.checkpoint``)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def lm_forward(p: LM, cfg, batch: dict, compute_dtype=torch.bfloat16, remat: bool = True,
               last_only: bool = False, return_hidden: bool = False,
               keep_states: bool = True):
    """The full-sequence forward. Returns (logits fp32, the summed MoE aux
    loss (0.0 without MoE), the states a segment: each layer's stacked
    (L, B, ...), a site's (k, v) unstacked; an empty list unless
    ``keep_states``). ``last_only`` keeps the last position (the serving
    prefill: no (B, T, V) fp32 tensor); ``return_hidden`` returns the
    final-norm hidden states in place of logits (the chunked-CE path)."""
    x, mask, positions = _embed_inputs(p, cfg, batch, compute_dtype)
    aux_total = 0.0
    caches = []
    site_idx = 0
    for seg, seg_p in zip(program(cfg), p["segments"]):
        if seg.kind == "site":
            x, kv = remat_apply(_site_apply, remat, p["site"], cfg, site_idx, x, positions, mask)
            if keep_states:
                caches.append(kv)
            site_idx += 1
            continue
        states = []
        for layer_p in seg_p:
            x, aux, state = remat_apply(block_apply, remat, layer_p, cfg, seg.kind, x,
                                        positions, mask)
            aux_total = aux_total + aux
            states.append(state)
        if keep_states:
            caches.append(tuple(torch.stack(parts) for parts in zip(*states)))
    if last_only:
        x = x[:, -1:]
    if return_hidden:
        return _norm(cfg, p["final_norm"], x), aux_total, caches
    return _logits(p, cfg, x, compute_dtype), aux_total, caches


def lm_loss(p: LM, cfg, batch: dict, compute_dtype=torch.bfloat16, remat: bool = True):
    """(CE + the MoE aux loss, {"ce", "aux"}), both () fp32. The CE is the
    token mean over labels ≥ 0, on the text positions only (a vlm's patch
    positions carry no label), through ``chunked_ce`` when
    ``perf_flags.CHUNKED_CE`` > 0 (its vocabulary chunk)."""
    from . import perf_flags

    labels = batch["labels"]
    if perf_flags.CHUNKED_CE:
        hid, aux, _ = lm_forward(p, cfg, batch, compute_dtype, remat, return_hidden=True,
                                 keep_states=False)
        if cfg.vis_ctx:
            hid = hid[:, cfg.vis_ctx:]
        w = p["embed"].T if cfg.tie_embed else p["unembed"]
        n = hid.shape[0] * hid.shape[1]
        ce = chunked_ce(hid.reshape(n, -1).to(compute_dtype), w.to(compute_dtype),
                        labels.reshape(n), (labels >= 0).reshape(n), cfg.vocab,
                        perf_flags.CHUNKED_CE)
    else:
        logits, aux, _ = lm_forward(p, cfg, batch, compute_dtype, remat, keep_states=False)
        if cfg.vis_ctx:  # loss on text positions only
            logits = logits[:, cfg.vis_ctx:]
        ce = cross_entropy(logits, labels, vocab_valid=cfg.vocab)
    aux = torch.zeros((), dtype=torch.float32, device=labels.device) + aux
    return ce + aux, {"ce": ce, "aux": aux}


# -------------------------------------------------------------------- cache
def _layer_cache_init(cfg, kind: str, batch: int, t_max: int, dtype, device) -> dict:
    if kind in ATTN_CACHE:
        init = mla_cache_init if kind.startswith("mla") else gqa_cache_init
        c = init(cfg, batch, t_max, dtype, device)
        c.pop("len")
        return c
    if kind == "mamba":
        conv, ssm = mb.mamba2_state_init(cfg, batch, dtype, device)
        return {"conv": conv, "ssm": ssm}
    if kind == "rwkv":
        s, tsh, csh = rk.rwkv6_state_init(cfg, batch, device)
        return {"wkv": s, "tshift": tsh, "cshift": csh}
    raise ValueError(kind)


def lm_cache_init(cfg, batch: int, t_max: int, dtype=torch.bfloat16, device=None
                  ) -> dict:
    """{segments: [a segment's cache, each tensor stacked (L, B, ...); a
    site's GQA {k, v} unstacked], len: () int32} on ``device`` (None: the
    CUDA card); t_max includes vis_ctx for vlm archs. Attention caches and
    the Mamba2 conv window take ``dtype``; SSM and RWKV6 states are fp32."""
    device = resolve_device(device)
    segs = []
    for seg in program(cfg):
        if seg.kind == "site":
            segs.append(_layer_cache_init(cfg, "attn_mlp", batch, t_max, dtype, device))
            continue
        one = _layer_cache_init(cfg, seg.kind, batch, t_max, dtype, device)
        segs.append({name: t.new_zeros((seg.count, *t.shape)) for name, t in one.items()})
    return {"segments": segs, "len": torch.zeros((), dtype=torch.int32, device=device)}


@torch.inference_mode()
def lm_decode_step(p: LM, cfg, batch: dict, cache: dict, compute_dtype=torch.bfloat16):
    """One-token decode. batch: {"tokens": (B, 1)}. Writes the attention
    caches' tensors in place and returns (logits (B, 1, V_pad) fp32,
    cache')."""
    x = p["embed"][batch["tokens"]].to(compute_dtype)
    length = cache["len"]
    new_segs = []
    site_idx = 0
    for seg, seg_p, seg_c in zip(program(cfg), p["segments"], cache["segments"]):
        if seg.kind == "site":
            sp = p["site"]
            attn_out, newc = gqa_decode(sp["shared"]["attn"], cfg,
                                        _site_in(sp, cfg, site_idx, x), {**seg_c, "len": length})
            x = _site_out(sp, cfg, x + attn_out)
            new_segs.append(seg_c)
            site_idx += 1
            continue
        layers = []
        for i, layer_p in enumerate(seg_p):
            x, new_l = block_decode(layer_p, cfg, seg.kind, x,
                                    {name: t[i] for name, t in seg_c.items()}, length)
            layers.append(new_l)
        new_segs.append(seg_c if seg.kind in ATTN_CACHE else
                        {name: torch.stack([l[name] for l in layers]) for name in seg_c})
    return _logits(p, cfg, x, compute_dtype), {"segments": new_segs, "len": length + 1}


@torch.inference_mode()
def lm_prefill(p: LM, cfg, batch: dict, t_max: int, compute_dtype=torch.bfloat16,
               cache_dtype=torch.bfloat16):
    """Prefill: the forward, then each segment's states packed into a decode
    cache of ``t_max`` positions with ``len = T + vis_ctx``: attention k/v
    (or MLA's ckv/kpe) in ``cache_dtype``, the Mamba2 conv window cast to
    it, the SSM and RWKV6 states fp32. Returns the last position's logits
    (B, 1, V_pad) and the cache."""
    logits, _, caches = lm_forward(p, cfg, batch, compute_dtype, remat=False, last_only=True)
    b, t = batch["tokens"].shape
    t += cfg.vis_ctx or 0
    dev = logits.device
    cache = lm_cache_init(cfg, b, t_max, cache_dtype, device=dev)
    segs = cache["segments"]
    for j, (seg, got) in enumerate(zip(program(cfg), caches)):
        if seg.kind == "site":
            for name, val in zip(("k", "v"), got):
                segs[j][name][:, :t] = val.to(cache_dtype)
        elif seg.kind in ATTN_CACHE:
            for name, val in zip(ATTN_CACHE[seg.kind], got):
                segs[j][name][:, :, :t] = val.to(cache_dtype)
        elif seg.kind == "mamba":
            conv, ssm = got
            segs[j] = {"conv": conv.to(cache_dtype), "ssm": ssm}
        else:  # rwkv
            segs[j] = dict(zip(("wkv", "tshift", "cshift"), got))
    cache["len"] = torch.full((), t, dtype=torch.int32, device=dev)
    return logits, cache
