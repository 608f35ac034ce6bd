"""Batched LM serving driver: prefill a batch of prompts, then decode
greedily (the port of ``src/repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch qwen3-1.7b --reduced \\
        --batch 4 --prompt-len 32 --gen 16 --device cpu
    python -m repro_torch.launch.serve --arch qwen3-1.7b    # full width, on the card

Compute is bf16 at full width and fp32 under ``--reduced``; parameters
are fp32. Parameters, prompts and (vlm) patch embeddings are drawn from
seeded ``torch.Generator``s on the device (seeds 0 and 1, the reference's
keys; the draws themselves differ from ``jax.random``'s). As in the
reference, ``--temperature`` is accepted and decoding is greedy.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..configs import ARCHS
from ..device import resolve_device
from ..models import registry as R
from ..obs import MonotonicClock

_CLK = MonotonicClock()  # the obs timing seam — no raw perf_counter (RPR003)


def _ready(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prompts(cfg, batch: int, prompt_len: int, device) -> dict:
    """Seeded prompt tokens (and vlm patch embeddings) on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(1)
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                                   device=dev, dtype=torch.int32)}
    if cfg.vis_ctx:
        out["vis"] = torch.randn((batch, cfg.vis_ctx, cfg.vis_width), generator=gen, device=dev)
    return out


def generate(api: R.ModelAPI, params, batch: dict, t_max: int, gen: int):
    """One prefill, then ``gen - 1`` greedy decode steps. Returns the
    generated tokens (B, gen) int32 and the prefill's and the decode
    loop's seconds (each ending when the card is idle)."""
    dev = batch["tokens"].device
    t0 = _CLK.now()
    logits, cache = api.prefill(params, batch, t_max)
    _ready(dev)
    t_prefill = _CLK.now() - t0

    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    out = [tok]
    t0 = _CLK.now()
    for _ in range(gen - 1):
        logits, cache = api.decode(params, {"tokens": tok}, cache)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        out.append(tok)
    _ready(dev)
    return torch.cat(out, dim=1), t_prefill, _CLK.now() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-1.7b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "audio":
        raise SystemExit("use serve with decoder-only archs; Whisper serves through "
                         "repro_torch.models.registry.build (its prefill takes frames)")

    dev = resolve_device(args.device)
    dtype = torch.float32 if args.reduced else torch.bfloat16
    api = R.build(cfg, compute_dtype=dtype, device=dev)
    params = api.init()  # seed 0, the reference's init key
    t_max = args.prompt_len + args.gen + (cfg.vis_ctx or 0)
    batch = prompts(cfg, args.batch, args.prompt_len, dev)

    gen, t_prefill, t_decode = generate(api, params, batch, t_max, args.gen)
    toks_per_s = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"[serve] {cfg.name}{' (reduced)' if args.reduced else ''}")
    print(f"  prefill: {args.batch} x {args.prompt_len} tokens in {t_prefill*1e3:.1f} ms")
    print(f"  decode:  {args.gen-1} steps -> {toks_per_s:.1f} tok/s (batched)")
    print(f"  sample generations: {gen[:2, :8].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
