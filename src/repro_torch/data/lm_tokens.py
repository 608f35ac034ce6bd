"""Deterministic, cursor-addressable synthetic LM data (the counterpart of
``src/repro/data/lm_tokens.py``).

Tokens follow a noisy affine bigram chain t′ = (31·t + 17 + ε) mod V.
``batch(step)`` is a pure function of (seed, step): its draws come from a
``torch.Generator`` seeded by both, so a replayed step sees a
bit-identical batch. The draws are not the reference's (``jax.random`` is
not reproduced); :func:`chain` takes them as arguments, so a caller can
hand it the reference's draws and get the reference's tokens.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

A, B = 31, 17


def chain(first: torch.Tensor, eps: torch.Tensor, vocab: int) -> dict:
    """first: (B, 1) start tokens, eps: (B, T) noise draws → {"tokens",
    "labels"}: (B, T) int32 each, the chain's positions [0, T) and [1, T]."""
    toks = [first[:, 0].long()]
    for e in eps.long().unbind(1):
        toks.append((A * toks[-1] + B + e) % vocab)
    toks = torch.stack(toks, dim=1).to(torch.int32)  # (B, T + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class TokenPipeline:
    def __init__(self, vocab: int, seq_len: int, global_batch: int, seed: int = 0,
                 noise: int = 4, device=None):
        self.vocab = vocab
        self.seq = seq_len
        self.batch_size = global_batch
        self.seed = seed
        self.noise = noise
        self.device = resolve_device(device)

    def draws(self, step: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(first (B, 1), eps (B, T)) of ``step``, from a CPU generator
        seeded by (seed, step) through numpy's ``SeedSequence``."""
        state = np.random.SeedSequence((self.seed, step)).generate_state(1)[0]
        gen = torch.Generator().manual_seed(int(state))
        first = torch.randint(0, self.vocab, (self.batch_size, 1), generator=gen)
        eps = torch.randint(0, self.noise, (self.batch_size, self.seq), generator=gen)
        return first, eps

    def batch(self, step: int) -> dict:
        first, eps = self.draws(step)
        return {k: v.to(self.device) for k, v in chain(first, eps, self.vocab).items()}
