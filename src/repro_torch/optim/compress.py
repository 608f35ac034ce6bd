"""Int8 gradient compression (the counterpart of
``src/repro/optim/compress.py:21-33``): a symmetric per-tensor scale and
round half to even, bitwise the reference's. Its error-feedback mean over
a mesh axis, ``ef_compressed_mean``, needs a collective and comes with
the port's multi-device training (ROADMAP 14b-ii)."""
from __future__ import annotations

import torch


def compress_int8(g: torch.Tensor):
    """g → (q int8, scale () fp32)."""
    g32 = g.float()
    scale = g32.abs().max().clamp_min(1e-12) / 127.0
    q = torch.round(g32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
