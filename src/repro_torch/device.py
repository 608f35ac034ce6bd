"""Device and rank-dtype resolution for the PyTorch port.

Counterpart of ``src/repro/kernels/backend.py``. Entry points take
``device=None``, which means the CUDA card: they raise when no card is
present and run on the CPU only when the caller passes ``device="cpu"``.

Combo ranks are int32 unless the caller asks for int64 (``wide=True``),
mirroring ``levels._rank_dtype`` / ``_imax`` of the reference, whose int64
ranks need ``jax_enable_x64``. Keeping int32 as the default keeps the
reference's capacity guard: the port refuses the levels the reference
refuses.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None → the CUDA card (raises without one); else ``torch.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def rank_dtype(wide: bool = False) -> torch.dtype:
    """int64 combo ranks when ``wide``, else int32."""
    return torch.int64 if wide else torch.int32


def imax(dtype: torch.dtype) -> int:
    """The 'no winner' sentinel of the commit keys: a quarter of the dtype's
    maximum, as in the reference."""
    return torch.iinfo(dtype).max // 4
