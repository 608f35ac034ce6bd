"""Performance toggles the port's models read (the counterpart of
``src/repro/models/perf_flags.py``; the training flags arrive with their
users).

  FLASH_BF16     run the flash QKᵀ / PV products with bf16 operands and
                 fp32 accumulation; the softmax stays fp32. Default off:
                 operands are upcast to fp32.
"""
from __future__ import annotations

FLASH_BF16 = False
