"""Performance toggles the port's models read (the counterpart of
``src/repro/models/perf_flags.py``; the training flags arrive with their
users).

  FLASH_BF16           run the flash QKᵀ / PV products with bf16 operands
                       and fp32 accumulation; the softmax stays fp32.
                       Default off: operands are upcast to fp32.

The reference's MoE flags are not here. ``MOE_GATHER_DISPATCH`` builds the
same dispatch buffer as a row gather so that GSPMD never reduces the
(E, C, D) buffer across devices, and ``MOE_DATA_CAP`` only moves a
sharding anchor (``shard_act`` on the buffer's capacity axis). One
process has no mesh for either to act on, so the port has one dispatch,
the row writes, which the tests hold to the reference under both of its
flag values.
"""
from __future__ import annotations

FLASH_BF16 = False
