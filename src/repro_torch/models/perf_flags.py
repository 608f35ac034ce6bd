"""Performance toggles the port's models read (the counterpart of
``src/repro/models/perf_flags.py``; ``SCATTER_GRADS`` anchors gradients to
a mesh's sharding and comes with the port's multi-device training).

  FLASH_BF16           run the flash QKᵀ / PV products (and the backward's
                       dq, dk, dv products) with bf16 operands and fp32
                       accumulation; the softmax stays fp32. Default off:
                       operands are upcast to fp32.
  CHUNKED_CE           > 0: ``lm_loss`` never makes the (B, T, V) fp32
                       logits; it streams the unembedding product and the
                       log-sum-exp over vocabulary chunks of this size
                       (``layers.chunked_ce``, whose backward recomputes
                       each chunk). Default 0, the reference's.

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
CHUNKED_CE = 0
