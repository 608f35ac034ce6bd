"""Performance toggles the port's models read (the counterpart of
``src/repro/models/perf_flags.py``).

  FLASH_BF16           run the flash QKᵀ / PV products (and the backward's
                       dq, dk, dv products) with bf16 operands and fp32
                       accumulation; the softmax stays fp32. Default off:
                       operands are upcast to fp32.
  CHUNKED_CE           > 0: ``lm_loss`` never makes the (B, T, V) fp32
                       logits; it streams the unembedding product and the
                       log-sum-exp over vocabulary chunks of this size
                       (``layers.chunked_ce``, whose backward recomputes
                       each chunk). Default 0, the reference's.

The reference's ``SCATTER_GRADS`` and MoE flags are not here. They steer
GSPMD's collectives: ``SCATTER_GRADS`` pins each gradient to its
parameter's sharding (a reduce-scatter instead of an all-reduce and a
slice), ``MOE_GATHER_DISPATCH`` builds the (E, C, D) dispatch buffer as a
row gather so that it is never reduced across devices, and
``MOE_DATA_CAP`` moves a sharding anchor on the buffer's capacity axis.
The port's step that computes each rank's share (``models/spmd.py``, the
dense and vlm families) always reduce-scatters each gradient onto its
block, ``SCATTER_GRADS``'s choice; the other families' sharded step runs
the forward and backward as one on one device and gives each block its
slice of the one gradient: there is no collective for the flags to
change. The port has one MoE dispatch, the row writes, which the tests
hold to the reference under both values of ``MOE_GATHER_DISPATCH``.
``CHUNKED_CE`` also holds in the split step, over each rank's vocabulary
block.
"""
from __future__ import annotations

FLASH_BF16 = False
CHUNKED_CE = 0
