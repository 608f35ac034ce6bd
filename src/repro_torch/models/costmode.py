"""Cost-mode switches (the counterpart of ``src/repro/models/costmode.py``).

The reference needs its module because XLA's ``HloCostAnalysis`` counts a
``while`` body once: its dry run compiles reduced-depth variants with
every scan unrolled (``costmode.scan``) and extrapolates to full depth.
The port runs eagerly, and its dry run (``launch/dryrun.py``) counts at
the dispatcher, which sees every layer, every key block and every chunk:
``costmode.scan`` has no counterpart here.

What carries over are the switches that make a counting run cheaper (fewer
ops to dispatch) without changing its FLOPs:

  * ``UNROLL`` — cost mode on (the reference's name; nothing unrolls here);
  * ``FLASH_BLOCK`` — in cost mode a flash key block grows towards it
    (:func:`flash_block`);
  * ``MAX_CHUNK_COPIES`` — in cost mode the SSM/RWKV6 chunk loop runs at
    most this many chunks (:func:`chunk_size`).

Outside cost mode every function returns its request, and every result is
what it is without this module.
"""
from __future__ import annotations

import contextlib
import math

UNROLL = False          # cost mode on
FLASH_BLOCK = None      # the widest flash key block in cost mode
MAX_CHUNK_COPIES = 8


def flash_block(requested: int, tk: int) -> int:
    """The flash key block for ``tk`` keys. In cost mode, the largest
    multiple of ``requested`` that is at most ``FLASH_BLOCK`` and divides
    the key length padded to ``requested``: the padded length, and so the
    FLOPs, stay the requested block's (the reference's ``max(requested,
    FLASH_BLOCK)`` pads a 1500-key cross attention to 4096)."""
    if not (UNROLL and FLASH_BLOCK):
        return requested
    nblk = -(-tk // requested)
    k = max(d for d in range(1, max(FLASH_BLOCK // requested, 1) + 1) if nblk % d == 0)
    return requested * k


def chunk_size(q: int, t: int) -> int:
    """SSM/RWKV6 chunk length in cost mode: at most ``MAX_CHUNK_COPIES``
    chunks. It slightly inflates the (small) intra-chunk term; the
    projection products that dominate the FLOP count are unaffected."""
    if UNROLL:
        return max(q, math.ceil(t / MAX_CHUNK_COPIES))
    return q


@contextlib.contextmanager
def enabled(flash: int | None = 4096):
    """Cost mode inside (``FLASH_BLOCK`` = ``flash``), the switches restored
    after."""
    global UNROLL, FLASH_BLOCK
    old = UNROLL, FLASH_BLOCK
    UNROLL, FLASH_BLOCK = True, flash
    try:
        yield
    finally:
        UNROLL, FLASH_BLOCK = old
