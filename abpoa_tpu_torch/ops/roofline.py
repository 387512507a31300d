"""The H100's rates behind a kernel's bound, one definition for
``chip_smoke.py``'s kernel table (``--dp-only``).

A kernel's bound is the larger of two times: the bytes it must move
(inputs read once, outputs written once) over the card's HBM rate, and
its int32 operations over the card's int32 rate (132 SMs x 64 INT32
lanes x 1.98 GHz boost clock = 16.7e12 op/s, NVIDIA Hopper white paper).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations of one DP cell's recurrence (adds and maxes of H, E,
# F), by gap mode: linear 5, affine 11, convex 17
OPS_PER_CELL = {0: 5, 1: 11, 2: 17}


def bound(nbytes: int, ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by) of a call that moves nbytes and does ops."""
    tb = nbytes / HBM_BYTES_PER_S
    to = ops / INT32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")
