"""The H100's peaks and the work of a DP cell, frozen from the port's
``ops/roofline.py`` so that later changes to the port cannot move them.

A DP kernel's bound is its int32 operations over the card's int32 rate
(132 SMs x 64 INT32 lanes x 1.98 GHz boost clock = 16.7e12 op/s, NVIDIA
Hopper white paper). The operations are abPOA's band cells, counted by
the benchmark's reference (``reference/engine.py`` ``_band_cells``),
times the recurrence's operations per cell. The bytes a DP must move
(the query, the graph's rows, the step words: tens of kilobytes per
alignment) take under a tenth of the operations' time at 3.35 TB/s, so
the bound is the operations'.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations of one DP cell's recurrence (adds and maxes of H, E,
# F), by gap mode: linear 5, affine 11, convex 17
OPS_PER_CELL = {0: 5, 1: 11, 2: 17}
# substrings of the device kernels that compute DP cells: B1/B3
# (band_dp.cu), B4 (fw_dp.cu), B5 (tile_dp.cu)
DP_KERNELS = ("band_dp_kernel", "fw_dp_kernel", "tile_dp_kernel")


def dp_bound_s(cells: float, gap_mode: int) -> float:
    """Least seconds the card needs for `cells` DP cells."""
    return cells * OPS_PER_CELL[gap_mode] / INT32_OPS_PER_S


def is_dp_kernel(name: str) -> bool:
    return any(k in name for k in DP_KERNELS)
