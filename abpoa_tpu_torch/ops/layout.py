"""Layout constants shared by the band DP and graph-update kernels.

Copies of ``abpoa_tpu/ops/dp_pallas.py`` (scal / misc / backtrack-op
layouts) and ``abpoa_tpu/ops/dp_pallas_band.py`` (NEG, INVALID_BITS):
importing those modules pulls in JAX, so the port keeps its own copies
and ``tests/test_torch_layout.py`` pins them equal. The CUDA sources
(``csrc/*.cu``) repeat the same numbers; ``csrc/layout.cuh`` names them.
"""

NEG = -(1 << 29)
H16 = 0xFFFF

# scal vector layout (per instance)
(S_QLEN, S_NROWS, S_W, S_INF, S_REMEND, S_E1, S_O1, S_OE1, S_E2, S_O2,
 S_OE2, S_ZDROP, S_DPSN, S_NSCAL) = range(14)

# misc output layout; M_LASTI is the topo row of the last pushed step,
# the anchor of the graph update's forward row reconstruction
(M_BEST, M_BI, M_BJ, M_CELLS, M_OVFL, M_NSTEPS, M_FAIL, M_ENDI, M_ENDJ,
 M_LASTI, M_NMISC) = range(11)

# backtrack operator bitmask (ref abpoa_align.h:20-27)
BT_M, BT_E1, BT_E2, BT_F1, BT_F2 = 0x1, 0x2, 0x4, 0x8, 0x10
BT_E, BT_F, BT_ALL = 0x6, 0x18, 0x1F

# backtrack bits of a cell outside its row's band window: no move hits
INVALID_BITS = 15 | (15 << 4) | (15 << 8) | (15 << 14) | (15 << 18)

# dynamic shared memory a block may use on Hopper
MAX_SMEM_BYTES = 232448
# B4's and B5's per-row arrays: ROW_WORDS words a row after 224 fixed
# words of shared memory, where they stay while they fit; past that the
# wrappers allocate them a global scratch (csrc/fw_tile.cuh
# smem_with_rows)
ROW_WORDS = 7


def rows_in_smem(R: int) -> bool:
    """Whether B4 and B5 keep the per-row arrays of R rows in shared
    memory."""
    return 4 * (224 + ROW_WORDS * R) <= MAX_SMEM_BYTES
