"""Persistent DP arena with the sanitized reference's clearing semantics.

The reference allocates ONE flat SIMD arena per aligner (qp | DP rows | qi,
ref simd_abpoa_realloc abPOA src/simd_abpoa_align.c:1178-1208) and
only reallocates (free + malloc, content discarded) when a larger size is
needed (kroundup64). The STOCK build never clears the arena between
alignment calls, and some DP reads (cells inside the snapped band but
outside every predecessor's fill range, and unguarded backtrack probes) hit
cells the current call never wrote — the previous alignment's matrix, i.e.
undefined behavior (docs/REFERENCE_UB.md finding 2).

The parity target is therefore the SANITIZED reference: arena cleared at
the start of every alignment call (CANARY_BYTE; outputs are fill-byte
independent, so zero = the defined semantics). This arena replicates that:
a persistent byte buffer grown with kroundup64, zeroed on every layout()
(= once per alignment call), with per-call dtype/layout views exactly like
the C code. Fuzz seed 3212 (narrow-band linear seeded windows) is the
counterexample where residue-preserving semantics diverged from the
sanitized reference and dead-ended the backtrack.
"""
from __future__ import annotations

import numpy as np

SIMD_TOTAL_BYTES = 64  # AVX-512 register width used by the reference build


def kroundup64(x: int) -> int:
    x -= 1
    for s in (1, 2, 4, 8, 16, 32):
        x |= x >> s
    return x + 1


class SimdArena:
    def __init__(self):
        self.buf = np.zeros(0, dtype=np.uint8)
        self.s_msize = 0

    def ensure(self, n_bytes: int):
        """ref simd_abpoa_realloc (:1194-1198): grow-only, content discarded."""
        if n_bytes > self.s_msize:
            self.s_msize = kroundup64(n_bytes)
            self.buf = np.zeros(self.s_msize, dtype=np.uint8)

    def layout(self, params, gn: int, qlen: int, pn: int, dtype):
        """Compute per-call views (qp, DP planes, qi) like the C layout.

        Returns (qp[m, width], dp[gn, n_planes, width], qi[width]) where
        width = dp_sn*pn elements of `dtype`.
        """
        from .params import LINEAR_GAP, AFFINE_GAP, EXTEND_MODE
        size = SIMD_TOTAL_BYTES
        sn = (qlen + pn) // pn
        m = params.m
        if params.gap_mode == LINEAR_GAP:
            planes = 1
        elif params.gap_mode == AFFINE_GAP:
            planes = 3
        else:
            planes = 5
        need = sn * m * size + sn * gn * planes * size
        has_qi = params.wb >= 0 or params.align_mode == EXTEND_MODE
        if has_qi:
            need += sn * size
        self.ensure(need)
        # sanitized-reference semantics: clear per alignment call
        # (ref patch in tests/golden/make_sanitized_ref.sh: memset of
        # s_mem at the top of simd_abpoa_align_sequence_to_subgraph)
        self.buf[:self.s_msize] = 0
        width = sn * (size // dtype().itemsize)  # == dp_sn * pn elements
        elems = self.buf.view(dtype)
        qp = elems[:m * width].reshape(m, width)
        dp = elems[m * width:(m + gn * planes) * width].reshape(gn, planes,
                                                                width)
        qi = elems[(m + gn * planes) * width:(m + gn * planes + 1) * width] \
            if has_qi else None
        return qp, dp, qi
