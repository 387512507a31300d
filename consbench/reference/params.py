"""Alignment / pipeline parameters (the benchmark's frozen copy).

Equivalent of abPOA's abpoa_para_t + init/post-set logic
(reference: abPOA include/abpoa.h:62-81, src/abpoa_align.c:12-176).
"""
from __future__ import annotations

import dataclasses
import numpy as np

# alignment modes (ref include/abpoa.h:7-9)
GLOBAL_MODE = 0
LOCAL_MODE = 1
EXTEND_MODE = 2

# gap modes (ref include/abpoa.h:13-15)
LINEAR_GAP = 0
AFFINE_GAP = 1
CONVEX_GAP = 2

# defaults (ref src/abpoa_align.h:9-18, include/abpoa.h:17-18)
ABPOA_MATCH = 2
ABPOA_MISMATCH = 4
ABPOA_GAP_OPEN1 = 4
ABPOA_GAP_OPEN2 = 24
ABPOA_GAP_EXT1 = 2
ABPOA_GAP_EXT2 = 1
ABPOA_EXTRA_B = 10
ABPOA_EXTRA_F = 0.01
ABPOA_MMK = 19
ABPOA_MMW = 10
ABPOA_MIN_POA_WIN = 500
MULTIP_MIN_FREQ = 0.25

SRC_NODE_ID = 0
SINK_NODE_ID = 1

# output modes (ref include/abpoa.h:31-36)
OUT_CONS = 0
OUT_MSA = 1
OUT_CONS_MSA = 2
OUT_GFA = 3
OUT_CONS_GFA = 4
OUT_CONS_FQ = 5


def _char26(c: str, m: int) -> int:
    from .alphabet import encode_table
    return int(encode_table(27)[ord(c)])


@dataclasses.dataclass
class Params:
    """All knobs; defaults mirror abpoa_init_para (ref src/abpoa_align.c:93-141)."""
    align_mode: int = GLOBAL_MODE
    gap_mode: int = CONVEX_GAP
    zdrop: int = -1
    end_bonus: int = -1
    wb: int = ABPOA_EXTRA_B
    wf: float = ABPOA_EXTRA_F

    amb_strand: bool = False
    ret_cigar: bool = True
    rev_cigar: bool = False
    out_cons: bool = True
    out_fq: bool = False
    out_gfa: bool = False
    out_msa: bool = False
    max_n_cons: int = 1
    min_freq: float = MULTIP_MIN_FREQ
    use_read_ids: bool = False
    incr_fn: str | None = None
    out_pog: str | None = None

    m: int = 5  # residue types (5 nt / 27 aa)
    use_score_matrix: bool = False
    mat_fn: str | None = None
    match: int = ABPOA_MATCH
    mismatch: int = ABPOA_MISMATCH
    gap_open1: int = ABPOA_GAP_OPEN1
    gap_open2: int = ABPOA_GAP_OPEN2
    gap_ext1: int = ABPOA_GAP_EXT1
    gap_ext2: int = ABPOA_GAP_EXT2

    use_qv: bool = False
    disable_seeding: bool = True
    k: int = ABPOA_MMK
    w: int = ABPOA_MMW
    min_w: int = ABPOA_MIN_POA_WIN
    progressive_poa: bool = False
    verbose: int = 0

    # derived (post_set)
    mat: np.ndarray | None = None
    max_mat: int = 0
    min_mis: int = 0

    # 0: abPOA's 16/32-bit score-width dispatch; 8: the benchmark's
    # control, every DP in int8 (engine.score_width_dispatch)
    score_bits: int = 0

    def set_gap_mode(self):
        # ref src/abpoa_align.c:87-91
        if self.gap_open1 == 0:
            self.gap_mode = LINEAR_GAP
        elif self.gap_open1 > 0 and self.gap_open2 == 0:
            self.gap_mode = AFFINE_GAP
        else:
            self.gap_mode = CONVEX_GAP

    def gen_simple_mat(self):
        # ref src/abpoa_align.c:12-25
        m = self.m
        match = abs(self.match)
        mismatch = -abs(self.mismatch)
        mat = np.zeros((m, m), dtype=np.int64)
        for i in range(m - 1):
            for j in range(m - 1):
                mat[i, j] = match if i == j else mismatch
            mat[i, m - 1] = 0
        mat[m - 1, :] = 0
        self.mat = mat
        self.max_mat = match
        self.min_mis = -mismatch

    def set_mat_from_file(self, mat_fn: str):
        # ref src/abpoa_align.c:34-85 (BLOSUM62/HOXD70/PAM250 format)
        from .alphabet import encode_table
        tab = encode_table(27) if self.m > 5 else encode_table(27)
        m = self.m
        mat = np.zeros((m, m), dtype=np.int64)
        order: list[int] = []
        first = True
        with open(mat_fn) as fp:
            for line in fp:
                if line.startswith("#"):
                    continue
                if first:
                    first = False
                    order = [int(tab[ord(c)]) for c in line.split()]
                else:
                    toks = line.split()
                    if not toks:
                        continue
                    bi = int(tab[ord(toks[0][0])])
                    if bi >= m:
                        raise ValueError(f"Unknown base: {toks[0]}")
                    for n, s in enumerate(toks[1:]):
                        mat[bi, order[n]] = int(s)
        self.mat = mat
        self.max_mat = int(mat.max()) if mat.size else 0
        self.min_mis = int(max(0, (-mat).max())) if mat.size else 0

    def post_set(self):
        """ref abpoa_post_set_para (src/abpoa_align.c:143-168)."""
        self.set_gap_mode()
        if self.out_msa or self.out_gfa or self.max_n_cons > 1:
            self.use_read_ids = True
        if self.align_mode == LOCAL_MODE:
            self.wb = -1
        if self.m > 5 and self.k > 11:
            self.k, self.w = 7, 4
        if not self.use_score_matrix:
            self.gen_simple_mat()
        else:
            self.set_mat_from_file(self.mat_fn)
        return self

    @property
    def gap_oe1(self) -> int:
        return self.gap_open1 + self.gap_ext1

    @property
    def gap_oe2(self) -> int:
        return self.gap_open2 + self.gap_ext2
