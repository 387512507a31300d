"""Reference-exact banded POA dynamic program: the benchmark's frozen
plain-NumPy copy of the port's host oracle (no native row kernels).

This engine reproduces abPOA's striped-SIMD DP *bit exactly*, including the
lane-width (pn) band snapping, segment-boundary carries, the masked log-step
F prefix scan (SIMD_SET_F), adaptive-band bookkeeping and the score-width
(16/32-bit) dispatch (reference: abPOA src/simd_abpoa_align.c).

The vector quirks that leak into scores (and therefore into output bytes):
  * band [beg,end] is snapped to pn-lane segments: beg = beg_sn*pn,
    end = (end_sn+1)*pn-1 (ref :718-719), with beg_sn clamped to the earliest
    predecessor segment,
  * the F scan's initial carry for the band's first lane is H(M)+q at that
    very column (pre-E-max), not -inf (ref :976/:1381),
  * segments beyond all predecessor bands restrict which lanes may propagate
    F at each log step (set_num masking, ref :664-699),
  * 16-bit runs use inf_min = INT16_MIN + margin and wraparound int16 math.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .params import (GLOBAL_MODE, LOCAL_MODE, EXTEND_MODE,
                      LINEAR_GAP, AFFINE_GAP, CONVEX_GAP)
from . import cigar as cg


INT8_MIN = -128
INT16_MAX = 32767
INT16_MIN = -32768
INT32_MIN = -2147483648


@dataclasses.dataclass
class AlignResult:
    best_score: int = 0
    cigar: list = dataclasses.field(default_factory=list)
    node_s: int = -1
    node_e: int = -1
    query_s: int = -1
    query_e: int = -1
    n_aln_bases: int = 0
    n_matched_bases: int = 0
    dp_cells: int = 0      # band cells the DP computed (_band_cells)


def _simd_params(bits: int):
    """Lane geometry (pn lanes per vector, log2 scan steps).

    The reference build on this hardware runs the AVX-512 branch
    (ref simd_abpoa_align.c:18-23): its `#undef __AVX512F__` in
    simd_instruction.h:17 is silently undone by immintrin.h's
    `#pragma GCC pop_options` on modern GCC, so with -march=native on an
    AVX-512 CPU pn = 32 (int16) / 16 (int32) with 64-byte vectors. Band
    snapping and the masked F-scan depend on pn, so we mirror it.
    """
    if bits == 8:
        return 64, 6  # the control's int8 lanes
    if bits == 16:
        return 32, 5  # pn, log_n
    return 16, 4


def score_width_dispatch(params, gn: int, qlen: int):
    """The reference's 16/32-bit score-width choice (ref :1667-1683).
    Returns (bits, pn, log_n, inf_min).

    params.score_bits == 8 is the benchmark's control: the same
    recurrence in int8 with wraparound, the width below the int16 that
    abPOA picks for every alignment of the benchmark's cells."""
    gap_oe1 = params.gap_open1 + params.gap_ext1
    gap_oe2 = params.gap_open2 + params.gap_ext2
    if params.score_bits == 8:
        inf_min = (max(INT8_MIN + params.min_mis, INT8_MIN + gap_oe1,
                       INT8_MIN + gap_oe2)
                   + 31 * max(params.gap_ext1, params.gap_ext2))
        pn, log_n = _simd_params(8)
        return 8, pn, log_n, int(inf_min)
    ln = max(qlen, gn)
    max_score = max(qlen * params.max_mat,
                    ln * params.gap_ext1 + params.gap_open1)
    if max_score <= INT16_MAX - params.min_mis - gap_oe1 - gap_oe2:
        bits = 16
        inf_min = (max(INT16_MIN + params.min_mis, INT16_MIN + gap_oe1,
                       INT16_MIN + gap_oe2)
                   + 31 * max(params.gap_ext1, params.gap_ext2))
    else:
        bits = 32
        inf_min = (max(INT32_MIN + params.min_mis, INT32_MIN + gap_oe1,
                       INT32_MIN + gap_oe2)
                   + 31 * max(params.gap_ext1, params.gap_ext2))
    pn, log_n = _simd_params(bits)
    return bits, pn, log_n, int(inf_min)


def align_sequence_to_subgraph(graph, params, beg_node_id: int, end_node_id: int,
                               query: np.ndarray, arena=None) -> AlignResult:
    """ref simd_abpoa_align_sequence_to_subgraph (:1645-1712).

    `arena` is the aligner's persistent SimdArena; passing None uses a fresh
    zeroed arena (clean single-call semantics).
    """
    from .arena import SimdArena
    if arena is None:
        arena = SimdArena()
    res = AlignResult()
    abg = graph
    n2i = abg.node_id_to_index
    i2n = abg.index_to_node_id
    beg_index = int(n2i[beg_node_id]); end_index = int(n2i[end_node_id])
    gn = end_index - beg_index + 1
    qlen = len(query)

    # reachability map within the subgraph interval (ref :1650-1660)
    index_map = np.zeros(abg.node_n, dtype=bool)
    index_map[beg_index] = index_map[end_index] = True
    for i in range(beg_index, end_index - 1):
        if not index_map[i]:
            continue
        nid = int(i2n[i])
        for out_id in abg.node[nid].out_id:
            index_map[int(n2i[out_id])] = True

    # score-width dispatch (ref :1667-1683)
    bits, _pn, _ln, inf_min = score_width_dispatch(params, gn, qlen)
    it = {8: np.int8, 16: np.int16, 32: np.int32}[bits]

    ctx = _Ctx(graph, params, beg_node_id, end_node_id, beg_index, end_index,
               index_map, query, qlen, bits, inf_min, it, res, arena)
    ctx.run()
    return res


class _Ctx:
    def __init__(self, graph, params, beg_node_id, end_node_id, beg_index,
                 end_index, index_map, query, qlen, bits, inf_min, it, res,
                 arena):
        self.g = graph; self.p = params
        self.beg_node_id = beg_node_id; self.end_node_id = end_node_id
        self.beg_index = beg_index; self.end_index = end_index
        self.index_map = index_map
        self.query = np.asarray(query, dtype=np.int64)
        self.qlen = qlen; self.bits = bits; self.inf_min = it(inf_min)
        self.it = it; self.res = res
        self.pn, self.log_n = _simd_params(bits)
        self.dp_sn = (qlen + 1 + self.pn - 1) // self.pn
        self.n_rows = end_index - beg_index + 1
        # band w (ref :445)
        self.w = qlen if params.wb < 0 else params.wb + int(params.wf * qlen)
        self.mat = params.mat
        # gap scalars in dtype (wraparound semantics)
        self.e1 = it(params.gap_ext1); self.e2 = it(params.gap_ext2)
        self.o1 = it(params.gap_open1); self.o2 = it(params.gap_open2)
        self.oe1 = it(params.gap_open1 + params.gap_ext1)
        self.oe2 = it(params.gap_open2 + params.gap_ext2)
        # GAP_E*S tables: e<<t computed by doubling in dtype (ref :1593-1596)
        self.e1S = np.empty(self.log_n, dtype=it)
        self.e2S = np.empty(self.log_n, dtype=it)
        self.e1S[0] = self.e1; self.e2S[0] = self.e2
        for t in range(1, self.log_n):
            self.e1S[t] = it(self.e1S[t - 1] + self.e1S[t - 1])
            self.e2S[t] = it(self.e2S[t - 1] + self.e2S[t - 1])
        # persistent arena views (ref s_mem layout, see arena.py)
        m = params.m
        width = self.dp_sn * self.pn
        qp_v, dp_v, _ = arena.layout(params, self.n_rows, qlen, self.pn, it)
        # query profile (ref abpoa_init_var :502-515) - fully rewritten
        self.qp = qp_v
        for k in range(m):
            row = self.qp[k]
            row[0] = 0
            row[1:qlen + 1] = self.mat[k][self.query].astype(it)
            row[qlen + 1:] = 0
        # DP planes: only reference-written ranges are touched; other
        # cells stay at the arena's per-call zero fill (sanitized-
        # reference semantics, see arena.py / REFERENCE_UB.md)
        gm = params.gap_mode
        self.H = dp_v[:, 0, :]
        self.E1 = self.F1 = self.E2 = self.F2 = None
        if gm == AFFINE_GAP:
            self.E1 = dp_v[:, 1, :]
            self.F1 = dp_v[:, 2, :]
        elif gm == CONVEX_GAP:
            self.E1 = dp_v[:, 1, :]
            self.E2 = dp_v[:, 2, :]
            self.F1 = dp_v[:, 3, :]
            self.F2 = dp_v[:, 4, :]
        self.dp_beg = np.zeros(self.n_rows, dtype=np.int64)
        self.dp_end = np.zeros(self.n_rows, dtype=np.int64)
        self.dp_beg_sn = np.zeros(self.n_rows, dtype=np.int64)
        self.dp_end_sn = np.zeros(self.n_rows, dtype=np.int64)
        # pre_index (ref :1599-1613)
        nr = self.n_rows
        self.pre_index = [[] for _ in range(nr)]
        for index_i in range(beg_index + 1, end_index + 1):
            dp_i = index_i - beg_index
            nid = int(graph.index_to_node_id[index_i])
            for in_id in graph.node[nid].in_id:
                pidx = int(graph.node_id_to_index[in_id])
                if index_map[pidx]:
                    self.pre_index[dp_i].append(pidx - beg_index)
        self.best_score = int(inf_min)
        self.best_i = 0; self.best_j = 0; self.best_id = 0
        # scratch (hot-loop allocation diet; contents never outlive a call)
        self._fbuf1 = np.empty(self.pn, dtype=it)
        self._f2d = np.empty((2, self.pn), dtype=it)
        self._e12S = np.stack([self.e1S, self.e2S])
        self._mbuf = np.empty(width, dtype=it)
        # per-column query indices, -1 past qlen (only segment qlen//pn
        # can hold masked lanes; rows never extend past it)
        self._qi_all = np.arange(width, dtype=np.int64)
        self._qi_all[self._qi_all > qlen] = -1

    # -------------------------------------------------------------- #
    def _ad_beg(self, node_id: int) -> int:
        g = self.g
        rem = int(g.node_id_to_max_remain[node_id]) - int(
            g.node_id_to_max_remain[self.end_node_id]) - 1
        return max(0, min(int(g.node_id_to_max_pos_left[node_id]),
                          self.qlen - rem) - self.w)

    def _ad_end(self, node_id: int) -> int:
        g = self.g
        rem = int(g.node_id_to_max_remain[node_id]) - int(
            g.node_id_to_max_remain[self.end_node_id]) - 1
        return min(self.qlen, max(int(g.node_id_to_max_pos_right[node_id]),
                                  self.qlen - rem) + self.w)

    # -------------------------------------------------------------- #
    def _first_row(self):
        """ref simd_abpoa_{lg,ag,cg}_first_dp (:553-662)."""
        p, g = self.p, self.g
        pn = self.pn
        if p.wb >= 0:
            g.node_id_to_max_pos_left[self.beg_node_id] = 0
            g.node_id_to_max_pos_right[self.beg_node_id] = 0
            for out_id in g.node[self.beg_node_id].out_id:
                if self.index_map[int(g.node_id_to_index[out_id])]:
                    g.node_id_to_max_pos_left[out_id] = 1
                    g.node_id_to_max_pos_right[out_id] = 1
            beg, end = 0, self._ad_end(self.beg_node_id)
        else:
            beg, end = 0, self.qlen
        self.dp_beg_sn[0] = beg // pn; self.dp_end_sn[0] = end // pn
        self.dp_beg[0] = self.dp_beg_sn[0] * pn
        self.dp_end[0] = (self.dp_end_sn[0] + 1) * pn - 1
        _end_sn = min(self.dp_end_sn[0] + 1, self.dp_sn - 1)
        hi = (_end_sn + 1) * pn
        it = self.it; inf = self.inf_min
        gm = p.gap_mode
        if p.align_mode == LOCAL_MODE:
            self.H[0, :hi] = 0
            if gm != LINEAR_GAP:
                self.E1[0, :hi] = 0; self.F1[0, :hi] = 0
            if gm == CONVEX_GAP:
                self.E2[0, :hi] = 0; self.F2[0, :hi] = 0
            return
        self.H[0, :hi] = inf
        de = int(self.dp_end[0])
        idx = np.arange(0, de + 1)
        if gm == LINEAR_GAP:
            self.H[0, :de + 1] = (-int(self.e1) * idx).astype(it)
        elif gm == AFFINE_GAP:
            self.E1[0, :hi] = inf
            self.H[0, 0] = 0; self.E1[0, 0] = it(-int(self.oe1))
            self.F1[0, 0] = inf
            if de >= 1:
                f1 = (-int(self.o1) - int(self.e1) * idx[1:]).astype(it)
                self.F1[0, 1:de + 1] = f1
                self.H[0, 1:de + 1] = f1
        else:  # convex
            self.E1[0, :hi] = inf; self.E2[0, :hi] = inf
            self.H[0, 0] = 0
            self.E1[0, 0] = it(-int(self.oe1)); self.E2[0, 0] = it(-int(self.oe2))
            self.F1[0, 0] = inf; self.F2[0, 0] = inf
            if de >= 1:
                f1 = (-int(self.o1) - int(self.e1) * idx[1:]).astype(np.int64)
                f2 = (-int(self.o2) - int(self.e2) * idx[1:]).astype(np.int64)
                self.F1[0, 1:de + 1] = f1.astype(it)
                self.F2[0, 1:de + 1] = f2.astype(it)
                self.H[0, 1:de + 1] = np.maximum(f1, f2).astype(it)

    # -------------------------------------------------------------- #
    def _row_band(self, dp_i: int, node_id: int):
        """band + snapping (ref :1305-1318)."""
        pn = self.pn
        if self.p.wb < 0:
            beg, end = 0, self.qlen
            beg_sn, end_sn = beg // pn, end // pn
            self.dp_beg[dp_i], self.dp_end[dp_i] = beg, end
            self.dp_beg_sn[dp_i], self.dp_end_sn[dp_i] = beg_sn, end_sn
            return beg_sn, end_sn, 0, end_sn
        beg = self._ad_beg(node_id); end = self._ad_end(node_id)
        beg_sn = beg // pn
        min_pre_beg_sn, max_pre_end_sn = 1 << 30, -1
        for pre_i in self.pre_index[dp_i]:
            min_pre_beg_sn = min(min_pre_beg_sn, int(self.dp_beg_sn[pre_i]))
            max_pre_end_sn = max(max_pre_end_sn, int(self.dp_end_sn[pre_i]))
        if beg_sn < min_pre_beg_sn:
            beg_sn = min_pre_beg_sn
        self.dp_beg_sn[dp_i] = beg_sn
        self.dp_beg[dp_i] = beg_sn * pn
        end_sn = end // pn
        self.dp_end_sn[dp_i] = end_sn
        self.dp_end[dp_i] = (end_sn + 1) * pn - 1
        return beg_sn, end_sn, min_pre_beg_sn, max_pre_end_sn

    def _merge_m(self, dst, src_row, beg_sn, end_sn, pre_i, is_first: bool,
                 local: bool):
        """Shifted-by-one M merge from one predecessor row (ref :1332-1342).

        Returns (_beg_sn, _end_sn) used so the E merge can reuse _beg_sn.
        """
        pn = self.pn
        pre_beg_sn = int(self.dp_beg_sn[pre_i])
        pre_end = int(self.dp_end[pre_i])
        pre_H = self.H[pre_i]
        if local:
            _beg_sn, _end_sn = 0, end_sn
        else:
            _beg_sn = beg_sn if pre_beg_sn < beg_sn else pre_beg_sn
            _end_sn = min((pre_end + 1) // pn, end_sn, self.dp_sn - 1)
            if is_first:
                if beg_sn < _beg_sn:
                    dst[beg_sn * pn:_beg_sn * pn] = self.inf_min
                cap = min(end_sn + 1, self.dp_sn - 1)
                if _end_sn < cap:
                    dst[(_end_sn + 1) * pn:(cap + 1) * pn] = self.inf_min
        if _end_sn >= _beg_sn:
            lo, hi = _beg_sn * pn, (_end_sn + 1) * pn
            cand = self._mbuf[:hi - lo]  # fully written before any read
            cand[1:] = pre_H[lo:hi - 1]
            if local:
                cand[0] = 0
            elif pre_beg_sn < beg_sn:
                cand[0] = pre_H[lo - 1]
            else:
                cand[0] = self.inf_min
            if is_first:
                dst[lo:hi] = cand
            else:
                np.maximum(dst[lo:hi], cand, out=dst[lo:hi])
        return _beg_sn, _end_sn

    def _merge_e(self, dsts, srcs_rows, beg_sn, end_sn, pre_i, _beg_sn,
                 is_first: bool, local: bool):
        """Same-column E merge (ref :1343-1350)."""
        pn = self.pn
        pre_end_sn = int(self.dp_end_sn[pre_i])
        _end_sn = min(pre_end_sn, end_sn)
        if is_first and not local:
            for dst in dsts:
                if beg_sn < _beg_sn:
                    dst[beg_sn * pn:_beg_sn * pn] = self.inf_min
                if _end_sn < end_sn:
                    dst[(_end_sn + 1) * pn:(end_sn + 1) * pn] = self.inf_min
        if _end_sn >= _beg_sn:
            lo, hi = _beg_sn * pn, (_end_sn + 1) * pn
            for dst, src in zip(dsts, srcs_rows):
                if is_first:
                    dst[lo:hi] = src[pre_i][lo:hi]
                else:
                    np.maximum(dst[lo:hi], src[pre_i][lo:hi], out=dst[lo:hi])

    def _set_f(self, F: np.ndarray, set_num: int, eS: np.ndarray):
        """Masked log-step in-register F prefix-max (ref SIMD_SET_F :664-699).

        Operates in-place on one pn-lane segment.
        """
        pn = self.pn
        inf = self.inf_min
        cov_bit = set_num
        for t in range(self.log_n):
            d = 1 << t
            if t > 0:
                cov_bit += d
            hi = pn - 1 if set_num == pn else min(cov_bit, pn - 1)
            # cand lanes outside [d, hi] are exactly inf_min (PRE_MIN/SUF_MIN
            # OR patterns); the unmasked SIMDMax therefore LIFTS any F lane
            # sitting below inf_min — semantics leak, must replicate
            # (hence the max-with-inf on the complement ranges below).
            if hi >= d:
                shifted = F[0:hi + 1 - d] - eS[t]  # pre-update F (copy)
                np.maximum(F[d:hi + 1], shifted, out=F[d:hi + 1])
                np.maximum(F[:d], inf, out=F[:d])
                if hi + 1 < pn:
                    np.maximum(F[hi + 1:], inf, out=F[hi + 1:])
            else:
                np.maximum(F, inf, out=F)

    def _set_f2(self, F2d: np.ndarray, set_num: int, e12S: np.ndarray):
        """_set_f on [2, pn] stacked (F1;F2) lanes with per-row eS — one
        set of numpy calls instead of two (the convex row runs this per
        segment, the hottest loop of the oracle)."""
        pn = self.pn
        inf = self.inf_min
        cov_bit = set_num
        for t in range(self.log_n):
            d = 1 << t
            if t > 0:
                cov_bit += d
            hi = pn - 1 if set_num == pn else min(cov_bit, pn - 1)
            if hi >= d:
                shifted = F2d[:, 0:hi + 1 - d] - e12S[:, t:t + 1]
                np.maximum(F2d[:, d:hi + 1], shifted,
                           out=F2d[:, d:hi + 1])
                np.maximum(F2d[:, :d], inf, out=F2d[:, :d])
                if hi + 1 < pn:
                    np.maximum(F2d[:, hi + 1:], inf, out=F2d[:, hi + 1:])
            else:
                np.maximum(F2d, inf, out=F2d)

    def _max_in_row(self, Hrow, beg_sn, end_sn):
        """row max + argmax with reference blend semantics (ref :1043-1057).

        Accumulator starts at segment end_sn; earlier segments replace on
        strict greater; lanes past qlen masked to inf_min; final scalar scan
        lowest-lane-first with strict greater.
        """
        pn = self.pn
        # visit order [end_sn, beg_sn, beg_sn+1, ...] with replace-on-
        # strict-greater == first occurrence of the lane max in that order
        # (np.argmax's tie rule); qi masking only affects segment qlen//pn
        # (rows never extend past it), matching the reference blends
        n_seg = end_sn - beg_sn + 1
        order = np.empty(n_seg, dtype=np.int64)
        order[0] = end_sn
        if n_seg > 1:
            order[1:] = np.arange(beg_sn, end_sn)
        M = Hrow[:(end_sn + 1) * pn].reshape(-1, pn)[order]
        if end_sn == self.qlen // pn:
            M[0][self._qi_all[end_sn * pn:(end_sn + 1) * pn] < 0] = \
                self.inf_min
        k = np.argmax(M, axis=0)
        lanes = np.arange(pn)
        a = M[k, lanes]
        b = self._qi_all[order[k] * pn + lanes]
        max_v = int(self.inf_min); max_i = -1
        for lane in range(pn):
            if int(a[lane]) > max_v:
                max_v = int(a[lane]); max_i = int(b[lane])
        return max_v, max_i

    def _ada_max_i(self, max_i: int, node_id: int):
        """adaptive band propagation to successors (ref :1274-1282)."""
        g = self.g
        out_i = max_i + 1
        for out_id in g.node[node_id].out_id:
            if out_i > g.node_id_to_max_pos_right[out_id]:
                g.node_id_to_max_pos_right[out_id] = out_i
            if out_i < g.node_id_to_max_pos_left[out_id]:
                g.node_id_to_max_pos_left[out_id] = out_i

    def _band_cells(self, dp_i: int) -> int:
        """The cells of row dp_i's lane-snapped band that lie in the
        matrix (columns 0..qlen): the DP work of that row."""
        return int(min(self.dp_end[dp_i], self.qlen) - self.dp_beg[dp_i] + 1)

    # -------------------------------------------------------------- #
    def run(self):
        p = self.p
        gm = p.gap_mode
        local = p.align_mode == LOCAL_MODE
        self._first_row()
        self.res.dp_cells = self._band_cells(0)
        g = self.g
        # the row max is needed by any consumer but unbanded global mode
        need_max = p.align_mode != GLOBAL_MODE or p.wb >= 0
        for index_i in range(self.beg_index + 1, self.end_index):
            if not self.index_map[index_i]:
                continue
            dp_i = index_i - self.beg_index
            node_id = int(g.index_to_node_id[index_i])
            if gm == LINEAR_GAP:
                self._row_lg(dp_i, node_id, local)
            elif gm == AFFINE_GAP:
                self._row_ag(dp_i, node_id, local)
            else:
                self._row_cg(dp_i, node_id, local)
            self.res.dp_cells += self._band_cells(dp_i)
            if need_max:
                beg_sn = int(self.dp_beg_sn[dp_i])
                end_sn = int(self.dp_end_sn[dp_i])
                mx, mi = self._max_in_row(self.H[dp_i], beg_sn,
                                          end_sn)
            else:
                mx, mi = None, None
            if p.align_mode == LOCAL_MODE:
                if mx > self.best_score:
                    self.best_score, self.best_i, self.best_j = \
                        mx, dp_i, mi
            elif p.align_mode == EXTEND_MODE:
                if mx > self.best_score:
                    self.best_score, self.best_i, self.best_j = \
                        mx, dp_i, mi
                    self.best_id = node_id
                elif p.zdrop > 0:
                    delta = (int(g.node_id_to_max_remain[self.best_id])
                             - int(g.node_id_to_max_remain[node_id]))
                    if (self.best_score - mx >
                            p.zdrop + p.gap_ext1
                            * abs(delta - (mi - self.best_j))):
                        break
            if p.wb >= 0:
                self._ada_max_i(mi, node_id)
        if p.align_mode == GLOBAL_MODE:
            self._global_get_max()
        self.res.best_score = int(self.best_score)
        if p.ret_cigar:
            if gm == LINEAR_GAP:
                self._backtrack_lg(local)
            elif gm == AFFINE_GAP:
                self._backtrack_ag(local)
            else:
                self._backtrack_cg(local)

    def _global_get_max(self):
        """best over sink predecessors at column min(qlen, dp_end) (ref :1284-1300)."""
        g = self.g
        for in_id in g.node[self.end_node_id].in_id:
            in_index = int(g.node_id_to_index[in_id])
            if not self.index_map[in_index]:
                continue
            dp_i = in_index - self.beg_index
            end = int(self.dp_end[dp_i]) if self.qlen > int(self.dp_end[dp_i]) \
                else self.qlen
            v = int(self.H[dp_i][end])
            if v > self.best_score:
                self.best_score = v
                self.best_i, self.best_j = dp_i, end

    # -------------------------------------------------------------- #
    def _row_cg(self, dp_i: int, node_id: int, local: bool):
        """one convex-gap row (ref abpoa_cg_dp :1302-1412 / macro :887-1010)."""
        pn = self.pn
        beg_sn, end_sn, min_pre_beg_sn, max_pre_end_sn = \
            self._row_band(dp_i, node_id)
        H = self.H[dp_i]; E1 = self.E1[dp_i]; E2 = self.E2[dp_i]
        F1 = self.F1[dp_i]; F2 = self.F2[dp_i]
        pres = self.pre_index[dp_i]
        _beg_sn = 0
        for k, pre_i in enumerate(pres):
            _beg_sn, _ = self._merge_m(H, None, beg_sn, end_sn, pre_i, k == 0,
                                       local)
            self._merge_e([E1, E2], [self.E1, self.E2], beg_sn, end_sn, pre_i,
                          _beg_sn, k == 0, local)
        # H += q
        lo, hi = beg_sn * pn, (end_sn + 1) * pn
        q = self.qp[self.g.node[node_id].base]
        H[lo:hi] += q[lo:hi]
        # F phase
        first1 = H[lo]  # pre-E-max carry quirk (ref :1381)
        first2 = first1
        it = self.it
        for sn_i in range(beg_sn, end_sn + 1):
            if local:
                set_num = pn
            elif sn_i > max_pre_end_sn:
                set_num = 2 if sn_i == max_pre_end_sn + 1 else 1
            else:
                set_num = pn
            s0, s1 = sn_i * pn, (sn_i + 1) * pn
            h = H[s0:s1]
            np.maximum(h, E1[s0:s1], out=h)
            np.maximum(h, E2[s0:s1], out=h)
            f2d = self._f2d  # copied out via F[s0:s1]=; rows (f1; f2)
            f1 = f2d[0]; f2 = f2d[1]
            f1[0] = it(first1 - self.oe1)
            np.subtract(h[:-1], self.oe1, out=f1[1:])
            f2[0] = it(first2 - self.oe2)
            np.subtract(h[:-1], self.oe2, out=f2[1:])
            self._set_f2(f2d, set_num, self._e12S)
            first1 = max(h[-1], it(f1[-1] + self.o1))
            first2 = max(h[-1], it(f2[-1] + self.o2))
            F1[s0:s1] = f1; F2[s0:s1] = f2
            np.maximum(h, f1, out=h)
            np.maximum(h, f2, out=h)
            if local:
                np.maximum(h, 0, out=h)
                e1n = np.maximum(E1[s0:s1] - self.e1, h - self.oe1)
                e2n = np.maximum(E2[s0:s1] - self.e2, h - self.oe2)
                E1[s0:s1] = np.maximum(e1n, 0)
                E2[s0:s1] = np.maximum(e2n, 0)
            else:
                E1[s0:s1] = np.maximum(E1[s0:s1] - self.e1, h - self.oe1)
                E2[s0:s1] = np.maximum(E2[s0:s1] - self.e2, h - self.oe2)

    def _row_ag(self, dp_i: int, node_id: int, local: bool):
        """one affine-gap row (ref macro simd_abpoa_ag_dp :781-885)."""
        pn = self.pn
        beg_sn, end_sn, min_pre_beg_sn, max_pre_end_sn = \
            self._row_band(dp_i, node_id)
        H = self.H[dp_i]; E1 = self.E1[dp_i]; F1 = self.F1[dp_i]
        pres = self.pre_index[dp_i]
        for k, pre_i in enumerate(pres):
            _beg_sn, _ = self._merge_m(H, None, beg_sn, end_sn, pre_i, k == 0,
                                       local)
            self._merge_e([E1], [self.E1], beg_sn, end_sn, pre_i, _beg_sn,
                          k == 0, local)
        lo, hi = beg_sn * pn, (end_sn + 1) * pn
        q = self.qp[self.g.node[node_id].base]
        H[lo:hi] += q[lo:hi]
        first1 = H[lo]
        it = self.it
        for sn_i in range(beg_sn, end_sn + 1):
            if local:
                set_num = pn
            elif sn_i > max_pre_end_sn:
                set_num = 2 if sn_i == max_pre_end_sn + 1 else 1
            else:
                set_num = pn
            s0, s1 = sn_i * pn, (sn_i + 1) * pn
            h = H[s0:s1]
            f1 = self._fbuf1  # copied out via F1[s0:s1]=
            f1[0] = it(first1 - self.oe1); f1[1:] = h[:-1] - self.oe1
            self._set_f(f1, set_num, self.e1S)
            first1 = max(h[-1], it(f1[-1] + self.o1))
            np.maximum(h, E1[s0:s1], out=h)
            tmp = h.copy()
            F1[s0:s1] = f1
            if local:
                hh = np.maximum(np.maximum(h, f1), 0)
                H[s0:s1] = hh
                e1n = np.maximum(E1[s0:s1] - self.e1, hh - self.oe1)
                E1[s0:s1] = np.where(hh == tmp, e1n, it(0))
            else:
                hh = np.maximum(h, f1)
                H[s0:s1] = hh
                e1n = np.maximum(E1[s0:s1] - self.e1, hh - self.oe1)
                E1[s0:s1] = np.where(hh == tmp, e1n, self.inf_min)

    def _row_lg(self, dp_i: int, node_id: int, local: bool):
        """one linear-gap row (ref macro simd_abpoa_lg_dp :701-779).

        M and E fold into H: H = max(shift(preH)+q, preH-e1) per predecessor,
        then F folds into H via the same masked scan.
        """
        pn = self.pn
        beg_sn, end_sn, min_pre_beg_sn, max_pre_end_sn = \
            self._row_band(dp_i, node_id)
        H = self.H[dp_i]
        q = self.qp[self.g.node[node_id].base]
        pres = self.pre_index[dp_i]
        it = self.it
        for k, pre_i in enumerate(pres):
            pre_beg_sn = int(self.dp_beg_sn[pre_i])
            pre_end = int(self.dp_end[pre_i])
            pre_H = self.H[pre_i]
            if local:
                _beg_sn, _end_sn = 0, end_sn
            else:
                _beg_sn = beg_sn if pre_beg_sn < beg_sn else pre_beg_sn
                _end_sn = min((pre_end + 1) // pn, end_sn, self.dp_sn - 1)
                if k == 0:
                    if beg_sn < _beg_sn:
                        H[beg_sn * pn:_beg_sn * pn] = self.inf_min
                    cap = min(end_sn + 1, self.dp_sn - 1)
                    if _end_sn < cap:
                        H[(_end_sn + 1) * pn:(cap + 1) * pn] = self.inf_min
            if _end_sn >= _beg_sn:
                lo, hi = _beg_sn * pn, (_end_sn + 1) * pn
                cand = self._mbuf[:hi - lo]  # fully written before read
                cand[1:] = pre_H[lo:hi - 1]
                if local:
                    cand[0] = 0
                elif pre_beg_sn < beg_sn:
                    cand[0] = pre_H[lo - 1]
                else:
                    cand[0] = self.inf_min
                cand += q[lo:hi]
                e_cand = pre_H[lo:hi] - self.e1
                np.maximum(cand, e_cand, out=cand)
                if k == 0:
                    H[lo:hi] = cand
                else:
                    np.maximum(H[lo:hi], cand, out=H[lo:hi])
        # F phase folded into H (ref :762-778)
        first = H[beg_sn * pn]  # lane 0 kept, others -inf
        first_vec = np.full(pn, self.inf_min, dtype=it)
        first_vec[0] = first
        for sn_i in range(beg_sn, end_sn + 1):
            if local:
                set_num = pn
            elif sn_i > max_pre_end_sn:
                set_num = 1 if sn_i == max_pre_end_sn + 1 else 0
            else:
                set_num = pn
            s0, s1 = sn_i * pn, (sn_i + 1) * pn
            h = H[s0:s1]
            np.maximum(h, first_vec, out=h)
            self._set_f(h, set_num, self.e1S)
            first_vec = np.full(pn, self.inf_min, dtype=it)
            first_vec[0] = it(h[-1] - self.e1)
        if local:
            H[:(end_sn + 1) * pn] = np.maximum(H[:(end_sn + 1) * pn], 0)


    # -------------------------------------------------------------- #
    # backtrack (ref :109-429 macros, :1415-1554 function)
    def _bt_common_start(self):
        res = self.res
        i, j = self.best_i, self.best_j
        cigar: list = []
        if j < self.qlen:
            cg.push_cigar(cigar, cg.CINS, self.qlen - j, -1, self.qlen - 1)
        return i, j, cigar

    def _bt_finish(self, cigar, i, j, start_i, start_j):
        res = self.res
        if j > 0:
            cg.push_cigar(cigar, cg.CINS, j, -1, j - 1)
        if not self.p.rev_cigar:
            cigar.reverse()
        res.cigar = cigar
        g = self.g
        res.node_e = int(g.index_to_node_id[self.best_i + self.beg_index])
        res.query_e = self.best_j - 1
        res.node_s = int(g.index_to_node_id[start_i + self.beg_index])
        res.query_s = start_j - 1

    def _row_base(self, i, nid):
        return self.g.node[nid].base

    def _in_band(self, pre_i, col):
        return self.dp_beg[pre_i] <= col <= self.dp_end[pre_i]

    def _backtrack_cg(self, local: bool):
        p = self.p; g = self.g; res = self.res
        M_OP, E1_OP, E2_OP, E_OP = 0x1, 0x2, 0x4, 0x6
        F1_OP, F2_OP, F_OP, ALL = 0x8, 0x10, 0x18, 0x1f
        H, E1, E2, F1, F2 = self.H, self.E1, self.E2, self.F1, self.F2
        i, j, cigar = self._bt_common_start()
        start_i, start_j = i, j
        nid = int(g.index_to_node_id[i + self.beg_index])
        cur_op = ALL
        indel_first = True
        mat = self.mat
        while i > 0 and j > 0:
            if local and int(H[i][j]) == 0:
                break
            start_i, start_j = i, j
            base = self._row_base(i, nid)
            s = int(mat[base][self.query[j - 1]])
            is_match = base == self.query[j - 1]
            hit = False
            if (cur_op & M_OP) and not indel_first:
                for pre_i in self.pre_index[i]:
                    if not self._in_band(pre_i, j - 1):
                        continue
                    if int(H[pre_i][j - 1]) + s == int(H[i][j]):
                        cg.push_cigar(cigar, cg.CMATCH, 1, nid, j - 1)
                        i = pre_i; j -= 1
                        nid = int(g.index_to_node_id[i + self.beg_index])
                        cur_op = ALL; hit = True
                        res.n_aln_bases += 1
                        res.n_matched_bases += 1 if is_match else 0
                        break
            if not hit and (cur_op & E_OP):
                for pre_i in self.pre_index[i]:
                    if not self._in_band(pre_i, j):
                        continue
                    if cur_op & E1_OP:
                        if cur_op & M_OP:
                            if int(H[i][j]) == int(E1[pre_i][j]):
                                if int(H[pre_i][j]) - int(self.oe1) == int(E1[pre_i][j]):
                                    cur_op = M_OP | F_OP
                                else:
                                    cur_op = E1_OP
                                cg.push_cigar(cigar, cg.CDEL, 1, nid, j - 1)
                                i = pre_i
                                nid = int(g.index_to_node_id[i + self.beg_index])
                                hit = True
                                break
                        else:
                            if int(E1[i][j]) == int(E1[pre_i][j]) - int(self.e1):
                                if int(H[pre_i][j]) - int(self.oe1) == int(E1[pre_i][j]):
                                    cur_op = M_OP | F_OP
                                else:
                                    cur_op = E1_OP
                                cg.push_cigar(cigar, cg.CDEL, 1, nid, j - 1)
                                i = pre_i
                                nid = int(g.index_to_node_id[i + self.beg_index])
                                hit = True
                                break
                    if cur_op & E2_OP:
                        if cur_op & M_OP:
                            if int(H[i][j]) == int(E2[pre_i][j]):
                                if int(H[pre_i][j]) - int(self.oe2) == int(E2[pre_i][j]):
                                    cur_op = M_OP | F_OP
                                else:
                                    cur_op = E2_OP
                                cg.push_cigar(cigar, cg.CDEL, 1, nid, j - 1)
                                i = pre_i
                                nid = int(g.index_to_node_id[i + self.beg_index])
                                hit = True
                                break
                        else:
                            if int(E2[i][j]) == int(E2[pre_i][j]) - int(self.e2):
                                if int(H[pre_i][j]) - int(self.oe2) == int(E2[pre_i][j]):
                                    cur_op = M_OP | F_OP
                                else:
                                    cur_op = E2_OP
                                cg.push_cigar(cigar, cg.CDEL, 1, nid, j - 1)
                                i = pre_i
                                nid = int(g.index_to_node_id[i + self.beg_index])
                                hit = True
                                break
            if not hit and (cur_op & F_OP):
                if cur_op & F1_OP:
                    if cur_op & M_OP:
                        if int(H[i][j]) == int(F1[i][j]):
                            if int(H[i][j - 1]) - int(self.oe1) == int(F1[i][j]):
                                cur_op = M_OP | E_OP; hit = True
                            elif int(F1[i][j - 1]) - int(self.e1) == int(F1[i][j]):
                                cur_op = F1_OP; hit = True
                    else:
                        if int(H[i][j - 1]) - int(self.oe1) == int(F1[i][j]):
                            cur_op = M_OP | E_OP; hit = True
                        elif int(F1[i][j - 1]) - int(self.e1) == int(F1[i][j]):
                            cur_op = F1_OP; hit = True
                if not hit and (cur_op & F2_OP):
                    if cur_op & M_OP:
                        if int(H[i][j]) == int(F2[i][j]):
                            if int(H[i][j - 1]) - int(self.oe2) == int(F2[i][j]):
                                cur_op = M_OP | E_OP; hit = True
                            elif int(F2[i][j - 1]) - int(self.e2) == int(F2[i][j]):
                                cur_op = F2_OP; hit = True
                    else:
                        if int(H[i][j - 1]) - int(self.oe2) == int(F2[i][j]):
                            cur_op = M_OP | E_OP; hit = True
                        elif int(F2[i][j - 1]) - int(self.e2) == int(F2[i][j]):
                            cur_op = F2_OP; hit = True
                if hit:
                    cg.push_cigar(cigar, cg.CINS, 1, nid, j - 1)
                    j -= 1
                    res.n_aln_bases += 1
            if not hit and (cur_op & M_OP) and indel_first:
                for pre_i in self.pre_index[i]:
                    if not self._in_band(pre_i, j - 1):
                        continue
                    if int(H[pre_i][j - 1]) + s == int(H[i][j]):
                        cg.push_cigar(cigar, cg.CMATCH, 1, nid, j - 1)
                        i = pre_i; j -= 1
                        nid = int(g.index_to_node_id[i + self.beg_index])
                        cur_op = ALL; hit = True
                        res.n_aln_bases += 1
                        res.n_matched_bases += 1 if is_match else 0
                        indel_first = False
                        break
            if not hit:
                raise RuntimeError("Error in cg_backtrack.")
        self._bt_finish(cigar, i, j, start_i, start_j)

    def _backtrack_ag(self, local: bool):
        p = self.p; g = self.g; res = self.res
        M_OP, E1_OP, E_OP = 0x1, 0x2, 0x6
        F1_OP, F_OP, ALL = 0x8, 0x18, 0x1f
        H, E1, F1 = self.H, self.E1, self.F1
        i, j, cigar = self._bt_common_start()
        start_i, start_j = i, j
        nid = int(g.index_to_node_id[i + self.beg_index])
        cur_op = ALL
        indel_first = True
        mat = self.mat
        while i > 0 and j > 0:
            if local and int(H[i][j]) == 0:
                break
            start_i, start_j = i, j
            base = self._row_base(i, nid)
            s = int(mat[base][self.query[j - 1]])
            is_match = base == self.query[j - 1]
            hit = False
            if (cur_op & M_OP) and not indel_first:
                for pre_i in self.pre_index[i]:
                    if not self._in_band(pre_i, j - 1):
                        continue
                    if int(H[pre_i][j - 1]) + s == int(H[i][j]):
                        cg.push_cigar(cigar, cg.CMATCH, 1, nid, j - 1)
                        i = pre_i; j -= 1
                        nid = int(g.index_to_node_id[i + self.beg_index])
                        cur_op = ALL; hit = True
                        res.n_aln_bases += 1
                        res.n_matched_bases += 1 if is_match else 0
                        break
            if not hit and (cur_op & E1_OP):
                for pre_i in self.pre_index[i]:
                    if not self._in_band(pre_i, j):
                        continue
                    if cur_op & M_OP:
                        if int(H[i][j]) == int(E1[pre_i][j]):
                            if int(H[pre_i][j]) - int(self.oe1) == int(E1[pre_i][j]):
                                cur_op = M_OP | F_OP
                            else:
                                cur_op = E1_OP
                            cg.push_cigar(cigar, cg.CDEL, 1, nid, j - 1)
                            i = pre_i
                            nid = int(g.index_to_node_id[i + self.beg_index])
                            hit = True
                            break
                    else:
                        if int(E1[i][j]) == int(E1[pre_i][j]) - int(self.e1):
                            if int(H[pre_i][j]) - int(self.oe1) == int(E1[pre_i][j]):
                                cur_op = M_OP | F_OP
                            else:
                                cur_op = E1_OP
                            cg.push_cigar(cigar, cg.CDEL, 1, nid, j - 1)
                            i = pre_i
                            nid = int(g.index_to_node_id[i + self.beg_index])
                            hit = True
                            break
            if not hit and (cur_op & F_OP):
                if cur_op & M_OP:
                    if int(H[i][j]) == int(F1[i][j]):
                        if int(H[i][j - 1]) - int(self.oe1) == int(F1[i][j]):
                            cur_op = M_OP | E_OP; hit = True
                        elif int(F1[i][j - 1]) - int(self.e1) == int(F1[i][j]):
                            cur_op = F1_OP; hit = True
                else:
                    if int(H[i][j - 1]) - int(self.oe1) == int(F1[i][j]):
                        cur_op = M_OP | E_OP; hit = True
                    elif int(F1[i][j - 1]) - int(self.e1) == int(F1[i][j]):
                        cur_op = F1_OP; hit = True
                if hit:
                    cg.push_cigar(cigar, cg.CINS, 1, nid, j - 1)
                    j -= 1
                    res.n_aln_bases += 1
            if not hit and (cur_op & M_OP) and indel_first:
                for pre_i in self.pre_index[i]:
                    if not self._in_band(pre_i, j - 1):
                        continue
                    if int(H[pre_i][j - 1]) + s == int(H[i][j]):
                        cg.push_cigar(cigar, cg.CMATCH, 1, nid, j - 1)
                        i = pre_i; j -= 1
                        nid = int(g.index_to_node_id[i + self.beg_index])
                        cur_op = ALL; hit = True
                        res.n_aln_bases += 1
                        res.n_matched_bases += 1 if is_match else 0
                        indel_first = False
                        break
            if not hit:
                raise RuntimeError("Error in ag_backtrack.")
        self._bt_finish(cigar, i, j, start_i, start_j)

    def _backtrack_lg(self, local: bool):
        g = self.g; res = self.res
        H = self.H
        i, j, cigar = self._bt_common_start()
        start_i, start_j = i, j
        nid = int(g.index_to_node_id[i + self.beg_index])
        indel_first = True
        mat = self.mat
        while i > 0 and j > 0:
            if local and int(H[i][j]) == 0:
                break
            start_i, start_j = i, j
            base = self._row_base(i, nid)
            s = int(mat[base][self.query[j - 1]])
            is_match = base == self.query[j - 1]
            hit = False
            if not indel_first:
                for pre_i in self.pre_index[i]:
                    if not self._in_band(pre_i, j - 1):
                        continue
                    if int(H[pre_i][j - 1]) + s == int(H[i][j]):
                        cg.push_cigar(cigar, cg.CMATCH, 1, nid, j - 1)
                        i = pre_i; j -= 1
                        nid = int(g.index_to_node_id[i + self.beg_index])
                        hit = True
                        res.n_aln_bases += 1
                        res.n_matched_bases += 1 if is_match else 0
                        break
            if not hit:
                for pre_i in self.pre_index[i]:
                    if not self._in_band(pre_i, j):
                        continue
                    if int(H[pre_i][j]) - int(self.e1) == int(H[i][j]):
                        cg.push_cigar(cigar, cg.CDEL, 1, nid, j - 1)
                        i = pre_i
                        nid = int(g.index_to_node_id[i + self.beg_index])
                        hit = True
                        break
            if not hit:
                if int(H[i][j - 1]) - int(self.e1) == int(H[i][j]):
                    cg.push_cigar(cigar, cg.CINS, 1, nid, j - 1)
                    j -= 1
                    hit = True
                    res.n_aln_bases += 1
            if not hit and indel_first:
                for pre_i in self.pre_index[i]:
                    if not self._in_band(pre_i, j - 1):
                        continue
                    if int(H[pre_i][j - 1]) + s == int(H[i][j]):
                        cg.push_cigar(cigar, cg.CMATCH, 1, nid, j - 1)
                        i = pre_i; j -= 1
                        nid = int(g.index_to_node_id[i + self.beg_index])
                        hit = True
                        res.n_aln_bases += 1
                        res.n_matched_bases += 1 if is_match else 0
                        indel_first = False
                        break
            if not hit:
                raise RuntimeError("Error in lg_backtrack.")
        self._bt_finish(cigar, i, j, start_i, start_j)
