"""Dense export of a POA graph for the batched device DP (numpy only).

Copy of the numpy half of ``abpoa_tpu/align/engine_jax.py``
(``score_dispatch``, ``DenseGraph``, ``subgraph_index_map``,
``export_dense``, ``repad_dense``, ``make_pallas_inputs``, ``pick_WB``):
pointer-chased adjacency becomes fixed-capacity int32 arrays plus
validity masks, in topological index order, and ``make_pallas_inputs``
turns one export into the per-round input tuple of the band and
full-width DP kernels (``ops/band_dp.py``, ``ops/fw_dp.py``).
``tests/test_torch_host.py`` pins the tuple equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from ..ops import layout as L


class PallasDPConfig(NamedTuple):
    """Static geometry of one round's DP inputs (the JAX package's
    ``ops/dp_pallas.py`` ``PallasDPConfig``)."""
    gap_mode: int
    align_mode: int
    pn: int
    R: int       # padded rows
    WB: int      # band tile width (multiple of pn)
    Wq: int      # padded query-profile width (qlen+1 rounded up to 128)
    P: int
    O: int
    m: int
    use_zdrop: bool
    bt_lmax: int = 0   # >0: the walk runs in-kernel, <= bt_lmax steps


def _bucket(x: int, lo: int) -> int:
    return max(lo, 1 << (int(x) - 1).bit_length())


def score_dispatch(params, gn: int, qlen: int):
    """pn + inf_min from the oracle's 16/32-bit dispatch (shared single
    source of truth; the device engines compute int32 but inherit the lane
    geometry so band snapping matches the oracle bit-exactly)."""
    from .engine_np import score_width_dispatch
    _bits, pn, _log_n, inf_min = score_width_dispatch(params, gn, qlen)
    return pn, inf_min


@dataclasses.dataclass
class DenseGraph:
    """Host-side dense export of one POAGraph for the device DP."""
    n_rows: int
    qlen: int
    pn: int
    inf_min: int
    bases: np.ndarray
    pre_idx: np.ndarray
    pre_n: np.ndarray
    out_idx: np.ndarray
    out_n: np.ndarray
    remain: np.ndarray
    mpl: np.ndarray
    mpr: np.ndarray
    qcol: np.ndarray
    pre_index: list | None   # ragged, for host backtrack (lazy)
    R: int
    W: int
    P: int
    O: int
    beg_index: int = 0       # subgraph: dp row 0 = this topo index
    rowmask: np.ndarray | None = None  # subgraph reachability (None = all)


def subgraph_index_map(graph, beg_index: int, end_index: int) -> np.ndarray:
    """Reachability mask within the subgraph interval
    (ref simd_abpoa_align_sequence_to_subgraph :1650-1660). CSR-based;
    the row-by-row sweep runs in C when the native lib is available
    (~1.3 ms/window in numpy was the seeded path's hottest host item)."""
    from .. import native
    c = graph.build_csr()
    out_flat = c["out_flat"]
    out_off = c["out_off"]
    if native.get_lib() is not None:
        mask = native.subgraph_reach(
            graph.node_n, beg_index, end_index,
            np.ascontiguousarray(out_flat, dtype=np.int32),
            np.ascontiguousarray(out_off, dtype=np.int32),
            np.ascontiguousarray(graph.index_to_node_id[:graph.node_n],
                                 dtype=np.int32),
            np.ascontiguousarray(graph.node_id_to_index[:graph.node_n],
                                 dtype=np.int32))
        return mask.astype(bool)
    n2i = np.asarray(graph.node_id_to_index, dtype=np.int64)
    index_map = np.zeros(graph.node_n, dtype=bool)
    index_map[beg_index] = index_map[end_index] = True
    i2n = graph.index_to_node_id
    for i in range(beg_index, end_index - 1):
        if not index_map[i]:
            continue
        nid = int(i2n[i])
        index_map[n2i[out_flat[out_off[nid]:out_off[nid + 1]]]] = True
    return index_map


def export_dense(graph, params, query, min_R=64, min_W=256,
                 force_R=None, force_W=None, force_P=None,
                 force_O=None, beg_index=0, end_index=None,
                 index_map=None) -> DenseGraph:
    """Flatten the DAG (in topo index order) into padded arrays.

    force_* pin the padded capacities so a batch of instances shares one
    static kernel shape (parallel/batch.py re-pads a round's group to its
    common maximum). beg_index/end_index/index_map restrict the export to a
    subgraph interval (anchored/windowed POA): dp row t = topo index
    beg_index+t; adjacency is filtered by the reachability map exactly like
    the oracle's pre_index (engine_np :177-184).
    """
    full = end_index is None
    if full:
        end_index = graph.node_n - 1
    n = end_index - beg_index + 1
    qlen = len(query)
    pn, inf_min = score_dispatch(params, n, qlen)
    i2n = graph.index_to_node_id
    n2i = graph.node_id_to_index
    # rows bucket: power-of-two up to 512, then 64-steps — a pure pow2
    # ladder would jump 800-row graphs straight to R=1024 and push the
    # band kernel out of its G=16 SMEM budget (fits up to R~832)
    R = force_R if force_R else (
        _bucket(n, min_R) if n <= 512 else (int(n) + 63) // 64 * 64)
    W_needed = ((qlen + pn) // pn) * pn
    W = force_W if force_W else _bucket(W_needed, min_W)
    banded = params.wb >= 0

    ids = np.asarray(i2n[beg_index:end_index + 1], dtype=np.int64)
    bases = np.zeros(R, dtype=np.int32)
    csr = getattr(graph, "_csr", None)
    if not full:
        # subgraph export: filtered adjacency, vectorized over the CSR
        # snapshot (walking Node objects materialized the native store
        # per window, dominating the seeded pipeline's host time)
        if index_map is None:
            index_map = subgraph_index_map(graph, beg_index, end_index)
        c = graph.build_csr()
        rowmask = np.zeros(R, dtype=np.int32)
        rowmask[:n] = index_map[beg_index:end_index + 1]
        n2i_np = np.asarray(n2i, dtype=np.int64)
        bases[:n] = c["bases"][ids]
        row_live = index_map[beg_index:end_index + 1]

        def _filtered(flat, off, cnt, also_map: bool):
            raw_cnt = cnt[ids].astype(np.int64)
            s = np.repeat(off[:-1][ids].astype(np.int64), raw_cnt)
            w = np.arange(len(s)) - np.repeat(
                np.cumsum(raw_cnt) - raw_cnt, raw_cnt)
            tgt = n2i_np[flat[s + w]]
            rows = np.repeat(np.arange(n), raw_cnt)
            keep = (row_live[rows] & (tgt >= beg_index)
                    & (tgt <= end_index))
            if also_map:
                keep &= index_map[tgt]
            rows_k = rows[keep]
            vals = (tgt[keep] - beg_index).astype(np.int32)
            counts = np.bincount(rows_k, minlength=n).astype(np.int32)
            starts = np.concatenate(
                ([0], np.cumsum(counts)[:-1])).astype(np.int64)
            pos = np.arange(len(rows_k)) - starts[rows_k]
            return rows_k, pos, vals, counts

        rin, pin, vin, pre_cnt = _filtered(c["in_flat"], c["in_off"],
                                           c["in_cnt"], True)
        rout, pout, vout, out_cnt = _filtered(c["out_flat"], c["out_off"],
                                              c["out_cnt"], False)
        P = force_P if force_P else _bucket(
            max(int(pre_cnt.max(initial=1)), 1), 2)
        O = force_O if force_O else _bucket(
            max(int(out_cnt.max(initial=1)), 1), 2)
        pre_idx = np.zeros((R, P), dtype=np.int32)
        pre_n = np.zeros(R, dtype=np.int32)
        out_idx = np.zeros((R, O), dtype=np.int32)
        out_n = np.zeros(R, dtype=np.int32)
        pre_n[:n] = pre_cnt
        out_n[:n] = out_cnt
        pre_idx[rin, pin] = vin
        out_idx[rout, pout] = vout
        remain = np.zeros(R, dtype=np.int32)
        mpl = np.zeros(R, dtype=np.int32)
        mpr = np.zeros(R, dtype=np.int32)
        if graph.node_id_to_max_remain is not None:
            remain[:n] = graph.node_id_to_max_remain[ids]
        if banded:
            mpl[:n] = graph.node_id_to_max_pos_left[ids]
            mpr[:n] = graph.node_id_to_max_pos_right[ids]
        qcol = np.zeros(W, dtype=np.int32)
        qcol[1:qlen + 1] = np.asarray(query, dtype=np.int32)
        dg = DenseGraph(n, qlen, pn, inf_min, bases, pre_idx, pre_n,
                        out_idx, out_n, remain, mpl, mpr, qcol,
                        None, R, W, P, O)
        dg.beg_index = beg_index
        dg.rowmask = rowmask
        return dg
    if (csr is not None and graph.is_topological_sorted
            and csr["n"] == n):
        # reuse the flat adjacency snapshot built by topological_sort
        bases[:n] = csr["bases"][ids]
        pre_cnt = csr["in_cnt"][ids]
        out_cnt = csr["out_cnt"][ids]
        s_in = np.repeat(csr["in_off"][:-1][ids], pre_cnt)
        s_out = np.repeat(csr["out_off"][:-1][ids], out_cnt)
        w_in = np.arange(len(s_in)) - np.repeat(
            np.cumsum(pre_cnt) - pre_cnt, pre_cnt)
        w_out = np.arange(len(s_out)) - np.repeat(
            np.cumsum(out_cnt) - out_cnt, out_cnt)
        flat_in = csr["in_flat"][s_in + w_in].astype(np.int64)
        flat_out = csr["out_flat"][s_out + w_out].astype(np.int64)
    else:
        node = graph.node
        in_lists = [node[int(nid)].in_id for nid in ids]
        out_lists_ = [node[int(nid)].out_id for nid in ids]
        pre_cnt = np.fromiter(map(len, in_lists), dtype=np.int32, count=n)
        out_cnt = np.fromiter(map(len, out_lists_), dtype=np.int32, count=n)
        bases[:n] = np.fromiter((node[int(nid)].base for nid in ids),
                                dtype=np.int32, count=n)
        flat_in = np.fromiter((x for lst in in_lists for x in lst),
                              dtype=np.int64, count=int(pre_cnt.sum()))
        flat_out = np.fromiter((x for lst in out_lists_ for x in lst),
                               dtype=np.int64, count=int(out_cnt.sum()))
    P = force_P if force_P else _bucket(max(int(pre_cnt.max(initial=1)), 1),
                                        2)
    O = force_O if force_O else _bucket(max(int(out_cnt.max(initial=1)), 1),
                                        2)
    n2i_np = np.asarray(n2i, dtype=np.int64)
    pre_idx = np.zeros((R, P), dtype=np.int32)
    pre_n = np.zeros(R, dtype=np.int32)
    out_idx = np.zeros((R, O), dtype=np.int32)
    out_n = np.zeros(R, dtype=np.int32)
    pre_n[:n] = pre_cnt
    out_n[:n] = out_cnt
    rows_in = np.repeat(np.arange(n), pre_cnt)
    offs_in = np.cumsum(pre_cnt) - pre_cnt
    cols_in = np.arange(len(flat_in)) - np.repeat(offs_in, pre_cnt)
    pre_idx[rows_in, cols_in] = n2i_np[flat_in]
    rows_out = np.repeat(np.arange(n), out_cnt)
    offs_out = np.cumsum(out_cnt) - out_cnt
    cols_out = np.arange(len(flat_out)) - np.repeat(offs_out, out_cnt)
    out_idx[rows_out, cols_out] = n2i_np[flat_out]
    pre_lists = None  # built lazily for the host backtrack only

    remain = np.zeros(R, dtype=np.int32)
    mpl = np.zeros(R, dtype=np.int32)
    mpr = np.zeros(R, dtype=np.int32)
    if graph.node_id_to_max_remain is not None:
        remain[:n] = graph.node_id_to_max_remain[np.asarray(i2n[:n],
                                                            dtype=np.int64)]
    if banded:
        mpl[:n] = graph.node_id_to_max_pos_left[np.asarray(i2n[:n],
                                                           dtype=np.int64)]
        mpr[:n] = graph.node_id_to_max_pos_right[np.asarray(i2n[:n],
                                                            dtype=np.int64)]
    qcol = np.zeros(W, dtype=np.int32)
    qcol[1:qlen + 1] = np.asarray(query, dtype=np.int32)
    return DenseGraph(n, qlen, pn, inf_min, bases, pre_idx, pre_n,
                      out_idx, out_n, remain, mpl, mpr, qcol,
                      pre_lists, R, W, P, O)


def repad_dense(dg: DenseGraph, R: int, W: int, P: int, O: int) -> DenseGraph:
    """Re-pad an exported DenseGraph to a batch group's common capacities
    without re-walking the graph."""
    if (R, W, P, O) == (dg.R, dg.W, dg.P, dg.O):
        return dg
    n = dg.n_rows

    def padv(a, size):
        out = np.zeros(size, dtype=a.dtype)
        out[:len(a)] = a
        return out

    def padm(a, rows, cols):
        out = np.zeros((rows, cols), dtype=a.dtype)
        out[:a.shape[0], :a.shape[1]] = a
        return out

    return DenseGraph(n, dg.qlen, dg.pn, dg.inf_min,
                      padv(dg.bases, R), padm(dg.pre_idx, R, P),
                      padv(dg.pre_n, R), padm(dg.out_idx, R, O),
                      padv(dg.out_n, R), padv(dg.remain, R),
                      padv(dg.mpl, R), padv(dg.mpr, R),
                      padv(dg.qcol, W), dg.pre_index, R, W, P, O,
                      dg.beg_index,
                      padv(dg.rowmask, R) if dg.rowmask is not None
                      else None)




def _round_up(x: int, m: int) -> int:
    return (int(x) + m - 1) // m * m


def make_pallas_inputs(dg: DenseGraph, params, WB: int, force_Wq=None,
                       bt_lmax=0):
    """Build the flattened input arrays of one round for the band and
    full-width DP kernels (ops/band_dp.py, ops/fw_dp.py).

    Control arrays use narrow dtypes (int8/int16, widened on the device),
    which keeps the per-round upload small. The query profile travels as
    [Wq] int8 codes; scal carries the score matrix flattened at its tail
    (the kernels' wrappers build the profile on the device)."""
    qlen = dg.qlen
    Wq = force_Wq if force_Wq else _round_up(qlen + 1, 128)
    w = qlen if params.wb < 0 else params.wb + int(params.wf * qlen)
    m = params.m
    scal = np.zeros(L.S_NSCAL + m * m, dtype=np.int32)
    scal[L.S_QLEN] = qlen
    scal[L.S_NROWS] = dg.n_rows
    scal[L.S_W] = w
    scal[L.S_INF] = dg.inf_min
    scal[L.S_REMEND] = dg.remain[dg.n_rows - 1]
    scal[L.S_E1] = params.gap_ext1
    scal[L.S_O1] = params.gap_open1
    scal[L.S_OE1] = params.gap_oe1
    scal[L.S_E2] = params.gap_ext2
    scal[L.S_O2] = params.gap_open2
    scal[L.S_OE2] = params.gap_oe2
    scal[L.S_ZDROP] = params.zdrop
    scal[L.S_DPSN] = qlen // dg.pn + 1
    scal[L.S_NSCAL:] = np.asarray(params.mat, dtype=np.int64).reshape(-1)
    # qp[k, 0] and cols > qlen are zeroed on device via the column masks
    qcodes = np.zeros(Wq, dtype=np.int8)
    qcodes[1:qlen + 1] = dg.qcol[1:qlen + 1]
    narrow = np.int16 if max(qlen, dg.R) < 32000 else np.int32
    cfg = PallasDPConfig(
        gap_mode=params.gap_mode, align_mode=params.align_mode,
        pn=dg.pn, R=dg.R, WB=WB, Wq=Wq, P=dg.P, O=dg.O, m=m,
        use_zdrop=params.zdrop > 0, bt_lmax=bt_lmax)
    if dg.rowmask is not None:
        rowmask = dg.rowmask.astype(np.int8)
    else:
        rowmask = np.ones(dg.R, dtype=np.int8)
    # edge counts travel as `narrow` too: a node can have more than 127
    # in- or out-edges (the sink of a batch of reads ending apart)
    return cfg, (scal, dg.bases.astype(np.int8),
                 dg.pre_idx.reshape(-1).astype(narrow),
                 dg.pre_n.astype(narrow),
                 dg.out_idx.reshape(-1).astype(narrow),
                 dg.out_n.astype(narrow), dg.remain.astype(narrow),
                 qcodes, dg.mpl.astype(narrow), dg.mpr.astype(narrow),
                 rowmask)


def pick_WB(params, qlen: int, pn: int) -> int:
    """Static band-tile width (any multiple of pn): the adaptive band grows
    well beyond 2w when max_pos hints spread across graph branches (observed
    up to ~8 pn-segments on the 700 bp fixtures), so size generously and let
    the overflow flag route outliers to the oracle."""
    w = params.wb + int(params.wf * qlen)
    need = min(4 * w + 8 * pn, qlen + 1 + 2 * pn)
    need = max(need, 4 * pn)
    return max(128, (need + 127) // 128 * 128)
