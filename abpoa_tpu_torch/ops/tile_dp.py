"""Banded POA DP over row-relative [R, WB] tiles, with the walk.

Counterpart of ``pallas_poa_dp_batch`` / ``make_dp_kernel`` in
``abpoa_tpu/ops/dp_pallas.py`` (the v1 banded-tile kernel). The CUDA
kernel is ``csrc/tile_dp.cu``; ``tile_poa_dp_batch_ref`` is its plain
PyTorch version, batched over instances.

What is computed, per instance: the adaptive-banded DP of one query
against the whole graph in topological order. Lane l of row t holds
query column ``beg_sn[t]*pn + l`` (row-relative tiles, unlike the band
kernels' ``c mod WB`` window); a predecessor row is read shifted by
``t_off - pre_beg_sn*pn`` with inf outside its tile. The band bounds
beg/end_sn and the band state mpl/mpr (pushed along out-edges, starting
from copies of mpl0/mpr0) are outputs for every row. A row whose band
outgrows the tile sets M_OVFL and is clamped to it. Extend mode tracks
the best row maximum and stops on z-drop; global mode takes the best
cell over the sink's predecessors. The walk (bt_lmax > 0; M -> D -> I
order, indel first, cur_op gating) emits int64 step words
``op|row<<2|col<<32``.

The plain version writes every tile, H, E1, E2, F1, F2 ([B, R, WB], 1,
3 or 5 of them by gap mode, every lane of the first row and of each
swept row), and its walk re-derives every backtrack condition from
them: the JAX package's tiles, which the tests compare. The kernel's
tiles are scratch (H, E1, E2 on the rows it swept; F1/F2 are not kept:
its sweep writes a backtrack word per cell instead); callers read only
misc, the steps, the band bounds and the band state.

The F (insertion) and linear-gap scans replicate the TPU kernel's
Kogge-Stone prefix max exactly, including its NEG fill: every lane but
the last of a power-of-two tile also takes max(., NEG), which matters
only in 32-bit score geometry (inf_min < NEG).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..params import GLOBAL_MODE, EXTEND_MODE, LINEAR_GAP, CONVEX_GAP

from . import layout as L
from ._build import check_launch, library
from .steps import pack_steps

I32 = torch.int32
NPLANES = 5


class TileOut(NamedTuple):
    """Outputs of one launch (the JAX ``PallasDPOut``). The kernel's
    tiles are scratch and its F1b/F2b None."""
    Hb: torch.Tensor      # [B, R, WB] row-relative tiles
    E1b: torch.Tensor
    E2b: torch.Tensor
    F1b: torch.Tensor
    F2b: torch.Tensor
    beg_sn: torch.Tensor  # [B, R]
    end_sn: torch.Tensor
    mpl: torch.Tensor
    mpr: torch.Tensor
    misc: torch.Tensor    # [B, M_NMISC]
    steps: torch.Tensor   # [B, max(bt_lmax, 8)] int64 op|row<<2|col<<32


def _bt_planes(gap_mode: int) -> int:
    """int32 planes of the backtrack words: 64 bits (convex gaps) or 32."""
    return 2 if gap_mode == CONVEX_GAP else 1


def tile_nplanes(gap_mode: int) -> int:
    """int32 tiles the kernel keeps: the backtrack words, H; E1
    (affine); E1, E2 (convex)."""
    return _bt_planes(gap_mode) + {LINEAR_GAP: 1, CONVEX_GAP: 3}.get(
        gap_mode, 2)


def tile_plane_bytes(cfg) -> int:
    """Device bytes of one instance's tiles on the card."""
    return tile_nplanes(cfg.gap_mode) * cfg.R * cfg.WB * 4


def _scratch(cfg, B: int, dev):
    """The kernel's tiles of B instances as views of one tensor: the
    backtrack words (int32 plane 0, or planes 0-1 for the 64-bit words of
    convex gaps, 8-byte aligned at its start), H, E1 (affine/convex), E2
    (convex)."""
    gm = cfg.gap_mode
    planes = torch.empty(tile_nplanes(gm), B, cfg.R, cfg.WB, dtype=I32,
                         device=dev)
    k = _bt_planes(gm)
    BT, H = planes[0], planes[k]
    E1 = planes[k + 1] if gm != LINEAR_GAP else H
    E2 = planes[k + 2] if gm == CONVEX_GAP else H
    return BT, H, E1, E2


def _pack(cfg, scal, bases, pre_idx, pre_n, out_idx, out_n, remain, qcodes,
          mpl0, mpr0):
    """int32 copies of the export tuple, and the query profile
    qp [B, m, Wq] = mat[:, code(col)] (0 for codes >= m), built by
    indexing (the JAX wrapper's one-hot product)."""
    B, m = bases.shape[0], cfg.m
    scal = scal.to(I32)
    mat = scal[:, L.S_NSCAL:L.S_NSCAL + m * m].reshape(B, m, m)
    codes = qcodes.to(torch.int64)
    qp = mat.gather(2, codes.clamp(max=m - 1)[:, None, :].expand(
        B, m, codes.shape[1]))
    qp = torch.where((codes < m)[:, None, :], qp,
                     torch.zeros((), dtype=I32, device=qp.device))

    def i32(x):
        return x.to(I32).contiguous()
    return (i32(scal[:, :L.S_NSCAL]), i32(bases), i32(pre_idx), i32(pre_n),
            i32(out_idx), i32(out_n), i32(remain), qp.contiguous(),
            i32(mpl0), i32(mpr0))


def _check(cfg, name, packed):
    if (cfg.align_mode not in (GLOBAL_MODE, EXTEND_MODE) or cfg.WB % cfg.pn
            or cfg.WB <= 0 or cfg.R < 2):
        raise ValueError(f"{name}: bad config {cfg}")
    scal, bases, pre_idx, pre_n, out_idx, out_n, remain, qp, mpl0, mpr0 = \
        packed
    B, R = bases.shape[0], cfg.R
    want = {"scal": (scal, (B, L.S_NSCAL)), "bases": (bases, (B, R)),
            "pre_idx": (pre_idx, (B, R * cfg.P)), "pre_n": (pre_n, (B, R)),
            "out_idx": (out_idx, (B, R * cfg.O)), "out_n": (out_n, (B, R)),
            "remain": (remain, (B, R)), "qp": (qp, (B, cfg.m, cfg.Wq)),
            "mpl0": (mpl0, (B, R)), "mpr0": (mpr0, (B, R))}
    for key, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key}: shape {tuple(t.shape)} != "
                             f"{shape}")
        if t.device != bases.device:
            raise ValueError(f"{name}: {key} on {t.device}")


def _outputs(cfg, B, dev):
    """Zero-filled band bounds, misc and steps."""
    R = cfg.R
    begsn = torch.zeros(B, R, dtype=I32, device=dev)
    endsn = torch.zeros(B, R, dtype=I32, device=dev)
    misc = torch.zeros(B, L.M_NMISC, dtype=I32, device=dev)
    steps = torch.zeros(B, max(cfg.bt_lmax, 8), dtype=torch.int64,
                        device=dev)
    return begsn, endsn, misc, steps


def tile_poa_dp_batch(cfg, scal, bases, pre_idx, pre_n, out_idx, out_n,
                      remain, qcodes, mpl0, mpr0, rowmask=None):
    """Batched banded-tile DP + walk over one export tuple
    (``align/export.py`` ``make_pallas_inputs``, stacked over B, narrow
    dtypes fine; ``cfg`` its ``PallasDPConfig``). rowmask is accepted for
    symmetry with the other DP kernels and unused: this kernel serves
    whole-graph alignments. Returns a ``TileOut``; misc slot M_LASTI is 0.

    CUDA tensors launch ``csrc/tile_dp.cu``; CPU tensors run the plain
    version."""
    dev = bases.device
    if dev.type == "cpu":
        return tile_poa_dp_batch_ref(cfg, scal, bases, pre_idx, pre_n,
                                     out_idx, out_n, remain, qcodes, mpl0,
                                     mpr0)
    if dev.type != "cuda":
        raise ValueError(f"tile_poa_dp_batch: unsupported device {dev}")
    packed = _pack(cfg, scal, bases, pre_idx, pre_n, out_idx, out_n, remain,
                   qcodes, mpl0, mpr0)
    _check(cfg, "tile_poa_dp_batch", packed)
    with torch.cuda.device(dev):
        out = _launch(cfg, packed, torch.cuda.current_stream(dev).cuda_stream)
    tile_poa_dp_batch.launches += 1
    return out


tile_poa_dp_batch.launches = 0


def _launch(cfg, packed, stream):
    """Allocate the outputs and scratch of one launch on the packed
    inputs' device and enqueue the kernel on `stream`."""
    bases = packed[1]
    B, R, dev = bases.shape[0], cfg.R, bases.device
    begsn, endsn, misc, steps = _outputs(cfg, B, dev)
    mpl = torch.empty_like(begsn)
    mpr = torch.empty_like(begsn)
    BT, H, E1, E2 = _scratch(cfg, B, dev)
    rows = (None if L.rows_in_smem(R) else
            torch.empty(B, L.ROW_WORDS * R, dtype=I32, device=dev))
    rc = library("tile_dp").tile_dp_launch(
        *(t.data_ptr() for t in packed), begsn.data_ptr(), endsn.data_ptr(),
        mpl.data_ptr(), mpr.data_ptr(), misc.data_ptr(), steps.data_ptr(),
        rows.data_ptr() if rows is not None else None, H.data_ptr(),
        E1.data_ptr(), E2.data_ptr(), BT.data_ptr(), B, R, cfg.WB, cfg.Wq,
        cfg.P, cfg.O, cfg.m, cfg.pn, cfg.gap_mode, cfg.align_mode,
        int(cfg.use_zdrop), cfg.bt_lmax, stream)
    check_launch(rc, "tile_dp")
    return TileOut(H, E1, E2, None, None, begsn, endsn, mpl, mpr, misc,
                   steps)


def _ks(g, neg):
    """The TPU kernel's Kogge-Stone inclusive prefix max over lanes, with
    NEG shifted in (log2 steps of shift-and-max)."""
    WB = g.shape[1]
    for k in range(int(WB - 1).bit_length()):
        d = 1 << k
        sh = torch.cat([neg.expand(g.shape[0], min(d, WB)), g[:, :WB - d]], 1)
        g = torch.maximum(g, sh[:, :WB])
    return g


def tile_poa_dp_batch_ref(cfg, scal, bases, pre_idx, pre_n, out_idx, out_n,
                          remain, qcodes, mpl0, mpr0, rowmask=None):
    """Plain PyTorch version of ``tile_poa_dp_batch`` (runs on any device;
    same inputs, same ``TileOut``), batched over B: each row step is a
    few tensor operations over [B, WB]."""
    packed = _pack(cfg, scal, bases, pre_idx, pre_n, out_idx, out_n, remain,
                   qcodes, mpl0, mpr0)
    _check(cfg, "tile_poa_dp_batch_ref", packed)
    scal, bases, pre_idx, pre_n, out_idx, out_n, remain, qp, mpl0, mpr0 = \
        packed
    dev = bases.device
    B, R, WB, Wq, P, O, pn = (bases.shape[0], cfg.R, cfg.WB, cfg.Wq, cfg.P,
                              cfg.O, cfg.pn)
    SB = WB // pn
    gm = cfg.gap_mode
    extend = cfg.align_mode == EXTEND_MODE
    begsn, endsn, misc, steps = _outputs(cfg, B, dev)
    planes = torch.zeros(NPLANES, B, R, WB, dtype=I32, device=dev)
    Hb, E1b, E2b, F1b, F2b = planes
    mpl, mpr = mpl0.clone(), mpr0.clone()

    bidx = torch.arange(B, device=dev)
    lane = torch.arange(WB, dtype=I32, device=dev)[None, :]
    lseg = lane // pn
    zero = torch.zeros((), dtype=I32, device=dev)
    NEGt = torch.tensor(L.NEG, dtype=I32, device=dev)
    inf = scal[:, L.S_INF]
    infc = inf[:, None]
    qlen = scal[:, L.S_QLEN]
    nrows = scal[:, L.S_NROWS]
    w = scal[:, L.S_W]
    remend = scal[:, L.S_REMEND]
    dpsn = scal[:, L.S_DPSN]
    e1, o1, oe1, e2, o2, oe2, zdrop = (
        int(v) for v in scal[0, L.S_E1:L.S_ZDROP + 1].tolist()) \
        if B else (0,) * 7

    def ad_bounds(t):
        rem = remain[:, t] - remend - 1
        beg = (torch.minimum(mpl[:, t], qlen - rem) - w).clamp(min=0)
        end = torch.minimum(qlen, torch.maximum(mpr[:, t], qlen - rem) + w)
        return beg, end

    def row_of(plane, row):
        return plane[bidx, row.long().clamp(0, R - 1)]

    def shifted(plane, row, s):
        """Lane j of the result is lane j+s of the tile row, inf outside
        the tile."""
        idx = lane.to(torch.int64) + s.to(torch.int64)[:, None]
        ok = (idx >= 0) & (idx < WB)
        v = row_of(plane, row).gather(1, idx.clamp(0, WB - 1))
        return torch.where(ok, v, infc)

    # ---- first row (ref :553-662) ----
    for o in range(O):
        oko = o < out_n[:, 0]
        tgt = out_idx[:, o].long().clamp(0, R - 1)
        mpl[bidx, tgt] = torch.where(oko, 1, mpl[bidx, tgt])
        mpr[bidx, tgt] = torch.where(oko, 1, mpr[bidx, tgt])
    mpl[:, 0] = 0
    mpr[:, 0] = 0
    _, end0 = ad_bounds(0)
    end_sn0 = torch.div(end0, pn, rounding_mode="floor")
    endsn[:, 0] = end_sn0
    in_de = lane <= ((end_sn0 + 1) * pn - 1)[:, None]
    if gm == LINEAR_GAP:
        Hb[:, 0] = torch.where(in_de, -e1 * lane, infc)
    else:
        f1v = -o1 - e1 * lane
        hv = f1v
        if gm == CONVEX_GAP:
            f2v = -o2 - e2 * lane
            hv = torch.maximum(f1v, f2v)
        Hb[:, 0] = torch.where(lane == 0, zero,
                               torch.where(in_de & (lane >= 1), hv, infc))
        E1b[:, 0] = torch.where(lane == 0, -oe1, infc)
        F1b[:, 0] = torch.where(in_de & (lane >= 1), f1v, infc)
        if gm == CONVEX_GAP:
            E2b[:, 0] = torch.where(lane == 0, -oe2, infc)
            F2b[:, 0] = torch.where(in_de & (lane >= 1), f2v, infc)
    ovfl = end_sn0 + 2 > SB

    def f_scan(src, e, oe, seed):
        """F[j] = max(src[j-1]-oe, F[j-1]-e), lane 0 seeded with
        seed-oe (ref :1381), through the Kogge-Stone prefix max."""
        g = _ks(torch.maximum(src, infc) + lane * e, NEGt)
        gsh = torch.cat([NEGt.expand(B, 1), g[:, :-1]], 1)
        F = gsh - oe - (lane - 1) * e
        F = torch.where(lane == 0, seed - oe, F)
        return torch.maximum(F, infc)

    bs = inf.clone()
    bi = torch.zeros(B, dtype=I32, device=dev)
    bj = torch.zeros(B, dtype=I32, device=dev)
    brem = remain[:, 0].clone()
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    cells = torch.zeros(B, dtype=I32, device=dev)
    tmax = int((nrows - 1).clamp(max=R - 1).max()) if B else 0
    for t in range(1, tmax):
        active = (t <= nrows - 2) & ~stopped
        if not bool(active.any()):
            break
        beg, end = ad_bounds(t)
        beg_sn = torch.div(beg, pn, rounding_mode="floor")
        preds = pre_idx[:, t * P:(t + 1) * P].long().clamp(0, R - 1)
        pvs = torch.arange(P, device=dev)[None, :] < pre_n[:, t, None]
        pbs = begsn.gather(1, preds)
        pes = endsn.gather(1, preds)
        min_pb = torch.where(pvs, pbs, 1 << 30).amin(1)
        beg_sn = torch.maximum(beg_sn, min_pb)
        end_sn = torch.div(end, pn, rounding_mode="floor")
        ovfl = ovfl | (active & (end_sn - beg_sn + 2 > SB))
        end_sn = torch.minimum(end_sn, beg_sn + SB - 2)
        n_seg = end_sn - beg_sn + 1
        begsn[:, t] = torch.where(active, beg_sn, begsn[:, t])
        endsn[:, t] = torch.where(active, end_sn, endsn[:, t])
        t_off = beg_sn * pn
        begc = beg_sn[:, None]
        endc = end_sn[:, None]
        aseg = begc + lseg
        capc = torch.minimum(end_sn + 1, dpsn - 1)[:, None]
        base = bases[:, t].long().clamp(0, cfg.m - 1)
        cols = t_off[:, None] + lane
        qv = qp[bidx, base].gather(1, cols.long().clamp(0, Wq - 1))
        qrow = torch.where((cols >= 1) & (cols <= qlen[:, None]), qv, zero)

        # ---- M/E merges over predecessors (ref :1332-1350); slots past
        # every instance's count add nothing, slot 0 sets the fill ----
        h = torch.zeros(B, WB, dtype=I32, device=dev)
        e1v = e2v = h
        for p in range(max(1, int(pvs.sum(1).max()))):
            pv = pvs[:, p][:, None]
            pred = preds[:, p]
            pb, pe = pbs[:, p], pes[:, p]
            s = t_off - pb * pn
            _begc = torch.maximum(beg_sn, pb)[:, None]
            _endc = torch.minimum(torch.minimum(pe + 1, end_sn),
                                  dpsn - 1)[:, None]
            cand = shifted(Hb, pred, s - 1)
            lo_local = _begc * pn - t_off[:, None]
            cand = torch.where((lane == lo_local) & (pb >= beg_sn)[:, None],
                               infc, cand)
            if gm == LINEAR_GAP:
                cand = torch.maximum(cand + qrow, shifted(Hb, pred, s) - e1)
            mmask = (aseg >= _begc) & (aseg <= _endc) & pv
            if p == 0:
                fill = (((aseg >= begc) & (aseg < _begc))
                        | ((aseg > _endc) & (aseg <= capc)))
                h = torch.where(fill, infc, h)
                h = torch.where(mmask, cand, h)
            else:
                h = torch.where(mmask, torch.maximum(h, cand), h)
            if gm != LINEAR_GAP:
                _ende = torch.minimum(pe, end_sn)[:, None]
                emask = (aseg >= _begc) & (aseg <= _ende) & pv
                pe1 = shifted(E1b, pred, s)
                pe2 = shifted(E2b, pred, s) if gm == CONVEX_GAP else None
                if p == 0:
                    efill = (((aseg >= begc) & (aseg < _begc))
                             | ((aseg > _ende) & (aseg <= endc)))
                    e1v = torch.where(emask, pe1,
                                      torch.where(efill, infc, e1v))
                    if gm == CONVEX_GAP:
                        e2v = torch.where(emask, pe2,
                                          torch.where(efill, infc, e2v))
                else:
                    e1v = torch.where(emask, torch.maximum(e1v, pe1), e1v)
                    if gm == CONVEX_GAP:
                        e2v = torch.where(emask, torch.maximum(e2v, pe2),
                                          e2v)
        in_band = lseg < n_seg[:, None]

        # ---- F phase (closed form; ref :664-699) ----
        rows = {}
        if gm == LINEAR_GAP:
            g = _ks(torch.maximum(torch.where(in_band, h, NEGt), infc)
                    + lane * e1, NEGt)
            hrow = torch.where(in_band, torch.maximum(g - lane * e1, infc),
                               infc)
        elif gm != CONVEX_GAP:
            h0 = h + torch.where(in_band, qrow, zero)
            f1 = f_scan(torch.where(in_band, h0, NEGt), e1, oe1,
                        h0[:, :1])
            h1 = torch.maximum(h0, e1v)
            hh = torch.maximum(h1, f1)
            e1n = torch.maximum(e1v - e1, hh - oe1)
            hrow = torch.where(in_band, hh, infc)
            rows[1] = torch.where(in_band & (hh == h1), e1n, infc)
            rows[3] = torch.where(in_band, f1, infc)
        else:
            h0 = h + torch.where(in_band, qrow, zero)
            hpf = torch.where(in_band, torch.maximum(torch.maximum(h0, e1v),
                                                     e2v), NEGt)
            f1 = f_scan(hpf, e1, oe1, h0[:, :1])
            f2 = f_scan(hpf, e2, oe2, h0[:, :1])
            hh = torch.maximum(torch.maximum(hpf, f1), f2)
            hrow = torch.where(in_band, hh, infc)
            rows[1] = torch.where(in_band, torch.maximum(e1v - e1, hh - oe1),
                                  infc)
            rows[2] = torch.where(in_band, torch.maximum(e2v - e2, hh - oe2),
                                  infc)
            rows[3] = torch.where(in_band, f1, infc)
            rows[4] = torch.where(in_band, f2, infc)
        rows[0] = hrow
        act = active[:, None]
        for k, row in rows.items():
            planes[k][:, t] = torch.where(act, row, planes[k][:, t])

        # ---- row max with the reference tie-breaks (ref :1043-1057): a
        # log-step fold over segments, per lane the last band segment
        # wins ties, then the earliest; across lanes the lowest lane ----
        ns = n_seg[:, None]
        v = torch.where((lseg < ns) & (cols <= qlen[:, None]), hrow, infc)
        prio = torch.where(lseg == ns - 1, -1, lseg)
        wseg = lseg.expand(B, WB)
        for k in range(int(SB - 1).bit_length()):
            d = pn << k
            ok = lane < WB - d
            vb = torch.roll(v, -d, 1)
            pb_ = torch.roll(prio, -d, 1)
            sb_ = torch.roll(wseg, -d, 1)
            take = ((vb > v) | ((vb == v) & (pb_ < prio))) & ok
            v = torch.where(take, vb, v)
            prio = torch.where(take, pb_, prio)
            wseg = torch.where(take, sb_, wseg)
        lane0 = lane < pn
        gmax = torch.where(lane0, v, NEGt).amax(1)
        lane_pick = torch.where(lane0 & (v == gmax[:, None]), lane,
                                1 << 30).amin(1)
        wseg_pick = wseg.gather(1, lane_pick.long().clamp(0, WB - 1)[:, None])
        mi = torch.where(gmax > inf, t_off + wseg_pick[:, 0] * pn + lane_pick,
                         -1)
        stop_now = torch.zeros_like(stopped)
        if extend:
            better = gmax > bs
            if cfg.use_zdrop:
                delta = brem - remain[:, t]
                zlim = zdrop + e1 * (delta - (mi - bj)).abs()
                stop_now = ~better & (bs - gmax > zlim)
            take = active & better
            bs = torch.where(take, gmax, bs)
            bi = torch.where(take, t, bi)
            bj = torch.where(take, mi, bj)
            brem = torch.where(take, remain[:, t], brem)
            stop_now = active & stop_now
        push = active & ~stop_now
        for o in range(O):
            oko = push & (o < out_n[:, t])
            tgt = out_idx[:, t * O + o].long().clamp(0, R - 1)
            mpr[bidx, tgt] = torch.where(
                oko, torch.maximum(mpr[bidx, tgt], mi + 1), mpr[bidx, tgt])
            mpl[bidx, tgt] = torch.where(
                oko, torch.minimum(mpl[bidx, tgt], mi + 1), mpl[bidx, tgt])
        stopped = stopped | stop_now
        cells = cells + torch.where(active, n_seg * pn, 0)

    def lane_at(plane, i, c):
        """Column c of tile row i; 0 outside the tile (ref :448-450)."""
        lc = c - begsn[bidx, i.long().clamp(0, R - 1)] * pn
        ok = (lc >= 0) & (lc < WB)
        v = plane[bidx, i.long().clamp(0, R - 1), lc.long().clamp(0, WB - 1)]
        return torch.where(ok, v, zero)

    if cfg.align_mode == GLOBAL_MODE:
        # ---- best cell over the sink's predecessors ----
        sink = (nrows - 1).long().clamp(0, R - 1)
        for p in range(P):
            pv = p < pre_n[bidx, sink]
            pred = pre_idx[bidx, sink * P + p].clamp(0, R - 1)
            ec = torch.minimum(qlen, (endsn[bidx, pred.long()] + 1) * pn - 1)
            val = lane_at(Hb, pred, ec)
            better = pv & (val > bs)
            bs = torch.where(better, val, bs)
            bi = torch.where(better, pred, bi)
            bj = torch.where(better, ec, bj)
    misc[:, L.M_BEST] = bs
    misc[:, L.M_BI] = bi
    misc[:, L.M_BJ] = bj
    misc[:, L.M_CELLS] = cells
    misc[:, L.M_OVFL] = ovfl.to(I32)
    out = TileOut(Hb, E1b, E2b, F1b, F2b, begsn, endsn, mpl, mpr, misc,
                  steps)
    if not cfg.bt_lmax:
        return out

    # ---- the walk over the tiles (ref :447-614) ----
    def in_band_bt(r, c):
        rl = r.long().clamp(0, R - 1)
        return ((begsn[bidx, rl] * pn <= c)
                & (c <= (endsn[bidx, rl] + 1) * pn - 1))

    def full(v):
        return torch.full((B,), v, dtype=I32, device=dev)

    i, j = bi.clone(), bj.clone()
    cur = full(L.BT_ALL)
    if_ = torch.ones(B, dtype=torch.bool, device=dev)
    nst = full(0)
    fail = torch.zeros(B, dtype=torch.bool, device=dev)
    done = (bi <= 0) | (bj <= 0)
    while True:
        act = ~done & (nst < cfg.bt_lmax)
        if not bool(act.any()):
            break
        ic = i.clamp(0, R - 1)
        curM = (cur & L.BT_M) > 0
        hij, h_prev = lane_at(Hb, ic, j), lane_at(Hb, ic, j - 1)
        base = bases[bidx, ic.long()].long().clamp(0, cfg.m - 1)
        s = qp[bidx, base, j.long().clamp(0, Wq - 1)]
        s = torch.where((j >= 0) & (j < Wq), s, zero)
        if gm != LINEAR_GAP:
            e1ij = lane_at(E1b, ic, j)
            f1ij, f1prev = lane_at(F1b, ic, j), lane_at(F1b, ic, j - 1)
        if gm == CONVEX_GAP:
            e2ij = lane_at(E2b, ic, j)
            f2ij, f2prev = lane_at(F2b, ic, j), lane_at(F2b, ic, j - 1)
        m_pick = full(-1)
        e_pred = full(0)
        e_op = full(L.BT_ALL)
        e_found = torch.zeros_like(curM)
        # slots past every instance's count meet no condition
        for p in range(int(pre_n[bidx, ic.long()].clamp(0, P).max())):
            pre = pre_idx[bidx, (ic * P + p).long()].clamp(0, R - 1)
            pv = p < pre_n[bidx, ic.long()]
            hpre, hpre1 = lane_at(Hb, pre, j), lane_at(Hb, pre, j - 1)
            hit = pv & in_band_bt(pre, j - 1) & (hpre1 + s == hij)
            m_pick = torch.where((m_pick < 0) & hit, p, m_pick)
            okp = pv & in_band_bt(pre, j)
            conds = []
            if gm == LINEAR_GAP:
                conds.append((okp & (hpre - e1 == hij), full(L.BT_ALL)))
            else:
                e1pre = lane_at(E1b, pre, j)
                hm = curM & (hij == e1pre)
                hx = ~curM & (e1ij == e1pre - e1)
                conds.append((okp & ((cur & L.BT_E1) > 0) & (hm | hx),
                              torch.where(hpre - oe1 == e1pre,
                                          L.BT_M | L.BT_F, L.BT_E1)))
                if gm == CONVEX_GAP:
                    e2pre = lane_at(E2b, pre, j)
                    hm2 = curM & (hij == e2pre)
                    hx2 = ~curM & (e2ij == e2pre - e2)
                    conds.append((okp & ((cur & L.BT_E2) > 0) & (hm2 | hx2),
                                  torch.where(hpre - oe2 == e2pre,
                                              L.BT_M | L.BT_F, L.BT_E2)))
            for cond, newop in conds:
                first = cond & ~e_found
                e_pred = torch.where(first, pre, e_pred)
                e_op = torch.where(first, newop, e_op)
                e_found = e_found | cond
        m_possible = m_pick >= 0
        if gm == LINEAR_GAP:
            f_possible = h_prev - e1 == hij
            f_op = full(L.BT_ALL)
        else:
            f1_open = h_prev - oe1 == f1ij
            f1_ext = f1prev - e1 == f1ij
            f1_gate = torch.where(curM, hij == f1ij, True)
            hit_f1 = ((cur & L.BT_F1) > 0) & f1_gate & (f1_open | f1_ext)
            op_f1 = torch.where(f1_open, L.BT_M | L.BT_E, L.BT_F1)
            if gm == CONVEX_GAP:
                f2_open = h_prev - oe2 == f2ij
                f2_ext = f2prev - e2 == f2ij
                f2_gate = torch.where(curM, hij == f2ij, True)
                hit_f2 = ((cur & L.BT_F2) > 0) & f2_gate & (f2_open | f2_ext)
                op_f2 = torch.where(f2_open, L.BT_M | L.BT_E, L.BT_F2)
            else:
                hit_f2 = torch.zeros_like(curM)
                op_f2 = full(L.BT_ALL)
            f_possible = hit_f1 | hit_f2
            f_op = torch.where(hit_f1, op_f1, op_f2)
        use_m1 = curM & ~if_ & m_possible
        use_e = ~use_m1 & e_found
        use_f = ~use_m1 & ~use_e & f_possible
        use_m2 = ~use_m1 & ~use_e & ~use_f & if_ & m_possible
        if gm != LINEAR_GAP:
            use_e = use_e & ((cur & L.BT_E) > 0)
            use_f = ~use_m1 & ~use_e & f_possible & ((cur & L.BT_F) > 0)
            use_m2 = ~use_m1 & ~use_e & ~use_f & curM & if_ & m_possible
        any_hit = use_m1 | use_e | use_f | use_m2
        use_m = use_m1 | use_m2
        m_pred = pre_idx[bidx, (ic * P + m_pick.clamp(min=0)).long()]
        m_pred = torch.where(m_possible, m_pred, 0)
        op_code = torch.where(use_m, 0, torch.where(use_e, 2, 1)).to(I32)
        emit = act & any_hit
        sel = emit.nonzero()[:, 0]
        word = pack_steps(op_code, i, j)
        steps[sel, nst[sel].long()] = word[sel]
        nst = nst + emit.to(I32)
        new_i = torch.where(use_m, m_pred, torch.where(use_e, e_pred, i))
        new_j = torch.where(use_m | use_f, j - 1, j)
        new_cur = torch.where(use_m, L.BT_ALL, torch.where(
            use_e, e_op, torch.where(use_f, f_op, cur))).to(I32)
        fail = fail | (act & ~any_hit)
        i = torch.where(act, new_i, i)
        j = torch.where(act, new_j, j)
        cur = torch.where(act, new_cur, cur)
        if_ = torch.where(act & use_m, False, if_)
        done = done | (act & (fail | (new_i <= 0) | (new_j <= 0)))
    misc[:, L.M_NSTEPS] = nst
    misc[:, L.M_FAIL] = fail.to(I32)
    misc[:, L.M_ENDI] = i
    misc[:, L.M_ENDJ] = j
    return out
