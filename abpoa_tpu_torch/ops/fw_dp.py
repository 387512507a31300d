"""Full-width POA DP + backtrack walk at absolute query columns.

Counterpart of ``fw_poa_dp_batch`` / ``make_fw_kernel`` in
``abpoa_tpu/ops/dp_pallas_fw.py``. The CUDA kernel is
``csrc/fw_dp.cu``; ``fw_poa_dp_batch_ref`` is its plain PyTorch version,
batched over instances.

What is computed, per instance: the DP of one query against the graph in
topological order with plane rows H, E1, E2, F1, F2 at absolute columns
[0, Wq) (1, 3 or 5 planes by gap mode). The adaptive band, when
``banded``, only decides which cells are computed, through the same
fill/merge masks as the band kernel; the band state is scattered to the
out-nodes (mpl/mpr) as the reference does. Unbanded rows (``-b -1``)
span [0, qlen]. Local mode clamps cells at 0, starts from a zero first
row and takes the best cell over every row; extend mode takes the best
row maximum and stops on z-drop. The walk (M -> D -> I order,
indel_first, cur_op gating, local mode's stop at a zero cell) emits
int64 step words ``op | row<<2 | col<<32``: the plain version re-derives
every backtrack condition from the planes, the kernel reads the
backtrack word its sweep wrote per cell (and keeps no F planes). Full
rows cannot overflow, so M_OVFL is 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..params import (GLOBAL_MODE, LOCAL_MODE, EXTEND_MODE, LINEAR_GAP,
                      CONVEX_GAP)

from . import layout as L
from ._build import check_launch, library
from .steps import pack_steps

I32 = torch.int32


class FWConfig(NamedTuple):
    """Geometry and mode of the full-width kernel (the JAX ``FWConfig``
    without the TPU packing field G)."""
    gap_mode: int
    align_mode: int
    pn: int
    R: int
    Wq: int      # full padded width (>= qlen+1)
    P: int
    O: int
    m: int
    use_zdrop: bool
    bt_lmax: int
    banded: bool = True   # False: unbanded (-b -1), beg=0 end=qlen per row


class FWOut(NamedTuple):
    beg_sn: torch.Tensor  # [B, R]
    end_sn: torch.Tensor
    mpl: torch.Tensor
    mpr: torch.Tensor
    misc: torch.Tensor    # [B, M_NMISC]
    steps: torch.Tensor   # [B, max(bt_lmax, 8)] int64 step words


def _bt_planes(gap_mode: int) -> int:
    """int32 planes of the backtrack words: 64 bits (convex gaps) or 32."""
    return 2 if gap_mode == CONVEX_GAP else 1


def fw_nplanes(gap_mode: int) -> int:
    """int32 planes the kernel keeps: the backtrack words, H; E1
    (affine); E1, E2 (convex)."""
    return _bt_planes(gap_mode) + {LINEAR_GAP: 1, CONVEX_GAP: 3}.get(
        gap_mode, 2)


def fw_plane_bytes(cfg: FWConfig) -> int:
    """Device bytes of one instance's planes."""
    return fw_nplanes(cfg.gap_mode) * cfg.R * cfg.Wq * 4


def _planes(cfg: FWConfig, B: int, dev):
    """Plane scratch of B instances as views of one tensor: the
    backtrack words (int32 plane 0, or planes 0-1 for the 64-bit words of
    convex gaps, 8-byte aligned at its start), H, E1 (affine/convex), E2
    (convex)."""
    gm = cfg.gap_mode
    planes = torch.empty(fw_nplanes(gm), B, cfg.R, cfg.Wq, dtype=I32,
                         device=dev)
    k = _bt_planes(gm)
    BT, H = planes[0], planes[k]
    E1 = planes[k + 1] if gm != LINEAR_GAP else H
    E2 = planes[k + 2] if gm == CONVEX_GAP else H
    return BT, H, E1, E2


def _pack_fw(cfg: FWConfig, scal, bases, pre_idx, pre_n, out_idx, out_n,
             remain, qcodes, mpl0, mpr0, rowmask):
    """int32 copies of the export tuple plus the query profile
    qp [B, m, Wq] (mat[base, code(col)], 0 for codes >= m)."""
    B, m = bases.shape[0], cfg.m
    scal = scal.to(I32)
    mat = scal[:, L.S_NSCAL:].reshape(B, m, m)
    codes = qcodes.to(torch.int64)
    qp = mat.gather(2, codes.clamp(max=m - 1)[:, None, :].expand(
        B, m, codes.shape[1]))
    qp = torch.where((codes < m)[:, None, :], qp,
                     torch.zeros((), dtype=I32, device=qp.device))

    def i32(x):
        return x.to(I32).contiguous()
    return (i32(scal[:, :L.S_NSCAL]), i32(bases), i32(pre_idx),
            i32(pre_n), i32(out_idx), i32(out_n), i32(remain),
            qp.contiguous(), i32(mpl0), i32(mpr0), i32(rowmask))


def _check(cfg: FWConfig, name: str, packed):
    if cfg.align_mode not in (GLOBAL_MODE, LOCAL_MODE, EXTEND_MODE) \
            or cfg.bt_lmax % 2:
        raise ValueError(f"{name}: bad config {cfg}")
    scal, bases, pre_idx, pre_n, out_idx, out_n, remain, qp, mpl0, mpr0, \
        rowmask = packed
    B, R = bases.shape[0], cfg.R
    want = {"scal": (scal, (B, L.S_NSCAL)), "bases": (bases, (B, R)),
            "pre_idx": (pre_idx, (B, R * cfg.P)), "pre_n": (pre_n, (B, R)),
            "out_idx": (out_idx, (B, R * cfg.O)), "out_n": (out_n, (B, R)),
            "remain": (remain, (B, R)), "qp": (qp, (B, cfg.m, cfg.Wq)),
            "mpl0": (mpl0, (B, R)), "mpr0": (mpr0, (B, R)),
            "rowmask": (rowmask, (B, R))}
    for key, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key}: shape {tuple(t.shape)} != "
                             f"{shape}")
        if t.device != bases.device:
            raise ValueError(f"{name}: {key} on {t.device}")


def fw_poa_dp_batch(cfg: FWConfig, scal, bases, pre_idx, pre_n, out_idx,
                    out_n, remain, qcodes, mpl0, mpr0, rowmask):
    """Batched full-width DP + walk over one round's export tuple
    (``align/export.py`` ``make_pallas_inputs``, stacked over B, narrow
    dtypes fine). Returns an ``FWOut``; rows at or past n_rows of
    beg/end_sn and mpl/mpr are not part of the result, nor misc slot
    M_LASTI.

    CUDA tensors launch ``csrc/fw_dp.cu``; CPU tensors run the plain
    version."""
    dev = bases.device
    if dev.type == "cpu":
        return fw_poa_dp_batch_ref(cfg, scal, bases, pre_idx, pre_n,
                                   out_idx, out_n, remain, qcodes, mpl0,
                                   mpr0, rowmask)
    if dev.type != "cuda":
        raise ValueError(f"fw_poa_dp_batch: unsupported device {dev}")
    packed = _pack_fw(cfg, scal, bases, pre_idx, pre_n, out_idx, out_n,
                      remain, qcodes, mpl0, mpr0, rowmask)
    _check(cfg, "fw_poa_dp_batch", packed)
    B, R, Wq = bases.shape[0], cfg.R, cfg.Wq
    LS = max(cfg.bt_lmax, 8)
    begsn = torch.zeros(B, R, dtype=I32, device=dev)
    endsn = torch.zeros(B, R, dtype=I32, device=dev)
    mpl = torch.zeros(B, R, dtype=I32, device=dev)
    mpr = torch.zeros(B, R, dtype=I32, device=dev)
    misc = torch.zeros(B, L.M_NMISC, dtype=I32, device=dev)
    steps = torch.zeros(B, LS, dtype=torch.int64, device=dev)
    BT, H, E1, E2 = _planes(cfg, B, dev)
    rows = (None if L.rows_in_smem(R) else
            torch.empty(B, L.ROW_WORDS * R, dtype=I32, device=dev))
    lib = library("fw_dp")
    with torch.cuda.device(dev):
        rc = lib.fw_dp_launch(
            *(t.data_ptr() for t in packed),
            begsn.data_ptr(), endsn.data_ptr(), mpl.data_ptr(),
            mpr.data_ptr(), misc.data_ptr(), steps.data_ptr(),
            rows.data_ptr() if rows is not None else None,
            H.data_ptr(), E1.data_ptr(), E2.data_ptr(), BT.data_ptr(),
            B, R, Wq, cfg.P, cfg.O, cfg.m, cfg.pn,
            cfg.gap_mode, cfg.align_mode, int(cfg.use_zdrop),
            int(cfg.banded), cfg.bt_lmax,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "fw_dp")
    fw_poa_dp_batch.launches += 1
    return FWOut(begsn, endsn, mpl, mpr, misc, steps)


fw_poa_dp_batch.launches = 0


def fw_poa_dp_batch_ref(cfg: FWConfig, scal, bases, pre_idx, pre_n,
                        out_idx, out_n, remain, qcodes, mpl0, mpr0,
                        rowmask):
    """Plain PyTorch version of ``fw_poa_dp_batch`` (runs on any device;
    same inputs, same ``FWOut``), batched over B; rows outside an
    instance's sweep write a scratch row R."""
    packed = _pack_fw(cfg, scal, bases, pre_idx, pre_n, out_idx, out_n,
                      remain, qcodes, mpl0, mpr0, rowmask)
    _check(cfg, "fw_poa_dp_batch_ref", packed)
    scal, bases, pre_idx, pre_n, out_idx, out_n, remain, qp, mpl0, mpr0, \
        rowmask = packed
    dev = bases.device
    B, R, Wq, P, O, pn = (bases.shape[0], cfg.R, cfg.Wq, cfg.P, cfg.O,
                          cfg.pn)
    gm = cfg.gap_mode
    local = cfg.align_mode == LOCAL_MODE
    extend = cfg.align_mode == EXTEND_MODE
    track_best = local or extend
    LS = cfg.bt_lmax
    NEG = L.NEG

    def full(v):
        return torch.full((B,), v, dtype=I32, device=dev)

    bidx = torch.arange(B, device=dev)
    lane = torch.arange(Wq, dtype=I32, device=dev)[None, :]
    seg = lane // pn
    zero = torch.zeros((), dtype=I32, device=dev)
    NEGt = torch.tensor(NEG, dtype=I32, device=dev)
    inf = scal[:, L.S_INF]
    infc = inf[:, None]
    qlen = scal[:, L.S_QLEN]
    qlenc = qlen[:, None]
    nrows = scal[:, L.S_NROWS]
    w = scal[:, L.S_W]
    remend = scal[:, L.S_REMEND]
    dpsnc = scal[:, L.S_DPSN, None]
    e1, o1, oe1, e2, o2, oe2, zdrop = (
        int(v) for v in scal[0, L.S_E1:L.S_ZDROP + 1].tolist()) \
        if B else (0,) * 7

    # planes and row state with one scratch row (R)
    H = torch.zeros(B, R + 1, Wq, dtype=I32, device=dev)
    E1 = F1 = E2 = F2 = None
    if gm != LINEAR_GAP:
        E1, F1 = torch.zeros_like(H), torch.zeros_like(H)
    if gm == CONVEX_GAP:
        E2, F2 = torch.zeros_like(H), torch.zeros_like(H)
    tix = torch.arange(R, dtype=I32, device=dev)[None, :]
    live = tix < nrows[:, None]
    begsn = torch.zeros(B, R + 1, dtype=I32, device=dev)
    endsn = torch.zeros(B, R + 1, dtype=I32, device=dev)
    mpl = torch.zeros(B, R + 1, dtype=I32, device=dev)
    mpr = torch.zeros(B, R + 1, dtype=I32, device=dev)
    mpl[:, :R] = torch.where(live, mpl0, 0)
    mpr[:, :R] = torch.where(live, mpr0, 0)

    def ad_bounds(t):
        if not cfg.banded:
            return torch.zeros_like(qlen), qlen
        rem = remain[:, t] - remend - 1
        beg = (torch.minimum(mpl[:, t], qlen - rem) - w).clamp(min=0)
        end = torch.minimum(qlen, torch.maximum(mpr[:, t], qlen - rem) + w)
        return beg, end

    # ---- first row (ref :553-662) ----
    mpl[:, 0] = 0
    mpr[:, 0] = 0
    for o in range(O):
        oko = o < out_n[:, 0]
        tgt = out_idx[:, o].long()
        mpl[bidx, tgt] = torch.where(oko, 1, mpl[bidx, tgt])
        mpr[bidx, tgt] = torch.where(oko, 1, mpr[bidx, tgt])
    _, end0 = ad_bounds(0)
    end_sn0 = end0 // pn
    endsn[:, 0] = end_sn0
    hi_mask = seg <= torch.minimum(end_sn0 + 1, dpsnc[:, 0] - 1)[:, None]
    de_mask = lane <= ((end_sn0 + 1) * pn - 1)[:, None]
    if not local:
        fill0 = torch.where(hi_mask, infc, zero)
        if gm == LINEAR_GAP:
            H[:, 0] = torch.where(de_mask, -e1 * lane, fill0)
        else:
            f1v = -o1 - e1 * lane
            hv = f1v
            if gm == CONVEX_GAP:
                f2v = -o2 - e2 * lane
                hv = torch.maximum(f1v, f2v)
            H[:, 0] = torch.where(lane == 0, zero, torch.where(
                de_mask & (lane >= 1), hv, fill0))
            E1[:, 0] = torch.where(lane == 0, -oe1, fill0)
            F1[:, 0] = torch.where(de_mask & (lane >= 1), f1v,
                                   torch.where(lane == 0, infc, zero))
            if gm == CONVEX_GAP:
                E2[:, 0] = torch.where(lane == 0, -oe2, fill0)
                F2[:, 0] = torch.where(de_mask & (lane >= 1), f2v,
                                       torch.where(lane == 0, infc, zero))

    limit = torch.minimum(nrows - 1, full(R - 1))
    tmax = int(limit.max()) if B else 0
    bs = inf.clone()
    bi = full(0)
    bj = full(0)
    brem = remain[:, 0].clone()
    stop = torch.zeros(B, dtype=torch.bool, device=dev)
    cells = full(0)

    def prefmax(x):
        return torch.cummax(x, dim=1).values

    for t in range(1, tmax):
        inr = t < limit
        rid = torch.where(inr, t, R).long()
        active = inr & ~stop & (rowmask[:, t] > 0)
        beg, end = ad_bounds(t)
        beg_sn = beg // pn
        preds = pre_idx[:, t * P:(t + 1) * P].long()           # [B, P]
        pvs = torch.arange(P, device=dev)[None, :] < pre_n[:, t, None]
        min_pb = torch.where(pvs, begsn.gather(1, preds), 1 << 30).amin(1)
        beg_sn = torch.maximum(beg_sn, min_pb)
        end_sn = end // pn
        begsn[bidx, rid] = beg_sn
        endsn[bidx, rid] = end_sn
        begc = beg_sn[:, None]
        endc = end_sn[:, None]
        capc = torch.minimum(endc + 1, dpsnc - 1)
        band = (seg >= begc) & (seg <= endc)
        base = bases[:, t].long().clamp(0, cfg.m - 1)
        qrow = torch.where((lane >= 1) & (lane <= qlenc), qp[bidx, base],
                           zero)

        # ---- merges over predecessors (slots past every instance's
        # count add nothing, slot 0 sets the fill) ----
        h = torch.zeros(B, Wq, dtype=I32, device=dev)
        e1v = e2v = h
        for p in range(max(1, int(pvs.sum(1).max()))):
            pred = preds[:, p]
            pvc = pvs[:, p][:, None]
            pbegc = torch.where(pvc, begsn[bidx, pred][:, None], 1 << 29)
            pendc = torch.where(pvc, endsn[bidx, pred][:, None], -(1 << 29))
            if local:
                _begc, _endc = begc, endc
            else:
                _begc = torch.maximum(begc, pbegc)
                _endc = torch.minimum(torch.minimum(pendc + 1, endc),
                                      dpsnc - 1)
            preH = H[bidx, pred]
            cand = torch.where(lane >= 1, torch.roll(preH, 1, 1), NEGt)
            boundary = zero if local else torch.where(pbegc < begc, cand,
                                                      infc)
            cand = torch.where(lane == _begc * pn, boundary, cand)
            if gm == LINEAR_GAP:
                cand = torch.maximum(cand + qrow, preH - e1)
            mmask = (seg >= _begc) & (seg <= _endc) & pvc
            if p == 0:
                if not local:
                    fill = (((seg >= begc) & (seg < _begc))
                            | ((seg > _endc) & (seg <= capc)))
                    h = torch.where(fill, infc, h)
                h = torch.where(mmask, cand, h)
            else:
                h = torch.where(mmask, torch.maximum(h, cand), h)
            if gm != LINEAR_GAP:
                _ende = torch.minimum(pendc, endc)
                emask = (seg >= _begc) & (seg <= _ende) & pvc
                preE1 = E1[bidx, pred]
                preE2 = E2[bidx, pred] if gm == CONVEX_GAP else None
                if p == 0:
                    if not local:
                        efill = (((seg >= begc) & (seg < _begc))
                                 | ((seg > _ende) & (seg <= endc)))
                        e1v = torch.where(efill, infc, e1v)
                        if gm == CONVEX_GAP:
                            e2v = torch.where(efill, infc, e2v)
                    e1v = torch.where(emask, preE1, e1v)
                    if gm == CONVEX_GAP:
                        e2v = torch.where(emask, preE2, e2v)
                else:
                    e1v = torch.where(emask, torch.maximum(e1v, preE1), e1v)
                    if gm == CONVEX_GAP:
                        e2v = torch.where(emask, torch.maximum(e2v, preE2),
                                          e2v)

        lo = begc * pn
        rel = lane - lo

        def f_scan(src, e, oe, seed):
            gv = torch.where(band, torch.maximum(src, infc) + rel * e, NEGt)
            M = prefmax(gv)
            Pm = torch.where(lane >= 1, torch.roll(M, 1, 1), NEGt)
            F = Pm - oe - (rel - 1) * e
            F = torch.where(lane == lo, seed - oe, F)
            return torch.maximum(F, infc)

        def seed_of(h0):
            return torch.where(lane == lo, h0, zero).sum(1, keepdim=True,
                                                         dtype=I32)

        if gm == LINEAR_GAP:
            gv = torch.where(band, torch.maximum(h, infc) + rel * e1, NEGt)
            hfin = torch.maximum(prefmax(gv) - rel * e1, infc)
            if local:
                hfin = hfin.clamp(min=0)
            hrow = torch.where(band, hfin, h)
        elif gm != CONVEX_GAP:
            h0 = h + torch.where(band, qrow, zero)
            f1 = f_scan(torch.where(band, h0, NEGt), e1, oe1, seed_of(h0))
            h1 = torch.maximum(h0, e1v)
            hh = torch.maximum(h1, f1)
            if local:
                hh = hh.clamp(min=0)
            e1n = torch.maximum(e1v - e1, hh - oe1)
            e1fin = torch.where(hh == h1, e1n, zero if local else infc)
            hrow = torch.where(band, hh, h0)
            e1row = torch.where(band, e1fin, e1v)
            f1row = torch.where(band, f1, zero)
        else:
            h0 = h + torch.where(band, qrow, zero)
            seed = seed_of(h0)
            hpf = torch.maximum(torch.maximum(h0, e1v), e2v)
            hpf = torch.where(band, hpf, NEGt)
            f1 = f_scan(hpf, e1, oe1, seed)
            f2 = f_scan(hpf, e2, oe2, seed)
            hh = torch.maximum(torch.maximum(hpf, f1), f2)
            if local:
                hh = hh.clamp(min=0)
            e1n = torch.maximum(e1v - e1, hh - oe1)
            e2n = torch.maximum(e2v - e2, hh - oe2)
            if local:
                e1n = e1n.clamp(min=0)
                e2n = e2n.clamp(min=0)
            hrow = torch.where(band, hh, h0)
            e1row = torch.where(band, e1n, e1v)
            e2row = torch.where(band, e2n, e2v)
            f1row = torch.where(band, f1, zero)
            f2row = torch.where(band, f2, zero)
        H[bidx, rid] = hrow
        if gm != LINEAR_GAP:
            E1[bidx, rid] = e1row
            F1[bidx, rid] = f1row
        if gm == CONVEX_GAP:
            E2[bidx, rid] = e2row
            F2[bidx, rid] = f2row

        # ---- row max with the reference tie-breaks: among the maximal
        # in-band cells at or past the band start, the lowest
        # lane-in-segment, then the last segment, then the first ----
        lseg = seg - begc
        nseg = endc - begc + 1
        v = torch.where(band & (lane <= qlenc), hrow, infc)
        prio = torch.where(lseg == nseg - 1, -1, lseg)
        aux = prio * 1024 + lseg
        gmax = v.amax(1, keepdim=True)
        key = ((lane % pn).to(torch.int64) << 32) | (aux + 1024).to(
            torch.int64)
        kmin = torch.where((v == gmax) & (lane >= lo), key,
                           torch.iinfo(torch.int64).max).amin(1)
        lane_pick = (kmin >> 32).to(I32)
        aux_pick = (kmin & 0xFFFFFFFF).to(I32) - 1024
        wseg = aux_pick - torch.div(aux_pick, 1024, rounding_mode="floor") \
            * 1024
        mx = gmax[:, 0]
        mi = torch.where(mx > inf, (beg_sn + wseg) * pn + lane_pick, -1)
        stop_now = torch.zeros_like(stop)
        if track_best:
            better = mx > bs
            if extend and cfg.use_zdrop:
                delta = brem - remain[:, t]
                zlim = zdrop + e1 * (delta - (mi - bj)).abs()
                stop_now = ~better & (bs - mx > zlim)
            take = active & better
            bs = torch.where(take, mx, bs)
            bi = torch.where(take, t, bi)
            bj = torch.where(take, mi, bj)
            brem = torch.where(take, remain[:, t], brem)
            stop_now = active & stop_now
        # the band state of the out-nodes (ref adaptive band update)
        do_scat = active & ~stop_now
        for o in range(O):
            oko = do_scat & (o < out_n[:, t])
            tgt = out_idx[:, t * O + o].long()
            mpr[bidx, tgt] = torch.maximum(mpr[bidx, tgt],
                                           torch.where(oko, mi + 1, NEG))
            mpl[bidx, tgt] = torch.minimum(mpl[bidx, tgt],
                                           torch.where(oko, mi + 1, 1 << 29))
        stop = stop | stop_now
        cells = cells + torch.where(active, (end_sn - beg_sn + 1) * pn, 0)

    def at(plane, i, c):
        """plane[b, i, c], 0 outside [0, Wq)."""
        ok = (c >= 0) & (c < Wq)
        v = plane[bidx, i.long(), c.clamp(0, Wq - 1).long()]
        return torch.where(ok, v, zero)

    if cfg.align_mode == GLOBAL_MODE:
        # ---- best cell over the sink's predecessors ----
        sink = (nrows - 1).clamp(0, R - 1)
        for p in range(P):
            pv = p < pre_n[bidx, sink.long()]
            pred = pre_idx[bidx, (sink * P + p).long()]
            ec = torch.minimum(qlen, (endsn[bidx, pred.long()] + 1) * pn - 1)
            val = at(H, pred, ec)
            better = pv & (val > bs)
            bs = torch.where(better, val, bs)
            bi = torch.where(better, pred, bi)
            bj = torch.where(better, ec, bj)
    misc = torch.zeros(B, L.M_NMISC, dtype=I32, device=dev)
    misc[:, L.M_BEST] = bs
    misc[:, L.M_BI] = bi
    misc[:, L.M_BJ] = bj
    misc[:, L.M_CELLS] = cells
    steps = torch.zeros(B, max(LS, 8), dtype=torch.int64, device=dev)
    out = lambda: FWOut(begsn[:, :R], endsn[:, :R], mpl[:, :R],  # noqa
                        mpr[:, :R], misc, steps)
    if LS == 0:
        return out()

    # ---- the walk over the planes ----
    i, j = bi.clone(), bj.clone()
    cur = full(L.BT_ALL)
    if_ = torch.ones(B, dtype=torch.bool, device=dev)
    nst = full(0)
    fail = torch.zeros(B, dtype=torch.bool, device=dev)
    done = (bi <= 0) | (bj <= 0)

    def in_band(r, c):
        return ((begsn[bidx, r.long()] * pn <= c)
                & (c <= (endsn[bidx, r.long()] + 1) * pn - 1))

    while True:
        act = ~done & (nst < LS)
        if not bool(act.any()):
            break
        ic = i.clamp(0, R - 1)
        curM = (cur & L.BT_M) > 0
        hij, h_prev = at(H, ic, j), at(H, ic, j - 1)
        zero_stop = (hij == 0) if local else torch.zeros_like(curM)
        s = qp[bidx, bases[bidx, ic.long()].long().clamp(0, cfg.m - 1),
               j.clamp(0, Wq - 1).long()]
        s = torch.where((j >= 0) & (j < Wq), s, zero)
        m_pick = full(-1)
        e_pick_pred = full(0)
        e_op_sel = full(L.BT_ALL)
        e_found = torch.zeros_like(curM)
        if gm != LINEAR_GAP:
            e1ij = at(E1, ic, j)
            f1ij, f1prev = at(F1, ic, j), at(F1, ic, j - 1)
        if gm == CONVEX_GAP:
            e2ij = at(E2, ic, j)
            f2ij, f2prev = at(F2, ic, j), at(F2, ic, j - 1)
        # slots past every instance's count meet no condition
        for p in range(int(pre_n[bidx, ic.long()].clamp(0, P).max())):
            pre = pre_idx[bidx, (ic * P + p).long()]
            pv = p < pre_n[bidx, ic.long()]
            hpre, hpre1 = at(H, pre, j), at(H, pre, j - 1)
            hit = pv & in_band(pre, j - 1) & (hpre1 + s == hij)
            m_pick = torch.where((m_pick < 0) & hit, p, m_pick)
            okp = pv & in_band(pre, j)
            conds = []
            if gm == LINEAR_GAP:
                conds.append((okp & (hpre - e1 == hij), full(L.BT_ALL)))
            else:
                e1pre = at(E1, pre, j)
                hm = curM & (hij == e1pre)
                hx = ~curM & (e1ij == e1pre - e1)
                conds.append((okp & ((cur & L.BT_E1) > 0) & (hm | hx),
                              torch.where(hpre - oe1 == e1pre,
                                          L.BT_M | L.BT_F, L.BT_E1)))
                if gm == CONVEX_GAP:
                    e2pre = at(E2, pre, j)
                    hm2 = curM & (hij == e2pre)
                    hx2 = ~curM & (e2ij == e2pre - e2)
                    conds.append((okp & ((cur & L.BT_E2) > 0) & (hm2 | hx2),
                                  torch.where(hpre - oe2 == e2pre,
                                              L.BT_M | L.BT_F, L.BT_E2)))
            for cond, newop in conds:
                first = cond & ~e_found
                e_pick_pred = torch.where(first, pre, e_pick_pred)
                e_op_sel = torch.where(first, newop, e_op_sel)
                e_found = e_found | cond
        m_possible = m_pick >= 0
        e_possible = e_found
        if gm == LINEAR_GAP:
            f_possible = h_prev - e1 == hij
            f_op_sel = full(L.BT_ALL)
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
            f_op_sel = torch.where(hit_f1, op_f1, op_f2)
        use_m1 = curM & ~if_ & m_possible
        use_e = ~use_m1 & e_possible
        if gm != LINEAR_GAP:
            use_e = use_e & ((cur & L.BT_E) > 0)
        use_f = ~use_m1 & ~use_e & f_possible
        if gm != LINEAR_GAP:
            use_f = use_f & ((cur & L.BT_F) > 0)
        use_m2 = ~use_m1 & ~use_e & ~use_f & if_ & m_possible
        if gm != LINEAR_GAP:
            use_m2 = use_m2 & curM
        any_hit = (use_m1 | use_e | use_f | use_m2) & ~zero_stop
        use_m = use_m1 | use_m2
        m_pred = pre_idx[bidx, (ic * P + m_pick.clamp(min=0)).long()]
        m_pred = torch.where(m_possible, m_pred, 0)
        op_code = torch.where(use_m, 0, torch.where(use_e, 2, 1)).to(I32)
        emit = act & any_hit
        sel = emit.nonzero()[:, 0]
        word = pack_steps(op_code, i, j)
        steps[sel, nst[sel].long()] = word[sel]
        nst = nst + emit.to(I32)
        new_i = torch.where(use_m, m_pred, torch.where(use_e, e_pick_pred, i))
        new_j = torch.where(use_m | use_f, j - 1, j)
        new_cur = torch.where(use_m, L.BT_ALL, torch.where(
            use_e, e_op_sel, torch.where(use_f, f_op_sel, cur))).to(I32)
        fail = fail | (act & ~(any_hit | zero_stop))
        # the walk moves only with a step: local mode ends on the zero
        # cell itself, whatever move its conditions would allow
        i = torch.where(emit, new_i, i)
        j = torch.where(emit, new_j, j)
        cur = torch.where(emit, new_cur, cur)
        if_ = torch.where(emit & use_m, False, if_)
        done = done | (act & (fail | zero_stop | (new_i <= 0)
                              | (new_j <= 0)))
    misc[:, L.M_NSTEPS] = nst
    misc[:, L.M_FAIL] = fail.to(I32)
    misc[:, L.M_ENDI] = i
    misc[:, L.M_ENDJ] = j
    return out()
