"""Banded POA DP + backtrack walk over the packed graph state.

Counterpart of ``band_poa_dp_packed`` / ``make_band_kernel`` (nid mode)
in ``abpoa_tpu/ops/dp_pallas_band.py``. The CUDA kernel is
``csrc/band_dp.cu``; ``band_poa_dp_packed_ref`` is its plain PyTorch
version, batched over instances.

What is computed, per instance: the adaptive-banded global DP of one
query against the graph in topological order (rows come from the
packed i2n map, planes are indexed by node id), with H/E1/E2 planes
whose lane l holds query column c = l (mod WB), a backtrack-bits plane
that bakes every comparison the reference walk makes (M -> D -> I
order, indel_first, cur_op gating; ref src/abpoa_align.c:64-170 via
``abpoa_tpu/align/engine_np.py:636-935``), and the walk, which emits
the steps16 delta stream (``ops/steps.py``) and the misc row. A row
whose band does not fit the WB window sets M_OVFL; a walk with no move
sets M_FAIL. The host rebuilds such instances on the oracle.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from abpoa_tpu.params import LINEAR_GAP, CONVEX_GAP, SINK_NODE_ID

from . import layout as L
from ._build import check_launch, library

I32 = torch.int32
RM_OK = 1 << 30


class BandConfig(NamedTuple):
    """Geometry of the band kernel. It always runs the JAX kernel's
    global, node-id-plane, fresh-band-state mode (nid=True, fresh=True):
    the only mode the device loop uses."""
    gap_mode: int
    pn: int
    R: int
    WB: int      # band tile width (multiple of pn)
    Wq: int      # padded query width (multiple of WB)
    P: int       # predecessor slots per row
    m: int
    bt_lmax: int  # walk length bound (step-stream capacity)


def build_qpf(cfg: BandConfig, mat, qcodes: torch.Tensor) -> torch.Tensor:
    """Query-profile folds [..., m*(KW+1), WB]: fold k of base a holds
    mat[a, code(col)] for query columns [k*WB, (k+1)*WB); the last fold
    of each base is zeros. qcodes: [..., Wq]; mat: [m*m]."""
    m, WB = cfg.m, cfg.WB
    KW = cfg.Wq // WB
    mat = torch.as_tensor(mat, dtype=I32, device=qcodes.device).reshape(m, m)
    codes = qcodes.to(torch.int64)
    valid = codes < m
    qp = torch.where(valid[..., None, :],
                     mat[:, codes.clamp(max=m - 1)].movedim(0, -2),
                     torch.zeros((), dtype=I32, device=qcodes.device))
    lead = qcodes.shape[:-1]
    qp = qp.reshape(*lead, m, KW, WB)
    qpf = torch.cat([qp, qp.new_zeros(*lead, m, 1, WB)], dim=-2)
    return qpf.reshape(*lead, m * (KW + 1), WB).contiguous()


def _check_inputs(cfg: BandConfig, scal, ctrl, inp, i2nn, qpf):
    if cfg.WB % cfg.pn or cfg.Wq % cfg.WB or cfg.P % 2 or cfg.bt_lmax % 2:
        raise ValueError(f"band_poa_dp_packed: bad geometry {cfg}")
    B, R = ctrl.shape[0], cfg.R
    KW1 = cfg.Wq // cfg.WB + 1
    want = {"scal": (scal, (B, L.S_NSCAL)), "ctrl": (ctrl, (B, R)),
            "inp": (inp, (B, R * cfg.P // 2)), "i2nn": (i2nn, (B, R)),
            "qpf": (qpf, (B, cfg.m * KW1, cfg.WB))}
    for name, (t, shape) in want.items():
        if t.dtype != I32:
            raise TypeError(f"{name}: int32 expected, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.device != ctrl.device:
            raise ValueError(f"{name}: on {t.device}, ctrl on {ctrl.device}")


def band_poa_dp_packed(cfg: BandConfig, scal, ctrl, inp, i2nn, qpf,
                       misc_out=None, s16_out=None):
    """Batched DP + walk over the packed state. scal [B, >=S_NSCAL]
    (per-round slots from build_scal), ctrl [B, R], inp [B, R*P/2],
    i2nn [B, R], qpf [B, m*(KW+1), WB], all int32. Returns
    (misc [B, M_NMISC], s16w [B, LS/2]); entries of s16w past M_NSTEPS
    halves are zero. misc_out/s16_out, when given, receive the results.

    CUDA tensors launch ``csrc/band_dp.cu``; CPU tensors run the plain
    version. Nothing else: a kernel fault raises."""
    scal = scal[:, :L.S_NSCAL].contiguous()
    _check_inputs(cfg, scal, ctrl, inp, i2nn, qpf)
    B = ctrl.shape[0]
    if ctrl.device.type == "cpu":
        misc, s16w = band_poa_dp_packed_ref(cfg, scal, ctrl, inp, i2nn, qpf)
        if misc_out is not None:
            misc_out.copy_(misc)
            s16_out.copy_(s16w)
            return misc_out, s16_out
        return misc, s16w
    if ctrl.device.type != "cuda":
        raise ValueError(f"band_poa_dp_packed: unsupported device "
                         f"{ctrl.device}")
    for t in (ctrl, inp, i2nn, qpf):
        if not t.is_contiguous():
            raise ValueError("band_poa_dp_packed: inputs must be contiguous")
    dev = ctrl.device
    misc = (misc_out if misc_out is not None
            else torch.empty(B, L.M_NMISC, dtype=I32, device=dev))
    s16w = (s16_out if s16_out is not None
            else torch.empty(B, cfg.bt_lmax // 2, dtype=I32, device=dev))
    for name, t, shape in (("misc_out", misc, (B, L.M_NMISC)),
                           ("s16_out", s16w, (B, cfg.bt_lmax // 2))):
        if (t.dtype != I32 or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"band_poa_dp_packed: bad {name}")
    s16w.zero_()
    nplanes = {LINEAR_GAP: 2, CONVEX_GAP: 4}.get(cfg.gap_mode, 3)
    planes = torch.empty(nplanes, B, cfg.R, cfg.WB, dtype=I32, device=dev)
    H, BT = planes[0], planes[-1]
    E1 = planes[1] if nplanes >= 3 else H
    E2 = planes[2] if nplanes == 4 else H
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.band_dp_launch(
            scal.data_ptr(), ctrl.data_ptr(), inp.data_ptr(),
            i2nn.data_ptr(), qpf.data_ptr(), misc.data_ptr(),
            s16w.data_ptr(), H.data_ptr(), E1.data_ptr(), E2.data_ptr(),
            BT.data_ptr(), B, cfg.R, cfg.WB, cfg.Wq, cfg.P, cfg.pn,
            cfg.gap_mode, cfg.bt_lmax,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "band_dp")
    band_poa_dp_packed.launches += 1
    return misc, s16w


band_poa_dp_packed.launches = 0


# ------------------------------------------------------------------ #
# plain PyTorch version

def band_poa_dp_packed_ref(cfg: BandConfig, scal, ctrl, inp, i2nn, qpf):
    """Plain PyTorch version of the band kernel, batched over B (runs on
    any device). Per instance it is the same function as the kernel:
    rows 1..n_rows-2 in topo order, predecessor slots p < n_in(row)."""
    dev = ctrl.device
    B, R, WB, pn, P = ctrl.shape[0], cfg.R, cfg.WB, cfg.pn, cfg.P
    gm = cfg.gap_mode
    P2 = P // 2
    NSEG = WB // pn
    KW1 = cfg.Wq // WB + 1
    LS = cfg.bt_lmax
    SINK = SINK_NODE_ID

    def full(v):
        return torch.full((B,), v, dtype=I32, device=dev)

    bidx = torch.arange(B, device=dev)
    lane = torch.arange(WB, dtype=I32, device=dev)[None, :]
    NEGt = torch.tensor(L.NEG, dtype=I32, device=dev)
    zero = torch.zeros((), dtype=I32, device=dev)

    scal = scal.to(I32)
    inf = scal[:, L.S_INF]
    infc = inf[:, None]
    qlen = scal[:, L.S_QLEN]
    qlenc = qlen[:, None]
    nrows = scal[:, L.S_NROWS]
    w = scal[:, L.S_W]
    remend = scal[:, L.S_REMEND]
    dpsn = scal[:, L.S_DPSN]
    dpsnc = dpsn[:, None]
    e1, o1, oe1, e2, o2, oe2 = (int(v) for v in scal[0, L.S_E1:L.S_OE2 + 1]
                                .tolist())
    inp3 = inp.reshape(B, R, P2)

    def preds_of(node):
        """[B, P] predecessor node ids of node [B] (clamped to R-1)."""
        wv = inp3[bidx, node.long()]
        pr = torch.stack([wv & 0xFFFF, (wv >> 16) & 0xFFFF], dim=2)
        return pr.reshape(B, P).clamp(max=R - 1)

    H = torch.zeros(B, R, WB, dtype=I32, device=dev)
    E1 = torch.zeros_like(H) if gm != LINEAR_GAP else None
    E2 = torch.zeros_like(H) if gm == CONVEX_GAP else None
    BT = torch.zeros_like(H)
    bsn = torch.zeros(B, R, dtype=I32, device=dev)
    rms = torch.zeros(B, R, dtype=I32, device=dev)

    # ---- first row (ref :553-662): lane l holds col l ----
    rms[:, 0] = RM_OK | 1
    rem0 = (ctrl[:, 0] >> 16) - remend - 1
    end0 = torch.minimum(qlen, (qlen - rem0).clamp(min=0) + w)
    end_sn0 = end0 // pn
    bsn[:, 0] = end_sn0 << 16
    cap0 = torch.minimum(end_sn0 + 1, dpsn - 1)
    ovfl = cap0 + 2 > NSEG
    hi_mask = (lane // pn) <= cap0[:, None]
    de_mask = lane <= ((end_sn0 + 1) * pn - 1)[:, None]
    fill0 = torch.where(hi_mask, infc, zero)
    if gm == LINEAR_GAP:
        H[:, 0] = torch.where(de_mask, -e1 * lane, fill0)
    else:
        hv = -o1 - e1 * lane
        if gm == CONVEX_GAP:
            hv = torch.maximum(hv, -o2 - e2 * lane)
        h0 = torch.where(de_mask & (lane >= 1), hv, fill0)
        H[:, 0] = torch.where(lane == 0, zero, h0)
        E1[:, 0] = torch.where(lane == 0, torch.tensor(-oe1, dtype=I32,
                                                       device=dev), fill0)
        if gm == CONVEX_GAP:
            E2[:, 0] = torch.where(lane == 0, torch.tensor(
                -oe2, dtype=I32, device=dev), fill0)

    cells = full(0)
    p_iota = torch.arange(P, dtype=I32, device=dev)[None, :]
    limit = min(int(nrows.max()) - 1, R - 1) if B else 0

    def to_rel(x, lane_of_rel):
        return x.gather(1, lane_of_rel)

    def prefmax(gv_rel):
        return torch.cummax(gv_rel, dim=1).values

    for t in range(1, limit):
        active = t <= nrows - 2
        rid = torch.where(active, (i2nn[:, t] & 0xFFFF).clamp(0, R - 1),
                          full(SINK))
        ridl = rid.long()
        cw = ctrl[bidx, ridl]
        npre = (cw >> 10) & 15
        preds = preds_of(rid)                                  # [B, P]
        pvs = p_iota < npre[:, None]
        predl = preds.long()
        bsnp = bsn.gather(1, predl)
        min_pb = torch.where(pvs, bsnp & 0xFFFF, RM_OK).amin(1)
        wr = rms.gather(1, predl)
        ok = pvs & (wr >= RM_OK)
        v = wr & (RM_OK - 1)
        mpl = torch.where(ok, v, 1 << 29).amin(1)
        mpr = torch.where(ok, v, -(1 << 29)).amax(1)
        has_src = (pvs & (preds == 0)).any(1)
        mpl = torch.minimum(mpl, torch.where(has_src, 1 << 29,
                                             nrows & 0xFFFF))
        mpr = torch.maximum(mpr, torch.where(has_src, -(1 << 29),
                                             nrows >> 16))
        rem = (cw >> 16) - remend - 1
        beg = (torch.minimum(mpl, qlen - rem) - w).clamp(min=0)
        end = torch.minimum(qlen, torch.maximum(mpr, qlen - rem) + w)
        beg_sn = torch.maximum(beg // pn, min_pb)
        end_sn = end // pn
        bsn[bidx, ridl] = beg_sn | (end_sn << 16)
        cells = cells + torch.where(active, (end_sn - beg_sn + 1) * pn, 0)
        capg = torch.minimum(end_sn + 1, dpsn - 1)
        ovfl = ovfl | (active & (capg - beg_sn + 2 > NSEG))
        lo_g = beg_sn * pn
        k0 = lo_g // WB
        # the kernel stages beg|end<<10|lomod<<20 in one word
        bel = (beg_sn | (end_sn << 10) | ((lo_g - k0 * WB) << 20))[:, None]
        base = (cw & 7).long()
        fold = (base * KW1 + k0).clamp(0, cfg.m * KW1 - 2)
        qA = qpf[bidx, fold]
        qB = qpf[bidx, fold + 1]
        bval = (base < cfg.m)[:, None]
        lomodc = bel >> 20
        qwin = torch.where(bval, torch.where(lane >= lomodc, qA, qB), zero)
        begc = bel & 1023
        endc = (bel >> 10) & 1023
        capc = torch.minimum(endc + 1, dpsnc - 1)
        dlo = lane - lomodc
        rel = torch.where(dlo >= 0, dlo, dlo + WB)
        lane_of_rel = (lomodc + lane) % WB
        lane_of_rel = lane_of_rel.long()
        rell = rel.long()
        c = begc * pn + rel
        seg = c // pn
        band = (seg >= begc) & (seg <= endc)
        qrow = torch.where((c >= 1) & (c <= qlenc), qwin, zero)

        # ---- predecessor merges ----
        btp = []
        hacc = e1acc = e2acc = None
        for p in range(max(1, int(npre.max()))):
            pred = predl[:, p]
            pv = pvs[:, p][:, None]
            pw = bsn[bidx, pred]
            pbel = ((pw & 0xFFFF) | ((pw >> 16) << 10)
                    | (pvs[:, p].to(I32) << 20))[:, None]
            pvc = (pbel >> 20) > 0
            pbegc = torch.where(pvc, pbel & 1023, 1 << 29)
            pendc = torch.where(pvc, (pbel >> 10) & 1023, -(1 << 29))
            _begc = torch.maximum(begc, pbegc)
            _endc = torch.minimum(torch.minimum(pendc + 1, endc), dpsnc - 1)
            preH = H[bidx, pred]
            rollH = torch.roll(preH, 1, dims=1)
            cand = torch.where(c == 0, NEGt, rollH)
            boundary = torch.where(pbegc < begc, cand, infc)
            cand = torch.where(c == _begc * pn, boundary, cand)
            if gm == LINEAR_GAP:
                cand = torch.maximum(cand + qrow, preH - e1)
            mmask = (seg >= _begc) & (seg <= _endc) & pvc
            plo = pbegc * pn
            phi = (pendc + 1) * pn - 1
            m_in = pvc & (c - 1 >= plo) & (c - 1 <= phi)
            okp = pvc & (c >= plo) & (c <= phi)
            preE1 = E1[bidx, pred] if gm != LINEAR_GAP else None
            preE2 = E2[bidx, pred] if gm == CONVEX_GAP else None
            btp.append((pv, torch.where(m_in, rollH, NEGt),
                        torch.where(okp, preH, NEGt),
                        torch.where(okp, preE1, NEGt) if preE1 is not None
                        else None,
                        torch.where(okp, preE2, NEGt) if preE2 is not None
                        else None))
            if p == 0:
                fill = (((seg >= begc) & (seg < _begc))
                        | ((seg > _endc) & (seg <= capc)))
                hacc = torch.where(mmask, cand,
                                   torch.where(fill, infc, zero))
            else:
                hacc = torch.where(mmask, torch.maximum(hacc, cand), hacc)
            if gm != LINEAR_GAP:
                _ende = torch.minimum(pendc, endc)
                emask = (seg >= _begc) & (seg <= _ende) & pvc
                if p == 0:
                    efill = (((seg >= begc) & (seg < _begc))
                             | ((seg > _ende) & (seg <= endc)))
                    ef = torch.where(efill, infc, zero)
                    e1acc = torch.where(emask, preE1, ef)
                    if gm == CONVEX_GAP:
                        e2acc = torch.where(emask, preE2, ef)
                else:
                    e1acc = torch.where(emask, torch.maximum(e1acc, preE1),
                                        e1acc)
                    if gm == CONVEX_GAP:
                        e2acc = torch.where(
                            emask, torch.maximum(e2acc, preE2), e2acc)
        h = hacc
        e1v = e1acc if gm != LINEAR_GAP else h
        e2v = e2acc if gm == CONVEX_GAP else h
        relz = rel == 0

        def f_scan(src, e, oe, seed):
            gv = torch.where(band, torch.maximum(src, infc) + rel * e, NEGt)
            cm = prefmax(to_rel(gv, lane_of_rel))
            # running max up to rel-1, NEG at rel 0
            Pm = torch.cat([NEGt.expand(B, 1), cm[:, :-1]], 1).gather(1, rell)
            F = Pm - oe - (rel - 1) * e
            F = torch.where(relz, seed - oe, F)
            return torch.maximum(F, infc)

        if gm == LINEAR_GAP:
            gv = torch.where(band, torch.maximum(h, infc) + rel * e1, NEGt)
            hfin = torch.maximum(
                prefmax(to_rel(gv, lane_of_rel)).gather(1, rell) - rel * e1,
                infc)
            hrow = torch.where(band, hfin, h)
        else:
            h0 = h + torch.where(band, qrow, zero)
            seed = h0.gather(1, lomodc.long())
            if gm == CONVEX_GAP:
                hpf = torch.maximum(torch.maximum(h0, e1v), e2v)
                hpf = torch.where(band, hpf, NEGt)
                f1 = f_scan(hpf, e1, oe1, seed)
                f2 = f_scan(hpf, e2, oe2, seed)
                hh = torch.maximum(torch.maximum(hpf, f1), f2)
                e1row = torch.where(band, torch.maximum(e1v - e1, hh - oe1),
                                    e1v)
                e2row = torch.where(band, torch.maximum(e2v - e2, hh - oe2),
                                    e2v)
                f2row = torch.where(band, f2, zero)
            else:
                f1 = f_scan(torch.where(band, h0, NEGt), e1, oe1, seed)
                h1 = torch.maximum(h0, e1v)
                hh = torch.maximum(h1, f1)
                e1n = torch.maximum(e1v - e1, hh - oe1)
                e1row = torch.where(band, torch.where(hh == h1, e1n, infc),
                                    e1v)
            hrow = torch.where(band, hh, h0)
            f1row = torch.where(band, f1, zero)
        H[bidx, ridl] = hrow
        if gm != LINEAR_GAP:
            E1[bidx, ridl] = e1row
        if gm == CONVEX_GAP:
            E2[bidx, ridl] = e2row

        # ---- backtrack bits: [0:4] m_pick, [4:8] e1_pickM,
        # [8:12] e1_pickX, [12] e1_openM, [13] e1_openX, [14:18] e2_pickM,
        # [18:22] e2_pickX, [22] e2_openM, [23] e2_openX, [24] f1_open
        # (linear: f_possible), [25] f1_ext, [26] f1_gate, [27] f2_open,
        # [28] f2_ext, [29] f2_gate; pick 15 = no hit ----
        one = torch.ones((), dtype=I32, device=dev)
        fifteen = torch.full((), 15, dtype=I32, device=dev)
        acc = None
        for p, (pv, bm, bh, be1, be2) in enumerate(btp):
            mh = (bm + qrow) == hrow
            if gm == LINEAR_GAP:
                e1m = e1x = (bh - e1) == hrow
                e1o = torch.zeros_like(mh)
                e2m = e2x = e2o = e1o
            else:
                e1m = hrow == be1
                e1x = e1row == (be1 - e1)
                e1o = (bh - oe1) == be1
                if gm == CONVEX_GAP:
                    e2m = hrow == be2
                    e2x = e2row == (be2 - e2)
                    e2o = (bh - oe2) == be2
                else:
                    e2m = e2x = e2o = torch.zeros_like(mh)
            if p == 0:
                acc = [torch.where(mh, zero, fifteen),
                       torch.where(e1m, zero, fifteen),
                       torch.where(e1x, zero, fifteen),
                       (e1m & e1o).to(I32), (e1x & e1o).to(I32),
                       torch.where(e2m, zero, fifteen),
                       torch.where(e2x, zero, fifteen),
                       (e2m & e2o).to(I32), (e2x & e2o).to(I32)]
                continue
            pt = torch.tensor(p, dtype=I32, device=dev)
            u = pv & mh & (acc[0] == 15)
            acc[0] = torch.where(u, pt, acc[0])
            for kp, ko, hit, op_ in ((1, 3, e1m, e1o), (2, 4, e1x, e1o),
                                     (5, 7, e2m, e2o), (6, 8, e2x, e2o)):
                if kp >= 5 and gm != CONVEX_GAP:
                    continue
                u = pv & hit & (acc[kp] == 15)
                acc[ko] = torch.where(u & op_, one,
                                      torch.where(u, zero, acc[ko]))
                acc[kp] = torch.where(u, pt, acc[kp])
        hprev = torch.where(relz, zero, torch.roll(hrow, 1, dims=1))
        if gm == LINEAR_GAP:
            fb = ((hprev - e1) == hrow).to(I32) << 24
        else:
            f1prev = torch.where(relz, zero, torch.roll(f1row, 1, dims=1))
            fb = ((((hprev - oe1) == f1row).to(I32) << 24)
                  | (((f1prev - e1) == f1row).to(I32) << 25)
                  | ((hrow == f1row).to(I32) << 26))
            if gm == CONVEX_GAP:
                f2prev = torch.where(relz, zero,
                                     torch.roll(f2row, 1, dims=1))
                fb = (fb | (((hprev - oe2) == f2row).to(I32) << 27)
                      | (((f2prev - e2) == f2row).to(I32) << 28)
                      | ((hrow == f2row).to(I32) << 29))
        BT[bidx, ridl] = (acc[0] | (acc[1] << 4) | (acc[2] << 8)
                          | (acc[3] << 12) | (acc[4] << 13)
                          | (acc[5] << 14) | (acc[6] << 18)
                          | (acc[7] << 22) | (acc[8] << 23) | fb)

        # ---- row max with the reference tie-breaks: among the maximal
        # in-band cells, the lowest lane-in-segment, then the last
        # segment, then the first ----
        lseg = seg - begc
        nseg = endc - begc + 1
        vv = torch.where(band & (c <= qlenc), hrow, infc)
        prio = torch.where(lseg == nseg - 1, -1, lseg)
        key = (rel % pn) * (1 << 15) + (prio * 1024 + lseg + 1024)
        gmax = vv.amax(1, keepdim=True)
        kpick = torch.where(vv == gmax, key, 1 << 30).amin(1, keepdim=True)
        aux_pick = (kpick & 0x7FFF) - 1024
        wseg = aux_pick - (aux_pick // 1024) * 1024
        maxi = torch.where(gmax > infc, (begc + wseg) * pn + (kpick >> 15),
                           -1)[:, 0]
        rms[bidx, ridl] = torch.where(active, RM_OK | (maxi + 1), 0)

    # ---- best cell over the sink's predecessors ----
    bs = inf.clone()
    bi = full(0)
    bj = full(0)
    sinkt = full(SINK)
    npre_sink = (ctrl[:, SINK] >> 10) & 15
    spreds = preds_of(sinkt)
    for p in range(P):
        pv = p < npre_sink
        pred = spreds[:, p].long()
        pw = bsn[bidx, pred]
        ec = torch.minimum(qlen, ((pw >> 16) + 1) * pn - 1)
        lo_p = (pw & 0xFFFF) * pn
        ln = (ec % WB).long()
        val = H[bidx, pred, ln]
        val = torch.where((ec >= lo_p) & (ec < lo_p + WB), val, 0)
        better = pv & (val > bs)
        bs = torch.where(better, val, bs)
        bi = torch.where(better, spreds[:, p], bi)
        bj = torch.where(better, ec, bj)
    n2i_of = i2nn >> 16
    misc = torch.zeros(B, L.M_NMISC, dtype=I32, device=dev)
    misc[:, L.M_BEST] = bs
    misc[:, L.M_BI] = n2i_of[bidx, bi.long()]
    misc[:, L.M_BJ] = bj
    misc[:, L.M_CELLS] = cells
    misc[:, L.M_OVFL] = ovfl.to(I32)

    # ---- the walk: one BT read per step ----
    I_ = bi.clone()
    J = bj.clone()
    lane_w = J % WB
    cur = full(L.BT_ALL)
    if_ = torch.ones(B, dtype=torch.bool, device=dev)
    nst = full(0)
    fail = torch.zeros(B, dtype=torch.bool, device=dev)
    done = (bi <= 0) | (bj <= 0) | ovfl
    PI = n2i_of[bidx, bi.long()]
    PJ = bj.clone()
    halves = torch.zeros(B, LS, dtype=I32, device=dev)

    def pre_at(node, p):
        wv = inp[bidx, (node * P2 + (p >> 1)).long()]
        return ((wv >> (16 * (p & 1))) & 0xFFFF).clamp(max=R - 1)

    def bit(x, k):
        return ((x >> k) & 1) > 0

    CHECK = 32
    it = 0
    while True:
        if it % CHECK == 0 and bool(done.all()):
            break
        it += 1
        act = ~done
        Il = I_.long()
        wv = bsn[bidx, Il]
        lo_i = (wv & 0xFFFF) * pn
        braw = BT[bidx, Il, lane_w.long()]
        b = torch.where((J >= lo_i) & (J < lo_i + WB), braw,
                        L.INVALID_BITS)
        curM = (cur & L.BT_M) > 0
        mp = b & 15
        m_possible = mp < 15
        if gm == LINEAR_GAP:
            pe = (b >> 4) & 15
            e_possible = pe < 15
            e_pick_p = pe
            e_op_sel = full(L.BT_ALL)
            f_possible = bit(b, 24)
            f_op_sel = full(L.BT_ALL)
        else:
            pe1 = torch.where(curM, (b >> 4) & 15, (b >> 8) & 15)
            e1open = torch.where(curM, bit(b, 12), bit(b, 13))
            e1hit = ((cur & L.BT_E1) > 0) & (pe1 < 15)
            if gm == CONVEX_GAP:
                pe2 = torch.where(curM, (b >> 14) & 15, (b >> 18) & 15)
                e2open = torch.where(curM, bit(b, 22), bit(b, 23))
                e2hit = ((cur & L.BT_E2) > 0) & (pe2 < 15)
            else:
                pe2 = full(15)
                e2open = torch.zeros_like(curM)
                e2hit = torch.zeros_like(curM)
            k1 = torch.where(e1hit, 2 * pe1, 99)
            k2 = torch.where(e2hit, 2 * pe2 + 1, 99)
            use_e1 = k1 <= k2
            e_possible = torch.minimum(k1, k2) < 99
            e_pick_p = torch.where(use_e1, pe1, pe2)
            mf = full(L.BT_M | L.BT_F)
            e_op_sel = torch.where(
                use_e1, torch.where(e1open, mf, full(L.BT_E1)),
                torch.where(e2open, mf, full(L.BT_E2)))
            me = full(L.BT_M | L.BT_E)
            f1o, f1x, f1g = bit(b, 24), bit(b, 25), bit(b, 26)
            hit_f1 = (((cur & L.BT_F1) > 0) & torch.where(curM, f1g, True)
                      & (f1o | f1x))
            op_f1 = torch.where(f1o, me, full(L.BT_F1))
            if gm == CONVEX_GAP:
                f2o, f2x, f2g = bit(b, 27), bit(b, 28), bit(b, 29)
                hit_f2 = (((cur & L.BT_F2) > 0)
                          & torch.where(curM, f2g, True) & (f2o | f2x))
                op_f2 = torch.where(f2o, me, full(L.BT_F2))
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
        any_hit = use_m1 | use_e | use_f | use_m2
        use_m = use_m1 | use_m2
        m_pred = pre_at(I_, mp.clamp(max=P - 1))
        e_pred = pre_at(I_, e_pick_p.clamp(max=P - 1))
        op_code = torch.where(use_m, 0, torch.where(use_e, 2, 1)).to(I32)
        emit = act & any_hit
        ti = n2i_of[bidx, Il]
        hw = (op_code | ((PJ - J) << 2) | ((PI - ti) << 3)) & 0xFFFF
        sel = emit.nonzero()[:, 0]
        halves[sel, nst[sel].long()] = hw[sel]
        PI = torch.where(emit, ti, PI)
        PJ = torch.where(emit, J, PJ)
        nst = nst + emit.to(I32)
        new_i = torch.where(use_m, m_pred, torch.where(use_e, e_pred, I_))
        dj = use_m | use_f
        new_j = J - dj.to(I32)
        nl = lane_w - dj.to(I32)
        new_lane = torch.where(nl < 0, nl + WB, nl)
        new_cur = torch.where(use_m, full(L.BT_ALL),
                              torch.where(use_e, e_op_sel,
                                          torch.where(use_f, f_op_sel, cur)))
        step_fail = ~any_hit
        I_ = torch.where(act, new_i, I_)
        J = torch.where(act, new_j, J)
        lane_w = torch.where(act, new_lane, lane_w)
        cur = torch.where(act, new_cur, cur)
        if_ = torch.where(act & use_m, False, if_)
        fail = fail | (act & step_fail)
        done = done | (act & (step_fail | (new_i <= 0) | (new_j <= 0)
                              | (nst >= LS)))
    misc[:, L.M_NSTEPS] = nst
    misc[:, L.M_FAIL] = fail.to(I32)
    misc[:, L.M_ENDI] = n2i_of[bidx, I_.long()]
    misc[:, L.M_ENDJ] = J
    misc[:, L.M_LASTI] = PI
    s16w = halves[:, 0::2] | (halves[:, 1::2] << 16)
    return misc, s16w.contiguous()
