"""The device-resident progressive POA loop in PyTorch.

Counterpart of ``abpoa_tpu/ops/poa_loop.py``. Read 0 of every instance
is fused on the host; each later read is one ROUND on the device:

    build_scal (torch glue) -> band DP kernel -> graph-update kernel

all on the current CUDA stream with no host synchronisation between
rounds. The graph state crosses the rounds in the packed form both
kernels read directly (``PackedState``); the host gets the per-round
``misc`` rows and step streams at the end and replays them through the
native C fusion (``parallel/batch.py``).

Semantics replicated bit-exactly (all orders are byte-parity-critical):
fusion ref src/abpoa_graph.c:596-672 (native/poagraph.c pg_fuse_steps),
Kahn FIFO with aligned grouping ref :186-231, max_remain ref :233-274.

``device_round(split=True)`` runs one round in the split form instead:
the topo-mode band DP, the vectorized fusion (``fuse_batch``), the
standalone Kahn sort (``ops/topo.py``) and ``remain_ref``; it is the
second implementation the packed round is held against.

Scope: global mode, banded, m == 5, any gap mode; unit weights
(``wmode=0``: out-edge entries are 16-bit halves ``id | w<<(16-wbits)``)
or qv weights (``wmode=1``: out-edge entries are full words
``id | w<<16`` and a per-base weight stream feeds the fusion).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import layout as L


class LoopConfig(NamedTuple):
    R: int          # node-id capacity == DP row capacity
    E: int          # out-degree capacity
    P: int          # in-degree capacity (DP predecessor slots)
    A: int          # aligned-list capacity (m=5 -> 4 is exact)
    Wq: int         # padded query width
    WB: int         # band tile width
    LS: int         # step-stream capacity (walk length bound)
    NR: int         # number of device rounds (reads 1..NR)
    B: int          # batch
    pn: int         # lane-snapping segment width of the 16-bit dispatch
    inf_min: int
    gap_mode: int
    wbits: int = 4  # out-edge weight bits above the 16-wbits id bits
    #                 (wmode 0 only)
    wmode: int = 0  # 0 = unit weights, out-edge halves; 1 = qv weights,
    #                 out-edge words id | w<<16 (every edge's weight sum
    #                 < 2^15, bounded by the dispatcher) and a per-base
    #                 weight stream (ref weight[q] per resolving edge,
    #                 native/poagraph.c pg_add_graph_sequence)


class GState(NamedTuple):
    """Per-instance graph state, all [B, ...]; node ids are array rows."""
    bases: object    # [B, R]
    out_ids: object  # [B, R, E]
    out_w: object    # [B, R, E]
    n_out: object    # [B, R]
    in_ids: object   # [B, R, P]
    n_in: object     # [B, R]
    al_ids: object   # [B, R, A]
    n_al: object     # [B, R]
    node_n: object   # [B]
    fail: object     # [B] (sticky)


class PackedState(NamedTuple):
    """The loop carry in the packed form both kernels consume.
    ctrl: base(3)|n_out(4)<<3|n_al(3)<<7|n_in(4)<<10|remain(16,s)<<16;
    outp: out-edge halves id|w<<(16-wbits) (wmode 0) or words id|w<<16
    (wmode 1); inp/alp: id halves; i2nn: the topo maps packed as
    i2n | n2i<<16. All int32."""
    ctrl: torch.Tensor    # [B, R]
    outp: torch.Tensor    # [B, R*E//2] (wmode 0) or [B, R*E] (wmode 1)
    inp: torch.Tensor     # [B, R*P//2]
    alp: torch.Tensor     # [B, R*((A+1)//2)]
    i2nn: torch.Tensor    # [B, R]
    node_n: torch.Tensor  # [B]
    fail: torch.Tensor    # [B]


I32 = torch.int32


def _pack2(x, B, R, k2):
    x = x.to(I32) & 0xFFFF
    if x.shape[2] % 2:
        x = torch.cat([x, x.new_zeros(B, R, 1)], dim=2)
    return (x[:, :, 0::2] | (x[:, :, 1::2] << 16)).reshape(B, R * k2)


def _unpack2(x, B, R, k, cap):
    x = x.reshape(B, R, k)
    full = torch.stack([x & 0xFFFF, (x >> 16) & 0xFFFF], dim=3)
    return full.reshape(B, R, 2 * k)[:, :, :cap]


def pack_state(cfg: LoopConfig, st: GState, i2n, n2i, remain) -> PackedState:
    """GState (+ topo/remain arrays, node-id indexed) -> PackedState.
    All inputs are int tensors on one device."""
    B, R = st.bases.shape[0], cfg.R
    P2, A2 = cfg.P // 2, (cfg.A + 1) // 2
    st = GState(*(x.to(I32) for x in st))
    ctrl = (st.bases | (st.n_out << 3) | (st.n_al << 7) | (st.n_in << 10)
            | ((remain.to(I32) & 0xFFFF) << 16))
    outp = pack_outp(cfg, st.out_ids, st.out_w)
    inp = _pack2(st.in_ids, B, R, P2)
    alp = _pack2(st.al_ids, B, R, A2)
    i2nn = (i2n.to(I32) & 0xFFFF) | (n2i.to(I32) << 16)
    return PackedState(ctrl.contiguous(), outp.contiguous(),
                       inp.contiguous(), alp.contiguous(),
                       i2nn.contiguous(), st.node_n.contiguous(),
                       st.fail.contiguous())


def pack_outp(cfg: LoopConfig, out_ids, out_w):
    """Out-edge ids and weights [B, R, E] -> the packed out-edge entries:
    halves id | w<<(16-wbits) (wmode 0) or words id | w<<16 (wmode 1)."""
    B, R = out_ids.shape[0], cfg.R
    out_ids, out_w = out_ids.to(I32), out_w.to(I32)
    if cfg.wmode:
        return (out_ids | (out_w << 16)).reshape(B, R * cfg.E)
    return _pack2(out_ids | (out_w << (16 - cfg.wbits)), B, R, cfg.E // 2)


def unpack_outp(cfg: LoopConfig, outp):
    """The packed out-edge entries -> (out_ids, out_w), each [B, R, E]."""
    B, R, E = outp.shape[0], cfg.R, cfg.E
    if cfg.wmode:
        ow = outp.reshape(B, R, E)
        return ow & 0xFFFF, ow >> 16
    IDB = 16 - cfg.wbits
    ow = _unpack2(outp, B, R, E // 2, E)
    return ow & ((1 << IDB) - 1), ow >> IDB


def unpack_state(cfg: LoopConfig, ps: PackedState):
    """PackedState -> (GState, i2n, n2i, remain)."""
    B, R = ps.ctrl.shape[0], cfg.R
    P, A = cfg.P, cfg.A
    P2, A2 = P // 2, (A + 1) // 2
    ctrl = ps.ctrl
    out_ids, out_w = unpack_outp(cfg, ps.outp)
    st = GState(
        bases=ctrl & 7,
        out_ids=out_ids, out_w=out_w,
        n_out=(ctrl >> 3) & 15,
        in_ids=_unpack2(ps.inp, B, R, P2, P), n_in=(ctrl >> 10) & 15,
        al_ids=_unpack2(ps.alp, B, R, A2, A), n_al=(ctrl >> 7) & 7,
        node_n=ps.node_n, fail=ps.fail)
    return st, ps.i2nn & 0xFFFF, ps.i2nn >> 16, ctrl >> 16


def s16w_to_s16(s16w: torch.Tensor) -> torch.Tensor:
    """Wire words (2 steps16 halves per int32, low half = even step) ->
    the flat int16 stream. Little-endian int32 -> int16 view."""
    return s16w.contiguous().view(torch.int16)


def pack_qp4(cfg: LoopConfig, qcodes: torch.Tensor) -> torch.Tensor:
    """Query codes [..., Wq] -> 4 bases per int32 word for the graph
    update's reads. Leading axes are free."""
    qb = qcodes.to(I32) & 0xFF
    if cfg.Wq % 4:
        pad = qb.new_zeros(*qb.shape[:-1], 4 - cfg.Wq % 4)
        qb = torch.cat([qb, pad], dim=-1)
    return (qb[..., 0::4] | (qb[..., 1::4] << 8) | (qb[..., 2::4] << 16)
            | (qb[..., 3::4] << 24)).contiguous()


def pack_qw(cfg: LoopConfig, qweights: torch.Tensor) -> torch.Tensor:
    """Per-base weights [..., Wq] (0-based: the weight of query base i at
    i; each < 2^15) -> 16-bit halves, two per int32 word, low half even
    (wmode 1 only). Leading axes are free."""
    w = qweights.to(I32) & 0xFFFF
    if cfg.Wq % 2:
        w = torch.cat([w, w.new_zeros(*w.shape[:-1], 1)], dim=-1)
    return (w[..., 0::2] | (w[..., 1::2] << 16)).contiguous()


# ------------------------------------------------------------------ #
# host-side state init (numpy; re-hosted from the JAX package)

def init_state_np(graphs, cfg: LoopConfig):
    """Initial GState (numpy) + topo/remain arrays from host graphs that
    already contain read 0 and are topologically sorted."""
    B, R, E, P, A = cfg.B, cfg.R, cfg.E, cfg.P, cfg.A
    z = np.zeros
    bases = z((B, R), np.int32)
    out_ids = z((B, R, E), np.int32)
    out_w = z((B, R, E), np.int32)
    n_out = z((B, R), np.int32)
    in_ids = z((B, R, P), np.int32)
    n_in = z((B, R), np.int32)
    al_ids = z((B, R, A), np.int32)
    n_al = z((B, R), np.int32)
    node_n = z(B, np.int32)
    fail = z(B, np.int32)
    i2n = z((B, R), np.int32)
    n2i = z((B, R), np.int32)
    remain = z((B, R), np.int32)

    def fill(dst_ids, dst_n, flat, off, b, n, extra=None, dst_w=None):
        cnt = (off[1:] - off[:-1]).astype(np.int64)
        if cnt[:n].max(initial=0) > dst_ids.shape[2]:
            return False
        rows = np.repeat(np.arange(n), cnt[:n])
        pos = np.arange(len(rows)) - np.repeat(
            np.cumsum(cnt[:n]) - cnt[:n], cnt[:n])
        dst_ids[b, rows, pos] = flat[:len(rows)]
        dst_n[b, :n] = cnt[:n]
        if dst_w is not None:
            dst_w[b, rows, pos] = extra[:len(rows)]
        return True

    for b, g in enumerate(graphs):
        c = g.build_csr()
        n = c["n"]
        if n > R:
            fail[b] = 1
            node_n[b] = min(n, R)
            continue
        node_n[b] = n
        bases[b, :n] = c["bases"][:n]
        ok = fill(out_ids, n_out, c["out_flat"], c["out_off"], b, n,
                  extra=c["out_w_flat"], dst_w=out_w)
        ok &= fill(in_ids, n_in, c["in_flat"], c["in_off"], b, n)
        ok &= fill(al_ids, n_al, c["al_flat"], c["al_off"], b, n)
        if not ok:
            fail[b] = 1
            continue
        i2n[b, :n] = np.asarray(g.index_to_node_id[:n])
        n2i[b, :n] = np.asarray(g.node_id_to_index[:n])
        remain[b, :n] = np.asarray(g.node_id_to_max_remain[:n])
    stt = GState(bases, out_ids, out_w, n_out, in_ids, n_in, al_ids,
                 n_al, node_n, fail)
    return stt, i2n, n2i, remain


def make_scal_base(params, cfg: LoopConfig) -> np.ndarray:
    """Static scal template (gaps/zdrop/matrix/inf_min); the per-instance
    slots are set each round by build_scal."""
    m = params.m
    scal = np.zeros(L.S_NSCAL + m * m, dtype=np.int32)
    scal[L.S_INF] = cfg.inf_min
    scal[L.S_E1] = params.gap_ext1
    scal[L.S_O1] = params.gap_open1
    scal[L.S_OE1] = params.gap_oe1
    scal[L.S_E2] = params.gap_ext2
    scal[L.S_O2] = params.gap_open2
    scal[L.S_OE2] = params.gap_oe2
    scal[L.S_ZDROP] = params.zdrop
    scal[L.S_NSCAL:] = np.asarray(params.mat, dtype=np.int64).reshape(-1)
    return scal


# ------------------------------------------------------------------ #
# the loop

def band_config(cfg: LoopConfig):
    from .band_dp import BandConfig
    return BandConfig(gap_mode=cfg.gap_mode, pn=cfg.pn, R=cfg.R, WB=cfg.WB,
                      Wq=cfg.Wq, P=cfg.P, m=5, bt_lmax=cfg.LS)


def build_scal(cfg: LoopConfig, ps: PackedState, qlen, scal_base, wb: int,
               wf1000: int) -> torch.Tensor:
    """Per-round scal rows [B, S_NSCAL] from the carry: the only glue
    between the two kernels. w = wb + (wf1000*qlen)//1000 matches the
    host's int(wf*qlen) for the reference's wf=0.01."""
    B = ps.ctrl.shape[0]
    scal = scal_base[:L.S_NSCAL].to(I32).expand(B, L.S_NSCAL).clone()
    qlen = qlen.to(I32)
    scal[:, L.S_W] = wb + (wf1000 * qlen) // 1000
    scal[:, L.S_QLEN] = qlen
    scal[:, L.S_NROWS] = ps.node_n
    scal[:, L.S_DPSN] = qlen // cfg.pn + 1
    # remain of the last topo node (SINK, -1, for whole-graph rounds)
    last = (ps.node_n - 1).clamp(0, cfg.R - 1).long()[:, None]
    lastn = (ps.i2nn.gather(1, last) & 0xFFFF).clamp(max=cfg.R - 1)
    scal[:, L.S_REMEND] = (ps.ctrl.gather(1, lastn.long()) >> 16)[:, 0]
    return scal


def device_round_packed(cfg: LoopConfig, ps: PackedState, qlen, qpf, qp4,
                        scal_base, wb: int, wf1000: int, misc_out=None,
                        s16_out=None, qw=None):
    """One POA round on the device: the band DP reads the packed state
    and emits (misc, steps16 wire words); the graph update consumes them
    (with the round's packed weights qw [B, ceil(Wq/2)] in wmode 1).
    On a CUDA state the graph update rewrites ps's state arrays in
    place. Returns (PackedState, misc, s16w)."""
    from .band_dp import band_poa_dp_packed
    from .graph_update import graph_update_packed
    scal = build_scal(cfg, ps, qlen, scal_base, wb, wf1000)
    misc, s16w = band_poa_dp_packed(band_config(cfg), scal, ps.ctrl,
                                    ps.inp, ps.i2nn, qpf,
                                    misc_out=misc_out, s16_out=s16_out)
    ps2 = graph_update_packed(cfg, ps, s16w, misc, qlen, qp4, qw=qw)
    return ps2, misc, s16w


def poa_device_loop(cfg: LoopConfig, st0: GState, i2n0, n2i0, remain0,
                    qcodes_rounds, qlen_rounds, scal_base, wb: int,
                    wf1000: int, qw_rounds=None):
    """NR rounds on the packed carry, all enqueued on the current stream
    with no host synchronisation. The query-profile folds, packed query
    codes and (wmode 1) packed weights of all rounds are built before
    the first round. qw_rounds [NR, B, Wq]: the per-base weight stream,
    wmode 1 only. Inputs are tensors on one device. Returns (final
    PackedState, misc [NR, B, M_NMISC], s16w [NR, B, LS//2])."""
    from .band_dp import build_qpf
    ps = pack_state(cfg, st0, i2n0, n2i0, remain0)
    B = ps.ctrl.shape[0]
    dev = ps.ctrl.device
    qpf_rounds = build_qpf(band_config(cfg), scal_base[L.S_NSCAL:],
                           qcodes_rounds)
    qp4_rounds = pack_qp4(cfg, qcodes_rounds)
    if (qw_rounds is not None) != bool(cfg.wmode):
        raise ValueError("poa_device_loop: a weight stream goes with "
                         "wmode 1 and only with it")
    qw2_rounds = pack_qw(cfg, qw_rounds) if cfg.wmode else None
    misc = torch.zeros(cfg.NR, B, L.M_NMISC, dtype=I32, device=dev)
    s16w = torch.zeros(cfg.NR, B, cfg.LS // 2, dtype=I32, device=dev)
    for r in range(cfg.NR):
        ps, _, _ = device_round_packed(
            cfg, ps, qlen_rounds[r], qpf_rounds[r], qp4_rounds[r],
            scal_base, wb, wf1000, misc_out=misc[r], s16_out=s16w[r],
            qw=qw2_rounds[r] if cfg.wmode else None)
    return ps, misc, s16w


# ------------------------------------------------------------------ #
# the split form of one round: topo-mode band DP, vectorized fusion,
# standalone Kahn sort, max_remain (the second implementation of the
# round, held against the packed two-kernel form)

def fuse_batch(cfg: LoopConfig, st: GState, i2n, steps, misc, qcodes, qlen):
    """Fuse one round's step words (int64 op|row<<2|col<<32 in push
    order, rows in topo space) into the graph state, with the plain graph
    update's vectorized fusion. Instances whose round was bad (overflow,
    walk failure) or whose fusion overran a capacity set the sticky fail
    flag and keep their graph."""
    from .graph_update import fuse_steps_ref
    from .steps import step_fields
    misc, qlen = misc.to(I32), qlen.to(I32)
    op, row, _col = step_fields(steps.to(torch.int64))
    st2, inst_ok, fusion_fail = fuse_steps_ref(
        cfg, st, i2n.to(I32), op.to(I32), row.to(I32), misc, qlen,
        qcodes.to(I32) & 0xFF)
    bad = (misc[:, L.M_OVFL] | misc[:, L.M_FAIL]) > 0
    fail = (st.fail > 0) | (inst_ok & fusion_fail) | (bad & (qlen > 0))
    return st2._replace(fail=fail.to(I32))


def build_dp_inputs(cfg: LoopConfig, st: GState, i2n, n2i, remain, qlen,
                    scal_base, wb: int, wf1000: int):
    """The topo-mode band kernel's inputs of one round, gathered from the
    graph state in topo order (the export of ``align/export.py`` on the
    device). Returns (scal [B, S_NSCAL + m*m], bases, pre_idx [B, R, P],
    pre_n, remain) by topo row; rows past node_n are 0. The state is
    int32."""
    from .graph_update import _take
    B, R, P = st.bases.shape[0], cfg.R, cfg.P
    dev = st.bases.device
    t = torch.arange(R, dtype=I32, device=dev)[None, :]
    live = t < st.node_n[:, None]
    nid = torch.where(live, i2n.to(I32), 0)
    bases_row = torch.where(live, _take(st.bases, nid), 0)
    pre_nn = torch.where(live, _take(st.n_in, nid), 0)
    pre_raw = st.in_ids.gather(
        1, nid.clamp(0, R - 1).long()[:, :, None].expand(B, R, P))
    pre_top = _take(n2i.to(I32), pre_raw.reshape(B, R * P)).reshape(B, R, P)
    p_iota = torch.arange(P, dtype=I32, device=dev)[None, None, :]
    pre_idx = torch.where(live[:, :, None] & (p_iota < pre_nn[:, :, None]),
                          pre_top, 0)
    remain_row = torch.where(live, _take(remain.to(I32), nid), 0)
    qlen = qlen.to(I32)
    scal = scal_base.to(I32)[None, :].expand(B, -1).clone()
    scal[:, L.S_W] = wb + (wf1000 * qlen) // 1000
    scal[:, L.S_QLEN] = qlen
    scal[:, L.S_NROWS] = st.node_n
    scal[:, L.S_DPSN] = qlen // cfg.pn + 1
    scal[:, L.S_REMEND] = _take(remain_row, st.node_n[:, None] - 1)[:, 0]
    return scal, bases_row, pre_idx, pre_nn, remain_row


def device_round(cfg: LoopConfig, st: GState, i2n, n2i, remain, qcodes,
                 qlen, scal_base, wb: int, wf1000: int, split: bool = False):
    """One POA round on the GState API. split=False runs the packed
    two-kernel route the device loop runs (band DP in node-id mode + the
    graph update); split=True runs the split route: topo-mode band DP
    (fresh band state), ``fuse_batch``, the standalone Kahn sort
    (``ops/topo.py``) and ``remain_ref``, with a failed sort setting
    the fail flag. Returns (GState, i2n, n2i, remain, misc, steps16)."""
    from .band_dp import band_poa_dp_batch, build_qpf, steps16_compress
    from .graph_update import remain_ref
    from .topo import topo_batch
    bc = band_config(cfg)
    if not split:
        ps = pack_state(cfg, st, i2n, n2i, remain)
        qpf = build_qpf(bc, scal_base[L.S_NSCAL:], qcodes)
        qp4 = pack_qp4(cfg, qcodes)
        ps2, misc, s16w = device_round_packed(cfg, ps, qlen, qpf, qp4,
                                              scal_base, wb, wf1000)
        st2, i2n2, n2i2, remain2 = unpack_state(cfg, ps2)
        return st2, i2n2, n2i2, remain2, misc, s16w_to_s16(s16w)
    B, R, P = st.bases.shape[0], cfg.R, cfg.P
    scal, bases_row, pre_idx, pre_nn, remain_row = build_dp_inputs(
        cfg, st, i2n, n2i, remain, qlen, scal_base, wb, wf1000)
    # fresh band state and an all-ones rowmask: the kernel synthesises
    # them, so those inputs (and the unused out-edges) are dummies
    dummy = torch.zeros(B, 1, dtype=torch.int8, device=bases_row.device)
    out = band_poa_dp_batch(
        bc._replace(nid=False), scal, bases_row.to(torch.int8),
        pre_idx.reshape(B, R * P).to(torch.int16), pre_nn.to(torch.int8),
        dummy, dummy, remain_row.to(torch.int16), qcodes.to(torch.int8),
        dummy, dummy, dummy)
    st2 = fuse_batch(cfg, st, i2n, out.steps, out.misc, qcodes, qlen)
    i2n2, n2i2, ok = topo_batch(cfg, st2)
    fail = (st2.fail > 0) | (~ok & (qlen.to(I32) > 0))
    st2 = st2._replace(fail=fail.to(I32))
    return (st2, i2n2, n2i2, remain_ref(cfg, st2), out.misc,
            steps16_compress(out.steps, out.misc))


__all__ = ["LoopConfig", "GState", "PackedState", "pack_state",
           "unpack_state", "pack_outp", "unpack_outp", "s16w_to_s16",
           "pack_qp4", "pack_qw", "init_state_np",
           "make_scal_base", "build_scal", "device_round_packed",
           "poa_device_loop", "fuse_batch", "build_dp_inputs",
           "device_round"]
