"""One round's graph update on the packed state: fusion of the step
stream, Kahn FIFO re-sort with aligned grouping, max_remain.

Counterpart of ``graph_update_packed`` / ``make_graph_kernel2`` in
``abpoa_tpu/ops/poa_loop.py``, both bodies: unit weights (``wmode=0``)
and qv weights (``wmode=1``: full-word out-edge entries, and each
resolving edge adds the weight of its query base, the sink edge the
last base's). The CUDA kernel is ``csrc/graph_update.cu``, one block
per instance and one template instance per mode: the fusion data
parallel over the steps (block scans number the rows, query bases and
new nodes; each edge and aligned bundle is written by its own thread),
the Kahn sort on one thread, max_remain by pointer doubling on the
other warps while it runs (the source's head says why this equals the
serial replay). The instance's packed state sits in shared memory where
it fits (``smem_bytes``: at the default band, reads up to about 1.9 kb
with qv weights and 2.55 kb without) and stays in global memory past that
(``state_in_global``), up to the loop's R = 4096.
``graph_update_packed_ref`` reaches the same function by vectorized
torch operations, so the two check each other:

  1. vectorized fusion (every node resolution depends only on the
     pre-fusion state; new ids come from a prefix count, the last-node
     chain is a masked fill-forward, mutations are batched scatters),
  2. Kahn FIFO with aligned grouping (ref src/abpoa_graph.c:186-231),
  3. max_remain by pointer doubling over the heaviest-edge forest
     (values of ref :233-274; first-max tie-break).

Instances whose round was bad (band overflow, walk failure), whose fail
flag was already set, or whose qlen is 0 keep their graph; capacity or
sort failure sets the sticky fail flag. The graph state of a failed
instance is unspecified (the host rebuilds it on the oracle).
"""
from __future__ import annotations

import torch

from ..params import SRC_NODE_ID, SINK_NODE_ID

from . import layout as L
from ._build import check_launch, library
from .poa_loop import (GState, LoopConfig, PackedState, unpack_state,
                       pack_outp, _pack2)

I32 = torch.int32


# shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448


def out_words(cfg: LoopConfig) -> int:
    """Packed out-edge words per node: E/2 halves (wmode 0) or E full
    words (wmode 1)."""
    return cfg.E if cfg.wmode else cfg.E // 2


def smem_bytes(cfg: LoopConfig) -> int:
    """Dynamic shared memory of one graph-update block with the packed
    state in shared memory (the formula of graph_update_launch): the
    packed state, both topo maps, in-degrees, the queue, the step
    stream, the query and (wmode 1) its weights."""
    A2 = (cfg.A + 1) // 2
    return (global_smem_bytes(cfg)
            + 4 * cfg.R * (1 + out_words(cfg) + cfg.P // 2 + A2))


def global_smem_bytes(cfg: LoopConfig) -> int:
    """The same with the packed state in global memory: everything but
    the state (ctrl, outp, inp, alp)."""
    qw = (cfg.Wq + 1) // 2 if cfg.wmode else 0
    return 4 * (3 * cfg.R + cfg.R + cfg.A + 1 + cfg.LS // 2
                + (cfg.Wq + 3) // 4 + qw)


def state_in_global(cfg: LoopConfig) -> bool:
    """The kernel's residency for cfg: the packed state stays in global
    memory where it does not fit one block's shared memory."""
    return smem_bytes(cfg) > MAX_SMEM_BYTES


def _check(cfg: LoopConfig, ps: PackedState, s16w, misc, qlen, qp4, qw):
    B, R = ps.ctrl.shape[0], cfg.R
    P2, A2 = cfg.P // 2, (cfg.A + 1) // 2
    want = {"ctrl": (ps.ctrl, (B, R)),
            "outp": (ps.outp, (B, R * out_words(cfg))),
            "inp": (ps.inp, (B, R * P2)), "alp": (ps.alp, (B, R * A2)),
            "i2nn": (ps.i2nn, (B, R)), "node_n": (ps.node_n, (B,)),
            "fail": (ps.fail, (B,)), "s16w": (s16w, (B, cfg.LS // 2)),
            "misc": (misc, (B, L.M_NMISC)), "qlen": (qlen, (B,)),
            "qp4": (qp4, (B, (cfg.Wq + 3) // 4))}
    if cfg.wmode:
        if qw is None:
            raise ValueError("graph_update_packed: wmode 1 needs the "
                             "weight stream qw")
        want["qw"] = (qw, (B, (cfg.Wq + 1) // 2))
    elif qw is not None:
        raise ValueError("graph_update_packed: qw is for wmode 1 only")
    for name, (t, shape) in want.items():
        if t.dtype != I32:
            raise TypeError(f"{name}: int32 expected, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.device != ps.ctrl.device:
            raise ValueError(f"{name}: on {t.device}, ctrl on "
                             f"{ps.ctrl.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    # node ids take 16-wbits bits of a half in wmode 0, 16 bits in wmode 1
    id_bits = 16 if cfg.wmode else 16 - cfg.wbits
    if cfg.E % 2 or cfg.P % 2 or R > (1 << id_bits):
        raise ValueError(f"graph_update_packed: bad geometry {cfg}")


def graph_update_packed(cfg: LoopConfig, ps: PackedState, s16w, misc, qlen,
                        qp4, qw=None) -> PackedState:
    """Fusion + re-sort + max_remain of one round on the packed state.
    s16w [B, LS/2] and misc [B, M_NMISC] are the band DP's outputs
    (rows rebuild from misc M_LASTI); qlen [B]; qp4 [B, ceil(Wq/4)];
    qw [B, ceil(Wq/2)] the packed per-base weights (``pack_qw``), wmode 1
    only.

    CUDA tensors launch ``csrc/graph_update.cu`` (the packed state in
    shared memory, or in global memory where ``state_in_global``), which
    updates ps.ctrl/outp/inp/alp IN PLACE (the counterpart of the JAX
    kernel's input_output_aliases) and returns them with a new i2nn,
    node_n and fail; its per-step scratch (two int32 a forward step and
    instance) comes from PyTorch's caching allocator. CPU tensors run
    the plain version, which returns new tensors."""
    qlen = qlen.to(I32).contiguous()
    _check(cfg, ps, s16w, misc, qlen, qp4, qw)
    if ps.ctrl.device.type == "cpu":
        return graph_update_packed_ref(cfg, ps, s16w, misc, qlen, qp4, qw)
    if ps.ctrl.device.type != "cuda":
        raise ValueError(f"graph_update_packed: unsupported device "
                         f"{ps.ctrl.device}")
    B, dev = ps.ctrl.shape[0], ps.ctrl.device
    i2nn = torch.empty_like(ps.i2nn)
    node_n = torch.empty_like(ps.node_n)
    fail = torch.empty_like(ps.fail)
    # per-step scratch: each resolving step's node and bundled node
    work = torch.empty(B, 2 * cfg.LS, dtype=I32, device=dev)
    gmem = state_in_global(cfg)
    lib = library("graph_update")
    with torch.cuda.device(dev):
        rc = lib.graph_update_launch(
            misc.data_ptr(), qlen.data_ptr(), ps.node_n.data_ptr(),
            ps.fail.data_ptr(), ps.i2nn.data_ptr(), s16w.data_ptr(),
            qp4.data_ptr(), qw.data_ptr() if cfg.wmode else None,
            ps.ctrl.data_ptr(), ps.outp.data_ptr(), ps.inp.data_ptr(),
            ps.alp.data_ptr(), i2nn.data_ptr(), node_n.data_ptr(),
            fail.data_ptr(), work.data_ptr(), B, cfg.R, cfg.E, cfg.P, cfg.A,
            s16w.shape[1],
            qp4.shape[1], qw.shape[1] if cfg.wmode else 0, cfg.wbits,
            cfg.wmode, int(gmem), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "graph_update")
    graph_update_packed.launches += 1
    graph_update_packed.qv_launches += int(cfg.wmode)
    graph_update_packed.global_launches += int(gmem and not cfg.wmode)
    graph_update_packed.qv_global_launches += int(gmem and cfg.wmode)
    return PackedState(ps.ctrl, ps.outp, ps.inp, ps.alp, i2nn, node_n, fail)


# launches of the kernel, all instances; of its wmode-1 instances; of its
# global-memory instances in wmode 0 and in wmode 1
graph_update_packed.launches = 0
graph_update_packed.qv_launches = 0
graph_update_packed.global_launches = 0
graph_update_packed.qv_global_launches = 0


# ------------------------------------------------------------------ #
# plain PyTorch version (the independent route)

def _take(arr, idx):
    """Batched gather arr[b, idx[b, k]]; idx clipped (callers mask)."""
    return arr.gather(1, idx.clamp(0, arr.shape[1] - 1).long())


def _scatter(flat, idx, val, valid, add=False):
    """flat[b, idx] = val (or += val) where valid; dropped elsewhere."""
    B, n = flat.shape
    ext = torch.cat([flat, flat.new_zeros(B, 1)], 1)
    idx = torch.where(valid, idx, n).long()
    val = torch.where(valid, val, 0).to(flat.dtype)
    if add:
        ext.scatter_add_(1, idx, val)
    else:
        ext.scatter_(1, idx, val)
    return ext[:, :n]


def fuse_ref(cfg: LoopConfig, st: GState, i2n, s16w, misc, qlen, qcodes,
             qweights=None):
    """Vectorized fusion of one round's wire stream into the graph state
    (qweights [B, >=qlen]: per-base weights, 0-based; None: unit).
    Returns (GState, inst_ok [B], fusion_fail [B])."""
    LS = 2 * s16w.shape[1]
    halves = s16w.contiguous().view(torch.int16).to(I32) & 0xFFFF
    nst = misc[:, L.M_NSTEPS]
    kk = torch.arange(LS, dtype=I32, device=st.bases.device)[None, :]
    # topo row of push-order step k: the walk's last row (M_LASTI) plus
    # the row decrements of the steps pushed after k
    di = torch.where(kk < nst[:, None], halves >> 3, 0)
    suffix = di.flip(1).cumsum(1).flip(1)
    rows = misc[:, L.M_LASTI:L.M_LASTI + 1] + suffix - di
    return fuse_steps_ref(cfg, st, i2n, halves & 3, rows, misc, qlen, qcodes,
                          qweights)


def fuse_steps_ref(cfg: LoopConfig, st: GState, i2n, ops, rows, misc, qlen,
                   qcodes, qweights=None):
    """The fusion proper, from each push-order step's op code and topo row
    ([B, LS]). Each resolving edge adds the weight of its query base (1
    when qweights is None), the edge into the sink the last base's (ref
    weight[q], native/poagraph.c pg_add_graph_sequence). Returns
    (GState, inst_ok [B], fusion_fail [B])."""
    B, R, E, P, A = st.bases.shape[0], cfg.R, cfg.E, cfg.P, cfg.A
    dev = st.bases.device
    LS = LF = ops.shape[1]
    nst = misc[:, L.M_NSTEPS]
    ej = misc[:, L.M_ENDJ].clamp(min=0)
    bj = misc[:, L.M_BJ]
    bad = (misc[:, L.M_OVFL] | misc[:, L.M_FAIL]) > 0

    lead = ej
    trail = (qlen - bj).clamp(min=0)
    live_n = lead + nst + trail
    inst_ok = (qlen > 0) & ~bad & (st.fail == 0) & (live_n > 0)
    k = torch.arange(LF, dtype=I32, device=dev)[None, :]
    in_lead = k < lead[:, None]
    in_steps = (k >= lead[:, None]) & (k < (lead + nst)[:, None])
    in_trail = (k >= (lead + nst)[:, None]) & (k < live_n[:, None])
    live = (in_lead | in_steps | in_trail) & inst_ok[:, None]
    s = ((nst - 1)[:, None] - (k - lead[:, None])).clamp(0, LS - 1)
    op_k = _take(ops, s)
    row_k = _take(rows, s)
    is_m = live & in_steps & (op_k == 0)
    is_i = live & (in_lead | in_trail | (in_steps & (op_k == 1)))
    has_res = is_m | is_i
    # query position: one base per M or I step, in forward order
    qid = torch.cumsum(has_res.to(I32), 1) - 1
    qbase = _take(qcodes, qid + 1)

    nid = (_take(i2n, row_k) & 0xFFFF).clamp(max=R - 1)
    gb = _take(st.bases, nid)
    mism = is_m & (gb != qbase)
    als = st.al_ids.gather(
        1, nid.long()[:, :, None].expand(B, LF, A))              # [B,LF,A]
    al_n_v = _take(st.n_al, nid)
    al_b = _take(st.bases, als.reshape(B, LF * A)).reshape(B, LF, A)
    a_iota = torch.arange(A, dtype=I32, device=dev)[None, None, :]
    hit = (a_iota < al_n_v[:, :, None]) & (al_b == qbase[:, :, None])
    first_a = hit.to(I32).argmax(2)
    has_aid = hit.any(2)
    aid = als.gather(2, first_a[:, :, None])[:, :, 0]

    is_new = live & (is_i | (mism & ~has_aid))
    new_id = st.node_n[:, None] + torch.cumsum(is_new.to(I32), 1) - 1
    resolved = torch.where(is_new, new_id, torch.where(mism, aid, nid))

    # from-node of each resolving step: the previous resolving step's
    # node, SRC before any (the fusion's last-node chain)
    r_idx = torch.where(has_res, k.expand(B, LF), -1)
    run = torch.cummax(r_idx, dim=1).values
    prefix = torch.cat([torch.full((B, 1), -1, dtype=I32, device=dev),
                        run[:, :-1]], 1)
    src = torch.full((), SRC_NODE_ID, dtype=I32, device=dev)
    frm = torch.where(prefix >= 0, _take(resolved, prefix.clamp(min=0)), src)
    last_final = torch.where(run[:, -1] >= 0,
                             _take(resolved, run[:, -1:].clamp(min=0))[:, 0],
                             src)
    eu = torch.cat([frm, last_final[:, None]], 1)                # [B,LF+1]
    ev = torch.cat([resolved, torch.full((B, 1), SINK_NODE_ID, dtype=I32,
                                         device=dev)], 1)
    e_live = torch.cat([has_res, inst_ok[:, None]], 1)
    # each edge's weight: the query base of its resolving step; the sink
    # edge takes the last base's
    if qweights is None:
        e_w = torch.ones_like(eu)
    else:
        qweights = qweights.to(I32)
        e_w = torch.cat([_take(qweights, qid),
                         _take(qweights, (qlen - 1)[:, None])], 1)

    n0 = st.node_n[:, None]
    e_iota = torch.arange(E, dtype=I32, device=dev)[None, None, :]
    out_u = _take(st.out_ids.reshape(B, R * E),
                  (eu.clamp(0, R - 1)[:, :, None] * E + e_iota)
                  .reshape(B, -1)).reshape(B, LF + 1, E)
    nout_u = _take(st.n_out, eu)
    ehit = ((e_iota < nout_u[:, :, None]) & (out_u == ev[:, :, None])
            & (eu < n0)[:, :, None])
    found = ehit.any(2)
    slot_f = ehit.to(I32).argmax(2).to(I32)
    bump = e_live & found
    newe = e_live & ~found
    nin_v = _take(st.n_in, ev)
    cap_fail = (newe & ((nout_u >= E) | (nin_v >= P))).any(1)

    euc = eu.clamp(0, R - 1)
    evc = ev.clamp(0, R - 1)
    one = torch.ones_like(eu)
    out_w = _scatter(st.out_w.reshape(B, R * E), euc * E + slot_f, e_w,
                     bump, add=True)
    slot_n = euc * E + nout_u.clamp(0, E - 1)
    out_ids = _scatter(st.out_ids.reshape(B, R * E), slot_n, ev, newe)
    out_w = _scatter(out_w, slot_n, e_w, newe)
    n_out = _scatter(st.n_out, euc, one, newe, add=True)
    in_ids = _scatter(st.in_ids.reshape(B, R * P),
                      evc * P + nin_v.clamp(0, P - 1), eu, newe)
    n_in = _scatter(st.n_in, evc, one, newe, add=True)
    bases = _scatter(st.bases, new_id.clamp(0, R - 1), qbase, is_new)

    # aligned bundling of mismatch-created nodes (all-pairs, ref
    # src/abpoa_graph.c:377-401): each member of group(nid) appends the
    # new id; the new node's list is [members in order..., nid]
    mk = mism & is_new
    memb = torch.cat([als, nid[:, :, None]], 2)                 # [B,LF,A+1]
    ones_b = torch.ones(B, LF, 1, dtype=torch.bool, device=dev)
    m_valid = torch.cat([(a_iota < al_n_v[:, :, None]).expand(B, LF, A),
                         ones_b], 2) & mk[:, :, None]
    nal_m = _take(st.n_al, memb.reshape(B, -1)).reshape(B, LF, A + 1)
    al_cap_fail = (m_valid & (nal_m >= A)).any(2).any(1)
    memc = memb.clamp(0, R - 1)
    al_ids = _scatter(st.al_ids.reshape(B, R * A),
                      (memc * A + nal_m.clamp(0, A - 1)).reshape(B, -1),
                      new_id[:, :, None].expand(B, LF, A + 1).reshape(B, -1),
                      m_valid.reshape(B, -1))
    n_al = _scatter(st.n_al, memc.reshape(B, -1),
                    torch.ones_like(memc).reshape(B, -1),
                    m_valid.reshape(B, -1), add=True)
    nl_pos = torch.cat([a_iota.expand(B, LF, A), al_n_v[:, :, None]], 2)
    nidc = new_id.clamp(0, R - 1)
    al_ids = _scatter(al_ids,
                      (nidc[:, :, None] * A + nl_pos.clamp(0, A - 1))
                      .reshape(B, -1), memb.reshape(B, -1),
                      m_valid.reshape(B, -1))
    n_al = _scatter(n_al, nidc, al_n_v + 1, mk)

    node_n = st.node_n + torch.where(inst_ok, is_new.sum(1, dtype=I32), 0)
    fusion_fail = inst_ok & (cap_fail | al_cap_fail | (node_n > R))
    new = GState(bases, out_ids.reshape(B, R, E), out_w.reshape(B, R, E),
                 n_out, in_ids.reshape(B, R, P), n_in,
                 al_ids.reshape(B, R, A), n_al, node_n, st.fail)
    # a failed fusion keeps the pre-round graph (unspecified either way)
    st2 = GState(*(torch.where(
        fusion_fail.reshape((B,) + (1,) * (x.dim() - 1)), o, x)
        for x, o in zip(new, st)))
    return st2, inst_ok, fusion_fail


def kahn_ref(cfg: LoopConfig, st: GState):
    """FIFO Kahn sort with aligned grouping per instance (ref
    src/abpoa_graph.c:186-231): a node whose in-degree drops to 0 is
    queued together with its aligned list once every member is at
    in-degree 0. Returns (i2n [B, R], n2i [B, R], ok [B]); entries of
    unsorted ids are 0."""
    B, R = st.bases.shape[0], cfg.R
    out_ids = st.out_ids.cpu().tolist()
    n_out = st.n_out.cpu().tolist()
    al_ids = st.al_ids.cpu().tolist()
    n_al = st.n_al.cpu().tolist()
    n_in = st.n_in.cpu().tolist()
    node_n = st.node_n.cpu().tolist()
    i2n = [[0] * R for _ in range(B)]
    n2i = [[0] * R for _ in range(B)]
    ok = [False] * B
    for b in range(B):
        nn = min(max(node_n[b], 0), R)
        indeg = [n_in[b][v] for v in range(R)]
        queue = [SRC_NODE_ID]
        head = idx = 0
        done = False
        while head < len(queue) and not done:
            cur = queue[head]
            head += 1
            i2n[b][idx] = cur
            n2i[b][cur] = idx
            idx += 1
            if cur == SINK_NODE_ID:
                done = True
                break
            for e in range(n_out[b][cur]):
                v = out_ids[b][cur][e]
                indeg[v] -= 1
                if indeg[v] != 0:
                    continue
                grp = al_ids[b][v][:n_al[b][v]]
                if all(indeg[a] == 0 for a in grp):
                    queue.append(v)
                    queue.extend(grp)
        ok[b] = done and idx == nn
    dev = st.bases.device
    return (torch.tensor(i2n, dtype=I32, device=dev),
            torch.tensor(n2i, dtype=I32, device=dev),
            torch.tensor(ok, dtype=torch.bool, device=dev))


def remain_ref(cfg: LoopConfig, st: GState):
    """max_remain by pointer doubling over the heaviest out-edge (max
    weight, lowest slot); remain[SINK] = -1 (ref :244)."""
    B, R, E = st.bases.shape[0], cfg.R, cfg.E
    dev = st.bases.device
    e_iota = torch.arange(E, dtype=I32, device=dev)[None, None, :]
    valid = e_iota < st.n_out[:, :, None]
    key = torch.where(valid, st.out_w * E + (E - 1 - e_iota), -1)
    slot = key.argmax(2)
    nxt = st.out_ids.gather(2, slot[:, :, None])[:, :, 0]
    rid = torch.arange(R, dtype=I32, device=dev)[None, :]
    is_sink = rid == SINK_NODE_ID
    nxt = torch.where(valid.any(2) & ~is_sink, nxt, SINK_NODE_ID)
    d = torch.where(is_sink, 0, 1).to(I32).expand(B, R).contiguous()
    for _ in range(max(1, (R - 1).bit_length())):
        d = d + _take(d, nxt)
        nxt = _take(nxt, nxt)
    return d - 1


def graph_update_packed_ref(cfg: LoopConfig, ps: PackedState, s16w, misc,
                            qlen, qp4, qw=None) -> PackedState:
    """Plain PyTorch version of the graph kernel (see the module doc)."""
    B, R = ps.ctrl.shape[0], cfg.R
    st, i2n, _n2i, _rem = unpack_state(cfg, ps)
    qcodes = torch.stack([(qp4 >> (8 * j)) & 0xFF for j in range(4)],
                         dim=2).reshape(B, -1)
    qweights = None
    if cfg.wmode:
        qweights = torch.stack([qw & 0xFFFF, (qw >> 16) & 0xFFFF],
                               dim=2).reshape(B, -1)
    st2, inst_ok, fusion_fail = fuse_ref(cfg, st, i2n, s16w, misc, qlen,
                                         qcodes, qweights)
    i2n2, n2i2, topo_ok = kahn_ref(cfg, st2)
    remain = remain_ref(cfg, st2)
    bad = (misc[:, L.M_OVFL] | misc[:, L.M_FAIL]) > 0
    skip = (bad | (ps.fail > 0) | (qlen == 0)
            | (misc[:, L.M_ENDJ].clamp(min=0) + misc[:, L.M_NSTEPS]
               + (qlen - misc[:, L.M_BJ]).clamp(min=0) == 0))
    fail = ((ps.fail > 0) | (bad & (qlen > 0)) | fusion_fail
            | (~skip & ~topo_ok)).to(I32)
    live = (torch.arange(R, device=ps.ctrl.device)[None, :]
            < st2.node_n[:, None])
    rem = torch.where(live, remain, ps.ctrl >> 16)
    ctrl = (st2.bases | (st2.n_out << 3) | (st2.n_al << 7)
            | (st2.n_in << 10) | ((rem & 0xFFFF) << 16))
    P2, A2 = cfg.P // 2, (cfg.A + 1) // 2
    outp = pack_outp(cfg, st2.out_ids, st2.out_w)
    inp = _pack2(st2.in_ids, B, R, P2)
    alp = _pack2(st2.al_ids, B, R, A2)
    i2nn = (i2n2 & 0xFFFF) | (n2i2 << 16)
    return PackedState(ctrl.contiguous(), outp.contiguous(),
                       inp.contiguous(), alp.contiguous(),
                       i2nn.contiguous(), st2.node_n.contiguous(), fail)
