"""abpoa_tpu_torch: the plain graph update (vectorized fusion + FIFO Kahn
+ pointer-doubling remain) against the JAX graph kernel (interpret mode)
and against the host POAGraph (CSR lists, topo order, max_remain), on
step streams derived from the oracle's alignments. Exact equality.
"""
import pathlib

import numpy as np
import pytest
import torch


from abpoa_tpu.params import Params, SRC_NODE_ID, SINK_NODE_ID

# paths spelled out here (not imported from conftest) so the gpu tests
# also run with --noconftest on a host without JAX
DATA = pathlib.Path(__file__).resolve().parent / "data"

torch.set_num_threads(1)


def _reads(fn, n):
    from abpoa_tpu.seqio import read_seqs
    from abpoa_tpu.alphabet import encode_table
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / fn))][:n]


def _jax_cfg(params, maxlen, B, R):
    from abpoa_tpu.align.engine_np import score_width_dispatch
    from abpoa_tpu.align.engine_jax import pick_WB
    from abpoa_tpu.ops.poa_loop import LoopConfig
    bits, pn, _ln, inf_min = score_width_dispatch(params, R, maxlen)
    WB = pick_WB(params, maxlen, pn)
    Wq = ((maxlen // 128) + 1) * 128
    Wq = (Wq + WB - 1) // WB * WB
    LS = (R + Wq + 63) // 64 * 64
    return LoopConfig(R=R, E=12, P=8, A=4, Wq=Wq, WB=WB, LS=LS, NR=1, B=B,
                      G=1, GT=B, pn=pn, inf_min=inf_min,
                      gap_mode=params.gap_mode, use_zdrop=False)


def _oracle_steps(g, params, q, LS):
    """The oracle's alignment of q as a stream of the port's int64 step
    words (push order) + misc, the inverse of bt_xla.replay_steps
    (``_legacy`` gives the JAX package's int32 words of the same steps)."""
    from abpoa_tpu.align.engine_np import align_sequence_to_subgraph
    from abpoa_tpu.cigar import CMATCH, CINS, CDEL
    from abpoa_tpu_torch.ops import layout as L
    res = align_sequence_to_subgraph(g, params, SRC_NODE_ID, SINK_NODE_ID, q)
    n2i = np.asarray(g.node_id_to_index)
    fwd, j, lead, trail, prev_row = [], 0, 0, 0, 0
    ent = list(res.cigar)
    if ent and ent[0][0] == CINS and ent[0][1] == ent[0][2] - 1:
        lead = j = ent[0][2]
        ent = ent[1:]
    for e in ent:
        if e[0] == CMATCH:
            j += 1
            prev_row = int(n2i[e[1]])
            fwd.append((0, prev_row, j))
        elif e[0] == CDEL:
            prev_row = int(n2i[e[1]])
            fwd.append((2, prev_row, j))
        elif e[0] == CINS:
            for _ in range(e[2]):
                j += 1
                fwd.append((1, prev_row, j))
    while fwd and fwd[-1][0] == 1:
        trail += 1
        fwd.pop()
    from abpoa_tpu_torch.ops.steps import pack_steps
    steps = np.zeros(LS, np.int64)
    for k, (op, row, col) in enumerate(reversed(fwd)):
        steps[k] = pack_steps(op, row, col)
    misc = np.zeros(L.M_NMISC, np.int32)
    misc[L.M_NSTEPS] = len(fwd)
    misc[L.M_BJ] = len(q) - trail
    misc[L.M_ENDJ] = lead
    misc[L.M_BI] = fwd[-1][1] if fwd else 0
    return res, steps, misc


def _legacy(steps):
    """The JAX package's int32 words op|row<<2|col<<14 of the port's step
    words (rows below 4096, columns below 2^17)."""
    from abpoa_tpu_torch.ops.steps import step_fields
    op, row, col = step_fields(np.asarray(steps, np.int64))
    assert (row < 4096).all() and (col < (1 << 17)).all()
    return (op | (row << 2) | (col << 14)).astype(np.int32)


def _port_state(graphs, cfg, device="cpu"):
    """The JAX package's init_state_np of its host graphs, carried across
    by convert.loop_inputs and packed by the port."""
    from abpoa_tpu.ops import poa_loop as pls
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.ops import poa_loop as tpl
    jcfg = pls.LoopConfig(**cfg._asdict(), G=1, GT=cfg.B, use_zdrop=False)
    return tpl.pack_state(cfg, *convert.loop_inputs(
        *pls.init_state_np(graphs, jcfg), device))


def _wire(steps, misc):
    from abpoa_tpu_torch.ops import steps as tst
    return tst.steps_to_s16w(torch.from_numpy(steps),
                             torch.from_numpy(misc))


_JAX_GU = {}


def _jax_graph_update(cfg, ps, s16w, misc, qlen, qc, qw=None):
    """The JAX graph kernel in interpret mode (numpy/torch round inputs,
    query codes qc [B, Wq], weights qw [B, Wq] in wmode 1), jitted once
    per geometry: one compile serves every round of a test module, each
    then runs in milliseconds."""
    import jax
    import jax.numpy as jnp
    from abpoa_tpu.ops import poa_loop as pls
    key = (cfg, qw is None)
    if key not in _JAX_GU:
        def run(ps, s16w, misc, qlen, qp4, *qw2):
            return pls.graph_update_packed(cfg, ps, s16w, misc, qlen, qp4,
                                           qw=qw2[0] if qw2 else None,
                                           interpret=True)
        _JAX_GU[key] = jax.jit(run)
    args = [ps, jnp.asarray(np.asarray(s16w)), jnp.asarray(np.asarray(misc)),
            jnp.asarray(np.asarray(qlen)), pls.pack_qp4(cfg, jnp.asarray(qc))]
    if qw is not None:
        args.append(pls.pack_qw(cfg, jnp.asarray(qw)))
    return _JAX_GU[key](*args)


def _fwd(steps, misc, qlen):
    """A round's steps in forward order as (op, row, col), col the 1-based
    query base; the lead and trailing insertions carry row -1."""
    from abpoa_tpu_torch.ops.steps import step_fields
    from abpoa_tpu_torch.ops import layout as L
    nst = int(misc[L.M_NSTEPS])
    op, row, col = step_fields(np.asarray(steps[:nst], np.int64))
    return ([(1, -1, j + 1) for j in range(int(misc[L.M_ENDJ]))]
            + [(int(o), int(r), int(c))
               for o, r, c in zip(op[::-1], row[::-1], col[::-1])]
            + [(1, -1, j + 1) for j in range(int(misc[L.M_BJ]), qlen)])


def _resolving(st, i2n, b, steps, misc, qc, qlen):
    """The resolving steps of instance b as (op, node, match, col): node
    the pre-fusion node of an M step (None for an insertion)."""
    out = []
    for op, row, col in _fwd(steps, misc, qlen):
        if op == 2:
            continue
        node = int(i2n[b, row]) & 0xFFFF if op == 0 else None
        match = op == 0 and int(st.bases[b, node]) == int(qc[col])
        out.append((op, node, match, col))
    return out


def _add_node(st, b, base):
    v = int(st.node_n[b])
    st.node_n[b] += 1
    st.bases[b, v] = base
    return v


def _add_edge(st, b, u, v, w=1):
    k = st.n_out[b, u]
    st.out_ids[b, u, k], st.out_w[b, u, k] = v, w
    st.n_out[b, u] += 1
    k = st.n_in[b, v]
    st.in_ids[b, v, k] = u
    st.n_in[b, v] += 1


def _edit(what, st, i2n, b, steps, misc, qc, qlen, cfg):
    """Edit instance b's state (and query) for `what`; returns (expected
    fail flag, the node the edit is about)."""
    res = _resolving(st, i2n, b, steps, misc, qc, qlen)
    inner = [(k, r) for k, r in enumerate(res)
             if r[1] not in (None, SRC_NODE_ID, SINK_NODE_ID)]
    if what is None:
        return 0, None
    if what == "sticky":
        st.fail[b] = 1
        return 1, None
    if what == "aligned_full":
        # X (matched by the round, a chain node) gets a full aligned group
        # of A=4 fake members (a clique, between X's neighbours) whose
        # bases miss the query's, which is changed to mismatch X: the new
        # node would make the group A + 2 > A + 1
        for _k, (op, x, match, col) in inner:
            if not (match and st.n_in[b, x] == st.n_out[b, x] == 1
                    and st.n_al[b, x] == 0):
                continue
            p_, s_ = int(st.in_ids[b, x, 0]), int(st.out_ids[b, x, 0])
            if st.n_out[b, p_] + 4 > cfg.E or st.n_in[b, s_] + 5 > cfg.P:
                continue
            c = (int(st.bases[b, x]) + 1) % 4
            qc[col] = c
            grp = [x] + [_add_node(st, b, base)
                         for base in range(5) if base != c]
            for m in grp[1:]:
                _add_edge(st, b, p_, m)
                _add_edge(st, b, m, s_)
            for m in grp:
                others = [y for y in grp if y != m]
                st.al_ids[b, m, :len(others)] = others
                st.n_al[b, m] = len(others)
            return 1, x
    if what in ("out_full", "out_edge"):
        # u (matched) is followed by an insertion: a new edge from u, whose
        # out-list is filled to E (fail) or E - 1 (fills to E) with fake
        # dead ends
        for k, (op, u, match, col) in inner:
            if match and k + 1 < len(res) and res[k + 1][0] == 1:
                fill = cfg.E - (what == "out_edge")
                while st.n_out[b, u] < fill:
                    _add_edge(st, b, u, _add_node(st, b, 0))
                return int(what == "out_full"), u
    if what in ("in_full", "in_edge"):
        # v (matched) follows an insertion: a new edge into v, whose
        # in-list is filled to P (fail) or P - 1 with fake nodes from SRC
        for k, (op, v, match, col) in inner:
            if match and k > 0 and res[k - 1][0] == 1:
                fill = cfg.P - (what == "in_edge")
                while st.n_in[b, v] < fill:
                    f = _add_node(st, b, 0)
                    _add_edge(st, b, SRC_NODE_ID, f)
                    _add_edge(st, b, f, v)
                return int(what == "in_full"), v
    raise AssertionError(f"no step for {what}")


EDGE_ROUNDS = {"aligned_full": ("aligned_full", None),
               "capacity_fail": ("out_full", "in_full"),
               "capacity_edge": ("out_edge", "in_edge"),
               "sticky": ("sticky", None)}


def _edge_round(kind):
    """One round of two seq.fa instances (the graphs of reads 0 and 1,
    query read 2, the oracle's alignments; the geometry and shapes of
    test_graph_update_ref_equals_jax_kernel) with each instance's state
    edited per EDGE_ROUNDS[kind]. Returns (JAX cfg, init_state_np's
    tuple, s16w, misc, qlen, qc, expected fail flags, the edited
    nodes)."""
    from abpoa_tpu.graph import POAGraph
    from abpoa_tpu.ops import poa_loop as pls
    params = Params().post_set()
    reads = _reads("seq.fa", 4)
    B = 2
    cfg = _jax_cfg(params, max(len(q) for q in reads), B, 192)
    graphs = []
    for r0 in (0, 1):
        g = POAGraph()
        g.add_graph_alignment(params, reads[r0], [1] * len(reads[r0]), [],
                              None, 0, True)
        g.topological_sort(params)
        graphs.append(g)
    st, i2n, n2i, remain = pls.init_state_np(graphs, cfg)
    q = reads[2]
    steps = np.zeros((B, cfg.LS), np.int64)
    misc = np.zeros((B, 10), np.int32)
    for b, g in enumerate(graphs):
        _res, steps[b], misc[b] = _oracle_steps(g, params, q, cfg.LS)
    qlen = np.full(B, len(q), np.int32)
    qc = np.zeros((B, cfg.Wq), np.int8)
    qc[:, 1:len(q) + 1] = q
    want, nodes = zip(*(_edit(what, st, i2n, b, steps[b], misc[b], qc[b],
                              len(q), cfg)
                        for b, what in enumerate(EDGE_ROUNDS[kind])))
    s16w, misc2 = _wire(steps, misc)
    return (cfg, (st, i2n, n2i, remain), s16w, misc2, qlen, qc, list(want),
            nodes)


def _assert_rounds_equal(a, b, want):
    """Two PackedStates of one round: fail flags == want, and each
    instance whose flag is clear equal in node_n, state rows and its
    topo maps on live rows (remain rides in ctrl)."""
    a = [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
         for x in a]
    b = [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
         for x in b]
    ctrl, outp, inp, alp, i2nn, node_n, fail = range(7)
    assert a[fail].tolist() == b[fail].tolist() == list(want)
    for k, f in enumerate(want):
        if f:
            continue
        assert a[node_n][k] == b[node_n][k], k
        for x in (ctrl, outp, inp, alp):
            assert (a[x][k] == b[x][k]).all(), (k, x)
        n = int(a[node_n][k])
        assert (a[i2nn][k, :n] == b[i2nn][k, :n]).all(), k


@pytest.mark.parametrize("kind", sorted(EDGE_ROUNDS))
def test_graph_update_edge_rounds_equal_jax_kernel(kind):
    """Rounds at the edges of the fusion's rules: a mismatch at a node
    whose aligned group is full (fail), an out-degree at E and an
    in-degree at P that the round must grow (fail) or that it fills to
    E and P (no fail), an instance with the sticky fail flag beside a
    live one: the plain version equals the JAX graph kernel on the fail
    flags, and on every instance whose flag is clear on node_n, the
    state and the topo maps."""
    from abpoa_tpu.ops import poa_loop as pls
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import graph_update as tgu
    from abpoa_tpu_torch import convert
    cfg, state, s16w, misc, qlen, qc, want, nodes = _edge_round(kind)
    tcfg = convert.loop_config(cfg)
    ps = pls.pack_state(cfg, *state)
    jout = _jax_graph_update(cfg, ps, s16w, misc, qlen, qc)
    tout = tgu.graph_update_packed(tcfg, convert.packed_state(ps, "cpu"),
                                   s16w, misc, torch.from_numpy(qlen),
                                   tpl.pack_qp4(tcfg, torch.from_numpy(qc)))
    _assert_rounds_equal(jout, tout, want)
    if kind == "capacity_edge":
        st2 = tpl.unpack_state(tcfg, tout)[0]
        assert int(st2.n_out[0, nodes[0]]) == cfg.E
        assert int(st2.n_in[1, nodes[1]]) == cfg.P


def test_graph_update_smem_keeps_the_loop_scope():
    """The graph kernel's shared memory (smem_bytes, the formula of
    graph_update_launch) does not grow: at heter64's geometry (R=1024,
    Wq=1152) 75,156 bytes in wmode 0 and 102,036 in wmode 1 at most, and
    the device loop still admits R = 3264 (wmode 0) and R = 2368 (wmode
    1) at Wq = 1152 (the next multiple of 64 does not fit)."""
    from abpoa_tpu_torch.ops import graph_update as tgu
    from abpoa_tpu_torch.params import Params as TParams
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    heter = _reads("heter.fa", 15)
    cfg = _loop_geometry(TParams().post_set(), [heter] * 64)
    qv = _loop_geometry(TParams().post_set(), [heter] * 64, wmax=885)
    assert (cfg.R, cfg.Wq, cfg.wmode, qv.wmode) == (1024, 1152, 0, 1)
    assert tgu.smem_bytes(cfg) <= 75156
    assert tgu.smem_bytes(qv) <= 102036

    def at(c, R):
        return c._replace(R=R, LS=(R + c.Wq + 63) // 64 * 64)
    for c, r_max in ((cfg, 3264), (qv, 2368)):
        assert tgu.smem_bytes(at(c, r_max)) <= tgu.MAX_SMEM_BYTES
        assert tgu.smem_bytes(at(c, r_max + 64)) > tgu.MAX_SMEM_BYTES


def test_graph_update_ref_equals_jax_kernel():
    """Round 1 of two seq.fa instances (different read 0) plus a padding
    instance (qlen 0): the plain version equals the JAX graph kernel on
    the whole packed state, the topo maps and the flags."""
    from abpoa_tpu.graph import POAGraph
    from abpoa_tpu.ops import poa_loop as pls
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import graph_update as tgu
    from abpoa_tpu_torch import convert
    params = Params().post_set()
    reads = _reads("seq.fa", 4)
    B = 2
    cfg = _jax_cfg(params, max(len(q) for q in reads), B, 192)
    tcfg = convert.loop_config(cfg)
    graphs = []
    for r0 in (0, 1):
        g = POAGraph()
        g.add_graph_alignment(params, reads[r0], [1] * len(reads[r0]), [],
                              None, 0, True)
        g.topological_sort(params)
        graphs.append(g)
    st, i2n, n2i, remain = pls.init_state_np(graphs, cfg)
    q = reads[2]
    steps = np.zeros((B, cfg.LS), np.int64)
    misc = np.zeros((B, 10), np.int32)
    for b, g in enumerate(graphs):
        _res, steps[b], misc[b] = _oracle_steps(g, params, q, cfg.LS)
    qlen = np.array([len(q), 0], np.int32)     # instance 1: padding round
    qc = np.zeros((B, cfg.Wq), np.int8)
    qc[0, 1:len(q) + 1] = q
    s16w, misc2 = _wire(steps, misc)
    ps = pls.pack_state(cfg, st, i2n, n2i, remain)
    jout = _jax_graph_update(cfg, ps, s16w, misc2, qlen, qc)
    tps = convert.packed_state(ps, "cpu")
    tout = tgu.graph_update_packed(tcfg, tps, s16w, misc2,
                                   torch.from_numpy(qlen),
                                   tpl.pack_qp4(tcfg, torch.from_numpy(qc)))
    assert np.asarray(jout.fail).tolist() == tout.fail.tolist() == [0, 0]
    assert (np.asarray(jout.node_n) == tout.node_n.numpy()).all()
    for name in ("ctrl", "outp", "inp", "alp"):
        assert (np.asarray(getattr(jout, name))
                == getattr(tout, name).numpy()).all(), name
    for b in range(B):
        n = int(tout.node_n[b])
        assert (np.asarray(jout.i2nn)[b, :n] == tout.i2nn[b, :n].numpy()).all()
    assert int(tout.node_n[0]) > int(ps.node_n[0])


@pytest.mark.parametrize("fn,nreads", [("heter.fa", 4), ("seq.fa", 6)])
def test_graph_update_ref_vs_host_graph(fn, nreads):
    """Round by round on real reads: fusion lists (order and weights),
    the Kahn order and max_remain equal the host graph's after the
    oracle fuses the same alignment (mirrors test_device_loop's
    fuse/topo/remain check)."""
    from abpoa_tpu.graph import POAGraph
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import graph_update as tgu
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    from abpoa_tpu_torch import convert
    params = Params().post_set()
    reads = _reads(fn, nreads)
    cfg = _loop_geometry(convert.params(params), [reads])._replace(B=1)
    g = POAGraph()
    g.add_graph_alignment(params, reads[0], [1] * len(reads[0]), [], None,
                          0, True)
    g.topological_sort(params)
    ps = _port_state([g], cfg)
    for r, q in enumerate(reads[1:], start=1):
        if not g.is_topological_sorted:
            g.topological_sort(params)
        res, steps, misc = _oracle_steps(g, params, q, cfg.LS)
        s16w, misc2 = _wire(steps[None], misc[None])
        qc = np.zeros((1, cfg.Wq), np.int8)
        qc[0, 1:len(q) + 1] = q
        ps = tgu.graph_update_packed(
            cfg, ps, s16w, misc2, torch.tensor([len(q)], dtype=torch.int32),
            tpl.pack_qp4(cfg, torch.from_numpy(qc)))
        assert ps.fail.tolist() == [0]
        g.add_graph_alignment(params, q, [1] * len(q), res.cigar, None, r,
                              True)
        g.topological_sort(params)
        st2, i2n2, n2i2, rem2 = tpl.unpack_state(cfg, ps)
        c = g.build_csr()
        n = c["n"]
        assert int(st2.node_n[0]) == n
        assert (st2.bases[0, :n].numpy() == c["bases"][:n]).all()
        for flat, off, cnt, ids, w in (
                (c["out_flat"], c["out_off"], st2.n_out, st2.out_ids,
                 st2.out_w),
                (c["in_flat"], c["in_off"], st2.n_in, st2.in_ids, None),
                (c["al_flat"], c["al_off"], st2.n_al, st2.al_ids, None)):
            k = off[1:] - off[:-1]
            assert (cnt[0, :n].numpy() == k[:n]).all()
            for i in range(n):
                assert (ids[0, i, :k[i]].numpy()
                        == flat[off[i]:off[i + 1]]).all()
                if w is not None:
                    assert (w[0, i, :k[i]].numpy()
                            == c["out_w_flat"][off[i]:off[i + 1]]).all()
        assert (i2n2[0, :n].numpy() == np.asarray(g.index_to_node_id[:n])).all()
        assert (n2i2[0, :n].numpy() == np.asarray(g.node_id_to_index[:n])).all()
        assert (rem2[0, :n].numpy()
                == np.asarray(g.node_id_to_max_remain[:n])).all()


def test_graph_update_capacity_sets_fail():
    """A round that needs more nodes than R sets the sticky fail flag,
    and a failed instance is left alone by later rounds' fusion."""
    from abpoa_tpu.graph import POAGraph
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import graph_update as tgu
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    from abpoa_tpu_torch import convert
    params = Params().post_set()
    rng = np.random.default_rng(5)
    reads = [rng.integers(0, 4, 150).astype(np.uint8) for _ in range(2)]
    cfg = _loop_geometry(convert.params(params), [reads])._replace(
        B=1, R=128 + 64)
    g = POAGraph()
    g.add_graph_alignment(params, reads[0], [1] * 150, [], None, 0, True)
    g.topological_sort(params)
    ps = _port_state([g], cfg)
    # an all-insertion round: every base is a new node (150 + 152 > R)
    misc = np.zeros((1, 10), np.int32)
    misc[0, 2] = 0                       # M_BJ = 0: the read is trailing I
    s16w, misc2 = _wire(np.zeros((1, cfg.LS), np.int64), misc)
    qc = np.zeros((1, cfg.Wq), np.int8)
    qc[0, 1:151] = reads[1]
    qp4 = tpl.pack_qp4(cfg, torch.from_numpy(qc))
    ql = torch.tensor([150], dtype=torch.int32)
    out = tgu.graph_update_packed(cfg, ps, s16w, misc2, ql, qp4)
    assert out.fail.tolist() == [1]
    again = tgu.graph_update_packed(cfg, out, s16w, misc2, ql, qp4)
    assert again.fail.tolist() == [1]
    assert again.node_n.tolist() == out.node_n.tolist()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_graph_kernel_equals_ref_on_gpu(cuda_device):
    """The CUDA kernel against the plain version on the card, round by
    round on heter.fa (mismatch bundles) plus a padding instance."""
    from abpoa_tpu.graph import POAGraph
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import graph_update as tgu
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    from abpoa_tpu_torch import convert
    params = Params().post_set()
    reads = _reads("heter.fa", 5)
    cfg = _loop_geometry(convert.params(params), [reads])._replace(B=2)
    g = POAGraph()
    g.add_graph_alignment(params, reads[0], [1] * len(reads[0]), [], None,
                          0, True)
    g.topological_sort(params)
    ps = _port_state([g, g], cfg, cuda_device)
    for r, q in enumerate(reads[1:], start=1):
        if not g.is_topological_sorted:
            g.topological_sort(params)
        res, steps, misc = _oracle_steps(g, params, q, cfg.LS)
        s16w, misc2 = _wire(np.stack([steps, steps]), np.stack([misc, misc]))
        qc = np.zeros((2, cfg.Wq), np.int8)
        qc[:, 1:len(q) + 1] = q
        args = (s16w.to(cuda_device), misc2.to(cuda_device),
                torch.tensor([len(q), 0], dtype=torch.int32,
                             device=cuda_device),
                tpl.pack_qp4(cfg, torch.from_numpy(qc).to(cuda_device)))
        ref = tgu.graph_update_packed_ref(cfg, ps, *args)
        ker = tgu.graph_update_packed(
            cfg, tpl.PackedState(*(x.clone() for x in ps)), *args)
        torch.cuda.synchronize()
        for name in ("ctrl", "outp", "inp", "alp", "node_n", "fail"):
            assert torch.equal(getattr(ker, name), getattr(ref, name)), name
        for b in range(2):
            n = int(ref.node_n[b])
            assert torch.equal(ker.i2nn[b, :n], ref.i2nn[b, :n])
        assert ref.fail.tolist() == [0, 0]
        g.add_graph_alignment(params, q, [1] * len(q), res.cigar, None, r,
                              True)
        ps = ker


def _kernel_vs_ref(cfg, ps, args, qw=None):
    """B2 against its plain version on one round (ps on the card, left
    as it is): one launch; fail flags and node_n exact, the state, the
    topo maps and remain (in ctrl) wherever the flag is clear; then B6
    against its plain version on the kernel's fused graph (i2n, n2i and
    ok). Returns (kernel's PackedState, plain version's)."""
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import graph_update as tgu
    from abpoa_tpu_torch.ops import topo as ttopo
    ref = tgu.graph_update_packed_ref(cfg, ps, *args, qw=qw)
    before = tgu.graph_update_packed.launches
    ker = tgu.graph_update_packed(
        cfg, tpl.PackedState(*(x.clone() for x in ps)), *args, qw=qw)
    torch.cuda.synchronize()
    assert tgu.graph_update_packed.launches == before + 1
    assert torch.equal(ker.node_n, ref.node_n)
    _assert_rounds_equal(ker, ref, ref.fail.tolist())
    st = tpl.unpack_state(cfg, ker)[0]
    got = ttopo.topo_batch(cfg, st)
    exp = ttopo.topo_batch_ref(cfg, st)
    torch.cuda.synchronize()
    for a, b in zip(got, exp):
        assert torch.equal(a.cpu(), b.cpu())
    return ker, ref


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(EDGE_ROUNDS))
def test_graph_kernel_edge_rounds_on_gpu(cuda_device, kind):
    """The CUDA kernel against the plain version on the edge rounds of
    test_graph_update_edge_rounds_equal_jax_kernel (full aligned group,
    out-degree at E and in-degree at P, filled to E and P, sticky fail),
    and B6 on the graphs they leave."""
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch import convert
    cfg, state, s16w, misc, qlen, qc, want, _nodes = _edge_round(kind)
    tcfg = convert.loop_config(cfg)
    dev = cuda_device
    ps = tpl.pack_state(tcfg, *convert.loop_inputs(*state, dev))
    args = (s16w.to(dev), misc.to(dev), torch.from_numpy(qlen).to(dev),
            tpl.pack_qp4(tcfg, torch.from_numpy(qc).to(dev)))
    _ker, ref = _kernel_vs_ref(tcfg, ps, args)
    assert ref.fail.tolist() == want


def _batch_rounds(dev, wmode, B, R=None, gmem=False):
    """Every round of a batch of B instances on the card, kernel against
    plain (_kernel_vs_ref): 8 rotations of heter.fa's reads (4 reads
    each; qv weights from numpy.random.default_rng(77) in wmode 1)
    repeated to B; instances b % 11 == 5 carry the sticky fail flag from
    the start, instances b % 7 == 3 are padding (qlen 0) in the last
    round. R: the node capacity (default: the device loop's); gmem: the
    kernel's residency R must select (the state in global memory)."""
    from abpoa_tpu.graph import POAGraph
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import graph_update as tgu
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    from abpoa_tpu_torch import convert
    params = Params().post_set()
    heter = _reads("heter.fa", 15)
    insts = [(heter[k:] + heter[:k])[:4] for k in range(min(8, B))]
    ws = None
    if wmode:
        rng = np.random.default_rng(77)
        ws = [[rng.integers(1, 60, len(q)).tolist() for q in reads]
              for reads in insts]
    cfg = _loop_geometry(convert.params(params), insts,
                         wmax=60 * 4 if wmode else None)._replace(B=B)
    if R is not None:
        cfg = cfg._replace(R=R, LS=(R + cfg.Wq + 63) // 64 * 64)
    assert cfg.wmode == wmode
    assert tgu.state_in_global(cfg) == gmem
    graphs = []
    for k, reads in enumerate(insts):
        g = POAGraph()
        g.add_graph_alignment(params, reads[0],
                              ws[k][0] if ws else [1] * len(reads[0]), [],
                              None, 0, True)
        g.topological_sort(params)
        graphs.append(g)
    of = [b % len(insts) for b in range(B)]
    fail0 = [int(b % 11 == 5) for b in range(B)]
    ps = _port_state([graphs[k] for k in of], cfg, dev)
    ps = ps._replace(fail=torch.tensor(fail0, dtype=torch.int32,
                                       device=dev))
    for r in range(1, 4):
        per = []
        for k, g in enumerate(graphs):
            if not g.is_topological_sorted:
                g.topological_sort(params)
            q = insts[k][r]
            res, steps_k, misc_k = _oracle_steps(g, params, q, cfg.LS)
            per.append((res, steps_k, misc_k, q))
        steps = np.zeros((B, cfg.LS), np.int64)
        misc = np.zeros((B, 10), np.int32)
        qc = np.zeros((B, cfg.Wq), np.int8)
        qlen = np.zeros(B, np.int32)
        qw = np.zeros((B, cfg.Wq), np.int32)
        for b in range(B):
            if r == 3 and b % 7 == 3:
                continue
            _res, steps[b], misc[b], q = per[of[b]]
            qc[b, 1:len(q) + 1] = q
            qlen[b] = len(q)
            if ws:
                qw[b, :len(q)] = ws[of[b]][r]
        s16w, misc2 = _wire(steps, misc)
        args = (s16w.to(dev), misc2.to(dev), torch.from_numpy(qlen).to(dev),
                tpl.pack_qp4(cfg, torch.from_numpy(qc).to(dev)))
        qw2 = tpl.pack_qw(cfg, torch.from_numpy(qw).to(dev)) if ws else None
        ker, ref = _kernel_vs_ref(cfg, ps, args, qw2)
        assert ref.fail.tolist() == fail0, r
        for k, g in enumerate(graphs):
            res, _s, _m, q = per[k]
            g.add_graph_alignment(params, q, ws[k][r] if ws else [1] * len(q),
                                  res.cigar, None, r, True)
        ps = ker


@pytest.mark.gpu
@pytest.mark.parametrize("wmode", [0, 1])
def test_graph_kernel_b64_on_gpu(cuda_device, wmode):
    """B2 at B=64 in both modes, with failed and padding instances, and
    B6 on every round's graph."""
    _batch_rounds(cuda_device, wmode, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("wmode,R", [(0, 3264), (1, 2368)])
def test_graph_kernel_at_smem_bound_on_gpu(cuda_device, wmode, R):
    """B2 at the largest R the device loop admits at Wq = 1152 in each
    mode (its shared memory then fills a block)."""
    _batch_rounds(cuda_device, wmode, 4, R)
