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


def test_graph_update_ref_equals_jax_kernel():
    """Round 1 of two seq.fa instances (different read 0) plus a padding
    instance (qlen 0): the plain version equals the JAX graph kernel on
    the whole packed state, the topo maps and the flags."""
    import jax.numpy as jnp
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
    jout = pls.graph_update_packed(cfg, ps, jnp.asarray(s16w.numpy()),
                                   jnp.asarray(misc2.numpy()),
                                   jnp.asarray(qlen),
                                   pls.pack_qp4(cfg, jnp.asarray(qc)),
                                   interpret=True)
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
