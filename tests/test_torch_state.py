"""abpoa_tpu_torch: the loop's state, packing and glue, bit-equal to the
JAX package on random and real states (exact equality: integer state).
"""
import pathlib

import numpy as np
import pytest
import torch


from abpoa_tpu.params import Params

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


def _cfgs(R=192, B=3, Wq=384, WB=384):
    from abpoa_tpu.ops.poa_loop import LoopConfig as JCfg
    from abpoa_tpu_torch import convert
    jc = JCfg(R=R, E=12, P=8, A=4, Wq=Wq, WB=WB, LS=(R + Wq + 63) // 64 * 64,
              NR=2, B=B, G=1, GT=1, pn=32, inf_min=-32681, gap_mode=2,
              use_zdrop=False, wbits=4)
    return jc, convert.loop_config(jc)


def _random_state(jc, seed):
    """A random GState in the packed fields' value ranges."""
    from abpoa_tpu.ops.poa_loop import GState
    rng = np.random.default_rng(seed)
    B, R, E, P, A = jc.B, jc.R, jc.E, jc.P, jc.A
    ri = rng.integers
    st = GState(ri(0, 5, (B, R)), ri(0, R, (B, R, E)), ri(0, 15, (B, R, E)),
                ri(0, E + 1, (B, R)), ri(0, R, (B, R, P)),
                ri(0, P + 1, (B, R)), ri(0, R, (B, R, A)),
                ri(0, A + 1, (B, R)), ri(2, R + 1, B), ri(0, 2, B))
    st = GState(*(x.astype(np.int32) for x in st))
    i2n = rng.permuted(np.tile(np.arange(R, dtype=np.int32), (B, 1)), axis=1)
    n2i = np.argsort(i2n, axis=1).astype(np.int32)
    remain = ri(-1, 2000, (B, R)).astype(np.int32)
    return st, i2n, n2i, remain


def _heter_state(jc):
    from abpoa_tpu.graph import POAGraph
    from abpoa_tpu.align.engine_np import align_sequence_to_subgraph
    from abpoa_tpu.params import SRC_NODE_ID, SINK_NODE_ID
    from abpoa_tpu.ops import poa_loop as pls
    params = Params().post_set()
    graphs = []
    for b in range(jc.B):
        g = POAGraph()
        reads = _reads("heter.fa", 3 + b)
        for r, q in enumerate(reads):
            if g.node_n > 2:
                if not g.is_topological_sorted:
                    g.topological_sort(params)
                res = align_sequence_to_subgraph(g, params, SRC_NODE_ID,
                                                 SINK_NODE_ID, q)
                cig = res.cigar
            else:
                cig = []
            g.add_graph_alignment(params, q, [1] * len(q), cig, None, r,
                                  True)
        g.topological_sort(params)
        graphs.append(g)
    return pls.init_state_np(graphs, jc)


@pytest.mark.parametrize("src", ["random0", "random1", "heter"])
def test_pack_unpack_equal_jax(src):
    from abpoa_tpu.ops import poa_loop as pls
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch import convert
    if src == "heter":
        jc, tc = _cfgs(R=1024, B=2, Wq=1152)
        st, i2n, n2i, remain = _heter_state(jc)
        assert not st.fail.any()
    else:
        jc, tc = _cfgs()
        st, i2n, n2i, remain = _random_state(jc, int(src[-1]))
    jps = pls.pack_state(jc, st, i2n, n2i, remain)
    tps = tpl.pack_state(tc, *convert.loop_inputs(st, i2n, n2i, remain,
                                                  "cpu"))
    for a, b in zip(jps, tps):
        assert (np.asarray(a) == b.numpy()).all()
    jun = pls.unpack_state(jc, jps)
    tun = tpl.unpack_state(tc, tps)
    for a, b in zip(jax_flat(jun), torch_flat(tun)):
        assert (a == b).all()


def jax_flat(un):
    st, i2n, n2i, rem = un
    return [np.asarray(x) for x in st] + [np.asarray(i2n), np.asarray(n2i),
                                          np.asarray(rem)]


def torch_flat(un):
    st, i2n, n2i, rem = un
    return [x.numpy() for x in st] + [i2n.numpy(), n2i.numpy(), rem.numpy()]


@pytest.mark.parametrize("gaps", [None, (4, 2, 0, 0), (0, 2, 0, 0)],
                         ids=["convex", "affine", "linear"])
def test_scal_qpf_qp4_equal_jax(gaps):
    import jax.numpy as jnp
    from abpoa_tpu.ops import poa_loop as pls
    from abpoa_tpu.ops.dp_pallas_band import build_qpf
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import band_dp as tbd
    from abpoa_tpu_torch import convert
    params = Params()
    if gaps is not None:
        (params.gap_open1, params.gap_ext1,
         params.gap_open2, params.gap_ext2) = gaps
    params.post_set()
    jc, tc = _cfgs(Wq=768)
    jc = jc._replace(gap_mode=params.gap_mode)
    tc = tc._replace(gap_mode=params.gap_mode)
    st, i2n, n2i, remain = _random_state(jc, 7)
    jbase = pls.make_scal_base(params, jc)
    tbase = tpl.make_scal_base(convert.params(params), tc)
    assert (jbase == tbase).all()
    rng = np.random.default_rng(3)
    qc = rng.integers(0, 5, (2, jc.B, jc.Wq)).astype(np.int8)
    qlen = rng.integers(0, 700, jc.B).astype(np.int32)
    jps = pls.pack_state(jc, st, i2n, n2i, remain)
    tps = convert.packed_state(jps, "cpu")
    js = pls.build_scal(jc, jps, jnp.asarray(qlen), jnp.asarray(jbase),
                        jnp.int32(params.wb),
                        jnp.int32(round(params.wf * 1000)))
    ts = tpl.build_scal(tc, tps, torch.from_numpy(qlen),
                        convert.tensor(tbase, "cpu"), params.wb,
                        round(params.wf * 1000))
    assert (np.asarray(js)[:, :ts.shape[1]] == ts.numpy()).all()
    bc = pls._band_cfg(jc, nid=True)
    jq = build_qpf(bc, jbase[13:], jnp.asarray(qc))
    tq = tbd.build_qpf(tpl.band_config(tc), torch.from_numpy(tbase[13:]),
                       torch.from_numpy(qc))
    assert (np.asarray(jq) == tq.numpy()).all()
    assert (np.asarray(pls.pack_qp4(jc, jnp.asarray(qc)))
            == tpl.pack_qp4(tc, torch.from_numpy(qc)).numpy()).all()


def test_init_state_np_equal_jax():
    """Each package's init_state_np of its own graphs of the same reads
    (the second over capacity: fail flag, clipped node_n)."""
    from abpoa_tpu.graph import POAGraph as JGraph
    from abpoa_tpu.ops import poa_loop as pls
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.graph import POAGraph as TGraph
    from abpoa_tpu_torch.ops import poa_loop as tpl
    jc, tc = _cfgs(R=1024, B=2, Wq=1152)
    params = Params().post_set()
    reads = [_reads("heter.fa", 1)[0], np.tile(_reads("heter.fa", 1)[0], 2)]

    def graphs(POAGraph, p):
        out = []
        for q in reads:
            g = POAGraph()
            g.add_graph_alignment(p, q, [1] * len(q), [], None, 0, True)
            g.topological_sort(p)
            out.append(g)
        return out
    a = pls.init_state_np(graphs(JGraph, params), jc)
    b = tpl.init_state_np(graphs(TGraph, convert.params(params)),
                          tc._replace(B=2))
    for x, y in zip(jax_flat(a), jax_flat(b)):
        assert (x == y).all()
    assert b[0].fail.tolist() == [0, 1]


def test_steps16_roundtrip_equal_jax():
    """Step words -> wire words (port) -> decode (port) equals the JAX
    encoder and bt_xla's decode on the same (op, row, col) steps (the JAX
    package's int32 words, the port's int64 words)."""
    import jax.numpy as jnp
    from abpoa_tpu.ops import bt_xla
    from abpoa_tpu.ops import poa_loop as pls
    from abpoa_tpu_torch.ops import steps as tst
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import layout as L
    rng = np.random.default_rng(11)
    B, LS = 3, 64
    steps = np.zeros((B, LS), np.int32)
    wide = np.zeros((B, LS), np.int64)
    misc = np.zeros((B, L.M_NMISC), np.int32)
    for b in range(B):
        n = int(rng.integers(1, LS))
        i, j = 900, 700
        misc[b, L.M_BI], misc[b, L.M_BJ], misc[b, L.M_NSTEPS] = i, j, n
        for k in range(n):
            op = int(rng.integers(0, 3))
            i -= int(rng.integers(0, 40)) if op != 1 else 0
            j -= 1 if op != 2 else 0
            steps[b, k] = op | (i << 2) | (j << 14)
            wide[b, k] = tst.pack_steps(op, i, j)
    js16w, jmisc = pls.steps32_to_s16w(jnp.asarray(steps), jnp.asarray(misc))
    ts16w, tmisc = tst.steps_to_s16w(torch.from_numpy(wide),
                                     torch.from_numpy(misc))
    assert (np.asarray(js16w) == ts16w.numpy()).all()
    assert (np.asarray(jmisc) == tmisc.numpy()).all()
    s16 = tpl.s16w_to_s16(ts16w).numpy()
    assert (np.asarray(pls.s16w_to_s16(js16w)) == s16).all()
    allw = tst.decode_steps_batch(s16[None], misc[None])[0]
    for b in range(B):
        n = misc[b, L.M_NSTEPS]
        ref = np.asarray(bt_xla.unpack_steps16(
            s16[b], n, misc[b, L.M_BI], misc[b, L.M_BJ])).astype(np.int64)
        ref3 = np.stack([ref & 3, (ref >> 2) & 0xFFF, ref >> 14])
        got = tst.unpack_steps16(s16[b], n, misc[b, L.M_BI],
                                 misc[b, L.M_BJ])
        assert (np.stack(tst.step_fields(got)) == ref3).all()
        assert (allw[b, :n] == wide[b, :n]).all()
