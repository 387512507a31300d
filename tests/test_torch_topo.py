"""abpoa_tpu_torch: the split device round and its standalone Kahn sort
(kernel B6).

* The port's fuse_batch + topo_batch_ref + remain_ref equal the JAX
  package's fuse_batch + topo_batch (interpret mode) + remain_batch on
  the step streams of the oracle's alignments of heter.fa, as
  tests/test_device_loop.py's test_fuse_topo_remain_no_kernel drives the
  JAX trio; and both equal the host graph.
* device_round(split=True) equals device_round(split=False) on the CPU
  at R=192, B=2 (seq.fa), round by round.
* On a GPU, the CUDA sort against its plain version, and the split round
  against the packed round.
Tolerance 0 (integer state): every state tensor whole, i2n/n2i/remain on
rows < node_n, and the ok/fail flags.
"""
import pathlib

import numpy as np
import pytest
import torch

from test_torch_graph_update import _jax_cfg, _legacy, _oracle_steps

DATA = pathlib.Path(__file__).resolve().parent / "data"

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _reads(fn, n):
    from abpoa_tpu_torch.seqio import read_seqs
    from abpoa_tpu_torch.alphabet import encode_table
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / fn))][:n]


def _live_equal(a, b, node_n, what):
    a, b = np.asarray(a), np.asarray(b)
    for k, n in enumerate(np.asarray(node_n)):
        assert (a[k, :n] == b[k, :n]).all(), (what, k)


def _state_equal(sa, sb, what):
    for f in ("bases", "out_ids", "out_w", "n_out", "in_ids", "n_in",
              "al_ids", "n_al", "node_n", "fail"):
        assert (np.asarray(getattr(sa, f))
                == np.asarray(getattr(sb, f))).all(), (what, f)


def test_fuse_topo_remain_equal_jax_trio():
    import jax.numpy as jnp
    from abpoa_tpu.graph import POAGraph
    from abpoa_tpu.params import Params
    from abpoa_tpu.ops import poa_loop as pls
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import topo as ttopo
    from abpoa_tpu_torch.ops.graph_update import remain_ref
    params = Params().post_set()
    reads = _reads("heter.fa", 3)
    cfg = _jax_cfg(params, max(len(q) for q in reads), 1, 1024)
    tcfg = convert.loop_config(cfg)
    g = POAGraph()
    g.add_graph_alignment(params, reads[0], [1] * len(reads[0]), [], None,
                          0, True)
    g.topological_sort(params)
    st, i2n, n2i, _remain = pls.init_state_np([g], cfg)
    jst = pls.GState(*(jnp.asarray(x) for x in st))
    tst, ti2n = convert.gstate(st, "cpu"), convert.tensor(i2n, "cpu")
    ji2n = jnp.asarray(i2n)
    for r, q in enumerate(reads[1:], start=1):
        if not g.is_topological_sorted:
            g.topological_sort(params)
        res, steps, misc = _oracle_steps(g, params, q, cfg.LS)
        qc = np.zeros((1, cfg.Wq), np.int8)
        qc[0, 1:len(q) + 1] = q
        qlen = np.array([len(q)], np.int32)
        jst = pls.fuse_batch(cfg, jst, ji2n,
                             jnp.asarray(_legacy(steps)[None]),
                             jnp.asarray(misc[None]), jnp.asarray(qc),
                             jnp.asarray(qlen))
        ji2n, jn2i, jok = pls.topo_batch(cfg, jst, interpret=True)
        jrem = pls.remain_batch(cfg, jst)
        tst = tpl.fuse_batch(tcfg, tst, ti2n, torch.from_numpy(steps[None]),
                             torch.from_numpy(misc[None]),
                             torch.from_numpy(qc), torch.from_numpy(qlen))
        ti2n, tn2i, tok = ttopo.topo_batch_ref(tcfg, tst)
        trem = remain_ref(tcfg, tst)
        _state_equal(jst, tst, f"round {r}")
        assert np.asarray(jok).tolist() == tok.int().tolist() == [1]
        nn = tst.node_n.numpy()
        for what, a, b in (("i2n", ji2n, ti2n), ("n2i", jn2i, tn2i),
                           ("remain", jrem, trem)):
            _live_equal(a, b.numpy(), nn, f"round {r}: {what}")
        # and the host graph after the oracle fuses the same alignment
        g.add_graph_alignment(params, q, [1] * len(q), res.cigar, None, r,
                              True)
        g.topological_sort(params)
        n = g.node_n
        assert int(nn[0]) == n
        assert (ti2n[0, :n].numpy()
                == np.asarray(g.index_to_node_id[:n])).all()
        assert (trem[0, :n].numpy()
                == np.asarray(g.node_id_to_max_remain[:n])).all()


def _split_vs_packed(device, NR=2):
    """Both routes of device_round from one initial state, round by round
    over rotated seq.fa instances; yields (round, split out, packed out)."""
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.graph import POAGraph
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.ops import poa_loop as tpl
    params = Params().post_set()
    reads = _reads("seq.fa", NR + 2)
    insts = [reads[:NR + 1], reads[1:NR + 2]]
    B = len(insts)
    cfg = _jax_cfg(params, max(len(q) for q in reads), B, 192)
    tcfg = convert.loop_config(cfg)._replace(NR=NR)
    graphs = []
    for rs in insts:
        g = POAGraph()
        g.add_graph_alignment(params, rs[0], [1] * len(rs[0]), [], None, 0,
                              True)
        g.topological_sort(params)
        graphs.append(g)
    init = tpl.init_state_np(graphs, tcfg)
    state = {s: convert.loop_inputs(*init, device) for s in (True, False)}
    base = torch.from_numpy(tpl.make_scal_base(params, tcfg)).to(device)
    wf1000 = round(params.wf * 1000)
    for r in range(NR):
        qc = np.zeros((B, tcfg.Wq), np.int8)
        ql = np.zeros(B, np.int32)
        for b, rs in enumerate(insts):
            qc[b, 1:len(rs[r + 1]) + 1] = rs[r + 1]
            ql[b] = len(rs[r + 1])
        qc_d = torch.from_numpy(qc).to(device)
        ql_d = torch.from_numpy(ql).to(device)
        outs = {}
        for split in (True, False):
            st, i2n, n2i, rem = state[split]
            outs[split] = tpl.device_round(tcfg, st, i2n, n2i, rem, qc_d,
                                           ql_d, base, params.wb, wf1000,
                                           split=split)
            state[split] = outs[split][:4]
        yield r, outs[True], outs[False]


def _assert_rounds_equal(r, so, po):
    from abpoa_tpu_torch.ops import layout as L
    s_st, s_i2n, s_n2i, s_rem, s_misc, s_s16 = so
    p_st, p_i2n, p_n2i, p_rem, p_misc, p_s16 = po
    s_st = type(s_st)(*(x.cpu() for x in s_st))
    p_st = type(p_st)(*(x.cpu() for x in p_st))
    assert not s_st.fail.any() and not p_st.fail.any(), r
    _state_equal(s_st, p_st, f"round {r}")
    nn = s_st.node_n.numpy()
    for what, a, b in (("i2n", s_i2n, p_i2n), ("n2i", s_n2i, p_n2i),
                       ("remain", s_rem, p_rem)):
        _live_equal(a.cpu().numpy(), b.cpu().numpy(), nn, f"round {r}: {what}")
    sm, pm = s_misc.cpu().numpy(), p_misc.cpu().numpy()
    assert (sm[:, :L.M_LASTI] == pm[:, :L.M_LASTI]).all(), r
    for b in range(sm.shape[0]):
        ns = int(sm[b, L.M_NSTEPS])
        assert (s_s16[b, :ns].cpu() == p_s16[b, :ns].cpu()).all(), (r, b)


def test_split_round_equals_packed_round():
    n = 0
    for r, so, po in _split_vs_packed("cpu"):
        _assert_rounds_equal(r, so, po)
        n += 1
    assert n == 2


@pytest.mark.gpu
def test_split_round_equals_packed_round_on_gpu(cuda_device):
    for r, so, po in _split_vs_packed(cuda_device):
        _assert_rounds_equal(r, so, po)


@pytest.mark.gpu
def test_topo_kernel_equals_ref_on_gpu(cuda_device):
    """The sort of the split round's fused states, kernel against plain,
    plus an instance whose fail flag is set (ok masked)."""
    from abpoa_tpu_torch.ops import topo as ttopo
    from abpoa_tpu_torch.ops.graph_update import remain_ref
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.params import Params
    for r, so, _po in _split_vs_packed(cuda_device):
        st = so[0]
        st = st._replace(fail=torch.tensor([0, 1], dtype=torch.int32,
                                           device=cuda_device))
        cfg = convert.loop_config(_jax_cfg(Params().post_set(), 64, 2, 192))
        before = ttopo.topo_batch.launches
        k = ttopo.topo_batch(cfg, st)
        assert ttopo.topo_batch.launches == before + 1
        ref = ttopo.topo_batch_ref(cfg, st)
        torch.cuda.synchronize()
        for a, b in zip(k, ref):
            assert torch.equal(a.cpu(), b.cpu()), r
        assert k[2].tolist() == [True, False]
        assert isinstance(remain_ref(cfg, st), torch.Tensor)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [192, 6000])
def test_topo_kernel_staged_and_global_on_gpu(cuda_device, R):
    """B6 in its two instances: the graphs of the sticky edge round (one
    failed instance beside a live one) at R=192 (staged in shared
    memory) and padded to R=6000 (past it: the state is read from
    device memory); i2n, n2i and ok equal the plain version's."""
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.ops import topo as ttopo
    from test_torch_graph_update import _edge_round
    cfg, (st, *_), *_rest = _edge_round("sticky")
    tcfg = convert.loop_config(cfg)._replace(R=R)
    assert ttopo.staged(tcfg) == (R == 192)
    pad = []
    for x in st:
        x = np.asarray(x)
        if x.ndim > 1:
            x = np.concatenate(
                [x, np.zeros((x.shape[0], R - x.shape[1]) + x.shape[2:],
                             x.dtype)], axis=1)
        pad.append(x)
    gst = convert.gstate(type(st)(*pad), cuda_device)
    got = ttopo.topo_batch(tcfg, gst)
    exp = ttopo.topo_batch_ref(tcfg, gst)
    torch.cuda.synchronize()
    for a, b in zip(got, exp):
        assert torch.equal(a.cpu(), b.cpu())
    assert got[2].tolist() == [False, True]
