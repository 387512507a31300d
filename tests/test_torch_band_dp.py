"""abpoa_tpu_torch: the plain band DP (band_poa_dp_packed_ref) against the
JAX band kernel in interpret mode (affine; convex in
test_torch_device_loop.py) and against the
oracle's best score and cigar (linear); on a GPU, the CUDA kernel
against the plain version. Exact equality everywhere (integer DP).
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



@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


GAPS = {"convex": None, "affine": (4, 2, 0, 0), "linear": (0, 2, 0, 0)}


def _reads(fn, n):
    from abpoa_tpu.seqio import read_seqs
    from abpoa_tpu.alphabet import encode_table
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / fn))][:n]


def _params(gap):
    params = Params()
    if GAPS[gap] is not None:
        (params.gap_open1, params.gap_ext1,
         params.gap_open2, params.gap_ext2) = GAPS[gap]
    return params.post_set()


def _graph(params, reads, port=True):
    """Host graph of `reads` fused by the oracle (bundles -> rows with
    several predecessors), topologically sorted: the port's graph and
    oracle for the port's Params, else the JAX package's."""
    if port:
        from abpoa_tpu_torch.graph import POAGraph
        from abpoa_tpu_torch.align.engine_np import (
            align_sequence_to_subgraph)
    else:
        from abpoa_tpu.graph import POAGraph
        from abpoa_tpu.align.engine_np import align_sequence_to_subgraph
    g = POAGraph()
    for r, q in enumerate(reads):
        cig = []
        if g.node_n > 2:
            if not g.is_topological_sorted:
                g.topological_sort(params)
            cig = align_sequence_to_subgraph(g, params, SRC_NODE_ID,
                                             SINK_NODE_ID, q).cigar
        g.add_graph_alignment(params, q, [1] * len(q), cig, None, r, True)
    g.topological_sort(params)
    return g


def _inputs(params, graphs, q, R, device="cpu"):
    """Port-side inputs of one round (the JAX test shapes: R=192, G=1)
    from the port's Params and graphs."""
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import band_dp as tbd
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    B = len(graphs)
    cfg = _loop_geometry(params, [[q, q]])._replace(B=B, R=R)
    cfg = cfg._replace(LS=(R + cfg.Wq + 63) // 64 * 64)
    st, i2n, n2i, remain = tpl.init_state_np(graphs, cfg)
    t = {k: torch.from_numpy(v).to(device)
         for k, v in (("i2n", i2n), ("n2i", n2i), ("rem", remain))}
    ps = tpl.pack_state(cfg, tpl.GState(*(torch.from_numpy(x).to(device)
                                          for x in st)),
                        t["i2n"], t["n2i"], t["rem"])
    base = torch.from_numpy(tpl.make_scal_base(params, cfg)).to(device)
    qlen = torch.full((B,), len(q), dtype=torch.int32, device=device)
    scal = tpl.build_scal(cfg, ps, qlen, base, params.wb,
                          round(params.wf * 1000))
    qc = np.zeros((B, cfg.Wq), np.int8)
    qc[:, 1:len(q) + 1] = q
    qpf = tbd.build_qpf(tpl.band_config(cfg), base[13:],
                        torch.from_numpy(qc).to(device))
    return cfg, ps, scal, qpf


@pytest.mark.parametrize("gap", ["affine"])
def test_band_ref_equals_jax_interpret(gap):
    """Affine gaps here; convex gaps are held to the JAX kernel round by
    round in tests/test_torch_device_loop.py (same shapes)."""
    import jax.numpy as jnp
    from abpoa_tpu.ops import poa_loop as pls
    from abpoa_tpu.ops.dp_pallas_band import band_poa_dp_packed
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import band_dp as tbd
    from abpoa_tpu_torch.ops import layout as L
    from abpoa_tpu_torch import convert
    params = convert.params(_params(gap))
    reads = _reads("seq.fa", 6)
    graphs = [_graph(params, reads[0:3]), _graph(params, reads[1:4])]
    q = reads[5]
    cfg, ps, scal, qpf = _inputs(params, graphs, q, 192)
    # the JAX test shapes (tests/test_device_loop.py): R=192, B=2, G=1
    jcfg = pls.LoopConfig(**cfg._asdict(), G=1, GT=2, use_zdrop=False)
    bc = pls._band_cfg(jcfg, nid=True)
    jm, js = band_poa_dp_packed(
        bc, jnp.asarray(scal.numpy()), jnp.asarray(ps.ctrl.numpy()),
        jnp.asarray(ps.inp.numpy()), jnp.asarray(ps.i2nn.numpy()),
        jnp.asarray(qpf.numpy()), interpret=True)
    tm, ts = tbd.band_poa_dp_packed(tpl.band_config(cfg), scal, ps.ctrl,
                                    ps.inp, ps.i2nn, qpf)
    jm, js = np.asarray(jm), np.asarray(js)
    assert (jm == tm.numpy()).all()
    assert (jm[:, L.M_NSTEPS] > 0).all() and not jm[:, L.M_FAIL].any()
    for b in range(2):
        n = int(jm[b, L.M_NSTEPS])
        assert (js[b].view(np.int16)[:n]
                == ts[b].numpy().view(np.int16)[:n]).all()


@pytest.mark.parametrize("gap", ["linear", "convex"])
def test_band_ref_matches_oracle(gap):
    """Best score and cigar of the plain DP equal the bit-exact oracle's
    on heter.fa graphs with mismatch bundles."""
    from abpoa_tpu.align.engine_np import align_sequence_to_subgraph
    from abpoa_tpu.align.engine_np import AlignResult
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import band_dp as tbd
    from abpoa_tpu_torch.ops import layout as L
    from abpoa_tpu_torch.ops import steps as tst
    from abpoa_tpu_torch import convert
    params = _params(gap)
    tparams = convert.params(params)
    reads = _reads("heter.fa", 5)
    parts = (reads[0:2], reads[1:4])
    graphs = [_graph(params, r, port=False) for r in parts]
    tgraphs = [_graph(tparams, r) for r in parts]
    q = reads[4]
    cfg, ps, scal, qpf = _inputs(tparams, tgraphs, q, 1024)
    tm, ts = tbd.band_poa_dp_packed(tpl.band_config(cfg), scal, ps.ctrl,
                                    ps.inp, ps.i2nn, qpf)
    tm = tm.numpy()
    s16 = tpl.s16w_to_s16(ts).numpy()
    for b, g in enumerate(graphs):
        res = align_sequence_to_subgraph(g, params, SRC_NODE_ID,
                                         SINK_NODE_ID, q)
        mi = tm[b]
        assert mi[L.M_OVFL] == 0 and mi[L.M_FAIL] == 0
        assert mi[L.M_BEST] == res.best_score
        n = int(mi[L.M_NSTEPS])
        steps = tst.unpack_steps16(s16[b], n, int(mi[L.M_BI]),
                                   int(mi[L.M_BJ]))
        r2 = AlignResult()
        tst.replay_steps(tgraphs[b], tparams, q, steps, n, int(mi[L.M_BI]),
                         int(mi[L.M_BJ]), int(mi[L.M_ENDI]),
                         int(mi[L.M_ENDJ]), r2)
        assert r2.cigar == res.cigar


def test_band_overflow_flag():
    """A band wider than the WB window raises M_OVFL and skips the walk
    (the host rebuilds such instances on the oracle)."""
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import band_dp as tbd
    from abpoa_tpu_torch.ops import layout as L
    from abpoa_tpu_torch import convert
    params = convert.params(_params("convex"))
    reads = _reads("heter.fa", 3)
    cfg, ps, scal, qpf = _inputs(params, [_graph(params, reads[:2])],
                                 reads[2], 1024)
    small = tpl.band_config(cfg)._replace(WB=64, Wq=cfg.Wq)
    qpf_small = tbd.build_qpf(small, torch.from_numpy(
        tpl.make_scal_base(params, cfg)[13:]),
        torch.zeros(1, cfg.Wq, dtype=torch.int8))
    tm, _ = tbd.band_poa_dp_packed(small, scal, ps.ctrl, ps.inp, ps.i2nn,
                                   qpf_small)
    assert tm[0, L.M_OVFL] == 1 and tm[0, L.M_NSTEPS] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("gap", ["convex", "affine", "linear"])
def test_band_kernel_equals_ref_on_gpu(gap, cuda_device):
    """The CUDA kernel against the plain version on the card."""
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import band_dp as tbd
    from abpoa_tpu_torch.ops import layout as L
    from abpoa_tpu_torch import convert
    params = convert.params(_params(gap))
    reads = _reads("heter.fa", 6)
    graphs = [_graph(params, reads[i:i + 3]) for i in range(3)]
    cfg, ps, scal, qpf = _inputs(params, graphs, reads[5], 1024,
                                 device=cuda_device)
    bc = tpl.band_config(cfg)
    km, ks = tbd.band_poa_dp_packed(bc, scal, ps.ctrl, ps.inp, ps.i2nn, qpf)
    rm, rs = tbd.band_poa_dp_packed_ref(bc, scal, ps.ctrl, ps.inp, ps.i2nn,
                                        qpf)
    torch.cuda.synchronize()
    assert torch.equal(km, rm)
    for b in range(len(graphs)):
        n = int(rm[b, L.M_NSTEPS])
        assert torch.equal(tpl.s16w_to_s16(ks[b:b + 1])[0, :n],
                           tpl.s16w_to_s16(rs[b:b + 1])[0, :n])
