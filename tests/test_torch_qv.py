"""abpoa_tpu_torch: qv weights on the device loop (the graph kernel's
wide-weight mode, wmode 1).

* The plain graph update in wmode 1 equals the JAX graph kernel
  (interpret mode) with the same packed weight stream, on the packed
  state (full-word out-edge entries id | w<<16), the topo maps and the
  flags, on a round of real step streams: new edges take the
  weight of their query base, bumps add it, the sink edge takes the
  last base's.
* convert carries the wide state and wmode across.
* BatchPOA on the CPU (plain versions) runs the device loop in wmode 1
  on the instances and weights of the JAX package's
  test_dispatcher_qv_weights and equals the JAX serial oracle under the
  same weights, with 0 fallbacks; a batch whose weight bound reaches
  2^15 takes the round path and equals the oracle too.
* On a GPU: the CUDA kernel's wmode-1 instance against its plain
  version, round by round; the qv device loop on the card against the
  oracle.
Exact equality everywhere.
"""
import pathlib

import numpy as np
import pytest
import torch

from abpoa_tpu.params import Params
from test_torch_graph_update import _jax_graph_update

# paths spelled out here (not imported from conftest) so the gpu tests
# also run with --noconftest on a host without JAX
DATA = pathlib.Path(__file__).resolve().parent / "data"

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _reads(fn, n):
    from abpoa_tpu.seqio import read_seqs
    from abpoa_tpu.alphabet import encode_table
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / fn))][:n]


def _weights(instances, seed=77, hi=60):
    rng = np.random.default_rng(seed)
    return [[rng.integers(1, hi, len(q)).tolist() for q in reads]
            for reads in instances]


def _serial_oracle(instances, params, weights):
    """The JAX package's serial consensus per instance under weights."""
    from abpoa_tpu.api import ABPOA
    from abpoa_tpu.consensus import generate_consensus
    from abpoa_tpu.alphabet import decode_table
    dt = decode_table(params.m)
    out = []
    for reads, ws in zip(instances, weights):
        ab = ABPOA()
        ab.n_seq, ab.names, ab.is_rc = len(reads), [""] * len(reads), \
            [0] * len(reads)
        ab.poa(params, reads, ws, 0)
        generate_consensus(ab, params)
        out.append([bytes(dt[b] for b in s).decode()
                    for s in ab.cons.cons_base[:ab.cons.n_cons]])
    return out


def _jax_cfg(params, maxlen, B, R):
    from abpoa_tpu.align.engine_np import score_width_dispatch
    from abpoa_tpu.align.engine_jax import pick_WB
    from abpoa_tpu.ops.poa_loop import LoopConfig
    _bits, pn, _ln, inf_min = score_width_dispatch(params, R, maxlen)
    WB = pick_WB(params, maxlen, pn)
    Wq = ((maxlen // 128) + 1) * 128
    Wq = (Wq + WB - 1) // WB * WB
    LS = (R + Wq + 63) // 64 * 64
    return LoopConfig(R=R, E=12, P=8, A=4, Wq=Wq, WB=WB, LS=LS, NR=1, B=B,
                      G=1, GT=B, pn=pn, inf_min=inf_min,
                      gap_mode=params.gap_mode, use_zdrop=False, wmode=1)


def _round_inputs(graphs, params, q, w, LS, Wq):
    """One round of every graph against read q: the oracle's alignment as
    steps16 wire words + misc, the query codes and the weight stream."""
    from test_torch_graph_update import _oracle_steps, _wire
    B = len(graphs)
    steps = np.zeros((B, LS), np.int64)
    misc = np.zeros((B, 10), np.int32)
    res = []
    for b, g in enumerate(graphs):
        r, steps[b], misc[b] = _oracle_steps(g, params, q, LS)
        res.append(r)
    qc = np.zeros((B, Wq), np.int8)
    qc[:, 1:len(q) + 1] = q
    qw = np.zeros((B, Wq), np.int32)
    qw[:, :len(q)] = w
    s16w, misc2 = _wire(steps, misc)
    return res, s16w, misc2, qc, qw


def test_graph_update_qv_ref_equals_jax_kernel():
    """One round of two seq.fa instances (different weighted read 0,
    a weighted read 2): the plain wmode-1 graph update equals the JAX
    graph kernel's wmode-1 body on the packed state, topo maps and
    flags."""
    from abpoa_tpu.graph import POAGraph
    from abpoa_tpu.ops import poa_loop as pls
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import graph_update as tgu
    from abpoa_tpu_torch import convert
    params = Params().post_set()
    reads = _reads("seq.fa", 5)
    (ws,) = _weights([reads])
    B = 2
    cfg = _jax_cfg(params, max(len(q) for q in reads), B, 192)
    tcfg = convert.loop_config(cfg)
    assert tcfg.wmode == 1
    graphs = []
    for r0 in (0, 1):
        g = POAGraph()
        g.add_graph_alignment(params, reads[r0], ws[r0], [], None, 0, True)
        g.topological_sort(params)
        graphs.append(g)
    ps = pls.pack_state(cfg, *pls.init_state_np(graphs, cfg))
    q = reads[2]
    _res, s16w, misc2, qc, qw = _round_inputs(graphs, params, q, ws[2],
                                              cfg.LS, cfg.Wq)
    qlen = np.full(B, len(q), np.int32)
    jout = _jax_graph_update(cfg, ps, s16w, misc2, qlen, qc, qw)
    tout = tgu.graph_update_packed(
        tcfg, convert.packed_state(ps, "cpu"), s16w, misc2,
        torch.from_numpy(qlen), tpl.pack_qp4(tcfg, torch.from_numpy(qc)),
        qw=tpl.pack_qw(tcfg, torch.from_numpy(qw)))
    assert np.asarray(jout.fail).tolist() == tout.fail.tolist() == [0, 0]
    assert (np.asarray(jout.node_n) == tout.node_n.numpy()).all()
    for name in ("ctrl", "outp", "inp", "alp"):
        assert (np.asarray(getattr(jout, name))
                == getattr(tout, name).numpy()).all(), name
    for b in range(B):
        n = int(tout.node_n[b])
        assert (np.asarray(jout.i2nn)[b, :n] == tout.i2nn[b, :n].numpy()).all()
    # the edge weights are sums of qv weights (bumped edges carry two
    # reads' weights), not edge counts
    st, *_ = tpl.unpack_state(tcfg, tout)
    assert int(st.out_w.max()) > 60


def _tie_round():
    """One wmode-1 round of two seq.fa instances (weighted reads 0 and 1,
    query read 2): in each, a matched node u is followed by an insertion,
    so the round gives u a second out-edge, and that base's weight is
    set to the weight of u's first edge (instance 0: a tie, the first
    slot must win max_remain's heaviest-edge chase) or one more
    (instance 1). Returns (JAX cfg, init_state_np's tuple, s16w, misc,
    qlen, qc, qw, the two nodes u)."""
    from abpoa_tpu.graph import POAGraph
    from abpoa_tpu.ops import poa_loop as pls
    from test_torch_graph_update import _resolving
    params = Params().post_set()
    reads = _reads("seq.fa", 5)
    (ws,) = _weights([reads])
    B = 2
    cfg = _jax_cfg(params, max(len(q) for q in reads), B, 192)
    graphs = []
    for r0 in (0, 1):
        g = POAGraph()
        g.add_graph_alignment(params, reads[r0], ws[r0], [], None, 0, True)
        g.topological_sort(params)
        graphs.append(g)
    st, i2n, n2i, remain = pls.init_state_np(graphs, cfg)
    q = reads[2]
    _res, s16w, misc2, qc, qw = _round_inputs(graphs, params, q, ws[2],
                                              cfg.LS, cfg.Wq)
    from test_torch_graph_update import _oracle_steps
    nodes = []
    for b, g in enumerate(graphs):
        _r, steps, misc = _oracle_steps(g, params, q, cfg.LS)
        res = _resolving(st, i2n, b, steps, misc, qc[b], len(q))
        k = next(k for k, (op, u, match, col) in enumerate(res[:-1])
                 if match and u > 1 and st.n_out[b, u] == 1
                 and res[k + 1][0] == 1)
        u = res[k][1]
        qw[b, res[k + 1][3] - 1] = int(st.out_w[b, u, 0]) + b
        nodes.append(u)
    qlen = np.full(B, len(q), np.int32)
    return cfg, (st, i2n, n2i, remain), s16w, misc2, qlen, qc, qw, nodes


def test_graph_update_qv_tied_edges_equal_jax_kernel():
    """max_remain's first-max rule under qv weights: a node's new
    out-edge ties its old one (instance 0) or outweighs it by one
    (instance 1); the plain wmode-1 graph update equals the JAX graph
    kernel on the packed state (remain rides in ctrl), the topo maps and
    the flags, and the ties are in the state."""
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import graph_update as tgu
    from abpoa_tpu_torch import convert
    from abpoa_tpu.ops import poa_loop as pls
    from test_torch_graph_update import _assert_rounds_equal
    cfg, state, s16w, misc2, qlen, qc, qw, nodes = _tie_round()
    tcfg = convert.loop_config(cfg)
    ps = pls.pack_state(cfg, *state)
    jout = _jax_graph_update(cfg, ps, s16w, misc2, qlen, qc, qw)
    tout = tgu.graph_update_packed(
        tcfg, convert.packed_state(ps, "cpu"), s16w, misc2,
        torch.from_numpy(qlen), tpl.pack_qp4(tcfg, torch.from_numpy(qc)),
        qw=tpl.pack_qw(tcfg, torch.from_numpy(qw)))
    _assert_rounds_equal(jout, tout, [0, 0])
    st = tpl.unpack_state(tcfg, tout)[0]
    for b, u in enumerate(nodes):
        assert int(st.n_out[b, u]) == 2
        assert int(st.out_w[b, u, 1]) - int(st.out_w[b, u, 0]) == b


def test_convert_carries_the_wide_state():
    """convert.loop_config keeps wmode 1 and convert.packed_state the
    full-word out-edge entries: the port's unpack equals the JAX
    package's, weights past any 16-wbits half included."""
    from abpoa_tpu.graph import POAGraph
    from abpoa_tpu.ops import poa_loop as pls
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch import convert
    params = Params().post_set()
    reads = _reads("seq.fa", 2)
    cfg = _jax_cfg(params, max(len(q) for q in reads), 1, 192)
    g = POAGraph()
    g.add_graph_alignment(params, reads[0], [5000] * len(reads[0]), [],
                          None, 0, True)
    g.topological_sort(params)
    init = pls.init_state_np([g], cfg)
    ps = pls.pack_state(cfg, *init)
    tcfg = convert.loop_config(cfg)
    tps = convert.packed_state(ps, "cpu")
    assert tuple(tps.outp.shape) == (1, cfg.R * cfg.E)
    jst, ji2n, jn2i, jrem = pls.unpack_state(cfg, ps)
    tst, ti2n, tn2i, trem = tpl.unpack_state(tcfg, tps)
    for a, b in zip(jst, tst):
        assert (np.asarray(a) == b.numpy()).all()
    assert int(tst.out_w.max()) == 5000
    # and the port packs its own state the same way
    again = tpl.pack_state(tcfg, *convert.loop_inputs(*init, "cpu"))
    assert torch.equal(again.outp, tps.outp)


def test_device_loop_qv_equals_oracle():
    """The instances and weights of the JAX package's
    test_dispatcher_qv_weights through the port's device loop (plain
    versions): wmode 1, 0 fallbacks, the serial oracle's consensus."""
    from abpoa_tpu_torch import BatchPOA, convert
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    params = Params().post_set()
    seq = _reads("seq.fa", 6)
    instances = [seq[:4], seq[1:6], seq[:3]]
    weights = _weights(instances)
    tparams = convert.params(params)
    assert _loop_geometry(tparams, instances, wmax=60 * 5).wmode == 1
    bp = BatchPOA(tparams, device="cpu")
    assert bp.run_consensus(instances, weights=weights) \
        == _serial_oracle(instances, params, weights)
    assert bp.used_device_loop and bp.fallbacks == 0


def test_qv_weight_bound_takes_the_round_path():
    """Per-read weight maxima that sum to 2^15 or more do not fit the
    wide out-edge word: the batch runs the round path (weights in the
    host fusion) and still equals the oracle."""
    from abpoa_tpu_torch import BatchPOA, convert
    params = Params().post_set()
    seq = _reads("seq.fa", 4)
    instances = [seq]
    weights = _weights(instances, seed=5, hi=8192)
    for w in weights[0]:
        w[-1] = 8192             # four reads of max 8192: the bound is 2^15
    bp = BatchPOA(convert.params(params), device="cpu")
    assert bp.run_consensus(instances, weights=weights) \
        == _serial_oracle(instances, params, weights)
    assert not bp.used_device_loop and bp.fallbacks == 0
    assert bp.launches["band_dp_topo"] == len(seq) - 1


@pytest.mark.gpu
def test_graph_kernel_qv_equals_ref_on_gpu(cuda_device):
    """The wmode-1 instance of csrc/graph_update.cu against the plain
    version on the card, round by round on weighted heter.fa reads
    (mismatch bundles), plus a padding instance."""
    from abpoa_tpu.graph import POAGraph
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import graph_update as tgu
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    from abpoa_tpu_torch import convert
    from test_torch_graph_update import _port_state
    params = Params().post_set()
    reads = _reads("heter.fa", 5)
    (ws,) = _weights([reads])
    cfg = _loop_geometry(convert.params(params), [reads],
                         wmax=60 * len(reads))._replace(B=2)
    assert cfg.wmode == 1
    g = POAGraph()
    g.add_graph_alignment(params, reads[0], ws[0], [], None, 0, True)
    g.topological_sort(params)
    ps = _port_state([g, g], cfg, cuda_device)
    for r, q in enumerate(reads[1:], start=1):
        if not g.is_topological_sorted:
            g.topological_sort(params)
        res, s16w, misc2, qc, qw = _round_inputs([g, g], params, q, ws[r],
                                                 cfg.LS, cfg.Wq)
        args = (s16w.to(cuda_device), misc2.to(cuda_device),
                torch.tensor([len(q), 0], dtype=torch.int32,
                             device=cuda_device),
                tpl.pack_qp4(cfg, torch.from_numpy(qc).to(cuda_device)))
        qw2 = tpl.pack_qw(cfg, torch.from_numpy(qw).to(cuda_device))
        ref = tgu.graph_update_packed_ref(cfg, ps, *args, qw=qw2)
        ker = tgu.graph_update_packed(
            cfg, tpl.PackedState(*(x.clone() for x in ps)), *args, qw=qw2)
        torch.cuda.synchronize()
        for name in ("ctrl", "outp", "inp", "alp", "node_n", "fail"):
            assert torch.equal(getattr(ker, name), getattr(ref, name)), name
        for b in range(2):
            n = int(ref.node_n[b])
            assert torch.equal(ker.i2nn[b, :n], ref.i2nn[b, :n])
        assert ref.fail.tolist() == [0, 0]
        g.add_graph_alignment(params, q, ws[r], res[0].cigar, None, r, True)
        ps = ker


@pytest.mark.gpu
def test_graph_kernel_qv_tied_edges_on_gpu(cuda_device):
    """The wmode-1 kernel against the plain version on the tie round of
    test_graph_update_qv_tied_edges_equal_jax_kernel, and B6 on the
    graph it leaves."""
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch import convert
    from test_torch_graph_update import _kernel_vs_ref
    cfg, state, s16w, misc2, qlen, qc, qw, _nodes = _tie_round()
    tcfg = convert.loop_config(cfg)
    dev = cuda_device
    ps = tpl.pack_state(tcfg, *convert.loop_inputs(*state, dev))
    args = (s16w.to(dev), misc2.to(dev), torch.from_numpy(qlen).to(dev),
            tpl.pack_qp4(tcfg, torch.from_numpy(qc).to(dev)))
    _ker, ref = _kernel_vs_ref(tcfg, ps, args,
                               tpl.pack_qw(tcfg, torch.from_numpy(qw).to(dev)))
    assert ref.fail.tolist() == [0, 0]


@pytest.mark.gpu
def test_device_loop_qv_on_gpu(cuda_device):
    """The qv device loop through both kernels on the card equals the
    serial oracle, with 0 fallbacks."""
    from abpoa_tpu_torch import BatchPOA, convert
    params = Params().post_set()
    heter = _reads("heter.fa", 15)
    instances = [heter[b:] + heter[:b] for b in range(4)]
    weights = _weights(instances)
    bp = BatchPOA(convert.params(params), device="cuda")
    assert bp.run_consensus(instances, weights=weights) \
        == _serial_oracle(instances, params, weights)
    assert bp.used_device_loop and bp.fallbacks == 0
