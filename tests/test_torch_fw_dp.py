"""abpoa_tpu_torch: the plain full-width DP (fw_poa_dp_batch_ref) against
the JAX full-width kernel in interpret mode (fw_poa_dp_batch,
interpret=True) on real rounds of seq.fa (G=1, one padded geometry per
case), and against the oracle's best score and cigar, as
tests/test_pallas_kernels.py holds the JAX kernel: local, unbanded
global and unbanded extend (z-drop on), plus the banded global rows the
round path sends here when the band kernel does not fit; linear gaps
(unbanded global) and affine gaps (local); and banded rows under
band-state hints and a partial row mask (the seeded path's windows; no
oracle there: the mask changes the problem). On a GPU, the CUDA kernel
against the plain version. Exact equality: misc (M_LASTI is not part of
the result), the steps up to M_NSTEPS as (op, row, col) triples (the JAX
package's int32 words, the port's int64 words), beg/end_sn and mpl/mpr
on rows < n_rows.
"""
import pathlib

import numpy as np
import pytest
import torch

from test_torch_tile_dp import _triples

DATA = pathlib.Path(__file__).resolve().parent / "data"

torch.set_num_threads(1)

R_PAD, P_PAD, O_PAD = 128, 4, 4


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


GAPS = {"linear": (0, 2, 0, 0), "affine": (4, 2, 0, 0)}
BANDED = ("banded", "mask")


def _params(case):
    from abpoa_tpu_torch.params import Params, LOCAL_MODE, EXTEND_MODE
    p = Params()
    if case in ("local", "affine"):
        p.align_mode = LOCAL_MODE
    elif case == "extend":
        p.align_mode = EXTEND_MODE
        p.zdrop = 20
    if case in GAPS:
        (p.gap_open1, p.gap_ext1, p.gap_open2, p.gap_ext2) = GAPS[case]
    if case not in BANDED:
        p.wb = -1
    return p.post_set()


def _mask(arrs, n, qlen, rng):
    """Band-state hints and a partial row mask on one round's tuple."""
    R = arrs[1].shape[1]
    t = np.arange(R)
    hint = np.clip(t * qlen // max(n - 1, 1) + rng.integers(-3, 4, R), 0,
                   qlen)
    arrs[8] = np.where(t < n, hint, 0).astype(np.int16)[None]
    arrs[9] = np.where(t < n, np.minimum(hint + 2, qlen), 0).astype(
        np.int16)[None]
    mask = np.ones(R, np.int8)
    mask[5:n - 5:7] = 0
    arrs[10] = mask[None]


def _rounds(case, n_reads=5):
    """(cfg, stacked numpy tuple [1, ...], n_rows, graph, query, oracle
    result) per DP call: read r against the graph of reads < r."""
    from abpoa_tpu_torch.graph import POAGraph
    from abpoa_tpu_torch.params import SRC_NODE_ID, SINK_NODE_ID
    from abpoa_tpu_torch.align.engine_np import align_sequence_to_subgraph
    from abpoa_tpu_torch.align.export import (export_dense, repad_dense,
                                              make_pallas_inputs)
    params = _params(case)
    reads = _reads("seq.fa", n_reads)
    Wq = (max(len(q) for q in reads) // 128 + 1) * 128
    LMAX = (R_PAD + Wq + 63) // 64 * 64
    rng = np.random.default_rng(7)
    g = POAGraph()
    g.add_graph_alignment(params, reads[0], [1] * len(reads[0]), [], None,
                          0, True)
    for rid, q in enumerate(reads[1:], start=1):
        if not g.is_topological_sorted:
            g.topological_sort(params)
        dg = export_dense(g, params, q)
        dg = repad_dense(dg, R_PAD, dg.W, P_PAD, O_PAD)
        cfg, arrs = make_pallas_inputs(dg, params, 128, force_Wq=Wq,
                                       bt_lmax=LMAX)
        res = align_sequence_to_subgraph(g, params, SRC_NODE_ID,
                                         SINK_NODE_ID, q)
        arrs = [a[None] for a in arrs]
        if case == "mask":
            _mask(arrs, dg.n_rows, len(q), rng)
        yield cfg, arrs, dg.n_rows, g, q, res
        g.add_graph_alignment(params, q, [1] * len(q), res.cigar, None,
                              rid, True)


def _port_cfg(cfg, case):
    from abpoa_tpu_torch.ops.fw_dp import FWConfig
    return FWConfig(cfg.gap_mode, cfg.align_mode, cfg.pn, cfg.R, cfg.Wq,
                    cfg.P, cfg.O, cfg.m, cfg.use_zdrop, cfg.bt_lmax,
                    banded=case in BANDED)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(a, b, n, what):
    from abpoa_tpu_torch.ops import layout as L
    ma, mb = _np(a.misc), _np(b.misc)
    assert (ma[:, :L.M_LASTI] == mb[:, :L.M_LASTI]).all(), (what, ma, mb)
    ns = int(ma[0, L.M_NSTEPS])
    assert (_triples(a.steps[0, :ns]) == _triples(b.steps[0, :ns])).all(), \
        what
    for f in ("beg_sn", "end_sn", "mpl", "mpr"):
        assert (_np(getattr(a, f))[0, :n]
                == _np(getattr(b, f))[0, :n]).all(), (what, f)


CASES = ["local", "global", "extend", "banded", "linear", "affine", "mask"]


@pytest.mark.parametrize("case", CASES)
def test_fw_ref_equals_jax_interpret_and_oracle(case):
    import jax.numpy as jnp
    from abpoa_tpu.ops.dp_pallas_fw import FWConfig as JFWConfig
    from abpoa_tpu.ops.dp_pallas_fw import fw_poa_dp_batch as jfw
    from abpoa_tpu_torch.align.engine_np import AlignResult
    from abpoa_tpu_torch.ops import fw_dp as tfw
    from abpoa_tpu_torch.ops import layout as L
    from abpoa_tpu_torch.ops.steps import replay_steps
    for cfg, arrs, n, g, q, res in _rounds(case):
        pc = _port_cfg(cfg, case)
        jc = JFWConfig(cfg.gap_mode, cfg.align_mode, cfg.pn, cfg.R, cfg.Wq,
                       cfg.P, cfg.O, cfg.m, cfg.use_zdrop, cfg.bt_lmax, 1,
                       banded=pc.banded)
        jout = jfw(jc, *[jnp.asarray(a) for a in arrs], interpret=True)
        tout = tfw.fw_poa_dp_batch(pc, *[torch.from_numpy(a) for a in arrs])
        _assert_same(jout, tout, n, case)
        if case == "mask":
            continue
        m = tout.misc.numpy()[0]
        assert not m[L.M_FAIL] and m[L.M_NSTEPS] > 0
        dres = AlignResult()
        dres.best_score = int(m[L.M_BEST])
        replay_steps(g, _params(case), np.asarray(q), tout.steps.numpy()[0],
                     int(m[L.M_NSTEPS]), int(m[L.M_BI]), int(m[L.M_BJ]),
                     int(m[L.M_ENDI]), int(m[L.M_ENDJ]), dres)
        assert dres.best_score == res.best_score
        assert dres.cigar == res.cigar


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_fw_kernel_equals_ref_on_gpu(case, cuda_device):
    from abpoa_tpu_torch.ops import fw_dp as tfw
    for cfg, arrs, n, _g, _q, _res in _rounds(case):
        pc = _port_cfg(cfg, case)
        args = [torch.from_numpy(a).to(cuda_device) for a in arrs]
        k = tfw.fw_poa_dp_batch(pc, *args)
        r = tfw.fw_poa_dp_batch_ref(pc, *args)
        torch.cuda.synchronize()
        _assert_same(k, r, n, case)
