"""abpoa_tpu_torch: the plain banded-tile DP (tile_poa_dp_batch_ref, the
plain version of kernel B5) against the JAX v1 banded-tile kernel in
interpret mode (pallas_poa_dp_batch, interpret=True) on real rounds of
seq.fa, as tests/test_pallas_kernels.py holds the JAX kernels: global
convex, affine and linear gaps, extend mode with z-drop, 32-bit score
geometry (where the Kogge-Stone scan's NEG fill shows), and a tile too
narrow for the band (M_OVFL). On a GPU, the CUDA kernel against the
plain version. Tolerance 0 (integer DP): misc (M_LASTI is not part of
the result), the steps up to M_NSTEPS as (op, row, col) triples (the
JAX package's int32 words and the port's int64 words hold the same
triples), beg/end_sn and mpl/mpr on rows < n_rows, and the tiles the gap
mode writes on the rows the sweep wrote (the kernel keeps no F tiles:
its H and E tiles only).
"""
import pathlib

import numpy as np
import pytest
import torch

DATA = pathlib.Path(__file__).resolve().parent / "data"

torch.set_num_threads(1)

R_PAD, P_PAD, O_PAD = 64, 4, 4


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


def _params(case):
    from abpoa_tpu_torch.params import Params, EXTEND_MODE
    p = Params()
    if case == "affine":
        p.gap_open2 = 0
    elif case == "linear":
        p.gap_open1 = p.gap_open2 = 0
    elif case == "extend":
        p.align_mode = EXTEND_MODE
        p.zdrop = 20
    elif case == "scores32":
        p.match = 1000
    return p.post_set()


def _rounds(case, n_reads=4):
    """(cfg, numpy tuple [1, ...], n_rows) per DP call: read r against the
    oracle-fused graph of reads < r, one padded geometry per case."""
    from abpoa_tpu_torch.graph import POAGraph
    from abpoa_tpu_torch.params import SRC_NODE_ID, SINK_NODE_ID
    from abpoa_tpu_torch.align.engine_np import align_sequence_to_subgraph
    from abpoa_tpu_torch.align.export import (export_dense, repad_dense,
                                              make_pallas_inputs, pick_WB)
    params = _params(case)
    reads = _reads("seq.fa", n_reads)
    qmax = max(len(q) for q in reads)
    Wq = (qmax // 128 + 1) * 128
    LMAX = (R_PAD + Wq + 63) // 64 * 64
    g = POAGraph()
    g.add_graph_alignment(params, reads[0], [1] * len(reads[0]), [], None,
                          0, True)
    for rid, q in enumerate(reads[1:], start=1):
        if not g.is_topological_sorted:
            g.topological_sort(params)
        dg = export_dense(g, params, q)
        WB = 2 * dg.pn if case == "overflow" else pick_WB(params, qmax,
                                                          dg.pn)
        dg = repad_dense(dg, R_PAD, dg.W, P_PAD, O_PAD)
        cfg, arrs = make_pallas_inputs(dg, params, WB, force_Wq=Wq,
                                       bt_lmax=LMAX)
        yield cfg, [a[None] for a in arrs[:10]], dg.n_rows
        res = align_sequence_to_subgraph(g, params, SRC_NODE_ID,
                                         SINK_NODE_ID, q)
        g.add_graph_alignment(params, q, [1] * len(q), res.cigar, None,
                              rid, True)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _swept_rows(out, cfg):
    """Rows the sweep wrote: 0 and 1..k, where the band cells of rows
    1..k add up to M_CELLS (extend mode may stop early)."""
    from abpoa_tpu_torch.ops import layout as L
    beg, end = _np(out.beg_sn)[0], _np(out.end_sn)[0]
    cum = np.cumsum((end[1:] - beg[1:] + 1) * cfg.pn)
    k = int(np.searchsorted(cum, int(_np(out.misc)[0, L.M_CELLS]))) + 1
    return k + 1


def _triples(steps):
    """(op, row, col) of step words: the JAX package's int32
    op|row<<2|col<<14 or the port's int64 op|row<<2|col<<32."""
    from abpoa_tpu_torch.ops.steps import step_fields
    w = _np(steps).astype(np.int64)
    if _np(steps).dtype == np.int32:
        return np.stack([w & 3, (w >> 2) & 0xFFF, w >> 14])
    return np.stack(step_fields(w))


def _assert_same(a, b, cfg, n, what, planes=None):
    from abpoa_tpu_torch.ops import layout as L
    ma, mb = _np(a.misc), _np(b.misc)
    assert (ma[:, :L.M_LASTI] == mb[:, :L.M_LASTI]).all(), (what, ma, mb)
    ns = int(ma[0, L.M_NSTEPS])
    assert (_triples(a.steps[0, :ns]) == _triples(b.steps[0, :ns])).all(), \
        what
    for f in ("beg_sn", "end_sn", "mpl", "mpr"):
        assert (_np(getattr(a, f))[0, :n]
                == _np(getattr(b, f))[0, :n]).all(), (what, f)
    rows = _swept_rows(b, cfg)
    if planes is None:
        planes = {0: ("Hb",), 1: ("Hb", "E1b", "F1b")}.get(
            cfg.gap_mode, ("Hb", "E1b", "E2b", "F1b", "F2b"))
    for f in planes:
        assert (_np(getattr(a, f))[0, :rows]
                == _np(getattr(b, f))[0, :rows]).all(), (what, f)


CASES = ["convex", "affine", "linear", "extend", "scores32", "overflow"]


@pytest.mark.parametrize("case", CASES)
def test_tile_ref_equals_jax_interpret(case):
    import jax.numpy as jnp
    from abpoa_tpu.ops import dp_pallas as dpp
    from abpoa_tpu_torch.ops import layout as L
    from abpoa_tpu_torch.ops import tile_dp
    n_ovfl = 0
    for cfg, arrs, n in _rounds(case):
        jcfg = dpp.PallasDPConfig(*cfg)
        jout = dpp.pallas_poa_dp_batch(jcfg, *[jnp.asarray(a) for a in arrs],
                                       interpret=True)
        tout = tile_dp.tile_poa_dp_batch(cfg,
                                         *[torch.from_numpy(a) for a in arrs])
        _assert_same(jout, tout, cfg, n, case)
        m = tout.misc.numpy()[0]
        n_ovfl += int(m[L.M_OVFL])
        if case != "overflow":
            assert not m[L.M_OVFL] and not m[L.M_FAIL] and m[L.M_NSTEPS] > 0
    assert (n_ovfl > 0) == (case == "overflow")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_tile_kernel_equals_ref_on_gpu(case, cuda_device):
    from abpoa_tpu_torch.ops import tile_dp
    for cfg, arrs, n in _rounds(case):
        args = [torch.from_numpy(a).to(cuda_device) for a in arrs]
        k = tile_dp.tile_poa_dp_batch(cfg, *args)
        r = tile_dp.tile_poa_dp_batch_ref(cfg, *args)
        torch.cuda.synchronize()
        # the kernel's tiles are scratch: H and E on the rows it swept
        _assert_same(k, r, cfg, n, case,
                     planes={0: ("Hb",), 1: ("Hb", "E1b")}.get(
                         cfg.gap_mode, ("Hb", "E1b", "E2b")))
        assert k.F1b is None and k.F2b is None
