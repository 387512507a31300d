"""abpoa_tpu_torch: the DP kernels at the edges of their shapes, on the
card, against their plain versions (bit-equal, as chip_smoke.py holds
them at the main path's shapes).

The inputs are synthetic exports (``synth_dense``): a random DAG in
topological order whose query is a mutated path through it, exported
through ``make_pallas_inputs`` as the round path exports a real graph.
Edges: B4 (``fw_poa_dp_batch``) with more than 1024 columns (several
column tiles a block), 16, 32 and 512 predecessor slots (a row of 270
predecessors on the only path, past what a backtrack word's slot field
holds), rows with no valid predecessor (the unreachable rows of a
window), R near 4096, R past 4096 and past the shared-memory switch of
its per-row arrays (9000 rows), and extend mode stopped by z-drop; B3
(``band_poa_dp_batch``) with 1024 band lanes, 16 predecessor slots, rows
with no valid predecessor, R near 4096, R past 4096 (8192, the last
graph of the steps16 row decrement) and past 8192 (9000), and the
z-drop stop; B5 (``tile_poa_dp_batch``) with 512 predecessor slots (the
spill), a 2048-lane tile (two tiles a row), rows with no predecessor,
R past its shared-memory switch and the z-drop stop. Every case needs a
CUDA card; synth_dense's own checks run on the CPU.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def synth_dense(params, n, seed, R=None, span=6, fan=3, wide=(), dead=(),
                diverge=False, qcut=None):
    """A DenseGraph of n rows on R padded rows (row 0 the source, row
    n-1 the sink) and its query. Row t in [1, n-1) takes the live row
    before it and up to fan-1 more among the `span` rows before that;
    each (row, k) in `wide` takes k predecessors; the rows in `dead` take
    none, and the live row before each keeps an out-edge into it (a
    window export drops the in-edges of unreachable rows, not the
    out-edges into them). The query is the bases of the chain through the
    live rows with 10 % substitutions, so the band follows the diagonal;
    with `diverge` the rows' bases are 0-2 and the query's second half is
    all 3: nothing matches it. qcut: keep the query's first qcut bases
    (a short query against a long graph, where the plain versions' rows
    stay narrow)."""
    from abpoa_tpu_torch.align.export import DenseGraph, score_dispatch
    rng = np.random.default_rng(seed)
    R = R or (n + 63) // 64 * 64
    wide = dict(wide)
    dead = set(dead)
    live = [t for t in range(1, n - 1) if t not in dead]
    preds = [[] for _ in range(n)]
    for t in live:
        k = wide.get(t, int(rng.integers(1, fan + 1)))
        chain = max(s for s in range(t) if s not in dead)
        lo = max(0, t - max(span, k))
        cand = [s for s in range(lo, chain) if s not in dead]
        more = rng.choice(cand, size=min(k - 1, len(cand)), replace=False)
        preds[t] = sorted([chain] + more.tolist())
    preds[n - 1] = [live[-1]]
    outs = [[] for _ in range(n)]
    for t in range(1, n):
        for s in preds[t]:
            outs[s].append(t)
    for t in dead:
        outs[max(s for s in range(t) if s not in dead)].append(t)
    bases = np.zeros(R, np.int32)
    bases[1:n - 1] = rng.integers(0, 3 if diverge else 4, n - 2)
    remain = np.zeros(R, np.int32)
    for t in range(n - 2, -1, -1):
        remain[t] = 1 + max((remain[o] for o in outs[t]), default=-1)
    q = bases[live].copy()
    qlen = len(q)
    sub = rng.random(qlen) < 0.1
    q[sub] = rng.integers(0, 4, int(sub.sum()))
    if diverge:
        q[qlen // 2:] = 3
    if qcut is not None:
        q = q[:qcut]
        qlen = len(q)
    P = max(2, 1 << (max(len(p) for p in preds) - 1).bit_length())
    O = max(2, 1 << (max(len(o) for o in outs) - 1).bit_length())
    pre_idx = np.zeros((R, P), np.int32)
    out_idx = np.zeros((R, O), np.int32)
    pre_n = np.zeros(R, np.int32)
    out_n = np.zeros(R, np.int32)
    for t in range(n):
        pre_idx[t, :len(preds[t])] = preds[t]
        out_idx[t, :len(outs[t])] = outs[t]
        pre_n[t], out_n[t] = len(preds[t]), len(outs[t])
    pn, inf_min = score_dispatch(params, n, qlen)
    W = (qlen // 128 + 1) * 128
    qcol = np.zeros(W, np.int32)
    qcol[1:qlen + 1] = q
    # band-state hints (read when not fresh): each live row's column
    hint = np.zeros(R, np.int32)
    hint[live] = np.arange(1, len(live) + 1)
    dg = DenseGraph(n, qlen, pn, inf_min, bases, pre_idx, pre_n, out_idx,
                    out_n, remain, hint, hint.copy(), qcol, None, R, W, P, O)
    if dead:
        dg.rowmask = (np.arange(R) < n).astype(np.int32)
        dg.rowmask[list(dead)] = 0
    return dg


def _params(extend=False, wb=None):
    from abpoa_tpu_torch.params import Params, EXTEND_MODE
    p = Params()
    if extend:
        # z-drop measures the drop against e1 per off-diagonal step: with
        # gaps dearer than mismatches the row maximum follows the diagonal
        # into the query's diverging half and the drop stops the extension
        p.align_mode = EXTEND_MODE
        p.zdrop = 20
        p.gap_open1, p.gap_ext1, p.gap_open2, p.gap_ext2 = 30, 10, 0, 0
    if wb is not None:
        p.wb = wb
    return p.post_set()


def _stack(made):
    return [np.stack([a[i] for a in made]) for i in range(len(made[0]))]


# (name, params kwargs, synth_dense kwargs per instance)
FW_CASES = {
    "wide_rows": ({"wb": -1}, dict(n=2600)),
    "p16": ({}, dict(n=400, wide=((50, 16), (200, 16)))),
    "p32": ({}, dict(n=400, wide=((60, 20), (210, 32)))),
    # more predecessors than a backtrack word's slot field holds (253),
    # on the only path (no band: the walk's M step through row 290 takes
    # the row before, slot 269, which it reads from the planes)
    "p512": ({"wb": -1}, dict(n=300, fan=1, wide=((290, 270),))),
    "dead_rows": ({}, dict(n=400, dead=(30, 31, 90, 250))),
    "r4096": ({}, dict(n=4000, R=4096, wide=((3000, 20),))),
    # past 4096 rows and past the shared memory of its per-row arrays
    "r9000": ({}, dict(n=9000, qcut=1500, wide=((7000, 20),))),
    "zdrop": ({"extend": True}, dict(n=600, fan=1, diverge=True)),
}


def _fw_inputs(case, dev, B=2):
    from abpoa_tpu_torch.align.export import make_pallas_inputs, repad_dense
    from abpoa_tpu_torch.ops.fw_dp import FWConfig
    pkw, gkw = FW_CASES[case]
    params = _params(**pkw)
    dgs = [synth_dense(params, seed=11 + b, **gkw) for b in range(B)]
    R = max(d.R for d in dgs)
    Wq = max(d.W for d in dgs)
    P = max(d.P for d in dgs)
    O = max(d.O for d in dgs)
    dgs = [repad_dense(d, R, Wq, P, O) for d in dgs]
    lmax = (R + Wq + 63) // 64 * 64
    made = [make_pallas_inputs(d, params, 128, force_Wq=Wq, bt_lmax=lmax)
            for d in dgs]
    c = made[0][0]
    cfg = FWConfig(c.gap_mode, c.align_mode, c.pn, R, Wq, P, O, c.m,
                   c.use_zdrop, lmax, banded=params.wb >= 0)
    args = [torch.from_numpy(a).to(dev) for a in _stack([m[1] for m in made])]
    return cfg, args, [d.n_rows for d in dgs]


def _band_inputs(case, dev, B=2):
    from abpoa_tpu_torch.align.export import (make_pallas_inputs, pick_WB,
                                              repad_dense)
    from abpoa_tpu_torch.ops.band_dp import BandConfig
    pkw, gkw = dict(BAND_CASES[case][0]), BAND_CASES[case][1]
    WB_force = pkw.pop("WB", None)
    params = _params(**pkw)
    dgs = [synth_dense(params, seed=21 + b, **gkw) for b in range(B)]
    R = max(d.R for d in dgs)
    P = max(d.P for d in dgs)
    O = max(d.O for d in dgs)
    qmax = max(d.qlen for d in dgs)
    WB = WB_force or max(pick_WB(params, d.qlen, d.pn) for d in dgs)
    Wq = ((qmax // 128 + 1) * 128 + WB - 1) // WB * WB
    dgs = [repad_dense(d, R, Wq, P, O) for d in dgs]
    lmax = (R + Wq + 63) // 64 * 64
    made = [make_pallas_inputs(d, params, WB, force_Wq=Wq, bt_lmax=lmax)
            for d in dgs]
    c = made[0][0]
    cfg = BandConfig(gap_mode=c.gap_mode, pn=c.pn, R=R, WB=WB, Wq=Wq, P=P,
                     m=c.m, bt_lmax=lmax, align_mode=c.align_mode,
                     use_zdrop=c.use_zdrop, fresh=not gkw.get("dead"),
                     nid=False)
    args = [torch.from_numpy(a).to(dev) for a in _stack([m[1] for m in made])]
    return cfg, args, [d.n_rows for d in dgs]


BAND_CASES = {
    "wb1024": ({"WB": 1024, "wb": 200}, dict(n=1500)),
    "p16": ({}, dict(n=400, wide=((50, 16), (200, 16)))),
    "dead_rows": ({}, dict(n=400, dead=(30, 31, 90, 250))),
    "r4096": ({}, dict(n=4000, R=4096)),
    # past 4096 rows: the last graph whose steps16 rows fit, and past it
    "r8192": ({}, dict(n=8100, R=8192, qcut=2000)),
    "r9000": ({}, dict(n=9000, fan=1, qcut=2000)),
    "zdrop": ({"extend": True}, dict(n=600, fan=1, diverge=True)),
}


def _tile_inputs(case, dev, B=2):
    from abpoa_tpu_torch.align.export import (make_pallas_inputs, pick_WB,
                                              repad_dense)
    pkw, gkw = dict(TILE_CASES[case][0]), TILE_CASES[case][1]
    WB_force = pkw.pop("WB", None)
    params = _params(**pkw)
    dgs = [synth_dense(params, seed=31 + b, **gkw) for b in range(B)]
    R = max(d.R for d in dgs)
    Wq = max(d.W for d in dgs)
    P = max(d.P for d in dgs)
    O = max(d.O for d in dgs)
    WB = WB_force or max(pick_WB(params, d.qlen, d.pn) for d in dgs)
    dgs = [repad_dense(d, R, Wq, P, O) for d in dgs]
    lmax = (R + Wq + 511) // 512 * 512
    made = [make_pallas_inputs(d, params, WB, force_Wq=Wq, bt_lmax=lmax)
            for d in dgs]
    args = [torch.from_numpy(a).to(dev)
            for a in _stack([m[1][:10] for m in made])]
    return made[0][0], args, [d.n_rows for d in dgs]


TILE_CASES = {
    "p512": ({}, dict(n=300, fan=1, wide=((290, 270),))),
    "wb2048": ({"WB": 2048, "wb": 400}, dict(n=2500)),
    "dead_rows": ({}, dict(n=400, dead=(30, 31, 90, 250))),
    # past the shared memory of its per-row arrays
    "r9000": ({}, dict(n=9000, qcut=2000, wide=((7000, 20),))),
    "zdrop": ({"extend": True}, dict(n=600, fan=1, diverge=True)),
}


def _assert_same(k, r, nrows, fields, what):
    from abpoa_tpu_torch.ops import layout as L
    assert torch.equal(k.misc[:, :L.M_LASTI], r.misc[:, :L.M_LASTI]), (
        what, k.misc.tolist(), r.misc.tolist())
    for b, n in enumerate(nrows):
        ns = int(r.misc[b, L.M_NSTEPS])
        for f in fields:
            assert torch.equal(getattr(k, f)[b, :ns], getattr(r, f)[b, :ns]), \
                (what, b, f)
        for f in ("beg_sn", "end_sn", "mpl", "mpr"):
            assert torch.equal(getattr(k, f)[b, :n], getattr(r, f)[b, :n]), \
                (what, b, f)


def test_synth_dense_is_a_dag_with_consistent_lists():
    """synth_dense's graphs: predecessors before their rows, out lists
    the mirror of the in lists (plus the edges into dead rows), the wide
    rows as wide as asked, every live row on a path to the sink."""
    p = _params()
    dg = synth_dense(p, n=120, seed=3, wide=((40, 16),), dead=(10, 70))
    n = dg.n_rows
    ins = {(int(s), t) for t in range(n) for s in dg.pre_idx[t, :dg.pre_n[t]]}
    outs = {(s, int(t)) for s in range(n) for t in dg.out_idx[s, :dg.out_n[s]]}
    assert all(s < t for s, t in ins)
    assert ins == {e for e in outs if e[1] not in (10, 70)}
    assert dg.pre_n[40] == 16 and dg.P == 16
    assert dg.pre_n[10] == dg.pre_n[70] == 0 and dg.rowmask[10] == 0
    live = np.ones(n - 1, bool)
    live[[10, 70]] = False
    assert (dg.remain[:n - 1][live] >= 1).all() and dg.remain[n - 1] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FW_CASES))
def test_fw_kernel_edges_on_gpu(case, cuda_device):
    from abpoa_tpu_torch.ops import fw_dp as fw
    from abpoa_tpu_torch.ops import layout as L
    cfg, args, nrows = _fw_inputs(case, cuda_device)
    k = fw.FWOut(*(t.cpu() for t in fw.fw_poa_dp_batch(cfg, *args)))
    # the plain version on the host's copies of the inputs: a loop of
    # small ops over every slot of every row, which costs less there
    # than as launches on the card
    host = [a.cpu() for a in args]
    r = fw.fw_poa_dp_batch_ref(cfg, *host)
    _assert_same(k, r, nrows, ("steps",), case)
    if case == "zdrop":
        # the stop fired: fewer cells than the same sweep without z-drop
        r0 = fw.fw_poa_dp_batch_ref(cfg._replace(use_zdrop=False), *host)
        assert (r.misc[:, L.M_CELLS] < r0.misc[:, L.M_CELLS]).all()
    assert int(r.misc[:, L.M_NSTEPS].min()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tile_kernel_edges_on_gpu(case, cuda_device):
    from abpoa_tpu_torch.ops import tile_dp as td
    from abpoa_tpu_torch.ops import layout as L
    cfg, args, nrows = _tile_inputs(case, cuda_device)
    k = td.tile_poa_dp_batch(cfg, *args)
    k = td.TileOut(*(t.cpu() if t is not None else None for t in k))
    # the plain version on the host's copies of the inputs
    host = [a.cpu() for a in args]
    r = td.tile_poa_dp_batch_ref(cfg, *host)
    _assert_same(k, r, nrows, ("steps",), case)
    if case == "zdrop":
        r0 = td.tile_poa_dp_batch_ref(cfg._replace(use_zdrop=False), *host)
        assert (r.misc[:, L.M_CELLS] < r0.misc[:, L.M_CELLS]).all()
    assert int(r.misc[:, L.M_NSTEPS].min()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BAND_CASES))
def test_band_topo_kernel_edges_on_gpu(case, cuda_device):
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.ops import layout as L
    cfg, args, nrows = _band_inputs(case, cuda_device)
    k = bd.band_poa_dp_batch(cfg, *args)
    r = bd.band_poa_dp_batch_ref(cfg, *args)
    torch.cuda.synchronize()
    _assert_same(k, r, nrows, ("steps", "steps16"), case)
    if case == "zdrop":
        r0 = bd.band_poa_dp_batch_ref(cfg._replace(use_zdrop=False), *args)
        assert (r.misc[:, L.M_CELLS] < r0.misc[:, L.M_CELLS]).all()
