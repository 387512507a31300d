"""abpoa_tpu_torch: the plain topo-mode band DP (band_poa_dp_batch_ref)
against the JAX band kernel in interpret mode (band_poa_dp_batch,
interpret=True), on the export tuples of real rounds: seq.fa graphs of
4-5 reads, G=1, one padded geometry per case so the JAX kernel compiles
once. Cases: global (convex), extend with z-drop on a query whose tail
diverges, affine, linear, and a non-fresh call with band-state hints and
a partial rowmask. Exact equality: misc (M_LASTI is node-id mode only),
the steps as (op, row, col) triples (the JAX package's int32 words, the
port's int64 words) and the steps16 stream up to M_NSTEPS, beg/end_sn
and mpl/mpr on rows < n_rows. The affine and linear cases are in
test_torch_band_topo_gaps.py (each JAX compile takes ~15 s on one core).

The staged layout of a launch (band_dp.TopoStage), on the CPU: the
plain prologue (unstage_topo) gives back _pack_topo's scal, ctrl,
predecessor words and mplr0 and build_qpf's folds from the bytes the
batch path stages, on a seeded window round of test_torch_seeded's
heter.fa instances (fresh and not, uint8-delta and int16 predecessors,
16 and 30 slots), and the staging of stacked tensors writes the same
bytes.

On a GPU, the CUDA topo kernel against the plain version through both
staged routes (inputs staged on the card, and staged in pinned host
memory and uploaded), plus a non-fresh extend case with z-drop: misc,
steps, bsn and mplr bit-equal in full.
"""
import functools
import pathlib

import numpy as np
import pytest
import torch

from test_torch_tile_dp import _triples

DATA = pathlib.Path(__file__).resolve().parent / "data"

torch.set_num_threads(1)

GAPS = {"convex": None, "affine": (4, 2, 0, 0), "linear": (0, 2, 0, 0)}
# one padded geometry for every round of a case (one JAX compile)
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


def _params(case):
    from abpoa_tpu_torch.params import Params, EXTEND_MODE
    p = Params()
    gap = case if case in GAPS else "convex"
    if GAPS[gap] is not None:
        (p.gap_open1, p.gap_ext1, p.gap_open2, p.gap_ext2) = GAPS[gap]
    if case.endswith("extend"):
        p.align_mode = EXTEND_MODE
        p.zdrop = 20
    return p.post_set()


def _rounds(case, n_reads=4):
    """(cfg, stacked numpy tuple [1, ...], n_rows) per DP call of a case:
    read r against the graph of reads < r (oracle fusion), exported and
    re-padded to the case's one geometry."""
    from abpoa_tpu_torch.graph import POAGraph
    from abpoa_tpu_torch.params import SRC_NODE_ID, SINK_NODE_ID
    from abpoa_tpu_torch.align.engine_np import align_sequence_to_subgraph
    from abpoa_tpu_torch.align.export import (export_dense, repad_dense,
                                              make_pallas_inputs, pick_WB)
    params = _params(case)
    reads = _reads("seq.fa", n_reads)
    rng = np.random.default_rng(7)
    if case.endswith("extend"):
        # a diverging tail: the extension stops on z-drop
        reads = [np.concatenate([q[:len(q) // 2],
                                 rng.integers(0, 4, len(q) // 2)
                                 .astype(np.uint8)]) if r % 2 else q
                 for r, q in enumerate(reads)]
    qmax = max(len(q) for q in reads)
    g = POAGraph()
    g.add_graph_alignment(params, reads[0], [1] * len(reads[0]), [], None,
                          0, True)
    out = []
    for rid, q in enumerate(reads[1:], start=1):
        if not g.is_topological_sorted:
            g.topological_sort(params)
        dg = export_dense(g, params, q)
        dg = repad_dense(dg, R_PAD, dg.W, P_PAD, O_PAD)
        WB = pick_WB(params, qmax, dg.pn)
        WqB = ((qmax // 128 + 1) * 128 + WB - 1) // WB * WB
        LMAX = (R_PAD + WqB + 63) // 64 * 64
        cfg, arrs = make_pallas_inputs(dg, params, WB, force_Wq=WqB,
                                       bt_lmax=LMAX)
        arrs = [a[None] for a in arrs]
        if case.startswith("nonfresh"):
            n = dg.n_rows
            t = np.arange(R_PAD)
            hint = np.clip(t * dg.qlen // max(n - 1, 1)
                           + rng.integers(-3, 4, R_PAD), 0, dg.qlen)
            arrs[8] = np.where(t < n, hint, 0).astype(np.int16)[None]
            arrs[9] = np.where(t < n, np.minimum(hint + 2, dg.qlen),
                               0).astype(np.int16)[None]
            mask = np.ones(R_PAD, np.int8)
            mask[5:n - 5:7] = 0
            arrs[10] = mask[None]
        out.append((cfg, arrs, dg.n_rows))
        res = align_sequence_to_subgraph(g, params, SRC_NODE_ID,
                                         SINK_NODE_ID, q)
        g.add_graph_alignment(params, q, [1] * len(q), res.cigar, None,
                              rid, True)
    return out


def _port_cfg(cfg, fresh):
    from abpoa_tpu_torch.ops.band_dp import BandConfig
    return BandConfig(gap_mode=cfg.gap_mode, pn=cfg.pn, R=cfg.R, WB=cfg.WB,
                      Wq=cfg.Wq, P=cfg.P, m=cfg.m, bt_lmax=cfg.bt_lmax,
                      align_mode=cfg.align_mode, use_zdrop=cfg.use_zdrop,
                      fresh=fresh, nid=False)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(a, b, n, what):
    """BandOut a == BandOut b (JAX arrays or tensors)."""
    from abpoa_tpu_torch.ops import layout as L
    ma, mb = _np(a.misc), _np(b.misc)
    assert (ma[:, :L.M_LASTI] == mb[:, :L.M_LASTI]).all(), (what, ma, mb)
    ns = int(ma[0, L.M_NSTEPS])
    assert (_triples(a.steps[0, :ns]) == _triples(b.steps[0, :ns])).all(), \
        (what, "steps")
    assert (_np(a.steps16)[0, :ns] == _np(b.steps16)[0, :ns]).all(), \
        (what, "steps16")
    for f in ("beg_sn", "end_sn", "mpl", "mpr"):
        assert (_np(getattr(a, f))[0, :n]
                == _np(getattr(b, f))[0, :n]).all(), (what, f)


CASES = ["global", "extend", "nonfresh"]


def check_ref_equals_jax(case):
    import jax.numpy as jnp
    from abpoa_tpu.ops.dp_pallas_band import BandConfig as JBandConfig
    from abpoa_tpu.ops.dp_pallas_band import band_poa_dp_batch as jband
    from abpoa_tpu_torch.ops import band_dp as tbd
    from abpoa_tpu_torch.ops import layout as L
    fresh = case != "nonfresh"
    stopped = 0
    for cfg, arrs, n in _rounds(case):
        jc = JBandConfig(cfg.gap_mode, cfg.align_mode, cfg.pn, cfg.R,
                         cfg.WB, cfg.Wq, cfg.P, cfg.O, cfg.m, cfg.use_zdrop,
                         cfg.bt_lmax, 1, fresh=fresh)
        jout = jband(jc, *[jnp.asarray(a) for a in arrs], interpret=True)
        tout = tbd.band_poa_dp_batch(_port_cfg(cfg, fresh),
                                     *[torch.from_numpy(a) for a in arrs])
        _assert_same(jout, tout, n, case)
        m = tout.misc.numpy()[0]
        assert not m[L.M_OVFL] and not m[L.M_FAIL] and m[L.M_NSTEPS] > 0
        if case == "extend":
            # without z-drop the same sweep computes more cells
            nz = tbd.band_poa_dp_batch(
                _port_cfg(cfg, fresh)._replace(use_zdrop=False),
                *[torch.from_numpy(a) for a in arrs])
            stopped += int(m[L.M_CELLS]) < int(nz.misc[0, L.M_CELLS])
    if case == "extend":
        assert stopped  # z-drop cut at least one sweep short


def _assert_bits(k, r, what):
    """Two BandOuts bit-equal in every word of misc, steps, bsn, mplr."""
    for f in ("misc", "steps", "bsn", "mplr"):
        assert torch.equal(getattr(k, f).cpu(), getattr(r, f).cpu()), \
            (what, f)


def check_kernel_equals_ref(case, cuda_device):
    """The kernel through both staged routes against the plain version:
    the inputs on the card (staged there), and staged in pinned host
    memory as the batch path stages them (one upload a launch)."""
    from abpoa_tpu_torch.ops import band_dp as tbd
    fresh = not case.startswith("nonfresh")
    for cfg, arrs, n in _rounds(case):
        pc = _port_cfg(cfg, fresh)
        args = [torch.from_numpy(a).to(cuda_device) for a in arrs]
        k = tbd.band_poa_dp_batch(pc, *args)
        r = tbd.band_poa_dp_batch_ref(pc, *args)
        st = tbd.topo_stage(pc, 1, False)
        buf = torch.empty(st.nbytes, dtype=torch.uint8, pin_memory=True)
        tbd.stage_topo(pc, st, [tuple(a[0] for a in arrs)], buf.numpy())
        up = tbd.band_poa_dp_batch.uploads
        h = tbd.band_poa_dp_staged(pc, st, buf, cuda_device)
        torch.cuda.synchronize()
        assert tbd.band_poa_dp_batch.uploads == up + 1
        _assert_same(k, r, n, case)
        _assert_bits(k, r, case)
        _assert_bits(h, r, case)


@pytest.mark.parametrize("case", CASES)
def test_band_topo_ref_equals_jax_interpret(case):
    check_ref_equals_jax(case)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES + ["nonfresh_extend"])
def test_band_topo_kernel_equals_ref_on_gpu(case, cuda_device):
    check_kernel_equals_ref(case, cuda_device)


@functools.lru_cache(maxsize=None)
def _window_plan():
    """The band plan of a seeded window round: ``BatchPOA.run_seeded`` on
    the CPU over test_torch_seeded's config-5-shaped heter.fa instances
    (two of four reads), up to the first band plan whose windows hold a
    node of three or more predecessors."""
    from unittest import mock
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.parallel import batch
    from abpoa_tpu_torch.params import Params
    from test_torch_seeded import _config5, _reads as heter_reads

    class Planned(Exception):
        pass
    plans, round_plan = [], batch.round_plan

    def plan_once(*args, **kw):
        plan = round_plan(*args, **kw)
        plans.append(plan)
        if plan.band and max(x[3].max() for x in plan.arrs) >= 3:
            raise Planned
        return plan
    p = Params()
    p.disable_seeding = False
    insts = _config5(heter_reads("heter.fa")[:4], 2)
    with mock.patch.object(batch, "round_plan", plan_once), \
            pytest.raises(Planned):
        BatchPOA(p.post_set(), device="cpu").run_seeded(insts)
    return plans[-1]


def _deltas(arrs, R, P):
    """The predecessor rows as uint8 deltas (pred = t - delta, invalid
    slots 0), as the JAX package ships them when all fit a byte."""
    out = []
    for a in arrs:
        pi = a[2].reshape(R, P).astype(np.int64)
        valid = np.arange(P)[None, :] < a[3][:, None]
        d = np.where(valid, np.arange(R)[:, None] - pi, 0)
        assert 0 <= d.min() and d.max() <= 255
        out.append(a[:2] + (d.reshape(-1).astype(np.uint8),) + a[3:])
    return out


@pytest.mark.parametrize("P", [16, 30])
@pytest.mark.parametrize("pre", ["int16", "uint8_delta"])
@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "nonfresh"])
def test_staged_layout_decodes_to_pack_topo(fresh, pre, P):
    from abpoa_tpu_torch.ops import band_dp as tbd
    plan = _window_plan()
    cfg = plan.cfg._replace(P=P, fresh=fresh)
    R, P0 = cfg.R, plan.cfg.P
    # the window's predecessor slots padded to P (empty slots hold 0)
    arrs = [a[:2] + (np.pad(a[2].reshape(R, P0),
                            ((0, 0), (0, P - P0))).reshape(-1),) + a[3:]
            for a in plan.arrs]
    if pre == "uint8_delta":
        arrs = _deltas(arrs, R, P)
    if not fresh:
        # band-state hints and a masked stripe over the export's (a
        # window's rows start reachable, with the post-sort band state)
        rng = np.random.default_rng(11)
        for b, a in enumerate(arrs):
            n = int(a[0][1])
            mpl = a[8].copy()
            mpl[1:n] = rng.integers(0, 700, n - 1)
            rowmask = a[10].copy()
            rowmask[5:n - 5:7] = 0
            arrs[b] = a[:8] + (mpl, np.minimum(mpl + 9, 700).astype(
                a[9].dtype), rowmask)
    B = len(arrs)
    st = tbd.topo_stage(cfg, B, pre == "uint8_delta")
    buf = np.full(st.nbytes + 16, 0xA5, dtype=np.uint8)
    tbd.stage_topo(cfg, st, arrs, buf)
    cols = [torch.from_numpy(np.stack([a[i] for a in arrs]))
            for i in range(11)]
    want = tbd._pack_topo(cfg, *cols[:4], *cols[6:])
    got = tbd.unstage_topo(cfg, st, buf)
    for name, w, g in zip(("scal", "ctrl", "pre", "mplr0", "qpf"), want,
                          got):
        if w is None:
            assert g is None and fresh, name
        else:
            assert g.dtype == torch.int32 and torch.equal(w, g), name
    st2, staged = tbd._stage_tensors(cfg, cols)
    assert st2 == st and (staged.numpy() == buf[:st.nbytes]).all()
