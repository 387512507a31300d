"""abpoa_tpu_torch: the round and seeded paths at the JAX package's
envelope.

``round_plan`` takes the topo-mode band kernel B3 by one rule,
``band_refusal``: bands of up to 2048 lanes (four positions a thread past
1024, ``band_cpt``), up to 30 predecessor slots (``band_slots``: past 16
the even cover of the round's largest in-degree), band segments below
1024 and the kernel's shared memory. A pick field of the backtrack word
keeps 4 bits; 15 reads "slot 15 or later, or none", and the walk re-tests
slots 15.. where it takes such a condition.

CPU: the rule against the JAX package's ``use_band`` over a grid (equal
wherever the port's limits hold, the rest counted by limit); the plain
B3 at WB 1152-1536 against the port's oracle on a real extend round and
a non-fresh window round with a partial row mask, and against the JAX
kernel in interpret mode at WB 1152; the plain B3 at 18, 24 and 30 slots
(hub graphs: a node of 17-29 predecessors) against the oracle in global
and extend modes, through cells whose only hit is slot 15 and slots
16-28; the JAX kernel in interpret mode at 18 slots (its DP; its 4-bit
picks past slot 15 are not asserted). GPU (``-m gpu``): the CUDA
instances against their plain versions: four positions a thread at WB
1152, 1536 and 2048, and 18, 24 and 30 slots, in each gap mode.
"""
import collections
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from test_torch_tile_dp import _triples

DATA = pathlib.Path(__file__).resolve().parent / "data"

torch.set_num_threads(1)

GAPS = {"convex": None, "affine": (4, 2, 0, 0), "linear": (0, 2, 0, 0)}
CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _set_gaps(p, gap):
    if GAPS[gap] is not None:
        p.gap_open1, p.gap_ext1, p.gap_open2, p.gap_ext2 = GAPS[gap]
    return p


def _params(gap="convex", wb=10, wf=0.01, extend=False, zdrop=-1):
    from abpoa_tpu_torch.params import Params, EXTEND_MODE
    p = _set_gaps(Params(), gap)
    p.wb, p.wf = wb, wf
    if extend:
        p.align_mode = EXTEND_MODE
        p.zdrop = zdrop
    return p.post_set()


def _codes(seqs):
    from abpoa_tpu_torch.alphabet import encode_table
    tab = encode_table(5)
    return [tab[np.frombuffer(s.encode(), dtype=np.uint8)] for s in seqs]


def _joined(n=6):
    """chip_smoke.py's wide batches: read i joins heter.fa reads i+3 and
    i+4 (1,212-1,537 bp)."""
    from abpoa_tpu_torch.seqio import read_seqs
    h = [r.seq for r in read_seqs(str(DATA / "heter.fa"))]
    return _codes([h[(3 + i) % len(h)] + h[(4 + i) % len(h)]
                   for i in range(n)])


def _graph(params, reads):
    """The oracle's graph of `reads`, topologically sorted."""
    from abpoa_tpu_torch.align.engine_np import align_sequence_to_subgraph
    from abpoa_tpu_torch.graph import POAGraph
    from abpoa_tpu_torch.params import SRC_NODE_ID, SINK_NODE_ID
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


def _repad(dgs):
    from abpoa_tpu_torch.align.export import repad_dense
    return [repad_dense(d, max(x.R for x in dgs), max(x.W for x in dgs),
                        max(x.P for x in dgs), max(x.O for x in dgs))
            for d in dgs]


def _forced(params, dgs, WB, seeded=False):
    """B3's config and stacked inputs of exports `dgs` at band tile WB
    (a multiple of 32 at least pick_WB's), slots as round_plan narrows
    them."""
    from abpoa_tpu_torch.align.export import make_pallas_inputs
    from abpoa_tpu_torch.ops.band_dp import BandConfig
    from abpoa_tpu_torch.parallel.batch import band_slots
    P = band_slots(dgs)
    dgs = [dataclasses.replace(d, P=P, pre_idx=d.pre_idx[:, :P])
           for d in dgs]
    R = dgs[0].R
    Wq = max((d.qlen // 128 + 1) * 128 for d in dgs)
    WqB = (Wq + WB - 1) // WB * WB
    LMAX = (R + WqB + 63) // 64 * 64
    made = [make_pallas_inputs(d, params, WB, force_Wq=WqB, bt_lmax=LMAX)
            for d in dgs]
    c = made[0][0]
    cfg = BandConfig(gap_mode=c.gap_mode, pn=c.pn, R=R, WB=WB, Wq=WqB, P=P,
                     m=c.m, bt_lmax=LMAX, align_mode=c.align_mode,
                     use_zdrop=c.use_zdrop, fresh=not seeded, nid=False)
    arrs = [np.stack([m[1][i] for m in made]) for i in range(11)]
    return cfg, arrs, c


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(a, b, n_rows, what):
    """BandOut a == BandOut b (JAX arrays or tensors), every instance."""
    from abpoa_tpu_torch.ops import layout as L
    ma, mb = _np(a.misc), _np(b.misc)
    assert (ma[:, :L.M_LASTI] == mb[:, :L.M_LASTI]).all(), (what, ma, mb)
    for k, n in enumerate(n_rows):
        ns = int(ma[k, L.M_NSTEPS])
        assert (_triples(a.steps[k, :ns]) == _triples(b.steps[k, :ns])
                ).all(), (what, k, "steps")
        assert (_np(a.steps16)[k, :ns] == _np(b.steps16)[k, :ns]).all(), \
            (what, k, "steps16")
        for f in ("beg_sn", "end_sn", "mpl", "mpr"):
            assert (_np(getattr(a, f))[k, :n]
                    == _np(getattr(b, f))[k, :n]).all(), (what, k, f)


def _replayed(g, params, q, out, k, row0=0):
    """The AlignResult of instance k's step stream."""
    from abpoa_tpu_torch.align.engine_np import AlignResult
    from abpoa_tpu_torch.ops import layout as L
    from abpoa_tpu_torch.ops.steps import replay_steps
    m = _np(out.misc[k])
    assert not m[L.M_OVFL] and not m[L.M_FAIL] and m[L.M_NSTEPS] > 0
    res = AlignResult()
    res.best_score = int(m[L.M_BEST])
    return replay_steps(g, params, np.asarray(q), _np(out.steps[k]),
                        int(m[L.M_NSTEPS]), int(m[L.M_BI]), int(m[L.M_BJ]),
                        int(m[L.M_ENDI]), int(m[L.M_ENDJ]), res, row0=row0)


# ------------------------------------------------------------------ #
# inputs

def _wide_round(gap="convex", extend=True, tail=False):
    """One real -m 2 -f 0.2 round of the wide batch: read 3 against the
    graph of reads 0-2 (1,620 rows). tail: the query's last 40 %
    replaced by random bases (z-drop stops the extension there)."""
    from abpoa_tpu_torch.align.export import export_dense
    params = _params(gap, wf=0.2, extend=extend, zdrop=100 if tail else -1)
    reads = _joined()
    g = _graph(params, reads[:3])
    q = reads[3].copy()
    if tail:
        cut = len(q) * 3 // 5
        q[cut:] = np.random.default_rng(3).integers(0, 4, len(q) - cut)
    return params, g, q, [export_dense(g, params, q)]


def _window(gap="convex"):
    """A non-fresh window of a -b 200 graph (reads 0-2 of the wide batch,
    read 1 with 200 random bases at 300-500: two branches there): rows
    from the start in [250, 600) whose reachability mask leaves the most
    rows out to 30 rows before the sink, read 3's bases from there. The
    graph's band state is the last alignment's. -> (params, graph,
    window, its export, beg_id, end_id)."""
    from abpoa_tpu_torch.align.export import export_dense, subgraph_index_map
    params = _params(gap, wb=200)
    reads = _joined()
    reads[1] = reads[1].copy()
    reads[1][300:500] = np.random.default_rng(5).integers(0, 4, 200)
    g = _graph(params, reads[:3])
    ei = g.node_n - 31
    bi = max(range(250, 600), key=lambda b: int(
        (subgraph_index_map(g, b, ei)[b:ei + 1] == 0).sum()))
    win = reads[3][bi - 1:ei - 10]
    dg = export_dense(g, params, win, beg_index=bi, end_index=ei)
    assert not dg.rowmask[:dg.n_rows].all()
    return (params, g, win, dg, int(g.index_to_node_id[bi]),
            int(g.index_to_node_id[ei]))


def _hub(gap, extend, n):
    """A graph of n hub reads (``fuzz_ref.hub_reads``; the hub node has n
    predecessors, slot k the one read k added) and five queries: read 15
    again (its M at the hub only through slot 15), read n (slot n-1),
    and three that delete the hub and the next 2-3 residues after
    pre[:-16], pre[:-15] and pre[:-19] (an E move out of the hub through
    slot 16 or later, 15, 18 or later). -> (params, graph, queries,
    exports re-padded to one geometry)."""
    from abpoa_tpu_torch.align.export import export_dense
    from abpoa_tpu_torch.tools.fuzz_ref import hub_reads, NT
    seqs = hub_reads(np.random.default_rng(n), NT, n + 1)
    hub = seqs[0].index(NT[-1])
    pre, post = seqs[0][:hub], seqs[0][hub:]
    params = _params(gap, extend=extend)
    reads = _codes(seqs)
    g = _graph(params, reads[:n])
    qs = [reads[15], reads[n]] + _codes(
        [pre[:-16] + post[3:], pre[:-15] + post[3:], pre[:-19] + post[4:]])
    return params, g, qs, _repad([export_dense(g, params, q) for q in qs])


def _hub_moves(dg, out, k):
    """(op, slot) of each move of instance k's walk out of the hub row."""
    from abpoa_tpu_torch.ops import layout as L
    from abpoa_tpu_torch.ops.steps import step_fields
    hub = int(np.argmax(dg.pre_n))
    preds = list(dg.pre_idx[hub][:dg.pre_n[hub]])
    n = int(_np(out.misc[k])[L.M_NSTEPS])
    op, row, _col = step_fields(_np(out.steps[k])[:n])
    return [(int(op[i]), preds.index(row[i + 1]))
            for i in np.nonzero(row[:-1] == hub)[0]]


# ------------------------------------------------------------------ #
# (1) the rule against the JAX package's

LIMITS = ("lanes", "segments", "shared memory")


@pytest.mark.parametrize("gap", list(GAPS))
def test_band_rule_admits_the_jax_envelope(gap):
    """-b 10-600, -f 0.01-0.4, reads of 300-4,100 bp, 2-30 slots, global
    and extend, round and seeded geometry (the JAX seeded path sizes WB
    and R from its query cap): wherever the JAX package's use_band takes
    its band kernel, band_refusal takes B3 or names a limit of the port
    that the point crosses: lanes (WB past 2048), segments, shared
    memory. B3 also takes points the JAX package sends to its XLA tier
    (R past 4096) or to B4 (its planes past its VMEM budget). The grid
    reaches bands past 1024 lanes and slots past 16."""
    from abpoa_tpu.align.engine_jax import (_bucket, pick_WB as jpick_WB,
                                            score_dispatch as jscore)
    from abpoa_tpu.ops.dp_pallas_band import pick_band_G
    from abpoa_tpu.params import Params as JParams, EXTEND_MODE
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.align.export import pick_WB, score_dispatch
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.parallel.batch import band_refusal
    both = past_4096 = vmem = wide = fan = 0
    refused = collections.Counter()
    for b in (10, 100, 300, 600):
        for f in (0.01, 0.1, 0.4):
            for extend in (False, True):
                jp = _set_gaps(JParams(), gap)
                jp.wb, jp.wf = b, f
                if extend:
                    jp.align_mode = EXTEND_MODE
                jp = jp.post_set()
                tp = convert.params(jp)
                for L in range(300, 4200, 200):
                    n = L + L // 8
                    R0 = _bucket(n, 64) if n <= 512 else (n + 63) // 64 * 64
                    Wq = (L // 128 + 1) * 128
                    for seeded in (False, True):
                        # the seeded path: WB and R from the query cap
                        qlen = Wq if seeded else L
                        R = max(min(_bucket(Wq, 64), 4096), R0) if seeded \
                            else R0
                        pn = jscore(jp, R, L)[0]
                        assert pn == score_dispatch(tp, R, L)[0]
                        WB = jpick_WB(jp, qlen, pn)
                        assert WB == pick_WB(tp, qlen, pn)
                        LMAX = (R + Wq + 63) // 64 * 64
                        for P in (2, 4, 8, 16, 18, 24, 30):
                            G = pick_band_G(jp.gap_mode, R, WB, P, jp.m, LMAX)
                            jax = (G > 0 and Wq < 32000 and R <= 4096
                                   and P < 32 and jp.wb >= 0)
                            why = band_refusal(tp, R, P, WB, Wq, pn)
                            if why is None:
                                both += jax
                                past_4096 += not jax and R > 4096
                                vmem += not jax and R <= 4096 and G == 0
                                wide += jax and WB > 1024
                                fan += jax and P > 16
                                continue
                            assert not jax or why in LIMITS, \
                                (why, b, f, L, P, seeded)
                            if not jax:
                                continue
                            refused[why] += 1
                            WqB = (Wq + WB - 1) // WB * WB
                            assert {"lanes": WB > bd.MAX_WB,
                                    "segments": WqB // pn >= 1024,
                                    "shared memory": bd.band_smem_bytes(
                                        False, R, P, WB)
                                    > bd.MAX_SMEM_BYTES}[why]
    print(f"\n{gap}: both {both}, the JAX package only {dict(refused)}, "
          f"the port only: past 4096 rows {past_4096}, past the JAX VMEM "
          f"budget {vmem}; both past 1024 lanes {wide}, past 16 slots {fan}")
    assert both > 2000 and wide > 200 and fan > 500 and past_4096 > 0
    assert refused["lanes"] > 0 and refused["shared memory"] > 0


# ------------------------------------------------------------------ #
# (2)-(3) four positions a thread: WB 1152-1536

def test_band_ref_wide_extend_round_equals_oracle():
    """A real -m 2 -f 0.2 round (convex gaps): round_plan takes B3 at
    four positions a thread (WB 1408); the plain version's best score,
    cigar and band bounds equal the oracle's."""
    from abpoa_tpu_torch.align import engine_np
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.params import SRC_NODE_ID, SINK_NODE_ID
    from abpoa_tpu_torch.parallel.batch import round_plan
    params, g, q, dgs = _wide_round()
    plan = round_plan(params, dgs, CPU)
    assert plan.name == "band_dp_topo" and 1152 <= plan.cfg.WB <= 1536
    assert bd.band_cpt(plan.cfg.WB) == 4
    out = bd.band_poa_dp_batch(plan.cfg, *plan.stack(slice(None), CPU))
    base = engine_np._Ctx
    rec = {}

    class Recording(base):
        def run(self):
            super().run()
            rec["beg"] = np.array(self.dp_beg_sn[:self.n_rows])
            rec["end"] = np.array(self.dp_end_sn[:self.n_rows])
    engine_np._Ctx = Recording
    try:
        res = engine_np.align_sequence_to_subgraph(g, params, SRC_NODE_ID,
                                                   SINK_NODE_ID, q)
    finally:
        engine_np._Ctx = base
    got = _replayed(g, params, q, out, 0)
    assert got.best_score == res.best_score and got.cigar == res.cigar
    rows = slice(1, dgs[0].n_rows - 1)
    assert (out.beg_sn[0, rows].numpy() == rec["beg"][rows]).all()
    assert (out.end_sn[0, rows].numpy() == rec["end"][rows]).all()


def test_band_ref_wide_window_round_equals_oracle():
    """A non-fresh window (-b 200, 1,220 rows, a partial row mask):
    round_plan(seeded=True) takes B3 at WB 1152; the plain version's best
    score, cigar and band state written back equal the oracle's."""
    from abpoa_tpu_torch.align.engine_np import align_sequence_to_subgraph
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.parallel.batch import round_plan
    params, g, win, dg, beg_id, end_id = _window()
    plan = round_plan(params, [dg], CPU, seeded=True)
    assert plan.name == "band_dp_topo" and plan.cfg.WB == 1152
    assert not plan.cfg.fresh
    out = bd.band_poa_dp_batch(plan.cfg, *plan.stack(slice(None), CPU))
    res = align_sequence_to_subgraph(g, params, beg_id, end_id, win)
    bi = dg.beg_index
    got = _replayed(g, params, win, out, 0, row0=bi)
    assert got.best_score == res.best_score and got.cigar == res.cigar
    n = dg.n_rows
    live = dg.rowmask[:n] > 0
    ids = np.asarray(g.index_to_node_id[bi:bi + n], dtype=np.int64)[live]
    assert (np.asarray(g.node_id_to_max_pos_left)[ids]
            == out.mpl[0, :n].numpy()[live]).all()
    assert (np.asarray(g.node_id_to_max_pos_right)[ids]
            == out.mpr[0, :n].numpy()[live]).all()


def test_band_ref_wide_equals_jax_interpret():
    """WB 1152 (four positions a thread) at 2 slots: the plain version
    equals the JAX band kernel in interpret mode (global, convex, -b 300,
    whose band spans the query: heter.fa read 2 against the graph of read
    0, 606 bp each)."""
    import jax.numpy as jnp
    from abpoa_tpu.ops.dp_pallas_band import BandConfig as JBandConfig
    from abpoa_tpu.ops.dp_pallas_band import band_poa_dp_batch as jband
    from abpoa_tpu_torch.align.export import export_dense
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.seqio import read_seqs
    params = _params(wb=300)
    reads = _codes([r.seq for r in read_seqs(str(DATA / "heter.fa"))][:3])
    g = _graph(params, reads[:1])
    dgs = [export_dense(g, params, reads[2])]
    cfg, arrs, c = _forced(params, dgs, 1152)
    assert cfg.P <= 14 and bd.band_cpt(cfg.WB) == 4
    jc = JBandConfig(c.gap_mode, c.align_mode, c.pn, cfg.R, cfg.WB, cfg.Wq,
                     cfg.P, c.O, c.m, c.use_zdrop, cfg.bt_lmax, 1, fresh=True)
    jout = jband(jc, *[jnp.asarray(a) for a in arrs], interpret=True)
    tout = bd.band_poa_dp_batch(cfg, *[torch.from_numpy(a) for a in arrs])
    _assert_same(jout, tout, [dgs[0].n_rows], "WB 1152")


# ------------------------------------------------------------------ #
# (4)-(5) past 16 predecessor slots

@pytest.mark.parametrize("extend", [False, True], ids=["global", "extend"])
def test_band_ref_fan_equals_oracle(extend):
    """Hub graphs of 17, 23 and 29 reads: round_plan takes B3 at 18, 24
    and 30 slots; for each of the five queries the plain version's best
    score and cigar equal the oracle's, and the walk leaves the hub by
    an M through slot 15 (read 15), through slot n-1 (read n), and by E
    moves through slots 15 and past it."""
    from abpoa_tpu_torch.align.engine_np import align_sequence_to_subgraph
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.params import SRC_NODE_ID, SINK_NODE_ID
    from abpoa_tpu_torch.parallel.batch import round_plan
    for n in (17, 23, 29):
        params, g, qs, dgs = _hub("convex", extend, n)
        plan = round_plan(params, dgs, CPU)
        assert plan.name == "band_dp_topo" and plan.cfg.P == n + 1
        out = bd.band_poa_dp_batch(plan.cfg, *plan.stack(slice(None), CPU))
        moves = []
        for k, q in enumerate(qs):
            res = align_sequence_to_subgraph(g, params, SRC_NODE_ID,
                                             SINK_NODE_ID, q)
            got = _replayed(g, params, q, out, k)
            assert got.best_score == res.best_score, (n, k)
            assert got.cigar == res.cigar, (n, k)
            moves.append(_hub_moves(dgs[0], out, k))
        assert moves[0] == [(0, 15)] and moves[1] == [(0, n - 1)], moves
        assert moves[3] == [(2, 15)], moves
        assert all(op == 2 and s >= 16 for m in (moves[2], moves[4])
                   for op, s in m), moves


def test_jax_band_kernel_at_18_slots():
    """The JAX band kernel in interpret mode on the 18-slot hub round
    (global; the query that leaves the hub through slot 16): its DP
    (best score, cells, band bounds and band state) equals the plain
    version's. Its walk reads 4-bit picks that slot 16 and later
    overflow; its step stream is not asserted."""
    import jax.numpy as jnp
    from abpoa_tpu.ops.dp_pallas_band import BandConfig as JBandConfig
    from abpoa_tpu.ops.dp_pallas_band import band_poa_dp_batch as jband
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.ops import layout as L
    params, _g, _qs, dgs = _hub("convex", False, 17)
    dgs = dgs[1:2]
    cfg, arrs, c = _forced(params, dgs, 256)
    assert cfg.P == 18
    jc = JBandConfig(c.gap_mode, c.align_mode, c.pn, cfg.R, cfg.WB, cfg.Wq,
                     cfg.P, c.O, c.m, c.use_zdrop, cfg.bt_lmax, 1, fresh=True)
    jout = jband(jc, *[jnp.asarray(a) for a in arrs], interpret=True)
    tout = bd.band_poa_dp_batch(cfg, *[torch.from_numpy(a) for a in arrs])
    jm, tm = np.asarray(jout.misc), tout.misc.numpy()
    for f in (L.M_BEST, L.M_BI, L.M_BJ, L.M_CELLS, L.M_OVFL):
        assert (jm[:, f] == tm[:, f]).all(), f
    for k, d in enumerate(dgs):
        for f in ("beg_sn", "end_sn", "mpl", "mpr"):
            assert (_np(getattr(jout, f))[k, :d.n_rows]
                    == _np(getattr(tout, f))[k, :d.n_rows]).all(), (k, f)
    same = [bool((jm[k, :L.M_LASTI] == tm[k, :L.M_LASTI]).all()
                 and (_triples(jout.steps[k, :tm[k, L.M_NSTEPS]])
                      == _triples(tout.steps[k, :tm[k, L.M_NSTEPS]])).all())
            for k in range(len(dgs))]
    print(f"\nJAX kernel at 18 slots: walk equal to the port's (and the "
          f"oracle's) per query {same}")


# ------------------------------------------------------------------ #
# on the card

def _wide_case(case, gap, WB):
    """(cfg, numpy inputs, n_rows) of a four-positions-a-thread case at
    band tile WB: "global" (a -f 0.2 round in global mode), "nonfresh"
    (the window of _window), "extend" (-m 2 with z-drop 100 on a query
    whose tail diverges)."""
    if case == "nonfresh":
        params, _g, _w, dg, _b, _e = _window(gap)
        cfg, arrs, _c = _forced(params, [dg], WB, seeded=True)
        return cfg, arrs, [dg.n_rows]
    params, _g, _q, dgs = _wide_round(gap, extend=case == "extend",
                                      tail=case == "extend")
    cfg, arrs, _c = _forced(params, dgs, WB)
    return cfg, arrs, [dgs[0].n_rows]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["global", "nonfresh", "extend"])
@pytest.mark.parametrize("gap", list(GAPS))
@pytest.mark.parametrize("WB", [1152, 1536, 2048])
def test_band_topo_wide_on_gpu(cuda_device, case, gap, WB):
    """B3 at four positions a thread against its plain version on the
    card: misc, the step stream, band bounds and state."""
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.ops import layout as L
    cfg, arrs, n_rows = _wide_case(case, gap, WB)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    before = bd.band_poa_dp_batch.wide_launches
    k = bd.band_poa_dp_batch(cfg, *args)
    r = bd.band_poa_dp_batch_ref(cfg, *args)
    torch.cuda.synchronize()
    assert bd.band_poa_dp_batch.wide_launches == before + 1
    _assert_same(k, r, n_rows, (case, gap, WB))
    assert not r.misc[:, L.M_OVFL].any() and not r.misc[:, L.M_FAIL].any()


@pytest.mark.gpu
@pytest.mark.parametrize("gap", list(GAPS))
@pytest.mark.parametrize("n", [17, 23, 29])
def test_band_topo_fan_on_gpu(cuda_device, gap, n):
    """B3 at 18, 24 and 30 slots against its plain version on the card,
    extend mode, the five hub queries (moves out of the hub through
    slot 15 and later)."""
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.parallel.batch import round_plan
    params, _g, _qs, dgs = _hub(gap, True, n)
    plan = round_plan(params, dgs, cuda_device)
    assert plan.name == "band_dp_topo" and plan.cfg.P == n + 1
    args = plan.stack(slice(None), cuda_device)
    before = bd.band_poa_dp_batch.fan_launches
    k = bd.band_poa_dp_batch(plan.cfg, *args)
    r = bd.band_poa_dp_batch_ref(plan.cfg, *args)
    torch.cuda.synchronize()
    assert bd.band_poa_dp_batch.fan_launches == before + 1
    _assert_same(k, r, [d.n_rows for d in dgs], (gap, n))
    assert _hub_moves(dgs[0], r, 0) == [(0, 15)]
