"""abpoa_tpu_torch: the device loop at the JAX package's envelope.

The port's ``_loop_geometry`` admits every batch that the JAX package's
admits with an uncapped node capacity (R up to 4096), with equal
``LoopConfig`` fields: the graph kernel B2 keeps a state past one
block's shared memory in global memory (``state_in_global``), and the
band kernel B1 takes bands past 1024 lanes at four positions a thread
(``band_cpt``). A batch whose uncapped R passes 4096 takes the round
path (the JAX package caps R and sends the outgrown instances to the
host oracle; the bytes are the same).

CPU: the geometry over a grid of gap modes, bands, weights and read
lengths against the JAX package's; the residency and positions a
thread at heter64, heter64-qv and the three envelope batches of
``chip_smoke.py`` phase 4c; the plain B2 past the shared-memory bound
against the host graph; the plain B1 past 1024 lanes against the JAX
kernel in interpret mode, and against the oracle's band bounds on rows
whose maximum lies 31 segments or more into a band (where the JAX
kernel's 15-bit tie-break key overflows). GPU (``-m gpu``): the CUDA
instances against their plain versions and the three batches end to
end against the port's serial oracle.
"""
import pathlib

import numpy as np
import pytest
import torch

from abpoa_tpu.params import Params

DATA = pathlib.Path(__file__).resolve().parent / "data"

torch.set_num_threads(1)

GAPS = {"convex": None, "affine": (4, 2, 0, 0), "linear": (0, 2, 0, 0)}
FIELDS = ("R", "WB", "Wq", "LS", "NR", "pn", "inf_min", "wbits", "wmode",
          "gap_mode")
# chip_smoke.py's envelope batches: (name, reads joined a read, reads,
# first read, from heter.fa's 762-769 bp reads alone, gap setting, -f)
BATCHES = {"qv-long": (3, 8, 0, True, "convex", 0.01),
           "affine-long": (4, 6, 0, True, "affine0", 0.01),
           "wide-loop": (2, 6, 3, False, "linear0", 0.2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _reads(fn="heter.fa", n=15):
    from abpoa_tpu.seqio import read_seqs
    from abpoa_tpu.alphabet import encode_table
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / fn))][:n]


def _params(gap, wb=10, wf=0.01):
    """The JAX package's Params: a gap set of GAPS, or the CLI's -O
    forms "affine0" (gap_open2 = 0) and "linear0" (gap_open1 = 0)."""
    p = Params()
    if gap == "affine0":
        p.gap_open2 = 0
    elif gap == "linear0":
        p.gap_open1 = 0
    elif GAPS[gap] is not None:
        p.gap_open1, p.gap_ext1, p.gap_open2, p.gap_ext2 = GAPS[gap]
    p.wb, p.wf = wb, wf
    return p.post_set()


def _weights(instances, seed=77):
    rng = np.random.default_rng(seed)
    return [[rng.integers(1, 60, len(q)).tolist() for q in reads]
            for reads in instances]


def _wmax(ws):
    return max(sum(max(w) for w in wk) for wk in ws) if ws else None


def _batch(name, n_inst=16):
    """(JAX Params, instances, qv weights or None) of an envelope batch."""
    join, n, first, long_only, gap, wf = BATCHES[name]
    h = [r for r in _reads() if len(r) > 700 or not long_only]
    reads = [np.concatenate([h[(first + i + j) % len(h)]
                             for j in range(join)]) for i in range(n)]
    insts = [reads] * n_inst
    return (_params(gap, wf=wf), insts,
            _weights(insts) if name == "qv-long" else None)


def _geometries(params, insts, wmax):
    from abpoa_tpu.parallel.batch import _loop_geometry as jax_geometry
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    return (jax_geometry(params, insts, wmax),
            _loop_geometry(convert.params(params), insts, wmax))


@pytest.mark.parametrize("gap", list(GAPS))
def test_loop_geometry_admits_the_jax_envelope(gap):
    """-b 10-500, -f 0.01-0.2, unit and qv weights, the longest read
    300-4,100 bp, 4 instances of 15 reads: wherever the JAX package's
    loop admits a batch with an uncapped R, the port's admits it with
    equal fields; where R is capped (uncapped R past 4096) the port
    refuses, as it did before (the JAX geometry's B2 state does not fit
    shared memory there). The grid reaches both new instances."""
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.ops import graph_update as tgu
    admitted = capped = in_global = wide = 0
    for b in (10, 50, 100, 200, 500):
        for f in (0.01, 0.05, 0.1, 0.2):
            params = _params(gap, wb=b, wf=f)
            for qv in (False, True):
                for L in range(300, 4200, 100):
                    insts = [[np.zeros(L, np.uint8)]
                             + [np.zeros(L - 5, np.uint8)] * 14] * 4
                    j, t = _geometries(params, insts,
                                       60 * 15 if qv else None)
                    if j is None:
                        continue
                    if (L + max(96, L // 4) + 63) // 64 * 64 > 4096:
                        capped += 1
                        assert t is None, (b, f, qv, L)
                        assert tgu.smem_bytes(convert.loop_config(j)) \
                            > tgu.MAX_SMEM_BYTES
                        continue
                    assert t is not None, (b, f, qv, L)
                    for name in FIELDS:
                        assert getattr(t, name) == getattr(j, name), \
                            (name, b, f, qv, L)
                    admitted += 1
                    in_global += tgu.state_in_global(t)
                    wide += t.WB > 1024
    assert admitted > 400 and in_global and wide, \
        (capped, admitted, in_global, wide)


@pytest.mark.parametrize("name,gmem,cpt", [
    ("heter64", False, 2), ("heter64-qv", False, 2),
    ("qv-long", True, 2), ("affine-long", True, 2), ("wide-loop", False, 4)])
def test_residency_and_positions_a_thread(name, gmem, cpt):
    """heter64 and heter64-qv keep B2 in shared memory and B1 at two
    positions a thread; qv-long and affine-long put B2's state in global
    memory and wide-loop runs B1 at four. The JAX package admits all
    five with the same fields; the three envelope batches were outside
    the port's loop before (shared memory or band lanes)."""
    from abpoa_tpu_torch.ops import band_dp as tbd
    from abpoa_tpu_torch.ops import graph_update as tgu
    if name.startswith("heter64"):
        insts = [_reads()] * 64
        params = _params("convex")
        ws = _weights(insts) if name == "heter64-qv" else None
    else:
        params, insts, ws = _batch(name)
    j, t = _geometries(params, insts, _wmax(ws))
    assert j is not None and t is not None
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert tgu.state_in_global(t) == gmem
    assert tbd.band_cpt(t.WB) == cpt
    before = tgu.smem_bytes(t) > tgu.MAX_SMEM_BYTES or t.WB > 1024
    assert before == (name in BATCHES)
    want = {"heter64": (1024, 384, 0), "heter64-qv": (1024, 384, 1),
            "qv-long": (2944, 512, 1), "affine-long": (3840, 512, 0),
            "wide-loop": (1984, 1536, 0)}[name]
    assert (t.R, t.WB, t.wmode) == want


def test_graph_update_ref_past_the_smem_bound_vs_host_graph():
    """The plain graph update in wmode 1 at R = 2432 (the first R past
    the shared-memory bound at Wq = 1152), round by round on weighted
    heter.fa reads: the fusion lists and weights, the Kahn order and
    max_remain equal the host graph's."""
    from abpoa_tpu.graph import POAGraph
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import graph_update as tgu
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    from test_torch_graph_update import _port_state
    from test_torch_qv import _round_inputs
    params = Params().post_set()
    reads = _reads(n=4)
    (ws,) = _weights([reads])
    cfg = _loop_geometry(convert.params(params), [reads],
                         wmax=60 * len(reads))
    R = 2432
    cfg = cfg._replace(B=1, R=R, LS=(R + cfg.Wq + 63) // 64 * 64)
    assert cfg.wmode == 1 and cfg.Wq == 1152 and tgu.state_in_global(cfg)
    assert not tgu.state_in_global(cfg._replace(
        R=R - 64, LS=(R - 64 + cfg.Wq + 63) // 64 * 64))
    g = POAGraph()
    g.add_graph_alignment(params, reads[0], ws[0], [], None, 0, True)
    g.topological_sort(params)
    ps = _port_state([g], cfg)
    for r, q in enumerate(reads[1:], start=1):
        if not g.is_topological_sorted:
            g.topological_sort(params)
        res, s16w, misc2, qc, qw = _round_inputs([g], params, q, ws[r],
                                                 cfg.LS, cfg.Wq)
        ps = tgu.graph_update_packed(
            cfg, ps, s16w, misc2, torch.tensor([len(q)], dtype=torch.int32),
            tpl.pack_qp4(cfg, torch.from_numpy(qc)),
            qw=tpl.pack_qw(cfg, torch.from_numpy(qw)))
        assert ps.fail.tolist() == [0]
        g.add_graph_alignment(params, q, ws[r], res[0].cigar, None, r, True)
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
    assert int(st2.out_w.max()) > 60     # edges summed several weights


def _wide_inputs(gap, wb, R, device="cpu", WB=None):
    """One round of two instances of joined heter.fa reads (2 a read;
    graphs of reads 0-1 and 1-2, query read 4) with -b wb: the port's
    loop inputs (cfg, packed state, scal, query folds). WB: force the
    band tile (the query width is padded to a multiple of it)."""
    from abpoa_tpu_torch import convert
    from test_torch_band_dp import _graph, _inputs
    params = convert.params(_params(gap, wb=wb))
    h = _reads()
    j2 = [np.concatenate([h[i], h[i + 1]]) for i in range(6)]
    graphs = [_graph(params, j2[0:2]), _graph(params, j2[1:3])]
    q = j2[4]
    if WB is None:
        return _inputs(params, graphs, q, R, device)
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import band_dp as tbd
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    cfg = _loop_geometry(params, [[q, q]])
    Wq = (cfg.Wq + WB - 1) // WB * WB
    cfg = cfg._replace(B=2, R=R, WB=WB, Wq=Wq, LS=(R + Wq + 63) // 64 * 64)
    st, i2n, n2i, remain = tpl.init_state_np(graphs, cfg)
    ps = tpl.pack_state(cfg, tpl.GState(*(torch.from_numpy(x).to(device)
                                          for x in st)),
                        *(torch.from_numpy(x).to(device)
                          for x in (i2n, n2i, remain)))
    base = torch.from_numpy(tpl.make_scal_base(params, cfg)).to(device)
    qlen = torch.full((2,), len(q), dtype=torch.int32, device=device)
    scal = tpl.build_scal(cfg, ps, qlen, base, params.wb,
                          round(params.wf * 1000))
    qc = np.zeros((2, cfg.Wq), np.int8)
    qc[:, 1:len(q) + 1] = q
    qpf = tbd.build_qpf(tpl.band_config(cfg), base[13:],
                        torch.from_numpy(qc).to(device))
    return cfg, ps, scal, qpf


def test_band_ref_past_1024_lanes_equals_jax_interpret():
    """Linear gaps, -b 300, reads of 1,212-1,375 bp (heter.fa reads
    joined two a read): WB = 1536, past the band kernel's former 1024
    lanes. The plain version equals the JAX band kernel in interpret mode
    on misc and the step stream."""
    import jax.numpy as jnp
    from abpoa_tpu.ops import poa_loop as pls
    from abpoa_tpu.ops.dp_pallas_band import band_poa_dp_packed
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import band_dp as tbd
    from abpoa_tpu_torch.ops import layout as L
    cfg, ps, scal, qpf = _wide_inputs("linear", 300, 1664)
    assert cfg.WB == 1536 and tbd.band_cpt(cfg.WB) == 4
    jcfg = pls.LoopConfig(**cfg._asdict(), G=1, GT=2, use_zdrop=False)
    jm, js = band_poa_dp_packed(
        pls._band_cfg(jcfg, nid=True), jnp.asarray(scal.numpy()),
        jnp.asarray(ps.ctrl.numpy()), jnp.asarray(ps.inp.numpy()),
        jnp.asarray(ps.i2nn.numpy()), jnp.asarray(qpf.numpy()),
        interpret=True)
    tm, ts = tbd.band_poa_dp_packed(tpl.band_config(cfg), scal, ps.ctrl,
                                    ps.inp, ps.i2nn, qpf)
    jm, js = np.asarray(jm), np.asarray(js)
    assert (jm == tm.numpy()).all()
    assert (jm[:, L.M_NSTEPS] > 1000).all() and not jm[:, L.M_FAIL].any()
    assert not jm[:, L.M_OVFL].any()
    for b in range(2):
        n = int(jm[b, L.M_NSTEPS])
        assert (js[b].view(np.int16)[:n]
                == ts[b].numpy().view(np.int16)[:n]).all()


def test_band_ref_row_max_past_segment_31_equals_oracle():
    """A graph of two reads A+S+C (a 700 bp S) and a query A+C under
    linear gaps and -b 300: the rows of A place the band ~1,000 columns
    left of the row maximum, so the maximum lies 31 or more segments into
    a band of up to 42 (WB = 1536). The plain version's band bounds equal
    the oracle's on every row, and its best score and cigar too. The JAX
    kernel's tie-break key, the lane above 15 bits of segment order,
    overflows there (abpoa_tpu/ops/dp_pallas_band.py:743-751): with it,
    8 rows of this input end one segment off."""
    from abpoa_tpu_torch.align import engine_np
    from abpoa_tpu_torch.align.engine_np import (AlignResult,
                                                 align_sequence_to_subgraph)
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import band_dp as tbd
    from abpoa_tpu_torch.ops import layout as L
    from abpoa_tpu_torch.ops.steps import replay_steps, unpack_steps16
    from abpoa_tpu_torch.params import SRC_NODE_ID, SINK_NODE_ID
    from test_torch_band_dp import _graph, _inputs
    rng = np.random.default_rng(3)
    params = convert.params(_params("linear", wb=300))
    A, S, C = (rng.integers(0, 4, n).astype(np.uint8)
               for n in (900, 700, 600))

    def mut(x):
        y = x.copy()
        m = rng.random(len(y)) < 0.03
        y[m] = rng.integers(0, 4, int(m.sum()))
        return y
    r0 = np.concatenate([A, S, C])
    r1 = mut(r0)
    q = mut(np.concatenate([A, C]))
    g = _graph(params, [r0, r1])
    cfg, ps, scal, qpf = _inputs(params, [g], q, 2816)
    assert cfg.WB == 1536
    base = engine_np._Ctx
    rec = {}

    class Recording(base):
        def run(self):
            super().run()
            rec["beg"] = np.array(self.dp_beg_sn[:self.n_rows])
            rec["end"] = np.array(self.dp_end_sn[:self.n_rows])
    engine_np._Ctx = Recording
    try:
        res = align_sequence_to_subgraph(g, params, SRC_NODE_ID,
                                         SINK_NODE_ID, q)
    finally:
        engine_np._Ctx = base
    bsn, _mplr, misc, s16w = tbd._band_ref(tpl.band_config(cfg), scal,
                                           ps.ctrl, ps.inp, qpf,
                                           i2nn=ps.i2nn)
    rows = np.arange(1, g.node_n - 1)
    nid = np.asarray(g.index_to_node_id)[rows]
    bsn = bsn[0].numpy()[nid]
    assert ((rec["end"][rows] - rec["beg"][rows] + 1) > 32).sum() > 500
    assert ((bsn & 0xFFFF) == rec["beg"][rows]).all()
    assert ((bsn >> 16) == rec["end"][rows]).all()
    mi = misc[0].numpy()
    assert mi[L.M_BEST] == res.best_score and not mi[L.M_OVFL]
    nst = int(mi[L.M_NSTEPS])
    words = unpack_steps16(tpl.s16w_to_s16(s16w)[0].numpy(), nst,
                           int(mi[L.M_BI]), int(mi[L.M_BJ]))
    r2 = AlignResult()
    replay_steps(g, params, q, words, nst, int(mi[L.M_BI]), int(mi[L.M_BJ]),
                 int(mi[L.M_ENDI]), int(mi[L.M_ENDJ]), r2)
    assert r2.cigar == res.cigar


# ------------------------------------------------------------------ #
# on the card

@pytest.mark.gpu
@pytest.mark.parametrize("wmode,R", [(0, 4096), (1, 2432), (1, 3136)])
def test_graph_kernel_in_global_memory_on_gpu(cuda_device, wmode, R):
    """B2 with its state in global memory against its plain version,
    every round of 8 instances (a failed and a padding one among them),
    and B6 on the graphs it leaves; each launch the global instance."""
    from abpoa_tpu_torch.ops import graph_update as tgu
    from test_torch_graph_update import _batch_rounds
    attr = "qv_global_launches" if wmode else "global_launches"
    before = getattr(tgu.graph_update_packed, attr)
    _batch_rounds(cuda_device, wmode, 8, R, gmem=True)
    assert getattr(tgu.graph_update_packed, attr) == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("gap", list(GAPS))
@pytest.mark.parametrize("WB", [1152, 1536, 2048])
def test_band_kernel_wide_on_gpu(cuda_device, gap, WB):
    """B1 at four positions a thread (WB past 1024 lanes) against its
    plain version on the card: misc and the step stream, both
    instances."""
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import band_dp as tbd
    from abpoa_tpu_torch.ops import layout as L
    cfg, ps, scal, qpf = _wide_inputs(gap, 300, 1664, cuda_device, WB=WB)
    args = (tpl.band_config(cfg), scal, ps.ctrl, ps.inp, ps.i2nn, qpf)
    before = tbd.band_poa_dp_packed.wide_launches
    km, ks = tbd.band_poa_dp_packed(*args)
    rm, rs = tbd.band_poa_dp_packed_ref(*args)
    torch.cuda.synchronize()
    assert tbd.band_poa_dp_packed.wide_launches == before + 1
    assert torch.equal(km, rm)
    assert (rm[:, L.M_NSTEPS] > 1000).all() and not rm[:, L.M_FAIL].any()
    k16, r16 = tpl.s16w_to_s16(ks), tpl.s16w_to_s16(rs)
    for b in range(2):
        n = int(rm[b, L.M_NSTEPS])
        assert torch.equal(k16[b, :n], r16[b, :n])


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(BATCHES))
def test_envelope_batch_on_gpu(cuda_device, name):
    """chip_smoke.py's envelope batch on the device loop: the port's
    serial oracle's consensus for every instance, no fallback, and the
    batch's kernel instance on every round and sub-batch."""
    from abpoa_tpu_torch import BatchPOA, convert
    from abpoa_tpu_torch.api import ABPOA
    from abpoa_tpu_torch.alphabet import decode_table
    from abpoa_tpu_torch.consensus import generate_consensus
    from abpoa_tpu_torch.ops import band_dp as tbd
    from abpoa_tpu_torch.ops import graph_update as tgu
    params, insts, ws = _batch(name)
    params = convert.params(params)
    host = convert.params(params)
    host.engine = "numpy"

    def oracle(reads, w):
        ab = ABPOA()
        ab.n_seq, ab.names, ab.is_rc = len(reads), [""] * len(reads), \
            [0] * len(reads)
        ab.poa(host, reads, w, 0)
        generate_consensus(ab, host)
        dt = decode_table(host.m)
        return [bytes(dt[b] for b in s).decode()
                for s in ab.cons.cons_base[:ab.cons.n_cons]]
    counter = {"qv-long": (tgu.graph_update_packed, "qv_global_launches"),
               "affine-long": (tgu.graph_update_packed, "global_launches"),
               "wide-loop": (tbd.band_poa_dp_packed, "wide_launches")}
    fn, attr = counter[name]
    before = getattr(fn, attr)
    bp = BatchPOA(params, device="cuda")
    got = bp.run_consensus(insts, weights=ws)
    if ws is None:      # unit weights: one oracle run serves every copy
        exp = [oracle(insts[0], [[1] * len(q) for q in insts[0]])] \
            * len(insts)
    else:
        exp = [oracle(r, w) for r, w in zip(insts, ws)]
    assert got == exp
    assert bp.used_device_loop and bp.fallbacks == 0
    # two sub-batches of 8, one launch a round each
    assert getattr(fn, attr) - before == 2 * (len(insts[0]) - 1)
