"""abpoa_tpu_torch: the device loop and the whole slice.

* The port's rounds (plain versions on the CPU) equal the JAX package's
  eager device_round (interpret-mode kernels) round by round: misc, the
  step stream, the graph state, the topo maps and max_remain.
* BatchPOA.run_consensus on the CPU equals the serial oracle on a mixed
  batch (capacity fallback, forced step-stream refetch, amb_strand) and
  reproduces the golden consensus of heter.fa; list mode reproduces the
  golden bytes; a qv-weighted batch runs the loop (wmode 1) and equals
  the oracle under its weights; a round past the packed step word raises
  NotImplementedError.
* The loop's busy time: on the CPU the host clock, inside the run, with
  the outputs and counters of the oracle and a one-instance run; on a
  GPU CUDA-event time, inside the run.
* On a GPU: the loop through the kernels equals the plain loop.
Exact equality everywhere.
"""
import io
import pathlib

import numpy as np
import pytest
import torch


from abpoa_tpu.params import Params
from abpoa_tpu_torch import convert

# paths spelled out here (not imported from conftest) so the gpu tests
# also run with --noconftest on a host without JAX
TESTS = pathlib.Path(__file__).resolve().parent
DATA = TESTS / "data"
GOLDEN = TESTS / "golden"
GOLDEN_SAN = TESTS / "golden_sanitized"

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _reads(fn, n=None):
    from abpoa_tpu.seqio import read_seqs
    from abpoa_tpu.alphabet import encode_table
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / fn))][:n]


def _serial_oracle(instances, params, weights=None):
    """The JAX package's serial consensus per instance (after restoring
    params.incr_fn, as its msa does, when that is set), under the
    per-read qv weights when given."""
    from abpoa_tpu.api import ABPOA
    from abpoa_tpu.consensus import generate_consensus
    from abpoa_tpu.alphabet import decode_table
    from abpoa_tpu.gfa import restore_graph
    dt = decode_table(params.m)
    out = []
    for k, reads in enumerate(instances):
        ab = ABPOA()
        if params.incr_fn:
            restore_graph(ab, params)
        n0 = ab.n_seq
        ab.n_seq = n0 + len(reads)
        ab.names = list(ab.names) + [""] * len(reads)
        ab.is_rc = list(ab.is_rc) + [0] * len(reads)
        ab.poa(params, reads, (weights[k] if weights is not None
                               else [[1] * len(q) for q in reads]), n0)
        generate_consensus(ab, params)
        out.append([bytes(dt[b] for b in s).decode()
                    for s in ab.cons.cons_base[:ab.cons.n_cons]])
    return out


def _mixed_instances():
    """Varying read counts/lengths, plus one instance whose unrelated
    reads overflow the node capacity (sticky fail -> oracle rebuild)."""
    rng = np.random.default_rng(20260820)
    seq = _reads("seq.fa", 9)
    unrelated = [rng.integers(0, 4, 150).astype(np.uint8) for _ in range(3)]
    return [seq, seq[:5], seq[2:8], [seq[0][:30], seq[1][:25]],
            unrelated, seq[:3]]


@pytest.mark.parametrize("gaps", [None], ids=["convex"])
def test_rounds_equal_jax_device_round(gaps):
    import jax
    import jax.numpy as jnp
    from abpoa_tpu.graph import POAGraph
    from abpoa_tpu.ops import poa_loop as pls
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.ops import layout as L
    from test_device_loop import _mk_cfg
    params = Params()
    if gaps is not None:
        (params.gap_open1, params.gap_ext1,
         params.gap_open2, params.gap_ext2) = gaps
    params.post_set()
    reads = _reads("seq.fa", 3)
    B = 2
    # the JAX test shapes (tests/test_device_loop.py): R=192, B=2, G=1
    jcfg = _mk_cfg(params, max(len(q) for q in reads), B, len(reads) - 1,
                   192)
    tcfg = convert.loop_config(jcfg)
    graphs = []
    for r0 in (0, 1):
        g = POAGraph()
        g.add_graph_alignment(params, reads[r0], [1] * len(reads[r0]), [],
                              None, 0, True)
        g.topological_sort(params)
        graphs.append(g)
    st0, i2n0, n2i0, rem0 = pls.init_state_np(graphs, jcfg)
    jst, ji2n, jn2i, jrem = (jax.tree.map(jnp.asarray, st0),
                             jnp.asarray(i2n0), jnp.asarray(n2i0),
                             jnp.asarray(rem0))
    base = pls.make_scal_base(params, jcfg)
    wf1000 = round(params.wf * 1000)
    tst0 = convert.loop_inputs(st0, i2n0, n2i0, rem0, "cpu")
    tps = tpl.pack_state(tcfg, *tst0)
    tbase = convert.tensor(base, "cpu")
    qc_all = np.zeros((tcfg.NR, B, tcfg.Wq), np.int8)
    ql_all = np.zeros((tcfg.NR, B), np.int32)
    from abpoa_tpu_torch.ops.band_dp import build_qpf
    for r in range(tcfg.NR):
        q = reads[r + 1 if r == 0 else 0]   # round 2 realigns read 0
        qc_all[r, :, 1:len(q) + 1] = q
        ql_all[r] = len(q)
        ql_all[r, 1] = 0 if r == 1 else len(q)   # a padding round
    for r in range(tcfg.NR):
        qc, ql = qc_all[r], ql_all[r]
        jst, ji2n, jn2i, jrem, jmisc, js16 = pls.device_round(
            jcfg, jst, ji2n, jn2i, jrem, jnp.asarray(qc), jnp.asarray(ql),
            jnp.asarray(base), jnp.int32(params.wb), jnp.int32(wf1000),
            interpret=True)
        qpf = build_qpf(tpl.band_config(tcfg), tbase[13:],
                        torch.from_numpy(qc))
        tps, tmisc, ts16w = tpl.device_round_packed(
            tcfg, tps, torch.from_numpy(ql), qpf,
            tpl.pack_qp4(tcfg, torch.from_numpy(qc)), tbase, params.wb,
            wf1000)
        jmisc, js16 = np.asarray(jmisc), np.asarray(js16)
        assert (jmisc == tmisc.numpy()).all(), r
        s16 = tpl.s16w_to_s16(ts16w).numpy()
        for b in range(B):
            n = int(jmisc[b, L.M_NSTEPS])
            assert (js16[b, :n] == s16[b, :n]).all()
        tst, ti2n, tn2i, trem = tpl.unpack_state(tcfg, tps)
        assert (np.asarray(jst.fail) == tst.fail.numpy()).all()
        assert not tst.fail.any()
        for a, t in zip(jst, tst):
            assert (np.asarray(a) == t.numpy()).all()
        for b in range(B):
            n = int(tst.node_n[b])
            for a, t in ((ji2n, ti2n), (jn2i, tn2i), (jrem, trem)):
                assert (np.asarray(a)[b, :n] == t[b, :n].numpy()).all()
    # the whole loop in one call gives the same rounds and final state
    psF, misc, s16w = tpl.poa_device_loop(
        tcfg, *tst0, torch.from_numpy(qc_all), torch.from_numpy(ql_all),
        tbase, params.wb, wf1000)
    assert torch.equal(misc[-1], tmisc)
    for a, t in zip(psF, tps):
        assert torch.equal(a, t)


def test_slice_mixed_batch_equals_oracle():
    """Mixed read counts and lengths, a capacity instance (fallback) and a
    forced step-stream cap of 2 (every instance refetches)."""
    from abpoa_tpu_torch import BatchPOA
    params = Params().post_set()
    instances = _mixed_instances()
    exp = _serial_oracle(instances, params)
    bp = BatchPOA(convert.params(params), device="cpu")
    assert bp.run_consensus(instances) == exp
    assert bp.used_device_loop
    assert bp.fallbacks >= 1
    assert bp.rounds == 8 and bp.dp_cells > 0
    bp2 = BatchPOA(convert.params(params), device="cpu")
    bp2.s16_cap = 2
    assert bp2.run_consensus(instances) == exp
    assert bp2.fallbacks == bp.fallbacks


def test_slice_amb_strand_equals_oracle():
    """-s: a reverse-complemented read trips the ambiguity threshold and
    the replay finishes that instance on the sequential fwd+rc body."""
    from abpoa_tpu_torch import BatchPOA
    params = Params()
    params.amb_strand = 1
    params.post_set()
    seq = _reads("seq.fa", 6)
    rc = np.array([3 - b if b < 4 else b for b in seq[2][::-1]],
                  dtype=np.uint8)
    instances = [[seq[0], seq[1], rc, seq[3]], seq[:4]]
    bp = BatchPOA(convert.params(params), device="cpu")
    assert bp.run_consensus(instances) == _serial_oracle(instances, params)
    assert bp.used_device_loop


def test_slice_heter_golden():
    """The bench workload's instance, twice: golden consensus bytes with
    no fallback."""
    from abpoa_tpu_torch import BatchPOA
    params = Params().post_set()
    heter = _reads("heter.fa")
    bp = BatchPOA(convert.params(params), device="cpu")
    cons = bp.run_consensus([heter, heter])
    gold = (GOLDEN_SAN / "heter_cons.fa").read_text().split("\n")[1]
    assert cons == [[gold], [gold]]
    assert bp.fallbacks == 0 and bp.used_device_loop
    assert bp.rounds == len(heter) - 1


def _timed_loop(instances, device):
    """(BatchPOA, consensus, host clock before, after) of one loop run."""
    import time
    from abpoa_tpu_torch import BatchPOA
    bp = BatchPOA(convert.params(Params().post_set()), device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    cons = bp.run_consensus(instances)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return bp, cons, t0, time.perf_counter()


def test_loop_busy_time_on_the_cpu():
    """16 instances (two sub-batches): on the CPU each device phase
    stays on the host clock, so the busy time is the union of the
    phases and lies inside the run; the outputs and the counters equal
    the serial oracle's and a one-instance run's."""
    from abpoa_tpu_torch.parallel.batch import _union_s
    reads = _reads("seq.fa", 5)
    cpu = torch.device("cpu")
    one, _, _, _ = _timed_loop([reads], cpu)
    bp, cons, t0, t1 = _timed_loop([reads] * 16, cpu)
    assert cons == _serial_oracle([reads], Params().post_set()) * 16
    assert bp.used_device_loop and bp.fallbacks == 0
    assert bp.rounds == len(reads) - 1
    assert bp.dp_cells == 16 * one.dp_cells > 0
    assert len(bp.dp_intervals) == 2
    assert all(t0 <= a <= b <= t1 for a, b in bp.dp_intervals)
    assert bp.dp_busy_seconds() == _union_s(bp.dp_intervals) > 0
    assert bp.dp_busy_seconds() <= t1 - t0


def test_list_mode_golden():
    """batch_msa_from_files: one instance per file, golden bytes each."""
    from abpoa_tpu_torch import batch_msa_from_files
    params = Params().post_set()
    out = io.StringIO()
    batch_msa_from_files(convert.params(params), [str(DATA / "seq.fa")] * 2,
                         out, device="cpu")
    assert out.getvalue() == (GOLDEN / "seq_cons.fa").read_text() * 2


SEQ_PARITY = [("seq_cons.fa", []), ("seq_msa.out", ["-r1"]),
              ("seq_cons_msa.out", ["-r2"]), ("seq.gfa", ["-r3"]),
              ("seq_cons.gfa", ["-r4"]), ("seq_cons.fq", ["-r5"]),
              ("seq_cons_lin.fa", ["-O", "0"]),
              ("seq_cons_aff.fa", ["-O", "4,0"]),
              ("seq_cons_ambs.fa", ["-s"])]
HETER_PARITY = [("heter_cons.fa", []), ("heter_d2_cons.fa", ["-d2"]),
                ("heter_d2_cons_msa.out", ["-d2", "-r2"])]


def _cli_params(args, monkeypatch):
    """The Params the JAX package's CLI builds for `args` (its run step
    intercepted), carried across by convert.params."""
    import contextlib
    import abpoa_tpu.cli as cli
    got = {}

    def grab(params, in_list, pos, out):
        got["params"] = params
    monkeypatch.setattr(cli, "_run", grab)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        cli.main(list(args) + [str(DATA / "seq.fa")])
    return convert.params(got["params"])


def _list_mode(golden, args, fn, device, monkeypatch):
    from abpoa_tpu_torch import batch_msa_from_files
    params = _cli_params(args, monkeypatch)
    out = io.StringIO()
    batch_msa_from_files(params, [str(DATA / fn)] * 2, out, device=device)
    assert out.getvalue() == (GOLDEN_SAN / golden).read_text() * 2


@pytest.mark.parametrize("golden,args", SEQ_PARITY,
                         ids=[c[0] for c in SEQ_PARITY])
def test_list_mode_parity(golden, args, monkeypatch):
    """The CLI's golden configurations that the device loop serves, through
    the port's list mode on the CPU: byte-equal output per file."""
    _list_mode(golden, args, "seq.fa", "cpu", monkeypatch)


@pytest.mark.gpu
@pytest.mark.parametrize("golden,args", SEQ_PARITY + HETER_PARITY,
                         ids=[c[0] for c in SEQ_PARITY + HETER_PARITY])
def test_list_mode_parity_on_gpu(golden, args, monkeypatch, cuda_device):
    fn = "heter.fa" if golden.startswith("heter") else "seq.fa"
    _list_mode(golden, args, fn, "cuda", monkeypatch)


@pytest.mark.gpu
def test_slice_mixed_batch_on_gpu(cuda_device):
    """The mixed batch through the kernels: capacity fail in the graph
    kernel -> oracle rebuild, and a forced cap of 2 (refetch from the
    device tensor)."""
    from abpoa_tpu_torch import BatchPOA
    params = Params().post_set()
    instances = _mixed_instances()
    exp = _serial_oracle(instances, params)
    for cap in (None, 2):
        bp = BatchPOA(convert.params(params), device="cuda")
        bp.s16_cap = cap
        assert bp.run_consensus(instances) == exp
        assert bp.used_device_loop and bp.fallbacks >= 1


@pytest.mark.parametrize("what", ["qv", "long"])
def test_out_of_scope_raises(what):
    """qv weights run the device loop in wmode 1 and give the serial
    oracle's consensus under the same weights; a batch past the former
    packed step word's 4096 rows (two 4.8 kb reads, extend mode: the
    round path, B3 over ~4800 rows) runs and gives the JAX package's
    serial consensus (it raised before the int64 step word)."""
    from abpoa_tpu_torch import BatchPOA
    params = Params().post_set()
    reads = _reads("seq.fa", 3)
    if what == "qv":
        rng = np.random.default_rng(3)
        weights = [[rng.integers(1, 60, len(q)).tolist() for q in reads]]
        bp = BatchPOA(convert.params(params), device="cpu")
        assert bp.run_consensus([reads], weights=weights) \
            == _serial_oracle([reads], params, weights)
        assert bp.used_device_loop and bp.fallbacks == 0
        return
    from abpoa_tpu.params import EXTEND_MODE
    heter = _reads("heter.fa")
    reads = [np.concatenate(heter[k:k + 7]) for k in range(2)]
    params.align_mode = EXTEND_MODE
    params.post_set()
    bp = BatchPOA(convert.params(params), device="cpu")
    assert bp.run_consensus([reads]) == _serial_oracle([reads], params)
    assert not bp.used_device_loop and bp.fallbacks == 0
    assert bp.launches == {"band_dp_topo": 1, "fw_dp": 0, "tile_dp": 0}


TURNED_AWAY = ["local", "unbanded", "incremental", "scores32"]


@pytest.mark.parametrize("what", TURNED_AWAY)
def test_round_path_serves_what_the_loop_turns_away(what):
    """Batches the device loop turns away (local mode, -b -1, a graph
    restored from seq.gfa, 32-bit score dispatch) run the round path and
    equal the JAX package's serial consensus."""
    _turned_away(what, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("what", TURNED_AWAY)
def test_round_path_serves_what_the_loop_turns_away_on_gpu(what,
                                                           cuda_device):
    _turned_away(what, cuda_device)


def _turned_away(what, device):
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.alphabet import decode_table
    from abpoa_tpu_torch.consensus import generate_consensus
    from abpoa_tpu_torch.gfa import restore_graph
    from abpoa_tpu.params import LOCAL_MODE
    params = Params()
    reads = _reads("seq.fa", 4)
    if what == "local":
        params.align_mode = LOCAL_MODE
    elif what == "unbanded":
        params.wb = -1
    elif what == "incremental":
        params.incr_fn = str(GOLDEN_SAN / "seq.gfa")
    else:
        params.match, params.mismatch = 1000, 1200
    params.post_set()
    tparams = convert.params(params)
    init = (lambda ab: restore_graph(ab, tparams)) if params.incr_fn \
        else None
    instances = [reads, reads[1:]]
    bp = BatchPOA(tparams, device=device)
    abs_ = bp.run(instances, init=init)
    assert not bp.used_device_loop and bp.fallbacks == 0
    assert bp.rounds == len(reads) - (what != "incremental")
    if what == "scores32":
        from abpoa_tpu_torch.align.engine_np import score_width_dispatch
        assert score_width_dispatch(tparams, 64, len(reads[0]))[0] == 32
    dt = decode_table(params.m)
    got = []
    for ab in abs_:
        generate_consensus(ab, tparams)
        got.append([bytes(dt[b] for b in s).decode()
                    for s in ab.cons.cons_base[:ab.cons.n_cons]])
    assert got == _serial_oracle(instances, params)


@pytest.mark.gpu
def test_loop_busy_time_is_event_timed_on_gpu(cuda_device):
    """64 x heter.fa (two sub-batches on one stream) on the card: each
    device phase is CUDA-event time placed on the host clock, inside the
    run, the second after the first; their union is busy time shorter
    than the run; golden output, one B1 and one B2 launch per round and
    sub-batch."""
    from abpoa_tpu_torch.ops.band_dp import band_poa_dp_packed
    from abpoa_tpu_torch.ops.graph_update import graph_update_packed
    heter = _reads("heter.fa")
    _timed_loop([heter] * 64, cuda_device)          # warm-up (build)
    band_poa_dp_packed.launches = graph_update_packed.launches = 0
    bp, cons, t0, t1 = _timed_loop([heter] * 64, cuda_device)
    gold = (GOLDEN_SAN / "heter_cons.fa").read_text().split("\n")[1]
    assert cons == [[gold]] * 64 and bp.fallbacks == 0
    assert band_poa_dp_packed.launches == graph_update_packed.launches \
        == 2 * (len(heter) - 1)
    (a0, b0), (a1, b1) = bp.dp_intervals
    assert t0 <= a0 < b0 <= a1 + 1e-6 and a1 < b1 <= t1
    assert 0 < bp.dp_busy_seconds() < t1 - t0


@pytest.mark.gpu
def test_loop_kernels_equal_plain_on_gpu(cuda_device):
    """poa_device_loop through the CUDA kernels equals the plain loop,
    on heter.fa instances with different read orders."""
    from abpoa_tpu_torch.graph import POAGraph
    from abpoa_tpu_torch.ops import poa_loop as tpl
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    params = convert.params(Params().post_set())
    heter = _reads("heter.fa")
    insts = [heter, heter[3:] + heter[:3], heter[::-1]]
    cfg = _loop_geometry(params, insts)._replace(B=len(insts))
    graphs = []
    for reads in insts:
        g = POAGraph()
        g.add_graph_alignment(params, reads[0], [1] * len(reads[0]), [],
                              None, 0, True)
        g.topological_sort(params)
        graphs.append(g)
    st, i2n, n2i, rem = tpl.init_state_np(graphs, cfg)
    qc = np.zeros((cfg.NR, cfg.B, cfg.Wq), np.int8)
    ql = np.zeros((cfg.NR, cfg.B), np.int32)
    for b, reads in enumerate(insts):
        for r, q in enumerate(reads[1:]):
            qc[r, b, 1:len(q) + 1] = q
            ql[r, b] = len(q)
    base = tpl.make_scal_base(params, cfg)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        args = [torch.from_numpy(x).to(dev) for x in
                (i2n, n2i, rem, qc, ql, base)]
        stt = tpl.GState(*(torch.from_numpy(x).to(dev) for x in st))
        outs.append(tpl.poa_device_loop(cfg, stt, *args[:3], args[3],
                                        args[4], args[5], params.wb,
                                        round(params.wf * 1000)))
    (kps, kmisc, ks16), (rps, rmisc, rs16) = outs
    assert torch.equal(kmisc.cpu(), rmisc)
    assert not rmisc[:, :, 4].any() and not rps.fail.any()
    for a, b in zip(kps, rps):
        assert torch.equal(a.cpu(), b) or a.dim() == 2
