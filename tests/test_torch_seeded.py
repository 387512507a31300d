"""abpoa_tpu_torch: the seeded -S/-p path.

* seed.build_guide_tree_partition of the port (native C, and its Python
  fallbacks) equals the JAX package's on heter.fa and seq.fa, with and
  without the progressive guide tree.
* BatchPOA.run_seeded on the CPU (the window rounds through the plain
  non-fresh band DP and full-width DP) equals the JAX package's
  run_seeded on config-5-shaped instances (heter.fa reads, instance k
  trimmed by (k % 5) * 120) cut to a few reads.
* The CLI's serial engine runs every non-empty window through the
  full-width DP under the window's row mask: -S, -S -p and -S -n 100 on
  a cut of heter.fa equal the port's serial oracle (--engine numpy),
  with one full-width launch per non-empty window; a window past the
  packed step word raises naming the XLA tier (A6).
* On a GPU: the three -S goldens on heter.fa through the serial engine
  on the card, and run_seeded on the card against the oracle.
Exact equality everywhere.
"""
import contextlib
import io
import pathlib

import numpy as np
import pytest
import torch

TESTS = pathlib.Path(__file__).resolve().parent
DATA = TESTS / "data"
GOLDEN_SAN = TESTS / "golden_sanitized"
HETER = str(DATA / "heter.fa")

torch.set_num_threads(1)

# the -S goldens of tests/test_parity.py (sanitized reference build)
SEEDED = [("heter_S_cons.fa", ["-S"]), ("heter_Sp_cons.fa", ["-S", "-p"]),
          ("heter_S_n100_cons.fa", ["-S", "-n", "100"])]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _reads(fn, m=5):
    from abpoa_tpu_torch.seqio import read_seqs
    from abpoa_tpu_torch.alphabet import encode_table
    tab = encode_table(m)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / fn))]


def _config5(reads, n):
    """bench.py's config-5 shape: instance k's reads trimmed at the end
    by (k % 5) * 120 bases (at least 64 kept)."""
    return [[q[:max(64, len(q) - (k % 5) * 120)] for q in reads]
            for k in range(n)]


def _cli(args, monkeypatch, device="cpu"):
    """The port's CLI main on `args`: (stdout, the serial engine's calls
    by kind, kernel launches by name, empty windows)."""
    from abpoa_tpu_torch.cli import main
    from abpoa_tpu_torch.align import engine_torch
    from abpoa_tpu_torch.ops.fw_dp import fw_poa_dp_batch
    from abpoa_tpu_torch.ops.tile_dp import tile_poa_dp_batch
    calls = {"window": 0, "graph": 0}
    for kind, name in (("window", "align_sequence_to_subgraph_device"),
                       ("graph", "align_sequence_to_graph_device")):
        def counted(*a, _f=getattr(engine_torch, name), _k=kind, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(engine_torch, name, counted)
    monkeypatch.setattr(engine_torch, "empty_windows", 0)
    engine_torch.reroutes.update(M_OVFL=0, M_FAIL=0)
    fw0, tile0 = fw_poa_dp_batch.launches, tile_poa_dp_batch.launches
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--device", device, *args])
    assert rc == 0, err.getvalue()
    launches = {"fw_dp": fw_poa_dp_batch.launches - fw0,
                "tile_dp": tile_poa_dp_batch.launches - tile0}
    return out.getvalue(), calls, launches, engine_torch.empty_windows


def _windows(args, fn):
    """The oracle's -S run on fn: its align calls by kind (non-empty
    subgraph windows, empty ones, whole-graph calls of reads without
    anchors)."""
    from abpoa_tpu_torch import align
    from abpoa_tpu_torch.params import SRC_NODE_ID, SINK_NODE_ID
    import abpoa_tpu_torch.api as api
    calls = {"window": 0, "empty": 0, "graph": 0}
    orig = align.align_sequence_to_subgraph

    def count(graph, params, beg, end, query, arena=None):
        if graph.node_n > 2:
            calls["graph" if (beg, end) == (SRC_NODE_ID, SINK_NODE_ID)
                  else "window" if len(query) else "empty"] += 1
        return orig(graph, params, beg, end, query, arena)
    api.aln.align_sequence_to_subgraph = count
    try:
        api.ABPOA().msa_from_file(_params(args, "numpy"), fn, io.StringIO())
    finally:
        api.aln.align_sequence_to_subgraph = orig
    return calls


def _params(args, engine):
    """The port's Params for CLI flags `args` (parsed by the port's CLI,
    its run step intercepted), with `engine`."""
    import dataclasses
    from abpoa_tpu_torch import cli
    got = {}
    orig = cli._run
    cli._run = lambda params, *a: got.setdefault("p", params)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(list(args) + [HETER])
    finally:
        cli._run = orig
    return dataclasses.replace(got["p"], engine=engine)


@pytest.mark.parametrize("fn,args", [("heter.fa", ["-S"]),
                                     ("heter.fa", ["-S", "-p"]),
                                     ("seq.fa", ["-S", "-p"])])
def test_partition_equals_jax(fn, args):
    """Anchors, chain offsets and the guide-tree read order of the port's
    seeding equal the JAX package's; the Python fallbacks too."""
    import os
    from abpoa_tpu import seed as jseed
    from abpoa_tpu_torch import convert, seed as tseed
    jp = _jax_params(args)
    tp = convert.params(jp)
    reads = _reads(fn)
    lens = [len(q) for q in reads]
    exp = jseed.build_guide_tree_partition(reads, lens, jp)
    assert tseed.build_guide_tree_partition(reads, lens, tp) == exp
    os.environ["ABPOA_NO_NATIVE"] = "1"
    try:
        assert tseed.build_guide_tree_partition(reads, lens, tp) == exp
    finally:
        del os.environ["ABPOA_NO_NATIVE"]


def _jax_params(args):
    from abpoa_tpu.params import Params
    p = Params()
    p.disable_seeding = "-S" not in args
    p.progressive_poa = "-p" in args
    return p.post_set()


def test_run_seeded_equals_jax():
    """Config-5-shaped instances (five trim classes) of four heter.fa
    reads: the port's window rounds (plain kernels) equal the JAX
    package's run_seeded, with no fallback and every window on the
    device."""
    from abpoa_tpu.parallel import BatchPOA as JBatch
    from abpoa_tpu_torch import BatchPOA, convert
    jp = _jax_params(["-S"])
    insts = _config5(_reads("heter.fa")[:4], 5)
    exp = JBatch(jp).run_consensus(insts, seeded=True)
    bp = BatchPOA(convert.params(jp), device="cpu")
    assert bp.run_consensus(insts, seeded=True) == exp
    assert bp.fallbacks == 0 and bp.windows > 0
    assert bp.launches["tile_dp"] == 0
    assert bp.launches["band_dp_topo"] + bp.launches["fw_dp"] >= bp.rounds - 1


@pytest.mark.parametrize("golden,args", SEEDED, ids=[g for g, _ in SEEDED])
def test_serial_seeded_on_a_cut_equals_oracle(golden, args, tmp_path,
                                              monkeypatch):
    """The first four heter.fa reads: the serial engine on the CPU gives
    the oracle's bytes, with every non-empty window through the window
    engine (its full-width DP) and the oracle only for the empty ones."""
    from abpoa_tpu_torch.api import ABPOA
    from abpoa_tpu_torch.seqio import read_seqs
    recs = read_seqs(HETER)[:4]
    cut = tmp_path / "heter4.fa"
    cut.write_text("".join(f">{r.name}\n{r.seq}\n" for r in recs))
    out, calls, _launches, empty = _cli(args + [str(cut)], monkeypatch)
    exp = io.StringIO()
    ABPOA().msa_from_file(_params(args, "numpy"), str(cut), exp)
    assert out == exp.getvalue()
    want = _windows(args, str(cut))
    assert calls == {"window": want["window"], "graph": want["graph"]}
    assert empty == want["empty"] and want["window"] > 0


def test_window_past_the_step_word_raises():
    """A window past the former packed step word's 4096 rows (the whole
    graph of one 4.8 kb read, a second such read as the window's query)
    runs the window path (B4 under the row mask, plain on the CPU) and
    gives the JAX package oracle's alignment; it raised before the int64
    step word."""
    from abpoa_tpu.align.engine_np import align_sequence_to_subgraph
    from abpoa_tpu.graph import POAGraph as JGraph
    from abpoa_tpu.params import Params as JParams
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.align.engine_torch import \
        align_sequence_to_subgraph_device
    from abpoa_tpu_torch.graph import POAGraph
    from abpoa_tpu_torch.params import SRC_NODE_ID, SINK_NODE_ID
    jp = JParams().post_set()
    p = convert.params(jp)
    heter = _reads("heter.fa")
    q0, q1 = (np.concatenate(heter[k:k + 7]) for k in range(2))
    g, gj = POAGraph(), JGraph()
    g.add_graph_alignment(p, q0, [1] * len(q0), [], None, 0, True)
    gj.add_graph_alignment(jp, q0, [1] * len(q0), [], None, 0, True)
    g.topological_sort(p)
    gj.topological_sort(jp)
    assert g.node_n > 4096
    r = align_sequence_to_subgraph_device(g, p, SRC_NODE_ID, SINK_NODE_ID,
                                          q1, "cpu")
    rj = align_sequence_to_subgraph(gj, jp, SRC_NODE_ID, SINK_NODE_ID, q1)
    assert r.best_score == rj.best_score
    assert list(map(tuple, r.cigar)) == list(map(tuple, rj.cigar))
    n = g.node_n
    assert (np.array(g.node_id_to_max_pos_left[:n])
            == np.array(gj.node_id_to_max_pos_left[:n])).all()


@pytest.mark.gpu
@pytest.mark.parametrize("golden,args", SEEDED, ids=[g for g, _ in SEEDED])
def test_seeded_cli_golden_on_gpu(golden, args, cuda_device, monkeypatch):
    """The -S goldens on heter.fa through the serial engine on the card:
    one B4 launch per non-empty window (plus one per B5 result re-run
    there), one B5 launch per whole-graph call, the oracle only for the
    empty windows."""
    from abpoa_tpu_torch.align import engine_torch
    out, calls, launches, empty = _cli(args + [HETER], monkeypatch, "cuda")
    assert out == (GOLDEN_SAN / golden).read_text()
    want = _windows(args, HETER)
    assert calls == {"window": want["window"], "graph": want["graph"]}
    assert empty == want["empty"]
    assert launches == {
        "fw_dp": want["window"] + sum(engine_torch.reroutes.values()),
        "tile_dp": want["graph"]}


@pytest.mark.gpu
def test_run_seeded_on_gpu(cuda_device):
    """Config-5-shaped instances of heter.fa through the window rounds on
    the card equal the serial oracle of their trim class. Every window
    round is a B3 launch staged in one upload, and a launch runs at most
    two kernels (the prologue and B3) by the profiler's count."""
    import dataclasses
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.api import ABPOA
    from abpoa_tpu_torch.consensus import generate_consensus
    from abpoa_tpu_torch.alphabet import decode_table
    from abpoa_tpu_torch.ops.band_dp import band_poa_dp_batch as b3
    p = _params(["-S"], "numpy")
    insts = _config5(_reads("heter.fa"), 10)
    dt = decode_table(5)
    exp = []
    for inst in insts[:5]:
        ab = ABPOA()
        ab.msa(p, [bytes(dt[b] for b in q).decode() for q in inst])
        generate_consensus(ab, p)
        exp.append([bytes(dt[b] for b in s).decode()
                    for s in ab.cons.cons_base[:ab.cons.n_cons]])
    bp = BatchPOA(dataclasses.replace(p, engine="torch"), device="cuda")
    n0, u0 = b3.launches, b3.uploads
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = bp.run_consensus(insts, seeded=True)
        torch.cuda.synchronize()
    assert got == exp * 2
    assert bp.fallbacks == 0 and bp.launches["tile_dp"] == 0
    launches = b3.launches - n0
    assert launches == bp.launches["band_dp_topo"] > 0
    assert bp.launches["fw_dp"] == 0
    assert b3.uploads - u0 == launches
    kernels = [e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()
               and not e.name().startswith(("Memcpy", "Memset"))]
    assert 0 < len(kernels) <= 2 * launches, kernels[:8]
