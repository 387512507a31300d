"""abpoa_tpu_torch: round_plan's dispatch pinned at the shapes of the
port's cells, and the plane sizes it budgets with pinned to what the
kernels' wrappers allocate (CPU).

round_plan picks B3 (the topo band kernel) when the band fits a block
(``band_smem_bytes``), else B4 (full width) within the plane budget
(``fw_plane_bytes``), and sizes each launch's chunk of instances by the
planes of one instance. A change of a kernel's layout (its shared memory,
its planes) must not move a round from one kernel to another or change
its chunk unnoticed: the expected values are the dispatch of the kernels
before their redesign, on every round of heter.fa in local mode
(``heter64-local``) and extend mode (``heter64-extend``) and on every
window round of the config-5 instances (``seeded-c5``, one instance per
trim class; its round shapes are those of any number of instances), at
the CPU's plane budget; and local mode with affine and linear gaps,
whose full-width planes the redesign changed (linear: one more). Past
4096 rows (synthetic exports, tests/test_torch_dp_edges.py synth_dense)
the same rule holds with no raise: B3 while the band fits a block (past
8192 rows too), B4 past that, B5 when B4's planes exceed the budget, and
the plan "oracle" (no kernel, chunk 0, the bytes of one instance in
``per``) when one instance's tiles exceed it too, or a window's planes
(the seeded rounds have no third branch). The budget itself
(``device.plane_budget``) is a share of the card's free memory over the
launches that share it, and a fixed allowance on the CPU.
"""
import pathlib

import numpy as np
import pytest
import torch

DATA = pathlib.Path(__file__).resolve().parent / "data"


# (round, kernel, chunk) of every round before the redesign of B3/B4;
# chunk = the CPU plane budget (4 GiB) over one instance's planes
LOCAL = [(k, "fw_dp", c) for k, c in enumerate(
    (374, 403, 403, 403, 288, 288, 336, 288, 288, 403, 336, 336, 403, 403),
    start=1)]
EXTEND = [(1, "band_dp_topo", 1092)] + [(k, "band_dp_topo", 840)
                                        for k in range(2, 15)]
# the same rounds with affine and linear gaps (-O 4 -E 2, -O 0 -E 2):
# affine as before the redesign (H, E1 and the 32-bit backtrack words,
# where F1 was); linear at half its chunk before (H beside the words)
LOCAL_GAPS = {
    "affine": ((4, 2, 0, 0), [(k, "fw_dp", c) for k, c in enumerate(
        (624, 624, 624, 624, 445, 445, 520, 445, 445, 624, 520, 520, 624,
         624), start=1)]),
    "linear": ((0, 2, 0, 0), [(k, "fw_dp", c) for k, c in enumerate(
        (936, 936, 936, 936, 668, 668, 780, 668, 668, 936, 780, 780, 936,
         936), start=1)]),
}
SEEDED = [(r, "band_dp_topo", c) for r, c in enumerate(
    (1365, 992, 992, 910, 992, 910, 1213, 910, 1213, 910, 1213, 1213, 1213,
     992, 992, 1213, 1213, 992, 992, 910, 8192, 910, 2730, 1213, 8192, 910,
     8192, 910), start=1)]


def _heter():
    import pathlib
    from abpoa_tpu_torch.seqio import read_seqs
    from abpoa_tpu_torch.alphabet import encode_table
    tab = encode_table(5)
    fn = pathlib.Path(__file__).resolve().parent / "data" / "heter.fa"
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(fn))]


def _mode_params(mode):
    from abpoa_tpu_torch.params import Params
    p = Params()
    p.align_mode = mode
    return p.post_set()


def round_plans(params, reads):
    """(round, kernel, chunk) of every round of one instance (the rounds
    of N identical instances dispatch alike): read k against the
    oracle-fused graph of reads < k."""
    from abpoa_tpu_torch.align.engine_np import align_sequence_to_subgraph
    from abpoa_tpu_torch.align.export import export_dense
    from abpoa_tpu_torch.graph import NativeGraph, POAGraph
    from abpoa_tpu_torch.params import SRC_NODE_ID, SINK_NODE_ID
    from abpoa_tpu_torch.parallel.batch import round_plan
    g = NativeGraph() if NativeGraph.available() else POAGraph()
    if NativeGraph.available():
        g.ensure_reads(len(reads))
    out = []
    for k, q in enumerate(reads):
        cig = []
        if g.node_n > 2:
            if not g.is_topological_sorted:
                g.topological_sort(params)
            plan = round_plan(params, [export_dense(g, params, q)],
                              torch.device("cpu"))
            out.append((k, plan.name, plan.chunk))
            cig = align_sequence_to_subgraph(g, params, SRC_NODE_ID,
                                             SINK_NODE_ID, q).cigar
        g.add_graph_alignment(params, q, [1] * len(q), cig, None, k, True)
    return out


def window_rounds(params, instances, monkeypatch):
    """The window exports of run_seeded's rounds over `instances`: the
    serial seeded path (host oracle) issues each instance's requests in
    the order of its request generator, which run_seeded drives in
    lockstep; round r holds request r of every instance that has one
    (None: no DP)."""
    import dataclasses
    from abpoa_tpu_torch import align as aln
    from abpoa_tpu_torch.api import ABPOA
    from abpoa_tpu_torch.align.export import export_dense
    from abpoa_tpu_torch.alphabet import decode_table
    host = dataclasses.replace(params, engine="numpy")
    dt = decode_table(5)
    per = []
    orig = aln.align_sequence_to_subgraph

    def record(graph, params_, beg_id, end_id, window, arena=None):
        dg = None
        if graph.node_n > 2 and len(window) > 0:
            if not graph.is_topological_sorted:
                graph.topological_sort(params_)
            dg = export_dense(graph, params_, window,
                              beg_index=int(graph.node_id_to_index[beg_id]),
                              end_index=int(graph.node_id_to_index[end_id]))
        per[-1].append(dg)
        return orig(graph, params_, beg_id, end_id, window, arena=arena)
    monkeypatch.setattr(aln, "align_sequence_to_subgraph", record)
    for inst in instances:
        per.append([])
        ABPOA().msa(host, [bytes(dt[b] for b in q).decode() for q in inst])
    n = max(len(p) for p in per)
    return [[p[r] for p in per if r < len(p) and p[r] is not None]
            for r in range(n)]


def seeded_plans(monkeypatch):
    """(round, kernel, chunk) of every window round of the five config-5
    trim classes, re-padded as run_seeded re-pads them."""
    from abpoa_tpu_torch.align.export import repad_dense
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.parallel.batch import round_plan
    p = Params()
    p.disable_seeding = False
    p.post_set()
    heter = _heter()
    insts = [[q[:max(64, len(q) - k * 120)] for q in heter] for k in range(5)]
    out = []
    for r, dgs in enumerate(window_rounds(p, insts, monkeypatch)):
        if not dgs:
            continue
        R = max(d.R for d in dgs)
        W = max(d.W for d in dgs)
        P = max(d.P for d in dgs)
        O = max(d.O for d in dgs)
        plan = round_plan(p, [repad_dense(d, R, W, P, O) for d in dgs],
                          torch.device("cpu"), seeded=True)
        out.append((r, plan.name, plan.chunk))
    return out


def test_round_plan_heter_local_pinned():
    from abpoa_tpu_torch.params import LOCAL_MODE
    assert round_plans(_mode_params(LOCAL_MODE), _heter()) == LOCAL


@pytest.mark.parametrize("gaps", list(LOCAL_GAPS))
def test_round_plan_heter_local_gaps_pinned(gaps):
    from abpoa_tpu_torch.params import Params, LOCAL_MODE
    p = Params()
    p.align_mode = LOCAL_MODE
    (p.gap_open1, p.gap_ext1, p.gap_open2, p.gap_ext2), want = \
        LOCAL_GAPS[gaps]
    p.post_set()
    assert round_plans(p, _heter()) == want


def test_round_plan_heter_extend_pinned():
    from abpoa_tpu_torch.params import EXTEND_MODE
    assert round_plans(_mode_params(EXTEND_MODE), _heter()) == EXTEND


def test_round_plan_seeded_windows_pinned(monkeypatch):
    assert seeded_plans(monkeypatch) == SEEDED


def _synth_plan(n, budget, monkeypatch, seeded=False, wb=None, **kw):
    from test_torch_dp_edges import _params, synth_dense
    from abpoa_tpu_torch import device
    from abpoa_tpu_torch.parallel import batch
    monkeypatch.setattr(device, "CPU_PLANE_BUDGET", budget)
    dg = synth_dense(_params(wb=wb), n, seed=7, **kw)
    return batch.round_plan(_params(wb=wb), [dg], torch.device("cpu"),
                            seeded)


# (rows, kwargs, budget) -> kernel; a band of 1024 lanes or fewer (the
# default -b 10) fits a block up to about 11,600 rows at 4 predecessor
# slots, -b 300 (1664 lanes) at four positions a thread; -b 400 (2176
# lanes) makes it wider than a block
PAST_4096 = {
    "band": ((5000, {}, 4 << 30), "band_dp_topo"),
    "band_wide": ((5000, dict(wb=300), 4 << 30), "band_dp_topo"),
    "band_past_8192": ((9000, dict(fan=1, qcut=2000), 4 << 30),
                       "band_dp_topo"),
    "fw": ((12000, dict(qcut=3000), 4 << 30), "fw_dp"),
    "fw_wide_band": ((5000, dict(wb=400), 4 << 30), "fw_dp"),
    "tile": ((5000, dict(wb=400), 256 << 20), "tile_dp"),
}


@pytest.mark.parametrize("case", list(PAST_4096))
def test_round_plan_past_4096_rows(case, monkeypatch):
    (n, kw, budget), name = PAST_4096[case]
    plan = _synth_plan(n, budget, monkeypatch, **kw)
    assert plan.cfg.R > 4096
    assert plan.name == name
    assert plan.chunk >= 1
    if case == "band_wide":
        from abpoa_tpu_torch.ops.band_dp import band_cpt
        assert band_cpt(plan.cfg.WB) == 4


def test_round_plan_past_the_budget_names_the_bytes(monkeypatch):
    """A window whose band does not fit a block and whose planes exceed
    the budget, and a round whose tiles exceed it too, get the plan
    "oracle": no kernel, no chunk, and the bytes one instance would need
    in ``per`` (the batch paths send the group to the oracle)."""
    for budget, seeded in ((256 << 20, True), (16 << 20, False)):
        plan = _synth_plan(5000, budget, monkeypatch, seeded=seeded, wb=400)
        assert (plan.name, plan.kernel, plan.chunk) == ("oracle", None, 0)
        assert plan.per > budget


def test_plane_sizes_equal_the_wrappers_allocations():
    """fw_plane_bytes, band_nplanes and tile_plane_bytes, which
    round_plan budgets with, are the planes the wrappers allocate, in
    every gap mode."""
    from abpoa_tpu_torch.align.export import PallasDPConfig
    from abpoa_tpu_torch.ops import band_dp as bd, fw_dp as fw
    from abpoa_tpu_torch.ops import tile_dp as td
    for gm in (0, 1, 2):
        tc = PallasDPConfig(gm, 0, 32, 64, 128, 256, 4, 4, 5, False)
        BT, H, E1, E2 = td._scratch(tc, 3, torch.device("cpu"))
        assert BT.untyped_storage().nbytes() == 3 * td.tile_plane_bytes(tc)
        fc = fw.FWConfig(gm, 0, 32, 64, 256, 4, 4, 5, False, 0)
        BT, H, E1, E2 = fw._planes(fc, 3, torch.device("cpu"))
        assert BT.untyped_storage().nbytes() == 3 * fw.fw_plane_bytes(fc)
        bc = bd.BandConfig(gap_mode=gm, pn=32, R=64, WB=128, Wq=256, P=4,
                           m=5, bt_lmax=0)
        H, E1, E2, BT = bd._planes(bc, 3, torch.device("cpu"))
        assert H.untyped_storage().nbytes() == \
            bd.band_nplanes(gm) * 3 * 64 * 128 * 4



@pytest.mark.parametrize("qlen,name", [(16000, "band_dp_topo"),
                                       (16500, "fw_dp")])
def test_round_plan_band_segments_past_1023_take_b4(qlen, name):
    """B3 keeps a band segment in 10 bits: a round whose query spans
    1024 segments or more (16,500 bases: 32-bit scores, 16 lanes a
    segment, 1064 segments) goes to B4 though its band fits a block;
    16,000 bases (16-bit scores, 32 lanes, 504 segments) stay on B3."""
    import dataclasses
    from test_torch_dp_edges import _params, synth_dense
    from abpoa_tpu_torch.align.export import score_dispatch
    from abpoa_tpu_torch.parallel import batch
    p = _params()
    dg = synth_dense(p, 2000, seed=3)
    q = np.random.default_rng(3).integers(0, 4, qlen)
    pn, inf_min = score_dispatch(p, dg.n_rows, qlen)
    W = (qlen // 128 + 1) * 128
    qcol = np.zeros(W, np.int32)
    qcol[1:qlen + 1] = q
    dg = dataclasses.replace(dg, qlen=qlen, pn=pn, inf_min=inf_min,
                             qcol=qcol, W=W)
    plan = batch.round_plan(p, [dg], torch.device("cpu"))
    assert plan.name == name and plan.cfg.R == 2048
    WqB = (W + plan.cfg.WB - 1) // plan.cfg.WB * plan.cfg.WB \
        if plan.band else W
    assert (WqB // pn < 1024) == (name == "band_dp_topo")


def _cli_bytes(argv, out):
    from abpoa_tpu_torch import cli
    assert cli.main([*argv, "-o", str(out)]) == 0
    return out.read_bytes()


def test_plane_budget_shares_the_free_memory(monkeypatch):
    """The budget both engines hold a launch to (device.plane_budget):
    on a card PLANE_BUDGET_SHARE of the free memory that cudaMemGetInfo
    reports, over the launches that share the card; on the CPU the fixed
    allowance, whatever shares it."""
    from abpoa_tpu_torch import device
    card = torch.device("cuda", 3)
    asked = []

    def mem_get_info(dev):
        asked.append(dev)
        return 10 << 30, 80 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    share = device.PLANE_BUDGET_SHARE
    assert device.plane_budget(card) == int((10 << 30) * share)
    assert device.plane_budget(card, 4) == int((10 << 30) * share / 4)
    assert asked == [card, card]
    cpu = torch.device("cpu")
    assert device.plane_budget(cpu) == device.plane_budget(cpu, 4) \
        == device.CPU_PLANE_BUDGET
    assert asked == [card, card]


@pytest.mark.parametrize("args", [[], ["-S"]], ids=["B5", "S-windows"])
def test_serial_engine_over_the_budget_runs_the_oracle(args, tmp_path,
                                                       monkeypatch):
    """An alignment whose tiles or planes exceed the budget (here every
    one: a budget of 1 byte) runs on the oracle and counts in
    over_budget; the output equals the oracle's, nothing raises."""
    from abpoa_tpu_torch import device
    from abpoa_tpu_torch.align import engine_torch
    fa = str(DATA / "seq.fa")
    want = _cli_bytes([*args, "--engine", "numpy", fa], tmp_path / "o.fa")
    monkeypatch.setattr(device, "CPU_PLANE_BUDGET", 1)
    n0 = engine_torch.over_budget
    got = _cli_bytes([*args, "--device", "cpu", fa], tmp_path / "t.fa")
    assert got == want
    assert engine_torch.over_budget - n0 >= 9   # seq.fa: 10 reads


@pytest.mark.parametrize("args", [["-m", "1"], ["-S"]],
                         ids=["round", "seeded"])
def test_batch_over_the_budget_falls_back(args, tmp_path, monkeypatch):
    """A round (or window round) group whose one instance exceeds the
    budget launches nothing; each instance goes to the oracle, counted
    in fallbacks; the output equals the oracle's, nothing raises."""
    from abpoa_tpu_torch import cli, device
    from abpoa_tpu_torch.parallel import batch
    fa = str(DATA / "seq.fa")
    one = _cli_bytes([*args, "--engine", "numpy", fa], tmp_path / "o.fa")
    grab = {}
    orig = batch.batch_msa_from_files

    def keep(*a, **k):
        grab["bp"] = orig(*a, **k)
        return grab["bp"]
    monkeypatch.setattr(batch, "batch_msa_from_files", keep)
    monkeypatch.setattr(device, "CPU_PLANE_BUDGET", 1)
    lst = tmp_path / "in.list"
    lst.write_text(f"{fa}\n" * 4)
    got = _cli_bytes([*args, "-l", "--device", "cpu", str(lst)],
                     tmp_path / "t.fa")
    bp = grab["bp"]
    assert got == one * 4
    assert set(bp.launches.values()) == {0}
    assert bp.fallbacks == (bp.windows if "-S" in args else 4 * 9)
    assert bp.fallbacks > 0
