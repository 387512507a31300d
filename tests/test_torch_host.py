"""abpoa_tpu_torch's copies of the host layers against the JAX package's
originals, fed from one source (the JAX package's Params carried across
by convert.params, the same encoded reads).

* The bit-exact oracle (align/engine_np.py): on seq.fa, read by read,
  each package aligns to its own graph and fuses its own result; every
  AlignResult field, CIGAR included, is equal in global, local and extend
  mode, and so is the final topological order.
* The per-round export (align/export.py): export_dense + pick_WB +
  make_pallas_inputs give the JAX package's config and input tuple,
  array for array, dtype and values, at the band kernel's and the
  full-width kernel's query widths (the edge counts in the port's wider
  index dtype).
* The measurement workloads (workload.py): a fixture's reads and the
  config-5 instances equal the root bench.py's ``_load_reads`` and
  ``_seeded_instances`` on heter.fa (bench.py is loaded by path; it
  imports no JAX at module level).
Exact equality everywhere.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
MODES = ["global", "local", "extend"]


def _jax_params(mode):
    from abpoa_tpu.params import Params, LOCAL_MODE, EXTEND_MODE
    p = Params()
    if mode == "local":
        p.align_mode = LOCAL_MODE
    elif mode == "extend":
        p.align_mode = EXTEND_MODE
        p.zdrop = 20
    return p.post_set()


def _reads(n):
    from abpoa_tpu.seqio import read_seqs
    from abpoa_tpu.alphabet import encode_table
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / "seq.fa"))][:n]


def _rounds(mode, n_reads):
    """Yield (jax graph, port graph, jax params, port params, read, rid)
    per aligned read; the caller aligns, then the loop fuses each
    package's oracle result into its own graph."""
    from abpoa_tpu.graph import POAGraph as JGraph
    from abpoa_tpu.params import SRC_NODE_ID, SINK_NODE_ID
    from abpoa_tpu.align.engine_np import align_sequence_to_subgraph as jal
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.graph import POAGraph as TGraph
    from abpoa_tpu_torch.align.engine_np import (
        align_sequence_to_subgraph as tal)
    jp = _jax_params(mode)
    tp = convert.params(jp)
    reads = _reads(n_reads)
    pairs = ((JGraph(), jp, jal), (TGraph(), tp, tal))
    for g, p, _al in pairs:
        g.add_graph_alignment(p, reads[0], [1] * len(reads[0]), [], None, 0,
                              True)
    for rid, q in enumerate(reads[1:], start=1):
        for g, p, _al in pairs:
            if not g.is_topological_sorted:
                g.topological_sort(p)
        yield pairs[0][0], pairs[1][0], jp, tp, q, rid
        for g, p, al in pairs:
            res = al(g, p, SRC_NODE_ID, SINK_NODE_ID, q)
            g.add_graph_alignment(p, q, [1] * len(q), res.cigar, None, rid,
                                  True)


@pytest.mark.parametrize("mode", MODES)
def test_oracle_equals_jax(mode):
    from abpoa_tpu.params import SRC_NODE_ID, SINK_NODE_ID
    from abpoa_tpu.align.engine_np import align_sequence_to_subgraph as jal
    from abpoa_tpu_torch.align.engine_np import (
        align_sequence_to_subgraph as tal)
    n = 0
    for jg, tg, jp, tp, q, rid in _rounds(mode, 6):
        jr = jal(jg, jp, SRC_NODE_ID, SINK_NODE_ID, q)
        tr = tal(tg, tp, SRC_NODE_ID, SINK_NODE_ID, q)
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr), (mode, rid)
        assert tr.cigar and tr.n_aln_bases > 0
        n += 1
        last = jg, tg, jp, tp
    jg, tg, jp, tp = last
    jg.topological_sort(jp)
    tg.topological_sort(tp)
    assert n == 5 and tg.node_n == jg.node_n
    assert list(tg.index_to_node_id[:tg.node_n]) \
        == list(jg.index_to_node_id[:jg.node_n])


@pytest.mark.parametrize("mode", MODES)
def test_make_pallas_inputs_equals_jax(mode):
    from abpoa_tpu.align import engine_jax as J
    from abpoa_tpu_torch.align import export as T
    for jg, tg, jp, tp, q, rid in _rounds(mode, 5):
        jd = J.export_dense(jg, jp, q)
        td = T.export_dense(tg, tp, q)
        assert (td.n_rows, td.qlen, td.pn, td.inf_min, td.R, td.W, td.P,
                td.O) == (jd.n_rows, jd.qlen, jd.pn, jd.inf_min, jd.R, jd.W,
                          jd.P, jd.O)
        WB = T.pick_WB(tp, td.qlen, td.pn)
        assert WB == J.pick_WB(jp, jd.qlen, jd.pn)
        Wq = (td.qlen // 128 + 1) * 128
        LMAX = (td.R + Wq + 63) // 64 * 64
        # the band kernel's query width (a multiple of WB) and the
        # full-width kernel's; a re-pad to a larger group geometry
        for force_Wq, pad in (((Wq + WB - 1) // WB * WB, 0), (Wq, 64)):
            jdd = J.repad_dense(jd, jd.R + pad, jd.W, jd.P * 2, jd.O)
            tdd = T.repad_dense(td, td.R + pad, td.W, td.P * 2, td.O)
            jc, ja = J.make_pallas_inputs(jdd, jp, WB, force_Wq=force_Wq,
                                          bt_lmax=LMAX)
            tc, ta = T.make_pallas_inputs(tdd, tp, WB, force_Wq=force_Wq,
                                          bt_lmax=LMAX)
            assert tuple(tc) == tuple(jc)
            assert len(ta) == len(ja) == 11
            for i, (t, j) in enumerate(zip(ta, ja)):
                # pre_n and out_n (3, 5) travel as the index dtype: the
                # JAX package's int8 wraps past 127 edges of a node
                want = ta[2].dtype if i in (3, 5) else j.dtype
                assert t.dtype == want and t.shape == j.shape, (i, rid)
                assert (t == j).all(), (mode, rid, i)


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config5_generator_equals_bench_py():
    from abpoa_tpu_torch import workload
    root = _root_bench()
    reads = workload.load_reads("heter.fa")
    theirs = root._load_reads("heter.fa")
    assert len(reads) == len(theirs)
    assert all(np.array_equal(a, b) for a, b in zip(reads, theirs))
    mine = workload.seeded_instances(reads, 10)
    want = root._seeded_instances(theirs, 10)
    assert len(mine) == len(want) == 10
    for a, b in zip(mine, want):
        assert [len(q) for q in a] == [len(q) for q in b]
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert len({tuple(len(q) for q in inst) for inst in mine}) == 5
