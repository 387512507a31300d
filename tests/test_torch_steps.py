"""abpoa_tpu_torch: the int64 step word op | row<<2 | col<<32 of the DP
walks (ops/steps.py), its steps16 wire stream, the host replay
(replay_steps) and the native fusion (native/poagraph.c pg_fuse_steps),
on hand-built streams.

Where a stream fits the JAX package's int32 word op|row<<2|col<<14
(rows below 4096, columns below 2^17) the port is held against the JAX
package: its steps16 encoding and decoding against
poa_loop.steps32_to_s16w and bt_xla.unpack_steps16, its replay against
bt_xla.replay_steps. Past that (rows past 4096 and 8192, columns past
2^17: the JAX word cannot hold them) the streams are held against how
they were built, and the native fusion against the host replay's cigar
fused by the same graph store. Exact equality.
"""
import numpy as np
import pytest
import torch

from abpoa_tpu_torch.ops import layout as L
from abpoa_tpu_torch.ops import steps as tst

ROWS = [0, 1, 4095, 4096, 8191, 8192, 8193, 1 << 20, (1 << 30) - 1]
COLS = [0, 1, (1 << 17) - 1, 1 << 17, 1 << 20, (1 << 31) - 1]


def test_pack_and_fields_roundtrip():
    op = np.arange(len(ROWS) * len(COLS)) % 3
    row = np.repeat(ROWS, len(COLS))
    col = np.tile(COLS, len(ROWS))
    w = tst.pack_steps(op, row, col)
    assert w.dtype == np.int64
    for got, want in zip(tst.step_fields(w), (op, row, col)):
        assert (got == want).all()
    wt = tst.pack_steps(*(torch.from_numpy(np.asarray(x)) for x in
                          (op, row, col)))
    assert wt.dtype == torch.int64 and (wt.numpy() == w).all()
    # in the JAX word's range the two words hold the same triple
    small = (row < 4096) & (col < (1 << 17))
    legacy = (op | (row << 2) | (col << 14))[small]
    assert ((legacy & 3) == op[small]).all()
    assert (((legacy >> 2) & 0xFFF) == row[small]).all()
    assert ((legacy >> 14) == col[small]).all()


def _walk(rng, n, i, j, max_di):
    """A hand-built walk of n steps from cell (i, j), in push order:
    (op, row, col) of each step, rows and columns non-increasing, and
    the misc row."""
    out = []
    for _ in range(n):
        op = int(rng.integers(0, 3))
        out.append((op, i, j))
        if op != 1:
            i -= int(rng.integers(1, max_di + 1))
        if op != 2:
            j -= 1
    misc = np.zeros(L.M_NMISC, np.int32)
    misc[L.M_BI], misc[L.M_BJ], misc[L.M_NSTEPS] = out[0][1], out[0][2], n
    return np.array(out, np.int64).T, misc


@pytest.mark.parametrize("start", [(4000, 3000), (8191, 20000),
                                   (8000, (1 << 17) + 500)])
def test_steps16_roundtrip_past_the_jax_word(start):
    """steps_to_s16w -> unpack_steps16 / decode_steps_batch gives back
    every step of streams whose rows pass 4096 (up to 8191, the 13-bit
    row decrement's graph) and whose columns pass 2^17; in the JAX
    word's range the wire words equal the JAX encoder's."""
    import jax.numpy as jnp
    from abpoa_tpu.ops import poa_loop as pls
    from abpoa_tpu_torch.ops import poa_loop as tpl
    rng = np.random.default_rng(start[0])
    B, LS = 3, 256
    words = np.zeros((B, LS), np.int64)
    misc = np.zeros((B, L.M_NMISC), np.int32)
    trip = []
    for b in range(B):
        (op, row, col), misc[b] = _walk(rng, LS - 8 * b, *start, 40)
        words[b, :len(op)] = tst.pack_steps(op, row, col)
        trip.append((op, row, col))
    s16w, misc2 = tst.steps_to_s16w(torch.from_numpy(words),
                                    torch.from_numpy(misc))
    s16 = tpl.s16w_to_s16(s16w).numpy()
    allw = tst.decode_steps_batch(s16[None], misc[None])[0]
    for b, (op, row, col) in enumerate(trip):
        n = len(op)
        got = tst.unpack_steps16(s16[b], n, misc[b, L.M_BI],
                                 misc[b, L.M_BJ])
        for g, want in zip(tst.step_fields(got), (op, row, col)):
            assert (g == want).all()
        assert (allw[b, :n] == words[b, :n]).all()
        assert misc2[b, L.M_LASTI] == row[-1]
    if start[0] < 4096 and start[1] < (1 << 17):
        op, row, col = tst.step_fields(words)
        legacy = (op | (row << 2) | (col << 14)).astype(np.int32)
        js16w, jmisc = pls.steps32_to_s16w(jnp.asarray(legacy),
                                           jnp.asarray(misc))
        assert (np.asarray(js16w) == s16w.numpy()).all()
        assert (np.asarray(jmisc) == misc2.numpy()).all()


def _chain(n, graph_cls, params, seed=5):
    """A graph of one read of n random bases (a chain of n nodes)."""
    q = np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)
    g = graph_cls()
    g.add_graph_alignment(params, q, [1] * n, [], None, 0, True)
    g.topological_sort(params)
    return g, q


def test_replay_in_the_jax_range_equals_jax():
    """replay_steps of the port's words == bt_xla.replay_steps of the JAX
    words, on a 4000-node chain (rows up to 4000)."""
    from abpoa_tpu.align.engine_np import AlignResult as JRes
    from abpoa_tpu.graph import POAGraph as JGraph
    from abpoa_tpu.ops import bt_xla
    from abpoa_tpu.params import Params as JParams
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.align.engine_np import AlignResult
    from abpoa_tpu_torch.graph import POAGraph
    jp = JParams().post_set()
    tp = convert.params(jp)
    gj, q = _chain(4000, JGraph, jp)
    gt, _ = _chain(4000, POAGraph, tp)
    (op, row, col), misc = _walk(np.random.default_rng(1), 3000, 4000, 3990,
                                 1)
    n = len(op)
    query = np.random.default_rng(2).integers(0, 4, 4100).astype(np.uint8)
    legacy = (op | (row << 2) | (col << 14)).astype(np.int32)
    args = (n, int(misc[L.M_BI]), int(misc[L.M_BJ]), 1, int(col[-1]) - 1)
    rj = bt_xla.replay_steps(gj, jp, query, legacy, *args, JRes())
    rt = tst.replay_steps(gt, tp, query, tst.pack_steps(op, row, col),
                          *args, AlignResult())
    assert list(map(tuple, rt.cigar)) == list(map(tuple, rj.cigar))
    assert (rt.node_s, rt.node_e, rt.query_s, rt.query_e,
            rt.n_aln_bases, rt.n_matched_bases) == (
        rj.node_s, rj.node_e, rj.query_s, rj.query_e, rj.n_aln_bases,
        rj.n_matched_bases)


def test_replay_and_native_fusion_past_the_jax_word():
    """On a 9000-node chain (rows past 8192) with a query of 2^17 + 3000
    bases (columns past 2^17): replay_steps gives the cigar the stream
    was built from, and the native fusion of the words (pg_fuse_steps)
    builds the graph the same store builds from that cigar."""
    from abpoa_tpu_torch.align.engine_np import AlignResult
    from abpoa_tpu_torch.cigar import CMATCH, CINS, CDEL
    from abpoa_tpu_torch.graph import NativeGraph
    from abpoa_tpu_torch.params import Params
    if not NativeGraph.available():
        pytest.skip("the native graph store did not build")
    params = Params().post_set()
    n_nodes, qlen = 9000, (1 << 17) + 3000
    ga, _ = _chain(n_nodes, NativeGraph, params)
    gb, _ = _chain(n_nodes, NativeGraph, params)
    query = np.random.default_rng(3).integers(0, 4, qlen).astype(np.uint8)
    # the walk: from the last chain row and column qlen - 7 down to row
    # 1; M and D steps move one row, insertions fill the columns between
    rng = np.random.default_rng(4)
    steps, i, j = [], n_nodes, qlen - 7
    while i >= 1 and j >= 1:
        op = 1 if (j > i and rng.random() < 0.94) else int(
            rng.choice([0, 0, 0, 2]))
        steps.append((op, i, j))
        i -= op != 1
        j -= op != 2
    op, row, col = np.array(steps, np.int64).T
    assert row.max() > 8192 and col.max() >= (1 << 17)
    words = tst.pack_steps(op, row, col)
    nst, bi, bj, end_i, end_j = len(op), n_nodes, qlen - 7, int(i), int(j)
    i2n = np.asarray(ga.index_to_node_id, np.int64)
    res = tst.replay_steps(ga, params, query, words, nst, bi, bj, end_i,
                           end_j, AlignResult())
    # the cigar as replay_steps pushes it (the walk's order), reversed
    want = [(CINS, qlen - 1, 7)]
    for o, r, c in steps:
        if o == 0:
            want.append((CMATCH, int(i2n[r]), c - 1))
        elif o == 2:
            want.append((CDEL, int(i2n[r]), 1))
        elif want[-1][0] == CINS:
            want[-1] = (CINS, want[-1][1], want[-1][2] + 1)
        else:
            want.append((CINS, c - 1, 1))
    if end_j > 0:
        if want[-1][0] == CINS:
            want[-1] = (CINS, want[-1][1], want[-1][2] + end_j)
        else:
            want.append((CINS, end_j - 1, end_j))
    want.reverse()
    assert list(map(tuple, res.cigar)) == want
    assert (res.node_s, res.query_s) == (int(i2n[row[-1]]), int(col[-1]) - 1)
    assert (res.node_e, res.query_e) == (int(i2n[bi]), bj - 1)
    ga.fuse_steps(params, 0, words, nst, bj, end_j, query, 1, True)
    gb.add_graph_alignment(params, query, [1] * qlen, res.cigar, None, 1,
                           True)
    ca, cb = ga.build_csr(), gb.build_csr()
    assert ca["n"] == cb["n"] > n_nodes + 2
    for k in ("bases", "out_flat", "out_off", "out_w_flat", "in_flat",
              "in_off"):
        assert (ca[k] == cb[k]).all(), k
