"""abpoa_tpu_torch: the device loop's host replay in one native call an
instance (native/poagraph.c pg_replay_loop, NativeGraph.replay_loop)
against the per-read route it replaced (topological_sort,
unpack_steps16, fuse_steps a read), on amp700-shaped loop batches
through the plain versions (devices=["cpu"]), and its in-C decode of
the steps16 wire stream on hand-built streams.

Each batch case runs the batch twice, once as BatchPOA runs it and once
with replay_loop replaced by the per-read route under the same
contract, and holds every instance's graph (the CSR arrays of
pg_export_csr, the read ids and weights of pg_export_aux) and consensus
(bases, coverage, phred) equal, and the counters replayed_native and
replayed_python to the reads replayed. Cases: unit weights with an
instance that fails on the device (capacity), qv weights (wmode 1), a
forced step-stream fetch cap (the native call stops before the reads
past it, which are refetched and fused by a call of their own),
amb_strand with a flagged read. Exact equality.
"""
import numpy as np
import pytest
import torch

from abpoa_tpu_torch.graph import NativeGraph
from abpoa_tpu_torch.ops import layout as L
from abpoa_tpu_torch.ops import steps as tst
from abpoa_tpu_torch.params import Params

pytestmark = pytest.mark.skipif(not NativeGraph.available(),
                                reason="native library unavailable")

torch.set_num_threads(1)


def _read(rng, template):
    """A read of `template` with amp700's error counts at 700 bp: 3
    substitutions, 3 deletions, 1 insertion."""
    n = len(template)
    pos = rng.choice(n, 6, replace=False)
    read = template.copy()
    read[pos[:3]] = (read[pos[:3]] + rng.integers(1, 4, 3)) % 4
    keep = np.ones(n, bool)
    keep[pos[3:]] = False
    return np.insert(read[keep], int(rng.integers(0, n - 6)),
                     np.uint8(rng.integers(0, 4))).astype(np.uint8)


def _clusters(seed, shapes):
    rng = np.random.default_rng(seed)
    out = []
    for length, depth in shapes:
        t = rng.integers(0, 4, length).astype(np.uint8)
        out.append([_read(rng, t) for _ in range(depth)])
    return out


def _case(name):
    """(params, instances, weights, s16_cap, the instances that fail on
    the device)."""
    p = Params()
    rng = np.random.default_rng(7)
    weights, cap, failed = None, None, []
    if name == "amb_strand":
        p.amb_strand = True
    p.post_set()
    inst = _clusters(20260901, [(700, 4), (650, 3)])
    if name == "unit":
        # unrelated reads outgrow the batch's node capacity: the
        # instance fails on the device and is rebuilt on the oracle
        inst.append([rng.integers(0, 4, 690).astype(np.uint8)
                     for _ in range(4)])
        failed = [2]
    elif name == "qv":
        weights = [[rng.integers(1, 40, len(q)).tolist() for q in reads]
                   for reads in inst]
    elif name == "cap":
        # a 120-half fetch: the 700 bp reads refetch; of a 150 bp
        # cluster with a 60-base deletion, the walks that cross the
        # deletion on a chain (150 steps) refetch, the one along the
        # edge the first deleted read left (90 steps) fits
        t = rng.integers(0, 4, 150).astype(np.uint8)
        gap = np.concatenate([t[:45], t[105:]])
        inst[1] = [t, gap, gap.copy(), t.copy()]
        cap = 120
    elif name == "amb_strand":
        # read 2 of a 300 bp cluster reverse-complemented: its forward
        # alignment trips the threshold; the graph it leaves on the
        # device still fits the batch's node capacity
        (short,) = _clusters(5, [(300, 4)])
        short[2] = (3 - short[2][::-1]).astype(np.uint8)
        inst.append(short)
    return p, inst, weights, cap, failed


def _graph_arrays(g):
    """The graph as flat arrays: pg_export_csr's and pg_export_aux's."""
    import ctypes
    from abpoa_tpu_torch.native import ptr
    c = g.build_csr()
    cnt = (ctypes.c_int64 * 3)()
    g._lib.pg_counts(g._h, ctypes.byref(cnt, 0), ctypes.byref(cnt, 8),
                     ctypes.byref(cnt, 16))
    E, n_rw = int(cnt[0]), int(cnt[2])
    rn = int(g._lib.pg_rn(g._h))
    aux = {"read_ids": np.zeros((max(E, 1), rn), np.uint64),
           "n_read": np.zeros(c["n"], np.int32),
           "rw_node": np.zeros(max(n_rw, 1), np.int32),
           "rw_rid": np.zeros(max(n_rw, 1), np.int32),
           "rw_w": np.zeros(max(n_rw, 1), np.int32)}
    g._lib.pg_export_aux(g._h, *(ptr(a) for a in aux.values()))
    return {**{k: v for k, v in c.items() if k != "n"}, **aux,
            "n": np.int64(c["n"])}


def _run(name):
    from abpoa_tpu_torch import BatchPOA
    params, inst, weights, cap, _ = _case(name)
    bp = BatchPOA(params, devices=["cpu"])
    bp.s16_cap = cap
    bp.precompute_cons = True     # the consensus inside the replay pool
    abs_ = bp.run(inst, weights=weights)
    assert bp.used_device_loop
    return bp, abs_


def _per_read_replay_loop(self, params, meta, s16, reads, weights, r0=0,
                          r1=None):
    """NativeGraph.replay_loop's contract, one read at a time the way the
    device loop fused before the native entry: topological_sort,
    unpack_steps16, fuse_steps."""
    r1 = len(reads) - 1 if r1 is None else r1
    for r in range(r0, r1):
        nst, bi, bj, end_j, best = (int(x) for x in meta[r])
        q = reads[r + 1]
        if params.amb_strand and best < (min(len(q), self.node_n - 2)
                                         * params.max_mat * .3333):
            return r
        if nst > s16.shape[1]:
            return r
        words = tst.unpack_steps16(s16[r - r0], nst, bi, bj)
        self.topological_sort(params)
        self.fuse_steps(params, 0, words, nst, bj, end_j, q, r + 1, True,
                        weight=None if weights is None else weights[r + 1])
    return r1


@pytest.mark.parametrize("name", ["unit", "qv", "cap", "amb_strand"])
def test_native_replay_equals_per_read_route(name, monkeypatch):
    _, inst, _, cap, failed = _case(name)
    calls, native_loop = [], NativeGraph.replay_loop

    def spy(self, params, meta, s16, reads, weights, r0=0, r1=None):
        calls.append((r1, s16.shape[1]))
        return native_loop(self, params, meta, s16, reads, weights, r0, r1)

    with monkeypatch.context() as m:
        m.setattr(NativeGraph, "replay_loop", spy)
        bp, abs_ = _run(name)
    with monkeypatch.context() as m:
        m.setattr(NativeGraph, "replay_loop", _per_read_replay_loop)
        ref_bp, ref = _run(name)
    assert bp.fallbacks == ref_bp.fallbacks == len(failed)
    for a, b in zip(abs_, ref):
        ga, gb = _graph_arrays(a.graph), _graph_arrays(b.graph)
        assert ga.keys() == gb.keys()
        for key in ga:
            assert np.array_equal(ga[key], gb[key]), key
        for field in ("cons_base", "cons_cov", "cons_phred_score",
                      "cons_node_ids"):
            assert getattr(a.cons, field) == getattr(b.cons, field), field
    replayed = sum(len(reads) - 1 for k, reads in enumerate(inst)
                   if k not in failed)
    assert bp.replayed_native + bp.replayed_python == replayed
    assert (ref_bp.replayed_native, ref_bp.replayed_python) == (
        bp.replayed_native, bp.replayed_python)
    refetched = [c for c in calls if c[0] is not None]
    if name == "amb_strand":
        # the flagged read and the rest of its instance go the
        # sequential fwd+rc way
        assert bp.replayed_native == 6 and bp.replayed_python == 2
    else:
        assert bp.replayed_python == 0
    if name == "cap":
        # the three 700 bp rounds and the two 150 bp rounds across the
        # deletion on a chain are refetched, each into a call of its
        # own; the call that stops at round 0 of the 150 bp cluster
        # takes up again at round 1
        assert len(refetched) == 5
        assert all(width > cap for _, width in refetched)
    else:
        assert refetched == []


def test_replay_loop_decodes_the_wire_stream():
    """pg_replay_loop's steps16 decode in C, a toposort and the fusion a
    round == decode_steps_batch + topological_sort + pg_fuse_steps a
    round, on hand-built steps_to_s16w streams over a 9000-node chain:
    three rounds under qv weights, each walk with one 13-bit row jump
    (8000 rows in one step), a leading and a trailing insertion. A
    stream whose row lies past the graph is refused."""
    p = Params().post_set()
    p.use_read_ids, p.use_qv, p.max_n_cons = True, True, 2
    rng = np.random.default_rng(13)
    n, LS = 9000, 512
    reads = [rng.integers(0, 4, n).astype(np.uint8)]
    words = np.zeros((3, LS), np.int64)
    misc = np.zeros((3, L.M_NMISC), np.int32)
    for r in range(3):
        i, j, steps = 8990 - 7 * r, 400 + r, []
        jump = int(rng.integers(20, 280))
        for k in range(300):
            op = int(rng.integers(0, 3))
            steps.append((op, i, j))
            if op != 1:
                i -= 8000 if k >= jump else int(rng.integers(1, 3))
                jump = jump if k < jump else 300
            if op != 2:
                j -= 1
        assert i >= 1 and j >= 1
        words[r, :300] = tst.pack_steps(*np.array(steps, np.int64).T)
        misc[r, [L.M_BI, L.M_BJ, L.M_NSTEPS, L.M_ENDJ]] = 8990 - 7 * r, \
            400 + r, 300, j
        reads.append(rng.integers(0, 4, 410 + r).astype(np.uint8))
    weights = [rng.integers(1, 9, len(q)).tolist() for q in reads]
    s16w, misc = tst.steps_to_s16w(torch.from_numpy(words),
                                   torch.from_numpy(misc))
    s16 = s16w.numpy().view(np.int16)
    misc = misc.numpy()
    di = (s16[:, :300].astype(np.int64) & 0xFFFF) >> 3
    assert (di.max(axis=1) == 8000).all()
    decoded = tst.decode_steps_batch(s16[None], misc[None])[0]
    ref, got = NativeGraph(), NativeGraph()
    for g in (ref, got):
        g.add_graph_alignment(p, reads[0], weights[0], [], None, 0, True)
        g.topological_sort(p)
    for r in range(3):
        ref.topological_sort(p)
        ref.fuse_steps(p, 0, decoded[r], 300, int(misc[r, L.M_BJ]),
                       int(misc[r, L.M_ENDJ]), reads[r + 1], r + 1, True,
                       weight=weights[r + 1])
    meta = np.ascontiguousarray(
        misc[:, [L.M_NSTEPS, L.M_BI, L.M_BJ, L.M_ENDJ, L.M_BEST]])
    assert got.replay_loop(p, meta, s16, reads, weights) == 3
    assert not got.is_topological_sorted
    ga, gr = _graph_arrays(got), _graph_arrays(ref)
    assert ga.keys() == gr.keys()
    for key in ga:
        assert np.array_equal(ga[key], gr[key]), key
    meta[0, 1] = got.node_n + 5       # M_BI past the graph's rows
    with pytest.raises(RuntimeError, match="outside the graph"):
        got.replay_loop(p, meta, s16, reads, weights, 0, 1)


def test_phred_table_equals_cons_phred_score():
    """The native consensus route's per-count phred table is
    cons_phred_score at every coverage; a coverage past n_seq still
    raises."""
    from abpoa_tpu_torch.consensus import (Consensus, cons_phred_score,
                                           cons_phred_table,
                                           heaviest_bundling)
    from abpoa_tpu_torch.params import SRC_NODE_ID, SINK_NODE_ID
    for n_seq in range(1, 65):
        assert cons_phred_table(n_seq) == [cons_phred_score(c, n_seq)
                                           for c in range(n_seq + 1)]
    g = NativeGraph()
    a = g.add_node(1)
    g.add_edge(SRC_NODE_ID, a, True, 1, False, False, 0)
    for _ in range(2):
        g.add_edge(a, SINK_NODE_ID, True, 1, False, False, 0)
    with pytest.raises(ValueError, match="unexpected n_cov/n_seq"):
        heaviest_bundling(g, Consensus(n_seq=1))
    abc = Consensus(n_seq=2)
    heaviest_bundling(g, abc)
    assert abc.cons_phred_score == [[cons_phred_score(2, 2)]]
