"""Differential fuzzer of the port's device loop.

    python -m abpoa_tpu_torch.tools.fuzz_device_loop --n N --start S \\
        --device cpu|cuda --mode round|batch|envelope [--keep-going]

round (the counterpart of ``tools/fuzz_device_loop.py``, same generator
and seeds): random heterogeneous batches (B 1-2 instances of 2-7 reads of
40-300 bp; rounds past an instance's last read are qlen-0 masked rounds)
under one of three gap sets (seed % 3) and a band of 5-29, one round at a
time through ``ops/poa_loop.device_round`` (the packed two-kernel round;
every third seed also the split round: B3, ``fuse_batch``, B6,
``remain_ref``). After every round and for every instance it checks,
against the port's oracle (``align/engine_np``) and ``POAGraph``:
  * misc's best score == the oracle's best score;
  * the cigar replayed from the step stream == the oracle's cigar;
  * the graph state (CSR with list orders and edge weights) == the host's;
  * i2n, n2i and max_remain == the host's;
  * a masked round leaves the instance's state untouched.

batch: random heterogeneous batches through ``BatchPOA(devices=...)
.run_consensus`` against the port's serial oracle. Each seed draws the
shard count (1-3, repeating the card on a host with fewer), -s with a
reverse-complemented read, a forced step-stream fetch cap of 2-64 (long
streams refetch) and qv weights (integers 1-59: the graph kernel's
wmode 1); then, from a second stream (so the draws above stay those of
the seed), the host/device pipeline on or off, the instance count
(raised to 3, 4, 8 or 16, across the pipeline's thresholds, with
instances of 2-4 reads of 40-150 bp) and the
path: the device loop, or the round path in extend mode (-m 2). It fails
on any byte difference, on a pipeline shard count other than the
thresholds give, on a round-path fallback, and on device-loop fallbacks
beyond the instances that the oracle's capacity rule flags (a graph past
the loop's node, edge or aligned-list capacity, or a band past its
segments), the rule run on the forward-only oracle, as the loop runs.

envelope: the loop at the edge of its envelope, a class a seed (seed %
3, ``draw_envelope``): ``qv``, 2-4 instances of 3-4 reads of 1.9-2.5 kb
with qv weights (the graph kernel's wmode 1 with its state in global
memory); ``long``, 2-3 instances of 3-4 reads of 2.6-3.1 kb under
affine or linear gaps (wmode 0, state in global memory); ``wide``, 2-4
instances of 3-5 reads of 1.0-1.8 kb with -b or -f wide enough for a
band of 1,025-2,048 lanes (the band kernel's four positions a thread).
``BatchPOA.run_consensus`` against the port's serial oracle, on the
device loop, with the batch mode's capacity rule for fallbacks; on the
card the class's kernel instance must launch.

A failing seed prints its parameters and the run exits 1; rerun it with
--start SEED --n 1. Out of scope: bands over 2048 lanes, partial row
masks and more than 253 predecessors (the shape classes of the CLI's
fuzzer, ``fuzz_ref --shapes``, reach them).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import traceback

import numpy as np

GAP_SETS = [(4, 2, 24, 1), (4, 2, 0, 0), (0, 2, 0, 0)]


def _gen_instance(rng, L, n_reads, sub_p, ind_p):
    anc = rng.integers(0, 4, L).astype(np.uint8)
    reads = []
    for _ in range(n_reads):
        out = []
        for b in anc:
            r = rng.random()
            if r < ind_p / 2:
                continue
            if r < ind_p:
                out.append(int(rng.integers(0, 4)))
            out.append(int(rng.integers(0, 4)) if rng.random() < sub_p
                       else int(b))
        reads.append(np.asarray(out or [0], dtype=np.uint8))
    return reads


def _state_rows(st, b):
    """Instance b's GState rows as numpy arrays."""
    return [np.array(x[b].cpu()) for x in st]


def _check_round(params, g, q, r, b, mi, s16, st, i2n, n2i, remain):
    """Round r of instance b against the oracle, then fuse the oracle's
    cigar into the host graph g. Returns False on a band overflow (the
    instance is retired, as the batch path rebuilds it on the oracle)."""
    from ..align.engine_np import align_sequence_to_subgraph, AlignResult
    from ..ops import layout as L
    from ..ops.steps import replay_steps, unpack_steps16
    from ..params import SRC_NODE_ID, SINK_NODE_ID
    if not g.is_topological_sorted:
        g.topological_sort(params)
    res = align_sequence_to_subgraph(g, params, SRC_NODE_ID, SINK_NODE_ID, q)
    fail = int(st.fail[b])
    if mi[L.M_OVFL]:
        # band overflow: the state freezes under the fail flag
        assert fail == 1, (r, b, "overflow without the fail flag")
        return False
    assert mi[L.M_FAIL] == 0, (r, b, "walk fail")
    assert mi[L.M_BEST] == res.best_score, \
        (r, b, "best", int(mi[L.M_BEST]), res.best_score)
    nst = int(mi[L.M_NSTEPS])
    words = unpack_steps16(s16, nst, int(mi[L.M_BI]), int(mi[L.M_BJ]))
    r2 = AlignResult()
    replay_steps(g, params, q, words, nst, int(mi[L.M_BI]),
                 int(mi[L.M_BJ]), int(mi[L.M_ENDI]), int(mi[L.M_ENDJ]), r2)
    assert r2.cigar == res.cigar, (r, b, "cigar")
    g.add_graph_alignment(params, q, [1] * len(q), res.cigar, None, r, True)
    assert fail == 0, (r, b, "fail flag")
    c = g.build_csr()
    n = c["n"]
    rows = dict(zip(("bases", "out_ids", "out_w", "n_out", "in_ids", "n_in",
                     "al_ids", "n_al", "node_n", "fail"), _state_rows(st, b)))
    assert rows["node_n"] == n, (r, b, "node_n")
    assert (rows["bases"][:n] == c["bases"][:n]).all(), (r, b, "bases")
    for name, flat, off, dn, di, dw in (
            ("out", c["out_flat"], c["out_off"], "n_out", "out_ids",
             c["out_w_flat"]),
            ("in", c["in_flat"], c["in_off"], "n_in", "in_ids", None),
            ("al", c["al_flat"], c["al_off"], "n_al", "al_ids", None)):
        cnt = off[1:] - off[:-1]
        assert (rows[dn][:n] == cnt[:n]).all(), (r, b, name)
        for i in range(n):
            assert (rows[di][i, :cnt[i]] == flat[off[i]:off[i + 1]]).all(), \
                (r, b, name, i)
            if dw is not None:
                assert (rows["out_w"][i, :cnt[i]]
                        == dw[off[i]:off[i + 1]]).all(), (r, b, "w", i)
    g.topological_sort(params)
    for name, dev_map, host_map in (
            ("i2n", i2n, g.index_to_node_id), ("n2i", n2i,
                                               g.node_id_to_index),
            ("remain", remain, g.node_id_to_max_remain)):
        assert (np.array(dev_map[b, :n].cpu())
                == np.asarray(host_map[:n])).all(), (r, b, name)
    return True


def run_round_seed(seed: int, device="cpu") -> str:
    """One round-mode seed; raises AssertionError on a mismatch."""
    import torch
    from ..align.engine_np import score_width_dispatch
    from ..align.export import pick_WB
    from ..graph import POAGraph
    from ..ops import poa_loop as pl
    from ..params import Params
    rng = np.random.default_rng(777_000 + seed)
    B = int(rng.integers(1, 3))
    sub_p = float(rng.uniform(0.01, 0.15))
    ind_p = float(rng.uniform(0.0, 0.08))
    gaps = GAP_SETS[seed % 3]
    wb = int(rng.integers(5, 30))
    insts = []
    for _ in range(B):
        n_reads = int(rng.integers(2, 8))
        L = int(rng.integers(40, 300))
        insts.append(_gen_instance(rng, L, n_reads, sub_p, ind_p))
    params = Params(gap_open1=gaps[0], gap_ext1=gaps[1], gap_open2=gaps[2],
                    gap_ext2=gaps[3], wb=wb).post_set()
    maxlen = max(len(q) for reads in insts for q in reads)
    NR = max(len(reads) for reads in insts) - 1
    R = 256 if maxlen < 180 else 512
    bits, pn, _l, inf_min = score_width_dispatch(params, R, maxlen)
    assert bits == 16
    WB = pick_WB(params, maxlen, pn)
    Wq = ((maxlen // 128) + 1) * 128
    Wq = (Wq + WB - 1) // WB * WB
    LS = (R + Wq + 63) // 64 * 64
    cfg = pl.LoopConfig(R=R, E=12, P=8, A=4, Wq=Wq, WB=WB, LS=LS, NR=NR,
                        B=B, pn=pn, inf_min=inf_min,
                        gap_mode=params.gap_mode, wbits=4, wmode=0)
    splits = (False, True) if seed % 3 == 0 else (False,)
    for split in splits:
        gs = []
        for reads in insts:
            g = POAGraph()
            g.add_graph_alignment(params, reads[0], [1] * len(reads[0]), [],
                                  None, 0, True)
            g.topological_sort(params)
            gs.append(g)
        st, i2n, n2i, remain = pl.init_state_np(gs, cfg)
        if st.fail.any():
            return "skip (capacity at init)"

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)
        st = pl.GState(*(put(x) for x in st))
        i2n, n2i, remain = put(i2n), put(n2i), put(remain)
        scal_base = put(pl.make_scal_base(params, cfg))
        done = [False] * B
        for r in range(1, NR + 1):
            qc = np.zeros((B, Wq), np.int8)
            ql = np.zeros(B, np.int32)
            for b, reads in enumerate(insts):
                if r < len(reads):
                    qc[b, 1:len(reads[r]) + 1] = reads[r]
                    ql[b] = len(reads[r])
            before = [_state_rows(st, b) for b in range(B)]
            st2, i2n2, n2i2, remain2, misc, s16 = pl.device_round(
                cfg, st, i2n, n2i, remain, put(qc), put(ql), scal_base,
                params.wb, int(round(params.wf * 1000)), split=split)
            mi_all = misc.cpu().numpy()
            s16_all = s16.cpu().numpy()
            for b, reads in enumerate(insts):
                if done[b]:
                    continue
                if r >= len(reads):
                    after = _state_rows(st2, b)
                    assert all((x == y).all() for x, y in
                               zip(before[b], after)), \
                        (r, b, split, "masked round changed the state")
                    continue
                done[b] = not _check_round(
                    params, gs[b], reads[r], r, b, mi_all[b],
                    s16_all[b], st2, i2n2, n2i2, remain2)
            st, i2n, n2i, remain = st2, i2n2, n2i2, remain2
            if all(done):
                break
    shape = [(len(rr), max(len(q) for q in rr)) for rr in insts]
    return (f"ok (B={B} {shape}, gaps={gaps}, wb={wb}, "
            f"split={'both' if len(splits) == 2 else 'packed'})")


def _revcomp(q):
    return np.array([3 - b if b < 4 else b for b in q[::-1]], np.uint8)


def _oracle(params, insts, weights):
    """The port's serial pipeline of each instance on the oracle, under
    the per-read weights: (consensus strings per instance, aligners)."""
    from ..alphabet import decode_table
    from ..api import ABPOA
    from ..consensus import generate_consensus
    host = dataclasses.replace(params, engine="numpy")
    dt = decode_table(params.m)
    out, abs_ = [], []
    for k, reads in enumerate(insts):
        ab = ABPOA()
        ab.n_seq = len(reads)
        ab.names = [""] * len(reads)
        ab.is_rc = [0] * len(reads)
        ab.poa(host, reads, weights[k] if weights is not None
               else [[1] * len(q) for q in reads], 0)
        generate_consensus(ab, host)
        out.append([bytes(dt[b] for b in s).decode()
                    for s in ab.cons.cons_base[:ab.cons.n_cons]])
        abs_.append(ab)
    return out, abs_


def _capacity_flags(params, insts, weights, cfg):
    """Instances the loop's capacity rule sends to the oracle: the serial
    run's graph past the loop's node, out-, in- or aligned-list capacity
    (graphs only grow, so the final graph decides), or a band in any of
    its alignments wider than the loop's band segments (WB // pn)."""
    from ..align import engine_np
    seg = []
    base = engine_np._Ctx

    class Recording(base):
        def run(self):
            super().run()
            n = self.n_rows - 1      # rows 0..n-2 carry a band
            cap = np.minimum(self.dp_end_sn[:n] + 1, self.dp_sn - 1)
            seg.append(int((cap - self.dp_beg_sn[:n] + 2).max(initial=0)))
    flags = []
    engine_np._Ctx = Recording
    try:
        for k, reads in enumerate(insts):
            seg.clear()
            _cons, (ab,) = _oracle(params, [reads], None if weights is None
                                   else [weights[k]])
            c = ab.graph.build_csr()
            al = c["al_off"][1:] - c["al_off"][:-1]
            flags.append(bool(
                c["n"] > cfg.R or c["out_cnt"].max(initial=0) > cfg.E
                or c["in_cnt"].max(initial=0) > cfg.P
                or al.max(initial=0) > cfg.A
                or max(seg, default=0) > cfg.WB // cfg.pn))
    finally:
        engine_np._Ctx = base
    return flags


def run_batch_seed(seed: int, device="cpu") -> str:
    """One batch-mode seed; raises AssertionError on a mismatch."""
    import torch
    from ..parallel.batch import BatchPOA
    from ..params import Params, GLOBAL_MODE, EXTEND_MODE
    rng = np.random.default_rng(888_000 + seed)
    n_shards = int(rng.integers(1, 4))
    if device == "cpu":
        devices = ["cpu"] * n_shards
    else:
        count = torch.cuda.device_count()
        devices = [f"cuda:{i % count}" for i in range(n_shards)]
    n_inst = int(rng.integers(2, 7))
    gaps = GAP_SETS[seed % 3]
    wb = int(rng.integers(5, 30))
    amb = bool(rng.random() < 0.5)
    cap = int(rng.integers(2, 65)) if rng.random() < 0.5 else None
    qv = bool(rng.random() < 0.5)
    sub_p = float(rng.uniform(0.01, 0.15))
    ind_p = float(rng.uniform(0.0, 0.08))
    insts = [_gen_instance(rng, int(rng.integers(40, 300)),
                           int(rng.integers(2, 8)), sub_p, ind_p)
             for _ in range(n_inst)]
    if amb:
        k = int(np.argmax([len(r) for r in insts]))
        r = int(rng.integers(1, len(insts[k])))
        insts[k][r] = _revcomp(insts[k][r])
    weights = ([[rng.integers(1, 60, len(q)).tolist() for q in reads]
                for reads in insts] if qv else None)
    rng2 = np.random.default_rng(889_000 + seed)
    pipeline = bool(rng2.random() < 0.5)
    rounds = bool(rng2.random() < 0.5)
    for _ in range(int(rng2.choice([3, 4, 8, 16])) - len(insts)):
        insts.append(_gen_instance(rng2, int(rng2.integers(40, 150)),
                                   int(rng2.integers(2, 5)), sub_p, ind_p))
        if qv:
            weights.append([rng2.integers(1, 60, len(q)).tolist()
                            for q in insts[-1]])
    params = Params(gap_open1=gaps[0], gap_ext1=gaps[1], gap_open2=gaps[2],
                    gap_ext2=gaps[3], wb=wb, amb_strand=amb,
                    align_mode=EXTEND_MODE if rounds else GLOBAL_MODE
                    ).post_set()
    exp, _abs = _oracle(params, insts, weights)
    bp = BatchPOA(params, devices=devices, pipeline=pipeline)
    bp.s16_cap = cap
    got = bp.run_consensus(insts, weights=weights)
    n = len(insts)
    desc = (f"shards={n_shards} n={n} gaps={gaps} wb={wb} amb={amb} "
            f"cap={cap} qv={qv} pipeline={pipeline} "
            f"path={'rounds' if rounds else 'loop'}")
    assert bp.used_device_loop != rounds, (desc, "the batch took the "
                                           "other path")
    bad = [k for k, (g, e) in enumerate(zip(got, exp)) if g != e]
    assert not bad, (desc, "consensus differs at instances", bad)
    if rounds:
        want = min(BatchPOA.N_SHARDS, n // 4) if pipeline and n >= 4 else 1
        assert len(bp.pipeline_shards) == want, \
            (desc, f"{len(bp.pipeline_shards)} pipeline shards")
        assert bp.fallbacks == 0, (desc, f"{bp.fallbacks} fallbacks")
    elif bp.fallbacks:
        # the loop runs forward-only (the host finishes a -s read's rc
        # retry from its first flagged round), so its graphs are those of
        # the forward-only oracle
        cfg = bp._loop_eligible(insts)
        flagged = sum(_capacity_flags(
            dataclasses.replace(params, amb_strand=False), insts, weights,
            cfg))
        assert bp.fallbacks <= flagged, \
            (desc, f"{bp.fallbacks} fallbacks, {flagged} flagged")
    return f"ok ({desc}, fallbacks {bp.fallbacks})"


ENVELOPE = ("qv", "long", "wide")


def draw_envelope(seed: int):
    """The batch of envelope seed `seed`: (class, params, instances,
    weights or None). The class is ENVELOPE[seed % 3]."""
    from ..params import Params
    rng = np.random.default_rng(666_000 + seed)
    cls = ENVELOPE[seed % 3]
    sub_p = float(rng.uniform(0.01, 0.05))
    ind_p = float(rng.uniform(0.0, 0.03))
    kw = {}
    if cls == "qv":
        n_inst, lo, hi, reads = int(rng.integers(2, 5)), 1900, 2450, (3, 5)
    elif cls == "long":
        n_inst, lo, hi, reads = int(rng.integers(2, 4)), 2600, 3100, (3, 5)
        kw = dict(zip(("gap_open1", "gap_ext1", "gap_open2", "gap_ext2"),
                      GAP_SETS[1 + int(rng.integers(0, 2))]))
    else:
        # w >= 200 and reads past 1,000 bp: pick_WB past 1024 lanes
        n_inst, lo, hi, reads = int(rng.integers(2, 5)), 1000, 1750, (3, 6)
        kw = dict(zip(("gap_open1", "gap_ext1", "gap_open2", "gap_ext2"),
                      GAP_SETS[int(rng.integers(0, 3))]))
        if rng.random() < 0.5:
            kw["wb"] = int(rng.integers(200, 600))
        else:
            kw["wf"] = round(float(rng.uniform(0.2, 0.4)), 2)
    insts = [_gen_instance(rng, int(rng.integers(lo, hi)),
                           int(rng.integers(*reads)), sub_p, ind_p)
             for _ in range(n_inst)]
    weights = ([[rng.integers(1, 60, len(q)).tolist() for q in r]
                for r in insts] if cls == "qv" else None)
    return cls, Params(**kw).post_set(), insts, weights


def run_envelope_seed(seed: int, device="cpu") -> str:
    """One envelope seed; raises AssertionError on a mismatch."""
    from ..ops.band_dp import band_poa_dp_packed
    from ..ops.graph_update import graph_update_packed
    from ..parallel.batch import BatchPOA
    cls, params, insts, weights = draw_envelope(seed)
    exp, _abs = _oracle(params, insts, weights)
    bp = BatchPOA(params, device=device)
    count = {"qv": lambda: graph_update_packed.qv_global_launches,
             "long": lambda: graph_update_packed.global_launches,
             "wide": lambda: band_poa_dp_packed.wide_launches}[cls]
    before = count()
    got = bp.run_consensus(insts, weights=weights)
    cfg = bp._loop_eligible(insts)
    desc = (f"{cls} n={len(insts)} maxlen="
            f"{max(len(q) for r in insts for q in r)} R={cfg.R} "
            f"WB={cfg.WB} wmode={cfg.wmode} gap={params.gap_mode}")
    assert bp.used_device_loop, (desc, "the batch took the round path")
    bad = [k for k, (g, e) in enumerate(zip(got, exp)) if g != e]
    assert not bad, (desc, "consensus differs at instances", bad)
    if bp.fallbacks:
        flagged = sum(_capacity_flags(params, insts, weights, cfg))
        assert bp.fallbacks <= flagged, \
            (desc, f"{bp.fallbacks} fallbacks, {flagged} flagged")
    if device != "cpu":
        assert count() > before, (desc, f"no launch of the {cls} instance")
    return f"ok ({desc}, fallbacks {bp.fallbacks})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m abpoa_tpu_torch.tools.fuzz_device_loop")
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--mode", default="round",
                    choices=("round", "batch", "envelope"))
    ap.add_argument("--keep-going", action="store_true")
    a = ap.parse_args(argv)
    run = {"round": run_round_seed, "batch": run_batch_seed,
           "envelope": run_envelope_seed}[a.mode]
    fails = []
    for seed in range(a.start, a.start + a.n):
        try:
            msg = run(seed, a.device)
        except Exception as e:    # a crash is a finding too
            fails.append(seed)
            kind = "FAIL" if isinstance(e, AssertionError) else "ERROR"
            print(f"seed {seed:4d} {kind} {e!r}", flush=True)
            if not isinstance(e, AssertionError):
                traceback.print_exc()
            if not a.keep_going:
                return 1
            continue
        print(f"seed {seed:4d} {msg}", flush=True)
    if fails:
        print(f"{len(fails)} failures: {fails}")
        return 1
    print(f"campaign clean ({a.mode}, {a.n} seeds)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
