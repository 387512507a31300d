#!/usr/bin/env python3
"""Smoke run of abpoa_tpu_torch, the PyTorch + CUDA port, on one GPU.

    python chip_smoke.py

Phases (each prints its own lines; any failed check exits non-zero):
  1. card   -- nvidia-smi name and power limit; no CUDA -> exit 2
  2. build  -- one nvcc per kernel source of abpoa_tpu_torch/csrc, all
     started together
  3. device-loop kernels vs plain, on the card, at heter.fa's geometry
     (R=1024, WB=384, LS=2176): band DP (node-id mode) and
     graph update against their plain PyTorch versions on real round
     inputs, bit-equal; times of both
  3b. round-path kernels vs plain on real round inputs of 8 rotated
     instances, at the shapes the round path's dispatch picks, bit-equal:
     the topo-mode band DP in extend mode with z-drop (heter.fa) and in
     global protein mode (prot.fa, -c), the full-width DP in local mode
     and in unbanded global mode (heter.fa); times of each
  3c. the banded-tile DP (B5) vs plain on the serial engine's inputs:
     heter.fa round 14 (B=1, global convex), extend mode with z-drop 100
     (B=8), and a tile forced too narrow (M_OVFL); misc, steps, band
     bounds and band state bit-equal (the kernel's tiles are scratch);
     times of each
  3d. B2's wmode-1 instance (qv weights) vs plain on the last round of
     64 x heter.fa with qv weights (rng 77), bit-equal; times
  3e. B3 non-fresh and B4 under the row mask vs plain on a real window
     round of 64 config-5-shaped instances (-S, lockstep), bit-equal;
     times
  4. device loop -- BatchPOA(device="cuda").run_consensus over
     64 x heter.fa: golden consensus bytes, no oracle fallback, every
     round through both kernels (launch counts); e2e seconds, DP cells/s
  4b. qv device loop -- 64 x heter.fa with qv weights: the port's serial
     oracle under the same weights, no fallback, one B1 and one wmode-1
     B2 launch per round and sub-batch; e2e; then -l -Q over 64 x seq.fq
     gives seq_fq_Q_cons.fa 64 times
  4c. loop envelope -- three batches of 16 instances of joined heter.fa
     reads past the shared-memory residency of B2 or past 1024 band
     lanes: qv-long (8 reads of 3 joined 762-769 bp reads, 2,298-2,305
     bp, qv weights: R 2944, B2 wmode 1 with its state in global memory),
     affine-long (6 of 4 joined, 3,066-3,072 bp, affine gaps: R 3840, B2
     wmode 0 in global memory), wide-loop (6 of 2 joined heter.fa reads,
     1,212-1,537 bp, linear gaps, -f 0.2: WB 1536, B1 with four
     positions a thread); each on the device loop
     with no fallback, B1 and B2 and the batch's instance once a round
     and sub-batch, all 16 instances equal to the port's serial oracle;
     e2e median of 3; the new instance against its plain version on the
     batch's last round, bit-equal, with times; B2 at heter64's and
     heter64-qv's last round with the state in global memory against
     shared memory, in turns
  4d. round envelope -- two batches of 16 instances on the round path
     (-m 2, pipelined over 4 shards): wide-extend (6 reads of 2 joined
     heter.fa reads, 1,212-1,537 bp, -f 0.2, default convex gaps: bands
     of 1,408-1,536 lanes, B3 at four lanes a thread) and fan-extend
     (18-30 hub reads of fuzz_ref.hub_reads an instance: B3 at 18-30
     predecessor slots from round 17); each with no fallback, every
     instance equal to the port's serial oracle, one B3 launch per
     round and shard with work, the batch's instance on every round
     that needs it; e2e median of 3; the new instance against its plain
     version on the batch's last round, bit-equal, with times
  5. list mode -- batch_msa_from_files over 4 x heter.fa writes the
     golden bytes 4 times
  6. round path -- run_consensus over 64 x heter.fa with -m 1 (full-width
     kernel) and -m 2 (topo band kernel), in the default mode (the
     host/device pipeline: 4 shards of 16): the consensus of the port's
     serial oracle, no fallback, each shard's launches and rounds equal
     to its plan; e2e seconds, device-phase seconds, DP cells/s
  7. round-path list mode -- 4 x seq.fa with -m 1, -m 2, -b -1 and
     4 x prot.fa with -c give their goldens 4 times; -i seq.gfa equals
     the port's serial output
  8. CLI serial engine on the card -- python -m abpoa_tpu_torch.cli's
     main with default flags on heter.fa, seq.fa -r2, seq.fa -m 1 and
     heter.fa -d2: golden bytes, B5 launched once per read after the
     first on banded runs, B4 once per B5 result re-run there (M_OVFL or
     M_FAIL) and once per read after the first with -m 1; e2e median of 3
  8b. CLI -S, -S -p, -S -n 100 on heter.fa through the serial engine:
     golden bytes, one B4 launch per non-empty window, the oracle only
     for the empty windows
  9. CLI list mode -- -l over 64 x heter.fa: golden bytes 64 times
     through the device loop (one launch of B1 and B2 per round and
     sub-batch)
  10. split device round -- 8 rotated heter.fa instances, every round
     through device_round(split=True) (topo band DP, fusion, the
     standalone Kahn sort B6, remain) and split=False (the packed
     two-kernel round): identical graph state, topo maps and remain; then
     B6 vs plain on each round's state, bit-equal; times
  11. seeded -- run_seeded over N_SEEDED config-5-shaped instances
     (heter.fa reads, instance k trimmed by (k % 5) * 120): each equals
     the port's serial oracle of its trim class, no fallback; e2e median,
     windows/s, DP cells/s
  12. long reads -- 3 reads of 4.7-4.9 kb (heter.fa reads k..k+6
     joined; graphs past 4096 nodes, past the former step word's rows):
     the CLI on the card with default flags, -m 1 and -S gives the port
     oracle's bytes (--engine numpy) with the serial engine's launch
     counts; -l -m 2 over 4 such files runs one B3 launch per round past
     4096 rows, no fallback, the oracle's bytes; e2e of each
  13. shards -- BatchPOA(devices=...) over every visible card, or
     ["cuda:0", "cuda:0"] on one card (each shard on its own stream):
     64 x heter.fa golden with B1 and B2 once a round and sub-batch of
     every shard, -m 1 and -m 2 equal to the serial oracle with the
     plan's kernel once a round on every shard with work, N_SEEDED
     config-5 instances equal to the oracle of their trim class, and
     parallel/dryrun.py's dryrun_multidevice; e2e medians beside the
     single-device ones of phases 4, 6 and 11
  14. processes -- python -m abpoa_tpu_torch.parallel.scaling --procs 2
     --device cuda (two fresh processes, gloo gather on process 0) over
     64 x heter.fa (golden x 64) and --seeded --config5 over 64 instances
     (the serial oracle); the 1-process and 2-process rates
  15. fuzz -- abpoa_tpu_torch/tools/fuzz_device_loop.py on the card: 30
     round-mode seeds, 11 batch-mode seeds, all clean
  16. pipeline -- BatchPOA(pipeline=True) against pipeline=False in one
     call, in turns (lockstep, pipelined, pipelined, lockstep, lockstep,
     pipelined after one checked warm-up each): heter64-local and
     heter64-extend (run_consensus, the serial oracle), seeded-c5
     (N_SEEDED instances, run_seeded: the oracle of each trim class) and
     -l -m 1 over 64 x heter.fa (batch_msa_from_files, the CLI's list
     mode: the serial CLI's bytes 64 times); every run without fallback,
     each shard's launches as its plan implies; e2e medians of 3, device
     busy seconds and launches per shard of each mode
  18. cli fuzz -- abpoa_tpu_torch/tools/fuzz_ref.py on the card: the
     CLI (serial engine, or -l through batch_msa_from_files) against
     its host oracle (--engine numpy) on gen_case seeds 0-199, list
     seeds 0-29 and seeds 0-3 of each shape class (wide, long, hub,
     svmask, fan) serially and under -l: every seed clean, every shape
     reached with its kernel launched, B1-B5 each launched in the
     phase; a line a row with seeds, clean, reached, launches and
     seconds (sized to ~115 s: 300, 40 and 6 seeds took 168.0 s after
     the phases before it, on an NVIDIA H100 80GB HBM3 at 700 W)
  3f. (run last, after the end-to-end phases) B1, B3 and B4 timed at the
     table's shape (B=8), at the B their path launches (B1 32, B3/B4 64,
     B4 1 per -S window), B5 at B=1 on heter.fa round 14, and sweep only
     (bt_lmax = 0); B2 at B=8 (wmode 0), B=64 (wmode 1) and B=32 (both,
     the device loop's sub-batch), B6 at B=8, on the device loop's last
     round; with --baseline DIR, each beside the kernels of the
     earlier checkout in DIR in turns new, old, old, new; B4 on each
     window of a CLI -S run (B=1, its serial path) bit-equal to the plain
     version, mean times a window; the round path's step fetch at
     heter64-extend's last round, as the int16 delta stream (and its host
     decode) and as the int64 words; B3 and B4 also at B=16 (a pipeline
     shard of 64 instances); in 3e, B3 non-fresh on its window round's
     exports repeated to B=128 (a seeded group of 256 instances) and
     B=256 (their lockstep round)
The line before the last is the kernels' JSON record (the window
kernels as band_dp_topo_window: phase 3e's round, and fw_dp_window: the
serial -S windows of 3f, 3e's round under round_B64_* keys, and 3e's
round at B=128 and 256 under round_B128_ms, round_B256_ms; phase 3f's
times as extra keys); the last line is {"ok": true, "device": {...}}.

    python chip_smoke.py --dp-only   # phases 1-3e and 3f, then stop
    python chip_smoke.py --multi-only   # phases 1, 2 and 13-15
    python chip_smoke.py --pipeline-only   # phases 1, 2 and 16
    python chip_smoke.py --fuzz-only   # phases 1, 2 and 18
    python chip_smoke.py --envelope-only   # phases 1, 2 and 4c
    python chip_smoke.py --round-envelope-only   # phases 1, 2 and 4d
    python chip_smoke.py --baseline build/base   # 3f beside that checkout
"""
import io
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
GOLD_SAN = ROOT / "tests" / "golden_sanitized"
HETER = DATA / "heter.fa"
GOLD = GOLD_SAN / "heter_cons.fa"
N_INST = 64      # instances of heter.fa in the slices (the root bench.py's)
N_CMP = 8        # instances in the kernel-vs-plain phases
N_SEEDED = 256   # config-5-shaped instances of the seeded phase (1024
#                  took over 60 s a run on the host's share of the work)
QV_SEED = 77     # seed of the qv weights (integers in [1, 60) per base)
REPS = 3         # timed slice runs after one warm-up
E2E = {}         # single-device e2e medians by cell, for phase 13
FUZZ_SERIAL = 200  # phase 18's seeds: gen_case, list mode, and each
FUZZ_LIST = 30     # shape class and mode
FUZZ_SHAPES = 4



def say(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def reads_of(path, m=5):
    import numpy as np
    from abpoa_tpu_torch.seqio import read_seqs
    from abpoa_tpu_torch.alphabet import encode_table
    tab = encode_table(m)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(path))]


def wrappers():
    """Every kernel wrapper of the port by name; each counts its
    launches in a plain integer attribute."""
    from abpoa_tpu_torch.ops.band_dp import (band_poa_dp_packed,
                                             band_poa_dp_batch)
    from abpoa_tpu_torch.ops.fw_dp import fw_poa_dp_batch
    from abpoa_tpu_torch.ops.graph_update import graph_update_packed
    from abpoa_tpu_torch.ops.tile_dp import tile_poa_dp_batch
    from abpoa_tpu_torch.ops.topo import topo_batch
    return {"band_dp": band_poa_dp_packed,
            "graph_update": graph_update_packed,
            "band_dp_topo": band_poa_dp_batch, "fw_dp": fw_poa_dp_batch,
            "tile_dp": tile_poa_dp_batch, "topo": topo_batch}


def reset_launches():
    for w in wrappers().values():
        w.launches = 0
    gu = wrappers()["graph_update"]
    gu.qv_launches = gu.global_launches = gu.qv_global_launches = 0
    wrappers()["band_dp"].wide_launches = 0
    topo = wrappers()["band_dp_topo"]
    topo.wide_launches = topo.fan_launches = 0


def launches_now():
    return {name: w.launches for name, w in wrappers().items()}


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def cuda_ms(fn, n):
    """Mean device milliseconds of fn() over n calls (CUDA events around
    each call; fn may do untimed set-up first and return the timed
    callable)."""
    import torch
    total = 0.0
    for _ in range(n):
        run = fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / n


def host_ms(fn, n):
    import torch
    total = 0.0
    for _ in range(n):
        run = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total += (time.perf_counter() - t0) * 1e3
    return total / n


def loop_inputs(dev, params, insts, cfg, ws=None):
    """The device loop's inputs for `insts` (read 0 fused on the host,
    per-base weights `ws` in wmode 1): (packed state, scal base, qlen,
    query folds, packed query codes, packed weights or None), the
    per-round ones stacked over the NR rounds."""
    import numpy as np
    import torch
    from abpoa_tpu_torch.graph import NativeGraph, POAGraph
    from abpoa_tpu_torch.ops import poa_loop as pl
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.ops import layout as L
    graphs = []
    for b, reads in enumerate(insts):
        g = NativeGraph() if NativeGraph.available() else POAGraph()
        g.add_graph_alignment(params, reads[0], ws[b][0] if ws else
                              [1] * len(reads[0]), [], None, 0, True)
        g.topological_sort(params)
        graphs.append(g)
    st, i2n, n2i, rem = pl.init_state_np(graphs, cfg)
    ps = pl.pack_state(cfg, pl.GState(*(torch.from_numpy(x).to(dev)
                                        for x in st)),
                       *(torch.from_numpy(x).to(dev) for x in (i2n, n2i, rem)))
    base = torch.from_numpy(pl.make_scal_base(params, cfg)).to(dev)
    qc = np.zeros((cfg.NR, cfg.B, cfg.Wq), np.int8)
    ql = np.zeros((cfg.NR, cfg.B), np.int32)
    qw = np.zeros((cfg.NR, cfg.B, cfg.Wq), np.int32)
    for b, reads in enumerate(insts):
        for r, q in enumerate(reads[1:]):
            qc[r, b, 1:len(q) + 1] = q
            ql[r, b] = len(q)
            if ws:
                qw[r, b, :len(q)] = ws[b][r + 1]
    qc_d = torch.from_numpy(qc).to(dev)
    qpf = bd.build_qpf(pl.band_config(cfg), base[L.S_NSCAL:], qc_d)
    qw2 = pl.pack_qw(cfg, torch.from_numpy(qw).to(dev)) if ws else None
    return (ps, base, torch.from_numpy(ql).to(dev), qpf,
            pl.pack_qp4(cfg, qc_d), qw2)


def kernel_phase(dev, heter):
    """Both device-loop kernels against their plain versions on the
    inputs of real rounds: round 1 (state after read 0) and the last
    round (state after the kernels ran every earlier round, with
    mismatch bundles)."""
    from abpoa_tpu_torch.ops.roofline import OPS_PER_CELL, bound
    import torch
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.ops import poa_loop as pl
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.ops import graph_update as gu
    from abpoa_tpu_torch.ops import layout as L
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    params = Params().post_set()
    insts = [heter[b:] + heter[:b] for b in range(N_CMP)]
    cfg = _loop_geometry(params, insts)._replace(B=N_CMP)
    say(f"geometry: R={cfg.R} WB={cfg.WB} Wq={cfg.Wq} LS={cfg.LS} "
        f"NR={cfg.NR} pn={cfg.pn} inf_min={cfg.inf_min} B={cfg.B}")
    ps, base, ql_d, qpf, qp4, _ = loop_inputs(dev, params, insts, cfg)
    bc = pl.band_config(cfg)
    wf1000 = round(params.wf * 1000)
    rec = {"band_dp": {"max_abs_err": 0}, "graph_update": {"max_abs_err": 0}}
    for r in (0, cfg.NR - 1):
        if r:
            # bring the state to the last round through the kernels
            for rr in range(1, r):
                ps, _, _ = pl.device_round_packed(
                    cfg, ps, ql_d[rr], qpf[rr], qp4[rr], base, params.wb,
                    wf1000)
        scal = pl.build_scal(cfg, ps, ql_d[r], base, params.wb, wf1000)
        args = (bc, scal, ps.ctrl, ps.inp, ps.i2nn, qpf[r])
        km, ks = bd.band_poa_dp_packed(*args)
        rm, rs = bd.band_poa_dp_packed_ref(*args)
        torch.cuda.synchronize()
        check(not rm[:, L.M_OVFL].any() and not rm[:, L.M_FAIL].any(),
              f"round {r}: plain DP overflow/fail {rm.tolist()}")
        dm = (km - rm).abs().max().item()
        k16, r16 = pl.s16w_to_s16(ks), pl.s16w_to_s16(rs)
        for b in range(cfg.B):
            n = int(rm[b, L.M_NSTEPS])
            d = (k16[b, :n].int() - r16[b, :n].int()).abs().max().item() \
                if n else 0
            dm = max(dm, d)
        rec["band_dp"]["max_abs_err"] = max(rec["band_dp"]["max_abs_err"],
                                            dm)
        check(dm == 0, f"round {r}: band DP kernel != plain (max |d| {dm})")
        say(f"kernels: round {r + 1} band_dp == plain (misc + "
            f"{int(rm[:, L.M_NSTEPS].sum())} steps)")

        ps_k = pl.PackedState(*(x.clone() for x in ps))
        gk = gu.graph_update_packed(cfg, ps_k, ks, km, ql_d[r], qp4[r])
        gr = gu.graph_update_packed_ref(cfg, ps, rs, rm, ql_d[r], qp4[r])
        torch.cuda.synchronize()
        check(not gr.fail.any() and torch.equal(gk.fail, gr.fail),
              f"round {r}: fail flags {gk.fail.tolist()} {gr.fail.tolist()}")
        check(torch.equal(gk.node_n, gr.node_n), f"round {r}: node_n")
        sk, i2k, n2k, remk = pl.unpack_state(cfg, gk)
        sr, i2r, n2r, remr = pl.unpack_state(cfg, gr)
        dm = 0
        for a, b_ in zip(sk, sr):
            dm = max(dm, (a - b_).abs().max().item())
        live = (torch.arange(cfg.R, device=dev)[None, :]
                < gr.node_n[:, None])
        for a, b_ in ((i2k, i2r), (n2k, n2r), (remk, remr)):
            dm = max(dm, ((a - b_).abs() * live).max().item())
        rec["graph_update"]["max_abs_err"] = max(
            rec["graph_update"]["max_abs_err"], dm)
        check(dm == 0, f"round {r}: graph kernel != plain (max |d| {dm})")
        say(f"kernels: round {r + 1} graph_update == plain "
            f"(node_n {gr.node_n.tolist()})")
        if r == cfg.NR - 1:
            rec["band_dp"]["ms"] = cuda_ms(
                lambda: (lambda: bd.band_poa_dp_packed(*args)), 20)
            rec["band_dp"]["plain_ms"] = host_ms(
                lambda: (lambda: bd.band_poa_dp_packed_ref(*args)), 1)
            cells = int(km[:, L.M_CELLS].sum())
            rec["band_dp"]["bound_ms"], rec["band_dp"]["bound_by"] = bound(
                nbytes(scal[:, :L.S_NSCAL], ps.ctrl, ps.inp, ps.i2nn,
                       qpf[r], km, ks),
                cells * OPS_PER_CELL[params.gap_mode])

            def fresh_kernel():
                c = pl.PackedState(*(x.clone() for x in ps))
                return lambda: gu.graph_update_packed(cfg, c, ks, km,
                                                      ql_d[r], qp4[r])
            rec["graph_update"]["ms"] = cuda_ms(fresh_kernel, 20)
            rec["graph_update"]["plain_ms"] = host_ms(
                lambda: (lambda: gu.graph_update_packed_ref(
                    cfg, ps, rs, rm, ql_d[r], qp4[r])), 1)
            # fusion: one pass over the step stream; sort and remain: one
            # visit of every node's in- and out-edge slots
            ops = (int(km[:, L.M_NSTEPS].sum())
                   + int(gr.node_n.sum()) * (cfg.E + cfg.P))
            rec["graph_update"]["bound_ms"], \
                rec["graph_update"]["bound_by"] = bound(
                    2 * nbytes(*ps) + nbytes(ks, km, ql_d[r], qp4[r]), ops)
        ps = gk
    for name in ("band_dp", "graph_update"):
        t = rec[name]
        say(f"time: {name} kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}) (B={cfg.B}, round {cfg.NR})")
    return rec


def round_exports(params, insts, k):
    """The exports of round k (read k against the oracle-fused graph of
    reads < k) of each instance, re-padded to one geometry."""
    from abpoa_tpu_torch.align.engine_np import align_sequence_to_subgraph
    from abpoa_tpu_torch.align.export import export_dense, repad_dense
    from abpoa_tpu_torch.graph import NativeGraph, POAGraph
    from abpoa_tpu_torch.params import SRC_NODE_ID, SINK_NODE_ID
    dgs = []
    for reads in insts:
        if NativeGraph.available():
            g = NativeGraph()
            g.ensure_reads(k)
        else:
            g = POAGraph()
        for r, q in enumerate(reads[:k]):
            cig = []
            if g.node_n > 2:
                if not g.is_topological_sorted:
                    g.topological_sort(params)
                cig = align_sequence_to_subgraph(g, params, SRC_NODE_ID,
                                                 SINK_NODE_ID, q).cigar
            g.add_graph_alignment(params, q, [1] * len(q), cig, None, r,
                                  True)
        g.topological_sort(params)
        dgs.append(export_dense(g, params, reads[k]))
    R = max(d.R for d in dgs)
    W = max(d.W for d in dgs)
    P = max(d.P for d in dgs)
    O = max(d.O for d in dgs)
    return [repad_dense(d, R, W, P, O) for d in dgs]


def round_inputs(dev, params, insts, k):
    """The round path's plan and stacked inputs of round k of each
    instance."""
    from abpoa_tpu_torch.parallel.batch import round_plan
    dgs = round_exports(params, insts, k)
    plan = round_plan(params, dgs, dev)
    return plan, plan.stack(slice(None), dev), [d.n_rows for d in dgs]


def round_kernel_phase(dev, heter):
    """B3 (topo band) and B4 (full width) against their plain versions on
    the round path's inputs of real rounds."""
    from abpoa_tpu_torch.ops.roofline import OPS_PER_CELL, bound
    import torch
    from abpoa_tpu_torch.params import (Params, LOCAL_MODE, EXTEND_MODE)
    from abpoa_tpu_torch.ops import band_dp as bd, fw_dp as fw
    from abpoa_tpu_torch.ops import layout as L

    def mk(**kw):
        p = Params()
        for key, v in kw.items():
            setattr(p, key, v)
        return p.post_set()
    rot = [heter[b:] + heter[:b] for b in range(N_CMP)]
    prot = reads_of(DATA / "prot.fa", 27)
    prot_rot = [prot[b % len(prot):] + prot[:b % len(prot)]
                for b in range(N_CMP)]
    cases = [("band_dp_topo", "extend, z-drop 100, heter",
              mk(align_mode=EXTEND_MODE, zdrop=100), rot, 4),
             ("band_dp_topo", "global protein -c, prot", mk(m=27),
              prot_rot, 2),
             ("fw_dp", "local -m 1, heter", mk(align_mode=LOCAL_MODE),
              rot, 4),
             ("fw_dp", "global -b -1, heter", mk(wb=-1), rot, 4)]
    rec = {"band_dp_topo": {"max_abs_err": 0}, "fw_dp": {"max_abs_err": 0}}
    for name, what, params, insts, k in cases:
        plan, args, nrows = round_inputs(dev, params, insts, k)
        check(plan.name == name, f"{what}: dispatch picked {plan.name}")
        ref = (bd.band_poa_dp_batch_ref if plan.band
               else fw.fw_poa_dp_batch_ref)
        out = plan.kernel(plan.cfg, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp = ref(plan.cfg, *args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        dm = (out.misc[:, :L.M_LASTI] - exp.misc[:, :L.M_LASTI]).abs().max()
        dm = int(dm)
        fields = ["steps"] + (["steps16"] if plan.band else [])
        for b, n in enumerate(nrows):
            ns = int(exp.misc[b, L.M_NSTEPS])
            for f in fields:
                d = (getattr(out, f)[b, :ns].int()
                     - getattr(exp, f)[b, :ns].int()).abs()
                dm = max(dm, int(d.max()) if ns else 0)
            for f in ("beg_sn", "end_sn", "mpl", "mpr"):
                d = (getattr(out, f)[b, :n] - getattr(exp, f)[b, :n]).abs()
                dm = max(dm, int(d.max()))
        check(dm == 0, f"{what}: {name} kernel != plain (max |d| {dm})")
        check(not exp.misc[:, L.M_FAIL].any(), f"{what}: walk failed")
        ms = cuda_ms(lambda: (lambda: plan.kernel(plan.cfg, *args)), 20)
        cells = int(exp.misc[:, L.M_CELLS].sum())
        outs = [t for t in out if isinstance(t, torch.Tensor)]
        bms, bby = bound(nbytes(*args, *outs),
                         cells * OPS_PER_CELL[params.gap_mode])
        say(f"kernels: {name} == plain ({what}; B={len(insts)}, "
            f"R={plan.cfg.R}, "
            f"{'WB=%d' % plan.cfg.WB if plan.band else 'Wq=%d' % plan.cfg.Wq}"
            f", {int(exp.misc[:, L.M_NSTEPS].sum())} steps, {cells} cells): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bms:.6f} ms ({bby})")
        r = rec[name]
        r["max_abs_err"] = max(r["max_abs_err"], dm)
        if "ms" not in r:      # the first case of each kernel is recorded
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby)
    return rec


def serial_consensus(params, path):
    """The port's serial oracle consensus of one input file (CPU)."""
    import dataclasses
    from abpoa_tpu_torch.api import ABPOA
    out = io.StringIO()
    ABPOA().msa_from_file(dataclasses.replace(params, engine="numpy"),
                          str(path), out)
    return out.getvalue().split("\n")[1]


def round_shard_plan(bp, insts, name, entries=1):
    """What each pipeline shard of a round-path run of `insts` must
    record (alike instances: one score width and one memory chunk a
    round): from 4 instances with the pipeline on, S = min(N_SHARDS, n //
    4) shards, instance k in shard k % S, each counting its rounds from
    read 0; else one lockstep shard counting its DP rounds. Every DP
    round launches `name` once on each of `entries` device entries with
    work."""
    n = len(insts)
    piped = bp.pipeline and n >= 4
    S = min(bp.N_SHARDS, max(1, n // 4)) if piped else 1
    want = []
    for s in range(S):
        mine = insts[s::S]
        nr = max(len(i) for i in mine)
        dp = sum(min(entries, sum(len(i) > r for i in mine))
                 for r in range(1, nr))
        want.append({"instances": len(mine),
                     "rounds": nr if piped else nr - 1,
                     "launches": {k: dp * (k == name) for k in bp.launches}})
    return want


def mode_of(bp):
    n = len(bp.pipeline_shards)
    return (f"pipelined, {n} shards" if bp.pipeline and n > 1 else
            "lockstep" if not bp.pipeline else "pipeline on, one shard")


def round_path_phase(dev, heter, n_inst=N_INST):
    """64 x heter.fa through the round path in local and extend mode."""
    import torch
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.params import Params, LOCAL_MODE, EXTEND_MODE
    launches = {}
    for flag, mode, name in (("-m 1", LOCAL_MODE, "fw_dp"),
                             ("-m 2", EXTEND_MODE, "band_dp_topo")):
        def params():
            p = Params()
            p.align_mode = mode
            return p.post_set()
        exp = serial_consensus(params(), HETER)
        bp = BatchPOA(params(), device=dev)
        reset_launches()
        t0 = time.perf_counter()
        cons = bp.run_consensus([heter] * n_inst)
        first_s = time.perf_counter() - t0
        got = launches_now()
        launches[name] = got[name]
        check(all(c == [exp] for c in cons),
              f"round path {flag}: consensus != serial oracle")
        check(not bp.used_device_loop, f"round path {flag}: device loop")
        check(bp.fallbacks == 0, f"round path {flag}: {bp.fallbacks} "
              "oracle fallbacks")
        # the instances are alike: one score-width group and one memory
        # chunk per shard round, so one launch of the planned kernel per
        # shard round after read 0
        want = round_shard_plan(bp, [heter] * n_inst, name)
        plan = {k: sum(w["launches"][k] for w in want) for k in bp.launches}
        round_got = {k: got[k] for k in bp.launches}
        check(bp.pipeline_shards == want and round_got == bp.launches
              == plan and bp.rounds == sum(w["rounds"] for w in want)
              and got["band_dp"] == 0 and got["graph_update"] == 0,
              f"round path {flag} ({mode_of(bp)}): launches {got}, "
              f"dispatch plan {bp.launches}, rounds {bp.rounds}, shards "
              f"{bp.pipeline_shards}, expected {want}")
        say(f"round path {flag} ({mode_of(bp)}): {n_inst} x heter.fa == "
            f"serial oracle consensus, fallbacks 0, rounds {bp.rounds} "
            f"{[w['rounds'] for w in want]}, launches {round_got} == "
            f"dispatch plan {bp.launches} == shard plans "
            f"{[w['launches'][name] for w in want]} (device-loop kernels "
            f"0), first run {first_s:.4f} s")
        e2e, busy = [], []
        for _ in range(REPS):
            bp = BatchPOA(params(), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cons = bp.run_consensus([heter] * n_inst)
            torch.cuda.synchronize()
            e2e.append(time.perf_counter() - t0)
            busy.append(bp.dp_busy_seconds())
            check(all(c == [exp] for c in cons) and bp.fallbacks == 0,
                  f"round path {flag}: timed run != serial oracle")
        med = statistics.median(e2e)
        E2E[f"heter64 {flag}"] = med
        say(f"round path {flag}: e2e {med:.4f} s median of {REPS} "
            f"{[round(x, 4) for x in e2e]}, device phases (upload, kernel, "
            f"fetch) {statistics.median(busy):.4f} s, host (sort, export, "
            f"fusion, consensus) {med - statistics.median(busy):.4f} s, "
            f"dp_cells {bp.dp_cells}, dp_cells/s {bp.dp_cells / med:.1f}")
    return launches


def round_list_phase(dev):
    from abpoa_tpu_torch import batch_msa_from_files
    from abpoa_tpu_torch.api import ABPOA
    from abpoa_tpu_torch.params import Params, LOCAL_MODE, EXTEND_MODE
    seq = str(DATA / "seq.fa")
    for flag, kw, golden, fn in (
            ("-m 1", {"align_mode": LOCAL_MODE}, "seq_cons_local.fa", seq),
            ("-m 2", {"align_mode": EXTEND_MODE}, "seq_cons_ext.fa", seq),
            ("-b -1", {"wb": -1}, "seq_cons_noband.fa", seq),
            ("-c", {"m": 27}, "prot_cons.fa", str(DATA / "prot.fa"))):
        p = Params()
        for key, v in kw.items():
            setattr(p, key, v)
        p.post_set()
        out = io.StringIO()
        batch_msa_from_files(p, [fn] * 4, out, device=dev)
        check(out.getvalue() == (GOLD_SAN / golden).read_text() * 4,
              f"list mode {flag} != golden")
        say(f"list mode {flag}: 4 x {pathlib.Path(fn).name} golden bytes")
    p = Params()
    p.incr_fn = str(GOLD_SAN / "seq.gfa")
    p.out_cons, p.out_gfa = False, True
    p.post_set()
    serial = io.StringIO()
    for _ in range(4):
        ABPOA().msa_from_file(p, seq, serial)
    out = io.StringIO()
    batch_msa_from_files(p, [seq] * 4, out, device=dev)
    check(out.getvalue() == serial.getvalue(),
          "list mode -i != the port's serial output")
    say("list mode -i seq.gfa -r3: 4 x seq.fa == serial output")


def tile_inputs(params, insts, k, WB=None):
    """The serial engine's B5 inputs of round k of each instance
    (align/engine_torch.py: export_dense, pick_WB, make_pallas_inputs
    with the walk bound), stacked over the instances."""
    import numpy as np
    from abpoa_tpu_torch.align.export import make_pallas_inputs, pick_WB
    dgs = round_exports(params, insts, k)
    Wq = max((d.qlen // 128 + 1) * 128 for d in dgs)
    lmax = (dgs[0].R + Wq + 511) // 512 * 512
    WB = WB or max(pick_WB(params, d.qlen, d.pn) for d in dgs)
    made = [make_pallas_inputs(d, params, WB, force_Wq=Wq, bt_lmax=lmax)
            for d in dgs]
    arrs = [np.stack([m[1][i] for m in made]) for i in range(10)]
    return made[0][0], arrs, [d.n_rows for d in dgs]


def tile_kernel_phase(dev, heter):
    """B5 against its plain version on the serial engine's inputs."""
    from abpoa_tpu_torch.ops.roofline import OPS_PER_CELL, bound
    import torch
    from abpoa_tpu_torch.params import Params, EXTEND_MODE
    from abpoa_tpu_torch.ops import tile_dp as td
    from abpoa_tpu_torch.ops import layout as L

    def mk(**kw):
        p = Params()
        for key, v in kw.items():
            setattr(p, key, v)
        return p.post_set()
    rot = [heter[b:] + heter[:b] for b in range(N_CMP)]
    last = len(heter) - 1
    cases = [("global convex, heter round 14, B=1", mk(), [heter], last,
              None),
             ("extend, z-drop 100, heter round 4, B=8",
              mk(align_mode=EXTEND_MODE, zdrop=100), rot, 4, None),
             ("tile forced to 2 segments (M_OVFL), heter round 14, B=1",
              mk(), [heter], last, 64)]
    rec = {"max_abs_err": 0}
    for what, params, insts, k, WB in cases:
        cfg, arrs, nrows = tile_inputs(params, insts, k, WB)
        args = [torch.from_numpy(a).to(dev) for a in arrs]
        out = td.tile_poa_dp_batch(cfg, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp = td.tile_poa_dp_batch_ref(cfg, *args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        dm = int((out.misc[:, :L.M_LASTI]
                  - exp.misc[:, :L.M_LASTI]).abs().max())
        for b in range(len(insts)):
            ns = int(exp.misc[b, L.M_NSTEPS])
            if ns:
                dm = max(dm, int((out.steps[b, :ns]
                                  - exp.steps[b, :ns]).abs().max()))
        for f in ("beg_sn", "end_sn", "mpl", "mpr"):
            dm = max(dm, int((getattr(out, f)
                              - getattr(exp, f)).abs().max()))
        ovfl = int(exp.misc[:, L.M_OVFL].sum())
        check(dm == 0, f"{what}: tile_dp kernel != plain (max |d| {dm})")
        check((ovfl > 0) == (WB is not None),
              f"{what}: {ovfl} overflow results")
        check(WB is not None or not exp.misc[:, L.M_FAIL].any(),
              f"{what}: walk failed")
        ms = cuda_ms(lambda: (lambda: td.tile_poa_dp_batch(cfg, *args)), 20)
        cells = int(exp.misc[:, L.M_CELLS].sum())
        # the outputs callers read: the tiles are the kernel's scratch
        bms, bby = bound(nbytes(*args, out.beg_sn, out.end_sn, out.mpl,
                                out.mpr, out.misc, out.steps),
                         cells * OPS_PER_CELL[params.gap_mode])
        say(f"kernels: tile_dp == plain ({what}; R={cfg.R}, WB={cfg.WB}, "
            f"{int(exp.misc[:, L.M_NSTEPS].sum())} steps, {cells} cells, "
            f"M_OVFL {ovfl}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bms:.6f} ms ({bby})")
        rec["max_abs_err"] = max(rec["max_abs_err"], dm)
        if "ms" not in rec:    # the serial engine's own case is recorded
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby)
    return {"tile_dp": rec}


def run_cli(args):
    """(stdout, stderr) of the port's CLI main, in this process."""
    import contextlib
    from abpoa_tpu_torch.cli import main
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(args))
    check(rc == 0, f"CLI {args}: exit {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue()


def cli_serial_phase(n_reads):
    """The CLI's default (card) run of single files: golden bytes, the
    serial engine's launches: every align call on a kernel."""
    import torch
    from abpoa_tpu_torch.align import engine_torch
    seq = str(DATA / "seq.fa")
    n_seq = len(reads_of(DATA / "seq.fa"))
    cases = [("heter.fa", [str(HETER)], "heter_cons.fa", n_reads, True),
             ("seq.fa -r2", ["-r2", seq], "seq_cons_msa.out", n_seq, True),
             ("seq.fa -m 1", ["-m", "1", seq], "seq_cons_local.fa", n_seq,
              False),
             ("heter.fa -d2", ["-d2", str(HETER)], "heter_d2_cons.fa",
              n_reads, True)]
    launches = None
    for what, args, golden, n, banded in cases:
        reset_launches()
        engine_torch.reroutes.update(M_OVFL=0, M_FAIL=0)
        out, _err = run_cli(args)
        got = launches_now()
        if launches is None:
            launches = got["tile_dp"]
        check(out == (GOLD_SAN / golden).read_text(),
              f"CLI {what}: output != {golden}")
        rerun = dict(engine_torch.reroutes)
        want = {"tile_dp": n - 1 if banded else 0,
                "fw_dp": sum(rerun.values()) if banded else n - 1}
        check({k: got[k] for k in want} == want,
              f"CLI {what}: launches {got}, expected {want} (B5 re-run on "
              f"B4: {rerun})")
        say(f"CLI {what}: {golden} bytes, launches {want} (B5 re-run on "
            f"B4: {rerun})")
    e2e = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _err = run_cli([str(HETER)])
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
        check(out == GOLD.read_text(), "CLI heter.fa: timed run != golden")
    say(f"CLI heter.fa (serial engine): e2e {statistics.median(e2e):.4f} s "
        f"median of {REPS} {[round(x, 4) for x in e2e]}")
    return launches


def cli_list_phase(n_reads):
    """-l over N_INST x heter.fa: the device loop through the CLI."""
    from abpoa_tpu_torch.parallel.batch import SPLIT_MIN
    lst = ROOT / "build" / "abpoa_tpu_torch" / "heter_list.txt"
    lst.parent.mkdir(parents=True, exist_ok=True)
    lst.write_text(f"{HETER}\n" * N_INST)
    reset_launches()
    t0 = time.perf_counter()
    out, _err = run_cli(["-l", str(lst)])
    secs = time.perf_counter() - t0
    got = launches_now()
    n_sub = 2 if N_INST >= SPLIT_MIN else 1
    check(out == GOLD.read_text() * N_INST, "CLI -l: output != golden")
    want = (n_reads - 1) * n_sub
    check(got["band_dp"] == got["graph_update"] == want
          and got["tile_dp"] == 0,
          f"CLI -l: launches {got}, expected {want} of B1 and B2")
    say(f"CLI -l {N_INST} x heter.fa: golden bytes {N_INST} times, "
        f"launches B1 {got['band_dp']}, B2 {got['graph_update']}, "
        f"{secs:.4f} s")


def split_round_phase(dev, heter):
    """Every round of N_CMP rotated heter.fa instances through the split
    and the packed device round; then B6 against its plain version."""
    from abpoa_tpu_torch.ops.roofline import bound
    import numpy as np
    import torch
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.graph import NativeGraph, POAGraph
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.ops import poa_loop as pl
    from abpoa_tpu_torch.ops import topo as tt
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    params = Params().post_set()
    insts = [heter[b:] + heter[:b] for b in range(N_CMP)]
    cfg = _loop_geometry(params, insts)._replace(B=N_CMP)
    graphs = []
    for reads in insts:
        g = NativeGraph() if NativeGraph.available() else POAGraph()
        g.add_graph_alignment(params, reads[0], [1] * len(reads[0]), [],
                              None, 0, True)
        g.topological_sort(params)
        graphs.append(g)
    init = pl.init_state_np(graphs, cfg)
    state = {s: convert.loop_inputs(*init, dev) for s in (True, False)}
    base = torch.from_numpy(pl.make_scal_base(params, cfg)).to(dev)
    wf1000 = round(params.wf * 1000)
    reset_launches()
    fused = []
    for r in range(cfg.NR):
        qc = np.zeros((cfg.B, cfg.Wq), np.int8)
        ql = np.zeros(cfg.B, np.int32)
        for b, reads in enumerate(insts):
            qc[b, 1:len(reads[r + 1]) + 1] = reads[r + 1]
            ql[b] = len(reads[r + 1])
        qc_d, ql_d = torch.from_numpy(qc).to(dev), torch.from_numpy(ql).to(dev)
        for split in (True, False):
            st, i2n, n2i, rem = state[split]
            state[split] = pl.device_round(cfg, st, i2n, n2i, rem, qc_d,
                                           ql_d, base, params.wb, wf1000,
                                           split=split)[:4]
        (s_st, s_i2n, s_n2i, s_rem), (p_st, p_i2n, p_n2i, p_rem) = \
            state[True], state[False]
        check(not s_st.fail.any() and not p_st.fail.any(),
              f"split round {r + 1}: fail {s_st.fail.tolist()} "
              f"{p_st.fail.tolist()}")
        for f in s_st._fields:
            check(torch.equal(getattr(s_st, f).int(), getattr(p_st, f).int()),
                  f"split round {r + 1}: {f} differs")
        live = (torch.arange(cfg.R, device=dev)[None, :]
                < s_st.node_n[:, None])
        for what, a, b in (("i2n", s_i2n, p_i2n), ("n2i", s_n2i, p_n2i),
                           ("remain", s_rem, p_rem)):
            check(torch.equal(a.int() * live, b.int() * live),
                  f"split round {r + 1}: {what} differs")
        fused.append(s_st)
    launches = launches_now()
    check(launches["topo"] == cfg.NR and launches["band_dp_topo"] == cfg.NR
          and launches["band_dp"] == launches["graph_update"] == cfg.NR,
          f"split rounds: launches {launches}")
    say(f"split round: {cfg.NR} rounds x {cfg.B} instances, split == "
        f"packed (state, topo maps, remain); launches {launches}")
    # B6 against its plain version on each round's fused state
    rec = {"max_abs_err": 0}
    for r, st in enumerate(fused):
        k = tt.topo_batch(cfg, st)
        e = tt.topo_batch_ref(cfg, st)
        torch.cuda.synchronize()
        dm = max(int((a.int() - b.int()).abs().max()) for a, b in zip(k, e))
        check(dm == 0 and bool(e[2].all()),
              f"round {r + 1}: topo kernel != plain (max |d| {dm})")
        rec["max_abs_err"] = max(rec["max_abs_err"], dm)
    st = fused[-1]
    rec["ms"] = cuda_ms(lambda: (lambda: tt.topo_batch(cfg, st)), 20)
    rec["plain_ms"] = host_ms(lambda: (lambda: tt.topo_batch_ref(cfg, st)),
                              1)
    # one pop per node, one visit of each out-edge and aligned slot
    live = (torch.arange(cfg.R, device=dev)[None, :] < st.node_n[:, None])
    ops = int(st.node_n.sum()) + int(((st.n_out + st.n_al) * live).sum())
    k = tt.topo_batch(cfg, st)
    rec["bound_ms"], rec["bound_by"] = bound(
        nbytes(st.out_ids, st.n_out, st.al_ids, st.n_al, st.n_in,
               st.node_n, st.fail) + nbytes(*k), ops)
    say(f"kernels: topo == plain on {cfg.NR} rounds (B={cfg.B}, "
        f"R={cfg.R}): kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms "
        f"({rec['bound_by']})")
    return {"topo": rec}, launches["topo"]


def qv_weights(instances):
    """The qv weights of a batch: numpy.random.default_rng(77).integers(
    1, 60, len(q)) for each read, in instance order."""
    import numpy as np
    rng = np.random.default_rng(QV_SEED)
    return [[rng.integers(1, 60, len(q)).tolist() for q in reads]
            for reads in instances]


def qv_kernel_phase(dev, heter):
    """B2's wmode-1 instance against its plain version on the last round
    of the 64 x heter.fa qv batch (the state brought there through both
    kernels)."""
    from abpoa_tpu_torch.ops.roofline import bound
    import torch
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.ops import poa_loop as pl
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.ops import graph_update as gu
    from abpoa_tpu_torch.ops import layout as L
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    params = Params().post_set()
    insts = [heter] * N_INST
    ws = qv_weights(insts)
    wmax = max(sum(max(w) for w in wk) for wk in ws)
    cfg = _loop_geometry(params, insts, wmax)._replace(B=N_INST)
    check(cfg.wmode == 1, f"qv geometry: wmode {cfg.wmode}")
    say(f"qv geometry: R={cfg.R} E={cfg.E} Wq={cfg.Wq} wmode=1 wmax={wmax} "
        f"graph-kernel shared memory {gu.smem_bytes(cfg)} bytes "
        f"(unit weights {gu.smem_bytes(cfg._replace(wmode=0))})")
    ps, base, ql_d, qpf, qp4, qw2 = loop_inputs(dev, params, insts, cfg, ws)
    bc = pl.band_config(cfg)
    wf1000 = round(params.wf * 1000)
    r = cfg.NR - 1
    for rr in range(r):
        ps, _, _ = pl.device_round_packed(cfg, ps, ql_d[rr], qpf[rr],
                                          qp4[rr], base, params.wb, wf1000,
                                          qw=qw2[rr])
    scal = pl.build_scal(cfg, ps, ql_d[r], base, params.wb, wf1000)
    km, ks = bd.band_poa_dp_packed(bc, scal, ps.ctrl, ps.inp, ps.i2nn, qpf[r])
    args = (ks, km, ql_d[r], qp4[r])
    gk = gu.graph_update_packed(
        cfg, pl.PackedState(*(x.clone() for x in ps)), *args, qw=qw2[r])
    gr = gu.graph_update_packed_ref(cfg, ps, *args, qw=qw2[r])
    torch.cuda.synchronize()
    check(not gr.fail.any() and torch.equal(gk.fail, gr.fail),
          f"qv round {r + 1}: fail flags {gk.fail.tolist()} "
          f"{gr.fail.tolist()}")
    check(torch.equal(gk.node_n, gr.node_n), f"qv round {r + 1}: node_n")
    sk, i2k, n2k, remk = pl.unpack_state(cfg, gk)
    sr, i2r, n2r, remr = pl.unpack_state(cfg, gr)
    dm = max((a - b_).abs().max().item() for a, b_ in zip(sk, sr))
    live = torch.arange(cfg.R, device=dev)[None, :] < gr.node_n[:, None]
    for a, b_ in ((i2k, i2r), (n2k, n2r), (remk, remr)):
        dm = max(dm, ((a - b_).abs() * live).max().item())
    check(dm == 0, f"qv round {r + 1}: graph kernel (wmode 1) != plain "
          f"(max |d| {dm})")
    rec = {"max_abs_err": dm}

    def fresh_kernel():
        c = pl.PackedState(*(x.clone() for x in ps))
        return lambda: gu.graph_update_packed(cfg, c, *args, qw=qw2[r])
    rec["ms"] = cuda_ms(fresh_kernel, 20)
    rec["plain_ms"] = host_ms(lambda: (lambda: gu.graph_update_packed_ref(
        cfg, ps, *args, qw=qw2[r])), 1)
    ops = (int(km[:, L.M_NSTEPS].sum())
           + int(gr.node_n.sum()) * (cfg.E + cfg.P))
    rec["bound_ms"], rec["bound_by"] = bound(
        2 * nbytes(*ps) + nbytes(*args, qw2[r]), ops)
    say(f"kernels: graph_update (wmode 1) == plain on round {r + 1} of "
        f"{N_INST} x heter.fa with qv weights (node_n max "
        f"{int(gr.node_n.max())}, max edge weight {int(sr.out_w.max())}): "
        f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    return {"graph_update_qv": rec}


def weighted_oracle(params, insts, ws):
    """The port's serial oracle consensus per instance under weights."""
    import dataclasses
    from abpoa_tpu_torch.api import ABPOA
    from abpoa_tpu_torch.consensus import generate_consensus
    from abpoa_tpu_torch.alphabet import decode_table
    p = dataclasses.replace(params, engine="numpy")
    dt = decode_table(p.m)
    out = []
    for reads, w in zip(insts, ws):
        ab = ABPOA()
        ab.n_seq, ab.names, ab.is_rc = len(reads), [""] * len(reads), \
            [0] * len(reads)
        ab.poa(p, reads, w, 0)
        generate_consensus(ab, p)
        out.append([bytes(dt[b] for b in s).decode()
                    for s in ab.cons.cons_base[:ab.cons.n_cons]])
    return out


def qv_loop_phase(dev, heter):
    """64 x heter.fa with qv weights through the device loop (wmode 1):
    the serial oracle's consensus under the same weights, no fallback,
    one launch of B1 and of B2's wmode-1 instance per round and
    sub-batch; e2e median of REPS. Then -l -Q over 64 x seq.fq."""
    import torch
    from abpoa_tpu_torch import BatchPOA, batch_msa_from_files
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.parallel.batch import SPLIT_MIN
    from abpoa_tpu_torch.ops.graph_update import graph_update_packed
    insts = [heter] * N_INST
    ws = qv_weights(insts)
    exp = weighted_oracle(Params().post_set(), insts, ws)
    n_sub = 2 if N_INST >= SPLIT_MIN else 1
    want = (len(heter) - 1) * n_sub
    e2e = []
    for rep in range(REPS + 1):
        bp = BatchPOA(Params().post_set(), device=dev)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cons = bp.run_consensus(insts, weights=ws)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = launches_now()
        check(cons == exp, "qv loop: consensus != serial oracle")
        check(bp.used_device_loop and bp.fallbacks == 0,
              f"qv loop: device loop {bp.used_device_loop}, fallbacks "
              f"{bp.fallbacks}")
        check(got["band_dp"] == got["graph_update"] == want
              and graph_update_packed.qv_launches == want
              and got["band_dp_topo"] == got["fw_dp"] == got["tile_dp"] == 0,
              f"qv loop: launches {got}, wmode-1 "
              f"{graph_update_packed.qv_launches}, expected {want}")
        if rep == 0:
            launches = graph_update_packed.qv_launches
            say(f"qv loop: {N_INST} x heter.fa (rng 77 weights) == serial "
                f"oracle, fallbacks 0, launches B1 {got['band_dp']}, B2 "
                f"wmode 1 {launches}, first run {secs:.4f} s")
        else:
            e2e.append(secs)
    med = statistics.median(e2e)
    say(f"qv loop: e2e {med:.4f} s median of {REPS} "
        f"{[round(x, 4) for x in e2e]}, device-loop phase "
        f"{bp.dp_busy_seconds():.4f} s, dp_cells {bp.dp_cells}, dp_cells/s "
        f"{bp.dp_cells / med:.1f}")
    p = Params()
    p.use_qv = True
    p.post_set()
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    batch_msa_from_files(p, [str(DATA / "seq.fq")] * N_INST, out,
                         device=dev)
    secs = time.perf_counter() - t0
    n_fq = len(reads_of(DATA / "seq.fq"))
    check(out.getvalue() == (GOLD_SAN / "seq_fq_Q_cons.fa").read_text()
          * N_INST, "-l -Q: output != seq_fq_Q_cons.fa")
    check(graph_update_packed.qv_launches == (n_fq - 1) * n_sub,
          f"-l -Q: {graph_update_packed.qv_launches} wmode-1 launches")
    say(f"list mode -Q: {N_INST} x seq.fq == seq_fq_Q_cons.fa, wmode-1 "
        f"launches {graph_update_packed.qv_launches}, {secs:.4f} s")
    return launches


# the loop-envelope phase's batches: (name, reads joined a read, reads
# an instance, the first read, from heter.fa's 762-769 bp reads alone);
# read i of a batch joins reads first+i .. first+i+join-1 of heter.fa
# (or of its long reads), cyclically, as long_reads does. Joined reads of
# both lengths (605-606 and 762-769 bp) differ by up to 3 x 163 bp and
# need more than the 16 band segments of the default band at 512 lanes
N_ENVELOPE = 16   # instances of each envelope batch
ENVELOPE = (("qv-long", 3, 8, 0, True), ("affine-long", 4, 6, 0, True),
            ("wide-loop", 2, 6, 3, False))


def envelope_batches(heter):
    """[(name, params, instances, qv weights or None)]: qv-long (default
    convex gaps, qv weights as in heter64-qv), affine-long (gap_open2 =
    0), wide-loop (gap_open1 = 0, -f 0.2), N_ENVELOPE instances of the
    same reads each."""
    import numpy as np
    from abpoa_tpu_torch.params import Params
    out = []
    for name, join, n, first, long_only in ENVELOPE:
        pool = [r for r in heter if len(r) > 700] if long_only else heter
        reads = [np.concatenate([pool[(first + i + j) % len(pool)]
                                 for j in range(join)]) for i in range(n)]
        p = Params()
        if name == "affine-long":
            p.gap_open2 = 0
        elif name == "wide-loop":
            p.gap_open1, p.wf = 0, 0.2
        insts = [reads] * N_ENVELOPE
        ws = qv_weights(insts) if name == "qv-long" else None
        out.append((name, p.post_set(), insts, ws))
    return out


def plain_timed(fn):
    """(fn(), host milliseconds of the call, synchronised both ends)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def envelope_kernels(dev, name, params, insts, ws, cfg):
    """The envelope batch's new kernel instance against its plain
    version on its last round (the state brought there through both
    kernels): B1 with four positions a thread (wide-loop) or B2 with its
    state in global memory (qv-long in wmode 1, affine-long in wmode 0);
    times of both, the bound; B2 also in shared memory's residency's
    place: the same round at heter64's R, state in global memory against
    shared memory, in turns."""
    import torch
    from abpoa_tpu_torch.ops.roofline import OPS_PER_CELL, bound
    from abpoa_tpu_torch.ops import poa_loop as pl
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.ops import graph_update as gu
    from abpoa_tpu_torch.ops import layout as L
    ps, base, ql_d, qpf, qp4, qw2 = loop_inputs(dev, params, insts, cfg, ws)
    bc = pl.band_config(cfg)
    wf1000 = round(params.wf * 1000)
    qw_of = (lambda r: qw2[r]) if ws else (lambda r: None)
    r = cfg.NR - 1
    for rr in range(r):
        ps, _, _ = pl.device_round_packed(cfg, ps, ql_d[rr], qpf[rr],
                                          qp4[rr], base, params.wb, wf1000,
                                          qw=qw_of(rr))
    scal = pl.build_scal(cfg, ps, ql_d[r], base, params.wb, wf1000)
    bargs = (bc, scal, ps.ctrl, ps.inp, ps.i2nn, qpf[r])
    km, ks = bd.band_poa_dp_packed(*bargs)
    if name == "wide-loop":
        (rm, rs), plain = plain_timed(
            lambda: bd.band_poa_dp_packed_ref(*bargs))
        check(not rm[:, L.M_OVFL].any() and not rm[:, L.M_FAIL].any(),
              f"{name}: plain DP overflow/fail")
        dm = (km - rm).abs().max().item()
        k16, r16 = pl.s16w_to_s16(ks), pl.s16w_to_s16(rs)
        for b in range(cfg.B):
            n = int(rm[b, L.M_NSTEPS])
            if n:
                dm = max(dm, (k16[b, :n].int() - r16[b, :n].int()).abs()
                         .max().item())
        check(dm == 0, f"{name}: band DP (4 positions a thread) != plain "
              f"(max |d| {dm})")
        rec = {"max_abs_err": dm, "plain_ms": plain,
               "ms": cuda_ms(lambda: (lambda: bd.band_poa_dp_packed(
                   *bargs)), 20)}
        rec["bound_ms"], rec["bound_by"] = bound(
            nbytes(scal[:, :L.S_NSCAL], ps.ctrl, ps.inp, ps.i2nn, qpf[r],
                   km, ks),
            int(km[:, L.M_CELLS].sum()) * OPS_PER_CELL[params.gap_mode])
        say(f"envelope {name}: band_dp_wide == plain on round {r + 1} "
            f"(B={cfg.B}, R={cfg.R}, WB={cfg.WB}, "
            f"{int(rm[:, L.M_NSTEPS].sum())} steps): kernel "
            f"{rec['ms']:.4f} ms, plain {plain:.4f} ms, bound "
            f"{rec['bound_ms']:.6f} ms ({rec['bound_by']})")
        return {"band_dp_wide": rec}
    check(gu.state_in_global(cfg), f"{name}: B2 state in shared memory")
    gargs = (ks, km, ql_d[r], qp4[r])
    gk = gu.graph_update_packed(
        cfg, pl.PackedState(*(x.clone() for x in ps)), *gargs, qw=qw_of(r))
    gr, plain = plain_timed(lambda: gu.graph_update_packed_ref(
        cfg, ps, *gargs, qw=qw_of(r)))
    check(not gr.fail.any() and torch.equal(gk.fail, gr.fail),
          f"{name}: fail flags {gk.fail.tolist()} {gr.fail.tolist()}")
    check(torch.equal(gk.node_n, gr.node_n), f"{name}: node_n")
    sk, i2k, n2k, remk = pl.unpack_state(cfg, gk)
    sr, i2r, n2r, remr = pl.unpack_state(cfg, gr)
    dm = max((a - b_).abs().max().item() for a, b_ in zip(sk, sr))
    live = torch.arange(cfg.R, device=dev)[None, :] < gr.node_n[:, None]
    for a, b_ in ((i2k, i2r), (n2k, n2r), (remk, remr)):
        dm = max(dm, ((a - b_).abs() * live).max().item())
    key = "graph_update_qv_global" if cfg.wmode else "graph_update_global"
    check(dm == 0, f"{name}: {key} != plain (max |d| {dm})")

    def fresh():
        c = pl.PackedState(*(x.clone() for x in ps))
        return lambda: gu.graph_update_packed(cfg, c, *gargs, qw=qw_of(r))
    rec = {"max_abs_err": dm, "plain_ms": plain, "ms": cuda_ms(fresh, 20)}
    ops = (int(km[:, L.M_NSTEPS].sum())
           + int(gr.node_n.sum()) * (cfg.E + cfg.P))
    rec["bound_ms"], rec["bound_by"] = bound(
        2 * nbytes(*ps) + nbytes(*gargs) + (nbytes(qw2[r]) if ws else 0),
        ops)
    say(f"envelope {name}: {key} == plain on round {r + 1} (B={cfg.B}, "
        f"R={cfg.R}, node_n max {int(gr.node_n.max())}, shared memory "
        f"{gu.global_smem_bytes(cfg)} of the state-resident "
        f"{gu.smem_bytes(cfg)} bytes): kernel {rec['ms']:.4f} ms, plain "
        f"{plain:.4f} ms, bound {rec['bound_ms']:.6f} ms "
        f"({rec['bound_by']})")
    return {key: rec}


def residency_split(dev, heter):
    """B2 on the last round of heter64 and heter64-qv (B=64; both fit
    shared memory) with the state in global memory against shared
    memory, in turns (smem, global, global, smem, 20 launches each):
    the cost of the global residency where both run. The residency is
    forced through graph_update.state_in_global, the wrapper's choice."""
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.ops import poa_loop as pl
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.ops import graph_update as gu
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    params = Params().post_set()
    wf1000 = round(params.wf * 1000)
    out = {}
    for label, ws in (("heter64", None),
                      ("heter64-qv", qv_weights([heter] * N_INST))):
        insts = [heter] * N_INST
        wmax = max(sum(max(w) for w in wk) for wk in ws) if ws else None
        cfg = _loop_geometry(params, insts, wmax)._replace(B=N_INST)
        ps, base, ql_d, qpf, qp4, qw2 = loop_inputs(dev, params, insts, cfg,
                                                    ws)
        qw_of = (lambda r: qw2[r]) if ws else (lambda r: None)
        r = cfg.NR - 1
        for rr in range(r):
            ps, _, _ = pl.device_round_packed(
                cfg, ps, ql_d[rr], qpf[rr], qp4[rr], base, params.wb,
                wf1000, qw=qw_of(rr))
        scal = pl.build_scal(cfg, ps, ql_d[r], base, params.wb, wf1000)
        km, ks = bd.band_poa_dp_packed(pl.band_config(cfg), scal, ps.ctrl,
                                       ps.inp, ps.i2nn, qpf[r])
        gargs = (ks, km, ql_d[r], qp4[r])

        def fresh():
            c = pl.PackedState(*(x.clone() for x in ps))
            return lambda: gu.graph_update_packed(cfg, c, *gargs,
                                                  qw=qw_of(r))
        t = {False: [], True: []}
        choose = gu.state_in_global
        try:
            for gmem in (False, True, True, False):
                gu.state_in_global = lambda _cfg, g=gmem: g
                t[gmem].append(cuda_ms(fresh, 20))
        finally:
            gu.state_in_global = choose
        sm, gl = statistics.mean(t[False]), statistics.mean(t[True])
        out[label] = {"smem_ms": sm, "global_ms": gl}
        say(f"envelope split: B2 at {label}'s last round (B={N_INST}, "
            f"R={cfg.R}, wmode {cfg.wmode}): state in shared memory "
            f"{sm:.4f} ms, in global memory {gl:.4f} ms ({gl / sm:.3f}x; "
            f"turns {[round(x, 4) for x in t[False] + t[True]]})")
    return out


def envelope_phase(dev, heter):
    """The device loop at the JAX package's envelope: each envelope
    batch through BatchPOA(device="cuda").run_consensus on the loop, no
    fallback, B1 and B2 once a round and sub-batch, the batch's kernel
    instance on every round (B2 in global memory in wmode 1 or 0, B1 with
    four positions a thread), every instance's bytes equal to the port's
    serial oracle; e2e median of REPS. Then each new kernel instance
    against its plain version at the batch's shape (envelope_kernels)
    and the residency split. Returns (kernel records, launches)."""
    import torch
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.ops.band_dp import band_poa_dp_packed
    from abpoa_tpu_torch.ops.graph_update import graph_update_packed
    from abpoa_tpu_torch.parallel.batch import SPLIT_MIN
    t_phase = time.perf_counter()
    counter = {"qv-long": ("graph_update_qv_global", graph_update_packed,
                           "qv_global_launches"),
               "affine-long": ("graph_update_global", graph_update_packed,
                               "global_launches"),
               "wide-loop": ("band_dp_wide", band_poa_dp_packed,
                             "wide_launches")}
    n_sub = 2 if N_ENVELOPE >= SPLIT_MIN else 1
    rec, launches = {}, {}
    for name, params, insts, ws in envelope_batches(heter):
        t0 = time.perf_counter()
        exp = weighted_oracle(params, insts, ws or [[[1] * len(q) for q in
                                                      r] for r in insts])
        t_oracle = time.perf_counter() - t0
        key, wrapper, attr = counter[name]
        want = (len(insts[0]) - 1) * n_sub
        e2e = []
        for rep in range(REPS + 1):
            bp = BatchPOA(params, device=dev)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cons = bp.run_consensus(insts, weights=ws)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = launches_now()
            bad = [k for k, (c, e) in enumerate(zip(cons, exp)) if c != e]
            check(not bad, f"envelope {name}: consensus != serial oracle "
                  f"at instances {bad}")
            check(bp.used_device_loop and bp.fallbacks == 0,
                  f"envelope {name}: device loop {bp.used_device_loop}, "
                  f"fallbacks {bp.fallbacks}")
            check(got["band_dp"] == got["graph_update"] == want
                  and getattr(wrapper, attr) == want
                  and got["band_dp_topo"] == got["fw_dp"] == got["tile_dp"]
                  == got["topo"] == 0,
                  f"envelope {name}: launches {got}, {key} "
                  f"{getattr(wrapper, attr)}, expected {want}")
            if rep == 0:
                launches[key] = getattr(wrapper, attr)
                cfg = bp._loop_eligible(insts)
                say(f"envelope {name}: {len(insts)} x {len(insts[0])} reads "
                    f"of {min(map(len, insts[0]))}-{max(map(len, insts[0]))}"
                    f" bp, R={cfg.R} WB={cfg.WB} Wq={cfg.Wq} "
                    f"wmode={cfg.wmode} gap_mode={params.gap_mode}: all "
                    f"{len(insts)} instances == serial oracle "
                    f"({t_oracle:.1f} s), fallbacks 0, launches B1 "
                    f"{got['band_dp']}, B2 {got['graph_update']}, {key} "
                    f"{launches[key]}; first run {secs:.4f} s")
            else:
                e2e.append(secs)
        med = statistics.median(e2e)
        E2E[name] = med
        say(f"envelope {name}: e2e {med:.4f} s median of {REPS} "
            f"{[round(x, 4) for x in e2e]}, device-loop phase "
            f"{bp.dp_busy_seconds():.4f} s, dp_cells {bp.dp_cells}, "
            f"dp_cells/s {bp.dp_cells / med:.1f}")
        rec.update(envelope_kernels(dev, name, params, insts, ws,
                                    cfg._replace(B=len(insts))))
    rec["graph_update_global"]["residency_split"] = residency_split(
        dev, heter)
    say(f"envelope: phase {time.perf_counter() - t_phase:.1f} s")
    return rec, launches


# the round-envelope phase's batches: wide-extend (read i joins heter.fa
# reads i+3 and i+4, 1,212-1,537 bp; -m 2 -f 0.2, default convex gaps:
# bands of 1,408-1,536 lanes, B3 at four lanes a thread) and fan-extend
# (instance k: 18 + (k % 13) hub reads of fuzz_ref.hub_reads under seed
# k, -m 2: the hub node gains a predecessor a read, so rounds 17-29 run
# B3 at 18-30 predecessor slots)
N_ROUND_ENV = 16


def round_envelope_batches(heter):
    """[(name, params, instances, counter attribute, kernel key)]."""
    import numpy as np
    from abpoa_tpu_torch.alphabet import encode_table
    from abpoa_tpu_torch.params import Params, EXTEND_MODE
    from abpoa_tpu_torch.tools.fuzz_ref import hub_reads, NT
    tab = encode_table(5)

    def ext(wf=None):
        p = Params()
        p.align_mode = EXTEND_MODE
        if wf is not None:
            p.wf = wf
        return p.post_set()
    wide = [np.concatenate([heter[(3 + i + j) % len(heter)]
                            for j in range(2)]) for i in range(6)]
    fan = [[tab[np.frombuffer(s.encode(), dtype=np.uint8)]
            for s in hub_reads(np.random.default_rng(k), NT, 18 + k % 13)]
           for k in range(N_ROUND_ENV)]
    return [("wide-extend", ext(0.2), [wide] * N_ROUND_ENV, "wide_launches",
             "band_dp_topo_wide"),
            ("fan-extend", ext(), fan, "fan_launches", "band_dp_topo_fan")]


def topo_last_round(dev, name, params, insts, key):
    """B3's new instance against its plain version on the batch's last
    round (the instances that have it; their exports from the oracle's
    graphs), bit-equal on misc, the int64 and int16 step streams, band
    bounds and state; times of both and the bound."""
    import torch
    from abpoa_tpu_torch.ops.roofline import OPS_PER_CELL, bound
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.ops import layout as L
    from abpoa_tpu_torch.parallel.batch import round_plan
    k = max(len(i) for i in insts) - 1
    live = [i for i in insts if len(i) > k]
    uniq = {id(i): i for i in live}
    dg_of = {j: round_exports(params, [i], k)[0] for j, i in uniq.items()}
    dgs = [dg_of[id(i)] for i in live]
    plan = round_plan(params, dgs, dev)
    check(plan.name == "band_dp_topo", f"{name}: last round plan "
          f"{plan.name}")
    cfg = plan.cfg
    check(cfg.WB > 1024 if key.endswith("wide") else cfg.P > bd.FAN_P,
          f"{name}: last round at WB {cfg.WB}, P {cfg.P}")
    args = plan.stack(slice(None), dev)
    out = bd.band_poa_dp_batch(cfg, *args)
    exp, plain = plain_timed(lambda: bd.band_poa_dp_batch_ref(cfg, *args))
    n_rows = [d.n_rows for d in dgs]
    dm = dp_diff(out, exp, n_rows, fields=("steps16",))
    for b in range(len(dgs)):
        ns = int(exp.misc[b, L.M_NSTEPS])
        dm = max(dm, int((out.steps[b, :ns] != exp.steps[b, :ns]).sum()))
    check(dm == 0, f"{name}: {key} != plain (max |d| {dm})")
    check(not exp.misc[:, L.M_OVFL].any() and not exp.misc[:, L.M_FAIL]
          .any(), f"{name}: plain DP overflow/fail")
    rec = {"max_abs_err": dm, "plain_ms": plain,
           "ms": cuda_ms(lambda: (lambda: bd.band_poa_dp_batch(cfg, *args)),
                         20)}
    cells = int(exp.misc[:, L.M_CELLS].sum())
    outs = [t for t in out if isinstance(t, torch.Tensor)]
    rec["bound_ms"], rec["bound_by"] = bound(
        nbytes(*args, *outs), cells * OPS_PER_CELL[params.gap_mode])
    say(f"round envelope {name}: {key} == plain on round {k} (B={len(dgs)}"
        f", R={cfg.R}, WB={cfg.WB}, P={cfg.P}, "
        f"{int(exp.misc[:, L.M_NSTEPS].sum())} steps, {cells} cells): "
        f"kernel {rec['ms']:.4f} ms, plain {plain:.4f} ms, bound "
        f"{rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    return rec


def round_envelope_phase(dev, heter):
    """The round path at the JAX package's envelope: wide-extend and
    fan-extend through BatchPOA(device="cuda").run_consensus (the round
    path, pipelined: 4 shards of 4), no fallback, every instance equal
    to the port's serial oracle, one B3 launch per round, width group,
    chunk and shard as round_shard_plan says, the batch's instance on
    every round that needs it (wide: all; fan: rounds of 17 or more
    predecessors); e2e median of REPS. Then each new instance against
    its plain version on the batch's last round. Returns (kernel
    records, launches)."""
    import torch
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.ops.band_dp import band_poa_dp_batch
    t_phase = time.perf_counter()
    rec, launches = {}, {}
    for name, params, insts, attr, key in round_envelope_batches(heter):
        t0 = time.perf_counter()
        memo = {}
        for i in insts:
            if id(i) not in memo:
                memo[id(i)] = weighted_oracle(
                    params, [i], [[[1] * len(q) for q in i]])[0]
        exp = [memo[id(i)] for i in insts]
        t_oracle = time.perf_counter() - t0
        e2e = []
        for rep in range(REPS + 1):
            bp = BatchPOA(params, device=dev)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cons = bp.run_consensus(insts)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = launches_now()
            bad = [k for k, (c, e) in enumerate(zip(cons, exp)) if c != e]
            check(not bad, f"round envelope {name}: consensus != serial "
                  f"oracle at instances {bad}")
            check(not bp.used_device_loop and bp.fallbacks == 0,
                  f"round envelope {name}: device loop "
                  f"{bp.used_device_loop}, fallbacks {bp.fallbacks}")
            want = round_shard_plan(bp, insts, "band_dp_topo")
            plan = {k: sum(w["launches"][k] for w in want)
                    for k in bp.launches}
            # the batch's instance: wide every round; fan the rounds whose
            # hub has 17 or more predecessors (round r: r of them)
            S = len(want)
            new = sum(
                sum(any(len(i) > r for i in insts[s::S])
                    for r in range(1, max(len(i) for i in insts[s::S]))
                    if key.endswith("wide") or r > 16)
                for s in range(S))
            check(bp.pipeline_shards == want and bp.launches == plan
                  and {k: got[k] for k in bp.launches} == plan
                  and got["band_dp"] == got["graph_update"] == 0
                  and getattr(band_poa_dp_batch, attr) == new,
                  f"round envelope {name} ({mode_of(bp)}): launches {got}, "
                  f"{key} {getattr(band_poa_dp_batch, attr)} (want {new}),"
                  f" dispatch plan {bp.launches}, shards "
                  f"{bp.pipeline_shards}, expected {want}")
            if rep == 0:
                launches[key] = new
                lens = [len(q) for i in insts for q in i]
                say(f"round envelope {name}: {len(insts)} instances of "
                    f"{min(map(len, insts))}-{max(map(len, insts))} reads "
                    f"of {min(lens)}-{max(lens)} bp ({mode_of(bp)}): all "
                    f"== serial oracle ({t_oracle:.1f} s), fallbacks 0, "
                    f"rounds {bp.rounds}, launches B3 "
                    f"{got['band_dp_topo']} == plan, {key} {new}; first "
                    f"run {secs:.4f} s")
            else:
                e2e.append(secs)
        med = statistics.median(e2e)
        E2E[name] = med
        say(f"round envelope {name}: e2e {med:.4f} s median of {REPS} "
            f"{[round(x, 4) for x in e2e]}, device phases "
            f"{bp.dp_busy_seconds():.4f} s, dp_cells {bp.dp_cells}, "
            f"dp_cells/s {bp.dp_cells / med:.1f}")
        rec[key] = topo_last_round(dev, name, params, insts, key)
    say(f"round envelope: phase {time.perf_counter() - t_phase:.1f} s")
    return rec, launches


def seeded_params():
    from abpoa_tpu_torch.params import Params
    p = Params()
    p.disable_seeding = False
    return p.post_set()


def dp_diff(out, exp, n_rows, fields=("steps",)):
    """The largest |kernel - plain| over a DP kernel's outputs: misc (but
    M_LASTI), each instance's step stream(s) up to its step count, its
    band bounds and band state up to its rows (n_rows[b])."""
    from abpoa_tpu_torch.ops import layout as L
    dm = int((out.misc[:, :L.M_LASTI] - exp.misc[:, :L.M_LASTI]).abs().max())
    for b, n in enumerate(n_rows):
        ns = int(exp.misc[b, L.M_NSTEPS])
        for f in fields:
            if ns:
                dm = max(dm, int((getattr(out, f)[b, :ns].int()
                                  - getattr(exp, f)[b, :ns].int())
                                 .abs().max()))
        for f in ("beg_sn", "end_sn", "mpl", "mpr"):
            dm = max(dm, int((getattr(out, f)[b, :n]
                              - getattr(exp, f)[b, :n]).abs().max()))
    return dm


def window_kernel_phase(dev, heter):
    """B3 in its non-fresh mode and B4 under the row mask against their
    plain versions, on the inputs of a real window round of 64
    config-5-shaped instances (the round with the most partial row
    masks, then the most windows; heter.fa's windows reach every row
    between their anchors, so its masks are full), at the dispatch's
    shapes (the band plan, and the full-width plan forced on the same
    exports)."""
    from abpoa_tpu_torch.ops.roofline import OPS_PER_CELL, bound
    from abpoa_tpu_torch.workload import seeded_instances
    import torch
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.ops import band_dp as bd, fw_dp as fw
    from abpoa_tpu_torch.ops import layout as L
    from abpoa_tpu_torch.parallel import batch
    params = seeded_params()
    rounds = []
    plan0 = batch.round_plan

    def capture(params_, dgs, dev_, seeded=False, **kw):
        if seeded:
            rounds.append(list(dgs))
        return plan0(params_, dgs, dev_, seeded, **kw)
    batch.round_plan = capture
    try:
        # lockstep: one window round of every instance at a time
        BatchPOA(params, device=dev, pipeline=False).run_seeded(
            seeded_instances(heter, N_INST))
    finally:
        batch.round_plan = plan0

    def partial(dgs):
        return sum(int((d.rowmask[:d.n_rows] == 0).any()) for d in dgs)
    dgs = max(rounds, key=lambda d: (partial(d), len(d)))
    rec = {}
    smem0 = bd.MAX_SMEM_BYTES
    for name, what in (("band_dp_topo", "non-fresh, row mask"),
                       ("fw_dp", "row mask")):
        if name == "fw_dp":
            bd.MAX_SMEM_BYTES = 0      # the band no longer fits a block
        try:
            plan = batch.round_plan(params, dgs, dev, seeded=True)
        finally:
            bd.MAX_SMEM_BYTES = smem0
        check(plan.name == name and (not plan.band or not plan.cfg.fresh),
              f"window round: dispatch picked {plan.name}")
        args = plan.stack(slice(None), dev)
        ref = (bd.band_poa_dp_batch_ref if plan.band
               else fw.fw_poa_dp_batch_ref)
        out = plan.kernel(plan.cfg, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp = ref(plan.cfg, *args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        dm = dp_diff(out, exp, [d.n_rows for d in dgs],
                     ("steps", "steps16") if plan.band else ("steps",))
        check(dm == 0, f"window round: {name} ({what}) != plain "
              f"(max |d| {dm})")
        check(not (exp.misc[:, L.M_FAIL] | exp.misc[:, L.M_OVFL]).any(),
              f"window round: {name} walk failed or overflowed")
        ms = cuda_ms(lambda: (lambda: plan.kernel(plan.cfg, *args)), 20)
        cells = int(exp.misc[:, L.M_CELLS].sum())
        outs = [t for t in out if isinstance(t, torch.Tensor)]
        bms, bby = bound(nbytes(*args, *outs),
                         cells * OPS_PER_CELL[params.gap_mode])
        rec[name] = dict(max_abs_err=dm, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=bby)
        if name == "band_dp_topo":
            # the window round's exports repeated to a seeded group of 256
            # instances (B=128) and to their lockstep round (B=256)
            for B in (128, 256):
                big = batch.round_plan(params, [dgs[i % len(dgs)]
                                                for i in range(B)],
                                       dev, seeded=True)
                big_args = big.stack(slice(None), dev)
                rec[name][f"round_B{B}_ms"] = cuda_ms(
                    lambda: (lambda: big.kernel(big.cfg, *big_args)), 10)
                del big_args
            say(f"kernels: {name} ({what}) on the window round at B="
                + ", ".join(f"{k[7:-3]} {v:.4f} ms"
                            for k, v in rec[name].items()
                            if k.startswith("round_B")))
        say(f"kernels: {name} ({what}) == plain on a window round (B="
            f"{len(dgs)}, {partial(dgs)} partial masks, R={plan.cfg.R}, "
            f"{'WB=%d' % plan.cfg.WB if plan.band else 'Wq=%d' % plan.cfg.Wq}"
            f", {int(exp.misc[:, L.M_NSTEPS].sum())} steps, {cells} cells): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.6f} "
            f"ms ({bby})")
    return rec


def baseline_kernels(root):
    """The kernels' wrappers of an earlier checkout at `root` (for
    example one unpacked by `git archive <commit>` into a git-ignored
    directory), imported as a package of its own: {record name: wrapper}
    for band_dp, band_dp_topo, fw_dp, fw_dp_window, tile_dp,
    graph_update (both modes) and topo. They take the
    port's arguments, and build that checkout's kernels from its csrc/
    into its build/ at first call."""
    import importlib
    import importlib.util
    pkg = pathlib.Path(root).resolve() / "abpoa_tpu_torch"
    check((pkg / "ops" / "fw_dp.py").is_file(),
          f"--baseline {root}: no abpoa_tpu_torch/ops/fw_dp.py there")
    name = "abpoa_tpu_torch_baseline"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    bd = importlib.import_module(name + ".ops.band_dp")
    fw = importlib.import_module(name + ".ops.fw_dp")
    td = importlib.import_module(name + ".ops.tile_dp")
    gu = importlib.import_module(name + ".ops.graph_update")
    tt = importlib.import_module(name + ".ops.topo")
    return {"band_dp": bd.band_poa_dp_packed,
            "band_dp_topo": bd.band_poa_dp_batch,
            "fw_dp": fw.fw_poa_dp_batch, "fw_dp_window": fw.fw_poa_dp_batch,
            "tile_dp": td.tile_poa_dp_batch,
            "graph_update": gu.graph_update_packed,
            "graph_update_qv": gu.graph_update_packed,
            "topo": tt.topo_batch}


def loop_round_args(dev, insts):
    """B1's arguments on the last round of the device loop over `insts`
    (the state brought there through both kernels)."""
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.ops import poa_loop as pl
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    params = Params().post_set()
    cfg = _loop_geometry(params, insts)._replace(B=len(insts))
    ps, base, ql_d, qpf, qp4, _ = loop_inputs(dev, params, insts, cfg)
    wf1000 = round(params.wf * 1000)
    r = cfg.NR - 1
    for rr in range(1, r):
        ps, _, _ = pl.device_round_packed(cfg, ps, ql_d[rr], qpf[rr],
                                          qp4[rr], base, params.wb, wf1000)
    scal = pl.build_scal(cfg, ps, ql_d[r], base, params.wb, wf1000)
    return pl.band_config(cfg), (scal, ps.ctrl, ps.inp, ps.i2nn, qpf[r])


def graph_round_args(dev, insts, ws=None):
    """B2's arguments on the last round of the device loop over `insts`
    (with per-base weights `ws`: wmode 1), the state brought there
    through both kernels: (cfg, packed state, (s16w, misc, qlen, qp4),
    packed weights or None). The state is not touched: callers clone it
    for the kernel, which updates it in place."""
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.ops import poa_loop as pl
    from abpoa_tpu_torch.ops import band_dp as bd
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    params = Params().post_set()
    wmax = max(sum(max(w) for w in wk) for wk in ws) if ws else None
    cfg = _loop_geometry(params, insts, wmax)._replace(B=len(insts))
    ps, base, ql_d, qpf, qp4, qw2 = loop_inputs(dev, params, insts, cfg, ws)
    wf1000 = round(params.wf * 1000)
    r = cfg.NR - 1
    for rr in range(r):
        ps, _, _ = pl.device_round_packed(
            cfg, ps, ql_d[rr], qpf[rr], qp4[rr], base, params.wb, wf1000,
            qw=qw2[rr] if ws else None)
    scal = pl.build_scal(cfg, ps, ql_d[r], base, params.wb, wf1000)
    km, ks = bd.band_poa_dp_packed(pl.band_config(cfg), scal, ps.ctrl,
                                   ps.inp, ps.i2nn, qpf[r])
    return cfg, ps, (ks, km, ql_d[r], qp4[r]), qw2[r] if ws else None


def fused_state(cfg, ps, args, qw):
    """The graph state after B2's round on a copy of `ps` (a GState: B6's
    input, as the split round hands it the fused graph)."""
    from abpoa_tpu_torch.ops import poa_loop as pl
    from abpoa_tpu_torch.ops import graph_update as gu
    out = gu.graph_update_packed(cfg, pl.PackedState(*(x.clone()
                                                       for x in ps)),
                                 *args, qw=qw)
    return pl.unpack_state(cfg, out)[0]


def serial_windows(device="cuda"):
    """(cfg, args) of every B4 launch of one CLI -S run on heter.fa (the
    serial engine's window path, B=1 each), taken where the engine hands
    a window's export to its launch (engine_torch._run) and uploaded as
    it uploads them."""
    import numpy as np
    import torch
    from abpoa_tpu_torch.align import engine_torch
    from abpoa_tpu_torch.ops import fw_dp as fw
    calls = []
    run0 = engine_torch._run

    def capture(kernel, cfg, arrs, dev):
        if kernel is fw.fw_poa_dp_batch:
            calls.append((cfg, [torch.from_numpy(np.ascontiguousarray(a))
                                [None].to(dev) for a in arrs]))
        return run0(kernel, cfg, arrs, dev)
    engine_torch._run = capture
    try:
        run_cli(["-S", "--device", device, str(HETER)])
    finally:
        engine_torch._run = run0
    return calls


def serial_window_phase(win, round_rec):
    """B4 on the serial -S path's own launches (`win`: B=1, one window
    each): every window's result bit-equal to the plain version's on the
    same inputs, run on the host's CPU (a Python loop of small ops, which
    costs less there than as launches on the card); the kernel's mean time a
    window (CUDA events), the plain version's (host clock, CPU) and the
    mean bound a window. round_rec (phase 3e's B=64 window round, plain
    on the card) is kept beside it under round_B64_* keys."""
    from abpoa_tpu_torch.ops.roofline import OPS_PER_CELL, bound
    import torch
    from abpoa_tpu_torch.ops import fw_dp as fw
    from abpoa_tpu_torch.ops import layout as L
    dm, plain, tb, rows = 0, [], [], []
    for cfg, args in win:
        out = fw.fw_poa_dp_batch(cfg, *args)
        host = [a.cpu() for a in args]
        t0 = time.perf_counter()
        exp = fw.fw_poa_dp_batch_ref(cfg, *host)
        plain.append((time.perf_counter() - t0) * 1e3)
        out = fw.FWOut(*(t.cpu() for t in out))
        n = int(args[0][0, L.S_NROWS])
        rows.append(n)
        dm = max(dm, dp_diff(out, exp, [n]))
        check(not (exp.misc[:, L.M_FAIL] | exp.misc[:, L.M_OVFL]).any(),
              "serial -S window: walk failed or overflowed")
        cells = int(exp.misc[:, L.M_CELLS].sum())
        outs = [t for t in out if isinstance(t, torch.Tensor)]
        tb.append(bound(nbytes(*args, *outs),
                        cells * OPS_PER_CELL[cfg.gap_mode]))
    check(dm == 0, f"serial -S windows: fw_dp != plain (max |d| {dm})")

    def run():
        for cfg, args in win:
            fw.fw_poa_dp_batch(cfg, *args)
    ms = cuda_ms(lambda: run, 10) / len(win)
    rec = dict(max_abs_err=dm, ms=ms, plain_ms=sum(plain) / len(plain),
               plain_on="cpu", bound_ms=sum(t for t, _ in tb) / len(tb),
               bound_by=tb[0][1],
               **{f"round_B64_{k}": v for k, v in round_rec.items()})
    say(f"kernels: fw_dp (row mask) == plain on each of the {len(win)} "
        f"windows of a CLI -S run (B=1, {min(rows)}-{max(rows)} rows): "
        f"kernel {ms:.4f} ms, plain (CPU) {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.7f} ms ({rec['bound_by']}), means a window")
    return rec


def dp_timing_phase(dev, heter, base, win):
    """B1, B3 and B4 at the table's shape (B=8), at the B their path
    launches (B1: 32, the device loop's sub-batch; B3/B4: 64 on the round
    path in lockstep, 16 in a pipeline shard of 64 instances; B4: 1 per
    window on the serial -S path, `win`, the mean over one
    run's windows), B5 at B=1 (the serial engine's last read of heter.fa)
    and sweep only (bt_lmax = 0: the kernels return before
    the walk); with `base` (baseline_kernels), each beside an earlier
    checkout's kernel in turns new, old, old, new. Returns {record name:
    {ms_B, sweep_ms_B, base_ms_B, ...}}."""
    import torch
    from abpoa_tpu_torch.params import Params, LOCAL_MODE, EXTEND_MODE
    from abpoa_tpu_torch.ops import band_dp as bd, fw_dp as fw
    from abpoa_tpu_torch.ops import tile_dp as td
    from abpoa_tpu_torch.parallel.batch import round_plan

    def mk(**kw):
        p = Params()
        for key, v in kw.items():
            setattr(p, key, v)
        return p.post_set()
    rot = [heter[b:] + heter[:b] for b in range(N_CMP)]
    cases = []       # (record, B label, new, [(cfg, args)])
    for B, insts in ((8, rot), (32, [heter] * 32)):
        cfg, args = loop_round_args(dev, insts)
        cases.append(("band_dp", B, bd.band_poa_dp_packed, [(cfg, args)]))
    for name, params in (("band_dp_topo", mk(align_mode=EXTEND_MODE,
                                              zdrop=100)),
                         ("fw_dp", mk(align_mode=LOCAL_MODE))):
        dgs = round_exports(params, rot, 4)
        for B, dd in ((8, dgs), (16, dgs * 2), (64, dgs * 8)):
            plan = round_plan(params, dd, dev)
            check(plan.name == name, f"dp timing: dispatch {plan.name}")
            cases.append((name, B, plan.kernel,
                          [(plan.cfg, plan.stack(slice(None), dev))]))
    cases.append(("fw_dp_window", 1, fw.fw_poa_dp_batch, win))
    cfg, arrs, _ = tile_inputs(mk(), [heter], len(heter) - 1)
    cases.append(("tile_dp", 1, td.tile_poa_dp_batch,
                  [(cfg, [torch.from_numpy(a).to(dev) for a in arrs])]))
    rec = {}

    def timed(fn, calls, lmax0, n):
        def run():
            for cfg, args in calls:
                fn(cfg._replace(bt_lmax=0) if lmax0 else cfg, *args)
        return cuda_ms(lambda: run, n) / len(calls)
    for name, B, new, calls in cases:
        n = 20 if B <= 8 else 10
        old = base.get(name)
        timed(new, calls, False, 2)
        r = rec.setdefault(name, {})
        if old is not None:
            timed(old, calls, False, 2)
            fns = (new, old, old, new)
            t = [timed(f, calls, False, n) for f in fns]
            sw = [timed(f, calls, True, n) for f in fns]
            r[f"ms_B{B}"] = (t[0] + t[3]) / 2
            r[f"base_ms_B{B}"] = (t[1] + t[2]) / 2
            r[f"sweep_ms_B{B}"] = (sw[0] + sw[3]) / 2
            r[f"base_sweep_ms_B{B}"] = (sw[1] + sw[2]) / 2
            say(f"dp timing: {name} B={B} ({len(calls)} launches): new "
                f"{r[f'ms_B{B}']:.4f} ms (sweep {r[f'sweep_ms_B{B}']:.4f}), "
                f"baseline {r[f'base_ms_B{B}']:.4f} ms (sweep "
                f"{r[f'base_sweep_ms_B{B}']:.4f}); turns new, old, old, new "
                f"{[round(x, 4) for x in t]}")
        else:
            r[f"ms_B{B}"] = timed(new, calls, False, n)
            r[f"sweep_ms_B{B}"] = timed(new, calls, True, n)
            say(f"dp timing: {name} B={B} ({len(calls)} launches): "
                f"{r[f'ms_B{B}']:.4f} ms, sweep only "
                f"{r[f'sweep_ms_B{B}']:.4f} ms")
    torch.cuda.synchronize()
    return rec


def graph_timing_phase(dev, heter, base):
    """B2 in both modes and B6 at the table's shapes (B2 wmode 0: 8
    rotated heter.fa instances; wmode 1: 64 x heter.fa with qv weights;
    B6: the graph of the wmode-0 round, B=8) and B2 at the B its path
    launches (32, the device loop's sub-batch), each on the device
    loop's last round; with `base` (baseline_kernels), beside an earlier
    checkout's kernels in turns new, old, old, new. B2 updates its state
    in place, so each call gets a fresh copy, made outside the timed
    region. Returns {record name: {ms_B, base_ms_B}}."""
    from abpoa_tpu_torch.ops import poa_loop as pl
    from abpoa_tpu_torch.ops import graph_update as gu
    from abpoa_tpu_torch.ops import topo as tt
    rot = [heter[b:] + heter[:b] for b in range(N_CMP)]
    cases = []       # (record, B, new wrapper, fn -> set-up -> callable)
    for name, B, insts in (("graph_update", 8, rot),
                           ("graph_update", 32, [heter] * 32),
                           ("graph_update_qv", N_INST, [heter] * N_INST),
                           ("graph_update_qv", 32, [heter] * 32)):
        ws = qv_weights(insts) if name == "graph_update_qv" else None
        cfg, ps, args, qw = graph_round_args(dev, insts, ws)

        def b2(fn, cfg=cfg, ps=ps, args=args, qw=qw):
            def setup():
                c = pl.PackedState(*(x.clone() for x in ps))
                return lambda: fn(cfg, c, *args, qw=qw)
            return setup
        cases.append((name, B, gu.graph_update_packed, b2))
        if name == "graph_update" and B == 8:
            st = fused_state(cfg, ps, args, qw)
            cases.append(("topo", 8, tt.topo_batch,
                          lambda fn, cfg=cfg, st=st:
                          (lambda: (lambda: fn(cfg, st)))))
    rec = {}
    for name, B, new, call in cases:
        old = base.get(name)
        cuda_ms(call(new), 2)
        r = rec.setdefault(name, {})
        if old is not None:
            cuda_ms(call(old), 2)
            t = [cuda_ms(call(f), 20) for f in (new, old, old, new)]
            r[f"ms_B{B}"] = (t[0] + t[3]) / 2
            r[f"base_ms_B{B}"] = (t[1] + t[2]) / 2
            say(f"graph timing: {name} B={B}: new {r[f'ms_B{B}']:.4f} ms, "
                f"baseline {r[f'base_ms_B{B}']:.4f} ms "
                f"({r[f'ms_B{B}'] / r[f'base_ms_B{B}']:.3f}x); turns new, "
                f"old, old, new {[round(x, 4) for x in t]}")
        else:
            r[f"ms_B{B}"] = cuda_ms(call(new), 20)
            say(f"graph timing: {name} B={B}: {r[f'ms_B{B}']:.4f} ms")
    return rec


class counted_engine:
    """Counts the serial engine's calls while it is entered: whole-graph
    and window alignments on the device, and the host oracle's window
    calls (``calls`` by name)."""

    NAMES = ("align_sequence_to_subgraph_device",
             "align_sequence_to_graph_device")

    def __enter__(self):
        from abpoa_tpu_torch import align
        from abpoa_tpu_torch.align import engine_torch
        self.calls = {}
        self.saved = {n: getattr(engine_torch, n) for n in self.NAMES}
        self.oracle0 = align._np_subgraph

        def counted(name, fn):
            def run(*a, **k):
                self.calls[name] = self.calls.get(name, 0) + 1
                return fn(*a, **k)
            return run
        for n, fn in self.saved.items():
            setattr(engine_torch, n, counted(n, fn))
        align._np_subgraph = counted("oracle", self.oracle0)
        return self.calls

    def __exit__(self, *exc):
        from abpoa_tpu_torch import align
        from abpoa_tpu_torch.align import engine_torch
        for n, fn in self.saved.items():
            setattr(engine_torch, n, fn)
        align._np_subgraph = self.oracle0


def check_serial_launches(what, calls, want_whole=None):
    """The serial engine's launches of one CLI run: one B4 per window and
    per B5 result re-run there, one B5 per whole-graph call (banded), the
    oracle only for the empty windows. Returns (launches, windows,
    whole-graph calls, re-runs)."""
    from abpoa_tpu_torch.align import engine_torch
    got = launches_now()
    win = calls.get("align_sequence_to_subgraph_device", 0)
    whole = calls.get("align_sequence_to_graph_device", 0)
    rerun = sum(engine_torch.reroutes.values())
    b5 = whole if want_whole is None else want_whole
    check(got["fw_dp"] == win + rerun + (whole - b5) and got["tile_dp"] == b5
          and calls.get("oracle", 0) == engine_torch.empty_windows,
          f"{what}: launches {got}, windows {win}, whole-graph calls "
          f"{whole}, B5 re-run on B4 {rerun}, oracle calls "
          f"{calls.get('oracle', 0)}, empty windows "
          f"{engine_torch.empty_windows}")
    return got, win, whole, rerun


def cli_seeded_phase():
    """The three -S goldens through the CLI's serial engine on the card:
    one B4 launch per non-empty window (plus one per B5 result re-run
    there), one B5 launch per whole-graph call (a read without anchors),
    and the oracle only for the empty windows. Returns the B4 launches
    of the -S run."""
    from abpoa_tpu_torch.align import engine_torch
    first = None
    with counted_engine() as calls:
        for golden, args in (("heter_S_cons.fa", ["-S"]),
                             ("heter_Sp_cons.fa", ["-S", "-p"]),
                             ("heter_S_n100_cons.fa", ["-S", "-n", "100"])):
            calls.clear()
            reset_launches()
            engine_torch.reroutes.update(M_OVFL=0, M_FAIL=0)
            engine_torch.empty_windows = 0
            t0 = time.perf_counter()
            out, _err = run_cli(args + [str(HETER)])
            secs = time.perf_counter() - t0
            check(out == (GOLD_SAN / golden).read_text(),
                  f"CLI {' '.join(args)}: output != {golden}")
            got, win, whole, rerun = check_serial_launches(
                f"CLI {' '.join(args)}", calls)
            check(win > 0, f"CLI {' '.join(args)}: no window on the card")
            if first is None:
                first = got["fw_dp"]
            say(f"CLI {' '.join(args)} heter.fa: {golden} bytes, B4 "
                f"{got['fw_dp']} launches for {win} windows (+{rerun} B5 "
                f"re-runs), B5 {got['tile_dp']} for {whole} whole-graph "
                f"calls, oracle only for the {engine_torch.empty_windows} "
                f"empty windows, {secs:.4f} s")
    return first


def long_reads(n_reads, first=0, join=7):
    """FASTA text of n_reads long reads: read k joins heter.fa reads
    first+k .. first+k+join-1 (cyclically)."""
    from abpoa_tpu_torch.seqio import read_seqs
    heter = [r.seq for r in read_seqs(str(HETER))]
    return "".join(f">long{k}\n"
                   + "".join(heter[(first + k + i) % len(heter)]
                             for i in range(join)) + "\n"
                   for k in range(n_reads))


def long_read_phase():
    """The CLI past 4096 graph nodes on the card: default flags, -m 1 and
    -S on 3 long reads give the port oracle's bytes with the serial
    engine's launch counts; -l -m 2 over 4 such files runs the round
    path's band kernel past 4096 rows, one launch per round, no
    fallback. Returns {case: e2e seconds}."""
    import torch
    from abpoa_tpu_torch.align import engine_torch
    d = ROOT / "build" / "abpoa_tpu_torch"
    d.mkdir(parents=True, exist_ok=True)
    fa = d / "long3.fa"
    fa.write_text(long_reads(3))
    rec = {}
    with counted_engine() as calls:
        for args in ([], ["-m", "1"], ["-S"]):
            what = f"long reads CLI {' '.join(args) or 'default'}"
            t0 = time.perf_counter()
            exp, _err = run_cli(["--engine", "numpy", *args, str(fa)])
            oracle_s = time.perf_counter() - t0
            calls.clear()
            reset_launches()
            engine_torch.reroutes.update(M_OVFL=0, M_FAIL=0)
            engine_torch.empty_windows = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _err = run_cli([*args, str(fa)])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check(out == exp, f"{what}: output != the port's oracle")
            got, win, whole, rerun = check_serial_launches(
                what, calls, 0 if args == ["-m", "1"] else None)
            check(whole + win > 0, f"{what}: nothing ran on the card")
            rec[" ".join(args) or "default"] = secs
            say(f"{what}: == oracle bytes, B5 {got['tile_dp']} for {whole} "
                f"whole-graph calls, B4 {got['fw_dp']} ({win} windows, "
                f"{rerun} B5 re-runs), empty windows "
                f"{engine_torch.empty_windows}; card {secs:.4f} s, oracle "
                f"(CPU) {oracle_s:.4f} s")
    fas = []
    for k in range(4):
        fas.append(d / f"long3_{k}.fa")
        fas[-1].write_text(long_reads(3, first=k))
    lst = d / "long_list.txt"
    lst.write_text("".join(f"{f}\n" for f in fas))
    exp = "".join(run_cli(["--engine", "numpy", "-m", "2", str(f)])[0]
                  for f in fas)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _err = run_cli(["-m", "2", "-l", str(lst)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = launches_now()
    check(out == exp, "long reads -l -m 2: output != the port's oracle")
    check(got["band_dp_topo"] == 2 and got["fw_dp"] == got["tile_dp"] == 0,
          f"long reads -l -m 2: launches {got}, expected 2 of B3")
    rec["-l -m 2"] = secs
    say(f"long reads -l -m 2 (4 files): == oracle bytes, B3 launches "
        f"{got['band_dp_topo']} (one per round), {secs:.4f} s")
    return rec


def fetch_phase(dev, heter):
    """The round path's step fetch at heter64-extend's last round (64
    instances, B3): the int16 delta stream plus its host decode against
    the int64 step words, in turns (s16, wide, wide, s16). Returns
    {s16_ms, wide_ms} per launch."""
    import numpy as np
    import torch
    from abpoa_tpu_torch.params import Params, EXTEND_MODE
    from abpoa_tpu_torch.parallel.batch import round_plan
    from abpoa_tpu_torch.ops import layout as L
    from abpoa_tpu_torch.ops.steps import unpack_steps16
    p = Params()
    p.align_mode = EXTEND_MODE
    p.post_set()
    dgs = round_exports(p, [heter], len(heter) - 1) * N_INST
    plan = round_plan(p, dgs, dev)
    check(plan.name == "band_dp_topo", f"fetch: dispatch {plan.name}")
    out = plan.kernel(plan.cfg, *plan.stack(slice(None), dev))
    misc = out.misc.cpu().numpy()
    cap = plan.step_cap

    def s16():
        st = out.steps16[:, :cap].cpu().numpy()
        return [unpack_steps16(st[b], int(misc[b, L.M_NSTEPS]),
                               int(misc[b, L.M_BI]), int(misc[b, L.M_BJ]))
                for b in range(len(dgs))]

    def wide():
        st = out.steps[:, :cap].cpu().numpy()
        return [st[b, :int(misc[b, L.M_NSTEPS])] for b in range(len(dgs))]
    a, b_ = s16(), wide()
    check(all(np.array_equal(x, y) for x, y in zip(a, b_)),
          "fetch: the two streams decode differently")
    t = [host_ms(lambda f=f: f, 20) for f in (s16, wide, wide, s16)]
    rec = {"s16_ms": (t[0] + t[3]) / 2, "wide_ms": (t[1] + t[2]) / 2}
    say(f"fetch at heter64-extend's last round (B=64, cap {cap} steps): "
        f"steps16 + host decode {rec['s16_ms']:.4f} ms, int64 words "
        f"{rec['wide_ms']:.4f} ms; turns {[round(x, 4) for x in t]}")
    return rec


def seeded_phase(dev, heter):
    """run_seeded over N_SEEDED config-5-shaped instances: each
    instance's consensus equals the port's serial oracle of its trim
    class, no fallback, the window kernels' launches equal the dispatch
    plan; e2e median of REPS, windows/s, DP cells/s."""
    from abpoa_tpu_torch.workload import seeded_instances
    import dataclasses
    import torch
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.api import ABPOA
    from abpoa_tpu_torch.consensus import generate_consensus
    from abpoa_tpu_torch.alphabet import decode_table
    params = seeded_params()
    insts = seeded_instances(heter, N_SEEDED)
    host = dataclasses.replace(params, engine="numpy")
    dt = decode_table(5)
    exp = []
    for inst in insts[:5]:
        ab = ABPOA()
        ab.msa(host, [bytes(dt[b] for b in q).decode() for q in inst])
        generate_consensus(ab, host)
        exp.append([bytes(dt[b] for b in s).decode()
                    for s in ab.cons.cons_base[:ab.cons.n_cons]])
    e2e = []
    for rep in range(REPS + 1):
        bp = BatchPOA(params, device=dev)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cons = bp.run_consensus(insts, seeded=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = launches_now()
        check(all(c == exp[k % 5] for k, c in enumerate(cons)),
              "seeded: consensus != serial oracle of its trim class")
        check(bp.fallbacks == 0, f"seeded: {bp.fallbacks} oracle fallbacks")
        round_got = {k: got[k] for k in bp.launches}
        check(round_got == bp.launches and got["band_dp_topo"] > 0
              and got["tile_dp"] == 0 and got["band_dp"] == 0
              and got["graph_update"] == 0,
              f"seeded: launches {got}, dispatch plan {bp.launches}")
        if rep == 0:
            launches = round_got
            say(f"seeded: {N_SEEDED} config-5 instances == serial oracle "
                f"(5 trim classes), fallbacks 0, {bp.rounds} window rounds, "
                f"{bp.windows} windows on the device + {bp.empty_windows} "
                f"empty, launches {round_got}, first run {secs:.4f} s")
        else:
            e2e.append(secs)
    med = statistics.median(e2e)
    E2E["seeded-c5"] = med
    busy = bp.dp_busy_seconds()
    say(f"seeded: e2e {med:.4f} s median of {REPS} "
        f"{[round(x, 4) for x in e2e]}, windows/s {bp.windows / med:.1f}, "
        f"device phases {busy:.4f} s, host {med - busy:.4f} s, dp_cells "
        f"{bp.dp_cells}, dp_cells/s {bp.dp_cells / med:.1f}")
    return launches


def shard_devices():
    """Phase 13's device list: every visible card, or cuda:0 twice on a
    host with one (two shards share the card, each on its own stream)."""
    import torch
    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if n >= 2 else ["cuda:0"] * 2


def seeded_text(params, insts):
    """The port's serial oracle output (consensus FASTA) of each of
    `insts`, on the host."""
    import dataclasses
    from abpoa_tpu_torch.api import ABPOA
    from abpoa_tpu_torch.alphabet import decode_table
    host = dataclasses.replace(params, engine="numpy")
    dt = decode_table(5)
    out = []
    for inst in insts:
        buf = io.StringIO()
        ABPOA().msa(host, [bytes(dt[b] for b in q).decode() for q in inst],
                    out=buf)
        out.append(buf.getvalue())
    return out


def shards_phase(heter):
    """BatchPOA(devices=...) over shard_devices(): 64 x heter.fa (golden,
    B1/B2 once a round and sub-batch of every shard), -m 1 and -m 2 (the
    serial oracle, the plan's kernel once a round on every shard with
    work), N_SEEDED config-5 instances (the oracle of each trim class) and
    the dry run; e2e medians beside the single-device ones."""
    from abpoa_tpu_torch.workload import seeded_instances
    import torch
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.params import Params, LOCAL_MODE, EXTEND_MODE
    from abpoa_tpu_torch.parallel.batch import SPLIT_MIN
    from abpoa_tpu_torch.parallel.dryrun import dryrun_multidevice
    from abpoa_tpu_torch.parallel.multihost import shard_bounds
    t_phase = time.perf_counter()
    devs = shard_devices()
    D = len(devs)
    cards = len(set(devs))
    say(f"shards: device list {devs} ({cards} card(s)"
        + (", one card shared: not scaling" if cards == 1 else "") + ")")
    sizes = [hi - lo for lo, hi in (shard_bounds(N_INST, D, i)
                                    for i in range(D))]
    n_sub = sum(2 if n >= SPLIT_MIN else int(n > 0) for n in sizes)
    gold = GOLD.read_text().split("\n")[1]
    med = {}

    def timed(params, insts, **kw):
        bp = BatchPOA(params, devices=devs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cons = bp.run_consensus(insts, **kw)
        torch.cuda.synchronize()
        return bp, cons, time.perf_counter() - t0

    # device loop: 64 x heter.fa
    reset_launches()
    bp, cons, first = timed(Params().post_set(), [heter] * N_INST)
    got = launches_now()
    want = (len(heter) - 1) * n_sub
    check(all(c == [gold] for c in cons) and bp.fallbacks == 0
          and bp.used_device_loop, "shards: 64 x heter.fa != golden")
    check(got["band_dp"] == got["graph_update"] == want
          and got["band_dp_topo"] == got["fw_dp"] == got["tile_dp"]
          == got["topo"] == 0,
          f"shards: launches {got}, expected B1 = B2 = {want}")
    e2e = []
    for _ in range(REPS):
        bp, cons, secs = timed(Params().post_set(), [heter] * N_INST)
        check(all(c == [gold] for c in cons) and bp.fallbacks == 0,
              "shards: timed run != golden")
        e2e.append(secs)
    med["heter64"] = statistics.median(e2e)
    say(f"shards: {N_INST} x heter.fa golden over {D} shards "
        f"{[s['instances'] for s in bp.shards]}, fallbacks 0, B1 = B2 = "
        f"{want} launches ({n_sub} sub-batches x {len(heter) - 1} rounds), "
        f"first run {first:.4f} s, e2e {med['heter64']:.4f} s median of "
        f"{REPS} {[round(x, 4) for x in e2e]}")

    # round path: -m 1 (B4), -m 2 (B3)
    for flag, mode, name in (("-m 1", LOCAL_MODE, "fw_dp"),
                             ("-m 2", EXTEND_MODE, "band_dp_topo")):
        def params():
            p = Params()
            p.align_mode = mode
            return p.post_set()
        exp = serial_consensus(params(), HETER)
        reset_launches()
        bp, cons, secs = timed(params(), [heter] * N_INST)
        got = launches_now()
        want = round_shard_plan(bp, [heter] * N_INST, name, D)
        plan = sum(w["launches"][name] for w in want)
        check(all(c == [exp] for c in cons) and bp.fallbacks == 0
              and not bp.used_device_loop,
              f"shards {flag}: consensus != serial oracle")
        check(got[name] == bp.launches[name] == plan
              and sum(got.values()) == plan and bp.pipeline_shards == want,
              f"shards {flag} ({mode_of(bp)}): launches {got}, plan {plan}"
              f", shards {bp.pipeline_shards}, expected {want}")
        med[f"heter64 {flag}"] = secs
        say(f"shards {flag} ({mode_of(bp)}): {N_INST} x heter.fa == serial "
            f"oracle, fallbacks 0, {name} launched {plan} = "
            f"{plan // D} DP shard rounds x {D} device entries, one run "
            f"{secs:.4f} s")

    # seeded windows: N_SEEDED config-5 instances
    params = seeded_params()
    insts = seeded_instances(heter, N_SEEDED)
    exp = seeded_text(params, insts[:5])
    e2e = []
    for rep in range(REPS + 1):
        reset_launches()
        bp, cons, secs = timed(params, insts, seeded=True)
        got = launches_now()
        check(all(f">Consensus_sequence\n{c[0]}\n" == exp[k % 5]
                  and len(c) == 1 for k, c in enumerate(cons)),
              "shards seeded: consensus != serial oracle of its trim class")
        check(bp.fallbacks == 0 and got["band_dp_topo"] > 0
              and {k: got[k] for k in bp.launches} == bp.launches
              and got["band_dp"] == got["graph_update"] == 0,
              f"shards seeded: fallbacks {bp.fallbacks}, launches {got}, "
              f"plan {bp.launches}")
        if rep:
            e2e.append(secs)
    med["seeded-c5"] = statistics.median(e2e)
    say(f"shards seeded: {N_SEEDED} config-5 instances == serial oracle, "
        f"fallbacks 0, {bp.windows} windows, launches {bp.launches}, e2e "
        f"{med['seeded-c5']:.4f} s median of {REPS} "
        f"{[round(x, 4) for x in e2e]}")

    t0 = time.perf_counter()
    summary = dryrun_multidevice(devs)
    say(f"shards dryrun: {summary}, {time.perf_counter() - t0:.3f} s")
    say("shards: e2e (s) over " + str(devs) + " against one device: "
        + json.dumps({k: [v, E2E.get(k, "not run")]
                      for k, v in med.items()}))
    say(f"shards: phase {time.perf_counter() - t_phase:.1f} s")
    return med


def procs_phase():
    """The launcher with --procs 2 on the card: 64 x heter.fa (golden x
    64), then --seeded --config5 over 64 instances (the serial oracle of
    each trim class); the 1-process and 2-process rates."""
    from abpoa_tpu_torch.workload import seeded_instances
    import tempfile
    t_phase = time.perf_counter()
    params = seeded_params()
    exp_seeded = seeded_text(params, seeded_instances(reads_of(HETER), 5))
    out = {}
    for name, extra, want in (
            ("plain", [], GOLD.read_text() * N_INST),
            ("seeded", ["--seeded", "--config5"],
             "".join(exp_seeded[k % 5] for k in range(N_INST)))):
        with tempfile.TemporaryDirectory() as tmp:
            fa = pathlib.Path(tmp) / "gathered.fa"
            cmd = [sys.executable, "-m", "abpoa_tpu_torch.parallel.scaling",
                   "--procs", "2", "--device", "cuda",
                   "--instances", str(N_INST), "--fixture", "heter.fa",
                   "--out", str(fa)] + extra
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                               text=True, timeout=400)
            secs = time.perf_counter() - t0
            check(r.returncode == 0, f"procs {name}: launcher exited "
                  f"{r.returncode}:\n{r.stdout}\n{r.stderr[-4000:]}")
            got = fa.read_text()
        lines = [json.loads(x) for x in r.stdout.strip().splitlines()]
        summary = lines[-1]
        check(got == want, f"procs {name}: gathered bytes != expected")
        check(lines[2]["text_bytes"] is None
              and lines[1]["text_bytes"] == len(got)
              and all(ln["foreign_modules"] == [] for ln in lines[:-1])
              and all(ln["fallbacks"] == 0 for ln in lines[:-1]),
              f"procs {name}: worker lines {lines[:-1]}")
        out[name] = summary
        say(f"procs {name}: 2 processes gathered {N_INST} outputs == "
            + ("golden" if name == "plain" else "serial oracle")
            + f"; rate 1 process {summary['windows_per_s_1host']:.2f}/s, "
            f"2 processes {summary['windows_per_s_Nhosts']:.2f}/s, "
            f"cards {summary['cards']}"
            + (" (one card shared: not scaling)" if summary["cards"] == 1
               else "") + f"; launcher {secs:.1f} s")
    say(f"procs: phase {time.perf_counter() - t_phase:.1f} s")
    return out


def fuzz_phase():
    """The device-loop fuzzer on the card: 30 round-mode seeds, 11
    batch-mode seeds (seed 10: an -s read the loop sends to the oracle,
    which the forward-only capacity rule flags), all clean."""
    import contextlib
    from abpoa_tpu_torch.tools.fuzz_device_loop import main as fuzz
    for mode, n in (("round", 30), ("batch", 11)):
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fuzz(["--n", str(n), "--start", "0", "--device", "cuda",
                       "--mode", mode, "--keep-going"])
        lines = buf.getvalue().strip().splitlines()
        check(rc == 0, f"fuzz {mode}: " + "\n".join(
            ln for ln in lines if "FAIL" in ln or "ERROR" in ln))
        say(f"fuzz {mode}: {n} seeds clean "
            f"({sum(' ok ' in ln for ln in lines)} ok, "
            f"{sum('skip' in ln for ln in lines)} skipped at init), "
            f"{time.perf_counter() - t0:.1f} s")


def pipeline_phase(heter):
    """BatchPOA(pipeline=True) against pipeline=False on the cells of the
    round and seeded paths, in turns within this call (F, T, T, F, F, T
    after one checked warm-up of each): heter64-local, heter64-extend,
    seeded-c5 and -l -m 1 over N_INST x heter.fa. Every run equals the
    serial oracle with no fallback; the round-path cells' shards launch
    and count rounds as their plans imply, the seeded cell's launches
    equal its dispatch plan and its windows those of lockstep. Returns
    {cell: {mode: {e2e, runs, busy, rounds, launches per shard}}}."""
    from abpoa_tpu_torch.workload import seeded_instances
    import torch
    from abpoa_tpu_torch import BatchPOA, batch_msa_from_files
    from abpoa_tpu_torch.params import Params, LOCAL_MODE, EXTEND_MODE
    t_phase = time.perf_counter()

    def mode_params(mode):
        p = Params()
        p.align_mode = mode
        return p.post_set()
    insts = [heter] * N_INST
    c5 = seeded_instances(heter, N_SEEDED)
    sp = seeded_params()
    c5_exp = seeded_text(sp, c5[:5])
    list_exp = run_cli(["--engine", "numpy", "-m", "1",
                        str(HETER)])[0] * N_INST

    def batch_cell(mode, name):
        exp = serial_consensus(mode_params(mode), HETER)

        def run(pipe):
            bp = BatchPOA(mode_params(mode), device="cuda", pipeline=pipe)
            cons = bp.run_consensus(insts)
            check(all(c == [exp] for c in cons),
                  f"pipeline {name} ({mode_of(bp)}): != serial oracle")
            return bp, round_shard_plan(bp, insts, name)
        return run

    def seeded_run(pipe):
        bp = BatchPOA(sp, device="cuda", pipeline=pipe)
        cons = bp.run_consensus(c5, seeded=True)
        check(all(f">Consensus_sequence\n{c[0]}\n" == c5_exp[k % 5]
                  and len(c) == 1 for k, c in enumerate(cons)),
              f"pipeline seeded-c5 ({mode_of(bp)}): != serial oracle")
        check(len(bp.pipeline_shards) == (2 if pipe else 1)
              and [r["instances"] for r in bp.pipeline_shards]
              == ([N_SEEDED // 2] * 2 if pipe else [N_SEEDED]),
              f"pipeline seeded-c5: groups {bp.pipeline_shards}")
        return bp, None

    def list_run(pipe):
        out = io.StringIO()
        bp = batch_msa_from_files(mode_params(LOCAL_MODE),
                                  [str(HETER)] * N_INST, out,
                                  device="cuda", pipeline=pipe)
        check(out.getvalue() == list_exp,
              f"pipeline -l -m 1 ({mode_of(bp)}): != the serial CLI")
        return bp, round_shard_plan(bp, insts, "fw_dp")

    cells = {"heter64-local": batch_cell(LOCAL_MODE, "fw_dp"),
             "heter64-extend": batch_cell(EXTEND_MODE, "band_dp_topo"),
             "seeded-c5": seeded_run, "-l -m 1": list_run}
    res = {}
    for cell, run in cells.items():
        r = res[cell] = {}
        for pipe in (False, True):
            reset_launches()
            bp, want = run(pipe)
            got = launches_now()
            round_got = {k: got[k] for k in bp.launches}
            check(bp.fallbacks == 0 and not bp.used_device_loop
                  and round_got == bp.launches and got["band_dp"]
                  == got["graph_update"] == got["topo"] == 0,
                  f"pipeline {cell} ({mode_of(bp)}): fallbacks "
                  f"{bp.fallbacks}, launches {got}, plan {bp.launches}")
            check(want is None or bp.pipeline_shards == want,
                  f"pipeline {cell} ({mode_of(bp)}): shards "
                  f"{bp.pipeline_shards}, expected {want}")
            r["pipelined" if pipe else "lockstep"] = {
                "shards": len(bp.pipeline_shards), "rounds": bp.rounds,
                "launches_per_shard": [
                    {k: v for k, v in x["launches"].items() if v}
                    for x in bp.pipeline_shards],
                "windows": bp.windows, "runs": []}
        check(r["pipelined"]["windows"] == r["lockstep"]["windows"],
              f"pipeline {cell}: windows differ between the modes")
        for pipe in (False, True, True, False, False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bp, _want = run(pipe)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check(bp.fallbacks == 0, f"pipeline {cell}: timed run fell back")
            m = r["pipelined" if pipe else "lockstep"]
            m["runs"].append(secs)
            m["busy"] = bp.dp_busy_seconds()
        for mode in ("lockstep", "pipelined"):
            m = r[mode]
            m["e2e"] = statistics.median(m["runs"])
            say(f"pipeline {cell} {mode}: e2e {m['e2e']:.4f} s median of "
                f"{len(m['runs'])} {[round(x, 4) for x in m['runs']]}, "
                f"device busy {m['busy']:.4f} s, {m['shards']} shard(s), "
                f"rounds {m['rounds']}, launches per shard "
                f"{m['launches_per_shard']}")
        say(f"pipeline {cell}: pipelined / lockstep e2e "
            f"{r['pipelined']['e2e'] / r['lockstep']['e2e']:.4f}")
    say("pipeline: " + json.dumps(res))
    say(f"pipeline: phase {time.perf_counter() - t_phase:.1f} s")
    return res


def cli_fuzz_phase():
    """The CLI's differential fuzzer on the card (python -m
    abpoa_tpu_torch.tools.fuzz_ref, in this process): FUZZ_SERIAL
    gen_case seeds, FUZZ_LIST list seeds and FUZZ_SHAPES seeds of each
    shape class serially and under -l, the port's CLI on the card
    against its host oracle (--engine numpy). Every seed clean (equal
    bytes, failure for failure); every shape seed reached its shape and
    launched the kernel the shape should reach (``run_shape_case``);
    over the phase, every kernel of the CLI's paths (B1-B5) launched.
    One line a row: seeds, clean, shapes reached, launches, seconds."""
    import collections
    import shutil
    import tempfile
    from abpoa_tpu_torch.tools import fuzz_ref
    t_phase = time.perf_counter()
    work = pathlib.Path(tempfile.mkdtemp(prefix="abpoa_cli_fuzz."))
    sides = fuzz_ref.Sides("cuda", workdir=work)
    rows = [("serial", FUZZ_SERIAL, lambda s: fuzz_ref.run_case(s, sides)),
            ("list", FUZZ_LIST,
             lambda s: fuzz_ref.run_case(s, sides, list_mode=True))]
    for cls in fuzz_ref.SHAPES:
        for lm in (False, True):
            rows.append((cls + (" -l" if lm else ""), FUZZ_SHAPES,
                         lambda s, c=cls, lm=lm:
                         fuzz_ref.run_shape_case(c, s, sides, lm)))
    bad = []
    reset_launches()
    try:
        for name, n, run in rows:
            t0 = time.perf_counter()
            clean = reached = 0
            launched = collections.Counter()
            for seed in range(n):
                res = run(seed)
                clean += res.ok
                reached += bool(res.reached)
                launched.update(res.launches)
                if not res.ok:
                    bad.append(f"{name} seed {seed}: {res.descr} args "
                               f"{' '.join(res.args)}")
            say(f"cli fuzz {name}: {n} seeds, {clean} clean"
                + (f", {reached} reached its shape"
                   if name not in ("serial", "list") else "")
                + f", launches {dict(launched)}, "
                f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    got = launches_now()
    check(not bad, "cli fuzz: " + "\n".join(bad))
    check(all(got[k] for k in ("band_dp", "graph_update", "band_dp_topo",
                               "fw_dp", "tile_dp")),
          f"cli fuzz: a kernel of the CLI's paths never launched: {got}")
    say(f"cli fuzz: launches {got}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


def main(argv):
    # --dp-only: the card, the build, phases 3-3e (the kernels against
    # their plain versions) and 3f (the DP kernels' times), then stop;
    # --baseline DIR: phase 3f also times an earlier checkout's DP kernels
    dp_only = "--dp-only" in argv
    multi_only = "--multi-only" in argv
    pipeline_only = "--pipeline-only" in argv
    fuzz_only = "--fuzz-only" in argv
    envelope_only = "--envelope-only" in argv
    round_envelope_only = "--round-envelope-only" in argv
    base_dir = argv[argv.index("--baseline") + 1] if "--baseline" in argv \
        else None
    try:
        import torch
    except ImportError:
        print("FAILED: torch is not installed", file=sys.stderr)
        return 2
    if not (ROOT / "abpoa_tpu_torch").is_dir():
        print("FAILED: run from a checkout of the repository "
              "(abpoa_tpu_torch/ not found)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()

    # ---- 1. card ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} x{torch.cuda.device_count()}")

    # ---- 2. build ----
    from abpoa_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    say(f"build: {build_s:.3f} s ({', '.join(p.name for p in libs.values())}"
        f"; nvcc {_build.build_seconds or 0:.3f} s)")

    heter = reads_of(HETER)
    if fuzz_only:
        # ---- 18 alone: the CLI's differential fuzzer ----
        cli_fuzz_phase()
        say(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0
    if envelope_only:
        # ---- 4c alone: the loop's envelope ----
        env_rec, env_launches = envelope_phase(dev, heter)
        say(json.dumps({"envelope": env_rec, "launches": env_launches}))
        say(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0
    if round_envelope_only:
        # ---- 4d alone: the round path's envelope ----
        renv_rec, renv_launches = round_envelope_phase(dev, heter)
        say(json.dumps({"round_envelope": renv_rec,
                        "launches": renv_launches}))
        say(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0
    if pipeline_only:
        # ---- 16 alone: pipelined against lockstep ----
        pipeline_phase(heter)
        say(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0
    if multi_only:
        # ---- 13-15 alone: shards, processes, the fuzzer ----
        shards_phase(heter)
        procs_phase()
        fuzz_phase()
        say(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0

    # ---- 3. device-loop kernels vs plain ----
    rec = kernel_phase(dev, heter)

    # ---- 3b. round-path kernels vs plain ----
    rec.update(round_kernel_phase(dev, heter))

    # ---- 3c. banded-tile DP vs plain ----
    rec.update(tile_kernel_phase(dev, heter))

    # ---- 3d. graph kernel, wmode 1 (qv weights), vs plain ----
    rec.update(qv_kernel_phase(dev, heter))

    # ---- 3e. window-round kernels (B3 non-fresh, B4 row mask) ----
    window_rec = window_kernel_phase(dev, heter)

    def dp_phase():
        # ---- 3f. the DP kernels' times: shapes, path B, sweep, baseline;
        # B4 on the serial -S path's own windows vs plain ----
        base = baseline_kernels(base_dir) if base_dir else {}
        say("dp timing: baseline kernels "
            + (f"of {base_dir}" if base else "absent"))
        win = serial_windows()
        timing = dp_timing_phase(dev, heter, base, win)
        timing.update(graph_timing_phase(dev, heter, base))
        window_rec["fw_dp_window"] = serial_window_phase(
            win, window_rec.pop("fw_dp"))
        timing["band_dp_topo"].update(
            {f"fetch_{k}": v for k, v in fetch_phase(dev, heter).items()})
        return timing
    if dp_only:
        timing = dp_phase()
        say(json.dumps({"dp_timing": timing, "window": window_rec}))
        say(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0

    # ---- 4. device loop ----
    from abpoa_tpu_torch import BatchPOA, batch_msa_from_files
    from abpoa_tpu_torch.params import Params
    gold = GOLD.read_text().split("\n")[1]
    bp = BatchPOA(Params().post_set(), device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    cons = bp.run_consensus([heter] * N_INST)
    first_s = time.perf_counter() - t0
    got = launches_now()
    launches = {"band_dp": got["band_dp"],
                "graph_update": got["graph_update"]}
    from abpoa_tpu_torch.parallel.batch import SPLIT_MIN
    n_sub = 2 if N_INST >= SPLIT_MIN else 1
    check(all(c == [gold] for c in cons), "slice: consensus != golden")
    check(bp.used_device_loop, "slice: device loop not used")
    check(bp.fallbacks == 0, f"slice: {bp.fallbacks} oracle fallbacks")
    for name, n in launches.items():
        check(n == (len(heter) - 1) * n_sub,
              f"slice: {name} launched {n} times, expected "
              f"{(len(heter) - 1) * n_sub}")
    check(got["band_dp_topo"] == got["fw_dp"] == got["tile_dp"]
          == got["topo"] == 0, f"slice: other kernels launched {got}")
    say(f"slice: {N_INST} x heter.fa golden consensus, fallbacks 0, "
        f"launches {launches}, first run {first_s:.4f} s")
    e2e = []
    for _ in range(REPS):
        bp = BatchPOA(Params().post_set(), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cons = bp.run_consensus([heter] * N_INST)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
        check(all(c == [gold] for c in cons) and bp.fallbacks == 0,
              "slice: timed run != golden")
    med = statistics.median(e2e)
    E2E["heter64"] = med
    say(f"slice: e2e {med:.4f} s median of {REPS} {[round(x, 4) for x in e2e]}"
        f", device-loop phase {bp.dp_busy_seconds():.4f} s, dp_cells "
        f"{bp.dp_cells}, dp_cells/s {bp.dp_cells / med:.1f}")

    # ---- 4b. qv device loop, -l -Q ----
    launches["graph_update_qv"] = qv_loop_phase(dev, heter)

    # ---- 4c. the loop envelope: B2 in global memory, B1 past 1024
    # lanes ----
    env_rec, env_launches = envelope_phase(dev, heter)
    rec.update(env_rec)
    launches.update(env_launches)

    # ---- 4d. the round envelope: B3 past 1024 lanes and past 16
    # predecessor slots ----
    renv_rec, renv_launches = round_envelope_phase(dev, heter)
    rec.update(renv_rec)
    launches.update(renv_launches)

    # ---- 5. list mode ----
    out = io.StringIO()
    batch_msa_from_files(Params().post_set(), [str(HETER)] * 4, out,
                         device="cuda")
    check(out.getvalue() == GOLD.read_text() * 4, "list mode != golden")
    say("list mode: 4 x heter.fa golden bytes")

    # ---- 6. round path ----
    launches.update(round_path_phase(dev, heter))

    # ---- 7. round-path list mode ----
    round_list_phase(dev)

    # ---- 8. CLI serial engine ----
    launches["tile_dp"] = cli_serial_phase(len(heter))

    # ---- 8b. CLI -S through the serial engine's window path ----
    launches["fw_dp_window"] = cli_seeded_phase()

    # ---- 9. CLI list mode ----
    cli_list_phase(len(heter))

    # ---- 10. split device round, B6 ----
    topo_rec, launches["topo"] = split_round_phase(dev, heter)
    rec.update(topo_rec)

    # ---- 11. seeded window rounds ----
    launches["band_dp_topo_window"] = seeded_phase(dev, heter)["band_dp_topo"]

    # ---- 12. long reads: past 4096 graph nodes ----
    long_rec = long_read_phase()

    # ---- 13. shards: BatchPOA(devices=...) ----
    shards_phase(heter)

    # ---- 14. processes: the launcher, gloo gather ----
    procs_phase()

    # ---- 15. the device-loop fuzzer ----
    fuzz_phase()

    # ---- 16. the host/device pipeline against lockstep ----
    pipeline_phase(heter)

    # ---- 18. the CLI's differential fuzzer ----
    cli_fuzz_phase()

    # ---- 3f, after the end-to-end phases (its buffers and builds do not
    # weigh on their times) ----
    timing = dp_phase()

    src = {"band_dp": ("abpoa_tpu_torch/csrc/band_dp.cu",
                       "abpoa_tpu/ops/dp_pallas_band.py:132"),
           "graph_update": ("abpoa_tpu_torch/csrc/graph_update.cu",
                            "abpoa_tpu/ops/poa_loop.py:840"),
           "graph_update_qv": ("abpoa_tpu_torch/csrc/graph_update.cu",
                               "abpoa_tpu/ops/poa_loop.py:840"),
           "graph_update_global": ("abpoa_tpu_torch/csrc/graph_update.cu",
                                   "abpoa_tpu/ops/poa_loop.py:840"),
           "graph_update_qv_global": (
               "abpoa_tpu_torch/csrc/graph_update.cu",
               "abpoa_tpu/ops/poa_loop.py:840"),
           "band_dp_wide": ("abpoa_tpu_torch/csrc/band_dp.cu",
                            "abpoa_tpu/ops/dp_pallas_band.py:132"),
           "band_dp_topo": ("abpoa_tpu_torch/csrc/band_dp.cu",
                            "abpoa_tpu/ops/dp_pallas_band.py:1247"),
           "band_dp_topo_wide": ("abpoa_tpu_torch/csrc/band_dp.cu",
                                 "abpoa_tpu/ops/dp_pallas_band.py:1247"),
           "band_dp_topo_fan": ("abpoa_tpu_torch/csrc/band_dp.cu",
                                "abpoa_tpu/ops/dp_pallas_band.py:1247"),
           "fw_dp": ("abpoa_tpu_torch/csrc/fw_dp.cu",
                     "abpoa_tpu/ops/dp_pallas_fw.py:746"),
           "tile_dp": ("abpoa_tpu_torch/csrc/tile_dp.cu",
                       "abpoa_tpu/ops/dp_pallas.py:713"),
           "topo": ("abpoa_tpu_torch/csrc/topo.cu",
                    "abpoa_tpu/ops/poa_loop.py:467"),
           "band_dp_topo_window": ("abpoa_tpu_torch/csrc/band_dp.cu",
                                   "abpoa_tpu/ops/dp_pallas_band.py:1247"),
           "fw_dp_window": ("abpoa_tpu_torch/csrc/fw_dp.cu",
                            "abpoa_tpu/ops/dp_pallas_fw.py:746")}
    rec["band_dp_topo_window"] = window_rec["band_dp_topo"]
    rec["fw_dp_window"] = window_rec["fw_dp_window"]
    kernels = []
    for name, (source, replaces) in src.items():
        r = rec[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        **{k: v for k, v in r.items()
                           if k.startswith("round_B") or k == "plain_on"},
                        **timing.get(name, {})})
    say(f"long reads e2e (s): {json.dumps(long_rec)}")
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
