#!/usr/bin/env python3
"""Smoke run of abpoa_tpu_torch, the PyTorch + CUDA port, on one GPU.

    python chip_smoke.py

Phases (each prints its own lines; any failed check exits non-zero):
  1. card   -- nvidia-smi name and power limit; no CUDA -> exit 2
  2. build  -- nvcc builds the kernels of abpoa_tpu_torch/csrc
  3. kernels vs plain, on the card, at the bench geometry (heter.fa:
     R=1024, WB=384, LS=2176): band DP and graph update against their
     plain PyTorch versions on real round inputs, bit-equal; times of
     both
  4. slice  -- BatchPOA(device="cuda").run_consensus over 64 x heter.fa:
     golden consensus bytes, no oracle fallback, every round through
     both kernels (launch counts); e2e seconds and DP cells/s
  5. list mode -- batch_msa_from_files over 4 x heter.fa writes the
     golden bytes 4 times
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
import io
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HETER = ROOT / "tests" / "data" / "heter.fa"
GOLD = ROOT / "tests" / "golden_sanitized" / "heter_cons.fa"
N_INST = 64      # instances of heter.fa in the slice (the bench workload)
N_CMP = 8        # instances in the kernel-vs-plain phase
REPS = 3         # timed slice runs after one warm-up


def say(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def reads_of(path):
    import numpy as np
    from abpoa_tpu.seqio import read_seqs
    from abpoa_tpu.alphabet import encode_table
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(path))]


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


def kernel_phase(dev, heter):
    """Both kernels against their plain versions on the inputs of real
    rounds: round 1 (state after read 0) and the last round (state after
    the kernels ran every earlier round, with mismatch bundles)."""
    import numpy as np
    import torch
    from abpoa_tpu.graph import NativeGraph, POAGraph
    from abpoa_tpu.params import Params
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
    graphs = []
    for reads in insts:
        g = NativeGraph() if NativeGraph.available() else POAGraph()
        g.add_graph_alignment(params, reads[0], [1] * len(reads[0]), [],
                              None, 0, True)
        g.topological_sort(params)
        graphs.append(g)
    st, i2n, n2i, rem = pl.init_state_np(graphs, cfg)
    ps = pl.pack_state(cfg, pl.GState(*(torch.from_numpy(x).to(dev)
                                        for x in st)),
                       *(torch.from_numpy(x).to(dev) for x in (i2n, n2i, rem)))
    base = torch.from_numpy(pl.make_scal_base(params, cfg)).to(dev)
    qc = np.zeros((cfg.NR, cfg.B, cfg.Wq), np.int8)
    ql = np.zeros((cfg.NR, cfg.B), np.int32)
    for b, reads in enumerate(insts):
        for r, q in enumerate(reads[1:]):
            qc[r, b, 1:len(q) + 1] = q
            ql[r, b] = len(q)
    qc_d = torch.from_numpy(qc).to(dev)
    ql_d = torch.from_numpy(ql).to(dev)
    bc = pl.band_config(cfg)
    qpf = bd.build_qpf(bc, base[L.S_NSCAL:], qc_d)
    qp4 = pl.pack_qp4(cfg, qc_d)
    wf1000 = round(params.wf * 1000)
    err = {"band_dp": 0, "graph_update": 0}
    times = {}
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
        err["band_dp"] = max(err["band_dp"], dm)
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
        err["graph_update"] = max(err["graph_update"], dm)
        check(dm == 0, f"round {r}: graph kernel != plain (max |d| {dm})")
        say(f"kernels: round {r + 1} graph_update == plain "
            f"(node_n {gr.node_n.tolist()})")
        if r == cfg.NR - 1:
            times["band_dp"] = (
                cuda_ms(lambda: (lambda: bd.band_poa_dp_packed(*args)), 20),
                host_ms(lambda: (lambda: bd.band_poa_dp_packed_ref(*args)),
                        2))

            def fresh_kernel():
                c = pl.PackedState(*(x.clone() for x in ps))
                return lambda: gu.graph_update_packed(cfg, c, ks, km,
                                                      ql_d[r], qp4[r])
            times["graph_update"] = (
                cuda_ms(fresh_kernel, 20),
                host_ms(lambda: (lambda: gu.graph_update_packed_ref(
                    cfg, ps, rs, rm, ql_d[r], qp4[r])), 2))
        ps = gk
    for name, (k, p) in times.items():
        say(f"time: {name} kernel {k:.4f} ms, plain {p:.4f} ms "
            f"(B={cfg.B}, round {cfg.NR})")
    return err, times


def main():
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
    _build.library()
    build_s = time.perf_counter() - t0
    say(f"build: {build_s:.3f} s ({_build.library_path().name}; nvcc "
        f"{_build.build_seconds if _build.build_seconds is not None else 0:.3f} s)")

    # ---- 3. kernels vs plain ----
    heter = reads_of(HETER)
    err, times = kernel_phase(dev, heter)

    # ---- 4. slice ----
    from abpoa_tpu.params import Params
    from abpoa_tpu_torch import BatchPOA, batch_msa_from_files
    from abpoa_tpu_torch.ops.band_dp import band_poa_dp_packed
    from abpoa_tpu_torch.ops.graph_update import graph_update_packed
    gold = GOLD.read_text().split("\n")[1]
    band_poa_dp_packed.launches = 0
    graph_update_packed.launches = 0
    bp = BatchPOA(Params().post_set(), device="cuda")
    t0 = time.perf_counter()
    cons = bp.run_consensus([heter] * N_INST)
    first_s = time.perf_counter() - t0
    launches = {"band_dp": band_poa_dp_packed.launches,
                "graph_update": graph_update_packed.launches}
    from abpoa_tpu_torch.parallel.batch import SPLIT_MIN
    n_sub = 2 if N_INST >= SPLIT_MIN else 1
    check(all(c == [gold] for c in cons), "slice: consensus != golden")
    check(bp.used_device_loop, "slice: device loop not used")
    check(bp.fallbacks == 0, f"slice: {bp.fallbacks} oracle fallbacks")
    for name, n in launches.items():
        check(n == (len(heter) - 1) * n_sub,
              f"slice: {name} launched {n} times, expected "
              f"{(len(heter) - 1) * n_sub}")
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
    say(f"slice: e2e {med:.4f} s median of {REPS} {[round(x, 4) for x in e2e]}"
        f", device-loop phase {bp.dp_busy_seconds():.4f} s, dp_cells "
        f"{bp.dp_cells}, dp_cells/s {bp.dp_cells / med:.1f}")

    # ---- 5. list mode ----
    out = io.StringIO()
    batch_msa_from_files(Params().post_set(), [str(HETER)] * 4, out,
                         device="cuda")
    check(out.getvalue() == GOLD.read_text() * 4, "list mode != golden")
    say("list mode: 4 x heter.fa golden bytes")

    rec = {"kernels": [
        {"name": "band_dp", "route": "cuda",
         "source": "abpoa_tpu_torch/csrc/band_dp.cu",
         "replaces": "abpoa_tpu/ops/dp_pallas_band.py:132",
         "launches": launches["band_dp"], "max_abs_err": err["band_dp"],
         "ms": times["band_dp"][0], "plain_ms": times["band_dp"][1]},
        {"name": "graph_update", "route": "cuda",
         "source": "abpoa_tpu_torch/csrc/graph_update.cu",
         "replaces": "abpoa_tpu/ops/poa_loop.py:840",
         "launches": launches["graph_update"],
         "max_abs_err": err["graph_update"],
         "ms": times["graph_update"][0],
         "plain_ms": times["graph_update"][1]}]}
    say(json.dumps(rec))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
