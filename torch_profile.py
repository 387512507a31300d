#!/usr/bin/env python3
"""Where the time of abpoa_tpu_torch's BatchPOA and serial engine goes,
on one GPU.

    python torch_profile.py [--n-inst 64] [--reps 3] [--serial-only]
                            [--seeded] [--n-seeded 1024]

For each path of the port over N x tests/data/heter.fa -- the device
loop (default parameters), the device loop with qv weights (rng 77,
wmode 1), the round path with -m 1 (full-width DP kernel) and with -m 2
(topo-mode band DP kernel), each round path in the default host/device
pipeline and in lockstep (BatchPOA(pipeline=False)) -- after one warm-up
run (which also builds the kernels):
  * e2e seconds of run_consensus, median of --reps runs (host clock
    around a run that ends in torch.cuda.synchronize());
  * the wall seconds of each host phase of one more run, timed on the
    calling thread around the port's own functions: aligner set-up,
    per-round sort + export (on the host pool), re-pad, dispatch plan
    (make_pallas_inputs), the device phases (upload, kernel, fetch:
    BatchPOA.dp_intervals), step-stream fusion, consensus; for the
    device loop, state build + enqueue and the replay;
  * torch.profiler over one more run: device time and launches per
    kernel, device busy time (the union of all device intervals, copies
    included) and the device's idle share of that run.
With --seeded, instead, run_seeded over --n-seeded config-5-shaped
instances (heter.fa reads, instance k trimmed by (k % 5) * 120): the
same e2e, phases and profile, the host phases being seeding and chaining
(per instance), window export (export_dense of each pending window, on
the host pool), dispatch (round_plan: make_pallas_inputs), the device
phases, the window results (band-state write-back, step replay into the
cigar) and fusion (the request generators' advance, which fuses each
finished read), plus windows/s; pipelined (two groups, the default)
and in lockstep.
Then the serial device engine through the CLI (``abpoa_tpu_torch.cli``
main, default flags, tests/data/heter.fa): e2e median of --reps runs,
and the per-read split of one run into host sort, export
(export_dense + make_pallas_inputs), upload, the B5 launch (wrapper +
kernel, synchronised), the misc fetch, the rest of the engine call
(band-state write-back, step fetch), replay (steps -> cigar) and fusion
(add_graph_alignment); each device phase ends in a synchronise, so the
split run is slower than an unsplit one. A profiled run gives the
device busy time and idle share.
Prints one line per measurement, then one JSON object per path. Needs
CUDA: exits 2 without it.
"""
import argparse
import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HETER = ROOT / "tests" / "data" / "heter.fa"


def say(*a):
    print(*a, flush=True)


class PhaseTimer:
    """Wall seconds per phase name, accumulated by wrapped callables."""

    def __init__(self):
        self.s = {}
        self._undo = []

    def add(self, key, dt):
        self.s[key] = self.s.get(key, 0.0) + dt

    def wrap(self, owner, attr, key):
        fn = getattr(owner, attr)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.add(key, time.perf_counter() - t0)
        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


class TimedPool:
    """The host pool, with the maps of the phases it runs outside the
    wrapped functions timed (sort + export, consensus)."""
    NAMES = {"sort_export": "sort + export", "cons_one": "consensus"}

    def __init__(self, pool, timer):
        self.pool, self.timer = pool, timer

    def map(self, fn, *its):
        t0 = time.perf_counter()
        out = list(self.pool.map(fn, *its))
        if fn.__name__ in self.NAMES:
            self.timer.add(self.NAMES[fn.__name__],
                           time.perf_counter() - t0)
        return out

    def submit(self, *a, **k):
        return self.pool.submit(*a, **k)


@contextlib.contextmanager
def phases(timer):
    from abpoa_tpu_torch.parallel import batch as B
    from abpoa_tpu_torch.align import export as X
    orig, pool = B._host_pool, B._host_pool()
    B._host_pool = lambda: TimedPool(pool, timer)
    timer.wrap(B, "_make_aligners", "aligners")
    timer.wrap(X, "repad_dense", "repad")
    timer.wrap(B, "round_plan", "plan (make_pallas_inputs)")
    timer.wrap(B._Rounds, "_collect", "fusion (_collect)")
    timer.wrap(B._DeviceLoop, "_launch", "state build + enqueue")
    timer.wrap(B._DeviceLoop, "_replay", "replay (+ consensus)")
    timer.wrap(B._Windows, "_start", "seeding + chaining")
    timer.wrap(B._Windows, "_export", "window export")
    timer.wrap(B._Windows, "_apply", "window results (write-back, replay)")
    timer.wrap(B._Windows, "_advance", "fusion (generator advance)")
    timer.wrap(B._Windows, "_oracle", "empty windows (oracle)")
    try:
        yield
    finally:
        timer.restore()
        B._host_pool = orig


def run_once(make_bp, insts, **kw):
    import torch
    bp = make_bp()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cons = bp.run_consensus(insts, **kw)
    torch.cuda.synchronize()
    return bp, cons, time.perf_counter() - t0


def union(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile_path(name, make_bp, insts, reps, card, **kw):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _bp, cons0, warm = run_once(make_bp, insts, **kw)
    e2e = [run_once(make_bp, insts, **kw)[2] for _ in range(reps)]
    med = statistics.median(e2e)
    timer = PhaseTimer()
    with phases(timer):
        bp, cons, t_ph = run_once(make_bp, insts, **kw)
    if cons != cons0:
        raise SystemExit(f"FAILED: {name}: runs disagree")
    ph = dict(timer.s)
    # the round path's device phases are upload + kernel + fetch; the
    # device loop's also hold its state build and enqueue
    ph["device phases"] = bp.dp_busy_seconds()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _b, _c, t_prof = run_once(make_bp, insts, **kw)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kern = {}
    for e in dev:
        k = kern.setdefault(e.name, [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) / 1e3
        k[1] += 1
    busy = union((e.time_range.start, e.time_range.end) for e in dev) / 1e6
    rec = {"path": name, "card": card, "n_inst": len(insts),
           "warmup_s": warm, "e2e_s": e2e, "e2e_median_s": med,
           "rounds": bp.rounds, "launches": bp.launches,
           "fallbacks": bp.fallbacks, "dp_cells": bp.dp_cells,
           "windows": bp.windows, "windows_per_s": bp.windows / med,
           "dp_cells_per_s": bp.dp_cells / med,
           "phase_run_s": t_ph, "phases_s": ph,
           "profiled_run_s": t_prof, "device_busy_s": busy,
           "device_idle_share": 1 - busy / t_prof,
           "device_ms_by_kernel": {k: {"ms": v[0], "n": v[1]}
                                   for k, v in sorted(
                                       kern.items(), key=lambda kv: -kv[1][0])
                                   if v[0] >= 0.05}}
    say(f"{name}: e2e {med:.4f} s median of {reps} "
        f"{[round(x, 4) for x in e2e]} (warm-up {warm:.4f} s), "
        f"{bp.rounds} rounds, fallbacks {bp.fallbacks}, "
        f"{bp.dp_cells / med:.1f} DP cells/s, {bp.windows} windows "
        f"({bp.windows / med:.1f}/s)")
    say(f"{name}: phases of one run of {t_ph:.4f} s: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(ph.items(), key=lambda kv: -kv[1])))
    say(f"{name}: profiled run {t_prof:.4f} s, device busy {busy:.4f} s, "
        f"idle {100 * (1 - busy / t_prof):.1f} %")
    for k, v in list(rec["device_ms_by_kernel"].items())[:6]:
        say(f"{name}:   {v['ms']:.3f} ms over {v['n']} x {k[:70]}")
    return rec


def run_cli(args):
    """Wall seconds of the port's CLI main on `args` (output dropped),
    ending in a device synchronise."""
    import io
    import torch
    from abpoa_tpu_torch.cli import main
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(args))
    torch.cuda.synchronize()
    if rc != 0:
        raise SystemExit(f"FAILED: CLI {args}: {err.getvalue()[-2000:]}")
    return time.perf_counter() - t0


def profile_serial(reps, card):
    """The CLI's serial device engine on heter.fa: e2e and the per-read
    phase split."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from abpoa_tpu_torch.align import engine_torch as ET
    from abpoa_tpu_torch.align import export as X
    from abpoa_tpu_torch.graph import POAGraph
    from abpoa_tpu_torch.ops import steps as S
    from abpoa_tpu_torch.ops.fw_dp import fw_poa_dp_batch
    from abpoa_tpu_torch.ops.tile_dp import tile_poa_dp_batch
    wrappers = {"tile_dp": tile_poa_dp_batch, "fw_dp": fw_poa_dp_batch}
    args = [str(HETER)]
    warm = run_cli(args)
    e2e = [run_cli(args) for _ in range(reps)]
    med = statistics.median(e2e)
    timer = PhaseTimer()
    orig_run = ET._run

    def split_run(kernel, cfg, arrs, dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ins = [torch.from_numpy(np.ascontiguousarray(a))[None].to(dev)
               for a in arrs]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = kernel(cfg, *ins)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        misc = out.misc[0].cpu().numpy()
        t3 = time.perf_counter()
        timer.add("upload", t1 - t0)
        timer.add(f"launch {kernel.__name__}", t2 - t1)
        timer.add("fetch misc", t3 - t2)
        return out, misc
    ET._run = split_run
    timer.wrap(POAGraph, "topological_sort", "host sort")
    timer.wrap(X, "export_dense", "export")
    timer.wrap(X, "make_pallas_inputs", "export")
    timer.wrap(S, "replay_steps", "replay")
    timer.wrap(POAGraph, "add_graph_alignment", "fusion")
    timer.wrap(ET, "align_sequence_to_graph_device", "engine call")
    for w in wrappers.values():
        w.launches = 0
    ET.reroutes.update(M_OVFL=0, M_FAIL=0)
    try:
        t_ph = run_cli(args)
    finally:
        timer.restore()
        ET._run = orig_run
    launches = {k: w.launches for k, w in wrappers.items()}
    n = sum(launches.values())
    ph = dict(timer.s)
    inner = sum(v for k, v in ph.items()
                if k in ("export", "upload", "fetch misc", "replay")
                or k.startswith("launch"))
    ph["engine rest (write-back, step fetch)"] = ph.pop("engine call") - inner
    per_read = {k: v / n * 1e3 for k, v in ph.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_prof = run_cli(args)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = union((e.time_range.start, e.time_range.end) for e in dev) / 1e6
    kern = {}
    for e in dev:
        k = kern.setdefault(e.name, [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) / 1e3
        k[1] += 1
    rec = {"path": "CLI serial engine, heter.fa", "card": card,
           "warmup_s": warm, "e2e_s": e2e, "e2e_median_s": med,
           "launches": launches, "reroutes": dict(ET.reroutes),
           "phase_run_s": t_ph,
           "phases_s": ph, "per_read_ms": per_read,
           "profiled_run_s": t_prof, "device_busy_s": busy,
           "device_idle_share": 1 - busy / t_prof,
           "device_ms_by_kernel": {k: {"ms": v[0], "n": v[1]}
                                   for k, v in sorted(
                                       kern.items(), key=lambda kv: -kv[1][0])
                                   if v[0] >= 0.05}}
    say(f"serial: e2e {med:.4f} s median of {reps} "
        f"{[round(x, 4) for x in e2e]} (warm-up {warm:.4f} s), "
        f"launches of the split run {launches}, B5 re-run on B4 "
        f"{ET.reroutes}")
    say(f"serial: per read (ms, {n} aligned reads, split run {t_ph:.4f} s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    sorted(per_read.items(), key=lambda kv: -kv[1])))
    say(f"serial: profiled run {t_prof:.4f} s, device busy {busy:.4f} s, "
        f"idle {100 * (1 - busy / t_prof):.1f} %")
    for k, v in list(rec["device_ms_by_kernel"].items())[:6]:
        say(f"serial:   {v['ms']:.3f} ms over {v['n']} x {k[:70]}")
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-inst", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--serial-only", action="store_true",
                    help="profile only the CLI's serial device engine")
    ap.add_argument("--seeded", action="store_true",
                    help="profile only run_seeded on the config-5 shape")
    ap.add_argument("--n-seeded", type=int, default=1024)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.alphabet import encode_table
    from abpoa_tpu_torch.params import (Params, GLOBAL_MODE, LOCAL_MODE,
                                        EXTEND_MODE)
    from abpoa_tpu_torch.seqio import read_seqs
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True
                          ).stdout.strip().splitlines()[0]
    say(card)
    tab = encode_table(5)
    heter = [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
             for r in read_seqs(str(HETER))]
    insts = [heter] * args.n_inst

    def maker(mode, seeded=False, pipeline=True):
        def make():
            p = Params()
            p.align_mode = mode
            p.disable_seeding = not seeded
            return BatchPOA(p.post_set(), device="cuda", pipeline=pipeline)
        return make
    if args.seeded:
        seeded = [[q[:max(64, len(q) - (k % 5) * 120)] for q in heter]
                  for k in range(args.n_seeded)]
        recs = [profile_path(f"seeded (config 5){tag}",
                             maker(GLOBAL_MODE, True, pipe), seeded,
                             args.reps, card, seeded=True)
                for tag, pipe in (("", True), (" lockstep", False))]
    elif args.serial_only:
        recs = [profile_serial(args.reps, card)]
    else:
        rng = np.random.default_rng(77)
        qv = [[rng.integers(1, 60, len(q)).tolist() for q in reads]
              for reads in insts]
        recs = [profile_path(name, maker(mode, pipeline=pipe), insts,
                             args.reps, card, **kw)
                for name, mode, pipe, kw in (
                    ("device loop", GLOBAL_MODE, True, {}),
                    ("device loop qv", GLOBAL_MODE, True, {"weights": qv}),
                    ("rounds -m 1", LOCAL_MODE, True, {}),
                    ("rounds -m 1 lockstep", LOCAL_MODE, False, {}),
                    ("rounds -m 2", EXTEND_MODE, True, {}),
                    ("rounds -m 2 lockstep", EXTEND_MODE, False, {}))]
        recs.append(profile_serial(args.reps, card))
    for r in recs:
        say(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
