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
  * the phases of one more run under ``abpoa_tpu_torch.trace.recording()``:
    each span's self seconds, its count and its work units
    (``abpoa.seed``, ``.sort``, ``.export``, ``.dispatch``, ``.wait``,
    ``.replay``, ``.advance``, ``.fuse``, ``.consensus``; the root
    ``abpoa.batch``'s self time is the rest of the run);
  * torch.profiler over one more run: device time and launches per
    kernel, device busy time (the union of all device intervals, copies
    included) and the device's idle share of that run.
With --seeded, instead, run_seeded over --n-seeded config-5-shaped
instances (heter.fa reads, instance k trimmed by (k % 5) * 120): the
same e2e, phases and profile, plus windows/s; pipelined (two groups,
the default) and in lockstep.
Then the serial device engine through the CLI (``abpoa_tpu_torch.cli``
main, default flags, tests/data/heter.fa): e2e median of --reps runs,
and the per-read phases of one recorded run (each span's self ms over
the reads fused; the root ``abpoa.cli`` holds argument parsing, the
files and the telemetry line). A profiled run gives the device busy
time and idle share.
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


def phases(buf):
    """span name -> (self seconds, spans, work units) of a recording."""
    from abpoa_tpu_torch import trace
    return {k: (v["self_ns"] / 1e9, v["count"], v["n"])
            for k, v in trace.summary(buf.records).items()}


def phase_line(ph, scale=1.0, unit="s"):
    return ", ".join(f"{k} {v[0] * scale:.4f} {unit} ({v[1]} spans, "
                     f"{v[2]} units)"
                     for k, v in sorted(ph.items(), key=lambda kv: -kv[1][0]))


def run_once(make_bp, insts, **kw):
    import torch
    bp = make_bp()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cons = bp.run_consensus(insts, **kw)
    torch.cuda.synchronize()
    return bp, cons, time.perf_counter() - t0


def device_ops(prof):
    """The profiler's device operations: kernels and copies, not the
    device-side ranges of the port's spans (user annotations)."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]


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
    from torch.profiler import ProfilerActivity, profile
    from abpoa_tpu_torch import trace
    _bp, cons0, warm = run_once(make_bp, insts, **kw)
    e2e = [run_once(make_bp, insts, **kw)[2] for _ in range(reps)]
    med = statistics.median(e2e)
    with trace.recording() as buf:
        bp, cons, t_ph = run_once(make_bp, insts, **kw)
    if cons != cons0:
        raise SystemExit(f"FAILED: {name}: runs disagree")
    ph = phases(buf)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _b, _c, t_prof = run_once(make_bp, insts, **kw)
    dev = device_ops(prof)
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
    say(f"{name}: phases of one run of {t_ph:.4f} s (self time): "
        + phase_line(ph))
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
    from torch.profiler import ProfilerActivity, profile
    from abpoa_tpu_torch import trace
    from abpoa_tpu_torch.align import engine_torch as ET
    from abpoa_tpu_torch.ops.fw_dp import fw_poa_dp_batch
    from abpoa_tpu_torch.ops.tile_dp import tile_poa_dp_batch
    wrappers = {"tile_dp": tile_poa_dp_batch, "fw_dp": fw_poa_dp_batch}
    args = [str(HETER)]
    warm = run_cli(args)
    e2e = [run_cli(args) for _ in range(reps)]
    med = statistics.median(e2e)
    for w in wrappers.values():
        w.launches = 0
    ET.reroutes.update(M_OVFL=0, M_FAIL=0)
    with trace.recording() as buf:
        t_ph = run_cli(args)
    launches = {k: w.launches for k, w in wrappers.items()}
    ph = phases(buf)
    n = ph["abpoa.fuse"][1]          # reads fused
    per_read = {k: v[0] / n * 1e3 for k, v in ph.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_prof = run_cli(args)
    dev = device_ops(prof)
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
        f"launches of the recorded run {launches}, B5 re-run on B4 "
        f"{ET.reroutes}")
    say(f"serial: per read (self ms over {n} reads fused, recorded run "
        f"{t_ph:.4f} s): " + phase_line(ph, 1e3 / n, "ms"))
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
