"""Scaling harness of the port: consensus windows/s over shards, then
over processes.

Counterpart of ``benchmarks/scaling.py``. Instances are independent:
within a process they split into shards over a device list
(``BatchPOA(devices=...)``), across processes the instance list splits
per process and process 0 gathers the rendered text
(``parallel/multihost.py``, gloo).

    python -m abpoa_tpu_torch.parallel.scaling [--shards N]
        # device sweep in this process: 1, ceil(N/2) and N shards over
        # the visible cards (a card repeats when there are fewer cards
        # than shards; each line says how many cards it used)
    python -m abpoa_tpu_torch.parallel.scaling --procs M [--out FILE]
        # spawns a 1-process run and then M fresh interpreters that
        # rendezvous through a file:// store in a temporary directory,
        # each running its shard; process 0 writes the gathered output
        # to --out; the last line is the strong-scaling summary
    --device cpu|cuda  --instances N  --fixture NAME  --seeded  --no-warm
    --config5   instance k's reads trimmed at the end by (k % 5) * 120
                bases (at least 64 kept): the config-5 shape
                (``workload.seeded_instances``)

Every line is one JSON object. Shards or processes that share one card
measure the pipeline, not scaling: the card's work does not grow.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
FOREIGN = ("abpoa_tpu", "jax", "jaxlib")


def _load_instances(fixture: str, n: int, config5=False):
    from ..workload import load_reads, seeded_instances
    reads = load_reads(fixture)
    return seeded_instances(reads, n) if config5 else [reads] * n


def _params(args):
    """Default params; --seeded turns on minimizer seeding (-S)."""
    from ..params import Params
    p = Params()
    if args.seeded:
        p.disable_seeding = 0
    return p.post_set()


def _sync(device):
    import torch
    if device != "cpu":
        torch.cuda.synchronize()


def _shard_devices(device: str, n: int) -> tuple[list[str], int]:
    """n shards over the visible cards (repeating them) or the CPU;
    returns (device list, cards used)."""
    if device == "cpu":
        return ["cpu"] * n, 0
    import torch
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("--device cuda: no CUDA device")
    return [f"cuda:{i % count}" for i in range(n)], min(n, count)


def device_sweep(args):
    import torch
    from .batch import BatchPOA
    instances = _load_instances(args.fixture, args.instances, args.config5)
    cards = torch.cuda.device_count() if args.device != "cpu" else 0
    top = args.shards or max(2, cards)
    base_rate = None
    for n in sorted({1, -(-top // 2), top}):
        devs, used = _shard_devices(args.device, n)
        if not args.no_warm:
            BatchPOA(_params(args), devices=devs).run_consensus(
                instances, seeded=args.seeded)
        bp = BatchPOA(_params(args), devices=devs)
        _sync(args.device)
        t0 = time.perf_counter()
        bp.run_consensus(instances, seeded=args.seeded)
        _sync(args.device)
        dt = time.perf_counter() - t0
        rate = args.instances / dt
        base_rate = base_rate or rate
        print(json.dumps({
            "shards": n, "cards": used, "devices": devs,
            "windows_per_s": rate, "speedup_vs_1shard": rate / base_rate,
            "wall_s": dt, "cells": bp.dp_cells, "fallbacks": bp.fallbacks,
            "shard_instances": [s["instances"] for s in bp.shards],
        }), flush=True)


def worker(args):
    """One process of a multi-process run (also the 1-process
    denominator, with --world 1)."""
    import torch
    from . import multihost as mh
    if args.world > 1:
        mh.initialize(init_method=args.init, world_size=args.world,
                      rank=args.rank)
    instances = _load_instances(args.fixture, args.instances, args.config5)
    devices = mh.local_devices(args.device)
    if not args.no_warm:
        mh.run_consensus_fasta(_params(args), instances, devices=devices,
                               seeded=args.seeded)
    stats = {}
    _sync(args.device)
    t0 = time.perf_counter()
    out = mh.run_consensus_fasta(_params(args), instances, devices=devices,
                                 stats=stats, seeded=args.seeded)
    _sync(args.device)
    wall = time.perf_counter() - t0
    _, rank = mh._world()
    if rank == 0 and args.out:
        pathlib.Path(args.out).write_text(out)
    print(json.dumps({
        "process": rank, "hosts": args.world, "devices": devices,
        "wall_s": wall, "windows_per_s": args.instances / wall,
        "text_bytes": None if out is None else len(out),
        "foreign_modules": sorted(m for m in sys.modules
                                  if m.split(".")[0] in FOREIGN),
        **stats}), flush=True)
    if args.world > 1:
        torch.distributed.destroy_process_group()


def _wait_all(procs):
    """Each process's (stdout, stderr) once all have ended; as soon as
    one fails, the others are killed (they would wait in the gather)."""
    import threading
    outs = [None] * len(procs)

    def read(i):
        outs[i] = procs[i].communicate()
    readers = [threading.Thread(target=read, args=(i,))
               for i in range(len(procs))]
    for t in readers:
        t.start()
    while any(t.is_alive() for t in readers):
        for t in readers:
            t.join(0.2)
        if any(p.poll() not in (None, 0) for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.kill()
    return outs


def procs_launcher(args):
    """Spawn a 1-process run, then args.procs processes on this host
    (fresh interpreters: no fork after CUDA has started), and print the
    strong-scaling efficiency of the gathered run against the first."""
    if args.device != "cpu":
        # build the kernels once, before the workers start
        from ..ops import _build
        _build.build_all()
    cards = 0
    if args.device != "cpu":
        import torch
        cards = min(args.procs, torch.cuda.device_count())

    def spawn(world, rank, store, out=None):
        env = dict(os.environ, LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world),
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO)] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        # the gather stays on this host: gloo over the loopback device
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        cmd = [sys.executable, "-m", "abpoa_tpu_torch.parallel.scaling",
               "--worker", "--world", str(world), "--rank", str(rank),
               "--init", f"file://{store}", "--device", args.device,
               "--instances", str(args.instances),
               "--fixture", args.fixture]
        cmd += (["--seeded"] * args.seeded + ["--no-warm"] * args.no_warm
                + ["--config5"] * args.config5)
        if out:
            cmd += ["--out", out]
        return subprocess.Popen(cmd, env=env, cwd=str(REPO),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def run(world, out=None):
        with tempfile.TemporaryDirectory(prefix="abpoa_scaling_") as tmp:
            store = pathlib.Path(tmp) / "store"
            procs = [spawn(world, r, store, out if r == 0 else None)
                     for r in range(world)]
            outs = _wait_all(procs)
        failed = [(r, p.returncode, err) for r, (p, (_o, err))
                  in enumerate(zip(procs, outs)) if p.returncode != 0]
        if failed:
            for r, rc, err in failed:
                print(f"worker {r} of {world} exited {rc}:\n{err}",
                      file=sys.stderr)
            raise SystemExit(1)
        return [json.loads(o.strip().splitlines()[-1]) for o, _e in outs]

    line1 = run(1)[0]
    print(json.dumps(line1), flush=True)
    lines = run(args.procs, args.out)
    for ln in lines:
        print(json.dumps(ln), flush=True)
    rate1 = line1["windows_per_s"]
    rate_n = lines[0]["windows_per_s"]     # wall clock of the gathered run
    cores = os.cpu_count() or 1
    print(json.dumps({
        "metric": "host_scaling_efficiency",
        "hosts": args.procs,
        "windows_per_s_1host": rate1,
        "windows_per_s_Nhosts": rate_n,
        "efficiency": rate_n / (args.procs * rate1),
        # processes on one host share its cores (and, with fewer cards
        # than processes, a card): the ceiling is then below 1
        "host_cores": cores,
        "core_limited": cores < args.procs * 2,
        "efficiency_core_normalized": min(1.0, rate_n / rate1)
        if cores < args.procs * 2 else None,
        "cards": cards,
    }), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m abpoa_tpu_torch.parallel.scaling")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--instances", type=int, default=32)
    ap.add_argument("--fixture", default="heter.fa")
    ap.add_argument("--seeded", action="store_true",
                    help="the seeded window rounds (-S)")
    ap.add_argument("--shards", type=int, default=0,
                    help="device sweep up to N shards (default: the "
                         "visible cards, at least 2)")
    ap.add_argument("--procs", type=int, default=0,
                    help="spawn M local processes (gloo gather)")
    ap.add_argument("--out", default=None,
                    help="process 0 writes the gathered output here")
    ap.add_argument("--config5", action="store_true",
                    help="trim instance k's reads by (k %% 5) * 120 bases")
    ap.add_argument("--no-warm", action="store_true",
                    help="skip the warm-up run (correctness checks)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)
    if args.procs:
        return procs_launcher(args)
    return device_sweep(args)


if __name__ == "__main__":
    sys.exit(main())
