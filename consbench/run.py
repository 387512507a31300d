"""Run one cell of BENCHMARK.json on the card and print its result.

    python3 consbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

The cell names a configuration (``consbench/configs/<config>.json``:
abPOA parameters) and a traffic mix (``consbench/traffic/<traffic>.json``:
the entry kind, the schedule of cluster shapes, the error profile, the
pool's size and how many clusters the reference checks). Set-up imports
the port, starts CUDA, loads the kernels, generates the pool from the
seed and makes one warm call; then a closed loop of one client calls the
entry kind's driver (``consbench/drivers/<kind>.py``) on the pool's
units in turn until ``--seconds`` have passed (whole calls). With
``--trace 1`` the window runs under ``torch.profiler``. After the window
a sample of the clusters it completed, drawn from the seed, goes through
the plain reference (``consbench/reference``) in worker processes, and
every answer the window gave for them is compared with it. Each metric
is read by ``consbench/metrics/<name>.py``.

Stdout: information lines, then one JSON result line. Stderr ends with
the numbers compared and their limits. Exits 3 without enough CUDA
devices, 1 on a JAX module in the process or a port outside this
checkout.
"""
from __future__ import annotations

import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


T0 = time.perf_counter()
AGE0 = _process_age_s()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "consbench"
# run as a script, the interpreter puts consbench/ first on the path,
# where its modules would shadow any of the same name
sys.path = [p for p in sys.path
            if pathlib.Path(p or ".").resolve() != ROOT / "consbench"]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from consbench import gen  # noqa: E402
from consbench.measure import Call, Window  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "abpoa_tpu"}
LIMITS = {"wrong_answers": 0, "missing_answers": 0, "unstable_answers": 0}
SMI = ("name,clocks.sm,clocks.max.sm,clocks.mem,power.limit,power.draw,"
       "temperature.gpu")


def say(*a):
    print("consbench:", *a, flush=True)


def since_start() -> float:
    return AGE0 + time.perf_counter() - T0


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, workload: str):
    """(workload entry, configuration, traffic) of a cell, found by name."""
    wl = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{wl['traffic']}.json")
    return wl, config, traffic


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: with trace the
    per-layer ones, else the end-to-end ones, those listing the cell or
    listing no cells (a per-layer metric without a list goes with its
    end-to-end metric)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"]
                                 in names else [])]


def read_metric(name: str, window: Window):
    mod = load_module(BENCH / "metrics" / f"{name}.py",
                      "consbench_metric_" + name.replace(".", "_"))
    return mod.read(window)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={SMI}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({type(e).__name__})"


def host_cpu():
    """(this process's CPU seconds, the host's jiffies: all, steal) now;
    the steal share of a window is the hypervisor's take of its cores."""
    t = os.times()
    try:
        with open("/proc/stat") as fh:
            f = [int(x) for x in fh.readline().split()[1:]]
        return t.user + t.system, sum(f[:8]), f[7]
    except (OSError, ValueError, IndexError):
        return t.user + t.system, 0, 0


def draw_sample(seed, called, schedule, k):
    """k distinct clusters of `called`, drawn from the seed: one of the
    heaviest schedule entry (length x depth), the rest at random."""
    import numpy as np
    rng = np.random.default_rng([int(seed) % (1 << 64), 0x5EED])
    called = sorted(called)
    heavy = max(range(len(schedule)),
                key=lambda i: schedule[i][0] * schedule[i][1])
    first = [c for c in called if c[1] == heavy]
    first = [first[rng.integers(len(first))]] if first else []
    rest = [c for c in called if c not in first]
    pick = rng.permutation(len(rest))[:max(0, k - len(first))]
    return first + [rest[i] for i in sorted(pick)]


def reference(jobs, workers: int):
    """check_cluster over `jobs`, in `workers` spawned processes (inline
    with one)."""
    from consbench.reference import check_cluster
    if workers <= 1:
        return [check_cluster(j) for j in jobs]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(workers, multiprocessing.get_context("spawn")) \
            as ex:
        return list(ex.map(check_cluster, jobs))


def compare(calls, expected: dict, render) -> dict:
    """The numbers compared: answers of the sampled clusters unlike the
    reference's (`expected`: cluster -> consensus strings, None where
    the reference failed), answers a call left out, and answers unlike
    the first answer given for the same cluster."""
    seen = {}
    out = dict.fromkeys(LIMITS, 0)
    out["checked_answers"] = 0
    for c in calls:
        out["missing_answers"] += max(0, len(c.ids) - len(c.answers))
        for cid, ans in zip(c.ids, c.answers):
            first = seen.setdefault(cid, ans)
            out["unstable_answers"] += ans != first
            if cid in expected:
                out["checked_answers"] += 1
                cons = expected[cid]
                out["wrong_answers"] += cons is None or ans != render(cons)
    return out


def run_cell(wl, config, traffic, seed, seconds, trace, device,
             workers=None):
    """Set up, measure and check one cell on `device` ("cuda" or, in the
    tests, "cpu"). Returns (result dict without device, Window, check
    numbers)."""
    import gc
    import tempfile
    import torch
    import abpoa_tpu_torch
    if not pathlib.Path(abpoa_tpu_torch.__file__).resolve().is_relative_to(
            ROOT):
        raise SystemExit(f"abpoa_tpu_torch imported from "
                         f"{abpoa_tpu_torch.__file__}, not {ROOT}")
    driver_mod = importlib.import_module(
        f"consbench.drivers.{traffic['driver']}")
    # from the process's start: the interpreter, torch and the port
    split = {"import": since_start()}
    t = time.perf_counter()
    on_card = device.startswith("cuda")
    if on_card:
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    split["cuda_init"] = time.perf_counter() - t
    t = time.perf_counter()
    from abpoa_tpu_torch import native
    native.get_lib()
    if on_card:
        # the port builds its kernels at first use; loading them here
        # keeps the warm call's time its own
        from abpoa_tpu_torch.ops import _build
        if hasattr(_build, "build_all"):
            _build.build_all()
    split["kernel_load"] = time.perf_counter() - t
    t = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="consbench-")
    try:
        pool = gen.make_pool(seed, traffic)
        driver = driver_mod.Driver(config["params"], device, workdir)
        units = driver.units(pool)
        split["data"] = time.perf_counter() - t
        t = time.perf_counter()
        driver.call(units[0][1])
        if on_card:
            torch.cuda.synchronize()
        split["warm_call"] = time.perf_counter() - t
        say("set-up split (s):", json.dumps(
            {k: round(v, 4) for k, v in split.items()}))
        say(f"host: os.cpu_count() {os.cpu_count()}, affinity "
            f"{len(os.sched_getaffinity(0))} cores")
        calls = []
        prof = None
        setup_s = since_start()
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            prof.__enter__()
        from torch.profiler import record_function
        from consbench import devtrace as tr
        cpu0 = host_cpu()
        with record_function(tr.WINDOW):
            w0 = time.perf_counter()
            i = 0
            while True:
                ids, x = units[i % len(units)]
                i += 1
                t0 = time.perf_counter()
                with record_function(driver.span):
                    answers, counters = driver.call(x)
                t1 = time.perf_counter()
                calls.append(Call(t0, t1, ids, answers, counters))
                if t1 - w0 >= seconds:
                    break
            if on_card:
                torch.cuda.synchronize()
        cpu1 = host_cpu()
        t_trace = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if on_card:
            say("card after the window (name, clocks sm / max sm / mem, "
                "power limit / draw, temperature):", smi())
        window = Window(calls, setup_s, gap_mode(config))
        if prof is not None:
            window.trace = tr.reduce(tr.events(prof), {driver.span})
            prof = None
            say(f"trace read in {time.perf_counter() - t_trace:.2f} s")
        del driver, units
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        say(f"window: {window.n_calls} calls of "
            f"{len(calls[0].ids)} clusters, {window.clusters} clusters in "
            f"{window.elapsed_s:.4f} s; counters "
            f"{ {k: window.counter(k) for k in calls[0].counters} }")
        wall = calls[-1].t1 - w0
        say(f"host during the window: process CPU {cpu1[0] - cpu0[0]:.2f} s "
            f"in {wall:.2f} s wall; host steal share "
            f"{(cpu1[2] - cpu0[2]) / max(1, cpu1[1] - cpu0[1]):.4f}")
        say("call seconds:", json.dumps([round(c.t1 - c.t0, 4) for c in calls]))
        # the reference over a sample of the clusters the window completed
        called = {cid for c in calls for cid in c.ids}
        sample = draw_sample(seed, called, traffic["schedule"],
                             int(traffic["check_clusters"]))
        jobs = [(config["params"], 0, pool[b][k]) for b, k in sample]
        if workers is None:
            workers = min(len(jobs), len(os.sched_getaffinity(0)))
        t = time.perf_counter()
        refs = reference(jobs, workers)
        ref_s = time.perf_counter() - t
        expected = {cid: cons for cid, (cons, _cells) in zip(sample, refs)}
        cells = [cells for _cons, cells in refs]
        # every cluster of a schedule entry has the same shape: the
        # sample's mean stands for each cluster of the window
        window.dp_cells = sum(cells) / len(cells) * window.clusters
        checks = compare(calls, expected, driver_mod.Driver.render)
        say(f"reference: {len(sample)} clusters in {workers} processes, "
            f"{ref_s:.2f} s; {checks['checked_answers']} answers checked; "
            f"band cells a cluster {sum(cells) / len(cells):.1f}")
    finally:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    correct = all(checks[k] <= lim for k, lim in LIMITS.items())
    failed = sum(checks[k] for k in LIMITS)
    result = {"correct": bool(correct), "attempted": window.clusters,
              "failed": int(failed), "peak": peak}
    return result, window, checks


def gap_mode(config) -> int:
    """The gap mode abPOA derives from a configuration's gap opens."""
    from consbench.reference import make_params
    return make_params(config["params"]).gap_mode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches a build of the port may use stay at fixed paths inside
    # the checkout (its own CUDA libraries go to build/abpoa_tpu_torch)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    bench = load_json(ROOT / "BENCHMARK.json")
    wl, config, traffic = cell_spec(bench, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < wl["chips"]):
        print(f"consbench: the cell needs {wl['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    result, window, checks = run_cell(wl, config, traffic, args.seed,
                                      args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"consbench: modules loaded in this process: {bad}",
              file=sys.stderr)
        return 1
    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        v = read_metric(m["name"], window)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if args.trace:
        say("end-to-end under the profiler:", json.dumps(
            {m["name"]: read_metric(m["name"], window)
             for m in cell_metrics(bench, args.workload, False)}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": wl["chips"], "memory_peak_bytes": result.pop("peak")}
    out = dict(result, metrics=metrics, device=device)
    if window.trace is not None:
        device["busy_s"] = window.trace["busy_s"]
        device["window_s"] = window.trace["window_s"]
        out["breakdown"] = {"device_ops": window.trace["device_ops"],
                            "idle_gaps": window.trace["idle_gaps"]}
    out["checks"] = {k: {"value": checks[k], "limit": lim}
                     for k, lim in LIMITS.items()}
    for k, lim in LIMITS.items():
        print(f"consbench: check {k} {checks[k]} limit {lim}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
