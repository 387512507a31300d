"""The control of the benchmark's check: the plain reference in int8
scores, put in the program's place, must come out as not correct.

    python3 consbench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed: the cell's pool and the sample a run draws (here from
every cluster of the pool), the reference in abPOA's own score width
and in int8 (the width below the int16 these cells run in), then the
run's comparison with the int8 answers in the program's place. Prints
one JSON line per seed; needs no card.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
# run as a script, the interpreter puts consbench/ first on the path,
# where its modules would shadow any of the same name
sys.path = [p for p in sys.path
            if pathlib.Path(p or ".").resolve() != ROOT / "consbench"]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from consbench import gen, run  # noqa: E402
from consbench.measure import Call  # noqa: E402


def control_checks(config, traffic, seed, workers=1):
    """The check numbers with the int8 reference's answers in the
    program's place, over the sample a run with this seed would draw."""
    import importlib
    render = importlib.import_module(
        f"consbench.drivers.{traffic['driver']}").Driver.render
    pool = gen.make_pool(seed, traffic)
    called = {(b, k) for b in range(len(pool)) for k in range(len(pool[b]))}
    sample = run.draw_sample(seed, called, traffic["schedule"],
                             int(traffic["check_clusters"]))
    jobs = [(config["params"], bits, pool[b][k])
            for bits in (0, 8) for b, k in sample]
    refs = run.reference(jobs, workers)
    expected = {cid: cons for cid, (cons, _c) in zip(sample, refs)}
    calls = [Call(0.0, 0.0, [cid], [None if cons is None else render(cons)],
                  {})
             for cid, (cons, _c) in zip(sample, refs[len(sample):])]
    return run.compare(calls, expected, render)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = run.load_json(ROOT / "BENCHMARK.json")
    _wl, config, traffic = run.cell_spec(bench, args.workload)
    workers = len(os.sched_getaffinity(0))
    for seed in args.seeds:
        checks = control_checks(config, traffic, seed, workers)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
