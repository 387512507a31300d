"""After a rehearsal import of the harness and every module it loads of
the port, no module whose top-level name is jax, jaxlib, flax or the
JAX package abpoa_tpu is in the process (a fresh one)."""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

REHEARSAL = """
import json, pathlib, sys
sys.path.insert(0, {root!r})
from consbench import run, control, devtrace, roofline, measure
from consbench.reference import poa
from consbench.drivers import batch, seeded, cli
import abpoa_tpu_torch.parallel.batch, abpoa_tpu_torch.cli
bench = run.load_json(pathlib.Path({root!r}) / "BENCHMARK.json")
for m in bench["end_to_end"] + bench["per_layer"]:
    run.load_module(run.BENCH / "metrics" / (m["name"] + ".py"), "m")
print(json.dumps(run.forbidden_modules()))
"""


def test_no_jax_after_the_harness_imports():
    out = subprocess.run([sys.executable, "-c",
                          REHEARSAL.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    from consbench import run
    monkeypatch.setitem(sys.modules, "abpoa_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "abpoa_tpu.sub", sys)
    assert run.forbidden_modules() == ["abpoa_tpu"]
