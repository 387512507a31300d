"""abpoa_tpu_torch.bench: the port's bench, the counterpart of the root
bench.py.

* The config-5 generator equals bench.py's ``_seeded_instances`` on
  heter.fa's reads (bench.py is loaded by path; it imports no JAX at
  module level).
* From one stub run, the headline record has bench.py's ``_headline``
  keys (``windows_per_s`` named ``instances_per_s``, plus
  ``device_idle_share``), value and vs_baseline from the median rep.
* The stored denominator is BENCH_BASELINE.json's heter.fa rate, and the
  file is byte-identical after a rehearsal.
* Without a card and without ``--device cpu`` the bench exits 2 and
  prints no record; a failed gate, a deadline passed before the
  headline landed and a phase still running at the deadline (the
  watchdog) exit 1 with the record.
* A ``--device cpu`` rehearsal on seq.fa: every line parses, the last
  says "device": "cpu", 3 reps, 0 fallbacks, the gates passed, every
  phase landed (b256 at 4 x instances, seeded with 3 timed runs), and no
  roofline key.
* On a GPU: the bench at a short budget, the same fields plus the card's
  name, the kernel rate and 0 < busy < e2e.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
BASELINE = REPO / "BENCH_BASELINE.json"
STORED_HETER = 198580514.3


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_bench(args, env_extra, timeout):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               **env_extra)
    env.pop("ABPOA_BENCH_INNER", None)
    return subprocess.run([sys.executable, "-m", "abpoa_tpu_torch.bench",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _records(stdout):
    return [json.loads(line) for line in stdout.splitlines() if line.strip()]


def _keys(obj):
    """Every key of a nested record."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield k
            yield from _keys(v)


def test_config5_generator_equals_bench_py():
    from abpoa_tpu_torch import workload
    root = _root_bench()
    reads = workload.load_reads("heter.fa")
    theirs = root._load_reads("heter.fa")
    assert len(reads) == len(theirs)
    assert all(np.array_equal(a, b) for a, b in zip(reads, theirs))
    mine = workload.seeded_instances(reads, 10)
    want = root._seeded_instances(theirs, 10)
    assert len(mine) == len(want) == 10
    for a, b in zip(mine, want):
        assert [len(q) for q in a] == [len(q) for q in b]
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert len({tuple(len(q) for q in inst) for inst in mine}) == 5


class _Stub:
    dp_cells = 80_850_000
    dp_seconds = 0.30
    used_device_loop = True

    def dp_busy_seconds(self):
        return 0.06


def test_headline_record_keys_and_median():
    from abpoa_tpu_torch import bench
    root = _root_bench()
    reps = [0.61, 0.50, 0.52]
    best, med = min(reps), sorted(reps)[1]
    cfg = bench.BenchConfig.from_env("cpu")
    theirs = root._headline(_Stub(), best, STORED_HETER, e2e_med=med)
    mine = bench.headline(_Stub(), best, STORED_HETER, cfg, 0.0,
                          e2e_med=med)
    assert set(mine) == set(theirs)
    want = (set(theirs["extras"]) - {"windows_per_s"}) | {
        "instances_per_s", "device_idle_share"}
    assert set(mine["extras"]) == want
    assert mine["value"] == pytest.approx(80_850_000 / 0.52)
    assert mine["value"] == pytest.approx(theirs["value"], abs=0.05)
    assert mine["vs_baseline"] == pytest.approx(
        80_850_000 / 0.52 / STORED_HETER)
    assert mine["extras"]["best_cells_per_s"] == pytest.approx(
        80_850_000 / 0.50)
    assert mine["extras"]["instances_per_s"] == pytest.approx(
        theirs["extras"]["windows_per_s"], abs=1e-4)
    assert mine["extras"]["device_idle_share"] == pytest.approx(
        1 - 0.06 / 0.52)
    assert mine["extras"]["e2e_seconds_median"] == med


def test_stored_denominator():
    from abpoa_tpu_torch import bench
    assert bench.stored_cells_per_s("heter.fa") == STORED_HETER
    assert bench.reference_cells_per_s(None, "heter.fa", 1) == STORED_HETER
    # a live rate below the stored one does not lower the denominator
    assert bench.reference_cells_per_s((32, 10.0), "heter.fa", 1000) \
        == STORED_HETER
    assert bench.reference_cells_per_s((32, 1e-6), "heter.fa", 1000) \
        == pytest.approx(32 * 1000 / 1e-6)


def test_no_card_exits_nonzero_without_a_record():
    """No visible card (decided here: CUDA_VISIBLE_DEVICES is empty) and
    no --device cpu: exit 2, a message, no record."""
    out = _run_bench([], {"CUDA_VISIBLE_DEVICES": ""}, 120)
    assert out.returncode == 2, out.stderr
    assert "torch.cuda.is_available() is False" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("landed,phase,code", [
    pytest.param(False, None, 1, id="False"),
    pytest.param(True, "seeded", 1, id="True"),
    pytest.param(True, None, 0, id="True-between-phases")])
def test_watchdog_at_the_deadline(landed, phase, code, monkeypatch, capsys):
    """The deadline passed: the latest record goes out with
    budget_exhausted; the exit code is 1 before the headline landed and
    while a phase still runs (it may hang on the card), 0 only between
    phases after the headline (os._exit is caught here)."""
    from abpoa_tpu_torch import bench
    rec = bench.Records(bench.BenchConfig.from_env("cpu"))
    codes = []

    def fake_exit(code):
        codes.append(code)
        rec.done = True
    monkeypatch.setattr(bench.os, "_exit", fake_exit)
    rec.emit(bench.provisional(rec.cfg))
    rec.landed, rec.phase = landed, phase
    rec.watchdog(time.monotonic())
    last = _records(capsys.readouterr().out)[-1]
    assert codes == [code]
    assert last["extras"]["budget_exhausted"] is True
    if phase:
        assert last["extras"][phase] == {"interrupted": "deadline"}
        assert "still running" in last["extras"]["error"]
    elif not landed:
        assert "headline" in last["extras"]["error"]
    else:
        assert "error" not in last["extras"]


def test_failed_gate_exits_1(monkeypatch, capsys):
    from abpoa_tpu_torch import bench

    def miss(self):
        self.rec.emit(bench.provisional(self.cfg))
        bench.gate(False, "rep 1: consensus != golden")
    monkeypatch.setattr(bench.Bench, "run", miss)
    monkeypatch.setenv("ABPOA_BENCH_BUDGET_S", "60")
    assert bench.inner(["--device", "cpu"]) == 1
    last = _records(capsys.readouterr().out)[-1]
    assert last["extras"]["gate_failed"] is True
    assert last["extras"]["failed_phase"] == "headline"
    assert "consensus != golden" in last["extras"]["error"]


@pytest.fixture(scope="module")
def rehearsal():
    before = BASELINE.read_bytes()
    out = _run_bench(["--device", "cpu"],
                     {"ABPOA_BENCH_INSTANCES": "2",
                      "ABPOA_BENCH_FIXTURE": "seq.fa",
                      "ABPOA_BENCH_SEEDED": "1",
                      "ABPOA_BENCH_KERNEL_K": "2",
                      "ABPOA_BENCH_BUDGET_S": "300"}, 400)
    return out, before


def test_cpu_rehearsal(rehearsal):
    out, _before = rehearsal
    assert out.returncode == 0, out.stderr[-3000:]
    recs = _records(out.stdout)
    last = recs[-1]
    ex = last["extras"]
    assert last["metric"] == "dp_cells_per_s" and last["value"] > 0
    assert ex["device"] == "cpu" and ex["card"] is None
    assert ex["reps"] >= 3 and not ex["reps_insufficient"]
    assert ex["fallbacks"] == 0 and ex["device_loop"]
    assert ex["gates"]["golden"] is True
    assert ex["ref_source"] == "stored"
    assert ex["seeded"]["gates"]["oracle"] is True
    assert ex["seeded"]["fallbacks"] == 0 and ex["seeded"]["windows"] > 0
    assert ex["seeded"]["runs"] == 3
    assert ex["b256"]["instances"] == 8
    for phase in ("b256", "mixed", "kernel", "transport", "devices"):
        assert "skipped" not in ex[phase], phase
    assert ex["devices"]["devices"] == ["cpu"]
    assert ex["mixed"]["fallbacks"] == 0
    assert "plain_round" in ex["kernel"]
    keys = set(_keys(last))
    assert not any("roofline" in k for k in keys)
    assert not any(k.startswith("kernel_") for k in keys)
    assert ex["warmup_s"] > 0 and ex["build_s"] is None
    assert 0 < ex["dp_busy_seconds"] <= ex["e2e_seconds_median"] * 1.01


def test_rehearsal_leaves_the_baseline_file(rehearsal):
    _out, before = rehearsal
    assert BASELINE.read_bytes() == before


# ------------------------------------------------------------------ #
# on the card

@pytest.mark.gpu
def test_bench_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the bench runs the kernels")
    before = BASELINE.read_bytes()
    out = _run_bench([], {"ABPOA_BENCH_SEEDED": "64",
                          "ABPOA_BENCH_BUDGET_S": "150"}, 400)
    assert out.returncode == 0, out.stderr[-3000:]
    last = _records(out.stdout)[-1]
    ex = last["extras"]
    assert ex["device"] == torch.cuda.get_device_name(0)
    assert ex["card"].startswith(torch.cuda.get_device_name(0))
    assert ex["reps"] >= 3 and not ex["reps_insufficient"]
    assert ex["fallbacks"] == 0 and ex["gates"]["golden"] is True
    assert ex["launches"]["band_dp"] == ex["launches"]["graph_update"] > 0
    assert ex["seeded"]["gates"]["oracle"] is True
    assert 0 < ex["dp_busy_seconds"] < ex["e2e_seconds_median"]
    assert ex["kernel"]["kernel_cells_per_s"] > 0
    assert 0 < ex["kernel"]["kernel_roofline_pct"] < 100
    assert 0 < ex["roofline_pct"] < 100
    assert ex["transport"]["h2d_gbps"] > 0
    assert BASELINE.read_bytes() == before
