"""abpoa_tpu_torch.trace: the port's phase spans, and the benchmark's
readers of them (``consbench/spans.py``).

* Off (no profiler, no ``recording()``), a span records nothing and
  never enters ``record_function``.
* ``summary``'s self time (a span's duration less its children's) on a
  synthetic nest, its window and open spans left out.
* Under ``torch.profiler`` (CPU activities), on seq.fa, for the device
  loop, the round path (``-m 1``), the seeded window rounds (``-S``) and
  the CLI's serial engine: the path's span names appear, every span
  nests inside one root, the self times sum to the root's duration,
  each span is a user annotation of the same name in the profiler's
  events, no name is one of the benchmark harness's, and the output
  bytes equal the golden file with tracing on and off.
* ``recording()`` from two threads keeps each thread's parents apart; a
  root opens only outside every span and a span only inside a root; the
  cap counts what it drops.
* The per-layer readers: None where the port has no tracer, where the
  window holds no record of the span, or where spans were dropped;
  otherwise the phases and the root's own time add up to the roots'.
"""
import contextlib
import io
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from abpoa_tpu_torch import trace
from abpoa_tpu_torch.params import LOCAL_MODE

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
GOLDEN_SAN = ROOT / "tests" / "golden_sanitized"
HARNESS = {"consbench.window", "run_consensus", "cli.main"}

torch.set_num_threads(1)


def _seq():
    from abpoa_tpu_torch.alphabet import encode_table
    from abpoa_tpu_torch.seqio import read_seqs
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / "seq.fa"))]


def _params(**fields):
    from abpoa_tpu_torch.params import Params
    p = Params()
    for k, v in fields.items():
        setattr(p, k, v)
    return p.post_set()


def _batch(seeded=False, **fields):
    def run(tmp_path):
        from abpoa_tpu_torch.parallel.batch import BatchPOA
        p = _params(**fields)
        cons = BatchPOA(p, device="cpu").run_consensus([_seq()],
                                                       seeded=seeded)
        return "".join(f">Consensus_sequence\n{c}\n" for c in cons[0])
    return run


def _cli(tmp_path):
    from abpoa_tpu_torch.cli import main
    out = tmp_path / "cons.fa"
    with contextlib.redirect_stderr(io.StringIO()):
        assert main([str(DATA / "seq.fa"), "-o", str(out),
                     "--device", "cpu"]) == 0
    return out.read_text()


PHASES = {"abpoa.seed", "abpoa.sort", "abpoa.export", "abpoa.dispatch",
          "abpoa.wait", "abpoa.replay", "abpoa.advance", "abpoa.fuse",
          "abpoa.consensus"}
# path -> (run, golden, root, the phase names it records)
PATHS = {
    "loop": (_batch(), "seq_cons.fa", "abpoa.batch",
             {"abpoa.export", "abpoa.dispatch", "abpoa.wait", "abpoa.fuse",
              "abpoa.consensus"}),
    "rounds-m1": (_batch(align_mode=LOCAL_MODE), "seq_cons_local.fa",
                  "abpoa.batch",
                  {"abpoa.sort", "abpoa.export", "abpoa.dispatch",
                   "abpoa.wait", "abpoa.fuse", "abpoa.consensus"}),
    # seq.fa's reads are shorter than a window: -S gives the default bytes
    "seeded": (_batch(seeded=True, disable_seeding=0), "seq_cons.fa",
               "abpoa.batch", PHASES),
    "cli": (_cli, "seq_cons.fa", "abpoa.cli",
            PHASES - {"abpoa.seed", "abpoa.advance"}),
}


def test_off_records_nothing(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) while off")
    monkeypatch.setattr(trace, "_record_function", boom)
    assert not torch.autograd._profiler_enabled()
    before = len(trace.BUFFER.records)
    with trace.root("abpoa.batch", 2) as r:
        with trace.span("abpoa.sort", 1) as s:
            pass
    assert r is s is trace._NOOP
    assert len(trace.BUFFER.records) == before


def test_summary_self_time_on_a_nest():
    # root [0, 100] > a [10, 40] > b [20, 30]; root > c [50, 90]; an open
    # span and a second root outside the window
    recs = [["abpoa.batch", 0, 100, -1, 4], ["abpoa.export", 10, 40, 0, 2],
            ["abpoa.sort", 20, 30, 1, 1], ["abpoa.fuse", 50, 90, 0, 3],
            ["abpoa.wait", 95, 0, 0, 0], ["abpoa.batch", 200, 260, -1, 1]]
    s = trace.summary(recs, 0, 150)
    assert s == {
        "abpoa.batch": {"self_ns": 30, "total_ns": 100, "count": 1, "n": 4},
        "abpoa.export": {"self_ns": 20, "total_ns": 30, "count": 1, "n": 2},
        "abpoa.sort": {"self_ns": 10, "total_ns": 10, "count": 1, "n": 1},
        "abpoa.fuse": {"self_ns": 40, "total_ns": 40, "count": 1, "n": 3}}
    whole = trace.summary(recs)
    assert whole["abpoa.batch"] == {"self_ns": 90, "total_ns": 160,
                                    "count": 2, "n": 5}
    # a window that cuts the root keeps only what lies wholly inside it
    assert set(trace.summary(recs, 5, 45)) == {"abpoa.export", "abpoa.sort"}


def _annotations(prof):
    """name -> count of the profiler's user annotations."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            out[e.name()] = out.get(e.name(), 0) + 1
    return out


@pytest.mark.parametrize("path", list(PATHS))
def test_path_spans_under_the_profiler(path, tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    run, golden, root_name, names = PATHS[path]
    want = (GOLDEN_SAN / golden).read_text()
    # tracing off: the golden bytes, nothing recorded
    real_rf = trace._record_function

    def boom(name):
        raise AssertionError(f"record_function({name!r}) while off")
    monkeypatch.setattr(trace, "_record_function", boom)
    before = len(trace.BUFFER.records)
    assert run(tmp_path) == want
    assert len(trace.BUFFER.records) == before
    monkeypatch.setattr(trace, "_record_function", real_rf)
    # under the profiler
    trace.BUFFER.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert run(tmp_path) == want
    recs = trace.BUFFER.records
    assert trace.BUFFER.dropped == 0
    got = {r[0] for r in recs}
    assert got == names | {root_name}
    assert all(n.startswith("abpoa.") for n in got) and not got & HARNESS
    roots = [i for i, r in enumerate(recs) if r[3] == -1]
    assert len(roots) == 1 and recs[roots[0]][0] == root_name
    for name, t0, t1, parent, n in recs:
        assert 0 < t0 <= t1 and n >= 0
        if parent >= 0:
            p = recs[parent]
            assert p[1] <= t0 and t1 <= p[2]
            while p[3] >= 0:
                p = recs[p[3]]
            assert p is recs[roots[0]]
    s = trace.summary(recs)
    r = recs[roots[0]]
    assert sum(v["self_ns"] for v in s.values()) == r[2] - r[1]
    assert all(v["self_ns"] >= 0 for v in s.values())
    ann = _annotations(prof)
    for name, v in s.items():
        assert ann.get(name) == v["count"], name


def test_recording_keeps_threads_apart():
    barrier = threading.Barrier(2, timeout=30)
    errors = []

    def work(tag):
        try:
            with trace.root("abpoa.batch", tag):
                barrier.wait()
                with trace.span("abpoa.export", tag):
                    barrier.wait()
                    with trace.span("abpoa.sort", tag):
                        barrier.wait()
                barrier.wait()
                with trace.span("abpoa.fuse", tag):
                    barrier.wait()
        except Exception as e:      # noqa: BLE001 - reported below
            errors.append(e)
    with trace.recording() as buf:
        threads = [threading.Thread(target=work, args=(t,)) for t in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors
    recs = buf.records
    assert len(recs) == 8
    assert sorted(r[4] for r in recs if r[3] == -1) == [1, 2]
    for r in recs:
        if r[3] >= 0:
            assert recs[r[3]][4] == r[4]
    s = trace.summary(recs)
    assert s["abpoa.export"]["count"] == 2 and s["abpoa.sort"]["n"] == 3


def test_roots_nest_once_and_spans_only_inside_a_root():
    with trace.recording() as buf:
        with trace.span("abpoa.sort", 1):        # no root: nothing
            pass
        with trace.root("abpoa.cli", 1):
            with trace.root("abpoa.batch", 4):   # inside a root: nothing
                with trace.span("abpoa.fuse", 4):
                    pass
        def work():                              # no root on its thread
            with trace.span("abpoa.fuse", 1):
                pass
        worker = threading.Thread(target=work)
        worker.start()
        worker.join(timeout=30)
    assert [(r[0], r[3]) for r in buf.records] == [("abpoa.cli", -1),
                                                    ("abpoa.fuse", 0)]
    # the outermost recording() cleared what the last one left
    with trace.recording() as again:
        assert again.records == [] and again.dropped == 0


def test_cap_counts_dropped(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    with trace.recording() as buf:
        with trace.root("abpoa.batch", 1):
            for _ in range(4):
                with trace.span("abpoa.export", 1):
                    pass
    assert len(buf.records) == 3 and buf.dropped == 2


def _window(t0_s, t1_s, clusters=2):
    """A measured window of one call over [t0_s, t1_s]."""
    from consbench.measure import Call, Window
    return Window([Call(t0_s, t1_s, [(0, k) for k in range(clusters)], [],
                        {})], 0.0, 0)


def _reader(name):
    from consbench import run
    return run.load_module(run.BENCH / "metrics" / f"{name}.py",
                           "test_metric_" + name.replace(".", "_")).read


def _synthetic_call(first_ns):
    """Spans of one call in the format of the batch path, from
    first_ns: root [0, 100 us], export [10, 40] > sort [20, 30],
    dispatch [40, 50] (3 windows), dispatch [50, 60] (1 window),
    fuse [60, 90]."""
    us = 1000
    b = first_ns
    return [["abpoa.batch", b, b + 100 * us, -1, 2],
            ["abpoa.export", b + 10 * us, b + 40 * us, 0, 3],
            ["abpoa.sort", b + 20 * us, b + 30 * us, 1, 1],
            ["abpoa.dispatch", b + 40 * us, b + 50 * us, 0, 3],
            ["abpoa.dispatch", b + 50 * us, b + 60 * us, 0, 1],
            ["abpoa.fuse", b + 60 * us, b + 90 * us, 0, 4]]


def test_readers_add_up_to_the_roots(monkeypatch):
    monkeypatch.setattr(trace, "BUFFER", trace.Buffer())
    t0 = 10 ** 12
    trace.BUFFER.records = _synthetic_call(t0)
    w = _window(t0 / 1e9, (t0 + 101_000) / 1e9)
    ms = {ph: _reader(f"{ph}_ms_per_cluster.batch")(w)
          for ph in ("seed", "sort", "export", "dispatch", "wait", "replay",
                     "advance", "fuse", "consensus", "other")}
    assert ms["seed"] is None and ms["wait"] is None
    got = {k: v for k, v in ms.items() if v is not None}
    assert got == pytest.approx({"sort": 0.005, "export": 0.01,
                                 "dispatch": 0.01, "fuse": 0.015,
                                 "other": 0.01})
    assert sum(got.values()) == pytest.approx(0.1 / 2)
    assert _reader("windows_per_launch.batch")(w) == 2
    assert _reader("other_ms_per_call.cli")(w) is None


@pytest.mark.parametrize("case", ["no tracer", "no record", "dropped"])
def test_readers_give_none(case, monkeypatch):
    import abpoa_tpu_torch
    monkeypatch.setattr(trace, "BUFFER", trace.Buffer())
    t0 = 10 ** 12
    trace.BUFFER.records = _synthetic_call(t0)
    w = _window(t0 / 1e9, (t0 + 101_000) / 1e9)
    if case == "no tracer":
        # the parent commit: no abpoa_tpu_torch.trace to import
        monkeypatch.delattr(abpoa_tpu_torch, "trace")
        monkeypatch.setitem(sys.modules, "abpoa_tpu_torch.trace", None)
    elif case == "no record":
        w = _window(t0 / 1e9 + 1, t0 / 1e9 + 2)
    else:
        trace.BUFFER.dropped = 1
    for name in ("export_ms_per_cluster.batch", "other_ms_per_cluster.batch",
                 "windows_per_launch.batch", "fuse_ms_per_call.cli"):
        assert _reader(name)(w) is None, name
