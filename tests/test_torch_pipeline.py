"""abpoa_tpu_torch: the host/device pipeline of the round and seeded
batch paths (``BatchPOA(pipeline=True)``, the JAX package's
``_run_pipelined`` and its two seeded groups).

* The keyword, N_SHARDS and the thresholds equal the JAX package's:
  the round path pipelines from 4 instances over min(4, n // 4)
  round-robin shards, the seeded path from 8 over two groups (k % 2).
* Round path, -m 1 and -m 2 over 8 seq.fa instances of uneven read
  counts (two shards), -m 2 over 16 short instances (four shards):
  consensus, MSA and GFA equal the lockstep run; each whole seq.fa
  instance gives its golden; every shard launches its own plan (one
  launch a round after read 0) and ``rounds`` sums the shard rounds.
* Seeded, 8 instances over two groups: the lockstep run and the port's
  serial oracle.
* 8 instances with -m 2 against the JAX package's
  ``BatchPOA(pipeline=True).run`` (its XLA engine on the CPU): consensus,
  MSA and GFA, byte for byte.
* The pipeline over ``devices=["cpu", "cpu"]``; a forced step-stream
  cap of 2 (every stream refetched from its shard's device tensor);
  ``pipeline=False`` keeps the lockstep counters; a failing launch in a
  shard raises.
* On a GPU: the pipelined round path and seeded path equal lockstep on
  the card, and a refetch reads the words that its shard's stream wrote
  while another shard's stream still runs.
Exact equality everywhere.
"""
import dataclasses
import functools
import io
import pathlib

import numpy as np
import pytest
import torch

# paths spelled out here (not imported from conftest) so the gpu tests
# also run with --noconftest on a host without JAX
TESTS = pathlib.Path(__file__).resolve().parent
DATA = TESTS / "data"
GOLDEN_SAN = TESTS / "golden_sanitized"
KERNELS = ("band_dp_topo", "fw_dp", "tile_dp")
GOLDEN = {"-m 1": "seq_cons_local.fa", "-m 2": "seq_cons_ext.fa"}

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _reads(fn):
    from abpoa_tpu_torch.seqio import read_seqs
    from abpoa_tpu_torch.alphabet import encode_table
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / fn))]


def _params(flag, out=(), pkg=None):
    """Params of `flag`; out: the output flags to set (out_msa, ...)."""
    if pkg is None:
        from abpoa_tpu_torch import params as pkg
    p = pkg.Params()
    if flag == "-m 1":
        p.align_mode = pkg.LOCAL_MODE
    elif flag == "-m 2":
        p.align_mode = pkg.EXTEND_MODE
    elif flag == "-S":
        # -S -n 100: windows between anchors from 100 bases on
        p.disable_seeding, p.min_w = 0, 100
    for key in out:
        setattr(p, key, 1)
    return p.post_set()


RENDERS = ((), ("out_msa",), ("out_gfa",))


def _render(abs_, flag, pkg=None):
    """Each instance rendered as consensus FASTA, MSA (with consensus)
    and GFA: {kind: [text per instance]}."""
    out = {}
    for kind in RENDERS:
        p = _params(flag, kind, pkg)
        out[kind] = []
        for ab in abs_:
            buf = io.StringIO()
            ab.output(p, buf)
            out[kind].append(buf.getvalue())
    return out


def _uneven8():
    """8 seq.fa instances of 2-10 reads; instance 0 is the whole file."""
    r = _reads("seq.fa")
    return [r, r[:4], r[:3], r[:5], r[1:4], r[:2], r[2:6], r[:4]]


def _short16():
    r = _reads("seq.fa")
    return [(r[k % 10:] + r[:k % 10])[:3] for k in range(16)]


def _seeded8():
    """8 seeded instances of two reads (an ancestor of 165-200 bases,
    substitutions 3 %, indels 2 %): with -n 100 some reads align in two
    windows."""
    from abpoa_tpu_torch.tools.fuzz_device_loop import _gen_instance
    rng = np.random.default_rng(9)
    return [_gen_instance(rng, 200 - 5 * k, 2, 0.03, 0.02) for k in range(8)]


def _counters(bp):
    return dict(dp_cells=bp.dp_cells, fallbacks=bp.fallbacks,
                rounds=bp.rounds, windows=bp.windows,
                empty_windows=bp.empty_windows, loop=bp.used_device_loop,
                launches=dict(bp.launches))


def _run(flag, insts, device="cpu", seeded=False, **kw):
    from abpoa_tpu_torch import BatchPOA
    # read ids in the graph (out_msa), which the MSA and GFA renders need
    p = _params(flag, ("out_msa", "out_gfa"))
    cap = kw.pop("cap", None)
    bp = BatchPOA(p, device=device, **kw)
    bp.s16_cap = cap
    abs_ = bp.run_seeded(insts) if seeded else bp.run(insts)
    return _render(abs_, flag), bp


@functools.lru_cache(maxsize=None)
def _lockstep(flag, which):
    """(rendered output, counters, pipeline record) of the lockstep run."""
    insts = {"uneven8": _uneven8, "short16": _short16,
             "seeded8": _seeded8}[which]()
    text, bp = _run(flag, insts, seeded=flag == "-S", pipeline=False)
    return text, _counters(bp), bp.pipeline_shards


def _shard_plan(insts, n_shards, name):
    """Each round-path shard's own plan: instance k in shard k % S;
    rounds 0..max reads - 1 of its instances, every one after read 0
    with one launch of the group's kernel (one score width, one chunk)."""
    out = []
    for s in range(n_shards):
        nr = max(len(i) for i in insts[s::n_shards])
        out.append({"instances": len(insts[s::n_shards]), "rounds": nr,
                    "launches": {k: (nr - 1) * (k == name)
                                 for k in KERNELS}})
    return out


def test_keyword_defaults_and_thresholds_equal_jax():
    """pipeline=True by default, N_SHARDS = 4 as in the JAX package; the
    round path pipelines from 4 instances over min(4, n // 4) shards,
    round-robin; below 4, or with pipeline=False, one lockstep shard."""
    from abpoa_tpu.parallel.batch import BatchPOA as JBatch
    from abpoa_tpu_torch import BatchPOA
    import inspect
    jdef = inspect.signature(JBatch.__init__).parameters["pipeline"].default
    assert BatchPOA(_params("-m 1"), device="cpu").pipeline is jdef is True
    assert BatchPOA.N_SHARDS == JBatch.N_SHARDS == 4
    r = _reads("seq.fa")
    for n, want in ((3, 1), (4, 1), (12, 3), (20, 4)):
        insts = [r[:2 + k % 2] for k in range(n)]
        _text, bp = _run("-m 2", insts)
        recs = bp.pipeline_shards
        assert len(recs) == want, n
        assert [x["instances"] for x in recs] == \
            [len(range(s, n, want)) for s in range(want)]
        # a lockstep round with no DP (read 0 only) is not counted; every
        # prepared shard round of the pipeline is
        assert bp.rounds == sum(x["rounds"] for x in recs) \
            == (2 if n < 4 else sum(p["rounds"] for p in
                                    _shard_plan(insts, want, "")))


@pytest.mark.parametrize("flag,which,n_shards",
                         [("-m 1", "uneven8", 2), ("-m 2", "uneven8", 2),
                          ("-m 2", "short16", 4)],
                         ids=["m1-8", "m2-8", "m2-16"])
def test_round_path_pipeline_equals_lockstep(flag, which, n_shards):
    insts = {"uneven8": _uneven8, "short16": _short16}[which]()
    name = "fw_dp" if flag == "-m 1" else "band_dp_topo"
    want, counters, _rec = _lockstep(flag, which)
    text, bp = _run(flag, insts)
    assert text == want
    assert bp.fallbacks == 0 and not bp.used_device_loop
    plan = _shard_plan(insts, n_shards, name)
    assert bp.pipeline_shards == plan
    assert bp.rounds == sum(p["rounds"] for p in plan)
    assert bp.launches == {k: sum(p["launches"][k] for p in plan)
                           for k in KERNELS}
    # the same DP cells as lockstep: only the grouping of launches moved
    assert bp.dp_cells == counters["dp_cells"]
    if which == "uneven8":
        gold = (GOLDEN_SAN / GOLDEN[flag]).read_text()
        assert text[()][0] == gold


def test_lockstep_keeps_its_counters():
    """pipeline=False: one shard of every instance, a round counted only
    when it runs DP, one launch a round."""
    insts = _uneven8()
    _text, counters, rec = _lockstep("-m 1", "uneven8")
    assert counters["rounds"] == 9 and counters["fallbacks"] == 0
    assert counters["launches"] == {"band_dp_topo": 0, "fw_dp": 9,
                                    "tile_dp": 0}
    assert rec == [{"instances": 8, "rounds": 9,
                    "launches": counters["launches"]}]
    # below the threshold the default runs the same lockstep
    text, bp = _run("-m 1", _short16()[:3])
    assert len(bp.pipeline_shards) == 1 and bp.rounds == 2


def test_seeded_two_groups_equal_lockstep_and_oracle():
    """8 instances: groups k % 2 take turns; the outputs equal lockstep
    and the port's serial oracle, with the lockstep's windows."""
    from abpoa_tpu_torch.api import ABPOA
    insts = _seeded8()
    want, counters, _rec = _lockstep("-S", "seeded8")
    text, bp = _run("-S", insts, seeded=True)
    assert text == want
    assert bp.fallbacks == 0 and bp.windows == counters["windows"] > 8
    assert bp.empty_windows == counters["empty_windows"]
    assert bp.dp_cells == counters["dp_cells"]
    recs = bp.pipeline_shards
    assert [r["instances"] for r in recs] == [4, 4]
    assert bp.rounds == sum(r["rounds"] for r in recs)
    assert bp.launches == {k: sum(r["launches"][k] for r in recs)
                           for k in KERNELS}
    from abpoa_tpu_torch.alphabet import decode_table
    dt = decode_table(5)
    for kind in RENDERS:
        host = dataclasses.replace(_params("-S", kind), engine="numpy")
        exp = []
        for inst in insts:
            buf = io.StringIO()
            ABPOA().msa(host, [bytes(dt[b] for b in q).decode()
                               for q in inst], out=buf)
            exp.append(buf.getvalue())
        assert text[kind] == exp, kind


def test_pipeline_equals_jax_batch():
    """8 instances, -m 2: the port's pipelined rounds (two shards) against
    the JAX package's BatchPOA(pipeline=True).run on the CPU."""
    from abpoa_tpu import params as jparams
    from abpoa_tpu.parallel import BatchPOA as JBatch
    r = _reads("seq.fa")
    insts = [(r[k:] + r[:k])[:2 + k % 2] for k in range(8)]
    jb = JBatch(_params("-m 2", ("out_msa", "out_gfa"), jparams),
                pipeline=True)
    want = _render(jb.run(insts), "-m 2", pkg=jparams)
    text, bp = _run("-m 2", insts)
    assert len(bp.pipeline_shards) == 2
    assert text == want


def test_pipeline_over_two_cpu_entries_and_forced_refetch():
    """The pipeline (two shards) over devices=["cpu", "cpu"], each
    shard's round split over both entries, with a step-stream fetch cap
    of 2 (every stream refetched from its shard's device tensor): the
    lockstep output, one launch a shard round on each entry with work."""
    from abpoa_tpu_torch import BatchPOA
    insts = _short16()[:8]
    want = _render(BatchPOA(_params("-m 2", ("out_msa", "out_gfa")),
                            device="cpu", pipeline=False).run(insts), "-m 2")
    text, bp = _run("-m 2", insts, devices=["cpu", "cpu"], cap=2)
    assert text == want and bp.fallbacks == 0
    plan = _shard_plan(insts, 2, "band_dp_topo")
    assert [r["rounds"] for r in bp.pipeline_shards] == \
        [p["rounds"] for p in plan] == [3, 3]
    # four instances a shard, all live in both DP rounds: 2 + 2 per entry
    assert bp.launches["band_dp_topo"] == 2 * 2 * 2
    assert [(s["device"], s["instances"]) for s in bp.shards] == \
        [("cpu", 8)] * 2
    assert all(s["busy_s"] > 0 and s["launched_s"] > 0 for s in bp.shards)


def test_incremental_qv_batch_over_the_pipeline():
    """-i (every instance restores seq.gfa, so the loop turns the batch
    away) with qv weights, 8 instances over two shards: the lockstep
    output, rendered as GFA and as consensus."""
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.gfa import restore_graph
    r = _reads("seq.fa")
    insts = [(r[k:] + r[:k])[:1 + k % 2] for k in range(8)]
    rng = np.random.default_rng(5)
    ws = [[rng.integers(1, 60, len(q)).tolist() for q in inst]
          for inst in insts]
    out = []
    for pipe in (False, True):
        p = _params(None, ("out_gfa",))
        p.incr_fn = str(GOLDEN_SAN / "seq.gfa")

        def init(ab):
            restore_graph(ab, p)
        bp = BatchPOA(p, device="cpu", pipeline=pipe)
        out.append((_render(bp.run(insts, weights=ws, init=init), None),
                    len(bp.pipeline_shards), bp.fallbacks,
                    bp.used_device_loop))
    assert out[0][0] == out[1][0]
    assert [o[1:] for o in out] == [(1, 0, False), (2, 0, False)]


def test_failing_launch_in_a_shard_raises(monkeypatch):
    """A kernel fault in the second shard's first launch propagates:
    nothing reverts to lockstep or to the oracle."""
    from abpoa_tpu_torch.parallel import batch
    orig = batch._Job._launch
    seen = []

    def failing(self, sh, part):
        seen.append(self.rec)
        if len(seen) == 2:
            raise RuntimeError("injected kernel fault")
        return orig(self, sh, part)
    monkeypatch.setattr(batch._Job, "_launch", failing)
    with pytest.raises(RuntimeError, match="injected kernel fault"):
        _run("-m 2", _uneven8())
    assert seen[0] is not seen[1]


# ------------------------------------------------------------------ #
# on the card

@pytest.mark.gpu
def test_pipeline_equals_lockstep_on_gpu(cuda_device):
    """16 instances (four shards) of heter.fa with -m 1 and -m 2, and 16
    config-5-shaped seeded instances (two groups), on the card: the
    lockstep run's output and the shards' plans."""
    h = _reads("heter.fa")
    rot = [h[k:] + h[:k] for k in range(16)]
    for flag, name in (("-m 1", "fw_dp"), ("-m 2", "band_dp_topo")):
        want, bp0 = _run(flag, rot, device=cuda_device, pipeline=False)
        text, bp = _run(flag, rot, device=cuda_device)
        assert text == want and bp.fallbacks == bp0.fallbacks == 0
        assert bp.pipeline_shards == _shard_plan(rot, 4, name)
        text, bp = _run(flag, rot, device=cuda_device, cap=2)
        assert text == want
    c5 = [[q[:max(64, len(q) - (k % 5) * 120)] for q in h[:6]]
          for k in range(16)]
    want, bp0 = _run("-S", c5, device=cuda_device, seeded=True,
                     pipeline=False)
    text, bp = _run("-S", c5, device=cuda_device, seeded=True)
    assert text == want and bp.fallbacks == 0
    assert bp.windows == bp0.windows > 0
    assert len(bp.pipeline_shards) == 2


@pytest.mark.gpu
def test_refetch_orders_on_the_shards_stream_on_gpu(cuda_device):
    """Two pipeline shards on one card: shard 0's stream writes its step
    words after a long sleep while shard 1's stream sleeps too; the
    refetch of an over-cap stream, issued before the host waits on any
    event, must read shard 0's words. A copy on the current stream reads
    them before they land."""
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.parallel import batch
    bp = BatchPOA(_params("-m 2"), device=cuda_device)
    lanes = bp._lanes(2)
    a, b = lanes[0][0], lanes[1][0]
    assert a.stream != b.stream
    assert torch.cuda.current_stream(cuda_device) not in (a.stream, b.stream)
    words = torch.arange(1, 4097, dtype=torch.int64)
    with batch._on(a):
        steps_dev = torch.zeros((2, 4096), dtype=torch.int64,
                                device=cuda_device)
        host_words = words.pin_memory()
    a.stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with batch._on(b):
        torch.cuda._sleep(1 << 30)          # ~0.5 s at 1.98 GHz
    with batch._on(a):
        torch.cuda._sleep(1 << 29)
        steps_dev[1].copy_(host_words, non_blocking=True)
    pend = dict(steps_dev=steps_dev, shard=a)
    capped = np.zeros((2, 8), np.int64)
    got = batch._step_stream(pend, capped, 1, 4096)
    assert np.array_equal(got, words.numpy())
    torch.cuda.synchronize()
