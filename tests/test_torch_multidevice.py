"""abpoa_tpu_torch: data parallelism over a device list
(``BatchPOA(devices=[...])``), the counterpart of the JAX package's mesh.

* shard_bounds equals the JAX package's partition; the union of device
  phases (busy time) over empty, disjoint, overlapping, nested, touching
  and unsorted phases.
* Heterogeneous seq.fa instances over four CPU shards, rendered as
  consensus, MSA and GFA, equal the JAX package's BatchPOA over a
  4-device virtual CPU mesh.
* The device loop, the round path (-m 1, -m 2) and the seeded windows
  over 2 and 3 uneven shards equal the goldens and the single-device
  run, with equal counters (launches: one a shard with work, a round).
* Eight seeded-random instances over four CPU entries, on the device
  loop and on the seeded windows: the one-device run, and each entry's
  record (busy_s, launched_s, instances).
* -i with qv weights over two shards; a mixed batch (a capacity
  fallback, a forced step-stream cap of 2) over two shards; more shards
  than instances; the dry run over two CPU shards.
* On a GPU: the event of each shard on the stream its copies ran on
  (two shards on one card, each stream held back by a sleep), a second
  card, 64 x heter.fa, -m 1, -m 2 and config-5 seeded over two shards of
  one card, over two cards, and the four-entry check over four cards.
Exact equality everywhere.
"""
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

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _reads(fn, n=None):
    from abpoa_tpu_torch.seqio import read_seqs
    from abpoa_tpu_torch.alphabet import encode_table
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / fn))][:n]


def _params(flag=None, full=False):
    from abpoa_tpu_torch.params import Params, LOCAL_MODE, EXTEND_MODE
    p = Params()
    if flag == "-m 1":
        p.align_mode = LOCAL_MODE
    elif flag == "-m 2":
        p.align_mode = EXTEND_MODE
    elif flag == "-S":
        p.disable_seeding = 0
    if full:
        p.out_cons = p.out_msa = p.out_gfa = 1
    return p.post_set()


def _counters(bp):
    return dict(dp_cells=bp.dp_cells, fallbacks=bp.fallbacks,
                rounds=bp.rounds, windows=bp.windows,
                empty_windows=bp.empty_windows, loop=bp.used_device_loop)


def _render(abs_, params):
    out = io.StringIO()
    for ab in abs_:
        ab.output(params, out)
    return out.getvalue()


def test_shard_bounds_equal_jax():
    from abpoa_tpu.parallel.multihost import shard_bounds as jax_bounds
    from abpoa_tpu_torch.parallel.multihost import shard_bounds
    for n in range(0, 23):
        for shards in range(1, 7):
            got = [shard_bounds(n, shards, i) for i in range(shards)]
            assert got == [jax_bounds(n, shards, i) for i in range(shards)]
            assert got[0][0] == 0 and got[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("intervals,want", [
    pytest.param([], 0.0, id="empty"),
    pytest.param([(0.0, 1.0), (2.0, 3.5)], 2.5, id="disjoint"),
    pytest.param([(0.0, 2.0), (1.0, 3.0)], 3.0, id="overlapping"),
    pytest.param([(0.0, 4.0), (1.0, 2.0)], 4.0, id="nested"),
    pytest.param([(0.0, 1.0), (1.0, 2.5)], 2.5, id="touching"),
    pytest.param([(5.0, 6.0), (0.0, 1.0), (0.5, 2.0)], 3.0, id="unsorted")])
def test_union_of_device_phases(intervals, want):
    """_union_s, the one path of device time (dp_busy_seconds, each
    entry's busy_s): the length of the union of the phases."""
    from abpoa_tpu_torch.parallel.batch import _union_s
    assert _union_s(intervals) == pytest.approx(want)


def test_device_list_arguments():
    """devices replaces device; an empty list raises; without devices
    the one device runs on its current stream."""
    from abpoa_tpu_torch import BatchPOA
    with pytest.raises(ValueError, match="empty"):
        BatchPOA(_params(), devices=[])
    bp = BatchPOA(_params(), device="cpu")
    assert [s.dev for s in bp._shards] == [torch.device("cpu")]
    assert [s.stream for s in bp._shards] == [None]
    bp = BatchPOA(_params(), device="cuda" if torch.cuda.is_available()
                  else "cpu", devices=["cpu", torch.device("cpu")])
    assert bp.device == torch.device("cpu") and len(bp._shards) == 2
    assert bp.shards == [{"device": "cpu", "instances": 0, "busy_s": 0.0,
                          "launched_s": 0.0}] * 2


def test_heterogeneous_full_output_equals_jax_mesh():
    """Four CPU shards against the JAX package's 4-device virtual CPU
    mesh (tests/conftest.py splits the CPU into 8 devices): consensus,
    MSA and GFA of heterogeneous instances, byte for byte."""
    import jax
    from jax.sharding import Mesh
    from abpoa_tpu.params import Params as JParams
    from abpoa_tpu.parallel import BatchPOA as JBatch
    from abpoa_tpu_torch import BatchPOA
    if len(jax.devices()) < 4:
        pytest.skip("needs the 4-device virtual CPU mesh of conftest.py")
    reads = _reads("seq.fa")
    insts = [reads, reads[:8], reads[:6], reads[:9]]
    jp = JParams()
    jp.out_cons = jp.out_msa = jp.out_gfa = 1
    jp.post_set()
    want = _render(JBatch(jp, mesh=Mesh(np.array(jax.devices()[:4]),
                                        ("data",))).run(insts), jp)
    bp = BatchPOA(_params(full=True), devices=["cpu"] * 4)
    got = _render(bp.run(insts), _params(full=True))
    assert got == want
    assert bp.used_device_loop and bp.fallbacks == 0
    assert [s["instances"] for s in bp.shards] == [1, 1, 1, 1]


GOLDEN = {None: "seq_cons.fa", "-m 1": "seq_cons_local.fa",
          "-m 2": "seq_cons_ext.fa"}


@functools.lru_cache(maxsize=None)
def _single(flag):
    """The single-device run of _path_instances(): (consensus, counters,
    launches)."""
    from abpoa_tpu_torch import BatchPOA
    bp = BatchPOA(_params(flag), device="cpu")
    cons = bp.run_consensus(_path_instances(), seeded=flag == "-S")
    return cons, _counters(bp), dict(bp.launches)


def _path_instances():
    reads = _reads("seq.fa")
    return [reads, reads[:7], reads, reads[:5], reads[2:]]


@pytest.mark.parametrize("flag,n", [(None, 3), ("-m 1", 2), ("-m 2", 3),
                                    ("-S", 2)],
                         ids=["loop-3", "m1-2", "m2-3", "seeded-2"])
def test_paths_over_uneven_shards(flag, n):
    """Five instances over 2 (3/2) or 3 (2/2/1) shards: the goldens, the
    single-device run and its counters; the round path launches its plan
    once a round on every shard that has work."""
    from abpoa_tpu_torch import BatchPOA
    insts = _path_instances()
    cons, counters, launches = _single(flag)
    bp = BatchPOA(_params(flag), devices=["cpu"] * n)
    got = bp.run_consensus(insts, seeded=flag == "-S")
    assert got == cons
    assert _counters(bp) == counters
    assert bp.fallbacks == 0
    if flag != "-S":
        gold = (GOLDEN_SAN / GOLDEN[flag]).read_text().split("\n")[1]
        assert got[0] == got[2] == [gold]
    if flag in ("-m 1", "-m 2"):
        live = [sum(len(r) > k for r in insts)
                for k in range(1, max(map(len, insts)))]
        name = "fw_dp" if flag == "-m 1" else "band_dp_topo"
        assert bp.launches[name] == sum(min(n, m) for m in live)
        assert launches[name] == len(live)
        assert sum(s["instances"] for s in bp.shards) == sum(live)
    if flag is None:
        # the loop splits its five live instances 2/2/1
        assert [s["instances"] for s in bp.shards] == [2, 2, 1]


def test_incremental_and_qv_over_two_shards():
    """-i (every instance restores seq.gfa before its reads fuse: the
    round path) with qv weights, over two shards: the single-device run,
    rendered as GFA, byte for byte."""
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.gfa import restore_graph
    p = _params()
    p.incr_fn = str(GOLDEN_SAN / "seq.gfa")
    p.out_gfa = 1
    reads = _reads("seq.fa", 4)
    insts = [reads, reads[1:], reads[:3]]
    rng = np.random.default_rng(5)
    ws = [[rng.integers(1, 60, len(q)).tolist() for q in inst]
          for inst in insts]

    def init(ab):
        restore_graph(ab, p)
    one = BatchPOA(p, device="cpu")
    want = _render(one.run(insts, weights=ws, init=init), p)
    bp = BatchPOA(p, devices=["cpu", "cpu"])
    assert _render(bp.run(insts, weights=ws, init=init), p) == want
    assert not bp.used_device_loop and _counters(bp) == _counters(one)


def test_mixed_batch_over_two_shards():
    """A capacity fallback and a forced step-stream cap of 2 (every
    stream refetches) over two shards: the serial oracle."""
    from test_torch_device_loop import _mixed_instances, _serial_oracle
    from abpoa_tpu.params import Params as JParams
    from abpoa_tpu_torch import BatchPOA
    insts = _mixed_instances()
    exp = _serial_oracle(insts, JParams().post_set())
    bp = BatchPOA(_params(), devices=["cpu", "cpu"])
    bp.s16_cap = 2
    assert bp.run_consensus(insts) == exp
    assert bp.used_device_loop and bp.fallbacks == 1


def test_more_shards_than_instances():
    """Two instances over five shards: three shards are empty."""
    from abpoa_tpu_torch import BatchPOA
    reads = _reads("seq.fa", 4)
    insts = [reads, reads[1:]]
    one = BatchPOA(_params(), device="cpu")
    want = one.run_consensus(insts)
    bp = BatchPOA(_params(), devices=["cpu"] * 5)
    assert bp.run_consensus(insts) == want
    assert _counters(bp) == _counters(one)
    assert [s["instances"] for s in bp.shards] == [1, 1, 0, 0, 0]


def _seeded_batch(n, seeded):
    """n instances drawn from a fixed seed: 4 reads of a 120-190 base
    ancestor (3 % substitutions, 2 % indels), 160-230 under -S."""
    from abpoa_tpu_torch.tools.fuzz_device_loop import _gen_instance
    rng = np.random.default_rng(20261018)
    base = 160 if seeded else 120
    return [_gen_instance(rng, base + 70 * k // n, 4, 0.03, 0.02)
            for k in range(n)]


def _four_entries(seeded, devices, one_device, n):
    """`n` instances over the four entries of `devices` against the
    one-device run on `one_device`: the same output bytes (consensus,
    MSA, GFA) and counters; every entry busy, its launch skew recorded,
    and the entries' instances adding up to the live instances (the
    loop) or to the windows aligned on the device (seeded)."""
    from abpoa_tpu_torch import BatchPOA
    insts = _seeded_batch(n, seeded)
    flag = "-S" if seeded else None
    one = BatchPOA(_params(flag, full=True), device=one_device)
    run_one = one.run_seeded if seeded else one.run
    want = _render(run_one(insts), _params(flag, full=True))
    bp = BatchPOA(_params(flag, full=True), devices=devices)
    got = _render((bp.run_seeded if seeded else bp.run)(insts),
                  _params(flag, full=True))
    assert got == want
    assert _counters(bp) == _counters(one)
    assert bp.fallbacks == 0 and bp.used_device_loop == (not seeded)
    assert [s["device"] for s in bp.shards] == [str(torch.device(d))
                                                for d in devices]
    assert all(s["busy_s"] > 0 and s["launched_s"] >= 0 for s in bp.shards)
    live = bp.windows if seeded else sum(len(r) >= 2 for r in insts)
    assert sum(s["instances"] for s in bp.shards) == live > 0
    if not seeded:
        assert [s["instances"] for s in bp.shards] == [n // 4] * 4
    return bp


@pytest.mark.parametrize("seeded", [False, True], ids=["loop", "seeded"])
def test_four_entries_record_each_card(seeded):
    """Eight seeded-random instances over devices=["cpu"] * 4, on the
    device loop and on the seeded windows: the one-device run byte for
    byte, and each entry's busy_s, launched_s and instances."""
    _four_entries(seeded, ["cpu"] * 4, "cpu", 8)


def test_dryrun_over_two_cpu_shards():
    from abpoa_tpu_torch.parallel.dryrun import dryrun_multidevice
    got = dryrun_multidevice(["cpu", "cpu"], fixtures=("seq.fa",))
    assert got == {"devices": ["cpu", "cpu"], "golden_seq.fa": 4,
                   "heterogeneous": 4, "seeded": 2}


# ------------------------------------------------------------------ #
# on the card

def _heter_gold():
    return (GOLDEN_SAN / "heter_cons.fa").read_text().split("\n")[1]


@pytest.mark.gpu
def test_event_waits_on_the_shards_stream_on_gpu(cuda_device, monkeypatch):
    """Two shards on one card, each on its own stream, which is not the
    current stream when the host waits; a long sleep on each shard's
    stream before its pinned copies. An event recorded on any other
    stream lets the host read the buffers before the copies land."""
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.parallel import batch
    orig = batch._enqueue_fetch
    slept = []

    def delayed(shard, tensors):
        if shard.stream is not None:
            with torch.cuda.device(shard.dev), torch.cuda.stream(shard.stream):
                torch.cuda._sleep(1 << 29)      # ~0.3 s at 1.98 GHz
            slept.append(shard.stream)
        return orig(shard, tensors)
    monkeypatch.setattr(batch, "_enqueue_fetch", delayed)
    heter = _reads("heter.fa")
    bp = BatchPOA(_params(), devices=["cuda:0", "cuda:0"])
    assert all(s.stream != torch.cuda.current_stream(s.dev)
               for s in bp._shards)
    cons = bp.run_consensus([heter] * 8)
    assert len(slept) == 2 and slept[0] != slept[1]
    assert cons == [[_heter_gold()]] * 8
    assert bp.fallbacks == 0 and bp.used_device_loop


@pytest.mark.gpu
def test_second_card_on_gpu(cuda_device):
    """BatchPOA(device="cuda:1"): the loop's copies and their event on
    that card's stream."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: this host has "
                    f"{torch.cuda.device_count()}")
    from abpoa_tpu_torch import BatchPOA
    heter = _reads("heter.fa")
    bp = BatchPOA(_params(), device="cuda:1")
    assert bp.run_consensus([heter] * 16) == [[_heter_gold()]] * 16
    assert bp.fallbacks == 0


def _oracle(params, insts, seeded=False):
    import dataclasses
    from abpoa_tpu_torch.api import ABPOA
    from abpoa_tpu_torch.consensus import generate_consensus
    from abpoa_tpu_torch.alphabet import decode_table
    host = dataclasses.replace(params, engine="numpy")
    dt = decode_table(5)
    out = []
    for inst in insts:
        ab = ABPOA()
        ab.msa(host, [bytes(dt[b] for b in q).decode() for q in inst])
        generate_consensus(ab, host)
        out.append([bytes(dt[b] for b in s).decode()
                    for s in ab.cons.cons_base[:ab.cons.n_cons]])
    return out


def _sharded_card_runs(devices):
    from abpoa_tpu_torch import BatchPOA
    heter = _reads("heter.fa")
    bp = BatchPOA(_params(), devices=devices)
    assert bp.run_consensus([heter] * 64) == [[_heter_gold()]] * 64
    assert bp.fallbacks == 0 and bp.used_device_loop
    for flag in ("-m 1", "-m 2"):
        exp = _oracle(_params(flag), [heter])[0]
        bp = BatchPOA(_params(flag), devices=devices)
        assert bp.run_consensus([heter] * 64) == [exp] * 64, flag
        assert bp.fallbacks == 0 and not bp.used_device_loop
    c5 = [[q[:max(64, len(q) - (k % 5) * 120)] for q in heter]
          for k in range(64)]
    exp = _oracle(_params("-S"), c5[:5])
    bp = BatchPOA(_params("-S"), devices=devices)
    got = bp.run_consensus(c5, seeded=True)
    assert got == [exp[k % 5] for k in range(64)]
    assert bp.fallbacks == 0 and bp.windows > 0


@pytest.mark.gpu
def test_two_shards_on_one_card_on_gpu(cuda_device):
    _sharded_card_runs(["cuda:0", "cuda:0"])


@pytest.mark.gpu
def test_four_cards_on_gpu(cuda_device):
    """64 instances over cuda:0-3 (16 a card: two sub-batches a card on
    the loop) on the device loop and on the seeded windows: the run on
    cuda:0 alone byte for byte, no fallback, every card busy."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: this host has "
                    f"{torch.cuda.device_count()}")
    cards = [f"cuda:{i}" for i in range(4)]
    for seeded in (False, True):
        bp = _four_entries(seeded, cards, "cuda:0", 64)
        assert bp.fallbacks == 0


@pytest.mark.gpu
def test_two_cards_on_gpu(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: this host has "
                    f"{torch.cuda.device_count()}")
    _sharded_card_runs(["cuda:0", "cuda:1"])
