"""abpoa_tpu_torch: the round-based BatchPOA path (topo-mode band DP and
full-width DP, plain versions on the CPU) end to end.

* batch_msa_from_files and BatchPOA give the sanitized golden bytes of
  the CLI configurations the device loop turns away, with the arguments
  of tests/test_parity.py and tests/test_modes.py: -m 1 (local),
  -m 2 (extend), -b -1 (unbanded), -c (protein).
* -i list mode (every instance restores seq.gfa) equals the port's
  serial ABPOA.msa_from_file per file, as tests/test_modes.py holds the
  JAX package's batched list mode to its serial loop.
* Routing: an eligible batch runs the device loop and launches no round
  kernel; an ineligible one runs the rounds. A round whose band does not
  fit a block and whose full-width planes exceed the plane budget runs
  the banded-tile kernel (round_plan's third branch).
* qv weights on a batch the loop turns away (-m 1) run the round path
  with the weights in the host fusion; -S list mode runs the seeded
  window rounds; -l -Q runs the device loop with qv weights.
* On a GPU: the same goldens through the kernels.
Exact equality everywhere.
"""
import contextlib
import dataclasses
import io
import pathlib

import numpy as np
import pytest
import torch

TESTS = pathlib.Path(__file__).resolve().parent
DATA = TESTS / "data"
GOLDEN_SAN = TESTS / "golden_sanitized"

torch.set_num_threads(1)

# (golden, CLI arguments, input) of the round path's configurations
ROUND_PARITY = [("seq_cons_local.fa", ["-m", "1"], "seq.fa"),
                ("seq_cons_ext.fa", ["-m", "2"], "seq.fa"),
                ("seq_cons_noband.fa", ["-b", "-1"], "seq.fa"),
                ("prot_cons.fa", ["-c"], "prot.fa")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _cli_params(args, monkeypatch):
    """The port's Params for the JAX package CLI's parse of `args` (its
    run step intercepted), carried across by convert.params, with the
    serial DP on the host oracle (the expected values' engine)."""
    import abpoa_tpu.cli as cli
    from abpoa_tpu_torch import convert
    got = {}

    def grab(params, in_list, pos, out):
        got["params"] = params
    monkeypatch.setattr(cli, "_run", grab)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        cli.main(list(args) + [str(DATA / "seq.fa")])
    return dataclasses.replace(convert.params(got["params"]), engine="numpy")


def _reads(fn, m=5):
    from abpoa_tpu_torch.seqio import read_seqs
    from abpoa_tpu_torch.alphabet import encode_table
    tab = encode_table(m)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / fn))]


def _list_mode(args, fn, n, device, monkeypatch):
    from abpoa_tpu_torch import batch_msa_from_files
    params = _cli_params(args, monkeypatch)
    out = io.StringIO()
    batch_msa_from_files(params, [str(DATA / fn)] * n, out, device=device)
    return out.getvalue()


@pytest.mark.parametrize("golden,args,fn", ROUND_PARITY,
                         ids=[c[0] for c in ROUND_PARITY])
def test_round_list_mode_golden(golden, args, fn, monkeypatch):
    """List mode over two copies of the input: golden bytes per file."""
    assert _list_mode(args, fn, 2, "cpu", monkeypatch) \
        == (GOLDEN_SAN / golden).read_text() * 2


@pytest.mark.parametrize("golden,args,fn", ROUND_PARITY[:2],
                         ids=[c[0] for c in ROUND_PARITY[:2]])
def test_round_batch_consensus_golden(golden, args, fn, monkeypatch):
    """BatchPOA.run_consensus over rotated read orders equals the port's
    serial loop per instance, and the unrotated instance the golden;
    a forced step-stream cap of 2 (every instance refetches) gives the
    same bytes."""
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.api import ABPOA
    from abpoa_tpu_torch.consensus import generate_consensus
    from abpoa_tpu_torch.alphabet import decode_table
    params = _cli_params(args, monkeypatch)
    reads = _reads(fn)
    instances = [reads, reads[2:] + reads[:2], reads[::-1][:6]]
    dt = decode_table(params.m)
    exp = []
    for inst in instances:
        ab = ABPOA()
        ab.n_seq = len(inst)
        ab.names = [""] * len(inst)
        ab.is_rc = [0] * len(inst)
        ab.poa(params, inst, [[1] * len(q) for q in inst], 0)
        generate_consensus(ab, params)
        exp.append([bytes(dt[b] for b in s).decode()
                    for s in ab.cons.cons_base[:ab.cons.n_cons]])
    gold = (GOLDEN_SAN / golden).read_text().split("\n")[1]
    assert exp[0] == [gold]
    for cap in (None, 2):
        bp = BatchPOA(params, device="cpu")
        bp.s16_cap = cap
        assert bp.run_consensus(instances) == exp
        assert not bp.used_device_loop and bp.fallbacks == 0
        assert bp.rounds == len(reads) - 1
        assert bp.launches["band_dp_topo"] + bp.launches["fw_dp"] \
            == bp.rounds


def test_incremental_list_mode_equals_serial(monkeypatch):
    """-i seq.gfa -r3 over 3 x seq.fa: the batched rounds equal the
    port's serial msa_from_file per file, and its golden."""
    from abpoa_tpu_torch.api import ABPOA
    args = ["-i", str(GOLDEN_SAN / "seq.gfa"), "-r3"]
    params = _cli_params(args, monkeypatch)
    serial = io.StringIO()
    for _ in range(3):
        ABPOA().msa_from_file(params, str(DATA / "seq.fa"), serial)
    batched = _list_mode(args, "seq.fa", 3, "cpu", monkeypatch)
    assert batched == serial.getvalue()
    assert batched == (GOLDEN_SAN / "seq_incr_gfa.gfa").read_text() * 3


@pytest.mark.parametrize("mode", ["loop", "rounds"])
def test_routing_by_eligibility(mode, monkeypatch):
    """Global banded nucleotides go through the device loop (no round
    kernel launched); local mode through the rounds (full-width kernel)."""
    from abpoa_tpu_torch import BatchPOA
    args = [] if mode == "loop" else ["-m", "1"]
    params = _cli_params(args, monkeypatch)
    reads = _reads("seq.fa")[:4]
    bp = BatchPOA(params, device="cpu")
    bp.run([reads, reads[1:]])
    if mode == "loop":
        assert bp.used_device_loop
        assert bp.launches == {"band_dp_topo": 0, "fw_dp": 0, "tile_dp": 0}
    else:
        assert not bp.used_device_loop
        assert bp.launches == {"band_dp_topo": 0, "fw_dp": 3, "tile_dp": 0}


def test_round_plan_third_branch_runs_the_tile_kernel(monkeypatch):
    """Extend mode over two rotated heter.fa instances (3 reads) with the
    band kernel's shared memory shrunk to nothing (its band no longer
    fits a block) and a plane budget between one instance's tiles and
    its full-width planes: every round runs the banded-tile kernel, one
    instance per launch, and gives the serial oracle's consensus with no
    fallback."""
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.api import ABPOA
    from abpoa_tpu_torch.consensus import generate_consensus
    from abpoa_tpu_torch.alphabet import decode_table
    from abpoa_tpu_torch import device
    from abpoa_tpu_torch.ops import band_dp
    params = _cli_params(["-m", "2"], monkeypatch)
    reads = _reads("heter.fa")
    instances = [reads[:3], reads[3:6]]
    dt = decode_table(params.m)
    exp = []
    for inst in instances:
        ab = ABPOA()
        ab.n_seq = len(inst)
        ab.names = [""] * len(inst)
        ab.is_rc = [0] * len(inst)
        ab.poa(params, inst, [[1] * len(q) for q in inst], 0)
        generate_consensus(ab, params)
        exp.append([bytes(dt[b] for b in s).decode()
                    for s in ab.cons.cons_base[:ab.cons.n_cons]])
    # heter.fa rounds: tiles of 5 x R x 384 x 4 bytes (R <= 832) fit 8 MiB,
    # full-width planes of 5 x R x Wq x 4 bytes (R >= 704, Wq >= 640) do not
    monkeypatch.setattr(band_dp, "MAX_SMEM_BYTES", 0)
    monkeypatch.setattr(device, "CPU_PLANE_BUDGET", 8 << 20)
    bp = BatchPOA(params, device="cpu")
    assert bp.run_consensus(instances) == exp
    assert not bp.used_device_loop and bp.fallbacks == 0
    assert bp.rounds == 2
    assert bp.launches == {"band_dp_topo": 0, "fw_dp": 0, "tile_dp": 4}


@pytest.mark.parametrize("what", ["qv", "seeded", "qv_list"])
def test_still_out_of_scope_raises(what, monkeypatch):
    """The batches that were out of scope before qv weights and seeded
    windows were ported, now served: a qv batch in local mode (the round
    path, weights in the host fusion) equals the port's serial oracle
    under the same weights; -S list mode over 2 x seq.fa equals the
    port's serial oracle per file; -l -Q over 4 x seq.fq (the device
    loop in wmode 1) gives seq_fq_Q_cons.fa per file."""
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.api import ABPOA
    from abpoa_tpu_torch.consensus import generate_consensus
    from abpoa_tpu_torch.alphabet import decode_table
    if what == "qv":
        params = _cli_params(["-m", "1"], monkeypatch)
        reads = _reads("seq.fa")[:3]
        rng = np.random.default_rng(11)
        weights = [[rng.integers(1, 60, len(q)).tolist() for q in reads]]
        ab = ABPOA()
        ab.n_seq, ab.names, ab.is_rc = 3, [""] * 3, [0] * 3
        ab.poa(params, reads, weights[0], 0)
        generate_consensus(ab, params)
        dt = decode_table(params.m)
        exp = [[bytes(dt[b] for b in s).decode()
                for s in ab.cons.cons_base[:ab.cons.n_cons]]]
        bp = BatchPOA(params, device="cpu")
        assert bp.run_consensus([reads], weights=weights) == exp
        assert not bp.used_device_loop and bp.fallbacks == 0
        return
    args, fn, n = ((["-S"], "seq.fa", 2) if what == "seeded"
                   else (["-Q"], "seq.fq", 4))
    got = _list_mode(args, fn, n, "cpu", monkeypatch)
    if what == "seeded":
        out = io.StringIO()
        ABPOA().msa_from_file(_cli_params(args, monkeypatch),
                              str(DATA / fn), out)
        assert got == out.getvalue() * n
    else:
        assert got == (GOLDEN_SAN / "seq_fq_Q_cons.fa").read_text() * n


@pytest.mark.gpu
@pytest.mark.parametrize("golden,args,fn", ROUND_PARITY,
                         ids=[c[0] for c in ROUND_PARITY])
def test_round_list_mode_golden_on_gpu(golden, args, fn, monkeypatch,
                                       cuda_device):
    assert _list_mode(args, fn, 4, "cuda", monkeypatch) \
        == (GOLDEN_SAN / golden).read_text() * 4
