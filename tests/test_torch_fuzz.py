"""abpoa_tpu_torch: the device-loop fuzzer
(``python -m abpoa_tpu_torch.tools.fuzz_device_loop``) on the CPU.

* round mode, seeds 0-2 (one per gap set; seed 0 also the split round):
  every round of the port's device_round equals the oracle and the host
  graph;
* batch mode, four seeds (three shards, or two for seed 10; one with -s
  and a reverse-complemented read, qv weights and a forced fetch cap;
  one on the round path with the pipeline on; seed 10 an -s read that
  falls back on the loop, which the forward-only capacity rule flags):
  the sharded BatchPOA equals the serial oracle;
* envelope mode: every class draws a batch the loop admits at its
  class's instance (B2 state in global memory for qv and long, B1 past
  1024 lanes for wide), and a wide seed runs clean on the plain
  versions;
* the capacity rule flags an instance of unrelated reads and no
  instance of one read set;
* a corrupted step word makes the fuzzer report a failure (exit 1).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_mode_seed_is_clean(seed, capsys):
    from abpoa_tpu_torch.tools.fuzz_device_loop import main
    assert main(["--n", "1", "--start", str(seed), "--device", "cpu",
                 "--mode", "round"]) == 0
    out = capsys.readouterr().out
    assert f"seed {seed:4d} ok" in out and "campaign clean" in out
    if seed == 0:
        assert "split=both" in out


@pytest.mark.parametrize("seed", [3, 6, 8, 10])
def test_batch_mode_seed_is_clean(seed, capsys):
    from abpoa_tpu_torch.tools.fuzz_device_loop import main
    assert main(["--n", "1", "--start", str(seed), "--device", "cpu",
                 "--mode", "batch"]) == 0
    out = capsys.readouterr().out
    assert f"shards={2 if seed == 10 else 3}" in out
    assert "campaign clean" in out
    if seed == 10:
        # an -s read falls back on the loop: the forward-only oracle's
        # capacity rule flags its instance
        assert "amb=True" in out and "path=loop, fallbacks 1" in out
    if seed == 6:
        assert "amb=True" in out and "qv=True" in out and "cap=35" in out
    if seed == 8:
        assert "pipeline=True path=rounds" in out


@pytest.mark.parametrize("cls", ["qv", "long", "wide"])
def test_envelope_class_draws_reach_their_instance(cls):
    """Seeds 0-29: each seed's class is ENVELOPE[seed % 3]; the device
    loop admits its batch, qv with qv weights (wmode 1) and long with unit
    weights under affine or linear gaps take B2 with its state in global
    memory (reads of 1.9-2.5 and 2.6-3.2 kb), wide a band of 1,025-2,048
    lanes at four positions a thread."""
    from abpoa_tpu_torch.ops import band_dp, graph_update
    from abpoa_tpu_torch.parallel.batch import _loop_geometry
    from abpoa_tpu_torch.tools.fuzz_device_loop import ENVELOPE, draw_envelope
    for seed in range(ENVELOPE.index(cls), 30, 3):
        got, params, insts, ws = draw_envelope(seed)
        assert got == cls
        lens = [len(q) for reads in insts for q in reads]
        wmax = max(sum(max(w) for w in wk) for wk in ws) if ws else None
        cfg = _loop_geometry(params, insts, wmax)
        assert cfg is not None, seed
        assert cfg.wmode == (cls == "qv")
        if cls == "wide":
            assert 1024 < cfg.WB <= 2048 and band_dp.band_cpt(cfg.WB) == 4
        else:
            assert graph_update.state_in_global(cfg), seed
            lo, hi = (1800, 2500) if cls == "qv" else (2500, 3200)
            assert lo <= max(lens) <= hi, (seed, max(lens))
            assert params.gap_mode != 2 or cls == "qv"


def test_envelope_wide_seed_is_clean(capsys):
    from abpoa_tpu_torch.tools.fuzz_device_loop import main
    assert main(["--n", "1", "--start", "14", "--device", "cpu",
                 "--mode", "envelope"]) == 0
    out = capsys.readouterr().out
    assert "seed   14 ok (wide" in out and "WB=1408" in out
    assert "campaign clean" in out


def test_capacity_rule_flags_unrelated_reads():
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.tools.fuzz_device_loop import (_capacity_flags,
                                                        _gen_instance)
    rng = np.random.default_rng(1)
    unrelated = [rng.integers(0, 4, 150).astype(np.uint8) for _ in range(3)]
    alike = _gen_instance(rng, 150, 3, 0.05, 0.02)
    p = Params().post_set()
    bp = BatchPOA(p, device="cpu")
    bp.run_consensus([alike, unrelated])
    assert bp.fallbacks == 1
    cfg = bp._loop_eligible([alike, unrelated])
    assert _capacity_flags(p, [alike, unrelated], None, cfg) == [False, True]


def test_corrupted_step_word_is_reported(monkeypatch, capsys):
    """The first step of instance 0 flips its op in every round: the
    replayed cigar no longer equals the oracle's."""
    from abpoa_tpu_torch.ops import poa_loop
    from abpoa_tpu_torch.tools.fuzz_device_loop import main
    orig = poa_loop.device_round

    def corrupt(*a, **k):
        out = list(orig(*a, **k))
        s16 = out[5].clone()
        s16[0, 0] ^= 1
        out[5] = s16
        return tuple(out)
    monkeypatch.setattr(poa_loop, "device_round", corrupt)
    assert main(["--n", "1", "--start", "1", "--device", "cpu",
                 "--mode", "round"]) == 1
    out = capsys.readouterr().out
    assert "seed    1 FAIL" in out and "cigar" in out
