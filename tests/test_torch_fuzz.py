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
