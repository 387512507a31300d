"""abpoa_tpu_torch: processes (``parallel/multihost.py``) through the
port's launcher (``python -m abpoa_tpu_torch.parallel.scaling --procs``).

The cases of tests/test_multihost.py: two fresh worker processes
rendezvous through a file:// store, run their shards of 6 x seq.fa and
gather the rendered text on process 0 over gloo; the gathered FASTA
equals the single-process port run (and, plain, seq_cons.fa six times),
process 1 holds no text, and no worker loaded JAX or the JAX package.
In one process over devices=["cpu"], instances of uneven depth give the
port's serial oracle's text through the device loop, and ``stats``
report the device's busy time as busy_s, inside the call.
On a GPU: the same through the card (the two processes share it).
"""
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent
DATA = TESTS / "data"
N_INSTANCES = 6
FIXTURE = "seq.fa"

torch.set_num_threads(1)


def _single_process_output(seeded, device="cpu"):
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.alphabet import encode_table
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.seqio import read_seqs
    tab = encode_table(5)
    reads = [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
             for r in read_seqs(str(DATA / FIXTURE))]
    p = Params()
    if seeded:
        p.disable_seeding = 0
    p = p.post_set()
    p.out_cons = 1
    bp = BatchPOA(p, device=device)
    abs_ = (bp.run_seeded if seeded else bp.run)([reads] * N_INSTANCES)
    out = io.StringIO()
    for ab in abs_:
        ab.output(p, out)
    return out.getvalue()


def _launch(tmp_path, seeded, device="cpu"):
    out_fa = tmp_path / "gathered.fa"
    cmd = [sys.executable, "-m", "abpoa_tpu_torch.parallel.scaling",
           "--procs", "2", "--device", device,
           "--instances", str(N_INSTANCES), "--fixture", FIXTURE,
           "--out", str(out_fa), "--no-warm"] + ["--seeded"] * seeded
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [json.loads(x) for x in r.stdout.strip().splitlines()]
    summary = lines[-1]
    assert summary["metric"] == "host_scaling_efficiency"
    assert summary["hosts"] == 2
    workers = lines[1:-1]
    assert [ln["process"] for ln in workers] == [0, 1]
    assert sum(ln["shard_instances"] for ln in workers) == N_INSTANCES
    # rank 0 alone holds the gathered text
    assert workers[0]["text_bytes"] == len(out_fa.read_text())
    assert workers[1]["text_bytes"] is None
    assert all(ln["foreign_modules"] == [] for ln in lines[:-1])
    return out_fa.read_text(), summary


@pytest.mark.parametrize("seeded", [False, True], ids=["plain", "seeded"])
def test_two_process_gather_matches_single(tmp_path, seeded):
    got, summary = _launch(tmp_path, seeded)
    assert summary["cards"] == 0
    assert got == _single_process_output(seeded)
    if not seeded:
        assert got == (TESTS / "golden" / "seq_cons.fa").read_text() \
            * N_INSTANCES


def test_gather_text_of_one_process():
    """Without a process group the world is one process: the text comes
    back as the only part, and the shard is the whole list."""
    from abpoa_tpu_torch.parallel import multihost as mh
    assert mh.gather_text("abc") == ["abc"]
    assert mh.local_shard([1, 2, 3]) == [1, 2, 3]
    assert mh.local_devices("cpu") == ["cpu"]


def test_stats_of_one_cpu_entry(monkeypatch):
    """run_consensus_fasta over devices=["cpu"] in one process, instance
    k keeping seq.fa's reads[k % 4:]: the serial oracle's text through
    the device loop with no fallback; busy_s is the union of the device
    phases, inside the call, and stats carry no second clock."""
    import dataclasses
    from abpoa_tpu_torch.api import ABPOA
    from abpoa_tpu_torch.alphabet import encode_table
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.parallel import batch, multihost as mh
    from abpoa_tpu_torch.seqio import read_seqs
    tab = encode_table(5)
    seqs = [r.seq for r in read_seqs(str(DATA / FIXTURE))]
    reads = [tab[np.frombuffer(q.encode(), dtype=np.uint8)] for q in seqs]
    insts = [reads[k % 4:] for k in range(4)]
    p = Params().post_set()
    p.out_cons = 1
    host = dataclasses.replace(p, engine="numpy")
    want = io.StringIO()
    for k in range(4):
        ABPOA().msa(host, seqs[k % 4:], out=want)
    loops = []
    run = batch._DeviceLoop.run
    monkeypatch.setattr(batch._DeviceLoop, "run",
                        lambda self: loops.append(run(self)))
    s = {}
    got = mh.run_consensus_fasta(p, insts, devices=["cpu"], stats=s)
    assert got == want.getvalue() and loops == [True]
    assert s["shard_instances"] == 4 and s["fallbacks"] == 0
    assert s["rounds"] == len(reads) - 1 and s["dp_cells"] > 0
    assert 0 < s["busy_s"] <= s["wall_s"]
    assert "dp_seconds" not in s


@pytest.mark.gpu
def test_two_process_gather_on_gpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    got, summary = _launch(tmp_path, False, device="cuda")
    assert summary["cards"] == min(2, torch.cuda.device_count())
    assert got == (TESTS / "golden" / "seq_cons.fa").read_text() \
        * N_INSTANCES
