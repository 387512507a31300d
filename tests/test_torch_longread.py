"""abpoa_tpu_torch on long reads: graphs past 4096 nodes, where the
former int32 step word op|row<<2|col<<14 ran out of row bits.

The input is built here from tests/data/heter.fa: read k of the long
set joins heter.fa reads k..k+6 (4.7-4.9 kb each; the ~15 kb set joins
21). On the CPU: the port's oracle CLI (``--engine numpy``) gives the
JAX package CLI's bytes for the default flags, -m 1, -m 2 and -S, and
the port's CLI on the kernels' plain versions (``--device cpu``, plain
B5 over rows past 4096) gives them for two reads. On a GPU: the port's
CLI on the card gives its oracle's bytes for the default flags, -m 1,
-S and -l -m 2 over 4 files (the round path's band kernel over rows
past 4096; the device loop, like the JAX package's, takes graphs up to
4096 rows and rebuilds larger ones on the oracle), and for the ~15 kb
set (the per-row arrays of B4 and B5 past shared memory). Exact byte
equality.
"""
import pytest
import torch

from test_torch_cli import jax_cli, port, run

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def long_reads(n_reads, join=7, first=0):
    """(name, sequence) of n_reads long reads: read k joins heter.fa
    reads first+k .. first+k+join-1 (cyclically)."""
    from abpoa_tpu_torch.seqio import read_seqs
    from test_torch_cli import DATA
    heter = [r.seq for r in read_seqs(str(DATA / "heter.fa"))]
    return [(f"long{k}", "".join(heter[(first + k + i) % len(heter)]
                                 for i in range(join)))
            for k in range(n_reads)]


def write_fa(path, reads):
    path.write_text("".join(f">{n}\n{s}\n" for n, s in reads))
    return str(path)


ORACLE_CASES = [[], ["-m", "1"], ["-m", "2"], ["-S"]]


@pytest.mark.parametrize("flags", ORACLE_CASES,
                         ids=[" ".join(f) or "default" for f in ORACLE_CASES])
def test_oracle_cli_equals_jax_on_long_reads(flags, tmp_path):
    fa = write_fa(tmp_path / "long3.fa", long_reads(3))
    got = port(["--engine", "numpy", *flags, fa])
    assert got.startswith(">Consensus_sequence")
    assert got == jax_cli([*flags, fa])


def test_cli_cpu_past_4096_nodes_equals_jax(tmp_path):
    """Two long reads through the serial engine on the plain versions:
    the second read's DP runs over more than 4096 rows."""
    from abpoa_tpu_torch.align import engine_torch
    from abpoa_tpu_torch.ops import tile_dp
    fa = write_fa(tmp_path / "long2.fa", long_reads(2))
    engine_torch.reroutes.update(M_OVFL=0, M_FAIL=0)
    n0 = tile_dp.tile_poa_dp_batch.launches
    got = port([fa])
    assert tile_dp.tile_poa_dp_batch.launches == n0   # CPU: plain only
    assert engine_torch.reroutes == {"M_OVFL": 0, "M_FAIL": 0}
    assert got == jax_cli([fa])


GPU_CASES = [[], ["-m", "1"], ["-S"]]


@pytest.mark.gpu
@pytest.mark.parametrize("flags", GPU_CASES,
                         ids=[" ".join(f) or "default" for f in GPU_CASES])
def test_cli_on_gpu_equals_oracle_on_long_reads(flags, tmp_path,
                                                cuda_device):
    fa = write_fa(tmp_path / "long3.fa", long_reads(3))
    assert (port([*flags, fa], device="cuda")
            == port(["--engine", "numpy", *flags, fa]))


@pytest.mark.gpu
def test_cli_list_on_gpu_equals_oracle_on_long_reads(tmp_path, cuda_device):
    """-l -m 2 over 4 files of 3 long reads: one batch on the round
    path, the band kernel over rows past 4096, no oracle fallback."""
    from abpoa_tpu_torch.cli import main
    from abpoa_tpu_torch.ops import band_dp
    fas = [write_fa(tmp_path / f"l{k}.fa", long_reads(3, first=k))
           for k in range(4)]
    lst = tmp_path / "list.txt"
    lst.write_text("".join(f"{f}\n" for f in fas))
    n0 = band_dp.band_poa_dp_batch.launches
    rc, got, err = run(main, ["-m", "2", "-l", str(lst)])
    assert rc == 0, err
    assert band_dp.band_poa_dp_batch.launches == n0 + 2   # reads 1 and 2
    want = "".join(port(["--engine", "numpy", "-m", "2", f]) for f in fas)
    assert got == want


@pytest.mark.gpu
def test_cli_on_gpu_equals_oracle_on_15kb_reads(tmp_path, cuda_device):
    """Two ~15 kb reads: B5's and B4's per-row arrays past shared
    memory."""
    fa = write_fa(tmp_path / "long15k.fa", long_reads(2, join=21))
    assert port([fa], device="cuda") == port(["--engine", "numpy", fa])


def test_long_reads_are_past_the_former_word():
    reads = long_reads(3)
    assert all(4600 <= len(s) <= 5000 for _, s in reads)
    assert all(len(s) > 14000 for _, s in long_reads(2, join=21))
