"""abpoa_tpu_torch: the port's CLI (cli.py) with ``--device cpu`` (the
serial device engine on the kernels' plain versions) gives the sanitized
golden bytes, and the same bytes as the JAX package's CLI for the same
arguments: the default consensus, -r2, -r3, -m 1, -m 2, -b -1, -c on
prot.fa, -Q on seq.fq, -s, -g (the .dot file), --engine numpy, and -l
with 2 files (serial) and 4 files (batched through BatchPOA); on a GPU
also the list golden over heter.fa and seq.fa. -S on seq.fa (the
window path of the serial engine) equals the JAX package's CLI; without
a GPU the default device exits 1 with the device error. pyabpoa's msa and msa_batch give the golden consensus.
Exact byte equality.
"""
import contextlib
import io
import pathlib

import pytest
import torch

TESTS = pathlib.Path(__file__).resolve().parent
DATA = TESTS / "data"
GOLDEN_SAN = TESTS / "golden_sanitized"
SEQ = str(DATA / "seq.fa")

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def run(main, args):
    """(rc, stdout, stderr) of a CLI main in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(args))
    return rc, out.getvalue(), err.getvalue()


def port(args, device="cpu"):
    from abpoa_tpu_torch.cli import main
    rc, out, err = run(main, ["--device", device, *args])
    assert rc == 0, err
    return out


def jax_cli(args):
    from abpoa_tpu.cli import main
    rc, out, err = run(main, args)
    assert rc == 0, err
    return out


CASES = [
    ("seq_cons.fa", [SEQ]),
    ("seq_cons_msa.out", ["-r2", SEQ]),
    ("seq.gfa", ["-r3", SEQ]),
    ("seq_cons_local.fa", ["-m", "1", SEQ]),
    ("seq_cons_ext.fa", ["-m", "2", SEQ]),
    ("seq_cons_noband.fa", ["-b", "-1", SEQ]),
    ("prot_cons.fa", ["-c", str(DATA / "prot.fa")]),
    ("seq_fq_Q_cons.fa", ["-Q", str(DATA / "seq.fq")]),
    ("seq_cons_ambs.fa", ["-s", SEQ]),
    ("seq_cons.fa", ["--engine", "numpy", SEQ]),
]


@pytest.mark.parametrize("golden,args", CASES,
                         ids=[" ".join(a[:-1]) or "default" for _, a in CASES])
def test_cli_golden_and_jax_bytes(golden, args, monkeypatch):
    from abpoa_tpu_torch.align import engine_torch
    calls = []
    dev_align = engine_torch.align_sequence_to_graph_device
    monkeypatch.setattr(engine_torch, "align_sequence_to_graph_device",
                        lambda *a: calls.append(1) or dev_align(*a))
    got = port(args)
    assert got == (GOLDEN_SAN / golden).read_text()
    assert got == jax_cli(args)
    device_engine = "--engine" not in args
    assert (len(calls) > 0) == device_engine


def test_cli_pog_dot(tmp_path):
    """-g x.png writes the reference's .dot bytes (the png needs
    graphviz, which is optional)."""
    png = tmp_path / "x.png"
    port([SEQ, "-g", str(png)])
    assert (tmp_path / "x.png.dot").read_text() \
        == (GOLDEN_SAN / "seq_pog.dot").read_text()


def _list(tmp_path, fns):
    lst = tmp_path / "list.txt"
    lst.write_text("".join(f"{f}\n" for f in fns))
    return str(lst)


@pytest.mark.parametrize("n", [2, 4], ids=["serial", "batched"])
def test_cli_list_mode(n, tmp_path):
    """-l with 2 files runs them serially through the device engine; with
    4 the files batch through BatchPOA (the device loop, plain versions
    on the CPU)."""
    lst = _list(tmp_path, [DATA / "seq.fa"] * n)
    got = port(["-l", lst])
    assert got == (GOLDEN_SAN / "seq_cons.fa").read_text() * n
    assert got == jax_cli(["-l", lst])


@pytest.mark.gpu
def test_cli_list_mode_golden_on_gpu(tmp_path, cuda_device):
    """The list golden of tests/test_modes.py (heter.fa + seq.fa, serial):
    heter.fa through the plain B5 takes a minute on a CPU, so it runs on
    the card."""
    lst = _list(tmp_path, [DATA / "heter.fa", DATA / "seq.fa"])
    assert port(["-l", lst], "cuda") \
        == (GOLDEN_SAN / "list_cons.fa").read_text()


def test_cli_seeded_exits_naming_its_item(monkeypatch):
    """-S, once refused, now runs: every window of seq.fa through the
    serial engine's full-width kernel (plain version) gives the JAX
    package's CLI bytes, with no window on the oracle but the empty
    ones."""
    from abpoa_tpu_torch import align
    from abpoa_tpu_torch.align import engine_torch
    oracle = []
    np_sub = align._np_subgraph
    monkeypatch.setattr(align, "_np_subgraph",
                        lambda *a, **k: oracle.append(1) or np_sub(*a, **k))
    monkeypatch.setattr(engine_torch, "empty_windows", 0)
    assert port(["-S", SEQ]) == jax_cli(["-S", SEQ])
    assert len(oracle) == engine_torch.empty_windows


@pytest.mark.parametrize("name,engine", [("jax", "torch"), ("torch", "torch"),
                                         ("numpy", "numpy"), ("auto", "auto")])
def test_engine_names(name, engine):
    """Params.post_set is the one place that reads engine names: "jax"
    is the device engine, so the JAX package's command lines run."""
    from abpoa_tpu_torch.params import Params
    assert Params(engine=name).post_set().engine == engine


def test_cli_unknown_engine_exits():
    from abpoa_tpu_torch.cli import main
    rc, out, err = run(main, ["--device", "cpu", "--engine", "tpu", SEQ])
    assert rc == 1 and out == ""
    assert "unknown engine: tpu" in err


def test_cli_default_device_without_gpu_exits():
    """No hidden fallback: the default engine on a host without CUDA
    exits 1 with the device error, before any read aligns."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    from abpoa_tpu_torch.cli import main
    rc, out, err = run(main, [SEQ])
    assert rc == 1 and out == ""
    assert "torch.cuda.is_available() is False" in err


def test_api_runs_on_the_card_unless_asked():
    """The library entry points run the serial device engine on the card
    by default: without a GPU, ABPOA.msa and msa_from_file raise the
    device error before any read aligns; engine="numpy" asks for the
    host oracle and gives the golden."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    import dataclasses
    from abpoa_tpu_torch.api import ABPOA
    from abpoa_tpu_torch.params import Params
    p = Params().post_set()
    assert (p.engine, p.device) == ("torch", "cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        ABPOA().msa(p, _seqs("seq.fa"), out=io.StringIO())
    with pytest.raises(RuntimeError, match="is_available"):
        ABPOA().msa_from_file(p, SEQ, io.StringIO())
    out = io.StringIO()
    ABPOA().msa_from_file(dataclasses.replace(p, engine="numpy"), SEQ, out)
    assert out.getvalue() == (GOLDEN_SAN / "seq_cons.fa").read_text()


def test_cli_module_entry():
    """python -m abpoa_tpu_torch.cli runs the same main."""
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "-m", "abpoa_tpu_torch.cli", "--device", "cpu",
         "--engine", "numpy", SEQ], cwd=TESTS.parent, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == (GOLDEN_SAN / "seq_cons.fa").read_text()


def _golden_cons(fn):
    return (GOLDEN_SAN / fn).read_text().split("\n")[1]


def _seqs(fn):
    from abpoa_tpu_torch.seqio import read_seqs
    return [r.seq for r in read_seqs(str(DATA / fn))]


def test_pyabpoa_msa_and_msa_batch():
    import abpoa_tpu_torch.pyabpoa as pa
    a = pa.msa_aligner(device="cpu")
    res = a.msa(_seqs("seq.fa"), out_cons=True, out_msa=False)
    assert res.cons_seq == [_golden_cons("seq_cons.fa")]
    outs = a.msa_batch([_seqs("seq.fa"), _seqs("seq.fa")[::-1]],
                       out_cons=True, out_msa=False)
    assert outs[0].cons_seq == [_golden_cons("seq_cons.fa")]
    single = pa.msa_aligner(device="cpu").msa(_seqs("seq.fa")[::-1],
                                              out_cons=True, out_msa=False)
    assert outs[1].cons_seq == single.cons_seq


@pytest.mark.gpu
@pytest.mark.parametrize("golden,args", CASES[:6],
                         ids=[" ".join(a[:-1]) or "default"
                              for _, a in CASES[:6]])
def test_cli_golden_on_gpu(golden, args, cuda_device):
    assert port(args, "cuda") == (GOLDEN_SAN / golden).read_text()
