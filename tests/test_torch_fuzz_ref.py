"""abpoa_tpu_torch: the CLI's differential fuzzer
(``python -m abpoa_tpu_torch.tools.fuzz_ref``) on the CPU.

(a) gen_case and gen_list_case make the cases of tools/fuzz_ref.py, seed
    for seed (0-299);
(b) the port's CLI on the plain versions (--device cpu) gives the bytes
    and exit code of the JAX package's CLI with --engine numpy on the
    fixed seeds of tests/test_fuzz_ref.py that fit the CPU budget: 3212
    (the arena residue) and 7887 (failure for failure) among them;
(c) the tool exits 0 on two seeds and 1 on a corrupted output, with a
    repro;
(d) each shape class reaches its shape on the port's oracle, serially
    and under -l, and names the kernels the shape should reach (fan: a
    node of 17-29 predecessors under -m 2);
(e) on the card (gpu): the list-mode seeds and every shape class through
    both paths, each launching its kernel.
"""
import contextlib
import io
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import fuzz_ref as jax_fuzz  # noqa: E402  (tools/fuzz_ref.py)

from abpoa_tpu_torch.tools import fuzz_ref  # noqa: E402

torch.set_num_threads(1)

# tests/test_fuzz_ref.py's seeds whose plain-version run fits the CPU
# budget of this file (7, 10, 22, 23, 38 and 90 take 8-15 s or more a
# seed here; the card's campaign runs them)
PARITY_SEEDS = [0, 2, 3, 6, 16, 19, 3212, 7887]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def test_generator_equals_the_jax_tools(tmp_path):
    for seed in range(300):
        assert fuzz_ref.gen_case(seed) == jax_fuzz.gen_case(seed), seed
        a, b = tmp_path / "a", tmp_path / "b"
        a.mkdir(exist_ok=True)
        b.mkdir(exist_ok=True)
        la, args_a, da = fuzz_ref.gen_list_case(seed, a)
        lb, args_b, db = jax_fuzz.gen_list_case(seed, b)
        assert (args_a, da) == (args_b, db), seed
        fa, fb = la.read_text().split(), lb.read_text().split()
        assert [pathlib.Path(f).name for f in fa] == \
            [pathlib.Path(f).name for f in fb], seed
        for x, y in zip(fa, fb):
            assert pathlib.Path(x).read_text() == \
                pathlib.Path(y).read_text(), seed


class JaxSides(fuzz_ref.Sides):
    """The JAX package's CLI (--engine numpy) as the reference side."""

    def reference(self, inp, args):
        from abpoa_tpu import cli
        out = self.work / "jax.out"
        if out.exists():
            out.unlink()
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            try:
                rc = cli.main([*args, "--engine", "numpy", "-o", str(out),
                               str(inp)])
            except Exception as e:  # noqa: BLE001 -- a non-zero exit
                rc = 2
                err.write(f" EXC {e!r}")
        return rc, out.read_bytes() if out.exists() else b"", \
            err.getvalue()[-300:]


@pytest.mark.parametrize("seed", PARITY_SEEDS)
def test_cli_equals_the_jax_cli(seed, tmp_path):
    res = fuzz_ref.run_case(seed, JaxSides("cpu", workdir=tmp_path))
    assert res.ok, (f"seed {seed} ({res.descr}) args={' '.join(res.args)}"
                    f"\nref: {res.ref[:400]!r}\ngot: {res.got[:400]!r}")
    if seed == 7887:
        assert "ref-fatal" in res.descr
    else:
        assert res.got


def test_tool_exits_0_on_two_seeds(capsys):
    assert fuzz_ref.main(["--n", "2", "--start", "0", "--device", "cpu"]) \
        == 0
    out = capsys.readouterr().out
    assert "seed     0 OK" in out and "seed     1 OK" in out
    assert "2 cases from seed 0: 2 ok, 0 failed" in out


def test_tool_exits_1_on_a_corrupted_output(monkeypatch, capsys, tmp_path):
    orig = fuzz_ref.Sides.ours

    def corrupt(self, inp, args):
        rc, body, err, launches = orig(self, inp, args)
        return rc, body[:-2] + b"N\n", err, launches
    monkeypatch.setattr(fuzz_ref.Sides, "ours", corrupt)
    assert fuzz_ref.main(["--n", "2", "--start", "0", "--device", "cpu",
                          "--repro-dir", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "seed     0 FAIL" in out and "1 cases from seed 0" in out
    assert (tmp_path / "0" / "got.out").read_bytes() != \
        (tmp_path / "0" / "ref.out").read_bytes()


def test_tool_without_a_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fuzz_ref.main(["--n", "1", "--device", "cuda"]) == 1
    assert "is_available() is False" in capsys.readouterr().err


# (class, seed, list mode) -> the kernels the case wants; one seed of
# each class serially and under -l, with the shape's own flags (wide
# under -l: -m 2 on the round path's B3 at four positions a thread, else
# the device loop's B1 at four positions a thread; fan under -l: B3 past
# 16 predecessor slots)
SHAPE_CASES = {
    ("wide", 0, False): ("tile_dp",), ("wide", 0, True):
        ("band_dp_topo_wide",),
    ("wide", 1, True): ("band_dp_wide",),
    ("long", 2, False): ("tile_dp",), ("long", 0, True):
        ("band_dp_topo", "fw_dp"),
    ("hub", 1, False): ("fw_dp",), ("hub", 0, True): ("fw_dp",),
    ("svmask", 0, False): ("fw_dp",), ("svmask", 0, True):
        ("band_dp_topo", "fw_dp"),
    ("fan", 0, False): ("tile_dp", "fw_dp"), ("fan", 0, True):
        ("band_dp_topo_fan",),
}


@pytest.mark.parametrize("cls,seed,list_mode", list(SHAPE_CASES),
                         ids=[f"{c}-{s}{'-l' if lm else ''}"
                              for c, s, lm in SHAPE_CASES])
def test_shape_class_reaches_its_shape_on_the_oracle(cls, seed, list_mode,
                                                     tmp_path):
    case = fuzz_ref.gen_shape_case(cls, seed, list_mode)
    assert case.want == SHAPE_CASES[cls, seed, list_mode]
    assert len(case.texts) == (4 if list_mode else 1)
    assert ("-l" in case.args) == list_mode
    sides = fuzz_ref.Sides("cpu", workdir=tmp_path)
    fns = []
    for i, text in enumerate(case.texts):
        fns.append(tmp_path / f"f{i}.fa")
        fns[-1].write_text(text)
    lst = tmp_path / "in.list"
    lst.write_text("\n".join(map(str, fns)) + "\n")
    facts = fuzz_ref.Facts()
    with fuzz_ref._recording(facts):
        if list_mode:
            rc, out, _err = sides.reference_per_file(lst, case.args)
        else:
            rc, out, _err = sides.reference(fns[0], case.args)
    assert rc == 0 and out
    assert fuzz_ref.shape_reached(cls, facts), facts.summary()
    # the recording is gone again: the oracle's own context class
    from abpoa_tpu_torch.align import engine_np
    assert engine_np._Ctx.__name__ == "_Ctx"


def test_shape_facts_of_a_plain_case_reach_no_shape(tmp_path):
    """A short gen_case input reaches none of the classes' shapes: the
    check is not vacuous."""
    text, _fq, args, _d, _i = fuzz_ref.gen_case(2)
    inp = tmp_path / "in.fa"
    inp.write_text(text)
    facts = fuzz_ref.Facts()
    with fuzz_ref._recording(facts):
        rc, _out, _err = fuzz_ref.Sides("cpu", workdir=tmp_path).reference(
            inp, args)
    assert rc == 0 and facts.nodes > 0
    assert not any(fuzz_ref.shape_reached(c, facts) for c in fuzz_ref.SHAPES)


@pytest.mark.gpu
def test_list_mode_seeds_on_gpu(cuda_device, tmp_path):
    sides = fuzz_ref.Sides("cuda", workdir=tmp_path)
    for seed in range(4):
        res = fuzz_ref.run_case(seed, sides, list_mode=True)
        assert res.ok, (seed, res.descr)
        assert res.launches, (seed, "no kernel launched")


@pytest.mark.gpu
@pytest.mark.parametrize("cls", fuzz_ref.SHAPES)
def test_shape_class_on_gpu(cls, cuda_device, tmp_path):
    sides = fuzz_ref.Sides("cuda", workdir=tmp_path)
    for list_mode in (False, True):
        res = fuzz_ref.run_shape_case(cls, 0, sides, list_mode)
        assert res.ok and res.reached, (cls, list_mode, res.descr)


# the card's campaign: local-mode seeds whose B4 walk ended one move past
# its zero cell (the plain version too), serially and on the round path
LOCAL_WALK_SEEDS = [222, 313, 341, 425]


@pytest.mark.parametrize("seed", LOCAL_WALK_SEEDS)
def test_local_walk_ends_on_its_zero_cell(seed, tmp_path):
    res = fuzz_ref.run_case(seed, JaxSides("cpu", workdir=tmp_path))
    assert res.ok and "-m 1" in " ".join(res.args), res.descr
    # the same input four times under -l: the round path's B4
    text, _fq, args, _d, _i = fuzz_ref.gen_case(seed)
    fns = []
    for i in range(4):
        fns.append(tmp_path / f"l{i}.fa")
        fns[-1].write_text(text)
    lst = tmp_path / "in.list"
    lst.write_text("\n".join(map(str, fns)) + "\n")
    sides = fuzz_ref.Sides("cpu", workdir=tmp_path)
    ref_rc, ref, _e = sides.reference_per_file(lst, ["-l", *args])
    rc, got, _e, _l = sides.ours(lst, ["-l", *args])
    assert ref_rc == rc == 0 and got == ref
