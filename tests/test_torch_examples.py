"""abpoa_tpu_torch/examples: the repository's examples through the port,
with --device cpu (the plain versions of the kernels).

* example.py and sub_example.py print the bytes the JAX package's
  examples print (those run on its host oracle, with no jit).
* batch_example.py's three runs (one device, a device list, seeded over
  the device list) equal the JAX package's host engine (no jit)
  instance by instance.
* Without --device cpu on a host with no card, an example raises: no
  silent run on the CPU.
"""
import contextlib
import importlib.util
import io
import pathlib

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def _jax_example_output(name):
    """What examples/<name>.py prints (its main(), loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


@pytest.mark.parametrize("name", ["example", "sub_example"])
def test_example_prints_what_the_jax_example_prints(name):
    import importlib
    mod = importlib.import_module(f"abpoa_tpu_torch.examples.{name}")
    out = io.StringIO()
    mod.main(["--device", "cpu"], out=out)
    want = _jax_example_output(name)
    assert ">Consensus_sequence" in want
    assert out.getvalue() == want


def _jax_oracle(instances, seeded):
    """The JAX package's consensus per instance on its host engine (no
    jit), seeded (-S) or not."""
    from abpoa_tpu.alphabet import decode_table
    from abpoa_tpu.api import ABPOA
    from abpoa_tpu.consensus import generate_consensus
    from abpoa_tpu.params import Params
    p = Params()
    p.engine = "numpy"
    p.disable_seeding = not seeded
    p = p.post_set()
    dt = decode_table(5)
    out = []
    for reads in instances:
        ab = ABPOA()
        ab.msa(p, [bytes(dt[b] for b in q).decode() for q in reads])
        generate_consensus(ab, p)
        out.append([bytes(dt[b] for b in s).decode()
                    for s in ab.cons.cons_base[:ab.cons.n_cons]])
    return out


def test_batch_example_equals_the_serial_oracle():
    from abpoa_tpu_torch.examples import batch_example
    reads = batch_example.seq_fa_reads()
    kinds = [reads, reads[:8], reads[:6]]
    text = io.StringIO()
    cons, cons_m, cons_s = batch_example.run("cpu", ["cpu", "cpu"],
                                             out=text)
    assert cons == cons_m == _jax_oracle(kinds, seeded=False) * 4
    assert cons_s == _jax_oracle(kinds, seeded=True) * 4
    lines = text.getvalue().splitlines()
    assert lines[0].startswith("batched: 12 consensus sequences")
    assert lines[1].startswith("devices(2): identical consensus")


def test_examples_default_to_the_card(monkeypatch):
    from abpoa_tpu_torch.examples import example
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        example.main([], out=io.StringIO())
