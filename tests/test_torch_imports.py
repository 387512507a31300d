"""abpoa_tpu_torch stands alone: no module of the port, and not
chip_smoke.py, imports the JAX package (abpoa_tpu), JAX, the root
bench.py (which drives the JAX package) or the root tools/
(tools/fuzz_ref.py, whose generator the port's fuzzer copies).

* An AST scan of every abpoa_tpu_torch/**/*.py and chip_smoke.py finds
  no such import statement and no importlib/__import__ call naming one.
* The layers point down: no module under ops/ or align/ imports the
  batch paths (parallel/), the aligner API (api.py) or the CLI.
* A fresh interpreter that imports abpoa_tpu_torch and runs BatchPOA on
  the CPU, through the device loop, the round path, the qv device loop
  and the seeded window rounds (the port's seed.py), then the CLI (the
  serial device engine, plain B5; -S on its window engine) and pyabpoa,
  ends with neither name in sys.modules.
"""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"abpoa_tpu", "jax", "jaxlib", "bench", "tools", "fuzz_ref"}
SOURCES = sorted((ROOT / "abpoa_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _bad_imports(path):
    """(line, module) of every import of a forbidden package in `path`."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _forbidden(alias.name):
                    yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                yield node.lineno, node.module
        elif isinstance(node, ast.Call):
            f = node.func
            fname = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            if fname in ("import_module", "__import__") and node.args:
                a = node.args[0]
                if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                        and _forbidden(a.value):
                    yield node.lineno, a.value


NEW_IN_SLICES = ["cli.py", "plot.py", "pyabpoa.py", "align/engine_torch.py",
                 "ops/tile_dp.py", "ops/topo.py", "seed.py",
                 "ops/roofline.py", "examples/example.py",
                 "examples/sub_example.py", "examples/batch_example.py",
                 "workload.py", "tools/fuzz_ref.py"]


def test_no_import_of_the_jax_package_or_jax():
    assert len(SOURCES) > 20
    for rel in NEW_IN_SLICES:
        assert ROOT / "abpoa_tpu_torch" / rel in SOURCES, rel
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}"
           for p in SOURCES for line, mod in _bad_imports(p)]
    assert not bad, "\n".join(bad)


def test_scan_finds_a_forbidden_import(tmp_path):
    """The scan itself: each forbidden form is caught, the port's own
    package name is not."""
    src = tmp_path / "m.py"
    src.write_text("import abpoa_tpu_torch.ops\n"
                   "from abpoa_tpu_torch import BatchPOA\n"
                   "from .params import Params\n"
                   "from abpoa_tpu_torch import bench\n"
                   "import jax.numpy as jnp\n"
                   "import bench\n"
                   "from abpoa_tpu_torch.tools import fuzz_ref\n"
                   "from tools.fuzz_ref import gen_case\n"
                   "import fuzz_ref\n"
                   "def f():\n"
                   "    from abpoa_tpu.graph import POAGraph\n"
                   "    importlib.import_module('jaxlib')\n")
    assert sorted(m for _line, m in _bad_imports(src)) == \
        ["abpoa_tpu.graph", "bench", "fuzz_ref", "jax.numpy", "jaxlib",
         "tools.fuzz_ref"]


UPPER = {"parallel", "api", "cli"}


def _upward(src: str, rel: str):
    """(line, module) of every import in `src`, the text of the port's
    module at `rel` (a path under the repository), of a module in
    UPPER. Relative imports resolve against the module's package, and
    ``from X import y`` also names X.y (y may be a submodule)."""
    pkg = rel.split("/")[:-1]
    for node in ast.walk(ast.parse(src, rel)):
        if isinstance(node, ast.Import):
            mods = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            mods = [mod] + [f"{mod}.{alias.name}" for alias in node.names]
        else:
            continue
        for mod in mods:
            parts = mod.split(".")
            if parts[0] == "abpoa_tpu_torch" and len(parts) > 1 \
                    and parts[1] in UPPER:
                yield node.lineno, mod


def test_ops_and_align_import_no_higher_layer():
    """The kernels' wrappers (ops/) and the engines (align/) sit below
    the batch paths (parallel/), the aligner API and the CLI: a policy
    both levels share, such as the DP planes' memory budget, lives below
    both (device.py)."""
    lower = sorted((ROOT / "abpoa_tpu_torch" / "ops").rglob("*.py")) \
        + sorted((ROOT / "abpoa_tpu_torch" / "align").rglob("*.py"))
    assert ROOT / "abpoa_tpu_torch" / "align" / "engine_torch.py" in lower
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}" for p in lower
           for line, mod in _upward(p.read_text(),
                                    p.relative_to(ROOT).as_posix())]
    assert not bad, "\n".join(bad)
    # the scan itself: each form of an upward import is caught, imports
    # of the same level or below are not
    probe = ("from ..parallel.batch import BatchPOA\n"
             "from .. import api\n"
             "import abpoa_tpu_torch.cli\n"
             "from ..device import plane_budget\n"
             "from .export import pick_WB\n"
             "from ..ops import band_dp\n")
    got = sorted(_upward(probe, "abpoa_tpu_torch/align/probe.py"))
    assert got == [(1, "abpoa_tpu_torch.parallel.batch"),
                   (1, "abpoa_tpu_torch.parallel.batch.BatchPOA"),
                   (2, "abpoa_tpu_torch.api"),
                   (3, "abpoa_tpu_torch.cli")]


RUN = """
import sys
import numpy as np
from abpoa_tpu_torch import BatchPOA
from abpoa_tpu_torch.alphabet import encode_table
from abpoa_tpu_torch.params import Params, LOCAL_MODE
from abpoa_tpu_torch.seqio import read_seqs
tab = encode_table(5)
reads = [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
         for r in read_seqs(sys.argv[1])][:4]
loop = BatchPOA(Params().post_set(), device="cpu")
loop.run([reads, reads[1:]])
p = Params()
p.align_mode = LOCAL_MODE
rounds = BatchPOA(p.post_set(), device="cpu")
rounds.run([reads, reads[1:]])
assert loop.used_device_loop and not rounds.used_device_loop
qv = BatchPOA(Params().post_set(), device="cpu")
qv.run([reads[:3]], weights=[[[7] * len(q) for q in reads[:3]]])
assert qv.used_device_loop
p = Params()
p.disable_seeding = False
seeded = BatchPOA(p.post_set(), device="cpu")
seeded.run_seeded([reads[:3], reads[1:3]])
assert seeded.windows > 0
import contextlib, io
import abpoa_tpu_torch.pyabpoa as pa
from abpoa_tpu_torch.cli import main
from abpoa_tpu_torch.ops import tile_dp, topo
with contextlib.redirect_stdout(io.StringIO()) as out:
    assert main(["--device", "cpu", sys.argv[1]]) == 0
assert out.getvalue().startswith(">Consensus_sequence")
with contextlib.redirect_stdout(io.StringIO()) as out:
    assert main(["--device", "cpu", "-S", sys.argv[1]]) == 0
assert out.getvalue().startswith(">Consensus_sequence")
res = pa.msa_aligner(device="cpu").msa([r.seq for r in read_seqs(
    sys.argv[1])][:3], out_cons=True, out_msa=False)
assert res.n_cons == 1
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("abpoa_tpu", "jax", "jaxlib")))
"""


def test_running_the_port_loads_neither_package():
    out = subprocess.run(
        [sys.executable, "-c", RUN, str(ROOT / "tests" / "data" / "seq.fa")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
