"""abpoa_tpu_torch: layout constants and package boundaries.

The port keeps its own copies of the kernels' layout constants (the JAX
modules that define them import JAX); these tests pin them equal to the
JAX package's, check that importing the port leaves JAX unloaded, and
that devices are explicit.
"""
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

NAMES = ["S_QLEN", "S_NROWS", "S_W", "S_INF", "S_REMEND", "S_E1", "S_O1",
         "S_OE1", "S_E2", "S_O2", "S_OE2", "S_ZDROP", "S_DPSN", "S_NSCAL",
         "M_BEST", "M_BI", "M_BJ", "M_CELLS", "M_OVFL", "M_NSTEPS",
         "M_FAIL", "M_ENDI", "M_ENDJ", "M_LASTI", "M_NMISC",
         "BT_M", "BT_E1", "BT_E2", "BT_F1", "BT_F2", "BT_E", "BT_F",
         "BT_ALL", "NEG"]


@pytest.mark.parametrize("name", NAMES)
def test_layout_constant_equals_jax(name):
    from abpoa_tpu.ops import dp_pallas as dpp
    from abpoa_tpu_torch.ops import layout
    assert getattr(layout, name) == getattr(dpp, name)


def test_band_constants_equal_jax():
    from abpoa_tpu.ops import dp_pallas_band as dpb
    from abpoa_tpu_torch.ops import layout
    assert layout.INVALID_BITS == dpb.INVALID_BITS
    assert layout.NEG == dpb.NEG
    assert layout.H16 == dpb.H16


def test_cuda_header_matches_layout():
    """csrc/layout.cuh repeats the constants for the kernels."""
    import re
    from abpoa_tpu_torch.ops import layout
    from abpoa_tpu.params import (LINEAR_GAP, AFFINE_GAP, CONVEX_GAP,
                                  SRC_NODE_ID, SINK_NODE_ID)
    text = (REPO / "abpoa_tpu_torch" / "csrc" / "layout.cuh").read_text()
    found = dict(re.findall(r"\b([A-Z][A-Z0-9_]+) = (0x[0-9A-Fa-f]+|\d+)",
                            text))
    expect = {n: getattr(layout, n) for n in NAMES if n != "NEG"}
    expect.update(LINEAR_GAP=LINEAR_GAP, AFFINE_GAP=AFFINE_GAP,
                  CONVEX_GAP=CONVEX_GAP, SRC_NODE_ID=SRC_NODE_ID,
                  SINK_NODE_ID=SINK_NODE_ID)
    for n, v in expect.items():
        assert int(found[n], 0) == v, n


def test_import_leaves_jax_out():
    """A fresh interpreter: importing the port (and its kernels' Python
    side) must not load JAX or the JAX package's device modules."""
    code = ("import sys; import abpoa_tpu_torch; "
            "import abpoa_tpu_torch.ops.band_dp, "
            "abpoa_tpu_torch.ops.graph_update, abpoa_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('abpoa_tpu.ops') "
            "or m.startswith('abpoa_tpu.parallel')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_never_import_jax():
    import re
    pat = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    files = list((REPO / "abpoa_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        assert not pat.search(f.read_text()), f


def test_device_is_explicit():
    """The card by default, the CPU only when asked for, and no silent
    fallback from one to the other."""
    from abpoa_tpu_torch import resolve_device, BatchPOA
    from abpoa_tpu_torch.params import Params
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device(None)
    assert BatchPOA(Params().post_set(), device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            BatchPOA(Params().post_set(), device="cuda")
        with pytest.raises(RuntimeError):
            BatchPOA(Params().post_set())     # the default is the card
    else:
        assert BatchPOA(Params().post_set()).device.type == "cuda"


def test_wrapper_rejects_other_devices():
    """The plain version runs only for CPU tensors: a tensor on another
    device (here "meta"; a CUDA tensor cannot exist on this host) makes
    the wrapper raise instead of running it."""
    from abpoa_tpu_torch.ops import band_dp
    cfg = band_dp.BandConfig(gap_mode=2, pn=32, R=128, WB=128, Wq=128,
                             P=8, m=5, bt_lmax=256)
    z = torch.zeros
    i32 = torch.int32
    args = (z(1, 13, dtype=i32, device="meta"),
            z(1, 128, dtype=i32, device="meta"),
            z(1, 512, dtype=i32, device="meta"),
            z(1, 128, dtype=i32, device="meta"),
            z(1, 10, 128, dtype=i32, device="meta"))
    with pytest.raises(ValueError):
        band_dp.band_poa_dp_packed(cfg, *args)

    from abpoa_tpu_torch.ops import graph_update, poa_loop
    lc = poa_loop.LoopConfig(R=128, E=12, P=8, A=4, Wq=128, WB=128, LS=256,
                             NR=1, B=1, pn=32, inf_min=-32681, gap_mode=2)
    ps = poa_loop.PackedState(*(z(*s, dtype=i32, device="meta") for s in
                                ((1, 128), (1, 768), (1, 512), (1, 256),
                                 (1, 128), (1,), (1,))))
    with pytest.raises(ValueError):
        graph_update.graph_update_packed(
            lc, ps, z(1, 128, dtype=i32, device="meta"),
            z(1, 10, dtype=i32, device="meta"),
            z(1, dtype=i32, device="meta"), z(1, 32, dtype=i32, device="meta"))
