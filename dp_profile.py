#!/usr/bin/env python3
"""Where a DP kernel's time goes, phase by phase, on one GPU.

    python dp_profile.py            # B4 (fw_dp), B1 and B3 (band_dp),
                                    # B5 (tile_dp), B2 (graph_update),
                                    # B6 (topo)
    python dp_profile.py graph      # B2 and B6 only

Builds ``abpoa_tpu_torch/csrc/fw_dp.cu`` and ``band_dp.cu`` with
``-DDP_PROFILE`` (into ``build/abpoa_tpu_torch/profile/``), which turns
on the kernels' DP_PROBE marks at the row body's phase boundaries
(``layout.cuh``; a normal build compiles them to nothing), runs each at
the shape of PERF.md's table (B4: local mode, round 4 of 8 rotated
heter.fa instances, and the largest of the serial engine's -S windows
at B=1; B1: the device loop's last round at B=8; B3: extend mode with
z-drop 100, round 4 of 8 rotated instances; B5: the serial engine's last
read of heter.fa at B=1), and prints, for block 0's
thread 0, the SM cycles a swept row spends in each phase and the cycles
of one walk step. B2 and B6 (``graph_update.cu``, ``topo.cu``) print
block 0's SM cycles in each phase of the whole launch: B2 in both
weight modes on the device loop's last round (wmode 0: 8 rotated
heter.fa instances, R=1024; wmode 1: 64 x heter.fa with the qv weights
of ``chip_smoke.qv_weights``), B6 on the graph that round fuses (B=8). The probes cost a few percent of the time; the
kernel's own times come from chip_smoke.py (phase 3f).
"""
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent

# the phases DP_PROBE(0)..DP_PROBE(6) close, then the walk (7)
PHASES = ["scalars", "loads+merge", "scan", "across warps+finish",
          "backtrack bits", "row max", "final"]
PHASES_B5 = ["scalars", "merge", "scan", "finish", "backtrack bits",
             "row max", "final"]
PHASES_B2 = ["copy-in", "fusion", "remain", "runs", "Kahn", "copy-out"]
PHASES_B6 = ["stage", "sort"]


def build(name):
    """csrc/<name>.cu built with its probes on, loaded with the
    committed library's C interface plus dp_profile_read."""
    from abpoa_tpu_torch.ops import _build
    out = _build.BUILD_DIR / "profile"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / f"lib{name}_profile.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DDP_PROFILE",
                    "-o", str(lib_path), str(_build.CSRC / f"{name}.cu")],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn_name, argtypes in _build.SOURCES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dp_profile_read.argtypes = [ctypes.c_void_p]
    return lib


def probed(name, call):
    """Run `call` once on the probed library of `name`; returns the 16
    counters of g_prof."""
    import torch
    from abpoa_tpu_torch.ops import _build
    lib = build(name)
    saved = _build._libs.get(name)
    _build._libs[name] = lib
    try:
        call()
        torch.cuda.synchronize()
    finally:
        if saved is not None:
            _build._libs[name] = saved
        else:
            _build._libs.pop(name)
    buf = (ctypes.c_longlong * 16)()
    lib.dp_profile_read(ctypes.addressof(buf))
    return list(buf)


def profile(name, label, call, phases=PHASES):
    """Run `call` once on the probed library of `name` and print block
    0's cycles per row by phase and per walk step."""
    buf = probed(name, call)
    rows, steps = max(buf[8] - 1, 1), max(buf[9], 1)
    per = {p: round(buf[k] / rows, 1) for k, p in enumerate(phases)}
    print(f"{label}: {rows} rows, SM cycles a row {per} (sum "
          f"{round(sum(per.values()), 1)}); walk {steps} steps, "
          f"{round(buf[7] / steps, 1)} cycles a step", flush=True)


def profile_launch(name, label, call, phases, count):
    """Run `call` once on the probed library of `name` and print block
    0's SM cycles in each phase of the launch (count: what g_prof[8]
    holds, e.g. node_n)."""
    buf = probed(name, call)
    per = {p: buf[k] for k, p in enumerate(phases)}
    print(f"{label}: {count} {buf[8]}, SM cycles of block 0 {per} (sum "
          f"{sum(per.values())})", flush=True)


def profile_graph(cs, dev, heter):
    """B2 in both weight modes and B6 at PERF.md's table shapes."""
    from abpoa_tpu_torch.ops import poa_loop as pl
    from abpoa_tpu_torch.ops import graph_update as gu
    from abpoa_tpu_torch.ops import topo as tt
    rot = [heter[b:] + heter[:b] for b in range(cs.N_CMP)]
    qv = [heter] * cs.N_INST
    for insts, ws, label in ((rot, None, "B2 wmode 0 B=8 round 14"),
                             (qv, cs.qv_weights(qv),
                              "B2 wmode 1 B=64 round 14")):
        cfg, ps, args, qw = cs.graph_round_args(dev, insts, ws)
        c = pl.PackedState(*(x.clone() for x in ps))
        profile_launch("graph_update", f"{label} (R={cfg.R})",
                       lambda: gu.graph_update_packed(cfg, c, *args, qw=qw),
                       PHASES_B2, "node_n")
        if ws is None:
            st = cs.fused_state(cfg, ps, args, qw)
            profile_launch("topo", f"B6 B=8 the same round's graph "
                           f"(R={cfg.R})", lambda: tt.topo_batch(cfg, st),
                           PHASES_B6, "sorted")


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from abpoa_tpu_torch.params import Params, LOCAL_MODE, EXTEND_MODE
    from abpoa_tpu_torch.parallel.batch import round_plan
    from abpoa_tpu_torch.ops import band_dp as bd
    dev = torch.device("cuda")
    heter = cs.reads_of(cs.HETER)
    rot = [heter[b:] + heter[:b] for b in range(cs.N_CMP)]
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip(), flush=True)
    profile_graph(cs, dev, heter)
    if "graph" in argv:
        return 0
    for name, mode, label in (("fw_dp", LOCAL_MODE, "B4 B=8 local"),
                              ("band_dp", EXTEND_MODE,
                               "B3 B=8 extend z-drop 100")):
        p = Params()
        p.align_mode = mode
        p.zdrop = 100 if mode == EXTEND_MODE else p.zdrop
        p.post_set()
        plan = round_plan(p, cs.round_exports(p, rot, 4), dev)
        args = plan.stack(slice(None), dev)
        profile(name, label, lambda: plan.kernel(plan.cfg, *args))
    win = cs.serial_windows()
    cfg, args = max(win, key=lambda w: w[0].R)
    from abpoa_tpu_torch.ops import fw_dp as fw
    profile("fw_dp", f"B4 B=1 the largest -S window (R={cfg.R})",
            lambda: fw.fw_poa_dp_batch(cfg, *args))
    bc, bargs = cs.loop_round_args(dev, rot)
    profile("band_dp", "B1 B=8 the device loop's last round",
            lambda: bd.band_poa_dp_packed(bc, *bargs))
    from abpoa_tpu_torch.ops import tile_dp as td
    tc, tarrs, _ = cs.tile_inputs(Params().post_set(), [heter],
                                  len(heter) - 1)
    targs = [torch.from_numpy(a).to(dev) for a in tarrs]
    profile("tile_dp", f"B5 B=1 heter.fa round 14 (R={tc.R}, WB={tc.WB})",
            lambda: td.tile_poa_dp_batch(tc, *targs), PHASES_B5)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
