"""The serial device engine: one read against the whole graph on the
device, per align call.

Counterpart of the device wrappers of ``abpoa_tpu/align/engine_jax.py``
(``align_sequence_to_graph_device``, :509-548). Per call:

* banded (``wb >= 0``) global or extend alignments run kernel B5, the
  banded-tile DP with the in-kernel walk (``ops/tile_dp.py``), on the
  inputs of ``export_dense`` + ``pick_WB`` + ``make_pallas_inputs``; the
  host replays the step words into the cigar (``ops/steps.py``) and
  writes the band state back into the graph, so a second call on the
  same graph without a re-sort (the ``-s`` reverse-complement retry)
  starts from it, as the reference's does;
* local mode, unbanded (``-b -1``), and a B5 result with a band
  overflow (``M_OVFL``) or a walk dead end (``M_FAIL``) run kernel B4,
  the full-width DP (``ops/fw_dp.py``), on the whole graph, on the same
  device. The JAX package runs its XLA tier there (``dp_xla``, ROADMAP
  A6); B4 computes the same function (the engine chain engine_np ==
  dp_xla == dp_pallas == dp_pallas_fw) with no overflow path, so it
  gives the same bytes;
* a walk dead end of B4 is the reference's own backtrack failure, which
  it treats as fatal: ``RuntimeError``;
* a graph past 4096 nodes or a query of 2^17 bases or more (the packed
  step word's row and column bits) raises ``NotImplementedError``: the
  XLA tier, ROADMAP A6.

Subgraph windows (only ``-S`` reaches them, ROADMAP A7) stay on the
oracle (``align/__init__.py``). The kernels' wrappers count their
launches; ``reroutes`` counts the B5 results re-run on B4, by flag.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..params import GLOBAL_MODE, EXTEND_MODE
from ..ops import layout as L
from .engine_np import AlignResult

reroutes = {"M_OVFL": 0, "M_FAIL": 0}


def _run(kernel, cfg, arrs, dev):
    """One B=1 launch; returns (out, misc row as numpy)."""
    out = kernel(cfg, *(torch.from_numpy(np.ascontiguousarray(a))[None]
                        .to(dev) for a in arrs))
    return out, out.misc[0].cpu().numpy()


def align_sequence_to_graph_device(graph, params, query,
                                   device) -> AlignResult:
    """Whole-graph alignment of `query` on `device` ("cuda": the kernels,
    "cpu": their plain versions); see the module doc for the routing."""
    from .export import export_dense, make_pallas_inputs, pick_WB
    from ..ops.fw_dp import FWConfig, fw_poa_dp_batch
    from ..ops.steps import replay_steps
    from ..ops.tile_dp import tile_poa_dp_batch
    dev = resolve_device(device)
    if graph.node_n > 4096 or len(query) >= (1 << 17):
        raise NotImplementedError(
            f"a graph of {graph.node_n} nodes or a query of {len(query)} "
            "bases needs the XLA tier of the JAX package, not ported yet: "
            "ROADMAP A6")
    dg = export_dense(graph, params, query)
    Wq = (dg.qlen // 128 + 1) * 128
    lmax = (dg.R + Wq + 511) // 512 * 512 if params.ret_cigar else 0
    banded = params.wb >= 0
    out = None
    if banded and params.align_mode in (GLOBAL_MODE, EXTEND_MODE):
        WB = pick_WB(params, dg.qlen, dg.pn)
        cfg, arrs = make_pallas_inputs(dg, params, WB, bt_lmax=lmax)
        out, misc = _run(tile_poa_dp_batch, cfg, arrs[:10], dev)
        flag = ("M_OVFL" if misc[L.M_OVFL] else
                "M_FAIL" if params.ret_cigar and misc[L.M_FAIL] else None)
        if flag:
            reroutes[flag] += 1
            out = None
    if out is None:
        cfg, arrs = make_pallas_inputs(dg, params, 128, force_Wq=Wq,
                                       bt_lmax=lmax)
        fwc = FWConfig(cfg.gap_mode, cfg.align_mode, cfg.pn, cfg.R, Wq,
                       cfg.P, cfg.O, cfg.m, cfg.use_zdrop, lmax,
                       banded=banded)
        out, misc = _run(fw_poa_dp_batch, fwc, arrs, dev)
        if params.ret_cigar and misc[L.M_FAIL]:
            raise RuntimeError("Error in backtrack: the full-width walk "
                               "reached a dead end")
    if banded:
        n = dg.n_rows
        i2n = np.asarray(graph.index_to_node_id[:n], dtype=np.int64)
        graph.node_id_to_max_pos_left[i2n] = out.mpl[0, :n].cpu().numpy()
        graph.node_id_to_max_pos_right[i2n] = out.mpr[0, :n].cpu().numpy()
    res = AlignResult()
    res.best_score = int(misc[L.M_BEST])
    if not params.ret_cigar:
        return res
    nst = int(misc[L.M_NSTEPS])
    return replay_steps(graph, params, np.asarray(query),
                        out.steps[0, :nst].cpu().numpy(), nst,
                        int(misc[L.M_BI]), int(misc[L.M_BJ]),
                        int(misc[L.M_ENDI]), int(misc[L.M_ENDJ]), res)
