"""The serial device engine: one read against the whole graph, or one
seeded window against its subgraph, on the device, per align call.

Counterpart of the device wrappers of ``abpoa_tpu/align/engine_jax.py``
(``align_sequence_to_graph_device``, :509-548, and
``align_sequence_to_subgraph_device``, :458-506). Per call:

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
  device. The JAX package runs its XLA tier there (``dp_xla``); B4
  computes the same function (the engine chain engine_np == dp_xla ==
  dp_pallas == dp_pallas_fw) with no overflow path, so it gives the same
  bytes;
* a walk dead end of B4 is the reference's own backtrack failure, which
  it treats as fatal: ``RuntimeError``;
* a subgraph window (``-S``/``-p``: the alignment between two anchors)
  runs B4 on the window's export (``export_dense`` with its
  beg/end index): dead rows are gated by the reachability row mask, the
  band state is written back for the window's live rows, and the steps
  replay relative to the window's first row. An empty window has no DP:
  ``align/__init__.py`` sends it where the JAX package does (the host
  oracle) and counts it in ``empty_windows``;
* any graph, window or query runs: the kernels' step words have 30 row
  and 31 column bits; an alignment whose B5 tiles or B4 planes exceed
  the device memory budget (``device.plane_budget``) runs on the host
  oracle instead (the JAX package runs its XLA tier there), counted in
  ``over_budget``.

The kernels' wrappers count their launches; ``reroutes`` counts the B5
results re-run on B4, by flag.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..device import plane_budget, resolve_device
from ..params import GLOBAL_MODE, EXTEND_MODE, SRC_NODE_ID, SINK_NODE_ID
from ..ops import layout as L
from .engine_np import AlignResult

reroutes = {"M_OVFL": 0, "M_FAIL": 0}
empty_windows = 0   # subgraph windows with no query bases (no DP)
over_budget = 0     # alignments over the memory budget (the oracle)


def _run(kernel, cfg, arrs, dev):
    """One B=1 launch; returns (out, misc row as numpy)."""
    with trace.span("abpoa.dispatch", 1):
        out = kernel(cfg, *(torch.from_numpy(np.ascontiguousarray(a))[None]
                            .to(dev) for a in arrs))
    with trace.span("abpoa.wait"):
        return out, out.misc[0].cpu().numpy()


def _fits(nbytes, dev):
    """Whether one launch's tiles or planes fit the device memory
    budget."""
    return nbytes <= plane_budget(dev)


def _oracle(graph, params, beg_node_id, end_node_id, query):
    """The alignment on the host oracle, counted in over_budget."""
    global over_budget
    from .engine_np import align_sequence_to_subgraph
    over_budget += 1
    return align_sequence_to_subgraph(graph, params, beg_node_id,
                                      end_node_id, query)


def _full_width(dg, params, dev):
    """B4 over one export (whole graph or window): (out, misc row), or
    None when its planes exceed the budget. A walk dead end is the
    reference's own backtrack failure: it raises."""
    from .export import make_pallas_inputs
    from ..ops.fw_dp import FWConfig, fw_plane_bytes, fw_poa_dp_batch
    Wq = (dg.qlen // 128 + 1) * 128
    lmax = (dg.R + Wq + 511) // 512 * 512 if params.ret_cigar else 0
    with trace.span("abpoa.export", 1):
        cfg, arrs = make_pallas_inputs(dg, params, 128, force_Wq=Wq,
                                       bt_lmax=lmax)
    fwc = FWConfig(cfg.gap_mode, cfg.align_mode, cfg.pn, cfg.R, Wq, cfg.P,
                   cfg.O, cfg.m, cfg.use_zdrop, lmax,
                   banded=params.wb >= 0)
    if not _fits(fw_plane_bytes(fwc), dev):
        return None
    out, misc = _run(fw_poa_dp_batch, fwc, arrs, dev)
    if params.ret_cigar and misc[L.M_FAIL]:
        raise RuntimeError("Error in backtrack: the full-width walk "
                           "reached a dead end")
    return out, misc


def _result(graph, params, query, out, misc, row0=0):
    """AlignResult of one launch: the best score, and with ret_cigar the
    replayed cigar (rows relative to topo index row0)."""
    from ..ops.steps import replay_steps
    res = AlignResult()
    res.best_score = int(misc[L.M_BEST])
    if not params.ret_cigar:
        return res
    nst = int(misc[L.M_NSTEPS])
    return replay_steps(graph, params, np.asarray(query),
                        out.steps[0, :nst].cpu().numpy(), nst,
                        int(misc[L.M_BI]), int(misc[L.M_BJ]),
                        int(misc[L.M_ENDI]), int(misc[L.M_ENDJ]), res,
                        row0=row0)


def align_sequence_to_graph_device(graph, params, query,
                                   device) -> AlignResult:
    """Whole-graph alignment of `query` on `device` ("cuda": the kernels,
    "cpu": their plain versions); see the module doc for the routing."""
    from .export import export_dense, make_pallas_inputs, pick_WB
    from ..ops.tile_dp import tile_plane_bytes, tile_poa_dp_batch
    dev = resolve_device(device)
    banded = params.wb >= 0
    tile = banded and params.align_mode in (GLOBAL_MODE, EXTEND_MODE)
    with trace.span("abpoa.export", 1):
        dg = export_dense(graph, params, query)
        Wq = (dg.qlen // 128 + 1) * 128
        lmax = (dg.R + Wq + 511) // 512 * 512 if params.ret_cigar else 0
        if tile:
            WB = pick_WB(params, dg.qlen, dg.pn)
            cfg, arrs = make_pallas_inputs(dg, params, WB, bt_lmax=lmax)
    out = None
    if tile:
        if not _fits(tile_plane_bytes(cfg), dev):
            return _oracle(graph, params, SRC_NODE_ID, SINK_NODE_ID, query)
        out, misc = _run(tile_poa_dp_batch, cfg, arrs[:10], dev)
        flag = ("M_OVFL" if misc[L.M_OVFL] else
                "M_FAIL" if params.ret_cigar and misc[L.M_FAIL] else None)
        if flag:
            reroutes[flag] += 1
            out = None
    if out is None:
        fw = _full_width(dg, params, dev)
        if fw is None:
            return _oracle(graph, params, SRC_NODE_ID, SINK_NODE_ID, query)
        out, misc = fw
    with trace.span("abpoa.replay", 1):
        if banded:
            n = dg.n_rows
            i2n = np.asarray(graph.index_to_node_id[:n], dtype=np.int64)
            graph.node_id_to_max_pos_left[i2n] = \
                out.mpl[0, :n].cpu().numpy()
            graph.node_id_to_max_pos_right[i2n] = \
                out.mpr[0, :n].cpu().numpy()
        return _result(graph, params, query, out, misc)


def align_sequence_to_subgraph_device(graph, params, beg_node_id,
                                      end_node_id, query,
                                      device) -> AlignResult:
    """One seeded window (`query`, non-empty) against the subgraph between
    beg_node_id and end_node_id on `device`: one B4 launch at B=1 under
    the window's reachability row mask (see the module doc)."""
    from .export import export_dense
    dev = resolve_device(device)
    beg_index = int(graph.node_id_to_index[beg_node_id])
    end_index = int(graph.node_id_to_index[end_node_id])
    with trace.span("abpoa.export", 1):
        dg = export_dense(graph, params, query, beg_index=beg_index,
                          end_index=end_index)
    fw = _full_width(dg, params, dev)
    if fw is None:
        return _oracle(graph, params, beg_node_id, end_node_id, query)
    out, misc = fw
    with trace.span("abpoa.replay", 1):
        if params.wb >= 0:
            # only the live rows carry band state: the oracle never
            # touches the rows outside the row mask
            n = dg.n_rows
            live = dg.rowmask[:n] > 0
            ids = np.asarray(
                graph.index_to_node_id[beg_index:beg_index + n],
                dtype=np.int64)[live]
            graph.node_id_to_max_pos_left[ids] = \
                out.mpl[0, :n].cpu().numpy()[live]
            graph.node_id_to_max_pos_right[ids] = \
                out.mpr[0, :n].cpu().numpy()[live]
        return _result(graph, params, query, out, misc, row0=beg_index)
