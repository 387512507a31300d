"""Alignment engines.

``align_sequence_to_graph/subgraph`` dispatch between the exact NumPy host
oracle (reference-bit-exact, see engine_np.py) and the serial device
engine (engine_torch.py), which ``params.engine == "torch"`` (the
default) selects, on ``params.device``, for whole-graph calls and for
non-empty subgraph windows (``-S``/``-p``). An empty window has no DP: it
goes to the oracle, as in the JAX package, and the engine counts it.
Batched multi-instance throughput runs go through the device kernels
(parallel/batch.py), whose dense inputs ``export.py`` builds.
"""
from __future__ import annotations

from .. import trace
from ..params import SRC_NODE_ID, SINK_NODE_ID
from .engine_np import AlignResult, align_sequence_to_subgraph as _np_subgraph


def align_sequence_to_subgraph(graph, params, beg_node_id, end_node_id,
                               query, arena=None) -> AlignResult:
    """ref abpoa_align_sequence_to_subgraph (src/abpoa_align.c:178-183)."""
    if graph.node_n <= 2:
        return None
    if not graph.is_topological_sorted:
        with trace.span("abpoa.sort", 1):
            graph.topological_sort(params)
    if params.engine == "torch":
        from . import engine_torch
        if beg_node_id == SRC_NODE_ID and end_node_id == SINK_NODE_ID:
            return engine_torch.align_sequence_to_graph_device(
                graph, params, query, params.device)
        if len(query) > 0:
            return engine_torch.align_sequence_to_subgraph_device(
                graph, params, beg_node_id, end_node_id, query,
                params.device)
        engine_torch.empty_windows += 1
    return _np_subgraph(graph, params, beg_node_id, end_node_id, query,
                        arena=arena)


def align_sequence_to_graph(graph, params, query, arena=None) -> AlignResult:
    return align_sequence_to_subgraph(graph, params, SRC_NODE_ID,
                                      SINK_NODE_ID, query, arena=arena)
