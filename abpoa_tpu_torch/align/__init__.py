"""Alignment engines.

``align_sequence_to_graph/subgraph`` dispatch between the exact NumPy host
oracle (reference-bit-exact, see engine_np.py) and the serial device
engine (engine_torch.py), which ``params.engine == "torch"`` selects for
whole-graph calls (on ``params.device``). Subgraph windows stay on the
oracle (only ``-S`` reaches them, ROADMAP A7). Batched multi-instance
throughput runs go through the device kernels (parallel/batch.py), whose
dense inputs ``export.py`` builds.
"""
from __future__ import annotations

from ..params import SRC_NODE_ID, SINK_NODE_ID
from .engine_np import AlignResult, align_sequence_to_subgraph as _np_subgraph


def align_sequence_to_subgraph(graph, params, beg_node_id, end_node_id,
                               query, arena=None) -> AlignResult:
    """ref abpoa_align_sequence_to_subgraph (src/abpoa_align.c:178-183)."""
    if graph.node_n <= 2:
        return None
    if not graph.is_topological_sorted:
        graph.topological_sort(params)
    if (params.engine == "torch" and beg_node_id == SRC_NODE_ID
            and end_node_id == SINK_NODE_ID):
        from .engine_torch import align_sequence_to_graph_device
        return align_sequence_to_graph_device(graph, params, query,
                                              params.device)
    return _np_subgraph(graph, params, beg_node_id, end_node_id, query,
                        arena=arena)


def align_sequence_to_graph(graph, params, query, arena=None) -> AlignResult:
    return align_sequence_to_subgraph(graph, params, SRC_NODE_ID,
                                      SINK_NODE_ID, query, arena=arena)
