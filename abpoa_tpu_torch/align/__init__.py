"""Alignment engines.

``align_sequence_to_graph/subgraph`` run the exact NumPy host oracle
(reference-bit-exact, see engine_np.py). Single-read incremental POA calls
use it; batched multi-instance throughput runs go through the device
kernels (parallel/batch.py), whose dense inputs ``export.py`` builds. The
serial device engine (``--engine``) is not ported yet (ROADMAP A8).
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
    return _np_subgraph(graph, params, beg_node_id, end_node_id, query,
                        arena=arena)


def align_sequence_to_graph(graph, params, query, arena=None) -> AlignResult:
    return align_sequence_to_subgraph(graph, params, SRC_NODE_ID,
                                      SINK_NODE_ID, query, arena=arena)
