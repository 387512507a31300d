"""Partial-order alignment graph: the benchmark's frozen plain-Python copy
of abPOA's abpoa_graph_t (reference: abPOA include/abpoa.h:83-101,
src/abpoa_graph.c).

Design notes vs the reference:
  * per-edge read-id bitmasks are arbitrary-precision python ints instead of
    uint64[] words — identical bit semantics, no word-count bookkeeping,
  * traversal orders (BFS toposort with aligned-node grouping, reverse BFS for
    max_remain, DFS for msa rank) replicate the reference exactly since they
    determine output bytes.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .cigar import CMATCH, CINS, CDEL, CSOFT_CLIP, CHARD_CLIP
from .params import SRC_NODE_ID, SINK_NODE_ID


class Node:
    __slots__ = ("base", "in_id", "out_id", "out_weight", "read_ids",
                 "aligned_node_id", "n_read", "read_weight")

    def __init__(self, base: int = 0):
        self.base = base
        self.in_id: list[int] = []
        self.out_id: list[int] = []
        self.out_weight: list[int] = []
        self.read_ids: list[int] = []      # python-int bitmask per out edge
        self.aligned_node_id: list[int] = []
        self.n_read = 0
        self.read_weight: dict[int, int] = {}  # read_id -> qv weight

    def reset(self):
        self.in_id.clear(); self.out_id.clear(); self.out_weight.clear()
        self.read_ids.clear(); self.aligned_node_id.clear()
        self.n_read = 0
        self.read_weight.clear()


class POAGraph:
    def __init__(self):
        self.node: list[Node] = [Node(), Node()]  # SRC, SINK
        self.is_topological_sorted = False
        self.is_called_cons = False
        self.is_set_msa_rank = False
        # index maps (filled by topological_sort)
        self.index_to_node_id: np.ndarray | None = None
        self.node_id_to_index: np.ndarray | None = None
        self.node_id_to_max_pos_left: np.ndarray | None = None
        self.node_id_to_max_pos_right: np.ndarray | None = None
        self.node_id_to_max_remain: np.ndarray | None = None
        self.node_id_to_msa_rank: np.ndarray | None = None

    # ------------------------------------------------------------------ #
    @property
    def node_n(self) -> int:
        return len(self.node)

    def reset(self):
        """ref abpoa_reset (src/abpoa_graph.c:681-743): wipe to SRC+SINK."""
        self.node = [Node(), Node()]
        self.is_topological_sorted = self.is_called_cons = False
        self.is_set_msa_rank = False

    def add_node(self, base: int) -> int:
        """ref abpoa_add_graph_node (src/abpoa_graph.c:409-416)."""
        self.node.append(Node(base))
        return len(self.node) - 1

    def add_edge(self, from_id: int, to_id: int, check_edge: bool, w: int,
                 add_read_id: bool, add_read_weight: bool, read_id: int):
        """ref abpoa_add_graph_edge (src/abpoa_graph.c:418-484)."""
        fnode = self.node[from_id]
        out_edge_i = -1
        if check_edge:
            for i, oid in enumerate(fnode.out_id):
                if oid == to_id:
                    fnode.out_weight[i] += w
                    out_edge_i = i
                    break
        if out_edge_i < 0:
            self.node[to_id].in_id.append(from_id)
            fnode.out_id.append(to_id)
            fnode.out_weight.append(w)
            fnode.read_ids.append(0)
            out_edge_i = len(fnode.out_id) - 1
        if add_read_id:
            fnode.read_ids[out_edge_i] |= (1 << read_id)
        fnode.n_read += 1
        if add_read_weight:
            fnode.read_weight[read_id] = w

    # --- aligned ("mismatch bundle") nodes, ref src/abpoa_graph.c:377-401 ---
    def get_aligned_id(self, node_id: int, base: int) -> int:
        for aln_id in self.node[node_id].aligned_node_id:
            if self.node[aln_id].base == base:
                return aln_id
        return -1

    def add_aligned_node(self, node_id: int, aligned_id: int):
        node = self.node
        for aid in node[node_id].aligned_node_id:
            node[aid].aligned_node_id.append(aligned_id)
            node[aligned_id].aligned_node_id.append(aid)
        node[node_id].aligned_node_id.append(aligned_id)
        node[aligned_id].aligned_node_id.append(node_id)

    # ------------------------------------------------------------------ #
    def add_graph_sequence(self, seq, weight, qpos_to_node_id,
                           add_read_id: bool, add_read_weight: bool, read_id: int):
        """First read -> linear backbone. ref src/abpoa_graph.c:486-502."""
        seq_l = len(seq)
        last = SRC_NODE_ID
        for i in range(seq_l):
            cur = self.add_node(int(seq[i]))
            if qpos_to_node_id is not None:
                qpos_to_node_id[i] = cur
            self.add_edge(last, cur, False, int(weight[i]), add_read_id,
                          add_read_weight, read_id)
            last = cur
        self.add_edge(last, SINK_NODE_ID, False, int(weight[seq_l - 1]),
                      add_read_id, add_read_weight, read_id)
        self.is_called_cons = self.is_set_msa_rank = False
        self.is_topological_sorted = False

    def add_subgraph_alignment(self, params, beg_node_id: int, end_node_id: int,
                               seq, weight, cigar, qpos_to_node_id, read_id: int,
                               inc_both_ends: bool):
        """Fuse an alignment (graph cigar) into the DAG.

        ref abpoa_add_subgraph_alignment (src/abpoa_graph.c:596-672); fusion
        rules documented at src/abpoa_graph.c:587-593.
        """
        seq_l = len(seq)
        add_read_id = params.use_read_ids
        add_read_weight = params.use_qv and (params.max_n_cons > 1)
        if weight is None:
            weight = [1] * seq_l
        if self.node_n == 2:  # empty graph
            self.add_graph_sequence(seq, weight, qpos_to_node_id,
                                    add_read_id, add_read_weight, read_id)
            return
        if not cigar:
            return

        query_id = -1
        last_new = False
        last_id = beg_node_id
        node = self.node
        rbit = 1 << read_id
        for entry in cigar:
            op = entry[0]
            if op == CMATCH:
                node_id = entry[1]
                query_id += 1
                add = bool(last_id != beg_node_id or inc_both_ends)
                if node[node_id].base != seq[query_id]:  # mismatch
                    aligned_id = self.get_aligned_id(node_id, int(seq[query_id]))
                    if aligned_id != -1:
                        self.add_edge(last_id, aligned_id, not last_new,
                                      int(weight[query_id]), add_read_id and add,
                                      add_read_weight, read_id)
                        last_id = aligned_id; last_new = False
                    else:
                        new_id = self.add_node(int(seq[query_id]))
                        self.add_edge(last_id, new_id, False,
                                      int(weight[query_id]), add_read_id and add,
                                      add_read_weight, read_id)
                        self.add_aligned_node(node_id, new_id)
                        last_id = new_id; last_new = True
                else:  # match: inlined add_edge fast path (the dominant op)
                    w = int(weight[query_id])
                    fnode = node[last_id]
                    out_edge_i = -1
                    if not last_new:
                        for i, oid in enumerate(fnode.out_id):
                            if oid == node_id:
                                fnode.out_weight[i] += w
                                out_edge_i = i
                                break
                    if out_edge_i < 0:
                        node[node_id].in_id.append(last_id)
                        fnode.out_id.append(node_id)
                        fnode.out_weight.append(w)
                        fnode.read_ids.append(0)
                        out_edge_i = len(fnode.out_id) - 1
                    if add_read_id and add:
                        fnode.read_ids[out_edge_i] |= rbit
                    fnode.n_read += 1
                    if add_read_weight:
                        fnode.read_weight[read_id] = w
                    last_id = node_id; last_new = False
                if qpos_to_node_id is not None:
                    qpos_to_node_id[query_id] = last_id
            elif op in (CINS, CSOFT_CLIP, CHARD_CLIP):
                length = entry[2]
                query_id += length
                for j in range(length - 1, -1, -1):
                    new_id = self.add_node(int(seq[query_id - j]))
                    add = bool(last_id != beg_node_id or inc_both_ends)
                    self.add_edge(last_id, new_id, False,
                                  int(weight[query_id - j]), add_read_id and add,
                                  add_read_weight, read_id)
                    last_id = new_id; last_new = True
                    if qpos_to_node_id is not None:
                        qpos_to_node_id[query_id - j] = last_id
            elif op == CDEL:
                continue
        self.add_edge(last_id, end_node_id, not last_new, int(weight[seq_l - 1]),
                      add_read_id, add_read_weight, read_id)
        self.is_called_cons = False
        self.is_topological_sorted = False

    def add_graph_alignment(self, params, seq, weight, cigar, qpos_to_node_id,
                            read_id: int, inc_both_ends: bool):
        self.add_subgraph_alignment(params, SRC_NODE_ID, SINK_NODE_ID, seq,
                                    weight, cigar, qpos_to_node_id, read_id,
                                    inc_both_ends)

    # ------------------------------------------------------------------ #
    def _bfs_set_node_index(self):
        """Kahn BFS keeping aligned nodes adjacent.
        ref abpoa_BFS_set_node_index (src/abpoa_graph.c:186-231)."""
        n = self.node_n
        in_degree = [len(nd.in_id) for nd in self.node]
        index_to_node_id = np.empty(n, dtype=np.int64)
        node_id_to_index = np.empty(n, dtype=np.int64)
        q = deque([SRC_NODE_ID])
        index = 0
        while q:
            cur = q.popleft()
            index_to_node_id[index] = cur
            node_id_to_index[cur] = index
            index += 1
            if cur == SINK_NODE_ID:
                self.index_to_node_id = index_to_node_id
                self.node_id_to_index = node_id_to_index
                return
            for out_id in self.node[cur].out_id:
                in_degree[out_id] -= 1
                if in_degree[out_id] == 0:
                    if any(in_degree[a] != 0
                           for a in self.node[out_id].aligned_node_id):
                        continue
                    q.append(out_id)
                    for a in self.node[out_id].aligned_node_id:
                        q.append(a)
        raise RuntimeError("Failed to set node index.")

    def _bfs_set_node_remain(self):
        """Reverse BFS computing longest remaining path along heaviest out edge.
        ref abpoa_BFS_set_node_remain (src/abpoa_graph.c:233-274)."""
        n = self.node_n
        out_degree = [len(nd.out_id) for nd in self.node]
        max_remain = np.zeros(n, dtype=np.int64)
        max_remain[SINK_NODE_ID] = -1
        q = deque([SINK_NODE_ID])
        while q:
            cur = q.popleft()
            if cur != SINK_NODE_ID:
                max_w, max_id = -1, -1
                nd = self.node[cur]
                for out_id, w in zip(nd.out_id, nd.out_weight):
                    if w > max_w:
                        max_w, max_id = w, out_id
                max_remain[cur] = max_remain[max_id] + 1
            if cur == SRC_NODE_ID:
                self.node_id_to_max_remain = max_remain
                return
            for in_id in self.node[cur].in_id:
                out_degree[in_id] -= 1
                if out_degree[in_id] == 0:
                    q.append(in_id)
        raise RuntimeError("Failed to set node remain.")

    def topological_sort(self, params):
        """ref abpoa_topological_sort (src/abpoa_graph.c:279-313)."""
        n = self.node_n
        self._bfs_set_node_index()
        if params.wb >= 0 or params.zdrop > 0:
            self._bfs_set_node_remain()
        if params.wb >= 0:
            self.node_id_to_max_pos_right = np.zeros(n, dtype=np.int64)
            self.node_id_to_max_pos_left = np.full(n, n, dtype=np.int64)
        self.is_topological_sorted = True

    # ------------------------------------------------------------------ #
    def _dfs_set_msa_rank(self):
        """DFS (LIFO) rank where aligned nodes share one MSA column.
        ref abpoa_DFS_set_msa_rank (src/abpoa_graph.c:315-366)."""
        n = self.node_n
        in_degree = [len(nd.in_id) for nd in self.node]
        msa_rank = np.full(n, -1, dtype=np.int64)
        stack = [SRC_NODE_ID]
        rank = 0
        while stack:
            cur = stack.pop()
            if msa_rank[cur] < 0:
                msa_rank[cur] = rank
                for a in self.node[cur].aligned_node_id:
                    msa_rank[a] = rank
                rank += 1
            if cur == SINK_NODE_ID:
                self.node_id_to_msa_rank = msa_rank
                self.is_set_msa_rank = True
                return
            for out_id in self.node[cur].out_id:
                in_degree[out_id] -= 1
                if in_degree[out_id] == 0:
                    if any(in_degree[a] != 0
                           for a in self.node[out_id].aligned_node_id):
                        continue
                    stack.append(out_id)
                    msa_rank[out_id] = -1
                    for a in self.node[out_id].aligned_node_id:
                        stack.append(a)
                        msa_rank[a] = -1
        raise RuntimeError("Error in set_msa_rank.")

    def set_msa_rank(self):
        if not self.is_set_msa_rank:
            self._dfs_set_msa_rank()

    # ------------------------------------------------------------------ #
    # subgraph closure, ref src/abpoa_graph.c:504-585
    def _is_full_upstream(self, up_index: int, down_index: int) -> bool:
        for i in range(up_index + 1, down_index + 1):
            nid = int(self.index_to_node_id[i])
            for in_id in self.node[nid].in_id:
                if self.node_id_to_index[in_id] < up_index:
                    return False
        return True

    def upstream_index(self, beg_index: int, end_index: int) -> int:
        while True:
            min_index = beg_index
            for i in range(beg_index, end_index + 1):
                nid = int(self.index_to_node_id[i])
                for in_id in self.node[nid].in_id:
                    min_index = min(min_index, int(self.node_id_to_index[in_id]))
            if self._is_full_upstream(min_index, beg_index):
                return min_index
            end_index = beg_index
            beg_index = min_index

    def downstream_index(self, beg_index: int, end_index: int) -> int:
        while True:
            max_index = end_index
            for i in range(beg_index, end_index + 1):
                nid = int(self.index_to_node_id[i])
                for out_id in self.node[nid].out_id:
                    max_index = max(max_index, int(self.node_id_to_index[out_id]))
            if self._is_full_upstream(end_index, max_index):
                return max_index
            beg_index = end_index
            end_index = max_index

    def subgraph_nodes(self, params, inc_beg: int, inc_end: int) -> tuple[int, int]:
        """ref abpoa_subgraph_nodes (src/abpoa_graph.c:573-585)."""
        if not self.is_topological_sorted:
            self.topological_sort(params)
        beg_i = int(self.node_id_to_index[inc_beg])
        end_i = int(self.node_id_to_index[inc_end])
        exc_beg_i = self.upstream_index(beg_i, end_i)
        exc_end_i = self.downstream_index(beg_i, end_i)
        return int(self.index_to_node_id[exc_beg_i]), int(self.index_to_node_id[exc_end_i])
