"""One cluster's POA and consensus, as abPOA v1.4.1's ``abpoa_msa``
computes it (ref src/abpoa_align.c:192-437): plain progressive POA, or
minimizer-seeded windows (``-S``/``-p``) in global mode, then heaviest
bundling. The benchmark's frozen plain-Python copy of the port's host
aligner; every alignment runs the NumPy engine in ``engine.py``.
"""
from __future__ import annotations

import numpy as np

from . import cigar as cgm
from .alphabet import decode_table, revcomp_codes
from .consensus import Consensus, generate_consensus
from .engine import align_sequence_to_subgraph
from .graph import POAGraph
from .params import GLOBAL_MODE, SINK_NODE_ID, SRC_NODE_ID


class Aligner:
    """Graph, read bookkeeping and the DP arena of one cluster, with the
    band cells of every alignment summed in ``dp_cells``."""

    def __init__(self, params):
        from .arena import SimdArena
        self.p = params
        self.graph = POAGraph()
        self.arena = SimdArena()
        self.is_rc: list[int] = []
        self.n_seq = 0
        self.cons = Consensus()
        self.dp_cells = 0

    def _align(self, beg_id, end_id, query):
        """ref abpoa_align_sequence_to_subgraph (src/abpoa_align.c:178-183)."""
        g = self.graph
        if g.node_n <= 2:
            return None
        if not g.is_topological_sorted:
            g.topological_sort(self.p)
        res = align_sequence_to_subgraph(g, self.p, beg_id, end_id, query,
                                         arena=self.arena)
        self.dp_cells += res.dp_cells
        return res

    def poa_one(self, qseq, weight, read_id: int):
        """ref abpoa_poa (src/abpoa_align.c:302-344), one read."""
        p = self.p
        res = self._align(SRC_NODE_ID, SINK_NODE_ID, qseq)
        if res is not None and p.amb_strand:
            thres = (min(len(qseq), self.graph.node_n - 2)
                     * p.max_mat * .3333)
            if res.best_score < thres:
                rc_qseq = revcomp_codes(np.asarray(qseq))
                rc_res = self._align(SRC_NODE_ID, SINK_NODE_ID, rc_qseq)
                if rc_res.best_score > res.best_score:
                    res, qseq = rc_res, rc_qseq
                    weight = list(weight[::-1])
                    self.is_rc[read_id] = 1
        cigar = res.cigar if res is not None else []
        self.graph.add_graph_alignment(p, qseq, weight, cigar, None,
                                       read_id, True)

    def anchor_poa(self, seqs, weights, seq_lens, par_anchors, par_c,
                   read_id_map):
        """ref abpoa_anchor_poa (src/abpoa_align.c:192-299)."""
        p = self.p
        k = p.k
        max_len = max(seq_lens) if seq_lens else 0
        tpos_to_node_id = [0] * max_len
        qpos_to_node_id = [0] * max_len
        last_read_id = -1
        for _i in range(len(seqs)):
            i = read_id_map[_i]
            read_id = i
            qlen = seq_lens[i]
            whole_cigar: list = []
            ai = 0 if _i == 0 else par_c[_i - 1]
            if ai < par_c[_i]:
                self.is_rc[read_id] = (self.is_rc[last_read_id]
                                       ^ (par_anchors[ai] >> 63))
                if self.is_rc[read_id]:
                    qseq = revcomp_codes(np.asarray(seqs[i]))
                    weight = list(weights[i][::-1])
                else:
                    qseq, weight = seqs[i], weights[i]
                if self.is_rc[last_read_id]:
                    # flip anchors to the previous read's stored
                    # orientation (ref :220-246)
                    last_qlen = seq_lens[read_id_map[_i - 1]]
                    for j in range(ai, par_c[_i]):
                        a = par_anchors[j]
                        end_tpos = (a >> 32) & 0x7fffffff
                        end_qpos = a & 0xffffffff
                        par_anchors[j] = ((a >> 63) << 63
                                          | (last_qlen - end_tpos + k) << 32
                                          | (qlen - end_qpos + k))
                    lo, hi = ai, par_c[_i] - 1
                    while lo < hi:
                        par_anchors[lo], par_anchors[hi] = \
                            par_anchors[hi], par_anchors[lo]
                        lo += 1
                        hi -= 1
            else:
                self.is_rc[read_id] = 0
                qseq, weight = seqs[i], weights[i]
            beg_id, beg_qpos = SRC_NODE_ID, 0
            while ai < par_c[_i]:
                a = par_anchors[ai]
                end_tpos = ((a >> 32) & 0x7fffffff) - k + 1
                end_id = tpos_to_node_id[end_tpos]
                end_qpos = (a & 0xffffffff) - k + 1
                res = self._align(beg_id, end_id, qseq[beg_qpos:end_qpos])
                if res is not None:
                    whole_cigar.extend(res.cigar)
                # forced k-match cigar across the anchor (ref :267-269)
                for j in range(k):
                    cgm.push_cigar(whole_cigar, cgm.CMATCH, 1,
                                   tpos_to_node_id[end_tpos + j], j)
                beg_id = tpos_to_node_id[end_tpos + k - 1]
                beg_qpos = end_qpos + k
                ai += 1
            res = self._align(beg_id, SINK_NODE_ID, qseq[beg_qpos:qlen])
            if res is not None:
                whole_cigar.extend(res.cigar)
            self.graph.add_subgraph_alignment(
                p, SRC_NODE_ID, SINK_NODE_ID, qseq, weight, whole_cigar,
                qpos_to_node_id, read_id, True)
            tpos_to_node_id, qpos_to_node_id = qpos_to_node_id, tpos_to_node_id
            last_read_id = read_id

    def msa(self, seqs):
        """ref abpoa_msa (src/abpoa_align.c:373-437) on encoded reads with
        unit weights, then the consensus."""
        p = self.p
        seqs = [np.asarray(s, dtype=np.uint8) for s in seqs]
        n_seq = len(seqs)
        self.n_seq = n_seq
        self.is_rc = [0] * n_seq
        weights = [[1] * len(s) for s in seqs]
        seq_lens = [len(s) for s in seqs]
        if ((p.disable_seeding and not p.progressive_poa)
                or p.align_mode != GLOBAL_MODE):
            for i, q in enumerate(seqs):
                self.poa_one(q, weights[i], i)
        else:
            from .seed import build_guide_tree_partition
            read_id_map, par_anchors, par_c = build_guide_tree_partition(
                seqs, seq_lens, p)
            self.anchor_poa(seqs, weights, seq_lens, par_anchors, par_c,
                            read_id_map)
        generate_consensus(self, p)


def cluster_consensus(params, reads):
    """(consensus strings, band cells of every alignment) of one cluster
    of encoded reads."""
    ab = Aligner(params)
    ab.msa(reads)
    tab = decode_table(params.m)
    c = ab.cons
    cons = [bytes(tab[b] for b in c.cons_base[i]).decode()
            for i in range(c.n_cons)]
    return cons, ab.dp_cells
