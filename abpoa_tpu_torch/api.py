"""Top-level POA pipeline (the abpoa_t / abpoa_msa equivalent).

reference: abPOA src/abpoa_align.c:302-503 (plain + anchored POA,
msa/msa1), src/abpoa.c:131-148 (main program).
"""
from __future__ import annotations

import numpy as np

from . import align as aln
from . import trace
from .alphabet import encode_table, revcomp_codes
from .consensus import Consensus, generate_consensus
from .gfa import generate_gfa, restore_graph
from .graph import POAGraph
from .msa import generate_rc_msa, output_fx_consensus, output_rc_msa
from .params import GLOBAL_MODE, Params


class ABPOA:
    """Aligner state: graph + sequence metadata + consensus (abpoa_t)."""

    def __init__(self):
        from .align.arena import SimdArena
        self.graph = POAGraph()
        self.arena = SimdArena()  # persistent DP arena (ref abm->s_mem)
        self.names: list[str] = []
        self.is_rc: list[int] = []
        self.n_seq = 0
        self.cons = Consensus()

    def reset(self):
        """ref abpoa_reset (src/abpoa_graph.c:681-743)."""
        self.graph.reset()
        self.names = []
        self.is_rc = []
        self.n_seq = 0
        self.cons = Consensus()

    # -------------------------------------------------------------- #
    def poa_one(self, params: Params, qseq, weight, read_id: int):
        """Align + (optional amb-strand rc retry) + fuse ONE read — the
        body of the reference's plain POA loop (ref abpoa_poa
        src/abpoa_align.c:302-344, rc retry at :315). Shared by the
        sequential loop and the batched runner's amb-strand handling."""
        qlen = len(qseq)
        res = aln.align_sequence_to_graph(self.graph, params, qseq,
                                          arena=self.arena)
        if res is not None and params.amb_strand:
            thres = (min(qlen, self.graph.node_n - 2)
                     * params.max_mat * .3333)
            if res.best_score < thres:
                rc_qseq = revcomp_codes(np.asarray(qseq))
                rc_weight = list(weight[::-1])
                rc_res = aln.align_sequence_to_graph(
                    self.graph, params, rc_qseq, arena=self.arena)
                if rc_res.best_score > res.best_score:
                    res = rc_res
                    qseq = rc_qseq
                    weight = rc_weight
                    self.is_rc[read_id] = 1
        cigar = res.cigar if res is not None else []
        with trace.span("abpoa.fuse", 1):
            self.graph.add_graph_alignment(params, qseq, weight, cigar, None,
                                           read_id, True)

    def poa(self, params: Params, seqs, weights, exist_n_seq: int):
        """plain iterative POA (ref abpoa_poa src/abpoa_align.c:302-344)."""
        for i, qseq in enumerate(seqs):
            self.poa_one(params, qseq, weights[i], exist_n_seq + i)

    def anchor_poa(self, params: Params, seqs, weights, seq_lens, par_anchors,
                   par_c, read_id_map, exist_n_seq: int):
        """anchored/windowed POA (ref abpoa_anchor_poa src/abpoa_align.c:192-299).

        Drives the request generator with the dispatcher; the batched device
        runner (parallel/batch.py run_seeded) drives the same generator, so
        both paths share the exact host logic."""
        gen = self.anchor_poa_requests(params, seqs, weights, seq_lens,
                                       par_anchors, par_c, read_id_map,
                                       exist_n_seq)
        try:
            req = next(gen)
            while True:
                beg_id, end_id, window = req
                res = aln.align_sequence_to_subgraph(
                    self.graph, params, beg_id, end_id, window,
                    arena=self.arena)
                req = gen.send(res)
        except StopIteration:
            pass

    def anchor_poa_requests(self, params: Params, seqs, weights, seq_lens,
                            par_anchors, par_c, read_id_map,
                            exist_n_seq: int):
        """Generator form of anchor_poa: yields (beg_id, end_id, window)
        subgraph-align requests and receives AlignResult via send()."""
        from .params import SRC_NODE_ID, SINK_NODE_ID
        n_seq = len(seqs)
        max_len = max(seq_lens) if seq_lens else 0
        tpos_to_node_id = [0] * max_len
        qpos_to_node_id = [0] * max_len
        k = params.k
        last_read_id = -1
        for _i in range(n_seq):
            i = read_id_map[_i]
            read_id = exist_n_seq + i
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
                    qseq = seqs[i]
                    weight = weights[i]
                if self.is_rc[last_read_id]:
                    # flip anchors to the previous read's stored orientation
                    # (ref :220-246)
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
                        lo += 1; hi -= 1
            else:
                self.is_rc[read_id] = 0
                qseq = seqs[i]
                weight = weights[i]

            beg_id, beg_qpos = SRC_NODE_ID, 0
            while ai < par_c[_i]:
                a = par_anchors[ai]
                end_tpos = ((a >> 32) & 0x7fffffff) - k + 1
                end_id = tpos_to_node_id[end_tpos]
                end_qpos = (a & 0xffffffff) - k + 1
                res = yield (beg_id, end_id, qseq[beg_qpos:end_qpos])
                if res is not None:
                    whole_cigar.extend(res.cigar)
                # forced k-match cigar across the anchor (ref :267-269)
                from . import cigar as cgm
                anchor_cigar: list = []
                for j in range(k):
                    cgm.push_cigar(anchor_cigar, cgm.CMATCH, 1,
                                   tpos_to_node_id[end_tpos + j], j)
                whole_cigar.extend(anchor_cigar)
                beg_id = tpos_to_node_id[end_tpos + k - 1]
                beg_qpos = end_qpos + k
                ai += 1
            res = yield (beg_id, SINK_NODE_ID, qseq[beg_qpos:qlen])
            if res is not None:
                whole_cigar.extend(res.cigar)
            with trace.span("abpoa.fuse", 1):
                self.graph.add_subgraph_alignment(
                    params, SRC_NODE_ID, SINK_NODE_ID, qseq, weight,
                    whole_cigar, qpos_to_node_id, read_id, True)
            tpos_to_node_id, qpos_to_node_id = qpos_to_node_id, tpos_to_node_id
            last_read_id = read_id

    # -------------------------------------------------------------- #
    def output(self, params: Params, out) -> None:
        """ref abpoa_output (src/abpoa_align.c:346-362)."""
        import sys
        if params.out_gfa:
            generate_gfa(self, params, out)
        else:
            if params.out_msa:
                generate_rc_msa(self, params)
            if params.out_cons:
                with trace.span("abpoa.consensus", 1):
                    generate_consensus(self, params)
                if not self.graph.is_called_cons:
                    print("Warning: no consensus sequence generated.",
                          file=sys.stderr)
            if params.out_msa:
                output_rc_msa(self, params, out)
            elif params.out_cons:
                output_fx_consensus(self, params, out)
        if params.out_pog:
            from .plot import dump_pog
            dump_pog(self, params)

    def msa(self, params: Params, seqs, out=None, names=None, quals=None):
        """ref abpoa_msa (src/abpoa_align.c:373-437).

        seqs: list of encoded uint8 arrays (0..m-1 codes) or ASCII strings.
        quals: optional list of per-base int weights (qv) arrays.
        """
        if not (params.out_msa or params.out_cons or params.out_gfa) \
                or not seqs:
            return
        if params.engine == "torch":
            # the device must exist before any read aligns (a one-read
            # input never reaches the DP): no silent run on the host
            from .device import resolve_device
            resolve_device(params.device)
        self.reset()
        if params.incr_fn:
            restore_graph(self, params)
        exist_n_seq = self.n_seq
        n_seq = len(seqs)
        tab = encode_table(params.m)
        enc_seqs = []
        for s in seqs:
            if isinstance(s, (str, bytes)):
                raw = s.encode() if isinstance(s, str) else s
                enc_seqs.append(tab[np.frombuffer(raw, dtype=np.uint8)])
            else:
                enc_seqs.append(np.asarray(s, dtype=np.uint8))
        self.n_seq += n_seq
        self.names.extend(names if names is not None else [""] * n_seq)
        self.is_rc.extend([0] * n_seq)
        weights = []
        for i in range(n_seq):
            if params.use_qv and quals is not None and quals[i] is not None:
                weights.append([int(q) for q in quals[i]])
            else:
                weights.append([1] * len(enc_seqs[i]))
        seq_lens = [len(s) for s in enc_seqs]
        if (params.disable_seeding and not params.progressive_poa) \
                or params.align_mode != GLOBAL_MODE:
            self.poa(params, enc_seqs, weights, exist_n_seq)
        else:
            from .seed import build_guide_tree_partition
            with trace.span("abpoa.seed", 1):
                read_id_map, par_anchors, par_c = \
                    build_guide_tree_partition(enc_seqs, seq_lens, params)
            self.anchor_poa(params, enc_seqs, weights, seq_lens, par_anchors,
                            par_c, read_id_map, exist_n_seq)
        if out is not None:
            self.output(params, out)

    def msa_from_file(self, params: Params, read_fn: str, out=None):
        """ref abpoa_msa1 (src/abpoa_align.c:439-503)."""
        from .seqio import read_seqs
        recs = read_seqs(read_fn)
        names = [r.name for r in recs]
        seqs = [r.seq for r in recs]
        quals = None
        if params.use_qv:
            quals = [[ord(c) - 32 for c in r.qual] if r.qual else None
                     for r in recs]
        self.msa(params, seqs, out=out, names=names, quals=quals)
