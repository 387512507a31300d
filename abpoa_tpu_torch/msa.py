"""Row-column MSA generation and output.

reference: abPOA src/abpoa_output.c:60-166.
"""
from __future__ import annotations

from .alphabet import decode_table
from .consensus import generate_consensus


def generate_rc_msa(ab, params):
    """ref abpoa_generate_rc_msa (src/abpoa_output.c:123-166)."""
    graph = ab.graph
    if graph.node_n <= 2:
        return
    graph.set_msa_rank()
    if params.out_cons:
        generate_consensus(ab, params)
    abc = ab.cons
    n_seq = ab.n_seq
    msa_len = int(graph.node_id_to_msa_rank[1]) - 1
    abc.n_seq = n_seq
    abc.msa_len = msa_len
    m = params.m
    msa = [[m] * msa_len for _ in range(n_seq + abc.n_cons)]

    rank_of = graph.node_id_to_msa_rank
    for i in range(2, graph.node_n):
        nd = graph.node[i]
        rank = int(rank_of[i])
        for aid in nd.aligned_node_id:
            rank = max(rank, int(rank_of[aid]))
        # scatter base to rows of reads holding this node's out edges
        # (ref abpoa_set_msa_seq :103-120)
        for mask in nd.read_ids:
            mm = mask
            while mm:
                low = mm & -mm
                read_id = low.bit_length() - 1
                msa[read_id][rank - 1] = nd.base
                mm ^= low
    if params.out_cons:
        for cons_i in range(abc.n_cons):
            row = msa[n_seq + cons_i]
            for i in range(abc.cons_len[cons_i]):
                cur_id = abc.cons_node_ids[cons_i][i]
                rank = int(rank_of[cur_id])
                for aid in graph.node[cur_id].aligned_node_id:
                    rank = max(rank, int(rank_of[aid]))
                row[rank - 1] = abc.cons_base[cons_i][i]
    abc.msa_base = msa


def output_rc_msa(ab, params, out) -> None:
    """ref abpoa_output_rc_msa (src/abpoa_output.c:70-101)."""
    abc = ab.cons
    if abc.msa_len <= 0:
        return
    tab = decode_table(params.m)
    for i in range(ab.n_seq):
        name = ab.names[i]
        if name:
            if ab.is_rc[i]:
                out.write(f">{name}_reverse_complement\n")
            else:
                out.write(f">{name}\n")
        else:
            out.write(f">Seq_{i+1}\n")
        out.write(bytes(tab[c] for c in abc.msa_base[i]).decode())
        out.write("\n")
    if params.out_cons:
        for cons_i in range(abc.n_cons):
            out.write(">Consensus_sequence")
            if abc.n_cons > 1:
                out.write(f"_{cons_i+1} ")
                out.write(",".join(str(r) for r in abc.clu_read_ids[cons_i]))
            out.write("\n")
            out.write(bytes(tab[c] for c in abc.msa_base[ab.n_seq + cons_i]).decode())
            out.write("\n")


def output_fx_consensus(ab, params, out) -> None:
    """ref abpoa_output_fx_consensus (src/abpoa_output.c:495-528)."""
    abc = ab.cons
    tab = decode_table(params.m)
    for cons_i in range(abc.n_cons):
        out.write("@Consensus_sequence" if params.out_fq else ">Consensus_sequence")
        if abc.n_cons > 1:
            out.write(f"_{cons_i+1} ")
            out.write(",".join(str(r) for r in abc.clu_read_ids[cons_i]))
        out.write("\n")
        out.write(bytes(tab[c] for c in abc.cons_base[cons_i]).decode())
        out.write("\n")
        if params.out_fq:
            out.write("+Consensus_sequence")
            if abc.n_cons > 1:
                out.write(f"_{cons_i+1} ")
                out.write(",".join(str(r) for r in abc.clu_read_ids[cons_i]))
            out.write("\n")
            out.write("".join(chr(q) for q in abc.cons_phred_score[cons_i]))
            out.write("\n")
