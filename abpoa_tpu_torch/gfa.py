"""GFA emission and graph restore (GFA / gapped-FASTA MSA).

reference: abPOA src/abpoa_output.c:169-268 (emit),
           abPOA src/abpoa_seq.c:303-660 (restore).
"""
from __future__ import annotations

from collections import deque

from .alphabet import decode_table, encode_table
from .consensus import generate_consensus
from .params import SRC_NODE_ID, SINK_NODE_ID


def generate_gfa(ab, params, out) -> None:
    """ref abpoa_generate_gfa (src/abpoa_output.c:169-268)."""
    graph = ab.graph
    if graph.node_n <= 2:
        return
    n_seq = ab.n_seq
    tab = decode_table(params.m)
    in_degree = [len(nd.in_id) for nd in graph.node]
    read_paths: list[list[int]] = [[] for _ in range(n_seq)]

    nl = sum(len(graph.node[i].in_id) for i in range(2, graph.node_n))
    out.write(f"H\tVN:Z:1.0\tNS:i:{graph.node_n-2}\t"
              f"NL:i:{nl - len(graph.node[SRC_NODE_ID].out_id)}\t"
              f"NP:i:{n_seq + int(params.out_cons)}\n")

    q = deque([SRC_NODE_ID])
    while q:
        cur = q.popleft()
        if cur == SINK_NODE_ID:
            break
        if cur != SRC_NODE_ID:
            nd = graph.node[cur]
            out.write(f"S\t{cur-1}\t{chr(tab[nd.base])}\n")
            for pre_id in nd.in_id:
                if pre_id != SRC_NODE_ID:
                    out.write(f"L\t{pre_id-1}\t+\t{cur-1}\t+\t0M\n")
            for mask in nd.read_ids:
                mm = mask
                while mm:
                    low = mm & -mm
                    read_paths[low.bit_length() - 1].append(cur - 1)
                    mm ^= low
        for out_id in graph.node[cur].out_id:
            in_degree[out_id] -= 1
            if in_degree[out_id] == 0:
                q.append(out_id)

    for i in range(n_seq):
        name = ab.names[i] if ab.names[i] else str(i + 1)
        out.write(f"P\t{name}\t")
        path = read_paths[i]
        if ab.is_rc[i]:
            out.write(",".join(f"{nid}-" for nid in reversed(path)))
        else:
            out.write(",".join(f"{nid}+" for nid in path))
        out.write("\t*\n")
    if params.out_cons:
        generate_consensus(ab, params)
        abc = ab.cons
        for cons_i in range(abc.n_cons):
            out.write("P\tConsensus_sequence")
            if abc.n_cons > 1:
                out.write(f"_{cons_i+1}")
            out.write("\t")
            out.write(",".join(f"{nid-1}+"
                               for nid in abc.cons_node_ids[cons_i]))
            out.write("\t*\n")


# ---------------------------------------------------------------------- #
# restore (-i): GFA S/P lines or gapped-FASTA MSA -> live graph

def _parse_fa_seq(ab, params, seq: str, name: str, p_i: int,
                  rank2node_id: dict):
    """ref abpoa_fa_parse_seq (src/abpoa_seq.c:559-593)."""
    graph = ab.graph
    add_read_id = params.use_read_ids
    tab = encode_table(params.m)
    last_id = SRC_NODE_ID
    for i, ch in enumerate(seq):
        if ch == "-":
            continue
        base = int(tab[ord(ch)])
        cur_id = rank2node_id.get(i, 0)
        if cur_id == 0:
            cur_id = graph.add_node(base)
            rank2node_id[i] = cur_id
        elif graph.node[cur_id].base != base:
            aln_id = graph.get_aligned_id(cur_id, base)
            if aln_id == -1:
                aln_id = graph.add_node(base)
                graph.add_aligned_node(cur_id, aln_id)
            cur_id = aln_id
        graph.add_edge(last_id, cur_id, True, 1, add_read_id, False, p_i)
        last_id = cur_id
    graph.add_edge(last_id, SINK_NODE_ID, True, 1, add_read_id, False, p_i)
    ab.names.append(name)
    ab.is_rc.append(0)
    ab.n_seq += 1


def _parse_gfa_P(ab, params, segs: dict, seg_in_id: dict, seg_out_id: dict,
                 p_i: int, line: str):
    """ref abpoa_gfa_parse_P (src/abpoa_seq.c:454-557)."""
    graph = ab.graph
    add_read_id = params.use_read_ids
    tab = encode_table(params.m)
    toks = line.split("\t")
    path_name = toks[1]
    path = toks[2]
    is_rc = -1
    last_id, next_id = SRC_NODE_ID, SINK_NODE_ID
    for seg in path.split(","):
        orient = seg[-1]
        seg_name = seg[:-1]
        if seg_name not in segs:
            raise ValueError(f"seg ({seg_name}) not exist.")
        seg_seq = segs[seg_name]
        if orient == "+":
            if is_rc == 1:
                raise ValueError(f"path has both + and - segs ({path_name})")
            is_rc = 0
            if seg_name not in seg_in_id:
                in_id = out_id = -1
                for i, ch in enumerate(seg_seq):
                    nid = graph.add_node(int(tab[ord(ch)]))
                    if i == 0:
                        in_id = nid
                    out_id = nid
                seg_in_id[seg_name] = in_id
                seg_out_id[seg_name] = out_id
            else:
                in_id = seg_in_id[seg_name]
                out_id = seg_out_id[seg_name]
            graph.add_edge(last_id, in_id, True, 1, add_read_id, False, p_i)
            for i in range(out_id - in_id):
                graph.add_edge(in_id + i, in_id + i + 1, True, 1, add_read_id,
                               False, p_i)
            last_id = out_id
        else:
            if is_rc == 0:
                raise ValueError(f"path has both + and - segs ({path_name})")
            is_rc = 1
            if seg_name not in seg_in_id:
                in_id = out_id = -1
                for i, ch in enumerate(seg_seq):
                    nid = graph.add_node(int(tab[ord(ch)]))
                    if i == 0:
                        in_id = nid
                    out_id = nid
                seg_in_id[seg_name] = in_id
                seg_out_id[seg_name] = out_id
            else:
                in_id = seg_in_id[seg_name]
                out_id = seg_out_id[seg_name]
            graph.add_edge(out_id, next_id, True, 1, add_read_id, False, p_i)
            for i in range(out_id - in_id):
                graph.add_edge(in_id + i, in_id + i + 1, True, 1, add_read_id,
                               False, p_i)
            next_id = in_id
    if is_rc:
        graph.add_edge(SRC_NODE_ID, next_id, True, 1, add_read_id, False, p_i)
    else:
        graph.add_edge(last_id, SINK_NODE_ID, True, 1, add_read_id, False, p_i)
    ab.names.append(path_name)
    ab.is_rc.append(is_rc)
    ab.n_seq += 1


def restore_graph(ab, params):
    """ref abpoa_restore_graph (src/abpoa_seq.c:595-660)."""
    import gzip
    import sys
    fn = params.incr_fn
    if fn is None:
        return
    opener = gzip.open if fn.endswith(".gz") else open
    segs: dict[str, str] = {}
    seg_in_id: dict[str, int] = {}
    seg_out_id: dict[str, int] = {}
    p_i = -1
    is_fa = False
    rank2node_id: dict[int, int] = {}
    fa_name = None
    fa_seq: list[str] = []
    with opener(fn, "rt") as fp:
        for line in fp:
            line = line.rstrip("\n")
            if is_fa:
                if line.startswith(">"):
                    if fa_seq:
                        _parse_fa_seq(ab, params, "".join(fa_seq), fa_name,
                                      p_i, rank2node_id)
                        fa_seq = []
                    fa_name = line[1:].split()[0] if len(line) > 1 else ""
                    p_i += 1
                else:
                    fa_seq.append(line)
            else:
                if line.startswith(">"):
                    fa_name = line[1:].split()[0] if len(line) > 1 else ""
                    is_fa = True
                    p_i += 1
                elif line.startswith("S"):
                    toks = line.split("\t")
                    if len(toks) < 3 or toks[1] in segs:
                        raise ValueError(f"bad S line: {line}")
                    segs[toks[1]] = toks[2]
                elif line.startswith("P"):
                    p_i += 1
                    _parse_gfa_P(ab, params, segs, seg_in_id, seg_out_id,
                                 p_i, line)
    if is_fa and (fa_seq or fa_name is not None):
        _parse_fa_seq(ab, params, "".join(fa_seq), fa_name, p_i, rank2node_id)
    if ab.n_seq == 0:
        print(f"[restore_graph] Warning: no graph/sequence restored from "
              f"file '{fn}'.", file=sys.stderr)
    g = ab.graph
    g.is_called_cons = g.is_set_msa_rank = g.is_topological_sorted = False
