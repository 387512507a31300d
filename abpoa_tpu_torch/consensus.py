"""Consensus generation: heaviest bundling + multi-allele clustering.

reference: abPOA src/abpoa_output.c:270-921.
Read-id sets are python-int bitmasks (bit i = read i).
"""
from __future__ import annotations

import dataclasses
import math

from collections import deque

from .params import SRC_NODE_ID, SINK_NODE_ID

NAT_E = 2.718281828459045


@dataclasses.dataclass
class Consensus:
    n_cons: int = 0
    n_seq: int = 0
    msa_len: int = 0
    clu_n_seq: list = dataclasses.field(default_factory=list)
    clu_read_ids: list = dataclasses.field(default_factory=list)  # per cons: list of read ids
    cons_len: list = dataclasses.field(default_factory=list)
    cons_node_ids: list = dataclasses.field(default_factory=list)
    cons_base: list = dataclasses.field(default_factory=list)
    cons_cov: list = dataclasses.field(default_factory=list)
    cons_phred_score: list = dataclasses.field(default_factory=list)
    msa_base: list = dataclasses.field(default_factory=list)  # rows of int codes


def cons_phred_score(n_cov: int, n_seq: int) -> int:
    """ref abpoa_cons_phred_score (src/abpoa_output.c:270-276)."""
    if n_cov > n_seq:
        raise ValueError(f"unexpected n_cov/n_seq ({n_cov}/{n_seq})")
    x = 13.8 * (1.25 * n_cov / n_seq - 0.25)
    p = 1 - 1.0 / (1.0 + math.pow(NAT_E, -x))
    return 33 + int(-10 * math.log10(p) + 0.499)


def cons_phred_table(n_seq: int) -> list:
    """cons_phred_score(n_cov, n_seq) for every n_cov in 0..n_seq."""
    return [cons_phred_score(c, n_seq) for c in range(n_seq + 1)]


def _popcount_and(a: int, b: int) -> int:
    return (a & b).bit_count()


def _clu_weight(cur_read_ids: int, clu_read_ids: int, use_qv: bool,
                read_weight: dict) -> int:
    """ref get_read_ids_clu_weight (src/abpoa_output.c:287-304)."""
    w = _popcount_and(cur_read_ids, clu_read_ids)
    if not use_qv:
        return w
    both = cur_read_ids & clu_read_ids
    for rid, rw in read_weight.items():
        if rw > 0 and (both >> rid) & 1:
            w += rw
    return w


def _consensus_cov(graph, nid: int, clu_read_ids: int) -> int:
    """max(left, right) cluster-masked coverage (ref :306-323)."""
    left_n = right_n = 0
    for in_id in graph.node[nid].in_id:
        innode = graph.node[in_id]
        for j, oid in enumerate(innode.out_id):
            if oid == nid:
                left_n += _popcount_and(innode.read_ids[j], clu_read_ids)
                break
    for rid_mask in graph.node[nid].read_ids:
        right_n += _popcount_and(rid_mask, clu_read_ids)
    return max(left_n, right_n)


def _reverse_bfs_bundle(graph, out_w_fn):
    """Reverse-topological heaviest bundling DP (ref :361-415).

    out_w_fn(node_id, edge_i) gives the edge weight; tie-break: strictly
    greater weight wins, equal weight prefers later out edge with
    score[max_id] <= score[out_id]; src node uses (w, score) lexicographic
    with strict greater.
    """
    n = graph.node_n
    node = graph.node  # bind once (NativeGraph: property with cache check)
    out_degree = [len(nd.out_id) for nd in node]
    score = [0] * n
    max_out_id = [-1] * n
    q = deque([SINK_NODE_ID])
    while q:
        cur = q.popleft()
        if cur == SINK_NODE_ID:
            max_out_id[cur] = -1
            score[cur] = 0
        elif cur == SRC_NODE_ID:
            path_score, path_max_w, max_id = -1, -1, -1
            for i, out_id in enumerate(node[cur].out_id):
                out_w = out_w_fn(cur, i)
                if out_w > path_max_w or (out_w == path_max_w
                                          and score[out_id] > path_score):
                    max_id = out_id
                    path_score = score[out_id]
                    path_max_w = out_w
            max_out_id[cur] = max_id
            break
        else:
            max_w, max_id = -(1 << 62), -1
            for i, out_id in enumerate(node[cur].out_id):
                out_w = out_w_fn(cur, i)
                if max_w < out_w:
                    max_w, max_id = out_w, out_id
                elif max_w == out_w and score[max_id] <= score[out_id]:
                    max_id = out_id
            score[cur] = max_w + score[max_id]
            max_out_id[cur] = max_id
        for in_id in node[cur].in_id:
            out_degree[in_id] -= 1
            if out_degree[in_id] == 0:
                q.append(in_id)
    return max_out_id


def heaviest_bundling(graph, abc: Consensus):
    """single-cluster consensus (ref abpoa_heaviest_bundling :361-415).

    Native fast path: the whole reverse-BFS DP + path walk runs in C on
    the NativeGraph store (pg_cons_hb) — the Python route materializes
    every Node view, which dominated batched consensus time (round-4
    profile: 0.9 s of a 64-instance run)."""
    abc.n_cons = 1
    abc.clu_n_seq = [abc.n_seq]
    abc.clu_read_ids = [list(range(abc.n_seq))]
    h = getattr(graph, "_h", None)
    if h is not None:
        import numpy as np
        from .native import ptr
        n = graph.node_n
        ids = np.empty(n, np.int32)
        covs = np.empty(n, np.int32)
        ln = np.zeros(1, np.int32)
        if graph._lib.pg_cons_hb(h, ptr(ids), ptr(covs), ptr(ln)) != 0:
            raise RuntimeError("pg_cons_hb failed")
        ln = int(ln[0])
        bases = graph.build_csr()["bases"]
        abc.cons_node_ids.append(ids[:ln].tolist())
        abc.cons_base.append(bases[ids[:ln]].tolist())
        cov = covs[:ln].tolist()
        abc.cons_cov.append(cov)
        if ln and max(cov) > abc.n_seq:
            raise ValueError(
                f"unexpected n_cov/n_seq ({max(cov)}/{abc.n_seq})")
        tab = cons_phred_table(abc.n_seq) if ln else []
        abc.cons_phred_score.append([tab[c] for c in cov])
        abc.cons_len.append(ln)
        return
    node = graph.node
    max_out_id = _reverse_bfs_bundle(
        graph, lambda nid, i: node[nid].out_weight[i])
    _set_hb_cons(graph, abc, 0, max_out_id,
                 cov_fn=lambda nid: node[nid].n_read)


def _set_hb_cons(graph, abc: Consensus, cons_i: int, max_out_id, cov_fn):
    node_ids, bases, covs, phreds = [], [], [], []
    cur = max_out_id[SRC_NODE_ID]
    while cur != SINK_NODE_ID:
        node_ids.append(cur)
        bases.append(graph.node[cur].base)
        cov = cov_fn(cur)
        covs.append(cov)
        phreds.append(cons_phred_score(cov, abc.clu_n_seq[cons_i]))
        cur = max_out_id[cur]
    abc.cons_node_ids.append(node_ids)
    abc.cons_base.append(bases)
    abc.cons_cov.append(covs)
    abc.cons_phred_score.append(phreds)
    abc.cons_len.append(len(node_ids))


def multip_heaviest_bundling(graph, params, n_clu: int, clu_read_ids: list,
                             abc: Consensus):
    """per-cluster bundling with masked weights (ref :429-493)."""
    abc.n_cons = n_clu
    abc.clu_n_seq = []
    abc.clu_read_ids = []
    for cons_i in range(n_clu):
        mask = clu_read_ids[cons_i]
        abc.clu_n_seq.append(mask.bit_count())
        ids = [i for i in range(abc.n_seq) if (mask >> i) & 1]
        if len(ids) != abc.clu_n_seq[cons_i]:
            raise RuntimeError("Error in set cluster read ids.")
        abc.clu_read_ids.append(ids)
    for cons_i in range(n_clu):
        mask = clu_read_ids[cons_i]

        def out_w_fn(nid, i, _mask=mask):
            return _clu_weight(graph.node[nid].read_ids[i], _mask,
                               params.use_qv, graph.node[nid].read_weight)

        max_out_id = _reverse_bfs_bundle(graph, out_w_fn)
        _set_hb_cons(graph, abc, cons_i, max_out_id,
                     cov_fn=lambda nid, _m=mask: _consensus_cov(graph, nid, _m))


# ---------------------------------------------------------------------- #
# multi-allele read clustering (ref :550-894)

def _check_iden_read_ids(rc_weight, read_ids, m, pos1, pos2) -> bool:
    """ref abpoa_check_iden_read_ids (src/abpoa_output.c:550-578)."""
    used = [False] * m
    for i in range(m):
        if rc_weight[pos1][i] == 0:
            continue
        found = False
        for j in range(m):
            if used[j] or rc_weight[pos1][i] != rc_weight[pos2][j]:
                continue
            if read_ids[pos1][i] == read_ids[pos2][j]:
                found = True
                used[j] = True
                break
        if not found:
            return False
    return True


def _set_het_columns(graph, params, n_seq: int, min_w: int):
    """collect minimized set of heterozygous MSA columns (ref :731-795).

    returns (het_poss, read_ids, rc_weight) where read_ids[pos][base] is the
    bitmask of reads supporting that base at that column.
    """
    m = params.m
    msa_l = int(graph.node_id_to_msa_rank[SINK_NODE_ID]) - 1
    whole = (1 << n_seq) - 1
    read_ids = [[0] * m for _ in range(msa_l)]
    rc_weight = [[0] * m for _ in range(msa_l)]
    for pos in range(msa_l):
        read_ids[pos][m - 1] = whole
        rc_weight[pos][m - 1] = n_seq
    node_seen = [False] * graph.node_n
    n_branch = [0] * msa_l
    for i in range(2, graph.node_n):
        nd = graph.node[i]
        if len(nd.out_id) < 2:
            continue
        for out_id in nd.out_id:
            if node_seen[out_id]:
                continue
            node_seen[out_id] = True
            out_nd = graph.node[out_id]
            # NB: reference sums n_read once per out edge (quirk kept,
            # ref src/abpoa_output.c:753-755)
            sum_out_w = len(out_nd.out_id) * out_nd.n_read
            if sum_out_w < min_w or sum_out_w > n_seq - min_w:
                continue
            rank = int(graph.node_id_to_msa_rank[out_id])
            n_branch[rank - 1] += 1
            base = out_nd.base
            for mask in out_nd.read_ids:
                rc_weight[rank - 1][base] += mask.bit_count()
                read_ids[rank - 1][base] |= mask
                read_ids[rank - 1][m - 1] ^= mask
            rc_weight[rank - 1][m - 1] -= rc_weight[rank - 1][base]
    het_poss = []
    for rank in range(msa_l):
        if min_w <= rc_weight[rank][m - 1] <= n_seq - min_w:
            n_branch[rank] += 1
        if n_branch[rank] > 1:
            iden = False
            for hp in reversed(het_poss):
                if _check_iden_read_ids(rc_weight, read_ids, m, rank, hp):
                    iden = True
                    break
            if iden:
                continue
            het_poss.append(rank)
    return het_poss, read_ids, rc_weight


def _reassign_hap_by_min_w(clu_haps, clu_size, clu_read_ids, n_clu, min_w,
                           n_het_pos):
    """ref reassign_hap_by_min_w (src/abpoa_output.c:603-631)."""
    n_reassign = 0
    for i in range(n_clu):
        if clu_size[i] >= min_w or clu_size[i] == 0:
            continue
        reassign_i, max_iden = -1, 0
        for j in range(n_clu):
            if clu_size[j] < min_w:
                continue
            n_iden = sum(1 for k in range(n_het_pos)
                         if clu_haps[i][k] == clu_haps[j][k])
            if n_iden > max_iden:
                max_iden, reassign_i = n_iden, j
        if reassign_i >= 0:
            clu_read_ids[reassign_i] |= clu_read_ids[i]
            clu_read_ids[i] = 0
            clu_size[reassign_i] += clu_size[i]
            clu_size[i] = 0
            n_reassign += 1
    return n_clu - n_reassign


def _reassign_max_n_hap1(clu_haps, clu_size, clu_read_ids, n_clu, clu_poss,
                         max_n_cons, n_het_pos):
    """ref reassign_max_n_hap1 (src/abpoa_output.c:633-671)."""
    n_reassign = 0
    for i in range(n_clu):
        if clu_size[i] == 0:
            continue
        if i in clu_poss[:max_n_cons]:
            continue
        reassign_i, max_iden = -1, 0
        for clu_i in clu_poss[:max_n_cons]:
            n_iden = sum(1 for k in range(n_het_pos)
                         if clu_haps[i][k] == clu_haps[clu_i][k])
            if n_iden > max_iden:
                max_iden, reassign_i = n_iden, clu_i
        if reassign_i >= 0:
            clu_read_ids[reassign_i] |= clu_read_ids[i]
            clu_read_ids[i] = 0
            clu_size[reassign_i] += clu_size[i]
            clu_size[i] = 0
            n_reassign += 1
        else:
            clu_size[i] = 0
    return n_clu - n_reassign


def _reassign_max_n_hap(clu_haps, clu_size, clu_read_ids, n_clu, n_het_pos,
                        max_n_cons):
    """ref reassign_max_n_hap (src/abpoa_output.c:682-704)."""
    import sys
    while n_clu > max_n_cons:
        tup = sorted(range(n_clu), key=lambda i: -clu_size[i])
        clu_poss = tup[:max_n_cons]
        new_n_clu = _reassign_max_n_hap1(clu_haps, clu_size, clu_read_ids,
                                         n_clu, clu_poss, max_n_cons,
                                         n_het_pos)
        if new_n_clu == n_clu:
            print(f"[reassign_max_n_hap] {n_clu - max_n_cons} small clusters "
                  "of sequences remain un-assigned.", file=sys.stderr)
            break
        n_clu = new_n_clu
    return n_clu


def _reassign_hap(clu_haps, clu_size, clu_read_ids, n_clu, min_w, max_n_cons,
                  n_het_pos):
    """ref reassign_hap (src/abpoa_output.c:706-727)."""
    new_n_clu = _reassign_hap_by_min_w(clu_haps, clu_size, clu_read_ids,
                                       n_clu, min_w, n_het_pos)
    if new_n_clu > max_n_cons:
        _reassign_max_n_hap(clu_haps, clu_size, clu_read_ids, n_clu,
                            n_het_pos, max_n_cons)
    pos_i = 0
    for i in range(n_clu):
        if clu_size[i] == 0:
            continue
        if i == pos_i:
            pos_i += 1
            continue
        clu_read_ids[pos_i] = clu_read_ids[i]
        clu_size[pos_i] = clu_size[i]
        pos_i += 1
    if pos_i > max_n_cons:
        raise RuntimeError(f"Error: collected {pos_i} clusters.")
    return pos_i


def _collect_clu_hap_read_ids(het_poss, read_ids, n_seq, m, min_w,
                              max_n_cons):
    """group reads by haplotype vector (ref :799-857)."""
    n_het = len(het_poss)
    if n_het == 0:
        return 1, []
    clu_haps = [[0] * n_het, [0] * n_het]
    clu_size = [0, 0]
    clu_read_ids = [0, 0]
    n_clu = 0
    for i in range(n_seq):
        bit = 1 << i
        hap = clu_haps[n_clu]
        for j, hp in enumerate(het_poss):
            for k in range(m):
                if read_ids[hp][k] & bit:
                    hap[j] = k
                    break
        # check_redundent_hap (ref :581-601)
        redundant = False
        for c in range(n_clu - 1, -1, -1):
            if clu_haps[c] == hap:
                clu_size[c] += 1
                clu_read_ids[c] |= bit
                redundant = True
                break
        if not redundant:
            clu_size[n_clu] += 1
            clu_read_ids[n_clu] |= bit
            n_clu += 1
            clu_haps.append([0] * n_het)
            clu_size.append(0)
            clu_read_ids.append(0)
    if n_clu < 2:
        raise RuntimeError(f"# haplotypes: {n_clu}")
    n_clu = _reassign_hap(clu_haps, clu_size, clu_read_ids, n_clu, min_w,
                          max_n_cons, n_het)
    return n_clu, clu_read_ids[:n_clu]


def multip_read_clu(graph, params, n_seq: int):
    """ref abpoa_multip_read_clu (src/abpoa_output.c:861-894)."""
    graph.set_msa_rank()
    min_w = max(1, int(n_seq * params.min_freq))
    het_poss, read_ids, _ = _set_het_columns(graph, params, n_seq, min_w)
    if len(het_poss) < 1:
        return 1, []
    return _collect_clu_hap_read_ids(het_poss, read_ids, n_seq, params.m,
                                     min_w, params.max_n_cons)


def generate_consensus(ab, params):
    """ref abpoa_generate_consensus (src/abpoa_output.c:897-921)."""
    graph = ab.graph
    if graph.is_called_cons:
        return
    if graph.node_n <= 2:
        return
    n_seq = ab.n_seq
    if params.max_n_cons > 1:
        n_clu, clu_read_ids = multip_read_clu(graph, params, n_seq)
    else:
        n_clu, clu_read_ids = 1, []
    abc = ab.cons = Consensus()
    abc.n_seq = n_seq
    if n_clu > 1:
        multip_heaviest_bundling(graph, params, n_clu, clu_read_ids, abc)
    else:
        heaviest_bundling(graph, abc)
    graph.is_called_cons = True
