"""Minimizer seeding, guide tree, anchor chaining, window partition.

reference: abPOA src/abpoa_seed.c (mm_sketch is minimap2's
(w,k)-minimizer algorithm; chaining is the two-level DP chain described in
the abPOA paper). Behavioral quirks of the reference are kept (noted inline)
since anchors determine the windowed alignments and hence output bytes.

The benchmark's frozen copy: plain Python, no native code.
"""
from __future__ import annotations

import sys

MASK32 = 0xffffffff
MASK64 = 0xffffffffffffffff

_LOG_TABLE256 = [-1, 0] + [1] * 2 + [2] * 4 + [3] * 8 + [4] * 16 + [5] * 32 \
    + [6] * 64 + [7] * 128


def ilog2_32(v: int) -> int:
    if v >> 16:
        return (24 + _LOG_TABLE256[v >> 24]) if v >> 24 \
            else (16 + _LOG_TABLE256[v >> 16])
    return (8 + _LOG_TABLE256[v >> 8]) if v >> 8 else _LOG_TABLE256[v]


def hash64(key: int, mask: int) -> int:
    """minimap2 invertible hash (ref src/abpoa_seed.c:35-45)."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def mm_sketch(seq, length, w, k, rid, both_strand, out, aa=False):
    """(w,k)-minimizer sketch (ref mm_sketch :84-155 / mm_aa_sketch :158-223).

    Appends (x, y) tuples: x = hash<<8|span, y = rid<<32|lastPos<<1|strand.
    Exact transcription incl. the symmetric-k-mer `continue` that skips the
    whole window update (ref :116)."""
    bits = 5 if aa else 2
    shift1 = bits * (k - 1)
    mask = (1 << (bits * k)) - 1
    kmer = [0, 0]
    UMAX = MASK64
    buf = [(UMAX, UMAX)] * w
    mn = (UMAX, UMAX)
    min_pos = 0
    l = 0
    buf_pos = 0
    amb = 26 if aa else 4
    for i in range(length):
        c = int(seq[i])
        info = (UMAX, UMAX)
        if c < amb:
            kmer_span = min(l + 1, k)
            if both_strand and not aa:
                kmer[0] = ((kmer[0] << 2) | c) & mask
                kmer[1] = (kmer[1] >> 2) | ((3 ^ c) << shift1)
                if kmer[0] == kmer[1]:
                    continue  # ref :116 - skips the whole window update
                z = 0 if kmer[0] < kmer[1] else 1
            else:
                kmer[0] = ((kmer[0] << bits) | c) & mask
                z = 0
            l += 1
            if l >= k and kmer_span < 256:
                info = ((hash64(kmer[z], mask) << 8) | kmer_span,
                        (rid << 32) | (i << 1) | z)
        else:
            l = 0
        buf[buf_pos] = info
        if l == w + k - 1 and mn[0] != UMAX:
            for j in range(buf_pos + 1, w):
                if mn[0] == buf[j][0] and buf[j][1] != mn[1]:
                    out.append(buf[j])
            for j in range(buf_pos):
                if mn[0] == buf[j][0] and buf[j][1] != mn[1]:
                    out.append(buf[j])
        if info[0] <= mn[0]:
            if l >= w + k and mn[0] != UMAX:
                out.append(mn)
            mn = info; min_pos = buf_pos
        elif buf_pos == min_pos:
            if l >= w + k - 1 and mn[0] != UMAX:
                out.append(mn)
            mn = (UMAX, UMAX)
            for j in range(buf_pos + 1, w):
                if mn[0] >= buf[j][0]:
                    mn = buf[j]; min_pos = j
            for j in range(buf_pos + 1):
                if mn[0] >= buf[j][0]:
                    mn = buf[j]; min_pos = j
            if l >= w + k - 1 and mn[0] != UMAX:
                for j in range(buf_pos + 1, w):
                    if mn[0] == buf[j][0] and mn[1] != buf[j][1]:
                        out.append(buf[j])
                for j in range(buf_pos + 1):
                    if mn[0] == buf[j][0] and mn[1] != buf[j][1]:
                        out.append(buf[j])
        buf_pos += 1
        if buf_pos == w:
            buf_pos = 0
    if mn[0] != UMAX:
        out.append(mn)


def collect_mm(seqs, seq_lens, n_seq, params):
    """ref abpoa_collect_mm (:690-701): per-read minimizer buckets."""
    if params.verbose > 0:
        print("[abpoa_collect_mm] Collecting minimizers ... ",
              end="", file=sys.stderr)
    mm: list = []
    mm_c = [0]
    for i in range(n_seq):
        if params.m > 5:
            mm_sketch(seqs[i], seq_lens[i], params.w, params.k, i,
                             False, mm, aa=True)
        else:
            mm_sketch(seqs[i], seq_lens[i], params.w, params.k, i,
                             bool(params.amb_strand), mm)
        mm_c.append(len(mm))
    if params.verbose > 0:
        print("done!", file=sys.stderr)
    return mm, mm_c


def build_guide_tree(params, n_seq: int, mm: list, tree_id_map: list):
    """Jaccard-similarity greedy guide tree (ref :231-324).

    Verbose progress messages mirror ref abpoa_seed.c:234,322."""
    if not mm:
        return
    if params.verbose > 0:
        print("[abpoa_build_guide_tree] Building progressive guide tree"
              " ... ", end="", file=sys.stderr)
    tri = [0] * ((n_seq * (n_seq + 1)) >> 1)
    mm_sorted = sorted(mm, key=lambda t: t[0])

    def flush(group):
        cnt = [0] * n_seq
        for x, y in group:
            rid = y >> 32
            cnt[rid] += 1
            tri[((rid * (rid + 1)) >> 1) + rid] += 1
        for r1 in range(n_seq - 1):
            if cnt[r1] == 0:
                continue
            for r2 in range(r1 + 1, n_seq):
                tri[((r2 * (r2 + 1)) >> 1) + r1] += min(cnt[r1], cnt[r2])

    grp = [mm_sorted[0]]
    for item in mm_sorted[1:]:
        if item[0] != grp[-1][0]:
            flush(grp); grp = []
        grp.append(item)
    flush(grp)

    jac_sim = [0.0] * ((n_seq * (n_seq - 1)) >> 1)
    max_jac, max_i, max_j = -1.0, -1, -1
    for i in range(1, n_seq):
        for j in range(i):
            hit = tri[((i * (i + 1)) >> 1) + j]
            tot = tri[((i * (i + 1)) >> 1) + i] \
                + tri[((j * (j + 1)) >> 1) + j] - hit
            jac = 0.0 if tot == 0 else hit / tot
            jac_sim[((i * (i - 1)) >> 1) + j] = jac
            if jac > max_jac:
                max_jac, max_i, max_j = jac, i, j
    tree_id_map[0] = max_j
    tree_id_map[1] = max_i
    n_in = 2
    while n_in < n_seq:
        max_jac, best = -1.0, n_seq
        for r1 in range(n_seq):
            jac = 0.0
            for t in range(n_in):
                r2 = tree_id_map[t]
                if r1 == r2:
                    jac = -1.0
                    break
                lo, hi = min(r1, r2), max(r1, r2)
                jac += jac_sim[((hi * (hi - 1)) >> 1) + lo]
            if jac > max_jac:
                max_jac, best = jac, r1
        if best == n_seq:
            raise RuntimeError("Bug in progressive tree building.")
        tree_id_map[n_in] = best
        n_in += 1
    if params.verbose > 0:
        print("done!", file=sys.stderr)


def collect_anchors(mm: list, mm_c: list, tid: int, qid: int, qlen: int,
                    k: int):
    """merge-join of sorted minimizer buckets (ref collect_anchors1 :331-364).

    mm[mm_c[tid]:mm_c[tid+1]] must already be sorted by x; the qid bucket is
    sorted here (in place), matching the reference's reuse of the sorted
    bucket in the next round.
    """
    mm[mm_c[qid]:mm_c[qid + 1]] = sorted(mm[mm_c[qid]:mm_c[qid + 1]],
                                         key=lambda t: t[0])
    anchors: list[int] = []
    i, j = mm_c[tid], mm_c[qid]
    while i < mm_c[tid + 1] and j < mm_c[qid + 1]:
        xi, xj = mm[i][0], mm[j][0]
        if xi == xj:
            _i = i
            while _i < mm_c[tid + 1] and mm[_i][0] == xi:
                yi = mm[_i][1]
                _j = j
                while _j < mm_c[qid + 1] and mm[_j][0] == xj:
                    yj = mm[_j][1]
                    if (yi & 1) == (yj & 1):
                        a = (((yi & MASK32) >> 1) << 32) | ((yj & MASK32) >> 1)
                    else:
                        a = (1 << 63) | (((yi & MASK32) >> 1) << 32) \
                            | (qlen - (((yj & MASK32) >> 1) + 1 - k) - 1)
                    anchors.append(a)
                    _j += 1
                _i += 1
            i, j = _i, _j
        elif xi < xj:
            i += 1
        else:
            j += 1
    anchors.sort()
    return anchors


def _get_chain_score(max_bw, i_qpos, i_tpos, j_qpos, j_tpos, k):
    """ref get_chain_score (:467-480); returns (ok, score) with the exact
    int/double truncation (incl. ilog2(0) == -1 quirk)."""
    delta_q = i_qpos - j_qpos
    delta_t = i_tpos - j_tpos
    min_d = min(delta_q, delta_t, k)
    delta_tq = abs(delta_q - delta_t)
    if delta_tq > max_bw:
        return False, 0
    score = int(min_d - ((ilog2_32(delta_tq) >> 1) + delta_tq * 0.01 * k))
    return True, score


def _get_local_chain_score(j_end_tpos, j_end_qpos, i_end_anchor_i, anchors,
                           pre_id, score):
    """ref get_local_chain_score (:366-379)."""
    i = i_end_anchor_i
    while i != -1:
        i_tpos = (anchors[i] >> 32) & 0x7fffffff
        i_qpos = anchors[i] & MASK32
        if i_tpos <= j_end_tpos and i_qpos <= j_end_qpos:
            break
        i = pre_id[i]
    if i == -1:
        return score[i_end_anchor_i]
    return score[i_end_anchor_i] - score[i]


def _chain_local_chains(local_chains, anchors, score, pre_id, par_anchors,
                        min_w, tlen, qlen):
    """chain-of-local-chains DP + anchor collection (ref :385-464)."""
    n = len(local_chains)
    chain_score = [0] * n
    pre_chain_id = [0] * n
    gmax, gmax_i = -(1 << 31), -1
    st = 0
    for i in range(n):
        ix, iy = local_chains[i]
        istrand = ix >> 63
        i_end_qpos = ix & MASK32
        i_end_anchor_i = iy >> 32
        i_start_anchor_i = iy & MASK32
        i_start_tpos = (anchors[i_start_anchor_i] >> 32) & 0x7fffffff
        i_start_qpos = anchors[i_start_anchor_i] & MASK32
        max_j, max_score = -1, score[i_end_anchor_i]
        while st < i:
            if (local_chains[st][0] >> 63) != istrand:
                st += 1
            else:
                break
        for j in range(i - 1, st - 1, -1):
            jx = local_chains[j][0]
            j_end_tpos = (jx >> 32) & 0x7fffffff
            j_end_qpos = jx & MASK32
            if j_end_qpos >= i_end_qpos:
                continue
            if i_start_tpos > j_end_tpos and i_start_qpos > j_end_qpos:
                s1 = chain_score[j] + score[i_end_anchor_i]
            else:
                s1 = chain_score[j] + _get_local_chain_score(
                    j_end_tpos, j_end_qpos, i_end_anchor_i, anchors, pre_id,
                    score)
            if s1 > max_score:
                max_score, max_j = s1, j
        chain_score[i] = max_score
        pre_chain_id[i] = max_j
        if max_score > gmax:
            gmax, gmax_i = max_score, i
    if gmax_i < 0:
        return
    out = []
    cur_i, pre_i = gmax_i, pre_chain_id[gmax_i]
    cur_y = local_chains[cur_i][1]
    last_tpos, last_qpos = tlen, qlen
    while pre_i != -1:
        pre_x, pre_y = local_chains[pre_i]
        pre_end_tpos = (pre_x >> 32) & 0x7fffffff
        pre_end_qpos = pre_x & MASK32
        i = cur_y >> 32
        while i != -1:
            cur_tpos = (anchors[i] >> 32) & 0x7fffffff
            cur_qpos = anchors[i] & MASK32
            if cur_tpos > pre_end_tpos and cur_qpos > pre_end_qpos:
                if last_tpos - cur_tpos >= min_w \
                        and last_qpos - cur_qpos >= min_w:
                    out.append(anchors[i])
                    last_tpos, last_qpos = cur_tpos, cur_qpos
            else:
                break
            i = pre_id[i]
        cur_i, pre_i, cur_y = pre_i, pre_chain_id[pre_i], pre_y
    i = cur_y >> 32
    while i != -1:
        cur_tpos = (anchors[i] >> 32) & 0x7fffffff
        cur_qpos = anchors[i] & MASK32
        if last_tpos - cur_tpos >= min_w and last_qpos - cur_qpos >= min_w:
            out.append(anchors[i])
            last_tpos, last_qpos = cur_tpos, cur_qpos
        i = pre_id[i]
    par_anchors.extend(reversed(out))


def dp_chaining(anchors: list, par_anchors: list, params, tlen: int,
                qlen: int):
    """two-level DP chaining (ref abpoa_dp_chaining :485-577)."""
    n_a = len(anchors)
    if n_a == 0:
        return
    score = [0] * n_a
    pre_id = [0] * n_a
    end_pos = [0] * n_a
    max_bw, max_dis = 100, 100
    max_skip_anchors, max_non_best_anchors = 25, 50
    min_local_chain_score = 100
    min_w = params.min_w + params.k
    st = 0
    for i in range(n_a):
        ia = anchors[i]
        i_qpos = ia & MASK32
        i_tpos = (ia >> 32) & 0x7fffffff
        i_tstrand = ia >> 63
        max_j, n_skip, non_best, max_score = -1, 0, 0, params.k
        while st < i:
            st_a = anchors[st]
            if (st_a >> 63) != i_tstrand \
                    or ((st_a >> 32) & 0x7fffffff) + max_dis < i_tpos:
                st += 1
            else:
                break
        for j in range(i - 1, st - 1, -1):
            ja = anchors[j]
            j_qpos = ja & MASK32
            j_tpos = (ja >> 32) & 0x7fffffff
            if j_qpos >= i_qpos or j_qpos + max_dis < i_qpos:
                continue
            ok, _score = _get_chain_score(max_bw, i_qpos, i_tpos, j_qpos,
                                          j_tpos, params.k)
            if not ok:
                continue
            _score += score[j]
            if _score > max_score:
                max_score, max_j = _score, j
                non_best = 0
                if n_skip > 0:
                    n_skip -= 1
            elif end_pos[j] == i:
                n_skip += 1
                if n_skip > max_skip_anchors:
                    break
            else:
                non_best += 1
                if non_best > max_non_best_anchors:
                    break
            if pre_id[j] >= 0:
                end_pos[pre_id[j]] = i
        score[i] = max_score
        pre_id[i] = max_j

    end_pos = [0] * n_a
    for i in range(n_a - 1, -1, -1):
        if pre_id[i] >= 0:
            end_pos[pre_id[i]] = 1
        if end_pos[i] == 0 and score[i] >= min_local_chain_score:
            end_pos[i] = 2
    # local chains as (x=score, y=end_anchor_index), sorted by x
    local_chains = [(score[i], i) for i in range(n_a) if end_pos[i] == 2]
    local_chains.sort(key=lambda t: t[0])
    n_lc = len(local_chains)

    anchor_map = [0] * n_a
    chains2 = []
    for i in range(n_lc - 1, -1, -1):
        j = local_chains[i][1]
        end_id = j
        # NB reference quirk: strand read from anchors[i] (the local-chain
        # INDEX), not from the chain's anchor (ref src/abpoa_seed.c:553)
        strand = anchors[i] >> 63
        tpos = (anchors[j] >> 32) & 0x7fffffff
        qpos = anchors[j] & MASK32
        while True:
            start_id = j
            anchor_map[j] = 1
            j = pre_id[j]
            if not (j >= 0 and anchor_map[j] == 0):
                break
        if j < 0:
            chains2.append(((strand << 63) | (tpos << 32) | qpos,
                            (end_id << 32) | start_id))
    chains2.sort(key=lambda t: t[0])
    _chain_local_chains(chains2, anchors, score, pre_id, par_anchors, min_w,
                        tlen, qlen)


def build_guide_tree_partition(seqs, seq_lens, params):
    """ref abpoa_build_guide_tree_partition (:704-745)."""
    n_seq = len(seqs)
    read_id_map = list(range(n_seq))
    mm, mm_c = collect_mm(seqs, seq_lens, n_seq, params)
    if params.progressive_poa and n_seq > 2:
        build_guide_tree(params, n_seq, list(mm), read_id_map)
    par_anchors: list[int] = []
    par_c = [0] * n_seq
    if params.disable_seeding or n_seq < 2:
        return read_id_map, par_anchors, par_c
    tid = read_id_map[0]
    mm[mm_c[tid]:mm_c[tid + 1]] = sorted(mm[mm_c[tid]:mm_c[tid + 1]],
                                         key=lambda t: t[0])
    par_c[0] = 0
    for i in range(1, n_seq):
        tid = read_id_map[i - 1]
        qid = read_id_map[i]
        anchors = collect_anchors(mm, mm_c, tid, qid, seq_lens[qid],
                                  params.k)
        dp_chaining(anchors, par_anchors, params, seq_lens[tid],
                    seq_lens[qid])
        par_c[i] = len(par_anchors)
    return read_id_map, par_anchors, par_c
