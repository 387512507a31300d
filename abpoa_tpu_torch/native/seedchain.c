/* Native minimizer sketch + anchor chaining for abpoa_tpu.
 *
 * Exact ports of the SEMANTICS of seed.py (which is the golden-verified
 * transcription of ref abPOA src/abpoa_seed.c): the (w,k)
 * minimizer queue (mm_sketch :84-223), the sorted-bucket merge-join
 * (collect_anchors1 :331-364), and the two-level DP chaining
 * (abpoa_dp_chaining :485-577 + get_chain_score :467-480 +
 * abpoa_dp_chaining_of_local_chains :385-464). Anchors determine the
 * windowed alignments and hence output bytes, so every tie-break, the
 * ilog2(0) == -1 quirk, the double->int truncation, and the reference's
 * strand-from-wrong-index quirk (:553) are preserved bit-for-bit.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static const int8_t LOG_TABLE256_INIT = 0;
static int8_t LogTable256[256];
static int log_table_ready = 0;

static void init_log_table(void)
{
    if (log_table_ready) return;
    LogTable256[0] = -1;
    LogTable256[1] = 0;
    for (int i = 2; i < 256; i++)
        LogTable256[i] = 1 + LogTable256[i / 2];
    log_table_ready = 1;
    (void)LOG_TABLE256_INIT;
}

static inline int ilog2_32(uint32_t v)
{
    uint32_t t, tt;
    if ((tt = v >> 16))
        return (t = tt >> 8) ? 24 + LogTable256[t] : 16 + LogTable256[tt];
    return (t = v >> 8) ? 8 + LogTable256[t] : LogTable256[v];
}

static inline uint64_t hash64(uint64_t key, uint64_t mask)
{
    key = (~key + (key << 21)) & mask;
    key = key ^ key >> 24;
    key = ((key + (key << 3)) + (key << 8)) & mask;
    key = key ^ key >> 14;
    key = ((key + (key << 2)) + (key << 4)) & mask;
    key = key ^ key >> 28;
    key = (key + (key << 31)) & mask;
    return key;
}

typedef struct { uint64_t x, y; } mm128_t;

/* (w,k)-minimizer sketch; returns the number of (x,y) pairs written.
 * out arrays must hold at least 2*len + 16 entries. */
int64_t sc_sketch(const uint8_t *seq, int32_t len, int32_t w, int32_t k,
                  int32_t rid, int32_t both_strand, int32_t aa,
                  uint64_t *out_x, uint64_t *out_y)
{
    int bits = aa ? 5 : 2;
    int shift1 = bits * (k - 1);
    uint64_t mask = (1ULL << (bits * k)) - 1;
    uint64_t kmer[2] = {0, 0};
    mm128_t buf[256];
    mm128_t mn = {UINT64_MAX, UINT64_MAX};
    int amb = aa ? 26 : 4;
    int32_t i, j, l = 0, buf_pos = 0, min_pos = 0;
    int64_t n = 0;
    for (i = 0; i < w; i++) {
        buf[i].x = UINT64_MAX;
        buf[i].y = UINT64_MAX;
    }
    for (i = 0; i < len; i++) {
        int c = seq[i];
        mm128_t info = {UINT64_MAX, UINT64_MAX};
        if (c < amb) {
            int kmer_span = l + 1 < k ? l + 1 : k;
            int z;
            if (both_strand && !aa) {
                kmer[0] = ((kmer[0] << 2) | c) & mask;
                kmer[1] = (kmer[1] >> 2) | ((uint64_t)(3 ^ c) << shift1);
                if (kmer[0] == kmer[1])
                    continue;       /* ref :116 skips the window update */
                z = kmer[0] < kmer[1] ? 0 : 1;
            } else {
                kmer[0] = ((kmer[0] << bits) | c) & mask;
                z = 0;
            }
            l++;
            if (l >= k && kmer_span < 256) {
                info.x = (hash64(kmer[z], mask) << 8) | kmer_span;
                info.y = ((uint64_t)rid << 32) | ((uint64_t)i << 1) | z;
            }
        } else {
            l = 0;
        }
        buf[buf_pos] = info;
        if (l == w + k - 1 && mn.x != UINT64_MAX) {
            for (j = buf_pos + 1; j < w; j++)
                if (mn.x == buf[j].x && buf[j].y != mn.y) {
                    out_x[n] = buf[j].x; out_y[n] = buf[j].y; n++;
                }
            for (j = 0; j < buf_pos; j++)
                if (mn.x == buf[j].x && buf[j].y != mn.y) {
                    out_x[n] = buf[j].x; out_y[n] = buf[j].y; n++;
                }
        }
        if (info.x <= mn.x) {
            if (l >= w + k && mn.x != UINT64_MAX) {
                out_x[n] = mn.x; out_y[n] = mn.y; n++;
            }
            mn = info;
            min_pos = buf_pos;
        } else if (buf_pos == min_pos) {
            if (l >= w + k - 1 && mn.x != UINT64_MAX) {
                out_x[n] = mn.x; out_y[n] = mn.y; n++;
            }
            mn.x = UINT64_MAX; mn.y = UINT64_MAX;
            for (j = buf_pos + 1; j < w; j++)
                if (mn.x >= buf[j].x) { mn = buf[j]; min_pos = j; }
            for (j = 0; j <= buf_pos; j++)
                if (mn.x >= buf[j].x) { mn = buf[j]; min_pos = j; }
            if (l >= w + k - 1 && mn.x != UINT64_MAX) {
                for (j = buf_pos + 1; j < w; j++)
                    if (mn.x == buf[j].x && mn.y != buf[j].y) {
                        out_x[n] = buf[j].x; out_y[n] = buf[j].y; n++;
                    }
                for (j = 0; j <= buf_pos; j++)
                    if (mn.x == buf[j].x && mn.y != buf[j].y) {
                        out_x[n] = buf[j].x; out_y[n] = buf[j].y; n++;
                    }
            }
        }
        if (++buf_pos == w) buf_pos = 0;
    }
    if (mn.x != UINT64_MAX) {
        out_x[n] = mn.x; out_y[n] = mn.y; n++;
    }
    return n;
}

static int cmp_u64(const void *a, const void *b)
{
    uint64_t x = *(const uint64_t *)a, y = *(const uint64_t *)b;
    return x < y ? -1 : x > y ? 1 : 0;
}

/* merge-join of two x-sorted minimizer buckets -> sorted anchor list.
 * Returns the anchor count; out must hold t_n * q_n worst case — the
 * caller bounds it (callers pass a cap and we stop there, returning -1
 * on overflow). */
int64_t sc_collect_anchors(const uint64_t *tx, const uint64_t *ty,
                           int64_t t_n, const uint64_t *qx,
                           const uint64_t *qy, int64_t q_n, int32_t qlen,
                           int32_t k, uint64_t *out, int64_t cap)
{
    int64_t i = 0, j = 0, n = 0;
    while (i < t_n && j < q_n) {
        uint64_t xi = tx[i], xj = qx[j];
        if (xi == xj) {
            int64_t _i = i, _j = j;
            for (_i = i; _i < t_n && tx[_i] == xi; _i++) {
                uint64_t yi = ty[_i];
                for (_j = j; _j < q_n && qx[_j] == xj; _j++) {
                    uint64_t yj = qy[_j];
                    uint64_t a;
                    if ((yi & 1) == (yj & 1))
                        a = (((yi & 0xFFFFFFFFULL) >> 1) << 32)
                            | ((yj & 0xFFFFFFFFULL) >> 1);
                    else
                        a = (1ULL << 63)
                            | (((yi & 0xFFFFFFFFULL) >> 1) << 32)
                            | (uint64_t)(qlen
                                         - (((yj & 0xFFFFFFFFULL) >> 1)
                                            + 1 - k) - 1);
                    if (n >= cap) return -1;
                    out[n++] = a;
                }
            }
            i = _i; j = _j;
        } else if (xi < xj) {
            i++;
        } else {
            j++;
        }
    }
    qsort(out, n, 8, cmp_u64);
    return n;
}

/* ---------------- two-level DP chaining ---------------- */

static inline int get_chain_score(int max_bw, int64_t i_qpos,
                                  int64_t i_tpos, int64_t j_qpos,
                                  int64_t j_tpos, int k, int32_t *sc)
{
    init_log_table();
    int64_t dq = i_qpos - j_qpos, dt = i_tpos - j_tpos;
    int64_t min_d = dq < dt ? dq : dt;
    if (k < min_d) min_d = k;
    int64_t dtq = dq > dt ? dq - dt : dt - dq;
    if (dtq > max_bw) return 0;
    *sc = (int32_t)(min_d - ((ilog2_32((uint32_t)dtq) >> 1)
                             + dtq * 0.01 * k));
    return 1;
}

static int32_t get_local_chain_score(int64_t j_end_tpos, int64_t j_end_qpos,
                                     int64_t i_end_anchor_i,
                                     const uint64_t *anchors,
                                     const int64_t *pre_id,
                                     const int32_t *score)
{
    int64_t i = i_end_anchor_i;
    while (i != -1) {
        int64_t i_tpos = (anchors[i] >> 32) & 0x7FFFFFFF;
        int64_t i_qpos = anchors[i] & 0xFFFFFFFFULL;
        if (i_tpos <= j_end_tpos && i_qpos <= j_end_qpos) break;
        i = pre_id[i];
    }
    if (i == -1) return score[i_end_anchor_i];
    return score[i_end_anchor_i] - score[i];
}

typedef struct { uint64_t x, y; int64_t ord; } chain_t;

static int cmp_chain_x(const void *a, const void *b)
{
    const chain_t *p = (const chain_t *)a, *q = (const chain_t *)b;
    if (p->x != q->x) return p->x < q->x ? -1 : 1;
    return p->ord < q->ord ? -1 : (p->ord > q->ord ? 1 : 0);  /* stable */
}

static int64_t chain_local_chains(const chain_t *lc, int64_t n,
                                  const uint64_t *anchors,
                                  const int32_t *score,
                                  const int64_t *pre_id, uint64_t *par,
                                  int32_t min_w, int32_t tlen,
                                  int32_t qlen)
{
    if (n == 0) return 0;
    int32_t *chain_score = (int32_t *)malloc(4 * (size_t)n);
    int64_t *pre_chain = (int64_t *)malloc(8 * (size_t)n);
    if (!chain_score || !pre_chain) {
        free(chain_score); free(pre_chain); return -1;
    }
    int64_t gmax_i = -1, st = 0, i, j;
    int32_t gmax = INT32_MIN;
    for (i = 0; i < n; i++) {
        uint64_t ix = lc[i].x, iy = lc[i].y;
        uint64_t istrand = ix >> 63;
        int64_t i_end_qpos = ix & 0xFFFFFFFFULL;
        int64_t i_end_anchor = iy >> 32;
        int64_t i_start_anchor = iy & 0xFFFFFFFFULL;
        int64_t i_start_tpos = (anchors[i_start_anchor] >> 32) & 0x7FFFFFFF;
        int64_t i_start_qpos = anchors[i_start_anchor] & 0xFFFFFFFFULL;
        int64_t max_j = -1;
        int32_t max_score = score[i_end_anchor];
        while (st < i) {
            if ((lc[st].x >> 63) != istrand) st++;
            else break;
        }
        for (j = i - 1; j >= st; j--) {
            uint64_t jx = lc[j].x;
            int64_t j_end_tpos = (jx >> 32) & 0x7FFFFFFF;
            int64_t j_end_qpos = jx & 0xFFFFFFFFULL;
            int32_t s1;
            if (j_end_qpos >= i_end_qpos) continue;
            if (i_start_tpos > j_end_tpos && i_start_qpos > j_end_qpos)
                s1 = chain_score[j] + score[i_end_anchor];
            else
                s1 = chain_score[j]
                    + get_local_chain_score(j_end_tpos, j_end_qpos,
                                            i_end_anchor, anchors,
                                            pre_id, score);
            if (s1 > max_score) { max_score = s1; max_j = j; }
        }
        chain_score[i] = max_score;
        pre_chain[i] = max_j;
        if (max_score > gmax) { gmax = max_score; gmax_i = i; }
    }
    int64_t n_out = 0;
    if (gmax_i >= 0) {
        int64_t cur_i = gmax_i, pre_i = pre_chain[gmax_i];
        uint64_t cur_y = lc[cur_i].y;
        int64_t last_tpos = tlen, last_qpos = qlen;
        while (pre_i != -1) {
            uint64_t pre_x = lc[pre_i].x, pre_y = lc[pre_i].y;
            int64_t pre_end_tpos = (pre_x >> 32) & 0x7FFFFFFF;
            int64_t pre_end_qpos = pre_x & 0xFFFFFFFFULL;
            i = (int64_t)(cur_y >> 32);
            while (i != -1) {
                int64_t ct = (anchors[i] >> 32) & 0x7FFFFFFF;
                int64_t cq = anchors[i] & 0xFFFFFFFFULL;
                if (ct > pre_end_tpos && cq > pre_end_qpos) {
                    if (last_tpos - ct >= min_w && last_qpos - cq >= min_w) {
                        par[n_out++] = anchors[i];
                        last_tpos = ct; last_qpos = cq;
                    }
                } else {
                    break;
                }
                i = pre_id[i];
            }
            cur_i = pre_i;
            pre_i = pre_chain[pre_i];
            cur_y = pre_y;
        }
        i = (int64_t)(cur_y >> 32);
        while (i != -1) {
            int64_t ct = (anchors[i] >> 32) & 0x7FFFFFFF;
            int64_t cq = anchors[i] & 0xFFFFFFFFULL;
            if (last_tpos - ct >= min_w && last_qpos - cq >= min_w) {
                par[n_out++] = anchors[i];
                last_tpos = ct; last_qpos = cq;
            }
            i = pre_id[i];
        }
        /* reverse into partition order */
        for (j = 0; j < n_out / 2; j++) {
            uint64_t tmp = par[j];
            par[j] = par[n_out - 1 - j];
            par[n_out - 1 - j] = tmp;
        }
    }
    free(chain_score);
    free(pre_chain);
    return n_out;
}

/* two-level DP chaining over sorted anchors. par must hold n_a entries.
 * Returns number of partition anchors appended (or -1 on malloc fail). */
int64_t sc_dp_chaining(const uint64_t *anchors, int64_t n_a, int32_t k,
                       int32_t min_w_plus_k, int32_t tlen, int32_t qlen,
                       uint64_t *par)
{
    if (n_a == 0) return 0;
    const int max_bw = 100, max_dis = 100;
    const int max_skip_anchors = 25, max_non_best_anchors = 50;
    const int min_local_chain_score = 100;
    int32_t *score = (int32_t *)malloc(4 * (size_t)n_a);
    int64_t *pre_id = (int64_t *)malloc(8 * (size_t)n_a);
    int64_t *end_pos = (int64_t *)calloc(n_a, 8);
    int8_t *anchor_map = (int8_t *)calloc(n_a, 1);
    chain_t *lc = (chain_t *)malloc(sizeof(chain_t) * (size_t)n_a);
    chain_t *c2 = (chain_t *)malloc(sizeof(chain_t) * (size_t)n_a);
    int64_t i, j, st = 0, n_lc = 0, n_c2 = 0, rc = -1;
    if (!score || !pre_id || !end_pos || !anchor_map || !lc || !c2)
        goto done;
    for (i = 0; i < n_a; i++) {
        uint64_t ia = anchors[i];
        int64_t i_qpos = ia & 0xFFFFFFFFULL;
        int64_t i_tpos = (ia >> 32) & 0x7FFFFFFF;
        uint64_t i_tstrand = ia >> 63;
        int64_t max_j = -1;
        int n_skip = 0, non_best = 0;
        int32_t max_score = k;
        while (st < i) {
            uint64_t st_a = anchors[st];
            if ((st_a >> 63) != i_tstrand
                || (int64_t)((st_a >> 32) & 0x7FFFFFFF) + max_dis < i_tpos)
                st++;
            else
                break;
        }
        for (j = i - 1; j >= st; j--) {
            uint64_t ja = anchors[j];
            int64_t j_qpos = ja & 0xFFFFFFFFULL;
            int64_t j_tpos = (ja >> 32) & 0x7FFFFFFF;
            int32_t _score;
            if (j_qpos >= i_qpos || j_qpos + max_dis < i_qpos) continue;
            if (!get_chain_score(max_bw, i_qpos, i_tpos, j_qpos, j_tpos,
                                 k, &_score))
                continue;
            _score += score[j];
            if (_score > max_score) {
                max_score = _score;
                max_j = j;
                non_best = 0;
                if (n_skip > 0) n_skip--;
            } else if (end_pos[j] == i) {
                if (++n_skip > max_skip_anchors) break;
            } else {
                if (++non_best > max_non_best_anchors) break;
            }
            if (pre_id[j] >= 0) end_pos[pre_id[j]] = i;
        }
        score[i] = max_score;
        pre_id[i] = max_j;
    }

    memset(end_pos, 0, 8 * (size_t)n_a);
    for (i = n_a - 1; i >= 0; i--) {
        if (pre_id[i] >= 0) end_pos[pre_id[i]] = 1;
        if (end_pos[i] == 0 && score[i] >= min_local_chain_score)
            end_pos[i] = 2;
    }
    for (i = 0; i < n_a; i++)
        if (end_pos[i] == 2) {
            lc[n_lc].x = (uint64_t)score[i];
            lc[n_lc].y = (uint64_t)i;
            lc[n_lc].ord = n_lc;
            n_lc++;
        }
    /* sort by (score, then anchor index): entries were built in
     * increasing index order, so the stable comparator matches Python's
     * tuple sort */
    qsort(lc, n_lc, sizeof(chain_t), cmp_chain_x);

    for (i = n_lc - 1; i >= 0; i--) {
        int64_t end_id = (int64_t)lc[i].y;
        int64_t start_id;
        /* reference quirk: strand read from anchors[i] (the local-chain
         * INDEX), not the chain's anchor (ref src/abpoa_seed.c:553) */
        uint64_t strand = anchors[i] >> 63;
        int64_t tpos = (anchors[end_id] >> 32) & 0x7FFFFFFF;
        int64_t qpos = (int64_t)(anchors[end_id] & 0xFFFFFFFFULL);
        j = end_id;
        for (;;) {
            start_id = j;
            anchor_map[j] = 1;
            j = pre_id[j];
            if (!(j >= 0 && anchor_map[j] == 0)) break;
        }
        if (j < 0) {
            c2[n_c2].x = (strand << 63) | ((uint64_t)tpos << 32)
                | (uint64_t)qpos;
            c2[n_c2].y = ((uint64_t)end_id << 32) | (uint64_t)start_id;
            c2[n_c2].ord = n_c2;
            n_c2++;
        }
    }
    qsort(c2, n_c2, sizeof(chain_t), cmp_chain_x);
    rc = chain_local_chains(c2, n_c2, anchors, score, pre_id, par,
                            min_w_plus_k, tlen, qlen);
done:
    free(score); free(pre_id); free(end_pos); free(anchor_map);
    free(lc); free(c2);
    return rc;
}
