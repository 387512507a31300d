/* Native POA graph store for abpoa_tpu.
 *
 * Host-side graph bookkeeping between device DP rounds (edge/node storage,
 * CIGAR->DAG fusion, packed-step replay+fusion, traversal kernels, CSR
 * export). The Python POAGraph (graph.py) stays as the always-available
 * oracle; this store mirrors its semantics exactly — including list
 * append/scan ORDER, which fixes traversal orders and hence output bytes
 * (fusion rules: ref abPOA src/abpoa_graph.c:587-676; traversals
 * ref abpoa_graph.c:186-366).
 *
 * Layout: one growable node table; per node growable in/out/aligned
 * adjacency arrays; per out-edge weight and a read-id bitmask of `rn`
 * 64-bit words (grown on demand); per-node (read_id -> weight) pair list
 * (qv mode only). SRC id 0, SINK id 1.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define SRC 0
#define SINK 1

typedef struct {
    int32_t base;
    int32_t n_in, cap_in;
    int32_t n_out, cap_out;
    int32_t n_al, cap_al;
    int32_t n_read;
    int32_t n_rw, cap_rw;
    int32_t *in_ids;
    int32_t *out_ids;
    int32_t *out_w;
    uint64_t *read_ids;   /* [cap_out * pg->rn] */
    int32_t *al_ids;
    int32_t *rw_rid;
    int32_t *rw_w;
} node_t;

typedef struct {
    int32_t n, cap;
    int32_t rn;           /* read-id words per edge */
    node_t *nodes;
} pg_t;

/* ------------------------------------------------------------------ */

static void node_clear(node_t *nd)
{
    free(nd->in_ids); free(nd->out_ids); free(nd->out_w);
    free(nd->read_ids); free(nd->al_ids); free(nd->rw_rid); free(nd->rw_w);
    memset(nd, 0, sizeof(*nd));
}

void *pg_new(void)
{
    pg_t *pg = (pg_t *)calloc(1, sizeof(pg_t));
    if (!pg) return 0;
    pg->cap = 1024;
    pg->nodes = (node_t *)calloc(pg->cap, sizeof(node_t));
    if (!pg->nodes) { free(pg); return 0; }
    pg->n = 2;            /* SRC + SINK */
    pg->rn = 1;
    return pg;
}

void pg_free(void *h)
{
    pg_t *pg = (pg_t *)h;
    if (!pg) return;
    for (int32_t i = 0; i < pg->n; i++) node_clear(&pg->nodes[i]);
    free(pg->nodes);
    free(pg);
}

void pg_reset(void *h)
{
    pg_t *pg = (pg_t *)h;
    for (int32_t i = 0; i < pg->n; i++) node_clear(&pg->nodes[i]);
    pg->n = 2;
    pg->rn = 1;
}

int32_t pg_node_n(void *h) { return ((pg_t *)h)->n; }

int32_t pg_add_node(void *h, int32_t base)
{
    pg_t *pg = (pg_t *)h;
    if (pg->n == pg->cap) {
        int32_t nc = pg->cap * 2;
        node_t *nn = (node_t *)realloc(pg->nodes, nc * sizeof(node_t));
        if (!nn) return -1;
        memset(nn + pg->cap, 0, (nc - pg->cap) * sizeof(node_t));
        pg->nodes = nn;
        pg->cap = nc;
    }
    node_t *nd = &pg->nodes[pg->n];
    memset(nd, 0, sizeof(*nd));
    nd->base = base;
    return pg->n++;
}

/* grow the read-id word count so bit `rid` fits (re-layouts every node's
 * per-edge masks; rare — callers pre-size via pg_ensure_reads) */
static int ensure_rid(pg_t *pg, int32_t rid)
{
    if (rid < pg->rn * 64) return 0;
    int32_t new_rn = pg->rn;
    while (rid >= new_rn * 64) new_rn *= 2;
    for (int32_t i = 0; i < pg->n; i++) {
        node_t *nd = &pg->nodes[i];
        if (nd->cap_out == 0) continue;
        uint64_t *nr = (uint64_t *)calloc((size_t)nd->cap_out * new_rn, 8);
        if (!nr) return -1;
        for (int32_t e = 0; e < nd->n_out; e++)
            memcpy(nr + (size_t)e * new_rn,
                   nd->read_ids + (size_t)e * pg->rn, pg->rn * 8);
        free(nd->read_ids);
        nd->read_ids = nr;
    }
    pg->rn = new_rn;
    return 0;
}

int pg_ensure_reads(void *h, int32_t n_reads)
{
    return n_reads > 0 ? ensure_rid((pg_t *)h, n_reads - 1) : 0;
}

static int grow_i32(int32_t **arr, int32_t *cap, int32_t need)
{
    if (need <= *cap) return 0;
    int32_t nc = *cap ? *cap * 2 : 4;
    while (nc < need) nc *= 2;
    int32_t *na = (int32_t *)realloc(*arr, (size_t)nc * 4);
    if (!na) return -1;
    *arr = na;
    *cap = nc;
    return 0;
}

/* semantics of graph.py add_edge / ref abpoa_add_graph_edge
 * (src/abpoa_graph.c:418-484) */
int32_t pg_add_edge(void *h, int32_t from_id, int32_t to_id,
                    int32_t check_edge, int32_t w, int32_t add_read_id,
                    int32_t add_read_weight, int32_t rid)
{
    pg_t *pg = (pg_t *)h;
    node_t *f = &pg->nodes[from_id];
    int32_t ei = -1;
    if (check_edge) {
        for (int32_t i = 0; i < f->n_out; i++)
            if (f->out_ids[i] == to_id) { f->out_w[i] += w; ei = i; break; }
    }
    if (ei < 0) {
        node_t *t = &pg->nodes[to_id];
        if (grow_i32(&t->in_ids, &t->cap_in, t->n_in + 1)) return -1;
        t->in_ids[t->n_in++] = from_id;
        if (f->n_out + 1 > f->cap_out) {
            int32_t oc = f->cap_out;
            if (grow_i32(&f->out_ids, &f->cap_out, f->n_out + 1)) return -1;
            int32_t tmp = oc;
            if (grow_i32(&f->out_w, &tmp, f->n_out + 1)) return -1;
            uint64_t *nr = (uint64_t *)calloc(
                (size_t)f->cap_out * pg->rn, 8);
            if (!nr) return -1;
            if (f->read_ids) {
                memcpy(nr, f->read_ids, (size_t)f->n_out * pg->rn * 8);
                free(f->read_ids);
            }
            f->read_ids = nr;
        }
        f->out_ids[f->n_out] = to_id;
        f->out_w[f->n_out] = w;
        memset(f->read_ids + (size_t)f->n_out * pg->rn, 0, pg->rn * 8);
        ei = f->n_out++;
    }
    if (add_read_id) {
        if (ensure_rid(pg, rid)) return -1;
        f = &pg->nodes[from_id];  /* ensure_rid re-layouts */
        f->read_ids[(size_t)ei * pg->rn + (rid >> 6)] |=
            1ULL << (rid & 63);
    }
    f->n_read++;
    if (add_read_weight) {
        int32_t j = 0;
        for (; j < f->n_rw; j++)
            if (f->rw_rid[j] == rid) { f->rw_w[j] = w; break; }
        if (j == f->n_rw) {
            if (f->n_rw + 1 > f->cap_rw) {
                int32_t oc = f->cap_rw;
                if (grow_i32(&f->rw_rid, &f->cap_rw, f->n_rw + 1))
                    return -1;
                if (grow_i32(&f->rw_w, &oc, f->n_rw + 1)) return -1;
            }
            f->rw_rid[f->n_rw] = rid;
            f->rw_w[f->n_rw] = w;
            f->n_rw++;
        }
    }
    return ei;
}

int32_t pg_get_aligned_id(void *h, int32_t node_id, int32_t base)
{
    pg_t *pg = (pg_t *)h;
    node_t *nd = &pg->nodes[node_id];
    for (int32_t i = 0; i < nd->n_al; i++)
        if (pg->nodes[nd->al_ids[i]].base == base) return nd->al_ids[i];
    return -1;
}

static int al_push(node_t *nd, int32_t id)
{
    if (grow_i32(&nd->al_ids, &nd->cap_al, nd->n_al + 1)) return -1;
    nd->al_ids[nd->n_al++] = id;
    return 0;
}

/* all-pairs linking, ref src/abpoa_graph.c:377-401 */
int pg_add_aligned(void *h, int32_t node_id, int32_t aligned_id)
{
    pg_t *pg = (pg_t *)h;
    node_t *nd = &pg->nodes[node_id];
    int32_t n0 = nd->n_al;
    for (int32_t i = 0; i < n0; i++) {
        int32_t aid = nd->al_ids[i];
        if (al_push(&pg->nodes[aid], aligned_id)) return -1;
        if (al_push(&pg->nodes[aligned_id], aid)) return -1;
    }
    if (al_push(&pg->nodes[node_id], aligned_id)) return -1;
    if (al_push(&pg->nodes[aligned_id], node_id)) return -1;
    return 0;
}

/* first read -> linear backbone, ref src/abpoa_graph.c:486-502 */
int pg_add_graph_sequence(void *h, const uint8_t *seq, const int32_t *weight,
                          int32_t seq_l, int32_t *q2n, int32_t add_read_id,
                          int32_t add_read_weight, int32_t rid)
{
    int32_t last = SRC;
    for (int32_t i = 0; i < seq_l; i++) {
        int32_t cur = pg_add_node(h, seq[i]);
        if (cur < 0) return -1;
        if (q2n) q2n[i] = cur;
        if (pg_add_edge(h, last, cur, 0, weight[i], add_read_id,
                        add_read_weight, rid) < 0) return -1;
        last = cur;
    }
    return pg_add_edge(h, last, SINK, 0, weight[seq_l - 1], add_read_id,
                       add_read_weight, rid) < 0 ? -1 : 0;
}

/* one fusion op stream item */
static int fuse_match(pg_t *pg, int32_t node_id, int32_t *last_id,
                      int32_t *last_new, int32_t *query_id,
                      const uint8_t *seq, const int32_t *weight,
                      int32_t beg_node_id, int32_t inc_both_ends,
                      int32_t add_rid, int32_t add_rw, int32_t rid,
                      int32_t *q2n)
{
    (*query_id)++;
    int32_t q = *query_id;
    int32_t add = (*last_id != beg_node_id) || inc_both_ends;
    if (pg->nodes[node_id].base != seq[q]) {      /* mismatch bundle */
        int32_t aid = pg_get_aligned_id(pg, node_id, seq[q]);
        if (aid != -1) {
            if (pg_add_edge(pg, *last_id, aid, !*last_new, weight[q],
                            add_rid && add, add_rw, rid) < 0) return -1;
            *last_id = aid; *last_new = 0;
        } else {
            int32_t nid = pg_add_node(pg, seq[q]);
            if (nid < 0) return -1;
            if (pg_add_edge(pg, *last_id, nid, 0, weight[q],
                            add_rid && add, add_rw, rid) < 0) return -1;
            if (pg_add_aligned(pg, node_id, nid)) return -1;
            *last_id = nid; *last_new = 1;
        }
    } else {
        if (pg_add_edge(pg, *last_id, node_id, !*last_new, weight[q],
                        add_rid && add, add_rw, rid) < 0) return -1;
        *last_id = node_id; *last_new = 0;
    }
    if (q2n) q2n[q] = *last_id;
    return 0;
}

static int fuse_ins(pg_t *pg, int32_t len, int32_t *last_id,
                    int32_t *last_new, int32_t *query_id,
                    const uint8_t *seq, const int32_t *weight,
                    int32_t beg_node_id, int32_t inc_both_ends,
                    int32_t add_rid, int32_t add_rw, int32_t rid,
                    int32_t *q2n)
{
    *query_id += len;
    for (int32_t j = len - 1; j >= 0; j--) {
        int32_t q = *query_id - j;
        int32_t nid = pg_add_node(pg, seq[q]);
        if (nid < 0) return -1;
        int32_t add = (*last_id != beg_node_id) || inc_both_ends;
        if (pg_add_edge(pg, *last_id, nid, 0, weight[q], add_rid && add,
                        add_rw, rid) < 0) return -1;
        *last_id = nid; *last_new = 1;
        if (q2n) q2n[q] = nid;
    }
    return 0;
}

/* CIGAR->DAG fusion, semantics of graph.py add_subgraph_alignment
 * (ref abpoa_add_subgraph_alignment src/abpoa_graph.c:596-672).
 * cigar arrays: op (0=M,1=I,2=D,4=S,5=H as cigar.py codes), a = node_id
 * for M, b = length for I/S/H. Caller handles the empty-graph case. */
int pg_add_subgraph_alignment(void *h, int32_t beg_node_id,
                              int32_t end_node_id, const uint8_t *seq,
                              const int32_t *weight, int32_t seq_l,
                              const int32_t *cg_op, const int32_t *cg_a,
                              const int32_t *cg_b, int32_t n_cigar,
                              int32_t *q2n, int32_t rid,
                              int32_t inc_both_ends, int32_t add_rid,
                              int32_t add_rw)
{
    pg_t *pg = (pg_t *)h;
    if (n_cigar == 0) return 0;
    int32_t query_id = -1, last_new = 0, last_id = beg_node_id;
    for (int32_t c = 0; c < n_cigar; c++) {
        int32_t op = cg_op[c];
        if (op == 0) {                       /* CMATCH */
            if (fuse_match(pg, cg_a[c], &last_id, &last_new, &query_id,
                           seq, weight, beg_node_id, inc_both_ends,
                           add_rid, add_rw, rid, q2n)) return -1;
        } else if (op == 1 || op == 4 || op == 5) {  /* CINS/CSOFT/CHARD */
            if (fuse_ins(pg, cg_b[c], &last_id, &last_new, &query_id,
                         seq, weight, beg_node_id, inc_both_ends,
                         add_rid, add_rw, rid, q2n)) return -1;
        }                                    /* CDEL: skip */
    }
    return pg_add_edge(pg, last_id, end_node_id, !last_new,
                       weight[seq_l - 1], add_rid, add_rw, rid) < 0 ? -1 : 0;
}

/* Replay a device backtrack step stream (int64 words op|row<<2|col<<32,
 * stored reversed: steps[0] is the LAST move) and fuse it in the same pass —
 * equivalent to ops/bt_xla.py replay_steps + add_graph_alignment without
 * materializing the cigar. i2n maps dp row -> node id (row0 offset) for
 * the n_rows rows of the sort it came from; -3 on a row outside them. */
static int fuse_walk(pg_t *pg, const int32_t *i2n, int32_t row0,
                     int32_t n_rows, const int64_t *steps, int32_t nsteps,
                     int32_t best_j, int32_t end_j, int32_t qlen,
                     const uint8_t *seq, const int32_t *weight, int32_t rid,
                     int32_t add_rid, int32_t add_rw, int32_t inc_both_ends,
                     int32_t beg_node_id, int32_t end_node_id)
{
    if (nsteps == 0 && end_j <= 0 && best_j >= qlen) return 0;
    int32_t query_id = -1, last_new = 0, last_id = beg_node_id;
    if (end_j > 0) {
        if (fuse_ins(pg, end_j, &last_id, &last_new, &query_id, seq,
                     weight, beg_node_id, inc_both_ends, add_rid, add_rw,
                     rid, 0)) return -1;
    }
    for (int32_t k = nsteps - 1; k >= 0; k--) {
        int64_t enc = steps[k];
        int32_t op = (int32_t)(enc & 3);
        if (op == 0) {
            int64_t row = row0 + ((enc >> 2) & 0x3FFFFFFF);
            if (row >= n_rows) return -3;
            if (fuse_match(pg, i2n[row], &last_id, &last_new, &query_id,
                           seq, weight, beg_node_id, inc_both_ends,
                           add_rid, add_rw, rid, 0)) return -1;
        } else if (op == 1) {
            if (fuse_ins(pg, 1, &last_id, &last_new, &query_id, seq,
                         weight, beg_node_id, inc_both_ends, add_rid,
                         add_rw, rid, 0)) return -1;
        }                                    /* op 2 = D: skip */
    }
    if (best_j < qlen) {
        if (fuse_ins(pg, qlen - best_j, &last_id, &last_new, &query_id,
                     seq, weight, beg_node_id, inc_both_ends, add_rid,
                     add_rw, rid, 0)) return -1;
    }
    return pg_add_edge(pg, last_id, end_node_id, !last_new,
                       weight[qlen - 1], add_rid, add_rw, rid) < 0 ? -1 : 0;
}

/* fuse_walk over the rows of a sort of the graph as it stands */
int pg_fuse_steps(void *h, const int32_t *i2n, int32_t row0,
                  const int64_t *steps, int32_t nsteps, int32_t best_j,
                  int32_t end_j, int32_t qlen, const uint8_t *seq,
                  const int32_t *weight, int32_t rid, int32_t add_rid,
                  int32_t add_rw, int32_t inc_both_ends,
                  int32_t beg_node_id, int32_t end_node_id)
{
    pg_t *pg = (pg_t *)h;
    return fuse_walk(pg, i2n, row0, pg->n, steps, nsteps, best_j, end_j,
                     qlen, seq, weight, rid, add_rid, add_rw, inc_both_ends,
                     beg_node_id, end_node_id);
}

/* ------------------------------------------------------------------ */
/* traversal kernels over the native store (same orders as hostgraph.c,
 * ref src/abpoa_graph.c:186-366) */

/* BFS toposort with aligned-node grouping into caller scratch indeg and
 * queue (n entries each: every node is queued once) */
static int topo_order(pg_t *pg, int32_t *index_to_node,
                      int32_t *node_to_index, int32_t *indeg,
                      int32_t *queue)
{
    int32_t n = pg->n;
    for (int32_t i = 0; i < n; i++) indeg[i] = pg->nodes[i].n_in;
    int32_t qh = 0, qt = 0, index = 0;
    queue[qt++] = SRC;
    while (qh < qt) {
        int32_t cur = queue[qh++];
        index_to_node[index] = cur;
        node_to_index[cur] = index;
        index++;
        if (cur == SINK) return 0;
        node_t *nd = &pg->nodes[cur];
        for (int32_t e = 0; e < nd->n_out; e++) {
            int32_t out = nd->out_ids[e];
            if (--indeg[out] == 0) {
                node_t *od = &pg->nodes[out];
                int ready = 1;
                for (int32_t a = 0; a < od->n_al; a++)
                    if (indeg[od->al_ids[a]] != 0) { ready = 0; break; }
                if (!ready) continue;
                queue[qt++] = out;
                for (int32_t a = 0; a < od->n_al; a++)
                    queue[qt++] = od->al_ids[a];
            }
        }
    }
    return -1;
}

int pg_topo_sort(void *h, int32_t *index_to_node, int32_t *node_to_index)
{
    pg_t *pg = (pg_t *)h;
    int32_t *indeg = (int32_t *)malloc(4 * (size_t)pg->n);
    int32_t *queue = (int32_t *)malloc(4 * (size_t)pg->n);
    int rc = -1;
    if (indeg && queue)
        rc = topo_order(pg, index_to_node, node_to_index, indeg, queue);
    free(indeg); free(queue);
    return rc;
}

/* The device loop's host replay of one instance, rounds r0..r1-1 (round
 * r is read r + 1; read 0 is already in the graph), in one call: per
 * round the toposort into scratch, the steps16 wire stream decoded into
 * scratch step words and fused by fuse_walk. A wire half is op | dj<<2 |
 * di<<3 in push order, di the topo-row decrement from the previous
 * emission (the first's from M_BI), so step k's row is M_BI less the
 * di of steps 0..k (ops/steps.py unpack_steps16). Columns need no
 * decode: fusion counts query bases itself.
 * meta: int32 rows (M_NSTEPS, M_BI, M_BJ, M_ENDJ, M_BEST), round r's at
 * meta + 5 * r; s16: round r's stream at s16 + (r - r0) * s16_stride,
 * `cap` halves fetched; seqs / weights: the reads of rounds r0..r1-1
 * back to back, round r's at off[r - r0] .. off[r - r0 + 1] (off[0] =
 * 0); weights NULL for unit weights.
 * Stops before a round the caller must take itself: a stream past the
 * fetch cap, or under amb_strand a score below the ambiguous-strand
 * threshold (ref abpoa_align.c:315). Returns the first round not
 * fused; -1 on allocation failure, -2 on a failed toposort, -3 on a
 * step row outside the graph. */
int32_t pg_replay_loop(void *h, int32_t r0, int32_t r1, const int32_t *meta,
                       const int16_t *s16, int64_t s16_stride, int32_t cap,
                       const uint8_t *seqs, const int32_t *weights,
                       const int64_t *off, int32_t add_rid, int32_t add_rw,
                       int32_t amb_strand, int32_t max_mat)
{
    pg_t *pg = (pg_t *)h;
    int32_t ncap = 0, scap = 0, r = r0, rc = 0;
    int32_t *i2n = 0, *n2i = 0, *indeg = 0, *queue = 0, *ones = 0;
    int64_t *steps = 0;
    if (!weights) {
        int64_t wn = 1;
        for (int32_t t = r0; t < r1; t++)
            if (off[t - r0 + 1] - off[t - r0] > wn)
                wn = off[t - r0 + 1] - off[t - r0];
        ones = (int32_t *)malloc(4 * (size_t)wn);
        if (!ones) return -1;
        for (int64_t q = 0; q < wn; q++) ones[q] = 1;
    }
    for (; r < r1; r++) {
        const int32_t *m = meta + 5 * (size_t)r;
        int32_t nst = m[0], bi = m[1], bj = m[2], end_j = m[3];
        int32_t qlen = (int32_t)(off[r - r0 + 1] - off[r - r0]);
        if (amb_strand) {
            int64_t span = qlen < pg->n - 2 ? qlen : pg->n - 2;
            if ((double)m[4] < (double)(span * max_mat) * .3333) break;
        }
        if (nst > cap) break;
        if (pg->n > ncap) {
            ncap = 2 * pg->n;
            free(i2n); free(n2i); free(indeg); free(queue);
            i2n = (int32_t *)malloc(4 * (size_t)ncap);
            n2i = (int32_t *)malloc(4 * (size_t)ncap);
            indeg = (int32_t *)malloc(4 * (size_t)ncap);
            queue = (int32_t *)malloc(4 * (size_t)ncap);
            if (!i2n || !n2i || !indeg || !queue) { rc = -1; break; }
        }
        if (nst > scap) {
            scap = 2 * nst;
            free(steps);
            steps = (int64_t *)malloc(8 * (size_t)scap);
            if (!steps) { rc = -1; break; }
        }
        if (topo_order(pg, i2n, n2i, indeg, queue)) { rc = -2; break; }
        const int16_t *st = s16 + (int64_t)(r - r0) * s16_stride;
        int64_t row = bi;
        for (int32_t k = 0; k < nst; k++) {
            uint16_t raw = (uint16_t)st[k];
            row -= (raw >> 3) & 0x1FFF;
            steps[k] = (int64_t)(raw & 3) | ((row & 0x3FFFFFFF) << 2);
        }
        rc = fuse_walk(pg, i2n, 0, pg->n, steps, nst, bj, end_j, qlen,
                       seqs + off[r - r0],
                       weights ? weights + off[r - r0] : ones, r + 1,
                       add_rid, add_rw, 1, SRC, SINK);
        if (rc) break;
    }
    free(i2n); free(n2i); free(indeg); free(queue); free(ones); free(steps);
    return rc ? rc : r;
}

int pg_set_remain(void *h, int32_t *max_remain)
{
    pg_t *pg = (pg_t *)h;
    int32_t n = pg->n;
    int32_t *outdeg = (int32_t *)malloc(4 * (size_t)n);
    int32_t *queue = (int32_t *)malloc(4 * (size_t)n);
    if (!outdeg || !queue) { free(outdeg); free(queue); return -1; }
    for (int32_t i = 0; i < n; i++) outdeg[i] = pg->nodes[i].n_out;
    int32_t qh = 0, qt = 0, rc = -1;
    max_remain[SINK] = -1;
    queue[qt++] = SINK;
    while (qh < qt) {
        int32_t cur = queue[qh++];
        node_t *nd = &pg->nodes[cur];
        if (cur != SINK) {
            int32_t max_w = -1, max_id = -1;
            for (int32_t e = 0; e < nd->n_out; e++)
                if (nd->out_w[e] > max_w) {
                    max_w = nd->out_w[e];
                    max_id = nd->out_ids[e];
                }
            max_remain[cur] = max_remain[max_id] + 1;
        }
        if (cur == SRC) { rc = 0; break; }
        for (int32_t e = 0; e < nd->n_in; e++)
            if (--outdeg[nd->in_ids[e]] == 0)
                queue[qt++] = nd->in_ids[e];
    }
    free(outdeg); free(queue);
    return rc;
}

int pg_msa_rank(void *h, int32_t *rank_out)
{
    pg_t *pg = (pg_t *)h;
    int32_t n = pg->n;
    int32_t *indeg = (int32_t *)malloc(4 * (size_t)n);
    int32_t *stack = (int32_t *)malloc(4 * (size_t)n);
    if (!indeg || !stack) { free(indeg); free(stack); return -1; }
    for (int32_t i = 0; i < n; i++) {
        indeg[i] = pg->nodes[i].n_in;
        rank_out[i] = -1;
    }
    int32_t sp = 0, rank = 0, rc = -1;
    stack[sp++] = SRC;
    while (sp > 0) {
        int32_t cur = stack[--sp];
        node_t *nd = &pg->nodes[cur];
        if (rank_out[cur] < 0) {
            rank_out[cur] = rank;
            for (int32_t a = 0; a < nd->n_al; a++)
                rank_out[nd->al_ids[a]] = rank;
            rank++;
        }
        if (cur == SINK) { rc = 0; break; }
        for (int32_t e = 0; e < nd->n_out; e++) {
            int32_t out = nd->out_ids[e];
            if (--indeg[out] == 0) {
                node_t *od = &pg->nodes[out];
                int ready = 1;
                for (int32_t a = 0; a < od->n_al; a++)
                    if (indeg[od->al_ids[a]] != 0) { ready = 0; break; }
                if (!ready) continue;
                stack[sp++] = out;
                rank_out[out] = -1;
                for (int32_t a = 0; a < od->n_al; a++) {
                    stack[sp++] = od->al_ids[a];
                    rank_out[od->al_ids[a]] = -1;
                }
            }
        }
    }
    free(indeg); free(stack);
    return rc;
}

/* ------------------------------------------------------------------ */
/* exports */

int32_t pg_rn(void *h) { return ((pg_t *)h)->rn; }

void pg_counts(void *h, int64_t *n_out_edges, int64_t *n_al_entries,
               int64_t *n_rw_pairs)
{
    pg_t *pg = (pg_t *)h;
    int64_t eo = 0, al = 0, rw = 0;
    for (int32_t i = 0; i < pg->n; i++) {
        eo += pg->nodes[i].n_out;
        al += pg->nodes[i].n_al;
        rw += pg->nodes[i].n_rw;
    }
    *n_out_edges = eo;
    *n_al_entries = al;
    *n_rw_pairs = rw;
}

/* flat CSR snapshot (same layout graph.py build_csr produces) */
void pg_export_csr(void *h, int32_t *bases, int32_t *out_cnt,
                   int32_t *in_cnt, int32_t *out_off, int32_t *in_off,
                   int32_t *out_flat, int32_t *out_w_flat, int32_t *in_flat,
                   int32_t *al_off, int32_t *al_flat)
{
    pg_t *pg = (pg_t *)h;
    int32_t n = pg->n;
    int32_t oo = 0, io = 0, ao = 0;
    for (int32_t i = 0; i < n; i++) {
        node_t *nd = &pg->nodes[i];
        bases[i] = nd->base;
        out_cnt[i] = nd->n_out;
        in_cnt[i] = nd->n_in;
        out_off[i] = oo;
        in_off[i] = io;
        al_off[i] = ao;
        memcpy(out_flat + oo, nd->out_ids, 4 * (size_t)nd->n_out);
        memcpy(out_w_flat + oo, nd->out_w, 4 * (size_t)nd->n_out);
        memcpy(in_flat + io, nd->in_ids, 4 * (size_t)nd->n_in);
        memcpy(al_flat + ao, nd->al_ids, 4 * (size_t)nd->n_al);
        oo += nd->n_out;
        io += nd->n_in;
        ao += nd->n_al;
    }
    out_off[n] = oo;
    in_off[n] = io;
    al_off[n] = ao;
}

/* per-edge read-id masks ([n_out_edges, rn] words, edge order == CSR
 * out_flat order), per-node n_read, and (node, rid, w) read-weight pairs */
void pg_export_aux(void *h, uint64_t *read_ids, int32_t *n_read,
                   int32_t *rw_node, int32_t *rw_rid, int32_t *rw_w)
{
    pg_t *pg = (pg_t *)h;
    int32_t rn = pg->rn;
    size_t e = 0;
    int64_t rw = 0;
    for (int32_t i = 0; i < pg->n; i++) {
        node_t *nd = &pg->nodes[i];
        n_read[i] = nd->n_read;
        if (nd->n_out)
            memcpy(read_ids + e * rn, nd->read_ids,
                   (size_t)nd->n_out * rn * 8);
        e += nd->n_out;
        for (int32_t j = 0; j < nd->n_rw; j++, rw++) {
            rw_node[rw] = i;
            rw_rid[rw] = nd->rw_rid[j];
            rw_w[rw] = nd->rw_w[j];
        }
    }
}

int32_t pg_node_base(void *h, int32_t id)
{
    return ((pg_t *)h)->nodes[id].base;
}

/* Heaviest-bundling consensus, single cluster (the default -d1 path):
 * reverse-topological DP picking each node's heaviest out edge, then
 * the SRC->SINK walk along the picks. Port of consensus.py
 * _reverse_bfs_bundle/_set_hb_cons (ref abpoa_heaviest_bundling,
 * src/abpoa_output.c:361-415) — the Python twin stays the readable
 * fallback and the multi-allele (-d>=2) implementation.
 * Outputs: cons_ids / covs (caller-sized >= n), *len_out. covs carry
 * n_read (the unit-weight coverage the default path uses). */
int pg_cons_hb(void *h, int32_t *cons_ids, int32_t *covs,
               int32_t *len_out)
{
    pg_t *pg = (pg_t *)h;
    int32_t n = pg->n;
    int32_t *outdeg = (int32_t *)malloc(4 * (size_t)n);
    int32_t *queue = (int32_t *)malloc(4 * (size_t)n);
    int32_t *max_out = (int32_t *)malloc(4 * (size_t)n);
    int64_t *score = (int64_t *)malloc(8 * (size_t)n);
    if (!outdeg || !queue || !max_out || !score) {
        free(outdeg); free(queue); free(max_out); free(score);
        return -1;
    }
    for (int32_t i = 0; i < n; i++) {
        outdeg[i] = pg->nodes[i].n_out;
        max_out[i] = -1;
        score[i] = 0;
    }
    int32_t qh = 0, qt = 0, rc = -1;
    queue[qt++] = SINK;
    while (qh < qt) {
        int32_t cur = queue[qh++];
        node_t *nd = &pg->nodes[cur];
        if (cur == SRC) {
            int64_t path_score = -1, path_max_w = -1;
            int32_t max_id = -1;
            for (int32_t i = 0; i < nd->n_out; i++) {
                int32_t oid = nd->out_ids[i];
                int64_t w = nd->out_w[i];
                if (w > path_max_w
                        || (w == path_max_w && score[oid] > path_score)) {
                    max_id = oid;
                    path_score = score[oid];
                    path_max_w = w;
                }
            }
            max_out[cur] = max_id;
            rc = 0;
            break;
        } else if (cur != SINK) {
            int64_t max_w = INT64_MIN;
            int32_t max_id = -1;
            for (int32_t i = 0; i < nd->n_out; i++) {
                int32_t oid = nd->out_ids[i];
                int64_t w = nd->out_w[i];
                if (max_w < w) {
                    max_w = w; max_id = oid;
                } else if (max_w == w && score[max_id] <= score[oid]) {
                    max_id = oid;
                }
            }
            score[cur] = max_w + score[max_id];
            max_out[cur] = max_id;
        }
        for (int32_t e = 0; e < nd->n_in; e++)
            if (--outdeg[nd->in_ids[e]] == 0)
                queue[qt++] = nd->in_ids[e];
    }
    int32_t len = 0;
    if (rc == 0) {
        int32_t cur = max_out[SRC];
        while (cur != SINK && cur >= 0 && len < n) {
            cons_ids[len] = cur;
            covs[len] = pg->nodes[cur].n_read;
            len++;
            cur = max_out[cur];
        }
        if (cur != SINK) rc = -1;
    }
    *len_out = len;
    free(outdeg); free(queue); free(max_out); free(score);
    return rc;
}
