/* Native host-side graph kernels for abpoa_tpu.
 *
 * The POA graph bookkeeping between device DP rounds (topological indexing,
 * band-bound metadata) is O(V+E) but runs once per read per instance; in
 * Python it dominates the host half of the pipeline. These are exact ports
 * of the traversal ORDERS of the reference (which fix output bytes):
 *
 *   topo_sort   — Kahn FIFO BFS keeping aligned ("mismatch bundle") nodes
 *                 adjacent (ref abPOA src/abpoa_graph.c:186-231)
 *   set_remain  — reverse BFS computing the longest remaining path along
 *                 the heaviest out-edge (ref abpoa_graph.c:233-274)
 *   msa_rank    — DFS (LIFO) rank where aligned nodes share one column
 *                 (ref abpoa_graph.c:315-366)
 *
 * Flat CSR layout: xxx_flat holds concatenated adjacency, xxx_off[i] the
 * start of node i's list, count = off[i+1]-off[i]. SRC node id 0, SINK 1.
 * Returns 0 on success, -1 on a broken DAG (cycle / unreachable sink).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define SRC 0
#define SINK 1

int topo_sort(int32_t n,
              const int32_t *out_flat, const int32_t *out_off,
              const int32_t *in_cnt,
              const int32_t *aligned_flat, const int32_t *aligned_off,
              int32_t *index_to_node, int32_t *node_to_index)
{
    int32_t *indeg = (int32_t *)malloc(sizeof(int32_t) * n);
    int32_t *queue = (int32_t *)malloc(sizeof(int32_t) * n);
    if (!indeg || !queue) { free(indeg); free(queue); return -1; }
    memcpy(indeg, in_cnt, sizeof(int32_t) * n);
    int32_t qh = 0, qt = 0, index = 0, rc = -1;
    queue[qt++] = SRC;
    while (qh < qt) {
        int32_t cur = queue[qh++];
        index_to_node[index] = cur;
        node_to_index[cur] = index;
        index++;
        if (cur == SINK) { rc = 0; break; }
        for (int32_t e = out_off[cur]; e < out_off[cur + 1]; e++) {
            int32_t out = out_flat[e];
            if (--indeg[out] == 0) {
                int ready = 1;
                for (int32_t a = aligned_off[out];
                     a < aligned_off[out + 1]; a++)
                    if (indeg[aligned_flat[a]] != 0) { ready = 0; break; }
                if (!ready) continue;
                queue[qt++] = out;
                for (int32_t a = aligned_off[out];
                     a < aligned_off[out + 1]; a++)
                    queue[qt++] = aligned_flat[a];
            }
        }
    }
    free(indeg); free(queue);
    return rc;
}

int set_remain(int32_t n,
               const int32_t *out_flat, const int32_t *out_off,
               const int32_t *out_w_flat,
               const int32_t *in_flat, const int32_t *in_off,
               const int32_t *out_cnt,
               int32_t *max_remain)
{
    int32_t *outdeg = (int32_t *)malloc(sizeof(int32_t) * n);
    int32_t *queue = (int32_t *)malloc(sizeof(int32_t) * n);
    if (!outdeg || !queue) { free(outdeg); free(queue); return -1; }
    memcpy(outdeg, out_cnt, sizeof(int32_t) * n);
    int32_t qh = 0, qt = 0, rc = -1;
    max_remain[SINK] = -1;
    queue[qt++] = SINK;
    while (qh < qt) {
        int32_t cur = queue[qh++];
        if (cur != SINK) {
            int32_t max_w = -1, max_id = -1;
            for (int32_t e = out_off[cur]; e < out_off[cur + 1]; e++) {
                if (out_w_flat[e] > max_w) {
                    max_w = out_w_flat[e];
                    max_id = out_flat[e];
                }
            }
            max_remain[cur] = max_remain[max_id] + 1;
        }
        if (cur == SRC) { rc = 0; break; }
        for (int32_t e = in_off[cur]; e < in_off[cur + 1]; e++) {
            int32_t in = in_flat[e];
            if (--outdeg[in] == 0)
                queue[qt++] = in;
        }
    }
    free(outdeg); free(queue);
    return rc;
}

int msa_rank(int32_t n,
             const int32_t *out_flat, const int32_t *out_off,
             const int32_t *in_cnt,
             const int32_t *aligned_flat, const int32_t *aligned_off,
             int32_t *rank_out)
{
    int32_t *indeg = (int32_t *)malloc(sizeof(int32_t) * n);
    int32_t *stack = (int32_t *)malloc(sizeof(int32_t) * n);
    if (!indeg || !stack) { free(indeg); free(stack); return -1; }
    memcpy(indeg, in_cnt, sizeof(int32_t) * n);
    for (int32_t i = 0; i < n; i++) rank_out[i] = -1;
    int32_t sp = 0, rank = 0, rc = -1;
    stack[sp++] = SRC;
    while (sp > 0) {
        int32_t cur = stack[--sp];
        if (rank_out[cur] < 0) {
            rank_out[cur] = rank;
            for (int32_t a = aligned_off[cur]; a < aligned_off[cur + 1];
                 a++)
                rank_out[aligned_flat[a]] = rank;
            rank++;
        }
        if (cur == SINK) { rc = 0; break; }
        for (int32_t e = out_off[cur]; e < out_off[cur + 1]; e++) {
            int32_t out = out_flat[e];
            if (--indeg[out] == 0) {
                int ready = 1;
                for (int32_t a = aligned_off[out];
                     a < aligned_off[out + 1]; a++)
                    if (indeg[aligned_flat[a]] != 0) { ready = 0; break; }
                if (!ready) continue;
                stack[sp++] = out;
                rank_out[out] = -1;
                for (int32_t a = aligned_off[out];
                     a < aligned_off[out + 1]; a++) {
                    stack[sp++] = aligned_flat[a];
                    rank_out[aligned_flat[a]] = -1;
                }
            }
        }
    }
    free(indeg); free(stack);
    return rc;
}

/* Reachability mask for a subgraph interval [beg_index, end_index]
 * (ref simd_abpoa_align_sequence_to_subgraph, src/simd_abpoa_align.c
 * :1650-1660): a node is in the window iff reachable from beg via out
 * edges whose endpoints stay inside the interval. Exact port of the
 * forward sweep the Python subgraph_index_map performed row by row. */
int subgraph_reach(int32_t n, int32_t beg_index, int32_t end_index,
                   const int32_t *out_flat, const int32_t *out_off,
                   const int32_t *i2n, const int32_t *n2i,
                   uint8_t *mask_out)
{
    memset(mask_out, 0, (size_t)n);
    mask_out[beg_index] = 1;
    mask_out[end_index] = 1;
    for (int32_t i = beg_index; i < end_index - 1; i++) {
        if (!mask_out[i]) continue;
        int32_t nid = i2n[i];
        for (int32_t e = out_off[nid]; e < out_off[nid + 1]; e++)
            mask_out[n2i[out_flat[e]]] = 1;
    }
    return 0;
}
