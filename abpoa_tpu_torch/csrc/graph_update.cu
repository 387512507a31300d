// One round's graph update on the packed state, one CUDA block per POA
// instance: fusion of the steps16 stream, Kahn FIFO re-sort with aligned
// grouping, max_remain.
//
// Replaces the TPU kernel make_graph_kernel2 behind graph_update_packed
// (abpoa_tpu/ops/poa_loop.py:840, :1530), both of its bodies, as the two
// instances of one template:
//   WM = 0, unit weights: out-edge entries are 16-bit halves
//     id | w<<(16-wbits), every resolving edge adds 1;
//   WM = 1, qv weights: out-edge entries are full words id | w<<16, and
//     the edge from the node of query base q (and the last base's edge
//     into the sink) adds the per-base weight qw[q], read from 16-bit
//     halves two per word like the query codes (ref weight[q] per
//     resolving edge, native/poagraph.c pg_add_graph_sequence).
// Plain PyTorch version: abpoa_tpu_torch/ops/graph_update.py
// graph_update_packed_ref (vectorized fusion, queue sort, pointer
// doubling); the two are held bit-equal on the card.
//
// Semantics: ref src/abpoa_graph.c:596-672 (native/poagraph.c
// pg_fuse_steps), :186-231 (Kahn FIFO with aligned grouping), :233-274
// (max_remain: heaviest out-edge, first max; remain[SINK] = -1).
//
// What bounds it on an H100: latency. An instance's state is a few tens
// to a few hundred KB and its work a few thousand steps and nodes, far
// below the card's byte and operation rates; what costs is chains of
// dependent loads. The state has two residencies, the template
// parameter GL:
//   GL = false: the instance's packed state is staged in shared memory
//     (copied in, and back IN PLACE, by the whole block: the counterpart
//     of the JAX kernel's input_output_aliases), where it fits one
//     block's 227 KB (ops/graph_update.py smem_bytes);
//   GL = true: the kernel works on the packed state in global memory in
//     place (the wrapper's in/out aliases; an instance's state stays in
//     L1 and the 50 MB L2); shared memory keeps the in-degrees, the
//     queue (which doubles as the scans' scratch), both topo maps (the
//     pointer-doubling buffers), the step stream and the query
//     (global_smem_bytes: 84,500 bytes in WM 0 and 91,668 in WM 1 at
//     R = 4096, reads of 3,276 bp). This is the residency past the
//     shared-memory bound, up to R = 4096: at the default band, qv reads
//     of 1.9-3.3 kb, unit weights 2.55-3.3 kb. Every write of the fusion
//     comes after the capacity check's barrier, so a failed fusion leaves
//     the global state as it was; every phase reads the state its
//     barrier closed, as in shared memory (global writes of a block are
//     visible to the whole block after __syncthreads). It costs 1.02-1.03x
//     the shared-memory residency at R = 1024 (chip_smoke.py phase 4c,
//     H100 80GB HBM3, 700 W): the state stays in the SM's L1.
// Either way the design takes every chain that is not inherently serial
// off the one thread:
//   * fusion is data parallel over the steps, on the route of the plain
//     version: each step's topo row and query index come from a block
//     scan of the row deltas and of the resolving steps; every step
//     resolves against the pre-fusion state; new node ids come from a
//     second scan; the resolving steps, numbered by query index, are the
//     edges SRC -> r0 -> r1 -> ... -> SINK, and each edge (weight bump or
//     new edge) and each aligned bundle is applied by its own thread.
//     This equals the serial replay because a round's alignment is a
//     path through the sorted pre-fusion graph: it visits a node at most
//     once and never two nodes of one aligned group (the sort accepts no
//     path between aligned nodes), so each node is the from-node of one
//     edge, the to-node of one and in at most one bundle, and no step
//     reads a list that an earlier step of the round changed.
//     Capacities are checked on the pre-fusion state before anything is
//     written, so a failed fusion leaves the graph and node_n as they
//     were (as the plain version does);
//   * max_remain by pointer doubling over the heaviest-out-edge forest
//     (ceil(log2 R) rounds of the whole block);
//   * the Kahn sort stays a FIFO on one thread (its order is the
//     reference's). A pop costs some 400 cycles of dependent loads,
//     selects and branches, so the block first finds the graph's fast
//     runs (pointer doubling again): chains of links u -> v where u has
//     one out-edge and v one in-edge and no aligned list. When the queue
//     is empty after popping a run's node, the FIFO pops the rest of the
//     run node after node, each queueing the next, so the sort queues it
//     whole from the run list and goes on at its last node. Other pops
//     keep the next node's words in registers (loaded a pop ahead from
//     the queue, or taken from the first node pushed) and load an
//     out-node's in-degree and control word together. The pops write only
//     the queue, from which the block builds both topo maps afterwards.
// Per-step scratch (each resolving step's node) lives in a global
// workspace the wrapper allocates, so the shared-memory formula
// (ops/graph_update.py smem_bytes) is the serial kernel's. Blocks are
// independent instances and run in any order.
#include <cuda_runtime.h>

#include "layout.cuh"

namespace abpoa {
namespace {

constexpr int NT = 512;        // threads a block
constexpr int NW = NT / 32;    // warps a block
// a resolving step's scratch word: node id | new << 16 | bundled << 17
constexpr int RES_NEW = 1 << 16, RES_BUNDLE = 1 << 17;

struct GraphArgs {
  const int* misc;      // [B, M_NMISC] from the band DP
  const int* qlen;      // [B]
  const int* node_n;    // [B]
  const int* fail;      // [B]
  const int* i2nn_in;   // [B, R] topo maps the DP ran with
  const int* s16w;      // [B, LS2] steps16 wire words
  const int* qp4;       // [B, Wq4] query codes, 4 per word
  const int* qw;        // [B, Wq2] per-base weights, 2 per word (WM 1)
  int* ctrl;            // [B, R]       updated in place
  int* outp;            // [B, R*E/2] (WM 0) or [B, R*E] (WM 1), in place
  int* inp;             // [B, R*P/2]   updated in place
  int* alp;             // [B, R*A2]    updated in place
  int* i2nn_out;        // [B, R]
  int* node_n_out;      // [B]
  int* fail_out;        // [B]
  int* work;            // [B, 4*LS2] scratch: res, bundle node by step
  int R, E, P, A, LS2, Wq4, Wq2, wbits;
};

// out-edge words per node: E/2 halves (WM 0) or E full words (WM 1)
template <int WM>
__host__ __device__ int out_words(int E) { return WM ? E : E / 2; }

__device__ __forceinline__ int half_get(const int* arr, int word, int k) {
  return (int)(((unsigned)arr[word] >> (16 * (k & 1))) & 0xFFFFu);
}
__device__ __forceinline__ void half_set(int* arr, int word, int k, int val) {
  const unsigned sh = 16 * (k & 1);
  const unsigned w = (unsigned)arr[word];
  arr[word] = (int)((w & ~(0xFFFFu << sh)) | (((unsigned)val & 0xFFFFu)
                                               << sh));
}
__device__ __forceinline__ int n_out_of(int cw) { return (cw >> 3) & 15; }
__device__ __forceinline__ int n_al_of(int cw) { return (cw >> 7) & 7; }
__device__ __forceinline__ int n_in_of(int cw) { return (cw >> 10) & 15; }

template <int WM>
struct Graph {
  int *ctrl, *outp, *inp, *alp;
  int E, OE, P2, A2, IDB, IDM;

  __device__ int out_id(int u, int e) const {
    if (WM) return outp[u * E + e] & H16;
    return half_get(outp, u * OE + (e >> 1), e) & IDM;
  }
  __device__ int out_w(int u, int e) const {
    if (WM) return (int)((unsigned)outp[u * E + e] >> 16);
    return half_get(outp, u * OE + (e >> 1), e) >> IDB;
  }
  // the out-slot of u that holds an edge to v, or -1
  __device__ int find_out(int u, int v) const {
    const int no = n_out_of(ctrl[u]);
    for (int e = 0; e < no; ++e)
      if (out_id(u, e) == v) return e;
    return -1;
  }
  __device__ int al_at(int u, int a) const {
    return half_get(alp, u * A2 + (a >> 1), a);
  }
  // += wv to edge (u, e)'s weight (wv is 1 in WM 0)
  __device__ void out_bump(int u, int e, int wv) {
    if (WM) {
      outp[u * E + e] += wv << 16;
      return;
    }
    const int word = u * OE + (e >> 1);
    half_set(outp, word, e, half_get(outp, word, e) + (1 << IDB));
  }
  __device__ void out_new(int u, int e, int to, int wv) {
    if (WM)
      outp[u * E + e] = to | (wv << 16);
    else
      half_set(outp, u * OE + (e >> 1), e, to | (1 << IDB));
  }
};

// the weight of 0-based query base q: 1 in WM 0, qw[q] in WM 1
template <int WM>
__device__ __forceinline__ int qweight(const int* s_qw, int Wq2, int q) {
  if (!WM) return 1;
  return (int)(((unsigned)s_qw[min(q >> 1, Wq2 - 1)] >> (16 * (q & 1)))
               & 0xFFFFu);
}

// the code of 0-based query base q (the codes sit at 1..qlen)
__device__ __forceinline__ int qbase(const int* s_qp4, int Wq4, int q) {
  const int c = q + 1;
  return ((unsigned)s_qp4[min(c >> 2, Wq4 - 1)] >> (8 * (c & 3))) & 0xFF;
}

// exclusive block-wide scan of two counts a thread (tmp: 2*(NW+1) ints
// of shared memory); returns the prefixes, *tot the block's sums
__device__ int2 block_scan2(int2 x, int* tmp, int2* tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int2 inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int p = __shfl_up_sync(~0u, inc.x, o);
    const int q = __shfl_up_sync(~0u, inc.y, o);
    if (lane >= o) {
      inc.x += p;
      inc.y += q;
    }
  }
  if (lane == 31) {
    tmp[2 * w] = inc.x;
    tmp[2 * w + 1] = inc.y;
  }
  __syncthreads();
  if (w == 0) {
    const int2 t = lane < NW ? make_int2(tmp[2 * lane], tmp[2 * lane + 1])
                             : make_int2(0, 0);
    int2 ti = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int p = __shfl_up_sync(~0u, ti.x, o);
      const int q = __shfl_up_sync(~0u, ti.y, o);
      if (lane >= o) {
        ti.x += p;
        ti.y += q;
      }
    }
    if (lane < NW) {
      tmp[2 * lane] = ti.x - t.x;
      tmp[2 * lane + 1] = ti.y - t.y;
    }
    if (lane == NW - 1) {
      tmp[2 * NW] = ti.x;
      tmp[2 * NW + 1] = ti.y;
    }
  }
  __syncthreads();
  const int2 r = make_int2(tmp[2 * w] + inc.x - x.x,
                           tmp[2 * w + 1] + inc.y - x.y);
  *tot = make_int2(tmp[2 * NW], tmp[2 * NW + 1]);
  __syncthreads();   // tmp is free again
  return r;
}

// pointer doubling over words nxt | d << 16 (d counts hops; SINK-like
// roots point at themselves with d = 0) in ceil(log2 R) rounds between
// two R-word buffers; after it each word holds the root and the hops to
// it. Returns the buffer that holds the result (the other is free).
__device__ int* pointer_double(int* src, int* dst, int R) {
  for (int lg = 1; lg < R; lg <<= 1) {
    __syncthreads();
    for (int u = threadIdx.x; u < R; u += NT) {
      const unsigned w = (unsigned)src[u];
      const unsigned w2 = (unsigned)src[w & 0xFFFFu];
      dst[u] = (int)((w2 & 0xFFFFu) + ((w & ~0xFFFFu) + (w2 & ~0xFFFFu)));
    }
    int* t = src;
    src = dst;
    dst = t;
  }
  __syncthreads();
  return src;
}

// n ints from src to dst by the whole block (int4 where both are
// 16-byte aligned)
__device__ void block_copy(int* dst, const int* src, int n) {
  int i0 = 0;
  if ((((size_t)dst | (size_t)src) & 15) == 0) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += NT)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
    i0 = 4 * n4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += NT) dst[i] = src[i];
}

// forward step t of the round: op (0 M, 1 I, 2 D) and row delta; lead
// and tail steps are insertions
struct Step {
  int op, delta;
};
__device__ __forceinline__ Step step_at(const int* s_steps, int LS, int ej,
                                        int nst, int t) {
  if (t < ej || t >= ej + nst) return {1, 0};
  const int k = min(max(nst - 1 - (t - ej), 0), LS - 1);
  const int enc = (int)(((unsigned)s_steps[k >> 1] >> (16 * (k & 1)))
                        & 0xFFFFu);
  return {enc & 3, enc >> 3};
}

template <int WM, bool GL>
__global__ void __launch_bounds__(NT, 1) graph_update_kernel(GraphArgs a) {
  extern __shared__ int smem[];
  const int R = a.R, E = a.E, P = a.P, A = a.A;
  const int OE = out_words<WM>(E), P2 = P / 2, A2 = (A + 1) / 2;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int QCAP = R + A + 1, LS = 2 * a.LS2;
  DP_PROBE_INIT
  int* ctrl_g = a.ctrl + (size_t)b * R;
  int* outp_g = a.outp + (size_t)b * R * OE;
  int* inp_g = a.inp + (size_t)b * R * P2;
  int* alp_g = a.alp + (size_t)b * R * A2;
  Graph<WM> g;
  int* indeg;
  if (GL) {
    g.ctrl = ctrl_g;
    g.outp = outp_g;
    g.inp = inp_g;
    g.alp = alp_g;
    indeg = smem;
  } else {
    g.ctrl = smem;
    g.outp = g.ctrl + R;
    g.inp = g.outp + R * OE;
    g.alp = g.inp + R * P2;
    indeg = g.alp + R * A2;
  }
  int* s_i2n_in = indeg + R;
  int* s_i2nn = s_i2n_in + R;
  int* s_q = s_i2nn + R;
  int* s_steps = s_q + QCAP;
  int* s_qp4 = s_steps + a.LS2;
  int* s_qw = s_qp4 + a.Wq4;   // Wq2 words in WM 1, none in WM 0
  g.E = E;
  g.OE = OE;
  g.P2 = P2;
  g.A2 = A2;
  g.IDB = 16 - a.wbits;
  g.IDM = (1 << g.IDB) - 1;
  int* res = a.work + (size_t)b * 2 * LS;   // by query index
  int* bnid = res + LS;                     // the bundled nid, likewise

  if (!GL) {
    block_copy(g.ctrl, ctrl_g, R);
    block_copy(g.outp, outp_g, R * OE);
    block_copy(g.inp, inp_g, R * P2);
    block_copy(g.alp, alp_g, R * A2);
  }
  block_copy(s_i2n_in, a.i2nn_in + (size_t)b * R, R);
  block_copy(s_steps, a.s16w + (size_t)b * a.LS2, a.LS2);
  block_copy(s_qp4, a.qp4 + (size_t)b * a.Wq4, a.Wq4);
  if (WM) block_copy(s_qw, a.qw + (size_t)b * a.Wq2, a.Wq2);

  const int* mi = a.misc + (size_t)b * M_NMISC;
  const int qlen = a.qlen[b];
  const int ej = max(mi[M_ENDJ], 0);
  const int nst = mi[M_NSTEPS];
  const int bad = (mi[M_OVFL] | mi[M_FAIL]) > 0;
  const int fail_in = a.fail[b];
  const int live_n = ej + nst + max(qlen - mi[M_BJ], 0);
  const bool skip = bad || fail_in > 0 || qlen == 0 || live_n == 0;
  const int n0 = a.node_n[b];
  // forward steps past the stream's capacity are not fused, as in the
  // plain version (a real round has at most R + Wq <= LS)
  const int LF = skip ? 0 : min(live_n, LS);
  __syncthreads();
  DP_PROBE(0)

  // ---- fusion, pass 1: the row deltas and resolving steps of this
  // thread's run of forward steps ----
  const int chunk = (LF + NT - 1) / NT;
  const int t0 = min(tid * chunk, LF), t1 = min(t0 + chunk, LF);
  int2 loc = make_int2(0, 0);
  for (int t = t0; t < t1; ++t) {
    const Step s = step_at(s_steps, LS, ej, nst, t);
    loc.x += s.delta;
    loc.y += s.op != 2;
  }
  int2 tot;
  const int2 pre = block_scan2(loc, s_q, &tot);
  const int n_res = tot.y;

  // ---- pass 2: resolve each step against the pre-fusion state ----
  int row = mi[M_LASTI] + pre.x, qid = pre.y, n_new = 0;
  for (int t = t0; t < t1; ++t) {
    const Step s = step_at(s_steps, LS, ej, nst, t);
    const int cur_row = row;
    row += s.delta;
    if (s.op == 2) continue;   // a deletion consumes nothing
    int word = RES_NEW;
    if (s.op == 0) {
      const int qb = qbase(s_qp4, a.Wq4, qid);
      const int nid = min(s_i2n_in[min(max(cur_row, 0), R - 1)] & H16,
                          R - 1);
      const int cw = g.ctrl[nid];
      if ((cw & 7) == qb) {
        word = nid;
      } else {
        int aid = -1;
        for (int x = 0; x < n_al_of(cw) && aid < 0; ++x) {
          const int av = g.al_at(nid, x);
          if (av < R && (g.ctrl[av] & 7) == qb) aid = av;
        }
        if (aid >= 0) {
          word = aid;
        } else {
          word = RES_NEW | RES_BUNDLE;
          bnid[qid] = nid;
        }
      }
    }
    res[qid] = word;
    n_new += (word & RES_NEW) != 0;
    ++qid;
  }
  const int new0 = block_scan2(make_int2(n_new, 0), s_q, &tot).x;
  const int tot_new = tot.x;
  // ---- pass 3: number the new nodes ----
  for (int j = pre.y, k = n0 + new0; j < qid; ++j)
    if (res[j] & RES_NEW) res[j] |= k++;
  __syncthreads();

  // ---- capacities, on the pre-fusion state: edge j runs r(j-1) -> r(j)
  // (SRC before r0, SINK after the last); a new node has no edges ----
  const int n_edge = LF > 0 ? n_res + 1 : 0;
  const bool over_r = n0 + tot_new > R;
  bool cap = false;
  for (int j = tid; j < n_edge && !over_r; j += NT) {
    const int ru = j > 0 ? res[j - 1] : SRC_NODE_ID;
    const int rv = j < n_res ? res[j] : SINK_NODE_ID;
    const int u = ru & H16, v = rv & H16;
    if ((ru & RES_NEW) || g.find_out(u, v) < 0)
      cap |= ((ru & RES_NEW) ? 0 : n_out_of(g.ctrl[u])) >= E
             || ((rv & RES_NEW) ? 0 : n_in_of(g.ctrl[v])) >= P;
    if (rv & RES_BUNDLE) cap |= n_al_of(g.ctrl[bnid[j]]) + 1 > A;
  }
  const bool ffail = __syncthreads_or(cap) || (n_edge > 0 && over_r);
  const int nn = ffail ? n0 : n0 + tot_new;

  if (!ffail && n_edge > 0) {
    // ---- the new nodes: their bases, no edges ----
    for (int j = tid; j < n_res; j += NT)
      if (res[j] & RES_NEW) g.ctrl[res[j] & H16] = qbase(s_qp4, a.Wq4, j);
    __syncthreads();
    // ---- the edges and the bundles of mismatch-created nodes; a node's
    // lists have one writer, its counts in ctrl take atomic adds to
    // separate fields ----
    for (int j = tid; j < n_edge; j += NT) {
      const int ru = j > 0 ? res[j - 1] : SRC_NODE_ID;
      const int rv = j < n_res ? res[j] : SINK_NODE_ID;
      const int u = ru & H16, v = rv & H16;
      const int wv = qweight<WM>(s_qw, a.Wq2, j < n_res ? j : qlen - 1);
      const int slot = (ru & RES_NEW) ? -1 : g.find_out(u, v);
      if (slot >= 0) {
        g.out_bump(u, slot, wv);
      } else {
        g.out_new(u, n_out_of(g.ctrl[u]), v, wv);
        atomicAdd(&g.ctrl[u], 1 << 3);
        const int ni = n_in_of(g.ctrl[v]);
        half_set(g.inp, v * P2 + (ni >> 1), ni, u);
        atomicAdd(&g.ctrl[v], 1 << 10);
      }
      if (rv & RES_BUNDLE) {
        // all pairs (ref src/abpoa_graph.c:377-401): each member of
        // group(nid) and nid append v; v's list is [members..., nid]
        const int nid = bnid[j];
        const int na = n_al_of(g.ctrl[nid]);
        for (int x = 0; x < na; ++x) {
          const int m = g.al_at(nid, x);
          const int nm = n_al_of(g.ctrl[m]);
          half_set(g.alp, m * A2 + (nm >> 1), nm, v);
          atomicAdd(&g.ctrl[m], 1 << 7);
          half_set(g.alp, v * A2 + (x >> 1), x, m);
        }
        half_set(g.alp, nid * A2 + (na >> 1), na, v);
        atomicAdd(&g.ctrl[nid], 1 << 7);
        half_set(g.alp, v * A2 + (na >> 1), na, nid);
        atomicAdd(&g.ctrl[v], (na + 1) << 7);
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < R; i += NT) indeg[i] = n_in_of(g.ctrl[i]);
  __syncthreads();
  DP_PROBE(1)

  // ---- max_remain: each node's heaviest out-edge (first max), SINK
  // where it has none, then pointer doubling (d = the hops to SINK);
  // remain = d - 1 into ctrl's upper half for live nodes (dead ones keep
  // theirs) ----
  int* buf0 = s_i2n_in;   // two R-word buffers, free after the fusion
  int* buf1 = s_i2nn;
  for (int u = tid; u < R; u += NT) {
    const int no = n_out_of(g.ctrl[u]);
    int bw = -1, bv = SINK_NODE_ID;
    for (int e = 0; e < no; ++e) {
      const int ew = g.out_w(u, e);
      if (ew > bw) {
        bw = ew;
        bv = g.out_id(u, e);
      }
    }
    buf0[u] = u == SINK_NODE_ID ? SINK_NODE_ID : min(bv, R - 1) | (1 << 16);
  }
  const int* rem = pointer_double(buf0, buf1, R);
  for (int u = tid; u < nn && u < R; u += NT)
    g.ctrl[u] = (int)(((unsigned)g.ctrl[u] & 0xFFFFu)
                      | (((unsigned)rem[u] & ~0xFFFFu) - 0x10000u));
  __syncthreads();
  DP_PROBE(2)

  // ---- fast runs for the sort: a link u -> v where u has one out-edge
  // and v (not SINK) one in-edge and no aligned list, so that popping u
  // queues v alone. Links chain into disjoint runs (each node is in one,
  // maybe alone); run[u] = (u's place in the run list L) | (the nodes
  // after u in its run) << 16, or -1 on a cycle of links (unreachable) ----
  for (int u = tid; u < R; u += NT) {
    int w = u;
    if (n_out_of(g.ctrl[u]) == 1) {
      const int v = g.out_id(u, 0);
      const int cv = g.ctrl[min(v, R - 1)];
      if (v < R && v != SINK_NODE_ID && n_in_of(cv) == 1 && n_al_of(cv) == 0)
        w = v | (1 << 16);
    }
    buf0[u] = w;
  }
  int* run = pointer_double(buf0, buf1, R);   // run end | hops to it << 16
  int* s_L = run == buf0 ? buf1 : buf0;
  for (int u = tid; u < R; u += NT) s_L[u] = 0;
  __syncthreads();
  // each run's length, at its end node; then their inclusive prefix sums
  for (int u = tid; u < R; u += NT) {
    const int r = (unsigned)run[u] >> 16;
    if (r < R) atomicMax(&s_L[run[u] & H16], r + 1);
  }
  __syncthreads();
  {
    const int chunk = (R + NT - 1) / NT;
    const int u0 = min(tid * chunk, R), u1 = min(u0 + chunk, R);
    int sum = 0;
    for (int u = u0; u < u1; ++u) sum += s_L[u];
    int2 tot2;
    int acc = block_scan2(make_int2(sum, 0), s_q, &tot2).x;
    for (int u = u0; u < u1; ++u) {
      acc += s_L[u];
      s_L[u] = acc;
    }
  }
  __syncthreads();
  for (int u = tid; u < R; u += NT) {
    const int w = run[u], r = (unsigned)w >> 16;
    run[u] = r < R ? (s_L[w & H16] - 1 - r) | (r << 16) : -1;
  }
  __syncthreads();
  for (int u = tid; u < R; u += NT)
    if (run[u] != -1) s_L[run[u] & H16] = u;
  __syncthreads();
  DP_PROBE(3)

  if (tid == 0) {
    // ---- Kahn FIFO sort with aligned grouping; the queue is the pop
    // order. cur's control word and the out-word(s) of its slots 0-1
    // ride in registers from one pop to the next ----
    int head = 0, tail = 1;
    bool done = false, over = false;
    s_q[0] = SRC_NODE_ID;
    int cur = SRC_NODE_ID, ccw = g.ctrl[SRC_NODE_ID];
    int w0 = g.outp[SRC_NODE_ID * OE];
    int w1 = WM ? g.outp[SRC_NODE_ID * OE + 1] : 0;
    while (true) {
      ++head;   // pop cur (== s_q[head - 1])
      if (cur == SINK_NODE_ID) {
        done = true;
        break;
      }
      if (head == tail) {
        // nothing else queued: cur's run is popped next, node after node,
        // each queueing the next; queue it whole and pop its last node
        const unsigned inf = (unsigned)run[cur];
        const int r = inf >> 16;
        if (r > 0 && tail + r <= QCAP) {
          const int p0 = inf & H16;
          for (int k = 1; k <= r; ++k) s_q[tail++] = s_L[p0 + k];
          head += r - 1;
          cur = s_L[p0 + r];
          ccw = g.ctrl[cur];
          w0 = g.outp[cur * OE];
          w1 = WM ? g.outp[cur * OE + 1] : 0;
          continue;
        }
      }
      const int no = min(n_out_of(ccw), E);
      const int tail0 = tail;
      const bool queued = head < tail0;
      // the queue's next node and slot 0's node, with their words, loaded
      // together
      const int nxt = queued ? s_q[head] : SRC_NODE_ID;
      const int v0 = min(w0 & (WM ? H16 : g.IDM), R - 1);
      const int d0 = indeg[v0] - 1, cv0 = g.ctrl[v0];
      const int x0 = g.outp[v0 * OE], x1 = WM ? g.outp[v0 * OE + 1] : 0;
      const int nxt_cw = g.ctrl[nxt];
      const int y0 = g.outp[nxt * OE], y1 = WM ? g.outp[nxt * OE + 1] : 0;
      int first = -1, f_cw = 0, f0 = 0, f1 = 0;
#pragma unroll 1
      for (int e = 0; e < no; ++e) {
        int v = v0, d = d0, cv = cv0;
        if (e > 0) {
          v = min(e == 1 ? (WM ? w1 & H16 : ((unsigned)w0 >> 16) & g.IDM)
                         : g.out_id(cur, e), R - 1);
          d = indeg[v] - 1;
          cv = g.ctrl[v];
        }
        indeg[v] = d;
        if (d != 0) continue;
        // queued with its aligned list once every member is at 0 (a
        // later slot's in-degree is not decremented yet)
        const int na = n_al_of(cv);
        if (na) {
          bool rdy = true;
          for (int x = 0; x < na && rdy; ++x) {
            const int av = g.al_at(v, x);
            rdy = av < R && indeg[av] == 0;
          }
          if (!rdy) continue;
        }
        if (tail + 1 + na > QCAP) {
          over = true;
          break;
        }
        if (first < 0) {
          first = v;
          f_cw = cv;
          f0 = e == 0 ? x0 : g.outp[v * OE];
          f1 = e == 0 ? x1 : (WM ? g.outp[v * OE + 1] : 0);
        }
        s_q[tail++] = v;
        for (int x = 0; x < na; ++x) s_q[tail++] = g.al_at(v, x);
      }
      if (over || head >= tail) break;
      cur = queued ? nxt : first;
      ccw = queued ? nxt_cw : f_cw;
      w0 = queued ? y0 : f0;
      w1 = queued ? y1 : f1;
    }
    // for the join (the step stream's words are free now)
    s_steps[0] = head;
    s_steps[1] = done && !over;
  }
  __syncthreads();
  DP_PROBE(4)

  // ---- the topo maps from the pop order: i2n low, n2i high ----
  const int n_pop = s_steps[0];
  for (int k = tid; k < R; k += NT) s_i2nn[k] = k < n_pop ? s_q[k] : 0;
  __syncthreads();
  for (int k = tid; k < n_pop; k += NT)
    atomicOr(reinterpret_cast<unsigned*>(s_i2nn) + s_q[k], (unsigned)k << 16);
  if (tid == 0) {
    const int topo_ok = s_steps[1] && n_pop == min(max(nn, 0), R);
    a.node_n_out[b] = nn;
    a.fail_out[b] = ffail || fail_in > 0 || (bad && qlen > 0)
                    || (!skip && !topo_ok);
  }
  __syncthreads();
  block_copy(a.i2nn_out + (size_t)b * R, s_i2nn, R);
  if (!GL) {
    block_copy(ctrl_g, g.ctrl, R);
    block_copy(outp_g, g.outp, R * OE);
    block_copy(inp_g, g.inp, R * P2);
    block_copy(alp_g, g.alp, R * A2);
  }
  DP_PROBE(5)
  DP_PROBE_SAVE(nn, n_res)
}

// dynamic shared memory of a block: the packed state (GL = false), the
// in-degrees, both topo maps, the queue, the step stream, the query and
// (WM 1) its weights; the numbers of ops/graph_update.py smem_bytes and
// global_smem_bytes
template <int WM, bool GL>
size_t smem_bytes(const GraphArgs& a) {
  const size_t state = GL ? 0 : (size_t)a.R * (1 + out_words<WM>(a.E)
                                               + a.P / 2 + (a.A + 1) / 2);
  return sizeof(int) * (state + 3 * (size_t)a.R + (a.R + a.A + 1) + a.LS2
                        + a.Wq4 + (WM ? a.Wq2 : 0));
}

template <int WM, bool GL>
cudaError_t launch(const GraphArgs& a, int B, void* stream) {
  const size_t smem = smem_bytes<WM, GL>(a);
  cudaError_t err = cudaFuncSetAttribute(
      graph_update_kernel<WM, GL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  graph_update_kernel<WM, GL><<<B, NT, smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace abpoa

DP_PROBE_EXPORT

// C entry point (bound with ctypes). Enqueues the kernel on `stream`;
// returns the cudaError_t of the launch.
// wmode 0 packs node ids into 16-wbits bits of a half; wmode 1 keeps
// 16-bit ids in full words and reads the weight stream qw (Wq2 words).
// gmem 0 stages the packed state in shared memory, gmem 1 works on it in
// global memory (the caller picks: shared memory where it fits).
// work: int32 scratch of B * 4 * LS2 words (two a forward step).
extern "C" int graph_update_launch(const int* misc, const int* qlen,
                                   const int* node_n, const int* fail,
                                   const int* i2nn_in, const int* s16w,
                                   const int* qp4, const int* qw, int* ctrl,
                                   int* outp, int* inp, int* alp,
                                   int* i2nn_out, int* node_n_out,
                                   int* fail_out, int* work, int B, int R,
                                   int E, int P, int A, int LS2, int Wq4,
                                   int Wq2, int wbits, int wmode,
                                   int gmem, void* stream) {
  using namespace abpoa;
  if (B <= 0) return 0;
  // the queue doubles as the scans' scratch (2 * (NW + 1) ints) and the
  // step stream as the sort's results (2 ints)
  if (E % 2 || P % 2 || E > 15 || P > 15 || A > 7 || R > (1 << 16)
      || R + A + 1 < 2 * (NW + 1) || LS2 < 2 || Wq4 < 1 || work == nullptr)
    return (int)cudaErrorInvalidValue;
  if (wmode == 0 && (wbits < 1 || wbits > 15 || R > (1 << (16 - wbits))))
    return (int)cudaErrorInvalidValue;
  if (wmode == 1 && (qw == nullptr || Wq2 < 1))
    return (int)cudaErrorInvalidValue;
  if ((wmode != 0 && wmode != 1) || (gmem != 0 && gmem != 1))
    return (int)cudaErrorInvalidValue;
  GraphArgs a{misc, qlen, node_n, fail, i2nn_in, s16w, qp4, qw, ctrl, outp,
              inp, alp, i2nn_out, node_n_out, fail_out, work, R, E, P, A,
              LS2, Wq4, Wq2, wbits};
  if (gmem)
    return (int)(wmode ? launch<1, true>(a, B, stream)
                       : launch<0, true>(a, B, stream));
  return (int)(wmode ? launch<1, false>(a, B, stream)
                     : launch<0, false>(a, B, stream));
}
