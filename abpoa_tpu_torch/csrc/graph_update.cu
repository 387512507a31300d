// One round's graph update on the packed state, one CUDA block per POA
// instance: fusion replay of the steps16 stream, Kahn FIFO re-sort with
// aligned grouping, max_remain in reverse topological order.
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
// graph_update_packed_ref, which reaches the same state by an
// independent route (vectorized fusion, queue sort, pointer doubling).
//
// Semantics: ref src/abpoa_graph.c:596-672 (native/poagraph.c
// pg_fuse_steps), :186-231 (Kahn FIFO with aligned grouping), :233-274
// (max_remain: heaviest out-edge, first max; remain[SINK] = -1).
//
// What bounds it on an H100: the work is scalar and pointer-chasing
// (each fusion step and each queue pop depends on the previous one), so
// it is bound by the latency of dependent loads. The design copies the
// instance's whole packed state (ctrl, out-edge entries, in/aligned
// halves, both topo maps, the step stream, the query and, in WM 1, its
// weights) into shared memory with the whole
// block, runs the sequential passes on one thread at shared-memory
// latency, and copies the state back IN PLACE (the counterpart of the
// JAX kernel's input_output_aliases). Blocks are independent instances
// and run in any order; nothing carries between them.
#include <cuda_runtime.h>

#include "layout.cuh"

namespace abpoa {
namespace {

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
  int R, E, P, A, LS2, Wq4, Wq2, wbits;
};

// out-edge words per node: E/2 halves (WM 0) or E full words (WM 1)
template <int WM>
__host__ __device__ int out_words(int E) { return WM ? E : E / 2; }

template <int WM>
struct Graph {
  int *ctrl, *outp, *inp, *alp, *indeg;
  int R, E, OE, P2, A2, IDB, IDM;

  __device__ int half_get(const int* arr, int word, int k) const {
    return (int)(((unsigned)arr[word] >> (16 * (k & 1))) & 0xFFFFu);
  }
  __device__ void half_set(int* arr, int word, int k, int val) const {
    unsigned sh = 16 * (k & 1);
    unsigned w = (unsigned)arr[word];
    arr[word] = (int)((w & ~(0xFFFFu << sh)) | (((unsigned)val & 0xFFFFu)
                                                 << sh));
  }
  __device__ int out_id(int u, int e) const {
    if (WM) return outp[u * E + e] & H16;
    return half_get(outp, u * OE + (e >> 1), e) & IDM;
  }
  __device__ int out_w(int u, int e) const {
    if (WM) return (int)((unsigned)outp[u * E + e] >> 16);
    return half_get(outp, u * OE + (e >> 1), e) >> IDB;
  }
  // += wv to edge (u, e)'s weight (wv is 1 in WM 0)
  __device__ void out_bump(int u, int e, int wv) {
    if (WM) {
      outp[u * E + e] += wv << 16;
      return;
    }
    int word = u * OE + (e >> 1);
    half_set(outp, word, e, half_get(outp, word, e) + (1 << IDB));
  }
  __device__ void out_new(int u, int e, int to, int wv) {
    if (WM)
      outp[u * E + e] = to | (wv << 16);
    else
      half_set(outp, u * OE + (e >> 1), e, to | (1 << IDB));
  }
  __device__ int al_at(int u, int a) const {
    return half_get(alp, u * A2 + (a >> 1), a);
  }
  __device__ void al_append(int x, int val) {
    int na = (ctrl[x] >> 7) & 7;
    half_set(alp, x * A2 + (na >> 1), na, val);
    ctrl[x] += 1 << 7;
  }
  // edge last -> to with weight wv: bump an existing edge (searched
  // only when the from-node is old) or append a new one; returns 1 on a
  // capacity failure
  __device__ int add_edge(int last, bool lnew, int to, int wv, int P) {
    int lcw = ctrl[last];
    int no = (lcw >> 3) & 15;
    int slot = -1;
    if (!lnew)
      for (int e = 0; e < no && slot < 0; ++e)
        if (out_id(last, e) == to) slot = e;
    if (slot >= 0) {
      out_bump(last, slot, wv);
      return 0;
    }
    int ni = (ctrl[to] >> 10) & 15;
    if (no >= E || ni >= P) return 1;
    out_new(last, no, to, wv);
    ctrl[last] = lcw + (1 << 3);
    half_set(inp, to * P2 + (ni >> 1), ni, last);
    ctrl[to] += 1 << 10;
    indeg[to] += 1;
    return 0;
  }
};

// the weight of 0-based query base q: 1 in WM 0, qw[q] in WM 1
__device__ __forceinline__ int qweight(const int* s_qw, int q, int wm) {
  if (!wm) return 1;
  return (int)(((unsigned)s_qw[q >> 1] >> (16 * (q & 1))) & 0xFFFFu);
}

template <int WM>
__global__ void graph_update_kernel(GraphArgs a) {
  extern __shared__ int smem[];
  const int R = a.R, E = a.E, P = a.P, A = a.A;
  const int OE = out_words<WM>(E), P2 = P / 2, A2 = (A + 1) / 2;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int QCAP = R + A + 1;
  Graph<WM> g;
  g.ctrl = smem;
  g.outp = g.ctrl + R;
  g.inp = g.outp + R * OE;
  g.alp = g.inp + R * P2;
  g.indeg = g.alp + R * A2;
  int* s_i2n_in = g.indeg + R;
  int* s_i2nn = s_i2n_in + R;
  int* s_q = s_i2nn + R;
  int* s_steps = s_q + QCAP;
  int* s_qp4 = s_steps + a.LS2;
  int* s_qw = s_qp4 + a.Wq4;   // Wq2 words in WM 1, none in WM 0
  g.R = R;
  g.E = E;
  g.OE = OE;
  g.P2 = P2;
  g.A2 = A2;
  g.IDB = 16 - a.wbits;
  g.IDM = (1 << g.IDB) - 1;

  int* ctrl_g = a.ctrl + (size_t)b * R;
  int* outp_g = a.outp + (size_t)b * R * OE;
  int* inp_g = a.inp + (size_t)b * R * P2;
  int* alp_g = a.alp + (size_t)b * R * A2;
  for (int i = tid; i < R; i += nt) {
    int cw = ctrl_g[i];
    g.ctrl[i] = cw;
    g.indeg[i] = (cw >> 10) & 15;   // pre-fusion in-degrees
    s_i2n_in[i] = a.i2nn_in[(size_t)b * R + i];
    s_i2nn[i] = 0;
  }
  for (int i = tid; i < R * OE; i += nt) g.outp[i] = outp_g[i];
  for (int i = tid; i < R * P2; i += nt) g.inp[i] = inp_g[i];
  for (int i = tid; i < R * A2; i += nt) g.alp[i] = alp_g[i];
  for (int i = tid; i < a.LS2; i += nt)
    s_steps[i] = a.s16w[(size_t)b * a.LS2 + i];
  for (int i = tid; i < a.Wq4; i += nt)
    s_qp4[i] = a.qp4[(size_t)b * a.Wq4 + i];
  if (WM)
    for (int i = tid; i < a.Wq2; i += nt)
      s_qw[i] = a.qw[(size_t)b * a.Wq2 + i];
  __syncthreads();

  if (tid == 0) {
    const int* mi = a.misc + (size_t)b * M_NMISC;
    const int qlen = a.qlen[b];
    const int ej = max(mi[M_ENDJ], 0);
    const int bj = mi[M_BJ];
    const int nst = mi[M_NSTEPS];
    const int bad = (mi[M_OVFL] | mi[M_FAIL]) > 0;
    const int fail_in = a.fail[b];
    const int LS = 2 * a.LS2;
    const int live_n = ej + nst + max(qlen - bj, 0);
    const bool skip = bad || fail_in > 0 || qlen == 0 || live_n == 0;
    int nn = a.node_n[b];
    int ffail = 0;

    // ---- fusion: replay the stream in forward query order ----
    if (!skip) {
      int last = SRC_NODE_ID, qid = -1;
      bool lnew = false;
      int row = mi[M_LASTI];   // topo row of the last pushed step
      for (int t = 0; t < live_n && !ffail; ++t) {
        bool in_lead = t < ej, in_tail = t >= ej + nst;
        int k = min(max(nst - 1 - (t - ej), 0), LS - 1);
        int enc = (int)(((unsigned)s_steps[k >> 1] >> (16 * (k & 1)))
                        & 0xFFFFu);
        int op = (in_lead || in_tail) ? 1 : (enc & 3);
        int cur_row = row;
        if (!(in_lead || in_tail)) row += enc >> 3;
        if (op == 2) continue;   // a deletion consumes nothing
        ++qid;
        int qb = ((unsigned)s_qp4[(qid + 1) >> 2] >> (8 * ((qid + 1) & 3)))
                 & 0xFF;
        bool is_m = op == 0;
        int nid = min(s_i2n_in[min(max(cur_row, 0), R - 1)] & H16, R - 1);
        int cw = g.ctrl[nid];
        int na = (cw >> 7) & 7;
        bool m_match = is_m && (cw & 7) == qb;
        int aid = -1;
        if (is_m && !m_match)
          for (int x = 0; x < na && aid < 0; ++x) {
            int av = g.al_at(nid, x);
            if (av < R && (g.ctrl[av] & 7) == qb) aid = av;
          }
        bool m_aid = is_m && !m_match && aid >= 0;
        bool is_new = !(m_match || m_aid);
        int to = m_match ? nid : (m_aid ? aid : nn);
        if (is_new && nn >= R) {
          ffail = 1;
          break;
        }
        if (is_new) {
          g.ctrl[nn] = qb;
          g.indeg[nn] = 0;
          ++nn;
          if (is_m) {
            // aligned bundling of a mismatch-created node (all pairs,
            // ref src/abpoa_graph.c:377-401)
            if (na + 1 > A) {
              ffail = 1;
              break;
            }
            for (int x = 0; x < na; ++x) {
              int m = g.al_at(nid, x);
              g.al_append(m, to);
              g.al_append(to, m);
            }
            g.al_append(nid, to);
            g.al_append(to, nid);
          }
        }
        ffail |= g.add_edge(last, lnew, to, qweight(s_qw, qid, WM), P);
        last = to;
        lnew = is_new;
      }
      // final edge last -> SINK, with the last base's weight
      if (!ffail)
        ffail |= g.add_edge(last, lnew, SINK_NODE_ID,
                            qweight(s_qw, qlen - 1, WM), P);
    }

    // ---- Kahn FIFO sort with aligned grouping ----
    int head = 0, tail = 1, idx = 0;
    bool done = false;
    s_q[0] = SRC_NODE_ID;
    while (!done && head < tail) {
      int cur = s_q[head++];
      s_i2nn[idx] = (int)(((unsigned)s_i2nn[idx] & ~0xFFFFu) | (unsigned)cur);
      s_i2nn[cur] = (int)(((unsigned)s_i2nn[cur] & 0xFFFFu)
                          | ((unsigned)idx << 16));
      ++idx;
      done = cur == SINK_NODE_ID;
      if (done) break;
      int no = (g.ctrl[cur] >> 3) & 15;
      for (int e = 0; e < no; ++e) {
        int v = g.out_id(cur, e);
        if (v >= R) continue;
        if (--g.indeg[v] != 0) continue;
        int na_v = (g.ctrl[v] >> 7) & 7;
        bool rdy = true;
        for (int x = 0; x < na_v; ++x) {
          int av = g.al_at(v, x);
          rdy = rdy && av < R && g.indeg[av] == 0;
        }
        if (rdy && tail + 1 + na_v <= QCAP) {
          s_q[tail] = v;
          for (int x = 0; x < na_v; ++x) s_q[tail + 1 + x] = g.al_at(v, x);
          tail += 1 + na_v;
        }
      }
    }

    // ---- max_remain in reverse topo order, packed into ctrl's upper
    // half; the heaviest successor's remain is already final ----
    for (int k = 0; k < nn && k < R; ++k) {
      int u = min(max(s_i2nn[nn - 1 - k] & H16, 0), R - 1);
      int cw = g.ctrl[u];
      int no = (cw >> 3) & 15;
      int bw = -1, bv = SINK_NODE_ID;
      for (int e = 0; e < no; ++e) {
        int ew = g.out_w(u, e);
        if (ew > bw) {
          bw = ew;
          bv = g.out_id(u, e);
        }
      }
      int rem = u == SINK_NODE_ID ? -1 : (g.ctrl[min(bv, R - 1)] >> 16) + 1;
      g.ctrl[u] = (int)(((unsigned)cw & 0xFFFFu) | ((unsigned)rem << 16));
    }

    int topo_ok = done && idx == nn;
    a.node_n_out[b] = nn;
    a.fail_out[b] = ffail | fail_in | (bad && qlen > 0)
                    | (!skip && !topo_ok);
  }
  __syncthreads();
  for (int i = tid; i < R; i += nt) {
    ctrl_g[i] = g.ctrl[i];
    a.i2nn_out[(size_t)b * R + i] = s_i2nn[i];
  }
  for (int i = tid; i < R * OE; i += nt) outp_g[i] = g.outp[i];
  for (int i = tid; i < R * P2; i += nt) inp_g[i] = g.inp[i];
  for (int i = tid; i < R * A2; i += nt) alp_g[i] = g.alp[i];
}

template <int WM>
cudaError_t launch(const GraphArgs& a, int B, void* stream) {
  const int A2 = (a.A + 1) / 2;
  size_t smem = sizeof(int) * ((size_t)a.R * (4 + out_words<WM>(a.E)
                                              + a.P / 2 + A2)
                               + (a.R + a.A + 1) + a.LS2 + a.Wq4
                               + (WM ? a.Wq2 : 0));
  cudaError_t err = cudaFuncSetAttribute(
      graph_update_kernel<WM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  graph_update_kernel<WM><<<B, 256, smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace abpoa

// C entry point (bound with ctypes). Enqueues the kernel on `stream`;
// returns the cudaError_t of the launch.
// wmode 0 packs node ids into 16-wbits bits of a half; wmode 1 keeps
// 16-bit ids in full words and reads the weight stream qw (Wq2 words).
extern "C" int graph_update_launch(const int* misc, const int* qlen,
                                   const int* node_n, const int* fail,
                                   const int* i2nn_in, const int* s16w,
                                   const int* qp4, const int* qw, int* ctrl,
                                   int* outp, int* inp, int* alp,
                                   int* i2nn_out, int* node_n_out,
                                   int* fail_out, int B, int R, int E, int P,
                                   int A, int LS2, int Wq4, int Wq2,
                                   int wbits, int wmode, void* stream) {
  using namespace abpoa;
  if (B <= 0) return 0;
  if (E % 2 || P % 2 || E > 15 || P > 15 || A > 7 || R > (1 << 16))
    return (int)cudaErrorInvalidValue;
  if (wmode == 0 && (wbits < 1 || wbits > 15 || R > (1 << (16 - wbits))))
    return (int)cudaErrorInvalidValue;
  if (wmode == 1 && (qw == nullptr || Wq2 < 1))
    return (int)cudaErrorInvalidValue;
  if (wmode != 0 && wmode != 1) return (int)cudaErrorInvalidValue;
  GraphArgs a{misc, qlen, node_n, fail, i2nn_in, s16w, qp4, qw, ctrl, outp,
              inp, alp, i2nn_out, node_n_out, fail_out, R, E, P, A, LS2,
              Wq4, Wq2, wbits};
  return (int)(wmode ? launch<1>(a, B, stream) : launch<0>(a, B, stream));
}
