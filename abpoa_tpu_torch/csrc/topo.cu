// Kahn FIFO topological sort with aligned grouping, one CUDA block per POA
// instance.
//
// Replaces the TPU kernel make_topo_kernel behind topo_batch
// (abpoa_tpu/ops/poa_loop.py:330, :432, pallas_call at :467). Plain
// version: abpoa_tpu_torch/ops/topo.py topo_batch_ref (the plain graph
// update's kahn_ref); the two are held bit-equal on i2n, n2i and ok. It
// is the second implementation that checks the graph kernel's sort
// (csrc/graph_update.cu), so it shares no code with it: not the sort,
// not the state's layout (this kernel reads the unpacked int32 GState),
// not a helper.
//
// What it computes (ref src/abpoa_graph.c:186-231): from SRC, pop the FIFO
// head and give it the next index; decrement its out-nodes' in-degrees; a
// node whose in-degree reaches 0 is queued with its aligned list once
// every member is at in-degree 0. ok = SINK popped with node_n nodes
// sorted, and the instance's fail flag clear.
//
// What bounds it on an H100: the sort is a serial chain of dependent
// loads (pop, scan the out-edges, test the aligned list), so one thread
// runs it, and its time is the latency of each load and of the selects
// and branches between them. The block first stages the instance's
// out-edge ids, aligned lists and counts into shared memory as 16-bit
// ids (node ids are below R <= 2^16), beside the in-degrees and the
// queue, so every load of the chain is a shared-memory load; the popped
// node's counts ride in a register, and a chain (nothing else queued,
// one out-node of in-degree 1 without an aligned list, which is then
// queued alone and popped next) takes a short path of three loads a
// node. Where the staged state does not fit (R * (E + A + 1) * 2 bytes
// plus the in-degrees and the queue past 227 KB, R past ~5,500 at
// E=12, A=4) a second instance of the kernel reads the state from
// device memory as the first version did (L1/L2-resident after the first
// touch); ops/topo.py staged() mirrors the rule.
#include <cuda_runtime.h>

#include "layout.cuh"

namespace abpoa {
namespace {

constexpr int TOPO_THREADS = 256;
constexpr size_t SMEM_CAP = 232448;   // a block's shared memory on Hopper

struct TopoArgs {
  const int* out_ids;  // [B, R, E]
  const int* n_out;    // [B, R]
  const int* al_ids;   // [B, R, A]
  const int* n_al;     // [B, R]
  const int* n_in;     // [B, R]
  const int* node_n;   // [B]
  const int* fail;     // [B]
  int* i2n;            // [B, R] (zeroed by the caller)
  int* n2i;            // [B, R] (zeroed)
  int* ok;             // [B]
  int R, E, A;
};

// bytes of shared memory: in-degrees, the queue and the sort's two
// results (ints), and when staged the out-ids, aligned ids and counts
// (16 bits each)
size_t topo_smem(int R, int E, int A, bool staged) {
  const size_t ints = sizeof(int) * (2 * (size_t)R + A + 3);
  return staged ? ints + sizeof(unsigned short) * (size_t)R * (E + A + 1)
                : ints;
}

template <bool STAGED>
__global__ void __launch_bounds__(TOPO_THREADS) topo_kernel(TopoArgs a) {
  extern __shared__ int smem[];
  const int R = a.R, E = a.E, A = a.A, b = blockIdx.x;
  // the queue holds each node once on a consistent graph; its capacity
  // leaves room for one aligned group past R, and a graph that would
  // overrun it (or pop past R nodes) is reported not ok
  const int QCAP = R + A + 1;
  DP_PROBE_INIT
  int* indeg = smem;
  int* q = smem + R;
  int* s_res = q + QCAP;   // the nodes popped, and whether SINK was
  unsigned short* s_out = reinterpret_cast<unsigned short*>(s_res + 2);
  unsigned short* s_al = s_out + (size_t)R * E;
  unsigned short* s_cnt = s_al + (size_t)R * A;   // n_out | n_al << 8
  const size_t ro = (size_t)b * R;
  const int* out_ids = a.out_ids + ro * E;
  const int* al_ids = a.al_ids + ro * A;
  const int* n_out = a.n_out + ro;
  const int* n_al = a.n_al + ro;
  auto clampR = [&](int v) { return min(max(v, 0), R - 1); };
  for (int v = threadIdx.x; v < R; v += TOPO_THREADS) {
    indeg[v] = a.n_in[ro + v];
    if (STAGED)
      s_cnt[v] = (unsigned short)(min(max(n_out[v], 0), E)
                                  | min(max(n_al[v], 0), A) << 8);
  }
  if (STAGED) {
    for (int i = threadIdx.x; i < R * E; i += TOPO_THREADS)
      s_out[i] = (unsigned short)clampR(out_ids[i]);
    for (int i = threadIdx.x; i < R * A; i += TOPO_THREADS)
      s_al[i] = (unsigned short)clampR(al_ids[i]);
  }
  __syncthreads();
  DP_PROBE(0)
  // the state, from shared memory or from device memory
  auto cnt_at = [&](int u) {   // n_out | n_al << 8
    return STAGED ? (int)s_cnt[u]
                  : max(min(n_out[u], E), 0) | max(min(n_al[u], A), 0) << 8;
  };
  auto out_at = [&](int u, int e) {
    return STAGED ? (int)s_out[u * E + e] : clampR(out_ids[(size_t)u * E + e]);
  };
  auto al_at = [&](int u, int k) {
    return STAGED ? (int)s_al[u * A + k] : clampR(al_ids[(size_t)u * A + k]);
  };
  if (threadIdx.x == 0) {
    // the pop order is the queue's: q[k] gets index k
    int head = 0, tail = 1;
    bool done = false, overrun = false;
    q[0] = SRC_NODE_ID;
    int cur = SRC_NODE_ID;       // q[head] and its counts, in registers
    int cc = cnt_at(SRC_NODE_ID);
    while (true) {
      if (head >= R) {
        overrun = true;
        break;
      }
      ++head;
      if (cur == SINK_NODE_ID) {
        done = true;
        break;
      }
      const int no = cc & 0xFF;
      const int u0 = out_at(cur, 0);
      if (no == 1 && head == tail && tail < QCAP) {
        // a chain: nothing else is queued and cur's one out-node has
        // in-degree 1 and no aligned list, so it is queued alone and
        // popped next
        const int c0 = cnt_at(u0);
        if (indeg[u0] == 1 && (c0 >> 8) == 0) {
          indeg[u0] = 0;
          q[tail++] = u0;
          cur = u0;
          cc = c0;
          continue;
        }
      }
      const bool queued = head < tail;
      const int nxt_q = queued ? q[head] : SRC_NODE_ID;
      int nxt_push = -1, push_c = 0;
      for (int e = 0; e < no; ++e) {
        const int v = e ? out_at(cur, e) : u0;
        const int cv = cnt_at(v);   // loaded beside the in-degree
        if (--indeg[v] != 0) continue;
        const int na = cv >> 8;
        bool rdy = true;
        for (int k = 0; k < na && rdy; ++k) rdy = indeg[al_at(v, k)] == 0;
        if (!rdy) continue;
        if (tail + 1 + na > QCAP) {
          overrun = true;
          break;
        }
        if (nxt_push < 0) {
          nxt_push = v;
          push_c = cv;
        }
        q[tail++] = v;
        for (int k = 0; k < na; ++k) q[tail++] = al_at(v, k);
      }
      if (overrun || head >= tail) break;
      cur = queued ? nxt_q : nxt_push;
      cc = queued ? cnt_at(nxt_q) : push_c;
    }
    s_res[0] = head;
    s_res[1] = done && !overrun;
    DP_PROBE(1)
  }
  __syncthreads();
  const int n_pop = s_res[0];
  for (int k = threadIdx.x; k < n_pop; k += TOPO_THREADS) {
    a.i2n[ro + k] = q[k];
    a.n2i[ro + q[k]] = k;
  }
  if (threadIdx.x == 0) {
    const int nn = min(max(a.node_n[b], 0), R);
    a.ok[b] = s_res[1] && n_pop == nn && a.fail[b] == 0;
  }
  DP_PROBE_SAVE(n_pop, 0)
}

}  // namespace
}  // namespace abpoa

DP_PROBE_EXPORT

// C entry point (bound with ctypes). Enqueues the kernel on `stream`;
// returns the cudaError_t of the launch. The staged instance runs where
// its shared memory fits a block.
extern "C" int topo_launch(const int* out_ids, const int* n_out,
                           const int* al_ids, const int* n_al, const int* n_in,
                           const int* node_n, const int* fail, int* i2n,
                           int* n2i, int* ok, int B, int R, int E, int A,
                           void* stream) {
  using namespace abpoa;
  if (B <= 0) return 0;
  if (R < 2 || E <= 0 || A < 0) return (int)cudaErrorInvalidValue;
  const bool staged = R <= (1 << 16) && E < 256 && A < 256
                      && topo_smem(R, E, A, true) <= SMEM_CAP;
  const size_t smem = topo_smem(R, E, A, staged);
  auto kernel = staged ? topo_kernel<true> : topo_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  TopoArgs a{out_ids, n_out, al_ids, n_al, n_in, node_n, fail, i2n, n2i, ok,
             R, E, A};
  kernel<<<B, TOPO_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
