// Kahn FIFO topological sort with aligned grouping, one CUDA block per POA
// instance.
//
// Replaces the TPU kernel make_topo_kernel behind topo_batch
// (abpoa_tpu/ops/poa_loop.py:330, :432, pallas_call at :467). Plain
// version: abpoa_tpu_torch/ops/topo.py topo_batch_ref (the plain graph
// update's kahn_ref); the two are held bit-equal on i2n, n2i and ok. It
// is the second implementation that checks the graph kernel's sort
// (csrc/graph_update.cu), so it shares no code with it.
//
// What it computes (ref src/abpoa_graph.c:186-231): from SRC, pop the FIFO
// head and give it the next index; decrement its out-nodes' in-degrees; a
// node whose in-degree reaches 0 is queued with its aligned list once
// every member is at in-degree 0. ok = SINK popped with node_n nodes
// sorted, and the instance's fail flag clear.
//
// What bounds it on an H100: the sort is a serial chain of dependent
// loads (pop, scan the out-edges, test the aligned list), so one thread
// runs it; the in-degrees and the queue live in shared memory, the graph
// state is read from device memory (L1/L2-resident after the first
// touch). Latency-bound by design: it exists to check the graph kernel,
// and the TPU kernel's 16-bit packing of the state (an answer to the
// TPU's scalar memory) is not carried over: the state is read as int32.
#include <cuda_runtime.h>

#include "layout.cuh"

namespace abpoa {
namespace {

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

__global__ void topo_kernel(TopoArgs a) {
  extern __shared__ int smem[];
  const int R = a.R, E = a.E, A = a.A, b = blockIdx.x;
  // the queue holds each node once on a consistent graph; its capacity
  // leaves room for one aligned group past R, and a graph that would
  // overrun it (or pop past R nodes) is reported not ok
  const int QCAP = R + A + 1;
  int* indeg = smem;
  int* q = smem + R;
  const size_t ro = (size_t)b * R;
  for (int v = threadIdx.x; v < R; v += blockDim.x) indeg[v] = a.n_in[ro + v];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int* out_ids = a.out_ids + ro * E;
  const int* al_ids = a.al_ids + ro * A;
  const int* n_out = a.n_out + ro;
  const int* n_al = a.n_al + ro;
  int* i2n = a.i2n + ro;
  int* n2i = a.n2i + ro;
  auto clampR = [&](int v) { return min(max(v, 0), R - 1); };
  int head = 0, tail = 1, idx = 0;
  bool done = false, overrun = false;
  q[0] = SRC_NODE_ID;
  while (head < tail && !done && !overrun) {
    if (idx >= R) {
      overrun = true;
      break;
    }
    const int cur = q[head++];
    i2n[idx] = cur;
    n2i[cur] = idx;
    ++idx;
    if (cur == SINK_NODE_ID) {
      done = true;
      break;
    }
    const int no = min(n_out[cur], E);
    for (int e = 0; e < no && !overrun; ++e) {
      const int v = clampR(out_ids[(size_t)cur * E + e]);
      if (--indeg[v] != 0) continue;
      const int na = min(n_al[v], A);
      bool rdy = true;
      for (int k = 0; k < na; ++k)
        rdy = rdy && indeg[clampR(al_ids[(size_t)v * A + k])] == 0;
      if (!rdy) continue;
      if (tail + 1 + na > QCAP) {
        overrun = true;
        break;
      }
      q[tail++] = v;
      for (int k = 0; k < na; ++k)
        q[tail++] = clampR(al_ids[(size_t)v * A + k]);
    }
  }
  const int nn = min(max(a.node_n[b], 0), R);
  a.ok[b] = done && !overrun && idx == nn && a.fail[b] == 0;
}

}  // namespace
}  // namespace abpoa

// C entry point (bound with ctypes). Enqueues the kernel on `stream`;
// returns the cudaError_t of the launch.
extern "C" int topo_launch(const int* out_ids, const int* n_out,
                           const int* al_ids, const int* n_al, const int* n_in,
                           const int* node_n, const int* fail, int* i2n,
                           int* n2i, int* ok, int B, int R, int E, int A,
                           void* stream) {
  using namespace abpoa;
  if (B <= 0) return 0;
  if (R < 2 || E <= 0 || A < 0) return (int)cudaErrorInvalidValue;
  size_t smem = sizeof(int) * (2 * (size_t)R + A + 1);
  cudaError_t err = cudaFuncSetAttribute(
      topo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  TopoArgs a{out_ids, n_out, al_ids, n_al, n_in, node_n, fail, i2n, n2i, ok,
             R, E, A};
  topo_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
