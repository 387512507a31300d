// Banded POA DP + backtrack walk, one CUDA block per POA instance, in
// two modes over one row body:
//   node-id mode (NID = true): planes and control words indexed by node
//     id, the sweep order from the packed i2n|n2i map, steps16 out; the
//     device loop's kernel.
//   topo mode (NID = false): planes and control words indexed by
//     topological row, band-state init (mplr0) and rowmask as inputs when
//     not fresh, extend mode with z-drop, int64 step words
//     (op | row<<2 | col<<32) and the band bounds/state out; the
//     round-based path's kernel.
//
// Replaces the TPU kernel make_band_kernel behind band_poa_dp_packed
// (nid mode) and band_poa_dp_batch (topo mode)
// (abpoa_tpu/ops/dp_pallas_band.py:132, :1340, :1154). Plain PyTorch
// versions: abpoa_tpu_torch/ops/band_dp.py band_poa_dp_packed_ref and
// band_poa_dp_batch_ref; each pair is held bit-equal on misc, the step
// stream and (topo mode) the band bounds and state.
//
// What bounds it on an H100: the DP is row-sequential (row t reads the
// rows of its predecessors), so one instance is one block and the work
// per row is one WB-lane vector (WB = 384 at the heter geometry). Bytes
// and operations are 3-4 orders below the time: it is latency-bound on
// one row's chain of dependent instructions (the pulled band, the
// predecessor values, a prefix max and a row maximum across the block,
// the backtrack bits) with a few warps an SM. Planes (H, E1, E2,
// backtrack bits) live in device memory at lane c mod WB, L2-resident
// between a row's write and its successors' reads. The design shortens
// the chain:
// - each thread owns CPT adjacent band positions (rel) in registers, a
//   template parameter: CPT = 2 up to 1024 lanes, CPT = 4 past them (up
//   to 2048, both modes), so a block has at most 512 threads (nvcc
//   -Xptxas -v for sm_90a, CUDA 12.8, registers linear / affine / convex:
//   topo mode at two 96 / 111 / 122, at four 111 / 128 / 128 with 116
//   bytes of spill stores and 108 of loads in convex; node-id mode at two
//   64 / 90 / 112, at four 104 / 128 / 128 with 36 and 36 in convex; no
//   other spills); the predecessor values are loaded once (the first
//   slot's kept for the backtrack bits), the row before's from registers
//   when the band did not move, and the query profile's load overlaps
//   the merge;
// - the F (insertion) prefix maxes are a serial max over the thread's
//   positions, a warp-shuffle scan and one warp reduction across warps;
//   the row maximum and its tie-break are one 64-bit key, two warp
//   reductions in each warp and across warps: two block barriers a row;
// - the band state and bounds of a row are pulled from its predecessors'
//   row maxima and bounds in shared memory, the row just finished from
//   registers, so no barrier ends a row;
// - control words, predecessor halves, band bounds and row maxima live in
//   shared memory; each mode and gap mode is its own instance of the
//   kernel; pn is a power of two and the division by WB a multiply (no
//   division on a row's path); the walk reads one backtrack word per step
//   on one thread.
//
// Topo mode's inputs arrive as one staged upload (ops/band_dp.py
// TopoStage: the export columns of every instance in their narrow dtypes,
// one section each). A prologue kernel (topo_stage_kernel) widens them
// into the words the band kernel reads (ctrl, predecessor halves, mplr0,
// the query-profile folds) and zeroes the outputs, so a launch is one
// host-to-device copy and two kernels; it replaces the PyTorch ops the
// JAX wrapper's packing became (abpoa_tpu/ops/dp_pallas_band.py:1154-
// 1210). It is one pass of loads and stores, a few microseconds.
//
// Predecessor slots: topo mode takes up to 30 (a runtime value), node-id
// mode 14. A backtrack pick field keeps 4 bits: the sweep writes slots
// 0-14 and leaves 15 for "slot 15 or later, or none" (the JAX kernel
// admits 30 slots in the same fields, so its slot-16 picks spill into
// the next field). Where the walk takes a condition whose field reads 15
// it re-tests slots 15..npre-1 in order from the predecessors' planes
// and bands (late_pick), as the sweep's first-hit rule would: only the
// cells whose first hit is at slot 15 or later pay for it, and below 16
// slots the search is slot 15 alone.
#include <cuda_runtime.h>

#include <algorithm>

#include "layout.cuh"

namespace abpoa {
namespace {

constexpr int MAX_NT = 512;   // threads a block, whatever the band
// bands of up to MAX_WB lanes: 2 positions a thread up to 1024 lanes, 4
// past them; predecessor slots of topo mode (node-id mode: 14)
constexpr int MAX_WB = 2048, MAX_P_TOPO = 30;

struct BandArgs {
  const int* scal;   // [B, S_NSCAL]
  const int* ctrl;   // [B, R]
  const int* inp;    // [B, R*P/2] predecessor halves
  const int* i2nn;   // [B, R] (node-id mode)
  const int* mplr0;  // [B, R] mpl|mpr<<16 (topo mode, not fresh) or null
  const int* qpf;    // [B, m*KW1, WB]
  int* misc;         // [B, M_NMISC]
  int* s16w;         // [B, LS/2] (node-id mode; zeroed by the caller)
  long long* steps;  // [B, max(LS, 8)] (topo mode; zeroed by the caller)
  int* bsn_out;      // [B, R] beg_sn|end_sn<<16 (topo mode; zeroed)
  int* mplr_out;     // [B, R] mpl|mpr<<16 (topo mode; zeroed)
  int* H;            // [B, R, WB] planes (scratch)
  int* E1;
  int* E2;
  int* BT;
  int R, WB, Wq, P, pn, pn_sh, gm, LS, m, extend, zdrop_on;
  unsigned wb_inv;   // ceil(2^32 / WB)
};

__device__ __forceinline__ int pre_at(const int* s_pre, int P2, int R,
                                      int node, int p) {
  unsigned w = (unsigned)s_pre[node * P2 + (p >> 1)];
  int v = (int)((w >> (16 * (p & 1))) & 0xFFFFu);
  return v < R - 1 ? v : R - 1;
}

// the row maximum and its tie-break as one key: the larger value, then
// the smaller (signed) key
__device__ __forceinline__ u64 best_key(int v, int key) {
  return ((u64)((unsigned)v ^ 0x80000000u) << 32)
         | (u64)(~((unsigned)key ^ 0x80000000u));
}

// band state of a row pulled from its predecessors' row maxima (the
// reference scatters each row's max position to its out-nodes; every
// predecessor completes first, so the pull is the same value), and the
// first band segment of its predecessors; the row just finished (prev)
// comes from registers
__device__ __forceinline__ void pull_band(const int* s_pre, const int* s_rms,
                                          const int* s_bsn, int P2, int R,
                                          int row, int npre, int iw,
                                          int prev, int prev_rms,
                                          int prev_bsn, int& mpl, int& mpr,
                                          int& min_pb) {
  mpl = 1 << 29;
  mpr = -(1 << 29);
  min_pb = 1 << 30;
  bool has_src = false;
  for (int p = 0; p < npre; ++p) {
    int pred = pre_at(s_pre, P2, R, row, p);
    int wr = pred == prev ? prev_rms : s_rms[pred];
    min_pb = min(min_pb, (pred == prev ? prev_bsn : s_bsn[pred]) & H16);
    if (wr >= RM_OK) {
      int v = wr & (RM_OK - 1);
      mpl = min(mpl, v);
      mpr = max(mpr, v);
    }
    has_src |= pred == 0;
  }
  mpl = min(mpl, has_src ? (1 << 29) : (iw & H16));
  mpr = max(mpr, has_src ? -(1 << 29) : (iw >> 16));
}

// a predecessor's band as the row body reads it: valid, first and last
// segment (10-bit fields of the JAX kernel's packed staging word)
struct PBand {
  bool pvc;
  int begc, endc;
};

__device__ __forceinline__ PBand pband(int pw, bool pv) {
  int pbel = (int)(((unsigned)pw & 0xFFFFu) | (((unsigned)(pw >> 16)) << 10)
                   | ((unsigned)pv << 20));
  PBand b;
  b.pvc = (pbel >> 20) > 0;
  b.begc = b.pvc ? (pbel & 1023) : (1 << 29);
  b.endc = b.pvc ? ((pbel >> 10) & 1023) : -(1 << 29);
  return b;
}

// what the row body reads of one predecessor row at the thread's lanes
template <int CPT>
struct PredVals {
  int h[CPT];    // H[pred][l]
  int hm[CPT];   // H[pred][l - 1 mod WB]
  int e1[CPT];
  int e2[CPT];
};

template <int CPT>
__device__ __forceinline__ void load_pred(PredVals<CPT>& v, const int* H,
                                          const int* E1, const int* E2,
                                          int pred, const int* lane,
                                          bool vec, int WB, int gm) {
  const size_t ro = (size_t)pred * WB;
  if (vec) {
    const int l0 = lane[0];
    ld_run<CPT>(H + ro + l0, v.h);
    v.hm[0] = H[ro + (l0 == 0 ? WB - 1 : l0 - 1)];
#pragma unroll
    for (int u = 1; u < CPT; ++u) v.hm[u] = v.h[u - 1];
    if (gm != LINEAR_GAP) ld_run<CPT>(E1 + ro + l0, v.e1);
    if (gm == CONVEX_GAP) ld_run<CPT>(E2 + ro + l0, v.e2);
  } else {
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int l = lane[u];
      v.h[u] = H[ro + l];
      v.hm[u] = H[ro + (l == 0 ? WB - 1 : l - 1)];
      v.e1[u] = gm != LINEAR_GAP ? E1[ro + l] : 0;
      v.e2[u] = gm == CONVEX_GAP ? E2[ro + l] : 0;
    }
  }
}

// a predecessor that is the row before at the same lanes, from the
// registers that hold it
template <int CPT>
__device__ __forceinline__ void from_regs(PredVals<CPT>& v, const int* ph,
                                          const int* pe1, const int* pe2,
                                          int ph_left) {
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    v.h[u] = ph[u];
    v.hm[u] = u > 0 ? ph[u - 1] : ph_left;
    v.e1[u] = pe1[u];
    v.e2[u] = pe2[u];
  }
}

// the row's scalars, alike in every thread
struct Row {
  int begc, endc, capc, dpsn, pn, inf, e1;
};

// one predecessor slot's step of the merge at the thread's positions
template <int CPT>
__device__ __forceinline__ void merge_pred(
    const Row& r, const PredVals<CPT>& v, bool first, const PBand& pb,
    const int* c, const int* seg, const int* qrow, int gm, int* h,
    int* e1v, int* e2v) {
  const int begc = r.begc, endc = r.endc;
  const int _begc = max(begc, pb.begc);
  const int _endc = min(min(pb.endc + 1, endc), r.dpsn - 1);
  const int _ende = min(pb.endc, endc);
  const int cb = mulw(_begc, r.pn);
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int s = seg[u];
    int cand = c[u] == 0 ? NEG : v.hm[u];
    const int boundary = pb.begc < begc ? cand : r.inf;
    if (c[u] == cb) cand = boundary;
    if (gm == LINEAR_GAP) cand = max(cand + qrow[u], v.h[u] - r.e1);
    const bool mmask = s >= _begc && s <= _endc && pb.pvc;
    if (first) {
      const bool fill = (s >= begc && s < _begc) || (s > _endc && s <= r.capc);
      h[u] = mmask ? cand : (fill ? r.inf : 0);
    } else if (mmask) {
      h[u] = max(h[u], cand);
    }
    if (gm != LINEAR_GAP) {
      const bool emask = s >= _begc && s <= _ende && pb.pvc;
      if (first) {
        const bool efill = (s >= begc && s < _begc) || (s > _ende && s <= endc);
        const int ef = efill ? r.inf : 0;
        e1v[u] = emask ? v.e1[u] : ef;
        e2v[u] = emask ? (gm == CONVEX_GAP ? v.e2[u] : 0) : ef;
      } else if (emask) {
        e1v[u] = max(e1v[u], v.e1[u]);
        if (gm == CONVEX_GAP) e2v[u] = max(e2v[u], v.e2[u]);
      }
    }
  }
}

// one predecessor slot p's part of the backtrack bits at the thread's
// positions (4-bit fields: the first slot of each condition, 15 = slot 15
// or later, or none; see late_pick)
template <int CPT>
__device__ __forceinline__ void bt_pred(
    const PredVals<CPT>& v, int p, const PBand& pb, int pn, const int* c,
    const int* qrow, const int* hrow, const int* e1row, const int* e2row,
    int gm, int e1, int oe1, int e2, int oe2, int (*acc)[9]) {
  const int plo = mulw(pb.begc, pn);
  const int phi = mulw(pb.endc + 1, pn) - 1;
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const bool m_in = pb.pvc && c[u] - 1 >= plo && c[u] - 1 <= phi;
    const bool okp = pb.pvc && c[u] >= plo && c[u] <= phi;
    const int bm = m_in ? v.hm[u] : NEG;
    const int bh = okp ? v.h[u] : NEG;
    const bool mh = bm + qrow[u] == hrow[u];
    bool e1m, e1x, e1o, e2m = false, e2x = false, e2o = false;
    if (gm == LINEAR_GAP) {
      e1m = e1x = (bh - e1) == hrow[u];
      e1o = false;
    } else {
      const int be1 = okp ? v.e1[u] : NEG;
      e1m = hrow[u] == be1;
      e1x = e1row[u] == be1 - e1;
      e1o = (bh - oe1) == be1;
      if (gm == CONVEX_GAP) {
        const int be2 = okp ? v.e2[u] : NEG;
        e2m = hrow[u] == be2;
        e2x = e2row[u] == be2 - e2;
        e2o = (bh - oe2) == be2;
      }
    }
    int* a = acc[u];
    if (p == 0) {
      a[0] = mh ? 0 : 15;
      a[1] = e1m ? 0 : 15;
      a[2] = e1x ? 0 : 15;
      a[3] = e1m && e1o;
      a[4] = e1x && e1o;
      a[5] = e2m ? 0 : 15;
      a[6] = e2x ? 0 : 15;
      a[7] = e2m && e2o;
      a[8] = e2x && e2o;
    } else {
      if (mh && a[0] == 15) a[0] = p;
      if (e1m && a[1] == 15) { a[3] = e1o; a[1] = p; }
      if (e1x && a[2] == 15) { a[4] = e1o; a[2] = p; }
      if (gm == CONVEX_GAP) {
        if (e2m && a[5] == 15) { a[7] = e2o; a[5] = p; }
        if (e2x && a[6] == 15) { a[8] = e2o; a[6] = p; }
      }
    }
  }
}

// the F bits of one cell from its own and its left lane's values (0 at
// the band start)
__device__ __forceinline__ int f_bits(int gm, int rel, int hh, int f1,
                                      int f2, int hprev, int f1prev,
                                      int f2prev, int e1, int oe1, int e2,
                                      int oe2) {
  if (rel == 0) hprev = f1prev = f2prev = 0;
  if (gm == LINEAR_GAP) return ((hprev - e1) == hh) << 24;
  int fb = (((hprev - oe1) == f1) << 24) | (((f1prev - e1) == f1) << 25)
           | ((hh == f1) << 26);
  if (gm == CONVEX_GAP)
    fb |= (((hprev - oe2) == f2) << 27) | (((f2prev - e2) == f2) << 28)
          | ((hh == f2) << 29);
  return fb;
}

// one instance per mode, gap mode (GM) and positions a thread (CPT):
// the code of a launch holds only the branches it runs
template <bool NID, int GM, int CPT>
__global__ void __launch_bounds__(MAX_NT) band_dp_kernel(BandArgs a) {
  extern __shared__ int smem[];
  constexpr int gm = GM;
  const int R = a.R, WB = a.WB, P = a.P, pn = a.pn;
  const int P2 = P / 2, NSEG = WB / pn, KW1 = a.Wq / WB + 1;
  const int b = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int lane_id = tid & 31, wid = tid >> 5, NW = NT >> 5;
  u64* s_red = reinterpret_cast<u64*>(smem);   // [32]
  int* s_ws1 = smem + 64;                      // [32] warp scan totals
  int* s_ws2 = s_ws1 + 32;
  int* s_edge = s_ws2 + 32;                    // [3 * 33] last positions
  int* s_ctrl = s_edge + 99;
  int* s_i2nn = s_ctrl + R;                    // node-id mode only
  int* s_pre = s_i2nn + (NID ? R : 0);
  int* s_bsn = s_pre + R * P2;
  int* s_rms = s_bsn + R;

  const int* ctrl = a.ctrl + (size_t)b * R;
  const int* inp = a.inp + (size_t)b * R * P2;
  for (int i = tid; i < R; i += NT) {
    s_ctrl[i] = ctrl[i];
    if (NID) s_i2nn[i] = a.i2nn[(size_t)b * R + i];
  }
  for (int i = tid; i < R * P2; i += NT) s_pre[i] = inp[i];
  const size_t plane = (size_t)R * WB;
  int* H = a.H + b * plane;
  int* E1 = a.E1 + b * plane;
  int* E2 = a.E2 + b * plane;
  int* BT = a.BT + b * plane;
  const int* qpf = a.qpf + (size_t)b * a.m * KW1 * WB;
  const int* mplr0 = a.mplr0 ? a.mplr0 + (size_t)b * R : nullptr;
  int* mplr_out = NID ? nullptr : a.mplr_out + (size_t)b * R;
  const int* sc = a.scal + (size_t)b * S_NSCAL;
  const int qlen = sc[S_QLEN], nrows = sc[S_NROWS], w = sc[S_W];
  const int inf = sc[S_INF], remend = sc[S_REMEND], dpsn = sc[S_DPSN];
  const int e1 = sc[S_E1], o1 = sc[S_O1], oe1 = sc[S_OE1];
  const int e2 = sc[S_E2], o2 = sc[S_O2], oe2 = sc[S_OE2];
  const int zdrop = sc[S_ZDROP];
  // the thread's band positions (scan order) and the last one's owner
  const int r0 = tid * CPT;
  const bool owns = r0 < WB;
  const bool last_owner = r0 + CPT == WB;
  __syncthreads();

  // ---- first row: its window is [0, WB), lane l holds col l ----
  int ovfl, cells = 0;
  {
    int rem0 = (s_ctrl[0] >> 16) - remend - 1;
    int end0 = min(qlen, max(0, qlen - rem0) + w);
    int end_sn0 = end0 >> a.pn_sh;
    int cap0 = min(end_sn0 + 1, dpsn - 1);
    ovfl = cap0 + 2 > NSEG;
    for (int l = tid; l < WB; l += NT) {
      bool hi_mask = (l >> a.pn_sh) <= cap0;
      bool de_mask = l <= (end_sn0 + 1) * pn - 1;
      int fill0 = hi_mask ? inf : 0;
      if (gm == LINEAR_GAP) {
        H[l] = de_mask ? mulw(-e1, l) : fill0;
      } else {
        int hv = -o1 - mulw(e1, l);
        if (gm == CONVEX_GAP) hv = max(hv, -o2 - mulw(e2, l));
        int h0 = (de_mask && l >= 1) ? hv : fill0;
        H[l] = l == 0 ? 0 : h0;
        E1[l] = l == 0 ? -oe1 : fill0;
        if (gm == CONVEX_GAP) E2[l] = l == 0 ? -oe2 : fill0;
      }
    }
    if (tid == 0) {
      s_rms[0] = RM_OK | 1;
      s_bsn[0] = shlw(end_sn0, 16);
      if (!NID) mplr_out[0] = 0;
    }
  }
  __syncthreads();

  // extend-mode best cell and z-drop state and the row just finished:
  // every thread keeps the same copy (all inputs are block-uniform)
  int bs = inf, bi = 0, bj = 0, brem = s_ctrl[0] >> 16;
  bool stop = false;
  int prev = -1, prev_rms = 0, prev_bsn = 0;
  // the row before's H, E1, E2 at the thread's lanes (and H at the lane
  // before them) and its lane offset: a predecessor that is the row
  // before, at the same lanes, is read from there
  int ph[CPT], pe1[CPT], pe2[CPT], ph_left = 0, prev_lomod = -1;
  int iw_next = (NID || !mplr0 || R < 2) ? nrows : mplr0[1];
  DP_PROBE_INIT
  const int limit = min(nrows - 1, R - 1);
  for (int t = 1; t < limit; ++t) {
    // ---- per-row scalars (every thread computes them from shared) ----
    const int rid = NID ? min(max(s_i2nn[t] & H16, 0), R - 1) : t;
    const int cw = s_ctrl[rid];
    const int npre = min(NID ? (cw >> 10) & 15 : (cw >> 5) & 31, P);
    const bool active = NID || (((cw >> 10) & 1) && !stop);
    // the band-state init of this row, loaded during the row before
    const int iw = iw_next;
    iw_next = (NID || !mplr0 || t + 1 >= R) ? nrows : mplr0[t + 1];
    int mpl, mpr, min_pb;
    pull_band(s_pre, s_rms, s_bsn, P2, R, rid, npre, iw, prev, prev_rms,
              prev_bsn, mpl, mpr, min_pb);
    if (!NID && tid == 0) mplr_out[t] = (int)((unsigned)mpl | shlw(mpr, 16));
    const int rem = (cw >> 16) - remend - 1;
    const int beg = max(0, min(mpl, qlen - rem) - w);
    const int end = min(qlen, max(mpr, qlen - rem) + w);
    const int beg_sn = max(beg >> a.pn_sh, min_pb);
    const int end_sn = end >> a.pn_sh;
    if (tid == 0 && active) {
      cells += (end_sn - beg_sn + 1) * pn;
      int capg = min(end_sn + 1, dpsn - 1);
      ovfl |= capg - beg_sn + 2 > NSEG;
    }
    const int lo_g = mulw(beg_sn, pn);
    // floor(lo_g / WB): a multiply by ceil(2^32 / WB), exact below 2^18
    const int k0 = (unsigned)lo_g < (1u << 18)
                       ? (int)__umulhi((unsigned)lo_g, a.wb_inv)
                       : floordiv(lo_g, WB);
    // the packed staging word of the JAX kernel: beg|end<<10|lomod<<20
    const int bel = (int)((unsigned)beg_sn | ((unsigned)end_sn << 10)
                          | ((unsigned)(lo_g - k0 * WB) << 20));
    Row r;
    r.begc = bel & 1023;
    r.endc = (bel >> 10) & 1023;
    r.capc = min(r.endc + 1, dpsn - 1);
    r.dpsn = dpsn;
    r.pn = pn;
    r.inf = inf;
    r.e1 = e1;
    const int lomodc = bel >> 20;
    const int base = cw & (NID ? 7 : 31);
    const int fold = min(max(base * KW1 + k0, 0), a.m * KW1 - 2);
    // position ri of the scan is lane (ri + lomodc) mod WB; rel is the
    // lane's offset from the band start (== ri on every swept row; a row
    // with no valid predecessor has a garbage band whose lanes wrap)
    const bool sane = lomodc >= 0 && lomodc < WB;
    const bool vec = sane && (lomodc & (CPT - 1)) == 0;
    const bool regs = lomodc == prev_lomod;
    int lane[CPT], rel[CPT], c[CPT], seg[CPT], qraw[CPT], qrow[CPT];
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int ri = owns ? r0 + u : 0;
      int l = ri + lomodc;
      if (sane) l -= l >= WB ? WB : 0;
      else l = floormod(l, WB);
      const int dlo = l - lomodc;
      lane[u] = l;
      rel[u] = dlo >= 0 ? dlo : dlo + WB;
      c[u] = r.begc * pn + rel[u];
      seg[u] = c[u] >> a.pn_sh;
      qraw[u] = base < a.m
                    ? qpf[(size_t)(l >= lomodc ? fold : fold + 1) * WB + l]
                    : 0;
    }
    // the query profile of the row's columns, masked where it is first
    // used (the merge with linear gaps, the F scan otherwise), so its load
    // overlaps the merge
    auto mask_q = [&]() {
#pragma unroll
      for (int u = 0; u < CPT; ++u)
        qrow[u] = (c[u] >= 1 && c[u] <= qlen) ? qraw[u] : 0;
    };
    if (gm == LINEAR_GAP) mask_q();

    DP_PROBE(0)
    // ---- predecessor merges; the first slot's values stay for the
    // backtrack bits ----
    int h[CPT], e1v[CPT], e2v[CPT];
    PredVals<CPT> first;
    PBand fb;
    {
      const int pred = pre_at(s_pre, P2, R, rid, 0);
      fb = pband(pred == prev ? prev_bsn : s_bsn[pred], npre > 0);
      if (regs && pred == prev)
        from_regs(first, ph, pe1, pe2, ph_left);
      else
        load_pred(first, H, E1, E2, pred, lane, vec, WB, gm);
    }
    merge_pred(r, first, true, fb, c, seg, qrow, gm, h, e1v, e2v);
    for (int p = 1; p < npre; ++p) {
      const int pred = pre_at(s_pre, P2, R, rid, p);
      const PBand pb = pband(pred == prev ? prev_bsn : s_bsn[pred], true);
      PredVals<CPT> v;
      if (regs && pred == prev)
        from_regs(v, ph, pe1, pe2, ph_left);
      else
        load_pred(v, H, E1, E2, pred, lane, vec, WB, gm);
      merge_pred(r, v, false, pb, c, seg, qrow, gm, h, e1v, e2v);
    }
    if (gm == LINEAR_GAP) {
#pragma unroll
      for (int u = 0; u < CPT; ++u) e1v[u] = e2v[u] = h[u];
    } else if (gm != CONVEX_GAP) {
#pragma unroll
      for (int u = 0; u < CPT; ++u) e2v[u] = h[u];
    }

    DP_PROBE(1)
    if (gm != LINEAR_GAP) mask_q();

    // ---- F (insertion) recurrences as prefix maxes in band order ----
    int band[CPT], h0[CPT], src[CPT];
    int cmax1 = NEG, cmax2 = NEG;
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      band[u] = seg[u] >= r.begc && seg[u] <= r.endc;
      if (gm == LINEAR_GAP) {
        h0[u] = h[u];
        src[u] = h[u];
        cmax1 = max(cmax1, band[u] ? max(h[u], inf) + rel[u] * e1 : NEG);
      } else {
        h0[u] = h[u] + (band[u] ? qrow[u] : 0);
        src[u] = !band[u] ? NEG
                 : gm == CONVEX_GAP ? max(max(h0[u], e1v[u]), e2v[u])
                                    : h0[u];
        cmax1 = max(cmax1, band[u] ? max(src[u], inf) + rel[u] * e1 : NEG);
        if (gm == CONVEX_GAP)
          cmax2 = max(cmax2, band[u] ? max(src[u], inf) + rel[u] * e2 : NEG);
      }
    }
    if (!owns) cmax1 = cmax2 = NEG;
    int in1 = cmax1, in2 = cmax2;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x1 = __shfl_up_sync(~0u, in1, d);
      const int x2 = __shfl_up_sync(~0u, in2, d);
      if (lane_id >= d) {
        in1 = max(in1, x1);
        in2 = max(in2, x2);
      }
    }
    int pm1 = __shfl_up_sync(~0u, in1, 1);
    int pm2 = __shfl_up_sync(~0u, in2, 1);
    if (lane_id == 0) pm1 = pm2 = NEG;
    if (lane_id == 31) {
      s_ws1[wid] = in1;
      s_ws2[wid] = in2;
    }
    __syncthreads();
    DP_PROBE(2)
    // across warps: lane k holds warp k's total; the warps before this
    // one, by a warp reduction
    {
      pm1 = max(pm1, __reduce_max_sync(
                         ~0u, lane_id < wid ? s_ws1[lane_id] : NEG));
      pm2 = max(pm2, __reduce_max_sync(
                         ~0u, lane_id < wid ? s_ws2[lane_id] : NEG));
    }
    int hrow[CPT], e1row[CPT], e2row[CPT], f1row[CPT], f2row[CPT];
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      e1row[u] = e2row[u] = f1row[u] = f2row[u] = 0;
      const int ru = rel[u];
      if (gm == LINEAR_GAP) {
        pm1 = max(pm1, band[u] ? max(h[u], inf) + ru * e1 : NEG);
        const int hfin = max(pm1 - ru * e1, inf);
        hrow[u] = band[u] ? hfin : h[u];
      } else {
        // pm1/pm2: the prefix max before this position (exclusive)
        int f1 = ru == 0 ? h0[u] - oe1 : pm1 - oe1 - (ru - 1) * e1;
        f1 = max(f1, inf);
        pm1 = max(pm1, band[u] ? max(src[u], inf) + ru * e1 : NEG);
        if (gm == CONVEX_GAP) {
          int f2 = ru == 0 ? h0[u] - oe2 : pm2 - oe2 - (ru - 1) * e2;
          f2 = max(f2, inf);
          pm2 = max(pm2, band[u] ? max(src[u], inf) + ru * e2 : NEG);
          const int hh = max(max(src[u], f1), f2);
          hrow[u] = band[u] ? hh : h0[u];
          e1row[u] = band[u] ? max(e1v[u] - e1, hh - oe1) : e1v[u];
          e2row[u] = band[u] ? max(e2v[u] - e2, hh - oe2) : e2v[u];
          f2row[u] = band[u] ? f2 : 0;
        } else {
          const int h1 = max(h0[u], e1v[u]);
          const int hh = max(h1, f1);
          const int e1n = max(e1v[u] - e1, hh - oe1);
          hrow[u] = band[u] ? hh : h0[u];
          e1row[u] = band[u] ? (hh == h1 ? e1n : inf) : e1v[u];
        }
        f1row[u] = band[u] ? f1 : 0;
      }
    }
    if (owns) {
      int* Hr = H + (size_t)rid * WB;
      int* E1r = E1 + (size_t)rid * WB;
      int* E2r = E2 + (size_t)rid * WB;
      if (vec) {
        st_run<CPT>(Hr + lane[0], hrow);
        if (gm != LINEAR_GAP) st_run<CPT>(E1r + lane[0], e1row);
        if (gm == CONVEX_GAP) st_run<CPT>(E2r + lane[0], e2row);
      } else {
#pragma unroll
        for (int u = 0; u < CPT; ++u) {
          Hr[lane[u]] = hrow[u];
          if (gm != LINEAR_GAP) E1r[lane[u]] = e1row[u];
          if (gm == CONVEX_GAP) E2r[lane[u]] = e2row[u];
        }
      }
    }

    DP_PROBE(3)
    // ---- backtrack bits: every comparison the walk makes, per cell; a
    // pick field holds slots 0-14, 15 stands for the rest ----
    int acc[CPT][9];
    bt_pred(first, 0, fb, pn, c, qrow, hrow, e1row, e2row, gm, e1, oe1, e2,
            oe2, acc);
    for (int p = 1; p < min(npre, 15); ++p) {
      const int pred = pre_at(s_pre, P2, R, rid, p);
      const PBand pb = pband(pred == prev ? prev_bsn : s_bsn[pred], true);
      PredVals<CPT> v;
      if (regs && pred == prev)
        from_regs(v, ph, pe1, pe2, ph_left);
      else
        load_pred(v, H, E1, E2, pred, lane, vec, WB, gm);
      bt_pred(v, p, pb, pn, c, qrow, hrow, e1row, e2row, gm, e1, oe1, e2,
              oe2, acc);
    }
    int bt[CPT];
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int* q = acc[u];
      bt[u] = q[0] | (q[1] << 4) | (q[2] << 8) | (q[3] << 12) | (q[4] << 13)
              | (q[5] << 14) | (q[6] << 18) | (q[7] << 22) | (q[8] << 23);
      if (u > 0)
        bt[u] |= f_bits(gm, rel[u], hrow[u], f1row[u], f2row[u],
                        hrow[u - 1], f1row[u - 1], f2row[u - 1], e1, oe1, e2,
                        oe2);
    }
    // the first position's left lane: the thread before, else (after the
    // barrier) the last position of the warp before or, for position 0,
    // of the row
    const int nh = __shfl_up_sync(~0u, hrow[CPT - 1], 1);
    const int nf1 = __shfl_up_sync(~0u, f1row[CPT - 1], 1);
    const int nf2 = __shfl_up_sync(~0u, f2row[CPT - 1], 1);
    if (lane_id > 0)
      bt[0] |= f_bits(gm, rel[0], hrow[0], f1row[0], f2row[0], nh, nf1, nf2,
                      e1, oe1, e2, oe2);
    if (lane_id == 31) {
      s_edge[wid] = hrow[CPT - 1];
      s_edge[33 + wid] = f1row[CPT - 1];
      s_edge[66 + wid] = f2row[CPT - 1];
    }
    if (last_owner) {
      s_edge[32] = hrow[CPT - 1];
      s_edge[33 + 32] = f1row[CPT - 1];
      s_edge[66 + 32] = f2row[CPT - 1];
    }

    DP_PROBE(4)
    // ---- row max with the reference tie-breaks: among maximal in-band
    // cells the lowest lane-in-segment, then the last segment, then the
    // first: one key, the lane above 17 bits of segment order (the JAX
    // kernel's 15 bits overflow from segment 31 of a band on) ----
    u64 kbest = 0;
    if (owns) {
      const int nseg = r.endc - r.begc + 1;
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int lseg = seg[u] - r.begc;
        const int vv = (band[u] && c[u] <= qlen) ? hrow[u] : inf;
        const int prio = lseg == nseg - 1 ? -1 : lseg;
        const int lis = rel[u] >= 0 ? rel[u] & (pn - 1) : rel[u] % pn;
        const int key = lis * (1 << 17) + (prio * 1024 + lseg + 1024);
        const u64 k = best_key(vv, key);
        kbest = k > kbest ? k : kbest;
      }
    }
    kbest = warp_max64(kbest);
    if (lane_id == 0) s_red[wid] = kbest;
    __syncthreads();
    DP_PROBE(5)
    const int e = wid > 0 ? wid - 1 : 32;
    if (lane_id == 0)
      bt[0] |= f_bits(gm, rel[0], hrow[0], f1row[0], f2row[0], s_edge[e],
                      s_edge[33 + e], s_edge[66 + e], e1, oe1, e2, oe2);
    ph_left = lane_id > 0 ? nh : s_edge[e];
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      ph[u] = hrow[u];
      pe1[u] = e1row[u];
      pe2[u] = e2row[u];
    }
    prev_lomod = lomodc;
    if (owns) {
      int* BTr = BT + (size_t)rid * WB;
      if (vec) {
        st_run<CPT>(BTr + lane[0], bt);
      } else {
#pragma unroll
        for (int u = 0; u < CPT; ++u) BTr[lane[u]] = bt[u];
      }
    }
    const u64 g = warp_max64(lane_id < NW ? s_red[lane_id] : 0);
    const int gmax = (int)((unsigned)(g >> 32) ^ 0x80000000u);
    const int kpick = (int)(~(unsigned)(g & 0xFFFFFFFFu) ^ 0x80000000u);
    const int aux_pick = (kpick & 0x1FFFF) - 1024;
    const int wseg = aux_pick - floordiv(aux_pick, 1024) * 1024;
    const int maxi = gmax > inf ? (r.begc + wseg) * pn + (kpick >> 17) : -1;
    bool stop_now = false;
    if (!NID && a.extend) {
      const bool better = gmax > bs;
      if (a.zdrop_on) {
        const int delta = brem - (cw >> 16);
        const int zlim = zdrop + mulw(e1, abs(delta - (maxi - bj)));
        stop_now = !better && bs - gmax > zlim;
      }
      if (active && better) {
        bs = gmax;
        bi = t;
        bj = maxi;
        brem = cw >> 16;
      }
      stop_now = active && stop_now;
      stop = stop || stop_now;
    }
    DP_PROBE(6)
    prev = rid;
    prev_rms = (active && !stop_now) ? (RM_OK | (maxi + 1)) : 0;
    prev_bsn = (int)((unsigned)beg_sn | ((unsigned)end_sn << 16));
    if (tid == 0) {
      s_rms[rid] = prev_rms;
      s_bsn[rid] = prev_bsn;
    }
  }
  __syncthreads();

  if (!NID) {
    // band bounds out; the sink row is never swept: pin its bsn and pull
    // its band state
    for (int i = tid; i < limit; i += NT)
      a.bsn_out[(size_t)b * R + i] = s_bsn[i];
    if (tid == 0 && limit >= 0) {
      int npre_l = min((s_ctrl[limit] >> 5) & 31, P);
      int iw = mplr0 ? mplr0[limit] : nrows;
      int mpl, mpr, min_pb;
      pull_band(s_pre, s_rms, s_bsn, P2, R, limit, npre_l, iw, -1, 0, 0, mpl,
                mpr, min_pb);
      mplr_out[limit] = (int)((unsigned)mpl | shlw(mpr, 16));
      s_bsn[limit] = 0;
    }
  }
  if (tid != 0) return;
  int* misc = a.misc + (size_t)b * M_NMISC;
  if (!a.extend) {
    // ---- best cell over the sink's predecessors ----
    bs = inf;
    bi = bj = 0;
    const int sink = NID ? SINK_NODE_ID : min(max(nrows - 1, 0), R - 1);
    const int npre_sink = min(NID ? (s_ctrl[sink] >> 10) & 15
                                  : (s_ctrl[sink] >> 5) & 31, P);
    for (int p = 0; p < npre_sink; ++p) {
      int pred = pre_at(s_pre, P2, R, sink, p);
      int pw = s_bsn[pred];
      int ec = min(qlen, ((pw >> 16) + 1) * pn - 1);
      int lo_p = (pw & H16) * pn;
      int val = H[(size_t)pred * WB + floormod(ec, WB)];
      if (!(ec >= lo_p && ec < lo_p + WB)) val = 0;
      if (val > bs) {
        bs = val;
        bi = pred;
        bj = ec;
      }
    }
  }
  misc[M_BEST] = bs;
  misc[M_BI] = NID ? s_i2nn[bi] >> 16 : bi;
  misc[M_BJ] = bj;
  misc[M_CELLS] = cells;
  misc[M_OVFL] = ovfl;
  if (a.LS == 0) return;
  DP_PROBE_MARK

  // ---- the walk: one backtrack word per step; node-id mode emits the
  // steps16 deltas (op | dj<<2 | di<<3 in topo space), two halves per
  // word, topo mode the int64 words op | row<<2 | col<<32 ----
  int* s16 = NID ? a.s16w + (size_t)b * (a.LS / 2) : nullptr;
  long long* st = NID ? nullptr : a.steps + (size_t)b * max(a.LS, 8);
  int I = bi, J = bj, lane = floormod(bj, WB), cur = BT_ALL, nst = 0;
  bool if_ = true, fail = false;
  int PI = NID ? s_i2nn[bi] >> 16 : 0, PJ = bj;
  unsigned half = 0;
  bool done = bi <= 0 || bj <= 0 || ovfl;
  // the pick conditions late_pick re-tests (as bt_pred tests them)
  enum { K_M, K_E1M, K_E1X, K_E2M, K_E2X };
  while (!done) {
    int wv = s_bsn[I];
    int lo_i = (wv & H16) * pn;
    const bool inwin = J >= lo_i && J < lo_i + WB;
    int bb = inwin ? BT[(size_t)I * WB + lane] : INVALID_BITS;
    // topo mode: a pick field of 15 reads "slot 15 or later, or none"
    const int npre_i = NID ? 0 : min((s_ctrl[I] >> 5) & 31, P);
    const bool late = !NID && inwin && npre_i > 15;
    // the first slot p in [15, npre_i) at which condition `kind` holds at
    // cell (I, J), or 99; `open` gets that slot's open bit (E kinds)
    auto late_pick = [&](int kind, int& open) -> int {
      const size_t ri = (size_t)I * WB + lane;
      const int hrow = H[ri];
      const int xrow = kind == K_E1X ? E1[ri] : kind == K_E2X ? E2[ri] : 0;
      int q = 0;
      if (kind == K_M) {
        // the row's query profile at column J, as the sweep loads it
        const int base = s_ctrl[I] & 31;
        const int k0 = floordiv(lo_i, WB);
        const int lomod = lo_i - k0 * WB;
        const int fold = min(max(base * KW1 + k0, 0), a.m * KW1 - 2);
        const int qraw =
            base < a.m
                ? qpf[(size_t)(lane >= lomod ? fold : fold + 1) * WB + lane]
                : 0;
        q = (J >= 1 && J <= qlen) ? qraw : 0;
      }
      const int lm = lane == 0 ? WB - 1 : lane - 1;
      const bool two = kind == K_E2M || kind == K_E2X;
      for (int p = 15; p < npre_i; ++p) {
        const int pred = pre_at(s_pre, P2, R, I, p);
        const PBand pb = pband(s_bsn[pred], true);
        const int plo = mulw(pb.begc, pn);
        const int phi = mulw(pb.endc + 1, pn) - 1;
        const size_t ro = (size_t)pred * WB;
        const bool okp = pb.pvc && J >= plo && J <= phi;
        const int bh = okp ? H[ro + lane] : NEG;
        bool hit;
        int o = 0;
        if (kind == K_M) {
          const bool m_in = pb.pvc && J - 1 >= plo && J - 1 <= phi;
          hit = (m_in ? H[ro + lm] : NEG) + q == hrow;
        } else if (gm == LINEAR_GAP) {
          hit = (bh - e1) == hrow;
        } else {
          const int be = okp ? (two ? E2 : E1)[ro + lane] : NEG;
          hit = (kind == K_E1M || kind == K_E2M) ? hrow == be
                                                 : xrow == be - (two ? e2 : e1);
          o = (bh - (two ? oe2 : oe1)) == be;
        }
        if (hit) {
          open = o;
          return p;
        }
      }
      return 99;
    };
    bool curM = (cur & BT_M) != 0;
    // the M pick's slot (99: none), resolved where the walk reads it
    int mslot = -1;
    auto m_slot = [&]() -> int {
      if (mslot < 0) {
        int o;
        const int f = bb & 15;
        mslot = f < 15 ? f : (late ? late_pick(K_M, o) : 99);
      }
      return mslot;
    };
    bool use_m1 = curM && !if_ && m_slot() < 99;
    bool e_possible = false, f_possible;
    int e_pick_p = 0, e_op_sel = BT_ALL, f_op_sel;
    if (gm == LINEAR_GAP) {
      if (!use_m1) {
        int o;
        const int f = (bb >> 4) & 15;
        e_pick_p = f < 15 ? f : (late ? late_pick(K_E1M, o) : 99);
        e_possible = e_pick_p < 99;
      }
      f_possible = (bb >> 24) & 1;
      f_op_sel = BT_ALL;
    } else {
      if (!use_m1 && (cur & BT_E)) {
        const int f1 = curM ? (bb >> 4) & 15 : (bb >> 8) & 15;
        int o1 = curM ? (bb >> 12) & 1 : (bb >> 13) & 1;
        const bool g1 = cur & BT_E1;
        int f2 = 15, o2 = 0;
        bool g2 = false;
        if (gm == CONVEX_GAP) {
          f2 = curM ? (bb >> 14) & 15 : (bb >> 18) & 15;
          o2 = curM ? (bb >> 22) & 1 : (bb >> 23) & 1;
          g2 = cur & BT_E2;
        }
        int s1 = g1 && f1 < 15 ? f1 : 99;
        int s2 = g2 && f2 < 15 ? f2 : 99;
        // candidate order interleaves (p0.e1, p0.e2, p1.e1, ...): a slot
        // of 15 or later is searched only where it can come first
        if (g1 && f1 == 15 && late && s2 == 99)
          s1 = late_pick(curM ? K_E1M : K_E1X, o1);
        if (g2 && f2 == 15 && late && s1 >= 15)
          s2 = late_pick(curM ? K_E2M : K_E2X, o2);
        int k1 = s1 < 99 ? 2 * s1 : 99;
        int k2 = s2 < 99 ? 2 * s2 + 1 : 99;
        bool use_e1 = k1 <= k2;
        e_possible = min(k1, k2) < 99;
        e_pick_p = use_e1 ? s1 : s2;
        e_op_sel = use_e1 ? (o1 ? (BT_M | BT_F) : BT_E1)
                          : (o2 ? (BT_M | BT_F) : BT_E2);
      }
      bool f1o = (bb >> 24) & 1, f1x = (bb >> 25) & 1, f1g = (bb >> 26) & 1;
      bool hit_f1 = (cur & BT_F1) && (curM ? f1g : true) && (f1o || f1x);
      int op_f1 = f1o ? (BT_M | BT_E) : BT_F1;
      bool hit_f2 = false;
      int op_f2 = BT_ALL;
      if (gm == CONVEX_GAP) {
        bool f2o = (bb >> 27) & 1, f2x = (bb >> 28) & 1,
             f2g = (bb >> 29) & 1;
        hit_f2 = (cur & BT_F2) && (curM ? f2g : true) && (f2o || f2x);
        op_f2 = f2o ? (BT_M | BT_E) : BT_F2;
      }
      f_possible = hit_f1 || hit_f2;
      f_op_sel = hit_f1 ? op_f1 : op_f2;
    }
    bool use_e = !use_m1 && e_possible;
    bool use_f = !use_m1 && !use_e && f_possible;
    if (gm != LINEAR_GAP) use_f = use_f && (cur & BT_F);
    bool use_m2 = !use_m1 && !use_e && !use_f && if_
                  && (gm == LINEAR_GAP || curM) && m_slot() < 99;
    bool any_hit = use_m1 || use_e || use_f || use_m2;
    bool use_m = use_m1 || use_m2;
    int new_i = I;
    if (use_m) new_i = pre_at(s_pre, P2, R, I, min(mslot, P - 1));
    else if (use_e) new_i = pre_at(s_pre, P2, R, I, min(e_pick_p, P - 1));
    if (any_hit) {
      int op_code = use_m ? 0 : (use_e ? 2 : 1);
      if (NID) {
        int ti = s_i2nn[I] >> 16;
        unsigned hw = ((unsigned)op_code | ((unsigned)(PJ - J) << 2)
                       | ((unsigned)(PI - ti) << 3)) & 0xFFFFu;
        if (nst & 1) s16[nst >> 1] = (int)(half | (hw << 16));
        else half = hw;
        PI = ti;
        PJ = J;
      } else {
        st[nst] = (long long)op_code | ((long long)I << 2)
                  | ((long long)J << 32);
      }
      ++nst;
    }
    bool dj = use_m || use_f;
    int new_j = J - dj;
    int nl = lane - dj;
    lane = nl < 0 ? nl + WB : nl;
    cur = use_m ? BT_ALL : (use_e ? e_op_sel : (use_f ? f_op_sel : cur));
    if (use_m) if_ = false;
    fail = !any_hit;
    I = new_i;
    J = new_j;
    done = fail || new_i <= 0 || new_j <= 0 || nst >= a.LS;
  }
  if (NID && (nst & 1)) s16[nst >> 1] = (int)(half & 0xFFFFu);
  DP_PROBE(7)
  DP_PROBE_SAVE(limit, nst)
  misc[M_NSTEPS] = nst;
  misc[M_FAIL] = fail;
  misc[M_ENDI] = NID ? s_i2nn[I] >> 16 : I;
  misc[M_ENDJ] = J;
  misc[M_LASTI] = PI;
}

// ---- the staged topo-mode launch's prologue ----

// byte offsets of the staged sections (ops/band_dp.py TopoStage; each
// section [B, n] of its dtype) and the words the prologue writes
struct StageArgs {
  const unsigned char* st;
  int o_scal, o_pre, o_pre_n, o_remain, o_mpl, o_mpr, o_bases, o_qcodes,
      o_rowmask;
  int* scal;          // [B, S_NSCAL]
  int* ctrl;          // [B, R] base | pre_n<<5 | rowmask<<10 | remain<<16
  int* pre;           // [B, R*P/2] predecessor rows, two a word
  int* mplr0;         // [B, R] mpl | mpr<<16 (not fresh)
  int* qpf;           // [B, m*KW1, WB] query-profile folds
  int* bsn;           // outputs, zeroed
  int* mplr;
  int* misc;
  long long* steps;   // [B, LS8]
  int R, P, Wq, WB, m, LS8, delta, fresh;
};

template <typename T>
__device__ __forceinline__ const T* section(const StageArgs& a, int off,
                                            size_t b, size_t n) {
  return reinterpret_cast<const T*>(a.st + off) + b * n;
}

// one instance per blockIdx.x, its elements split over blockIdx.y and the
// threads; every word as ops/band_dp.py _pack_topo and build_qpf compute
// it (int32 wrap-around, sign-extended narrow inputs)
__global__ void topo_stage_kernel(StageArgs a) {
  const size_t b = blockIdx.x;
  const int i0 = blockIdx.y * blockDim.x + threadIdx.x;
  const int di = gridDim.y * blockDim.x;
  const int R = a.R, P = a.P, m = a.m, SC = S_NSCAL + m * m;
  const int* sc = section<int>(a, a.o_scal, b, SC);
  for (int i = i0; i < S_NSCAL; i += di) a.scal[b * S_NSCAL + i] = sc[i];
  for (int i = i0; i < M_NMISC; i += di) a.misc[b * M_NMISC + i] = 0;
  const signed char* bases = section<signed char>(a, a.o_bases, b, R);
  const short* pre_n = section<short>(a, a.o_pre_n, b, R);
  const short* remain = section<short>(a, a.o_remain, b, R);
  for (int t = i0; t < R; t += di) {
    const unsigned rm =
        a.fresh ? 1u
                : (unsigned)(int)section<signed char>(a, a.o_rowmask, b, R)[t];
    a.ctrl[b * R + t] = (int)((unsigned)(int)bases[t]
                              | ((unsigned)(int)pre_n[t] << 5) | (rm << 10)
                              | ((unsigned)(int)remain[t] << 16));
    if (!a.fresh)
      a.mplr0[b * R + t] =
          (int)((unsigned)(int)section<short>(a, a.o_mpl, b, R)[t]
                | ((unsigned)(int)section<short>(a, a.o_mpr, b, R)[t] << 16));
    a.bsn[b * R + t] = 0;
    a.mplr[b * R + t] = 0;
  }
  // predecessor rows two a word; uint8 deltas decode to max(t - d, 0)
  const int nw = R * P / 2;
  for (int k = i0; k < nw; k += di) {
    int v0, v1;
    if (a.delta) {
      const unsigned char* d =
          section<unsigned char>(a, a.o_pre, b, (size_t)R * P);
      const int t = 2 * k / P;
      v0 = max(t - (int)d[2 * k], 0);
      v1 = max(t - (int)d[2 * k + 1], 0);
    } else {
      const short* s = section<short>(a, a.o_pre, b, (size_t)R * P);
      v0 = s[2 * k];
      v1 = s[2 * k + 1];
    }
    a.pre[b * nw + k] = (int)((unsigned)v0 | ((unsigned)v1 << 16));
  }
  // fold f = base * KW1 + k holds mat[base, code(col)] for the columns
  // [k*WB, (k+1)*WB); the last fold of each base is zeros
  const int KW1 = a.Wq / a.WB + 1, nq = m * KW1 * a.WB;
  const signed char* qc = section<signed char>(a, a.o_qcodes, b, a.Wq);
  for (int i = i0; i < nq; i += di) {
    const int f = i / a.WB, l = i - f * a.WB;
    const int base = f / KW1, k = f - base * KW1;
    int v = 0;
    if (k < KW1 - 1) {
      const int code = qc[k * a.WB + l];
      if ((unsigned)code < (unsigned)m) v = sc[S_NSCAL + base * m + code];
    }
    a.qpf[b * nq + i] = v;
  }
  for (int i = i0; i < a.LS8; i += di) a.steps[b * a.LS8 + i] = 0;
}

// the same number as ops/band_dp.py band_smem_bytes
size_t band_smem_bytes(bool nid, int R, int P) {
  return sizeof(int) * ((size_t)(3 + (nid ? 1 : 0) + P / 2) * R + 227);
}

template <bool NID, int GM, int CPT>
int launch_cpt(const BandArgs& a, int B, void* stream) {
  size_t smem = band_smem_bytes(NID, a.R, a.P);
  cudaError_t err = cudaFuncSetAttribute(
      band_dp_kernel<NID, GM, CPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int NT = (a.WB / CPT + 31) / 32 * 32;
  band_dp_kernel<NID, GM, CPT><<<B, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// 2 positions a thread up to 1024 lanes, 4 past them (ops/band_dp.py
// band_cpt)
template <bool NID, int GM>
int launch_gm(const BandArgs& a, int B, void* stream) {
  if (a.WB > 1024) return launch_cpt<NID, GM, 4>(a, B, stream);
  return launch_cpt<NID, GM, 2>(a, B, stream);
}

// the gap mode's instance (a mode neither linear nor convex is affine)
template <bool NID>
int launch(const BandArgs& a, int B, void* stream) {
  if (a.gm == LINEAR_GAP) return launch_gm<NID, LINEAR_GAP>(a, B, stream);
  if (a.gm == CONVEX_GAP) return launch_gm<NID, CONVEX_GAP>(a, B, stream);
  return launch_gm<NID, AFFINE_GAP>(a, B, stream);
}

unsigned wb_inv(int WB) {
  return (unsigned)(((1ull << 32) + WB - 1) / WB);
}

// the geometry both entries take: WB a multiple of 32 up to max_wb, pn a
// power of two (divisions by it are shifts)
bool bad_geometry(int WB, int pn, int max_wb) {
  return WB % 32 || WB > max_wb || pn <= 0 || (pn & (pn - 1)) || WB % pn;
}

}  // namespace
}  // namespace abpoa

DP_PROBE_EXPORT

// C entry points (bound with ctypes). Each enqueues its kernel on
// `stream` and returns the cudaError_t of the launch.

// node-id mode: global, fresh band state, m = 5
extern "C" int band_dp_launch(const int* scal, const int* ctrl,
                              const int* inp, const int* i2nn,
                              const int* qpf, int* misc, int* s16w, int* H,
                              int* E1, int* E2, int* BT, int B, int R,
                              int WB, int Wq, int P, int pn, int gap_mode,
                              int LS, void* stream) {
  using namespace abpoa;
  if (B <= 0) return 0;
  if (bad_geometry(WB, pn, MAX_WB) || P % 2 || P > 15)
    return (int)cudaErrorInvalidValue;
  BandArgs a{scal, ctrl, inp, i2nn, nullptr, qpf, misc, s16w, nullptr,
             nullptr, nullptr, H, E1, E2, BT,
             R, WB, Wq, P, pn, __builtin_ctz(pn), gap_mode, LS, 5, 0, 0,
             wb_inv(WB)};
  return launch<true>(a, B, stream);
}

// topo mode, staged: global or extend, fresh or not. `staged` holds the
// inputs on the card (offsets o_*, ops/band_dp.py TopoStage); with `host`
// set they are first copied there from host memory (nbytes, one
// asynchronous copy: pinned memory does not block the caller). `ws`
// takes the prologue's words: scal [B, S_NSCAL], ctrl [B, R], pre
// [B, R*P/2], mplr0 [B, R], qpf [B, m*KW1, WB] (ops/band_dp.py
// topo_ws_words). The prologue zeroes bsn, mplr, misc and steps
// [B, max(LS, 8)].
extern "C" int band_dp_topo_staged_launch(
    const unsigned char* host, unsigned char* staged, size_t nbytes,
    int* ws, int* bsn_out, int* mplr_out, int* misc, long long* steps,
    int* H, int* E1, int* E2, int* BT, int o_scal, int o_pre, int o_pre_n,
    int o_remain, int o_mpl, int o_mpr, int o_bases, int o_qcodes,
    int o_rowmask, int B, int R, int WB, int Wq, int P, int pn, int gap_mode,
    int LS, int m, int align_mode, int zdrop_on, int fresh, int delta,
    void* stream) {
  using namespace abpoa;
  if (B <= 0) return 0;
  if (bad_geometry(WB, pn, MAX_WB) || P % 2 || P > MAX_P_TOPO || m > 31
      || Wq % WB || (align_mode != 0 && align_mode != 2))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (host) {
    err = cudaMemcpyAsync(staged, host, nbytes, cudaMemcpyHostToDevice,
                          (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t nb = B;
  const int KW1 = Wq / WB + 1;
  StageArgs s{staged, o_scal, o_pre, o_pre_n, o_remain, o_mpl, o_mpr,
              o_bases, o_qcodes, o_rowmask, nullptr, nullptr, nullptr,
              nullptr, nullptr, bsn_out, mplr_out, misc, steps,
              R, P, Wq, WB, m, LS > 8 ? LS : 8, delta, fresh};
  s.scal = ws;
  s.ctrl = s.scal + nb * S_NSCAL;
  s.pre = s.ctrl + nb * R;
  s.mplr0 = s.pre + nb * R * (P / 2);
  s.qpf = s.mplr0 + nb * R;
  // enough blocks an instance that none takes more than ~2k elements
  const size_t most = std::max({(size_t)m * KW1 * WB, (size_t)R * P / 2,
                                 (size_t)R, (size_t)s.LS8});
  const int ny = (int)std::min<size_t>(32, (most + 2047) / 2048);
  topo_stage_kernel<<<dim3(B, ny), 256, 0, (cudaStream_t)stream>>>(s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  BandArgs a{s.scal, s.ctrl, s.pre, nullptr, fresh ? nullptr : s.mplr0,
             s.qpf, misc, nullptr, steps, bsn_out, mplr_out, H, E1, E2, BT,
             R, WB, Wq, P, pn, __builtin_ctz(pn), gap_mode, LS, m,
             align_mode == 2, zdrop_on, wb_inv(WB)};
  return launch<false>(a, B, stream);
}

// a topo launch's results copied to host memory `dst` on `stream`, with
// no gather kernel: misc [B, M_NMISC], then the first `cap` step words of
// each instance [B, cap], then the first `nmax` band-state words (mpl |
// mpr<<16) of each [B, nmax] (none when nmax is 0), each block
// contiguous (ops/band_dp.py fetch_topo)
extern "C" int band_dp_topo_fetch(unsigned char* dst, const int* misc,
                                  const long long* steps, const int* mplr,
                                  int B, int R, int LS8, int cap, int nmax,
                                  void* stream) {
  using namespace abpoa;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t nb = B;
  cudaError_t err = cudaMemcpyAsync(dst, misc, nb * M_NMISC * sizeof(int),
                                    cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return (int)err;
  dst += nb * M_NMISC * sizeof(int);
  if (cap > 0) {
    err = cudaMemcpy2DAsync(dst, cap * sizeof(long long), steps,
                            LS8 * sizeof(long long), cap * sizeof(long long),
                            B, cudaMemcpyDeviceToHost, st);
    if (err != cudaSuccess) return (int)err;
    dst += nb * cap * sizeof(long long);
  }
  if (nmax > 0)
    err = cudaMemcpy2DAsync(dst, nmax * sizeof(int), mplr, R * sizeof(int),
                            nmax * sizeof(int), B, cudaMemcpyDeviceToHost,
                            st);
  return (int)err;
}
