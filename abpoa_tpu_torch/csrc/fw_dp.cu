// Full-width POA DP + backtrack walk at absolute query columns, one CUDA
// block per POA instance.
//
// Replaces the TPU kernel make_fw_kernel behind fw_poa_dp_batch
// (abpoa_tpu/ops/dp_pallas_fw.py:80, :685). Plain PyTorch version:
// abpoa_tpu_torch/ops/fw_dp.py fw_poa_dp_batch_ref; the two are held
// bit-equal on misc, the steps, the band bounds and the band state.
//
// What it computes: rows in topological order over planes H, E1, E2
// [R, Wq] (H; E1 affine; E1, E2 convex) at absolute columns; banded rows
// take the band kernel's fill/merge masks, unbanded rows (-b -1) span
// [0, qlen]; local mode clamps at 0 and keeps the best cell of every row,
// extend mode the best row maximum with z-drop; the band state goes to
// the out-nodes. Full rows cannot overflow: no M_OVFL.
//
// What bounds it on an H100: rows are sequential (row t reads its
// predecessors' rows), so one instance is one block and a row is a
// Wq-wide vector (Wq = 768-896 at the heter geometry). Bytes and
// operations are 3-4 orders below the time: it is latency-bound on one
// row's chain of dependent instructions (predecessor values, the F prefix
// max across the block, the row maximum across the block, the backtrack
// word) with a few warps an SM, and on the walk, one dependent step at a
// time on one thread. The design shortens that chain:
// - each thread owns CPT adjacent columns of a tile (NT * CPT columns,
//   NT <= 512; wider rows take several tiles, the scan carried across)
//   in registers; the merge over the predecessors is a loop bounded by
//   pre_n, and the first predecessor's values stay in registers for the
//   backtrack word;
// - on one-tile rows the row before stays in registers, so a predecessor
//   that is the row before (a chain) needs no load;
// - the F (insertion) prefix max is a serial max inside the thread's
//   columns, a warp-shuffle scan and one warp reduction across warps; the
//   row maximum and its tie-break are one 64-bit key, two warp
//   reductions in each warp and across warps: two block barriers a row
//   (one more per extra tile);
// - a backtrack word per cell (32 bits for linear and affine gaps, 64
//   for convex: the first predecessor slot of each M/E condition, the
//   open bits, the F bits, H == 0), written in the sweep, so the walk
//   reads one word per step and the predecessor ids from shared memory;
//   F1/F2 are not stored, so the planes are those of the kernel before
//   the word for affine and convex gaps (one more for linear). A slot
//   field holds up to 253; on a row with more predecessors a field that
//   says "254 or later" sends the walk back to the planes for that step;
// - the band state is pushed to the out-nodes by one thread per out-edge
//   with shared-memory atomics, and the next row adds the push of the
//   row before it itself (a per-row flag says whether it is an out-node
//   of it), so no barrier waits for the push;
// - per-row control (predecessor count, base, row mask, the flag), the
//   out count, remain, the band bounds and state live in shared memory
//   while they fit (R up to 8270), in a global scratch past that (a
//   template flag picks the layout, so the common case keeps shared
//   memory's loads), and the predecessor ids in shared memory when
//   R * P fits; each gap mode is its own instance of the kernel, pn a
//   power of two (its divisions shifts);
// - the walk emits int64 step words op | row<<2 | col<<32: no row or
//   column cap short of the card's memory.
#include <cuda_runtime.h>

#include "fw_tile.cuh"

namespace abpoa {
namespace {

constexpr int LOCAL_MODE = 1, EXTEND_MODE = 2;
constexpr int CPT = 2;               // columns a thread owns in a tile
constexpr int MAX_NT = 512;          // threads of a block
// per-row control word: predecessor count (clamped to [0, P] and to 24
// bits), base, row mask, and whether row t+1 is an out-node of row t;
// the out count has a word of its own
constexpr int C_BASE = 24, C_LIVE = 29, C_NEXT = 30;
constexpr int CMASK = (1 << 24) - 1;

struct FwArgs {
  const int* scal;     // [B, S_NSCAL]
  const int* bases;    // [B, R]
  const int* pre_idx;  // [B, R*P]
  const int* pre_n;    // [B, R]
  const int* out_idx;  // [B, R*O]
  const int* out_n;    // [B, R]
  const int* remain;   // [B, R]
  const int* qp;       // [B, m, Wq]
  const int* mpl0;     // [B, R]
  const int* mpr0;     // [B, R]
  const int* rowmask;  // [B, R]
  int* begsn;          // [B, R] (zeroed by the caller)
  int* endsn;
  int* mpl;
  int* mpr;
  int* misc;           // [B, M_NMISC] (zeroed)
  long long* steps;    // [B, max(LS, 8)] (zeroed)
  int* rows;           // [B, ROW_WORDS * R] per-row scratch (when the
                       // per-row arrays do not fit shared memory)
  int* H;              // [B, R, Wq] planes (scratch)
  int* E1;
  int* E2;
  void* BT;            // [B, R, Wq] backtrack words (scratch)
  int R, Wq, P, O, m, pn, pn_sh, gm, mode, zdrop_on, banded, LS, pre_smem;
};

// what the merge keeps of one predecessor row at the thread's columns
struct PredVals {
  int h[CPT + 1];  // H[pred][c0 - 1 + u]
  int e1[CPT];
  int e2[CPT];
};

__device__ __forceinline__ void load_pred(PredVals& v, const int* H,
                                          const int* E1, const int* E2,
                                          int pred, int c0, int Wq, int gm) {
  const size_t ro = (size_t)pred * Wq;
  v.h[0] = (c0 >= 1 && c0 <= Wq) ? H[ro + c0 - 1] : NEG;
  if (c0 + CPT <= Wq && (Wq & (CPT - 1)) == 0) {
    ld_run<CPT>(H + ro + c0, v.h + 1);
    if (gm != LINEAR_GAP) ld_run<CPT>(E1 + ro + c0, v.e1);
    if (gm == CONVEX_GAP) ld_run<CPT>(E2 + ro + c0, v.e2);
  } else {
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      bool ok = c0 + u < Wq;
      v.h[u + 1] = ok ? H[ro + c0 + u] : 0;
      v.e1[u] = (ok && gm != LINEAR_GAP) ? E1[ro + c0 + u] : 0;
      v.e2[u] = (ok && gm == CONVEX_GAP) ? E2[ro + c0 + u] : 0;
    }
  }
}

// a predecessor that is the row before, from the registers that hold it
__device__ __forceinline__ void from_regs(PredVals& v, const int* ph,
                                          const int* pe1, const int* pe2,
                                          int ph_left) {
  v.h[0] = ph_left;
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    v.h[u + 1] = ph[u];
    v.e1[u] = pe1[u];
    v.e2[u] = pe2[u];
  }
}

// the row's scalars, alike in every thread
struct Row {
  int begc, endc, capc, lo, qlen, dpsn, pn, inf, e1;
  bool local;
};

// one predecessor slot's step of the merge at the thread's columns
// c0 + u: H (the shifted diagonal; linear gaps also the vertical move)
// and E1/E2, with the band kernel's fill rules on slot 0
__device__ __forceinline__ void merge_pred(
    const Row& r, const PredVals& v, bool first, bool pvc, int pbegc,
    int pendc, int c0, const int* segs, const int* qrow, int gm, int* h,
    int* e1v, int* e2v) {
  const int begc = r.begc, endc = r.endc;
  const int _begc = r.local ? begc : max(begc, pbegc);
  const int _endc = r.local ? endc
                            : min(min(pendc + 1, endc), r.dpsn - 1);
  const int _ende = min(pendc, endc);
  const int cb = mulw(_begc, r.pn);
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int c = c0 + u;
    const int seg = segs[u];
    int cand = c >= 1 ? v.h[u] : NEG;
    const int boundary = r.local ? 0 : (pbegc < begc ? cand : r.inf);
    if (c == cb) cand = boundary;
    if (gm == LINEAR_GAP) cand = max(cand + qrow[u], v.h[u + 1] - r.e1);
    const bool mmask = seg >= _begc && seg <= _endc && pvc;
    if (first) {
      if (!r.local && ((seg >= begc && seg < _begc)
                       || (seg > _endc && seg <= r.capc)))
        h[u] = r.inf;
      if (mmask) h[u] = cand;
    } else if (mmask) {
      h[u] = max(h[u], cand);
    }
    if (gm != LINEAR_GAP) {
      const bool emask = seg >= _begc && seg <= _ende && pvc;
      if (first) {
        if (!r.local && ((seg >= begc && seg < _begc)
                         || (seg > _ende && seg <= endc))) {
          e1v[u] = r.inf;
          e2v[u] = r.inf;
        }
        if (emask) {
          e1v[u] = v.e1[u];
          e2v[u] = gm == CONVEX_GAP ? v.e2[u] : 0;
        }
      } else if (emask) {
        e1v[u] = max(e1v[u], v.e1[u]);
        if (gm == CONVEX_GAP) e2v[u] = max(e2v[u], v.e2[u]);
      }
    }
  }
}

// one predecessor slot p's part of the backtrack words at the thread's
// columns: the first slot of each condition, its open bit
__device__ __forceinline__ void bt_pred(
    const PredVals& v, int p, int plo, int phi, int c0, const int* qrow,
    const int* hrow, const int* e1row, const int* e2row, int gm, int e1,
    int oe1, int e2, int oe2, Fields* fl) {
#pragma unroll
  for (int u = 0; u < CPT; ++u)
    bt_slot(fl[u], p, c0 + u, plo, phi, v.h[u], v.h[u + 1], v.e1[u],
            v.e2[u], qrow[u], hrow[u], e1row[u], e2row[u], gm, e1, oe1, e2,
            oe2);
}

// one instance per gap mode (GM) and per-row layout (SROWS: in shared
// memory): the code of a launch holds only the branches it runs
template <int GM, bool SROWS>
__global__ void __launch_bounds__(MAX_NT) fw_dp_kernel(FwArgs a) {
  extern __shared__ int smem[];
  constexpr int gm = GM;
  typedef Bt<GM> BL;
  typedef typename BL::W W;
  const int R = a.R, Wq = a.Wq, P = a.P, O = a.O, pn = a.pn;
  const bool local = a.mode == LOCAL_MODE, extend = a.mode == EXTEND_MODE;
  const int tid = threadIdx.x, NT = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, NW = NT >> 5;
  u64* s_red = reinterpret_cast<u64*>(smem);  // [32]
  int* s_ws1 = smem + 64;                     // [32] warp scan totals
  int* s_ws2 = s_ws1 + 32;
  int* s_edge = s_ws2 + 32;                   // [3 * 32] last columns
  const int b = blockIdx.x;
  int* s_beg = SROWS ? smem + FIXED_WORDS
                     : a.rows + (size_t)b * ROW_WORDS * R;
  int* s_end = s_beg + R;
  int* s_mpl = s_end + R;
  int* s_mpr = s_mpl + R;
  int* s_ctrl = s_mpr + R;
  int* s_nout = s_ctrl + R;
  int* s_rem = s_nout + R;
  // [R * P] when pre_smem
  int* s_pre = smem + FIXED_WORDS + (SROWS ? ROW_WORDS * R : 0);

  const size_t ro = (size_t)b * R;
  const int* qp = a.qp + (size_t)b * a.m * Wq;
  const size_t plane = (size_t)R * Wq;
  int* H = a.H + b * plane;
  int* E1 = a.E1 + b * plane;
  int* E2 = a.E2 + b * plane;
  W* BT = static_cast<W*>(a.BT) + b * plane;
  const int* out_idx = a.out_idx + ro * O;
  const int* sc = a.scal + (size_t)b * S_NSCAL;
  const int qlen = sc[S_QLEN], nrows = sc[S_NROWS], w = sc[S_W];
  const int inf = sc[S_INF], remend = sc[S_REMEND], dpsn = sc[S_DPSN];
  const int e1 = sc[S_E1], o1 = sc[S_O1], oe1 = sc[S_OE1];
  const int e2 = sc[S_E2], o2 = sc[S_O2], oe2 = sc[S_OE2];
  const int zdrop = sc[S_ZDROP];
  const int* pre = a.pre_smem ? s_pre : a.pre_idx + ro * P;
  for (int i = tid; i < R; i += NT) {
    const bool live = i < nrows;
    s_beg[i] = 0;
    s_end[i] = 0;
    s_mpl[i] = live ? a.mpl0[ro + i] : 0;
    s_mpr[i] = live ? a.mpr0[ro + i] : 0;
    s_rem[i] = a.remain[ro + i];
    const int npre = max(min(min(a.pre_n[ro + i], P), CMASK), 0);
    const int nout = max(min(a.out_n[ro + i], O), 0);
    const int base = min(max(a.bases[ro + i], 0), a.m - 1);
    bool next = false;
    for (int o = 0; o < nout; ++o)
      next |= out_idx[(size_t)i * O + o] == i + 1;
    s_ctrl[i] = npre | (base << C_BASE)
                | ((a.rowmask[ro + i] > 0) << C_LIVE) | (next << C_NEXT);
    s_nout[i] = nout;
  }
  if (a.pre_smem)
    for (int i = tid; i < R * P; i += NT) s_pre[i] = a.pre_idx[ro * P + i];
  __syncthreads();

  // ---- first row (ref :553-662): every column, band state to its
  // out-nodes ----
  if (tid == 0) {
    s_mpl[0] = 0;
    s_mpr[0] = 0;
    const int nout0 = s_nout[0];
    for (int o = 0; o < nout0; ++o) {
      int tgt = out_idx[o];
      s_mpl[tgt] = 1;
      s_mpr[tgt] = 1;
    }
  }
  __syncthreads();
  // the row before's H, E1, E2 at the thread's columns (and H at the
  // column before them), kept in registers when a row is one tile: a
  // predecessor that is the row before is read from there
  const int TILE = NT * CPT;
  const bool single = TILE >= Wq;
  int ph[CPT], pe1[CPT], pe2[CPT], ph_left;
  {
    int end0 = qlen;
    if (a.banded) {
      int rem = s_rem[0] - remend - 1;
      end0 = min(qlen, max(s_mpr[0], qlen - rem) + w);
    }
    const int end_sn0 = end0 >> a.pn_sh;
    if (tid == 0) s_end[0] = end_sn0;
    const int esn = min(end_sn0 + 1, dpsn - 1);
    auto row0 = [&](int c, int& hv, int& ev1, int& ev2) {
      hv = ev1 = ev2 = 0;
      if (local) return;
      const bool hi_mask = (c >> a.pn_sh) <= esn;
      const bool de_mask = c <= (end_sn0 + 1) * pn - 1;
      const int fill0 = hi_mask ? inf : 0;
      if (gm == LINEAR_GAP) {
        hv = de_mask ? mulw(-e1, c) : fill0;
      } else {
        int f = -o1 - mulw(e1, c);
        if (gm == CONVEX_GAP) f = max(f, -o2 - mulw(e2, c));
        hv = c == 0 ? 0 : ((de_mask && c >= 1) ? f : fill0);
        ev1 = c == 0 ? -oe1 : fill0;
        ev2 = c == 0 ? -oe2 : fill0;
      }
    };
    for (int T0 = 0; T0 < Wq; T0 += TILE) {
      const int c0 = T0 + tid * CPT;
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int c = c0 + u;
        row0(c, ph[u], pe1[u], pe2[u]);
        if (c >= Wq) continue;
        H[c] = ph[u];
        if (gm != LINEAR_GAP) E1[c] = pe1[u];
        if (gm == CONVEX_GAP) E2[c] = pe2[u];
      }
    }
    int x1, x2;
    ph_left = NEG;
    if (tid > 0) row0(tid * CPT - 1, ph_left, x1, x2);
  }
  __syncthreads();

  // best cell, z-drop state, cells and the previous row's push: every
  // thread keeps the same copy (all inputs are block-uniform)
  int bs = inf, bi = 0, bj = 0, brem = s_rem[0], cells = 0;
  bool stop = false, prev_push = false;
  int prev_mi1 = 0;
  DP_PROBE_INIT
  const int limit = min(nrows - 1, R - 1);
  for (int t = 1; t < limit; ++t) {
    // ---- the row's scalars ----
    const int cw = s_ctrl[t];
    const int npre = cw & CMASK, nout = s_nout[t];
    const int base = (cw >> C_BASE) & 31;
    // this thread's out-edge of the row (pushed after the row maximum)
    const int my_tgt = tid < nout ? out_idx[(size_t)t * O + tid] : 0;
    int beg = 0, end = qlen;
    if (a.banded) {
      int mplt = s_mpl[t], mprt = s_mpr[t];
      if (prev_push && ((s_ctrl[t - 1] >> C_NEXT) & 1)) {
        mplt = min(mplt, prev_mi1);
        mprt = max(mprt, prev_mi1);
      }
      const int rem = s_rem[t] - remend - 1;
      beg = max(0, min(mplt, qlen - rem) - w);
      end = min(qlen, max(mprt, qlen - rem) + w);
    }
    const int* prow_ids = pre + (size_t)t * P;
    int min_pb = 1 << 30;
    for (int p = 0; p < npre; ++p) min_pb = min(min_pb, s_beg[prow_ids[p]]);
    const int beg_sn = max(beg >> a.pn_sh, min_pb);
    const int end_sn = end >> a.pn_sh;
    if (tid == 0) {
      s_beg[t] = beg_sn;
      s_end[t] = end_sn;
    }
    Row r;
    r.begc = beg_sn;
    r.endc = end_sn;
    r.capc = min(end_sn + 1, dpsn - 1);
    r.lo = mulw(beg_sn, pn);
    r.qlen = qlen;
    r.dpsn = dpsn;
    r.pn = pn;
    r.inf = inf;
    r.e1 = e1;
    r.local = local;
    const int lo = r.lo;
    const int* qrow_p = qp + (size_t)base * Wq;
    int* Ht = H + (size_t)t * Wq;
    int* E1t = E1 + (size_t)t * Wq;
    int* E2t = E2 + (size_t)t * Wq;
    W* BTt = BT + (size_t)t * Wq;

    DP_PROBE(0)
    // below every candidate's key (a row of inf cells in 32-bit
    // geometry, where inf < NEG, keeps its own maximum)
    u64 kbest = 0;
    const int last_lseg = r.endc - r.begc;
    int carry1 = NEG, carry2 = NEG;
    // the left neighbour of the tile's first column (the last column of
    // the tile before it): H, F1, F2
    int eh = 0, ef1 = 0, ef2 = 0;
    for (int T0 = 0; T0 < Wq; T0 += TILE) {
      const bool last_tile = T0 + TILE >= Wq;
      const int c0 = T0 + tid * CPT;
      int qrow[CPT], h[CPT], e1v[CPT], e2v[CPT], segs[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int c = c0 + u;
        qrow[u] = (c >= 1 && c <= qlen && c < Wq) ? qrow_p[c] : 0;
        segs[u] = c >> a.pn_sh;
        h[u] = e1v[u] = e2v[u] = 0;
      }
      // ---- merges over the predecessors; the first one's values stay
      // for the backtrack words ----
      PredVals first = {};
      int fbeg = 1 << 29, fend = -(1 << 29);
      if (npre > 0) {
        const int pred = prow_ids[0];
        fbeg = s_beg[pred];
        fend = s_end[pred];
        if (single && pred == t - 1)
          from_regs(first, ph, pe1, pe2, ph_left);
        else
          load_pred(first, H, E1, E2, pred, c0, Wq, gm);
      }
      merge_pred(r, first, true, npre > 0, fbeg, fend, c0, segs, qrow, gm,
                 h, e1v, e2v);
      for (int p = 1; p < npre; ++p) {
        const int pred = prow_ids[p];
        PredVals v;
        if (single && pred == t - 1)
          from_regs(v, ph, pe1, pe2, ph_left);
        else
          load_pred(v, H, E1, E2, pred, c0, Wq, gm);
        merge_pred(r, v, false, true, s_beg[pred], s_end[pred], c0, segs,
                   qrow, gm, h, e1v, e2v);
      }

      DP_PROBE(1)
      // ---- scan inputs: the thread's maxima ----
      int cmax1 = NEG, cmax2 = NEG;
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int c = c0 + u;
        if (c >= Wq) continue;
        const int seg = segs[u];
        const bool band = seg >= r.begc && seg <= r.endc;
        const int rel = c - lo;
        if (gm == LINEAR_GAP) {
          cmax1 = max(cmax1, band ? max(h[u], inf) + rel * e1 : NEG);
        } else {
          const int h0 = h[u] + (band ? qrow[u] : 0);
          int src = h0;
          if (gm == CONVEX_GAP) {
            src = max(max(h0, e1v[u]), e2v[u]);
            cmax2 = max(cmax2, band ? max(src, inf) + rel * e2 : NEG);
          }
          cmax1 = max(cmax1, band ? max(src, inf) + rel * e1 : NEG);
        }
      }
      // ---- inclusive warp scan of the maxima, one step across warps ----
      int in1 = cmax1, in2 = cmax2;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int x1 = __shfl_up_sync(~0u, in1, d);
        const int x2 = __shfl_up_sync(~0u, in2, d);
        if (lane >= d) {
          in1 = max(in1, x1);
          in2 = max(in2, x2);
        }
      }
      int pm1 = __shfl_up_sync(~0u, in1, 1);
      int pm2 = __shfl_up_sync(~0u, in2, 1);
      if (lane == 0) pm1 = pm2 = NEG;
      if (lane == 31) {
        s_ws1[wid] = in1;
        s_ws2[wid] = in2;
      }
      __syncthreads();
      DP_PROBE(2)
      // across warps: lane k holds warp k's total; the warps before this
      // one and all warps, by warp reductions
      {
        const int w1 = lane < NW ? s_ws1[lane] : NEG;
        const int w2 = lane < NW ? s_ws2[lane] : NEG;
        const int b1 = __reduce_max_sync(~0u, lane < wid ? w1 : NEG);
        const int b2 = __reduce_max_sync(~0u, lane < wid ? w2 : NEG);
        const int t1 = __reduce_max_sync(~0u, w1);
        const int t2 = __reduce_max_sync(~0u, w2);
        pm1 = max(pm1, max(carry1, b1));
        pm2 = max(pm2, max(carry2, b2));
        carry1 = max(carry1, t1);
        carry2 = max(carry2, t2);
      }

      // ---- F, H, E, the stored rows ----
      int hrow[CPT], e1row[CPT], e2row[CPT], f1row[CPT], f2row[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int c = c0 + u;
        const int seg = segs[u];
        const bool band = seg >= r.begc && seg <= r.endc;
        const int rel = c - lo;
        e1row[u] = e2row[u] = f1row[u] = f2row[u] = 0;
        if (gm == LINEAR_GAP) {
          pm1 = max(pm1, band ? max(h[u], inf) + rel * e1 : NEG);
          int hfin = max(pm1 - rel * e1, inf);
          if (local) hfin = max(hfin, 0);
          hrow[u] = band ? hfin : h[u];
        } else {
          const int h0 = h[u] + (band ? qrow[u] : 0);
          const int src = gm == CONVEX_GAP ? max(max(h0, e1v[u]), e2v[u])
                                           : h0;
          int f1 = c == lo ? h0 - oe1 : pm1 - oe1 - (rel - 1) * e1;
          f1 = max(f1, inf);
          pm1 = max(pm1, band ? max(src, inf) + rel * e1 : NEG);
          if (gm == CONVEX_GAP) {
            int f2 = c == lo ? h0 - oe2 : pm2 - oe2 - (rel - 1) * e2;
            f2 = max(f2, inf);
            pm2 = max(pm2, band ? max(src, inf) + rel * e2 : NEG);
            const int hpf = band ? src : NEG;
            int hh = max(max(hpf, f1), f2);
            if (local) hh = max(hh, 0);
            int e1n = max(e1v[u] - e1, hh - oe1);
            int e2n = max(e2v[u] - e2, hh - oe2);
            if (local) {
              e1n = max(e1n, 0);
              e2n = max(e2n, 0);
            }
            hrow[u] = band ? hh : h0;
            e1row[u] = band ? e1n : e1v[u];
            e2row[u] = band ? e2n : e2v[u];
            f1row[u] = band ? f1 : 0;
            f2row[u] = band ? f2 : 0;
          } else {
            const int h1 = max(h0, e1v[u]);
            int hh = max(h1, f1);
            if (local) hh = max(hh, 0);
            const int e1n = max(e1v[u] - e1, hh - oe1);
            const int e1fin = hh == h1 ? e1n : (local ? 0 : inf);
            hrow[u] = band ? hh : h0;
            e1row[u] = band ? e1fin : e1v[u];
            f1row[u] = band ? f1 : 0;
          }
        }
      }
      if (c0 < Wq) {
        if (c0 + CPT <= Wq && (Wq & (CPT - 1)) == 0) {
          st_run<CPT>(Ht + c0, hrow);
          if (gm != LINEAR_GAP) st_run<CPT>(E1t + c0, e1row);
          if (gm == CONVEX_GAP) st_run<CPT>(E2t + c0, e2row);
        } else {
#pragma unroll
          for (int u = 0; u < CPT; ++u) {
            if (c0 + u >= Wq) continue;
            Ht[c0 + u] = hrow[u];
            if (gm != LINEAR_GAP) E1t[c0 + u] = e1row[u];
            if (gm == CONVEX_GAP) E2t[c0 + u] = e2row[u];
          }
        }
      }

      DP_PROBE(3)
      // ---- backtrack words: predecessor slots, then the F bits ----
      Fields fl[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u) fields_init(fl[u]);
      if (npre > 0)
        bt_pred(first, 0, mulw(fbeg, pn), mulw(fend + 1, pn) - 1, c0, qrow,
                hrow, e1row, e2row, gm, e1, oe1, e2, oe2, fl);
      for (int p = 1; p < npre; ++p) {
        const int pred = prow_ids[p];
        PredVals v;
        if (single && pred == t - 1)
          from_regs(v, ph, pe1, pe2, ph_left);
        else
          load_pred(v, H, E1, E2, pred, c0, Wq, gm);
        bt_pred(v, p, mulw(s_beg[pred], pn), mulw(s_end[pred] + 1, pn) - 1,
                c0, qrow, hrow, e1row, e2row, gm, e1, oe1, e2, oe2, fl);
      }
      u64 bt[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u)
        bt[u] = field_bits<GM>(fl[u]) | ((u64)(hrow[u] == 0) << BL::HZ);
#pragma unroll
      for (int u = 1; u < CPT; ++u)
        bt[u] |= f_bits<GM>(hrow[u], f1row[u], f2row[u], hrow[u - 1],
                            f1row[u - 1], f2row[u - 1], e1, oe1, e2, oe2);
      // the first column's left neighbour: the lane before, else the
      // warp before (after the barrier), else the tile before
      const int nh = __shfl_up_sync(~0u, hrow[CPT - 1], 1);
      const int nf1 = __shfl_up_sync(~0u, f1row[CPT - 1], 1);
      const int nf2 = __shfl_up_sync(~0u, f2row[CPT - 1], 1);
      if (lane > 0)
        bt[0] |= f_bits<GM>(hrow[0], f1row[0], f2row[0], nh, nf1, nf2, e1,
                            oe1, e2, oe2);
      else if (wid == 0)
        bt[0] |= c0 == 0 ? f_bits<GM>(hrow[0], f1row[0], f2row[0], 0, 0, 0,
                                      e1, oe1, e2, oe2)
                         : f_bits<GM>(hrow[0], f1row[0], f2row[0], eh, ef1,
                                      ef2, e1, oe1, e2, oe2);
      if (lane == 31) {
        s_edge[wid] = hrow[CPT - 1];
        s_edge[32 + wid] = f1row[CPT - 1];
        s_edge[64 + wid] = f2row[CPT - 1];
      }

      DP_PROBE(4)
      // ---- the row maximum candidates: columns at or past the band
      // start; out-of-band columns count as inf ----
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int c = c0 + u;
        if (c >= Wq || c < lo) continue;
        const int seg = segs[u];
        const bool band = seg >= r.begc && seg <= r.endc;
        const int v = (band && c <= qlen) ? hrow[u] : inf;
        const int lseg = seg - r.begc;
        const u64 k = best_key(v, c - seg * pn,
                               lseg == last_lseg ? 0 : lseg + 1);
        kbest = k > kbest ? k : kbest;
      }
      if (last_tile) {
        kbest = warp_max64(kbest);
        if (lane == 0) s_red[wid] = kbest;
      }
      __syncthreads();
      int left = lane > 0 ? nh : (wid > 0 ? s_edge[wid - 1] : eh);
      DP_PROBE(5)
      if (lane == 0 && wid > 0)
        bt[0] |= f_bits<GM>(hrow[0], f1row[0], f2row[0], left,
                            s_edge[32 + wid - 1], s_edge[64 + wid - 1], e1,
                            oe1, e2, oe2);
      if (single) {
#pragma unroll
        for (int u = 0; u < CPT; ++u) {
          ph[u] = hrow[u];
          pe1[u] = e1row[u];
          pe2[u] = e2row[u];
        }
        ph_left = c0 >= 1 ? left : NEG;
      }
      eh = s_edge[NW - 1];
      ef1 = s_edge[32 + NW - 1];
      ef2 = s_edge[64 + NW - 1];
      if (c0 < Wq) {
#pragma unroll
        for (int u = 0; u < CPT; ++u)
          if (c0 + u < Wq) BTt[c0 + u] = (W)bt[u];
      }
      // the next tile writes s_ws and s_edge only after its first
      // barrier, which every thread reaches after these reads
    }

    // ---- the row maximum (every thread), best cell, z-drop, push ----
    const u64 g = warp_max64(lane < NW ? s_red[lane] : 0);
    const int gmax = (int)((unsigned)(g >> 32) ^ 0x80000000u);
    const unsigned klo = ~(unsigned)(g & 0xFFFFFFFFu);
    const int lane_pick = (int)(klo >> 26);
    const int aux_pick = (int)(klo & 0x3FFFFFFu);
    const int wseg = aux_pick == 0 ? r.endc - r.begc : aux_pick - 1;
    const int mi = gmax > inf ? (r.begc + wseg) * pn + lane_pick : -1;
    const bool active = !stop && ((cw >> C_LIVE) & 1);
    bool stop_now = false;
    if (local || extend) {
      const bool better = gmax > bs;
      if (extend && a.zdrop_on) {
        const int delta = brem - s_rem[t];
        const int zlim = zdrop + mulw(e1, abs(delta - (mi - bj)));
        stop_now = !better && bs - gmax > zlim;
      }
      if (active && better) {
        bs = gmax;
        bi = t;
        bj = mi;
        brem = s_rem[t];
      }
      stop_now = active && stop_now;
    }
    prev_push = active && !stop_now;
    prev_mi1 = mi + 1;
    if (prev_push) {
      if (tid < nout) {
        atomicMin(&s_mpl[my_tgt], mi + 1);
        atomicMax(&s_mpr[my_tgt], mi + 1);
      }
      for (int o = tid + NT; o < nout; o += NT) {
        const int tgt = out_idx[(size_t)t * O + o];
        atomicMin(&s_mpl[tgt], mi + 1);
        atomicMax(&s_mpr[tgt], mi + 1);
      }
    }
    DP_PROBE(6)
    stop = stop || stop_now;
    if (active) cells += (end_sn - beg_sn + 1) * pn;
  }
  __syncthreads();

  for (int i = tid; i < min(nrows, R); i += NT) {
    a.begsn[ro + i] = s_beg[i];
    a.endsn[ro + i] = s_end[i];
    a.mpl[ro + i] = s_mpl[i];
    a.mpr[ro + i] = s_mpr[i];
  }
  if (tid != 0) return;
  if (a.mode == 0) {
    // ---- best cell over the sink's predecessors ----
    const int sink = min(max(nrows - 1, 0), R - 1);
    const int npre = s_ctrl[sink] & CMASK;
    for (int p = 0; p < npre; ++p) {
      const int pred = pre[(size_t)sink * P + p];
      const int ec = min(qlen, (s_end[pred] + 1) * pn - 1);
      const int val = (ec >= 0 && ec < Wq) ? H[(size_t)pred * Wq + ec] : 0;
      if (val > bs) {
        bs = val;
        bi = pred;
        bj = ec;
      }
    }
  }
  int* misc = a.misc + (size_t)b * M_NMISC;
  misc[M_BEST] = bs;
  misc[M_BI] = bi;
  misc[M_BJ] = bj;
  misc[M_CELLS] = cells;
  misc[M_OVFL] = 0;
  if (a.LS == 0) return;
  DP_PROBE_MARK

  // ---- the walk: one backtrack word per step ----
  // the first slot from SPILL on that meets field k's condition at cell
  // (i, j), re-derived from the planes as bt_pred derived it
  auto spill_slot = [&](int k, int i, int j) {
    const int cw = s_ctrl[i];
    const int np = cw & CMASK, base = (cw >> C_BASE) & 31;
    const size_t at = (size_t)i * Wq + j;
    const int q = (j >= 1 && j <= qlen && j < Wq)
                      ? qp[(size_t)base * Wq + j] : 0;
    for (int p = SPILL; p < np; ++p) {
      const int pred = pre[(size_t)i * P + p];
      const int plo = mulw(s_beg[pred], pn);
      const int phi = mulw(s_end[pred] + 1, pn) - 1;
      const size_t pa = (size_t)pred * Wq + j;
      bool hit;
      if (k == 0)
        hit = j - 1 >= plo && j - 1 <= phi && H[pa - 1] + q == H[at];
      else if (j < plo || j > phi)
        hit = false;
      else if (k == 1)
        hit = gm == LINEAR_GAP ? H[pa] - e1 == H[at] : H[at] == E1[pa];
      else if (k == 2)
        hit = E1[at] == E1[pa] - e1;
      else if (k == 3)
        hit = H[at] == E2[pa];
      else
        hit = E2[at] == E2[pa] - e2;
      if (hit) return p;
    }
    return NONE;
  };
  long long* st = a.steps + (size_t)b * max(a.LS, 8);
  int i = bi, j = bj, cur = BT_ALL, nst = 0;
  bool if_ = true, fail = false;
  bool done = bi <= 0 || bj <= 0;
  while (!done && nst < a.LS) {
    const u64 wd = (u64)BT[(size_t)i * Wq + j];
    const bool curM = (cur & BT_M) != 0;
    // local mode ends on the zero cell itself, whatever move its
    // conditions would allow
    if (local && ((wd >> BL::HZ) & 1)) break;
    const int mp = (int)(wd >> BL::MP) & NONE;
    const bool m_possible = mp != NONE;
    bool e_possible, f_possible;
    int e_pick = 0, e_op_sel = BT_ALL, f_op_sel = BT_ALL;
    if (gm == LINEAR_GAP) {
      e_pick = (int)(wd >> BL::E1M) & NONE;
      if (e_pick == SPILL) e_pick = spill_slot(1, i, j);
      e_possible = e_pick != NONE;
      f_possible = (wd >> BL::F) & 1;
    } else {
      int pe1 = (int)(wd >> (curM ? BL::E1M : BL::E1X)) & NONE;
      if (pe1 == SPILL) pe1 = spill_slot(curM ? 1 : 2, i, j);
      const bool op1 = (wd >> (BL::O + (curM ? 0 : 1))) & 1;
      const bool e1hit = (cur & BT_E1) && pe1 != NONE;
      int pe2 = NONE;
      bool op2 = false, e2hit = false;
      if (gm == CONVEX_GAP) {
        pe2 = (int)(wd >> (curM ? BL::E2M : BL::E2X)) & NONE;
        if (pe2 == SPILL) pe2 = spill_slot(curM ? 3 : 4, i, j);
        op2 = (wd >> (BL::O + (curM ? 2 : 3))) & 1;
        e2hit = (cur & BT_E2) && pe2 != NONE;
      }
      // candidate order: slot by slot, E1 before E2
      const bool use_e1 = e1hit && (!e2hit || pe1 <= pe2);
      e_possible = e1hit || e2hit;
      e_pick = use_e1 ? pe1 : pe2;
      e_op_sel = use_e1 ? (op1 ? (BT_M | BT_F) : BT_E1)
                        : (op2 ? (BT_M | BT_F) : BT_E2);
      const bool f1o = (wd >> BL::F) & 1, f1x = (wd >> (BL::F + 1)) & 1,
                 f1g = (wd >> (BL::F + 2)) & 1;
      const bool hit_f1 = (cur & BT_F1) && (curM ? f1g : true) && (f1o || f1x);
      const int op_f1 = f1o ? (BT_M | BT_E) : BT_F1;
      bool hit_f2 = false;
      int op_f2 = BT_ALL;
      if (gm == CONVEX_GAP) {
        const bool f2o = (wd >> (BL::F + 3)) & 1,
                   f2x = (wd >> (BL::F + 4)) & 1,
                   f2g = (wd >> (BL::F + 5)) & 1;
        hit_f2 = (cur & BT_F2) && (curM ? f2g : true) && (f2o || f2x);
        op_f2 = f2o ? (BT_M | BT_E) : BT_F2;
      }
      f_possible = hit_f1 || hit_f2;
      f_op_sel = hit_f1 ? op_f1 : op_f2;
    }
    const bool use_m1 = curM && !if_ && m_possible;
    bool use_e = !use_m1 && e_possible;
    if (gm != LINEAR_GAP) use_e = use_e && (cur & BT_E);
    bool use_f = !use_m1 && !use_e && f_possible;
    if (gm != LINEAR_GAP) use_f = use_f && (cur & BT_F);
    bool use_m2 = !use_m1 && !use_e && !use_f && if_ && m_possible;
    if (gm != LINEAR_GAP) use_m2 = use_m2 && curM;
    const bool any_hit = use_m1 || use_e || use_f || use_m2;
    fail = fail || !any_hit;
    const bool use_m = use_m1 || use_m2;
    if (any_hit) {
      const int op_code = use_m ? 0 : (use_e ? 2 : 1);
      st[nst++] = (long long)op_code | ((long long)i << 2)
                  | ((long long)j << 32);
    }
    int new_i = i;
    if (use_m)
      new_i = pre[(size_t)i * P + (mp == SPILL ? spill_slot(0, i, j) : mp)];
    else if (use_e) new_i = pre[(size_t)i * P + e_pick];
    const int new_j = (use_m || use_f) ? j - 1 : j;
    cur = use_m ? BT_ALL : (use_e ? e_op_sel : (use_f ? f_op_sel : cur));
    if (use_m) if_ = false;
    i = new_i;
    j = new_j;
    done = fail || new_i <= 0 || new_j <= 0;
  }
  DP_PROBE(7)
  DP_PROBE_SAVE(limit, nst)
  misc[M_NSTEPS] = nst;
  misc[M_FAIL] = fail;
  misc[M_ENDI] = i;
  misc[M_ENDJ] = j;
}

template <int GM, bool SROWS>
int launch_rows(const FwArgs& a, int B, int NT, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fw_dp_kernel<GM, SROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fw_dp_kernel<GM, SROWS><<<B, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int GM>
int launch(const FwArgs& a, int B, int NT, size_t smem, bool srows,
           void* stream) {
  return srows ? launch_rows<GM, true>(a, B, NT, smem, stream)
               : launch_rows<GM, false>(a, B, NT, smem, stream);
}
}  // namespace
}  // namespace abpoa

DP_PROBE_EXPORT

// C entry point (bound with ctypes). Enqueues the kernel on `stream`;
// returns the cudaError_t of the launch.
extern "C" int fw_dp_launch(
    const int* scal, const int* bases, const int* pre_idx, const int* pre_n,
    const int* out_idx, const int* out_n, const int* remain, const int* qp,
    const int* mpl0, const int* mpr0, const int* rowmask, int* begsn,
    int* endsn, int* mpl, int* mpr, int* misc, long long* steps, int* rows,
    int* H, int* E1, int* E2, void* BT, int B, int R, int Wq, int P, int O,
    int m, int pn,
    int gap_mode, int align_mode, int zdrop_on, int banded, int LS,
    void* stream) {
  using namespace abpoa;
  if (B <= 0) return 0;
  // pn a power of two (floor divisions by it are shifts); bases fit the
  // control word, the lane-in-segment and the columns the row-maximum key
  if (R <= 0 || R >= (1 << 30) || Wq <= 0 || Wq >= (1 << 29) || P <= 0
      || O <= 0 || m <= 0 || m > 32 || pn <= 0 || pn > 64 || (pn & (pn - 1))
      || align_mode < 0 || align_mode > 2)
    return (int)cudaErrorInvalidValue;
  const int pn_sh = __builtin_ctz(pn);
  const int NT = min(MAX_NT, ((Wq + CPT - 1) / CPT + 31) / 32 * 32);
  const size_t fixed = smem_with_rows(R);
  const bool srows = fixed > sizeof(int) * FIXED_WORDS;
  // past shared memory the per-row arrays need the caller's scratch
  if (!srows && rows == nullptr) return (int)cudaErrorInvalidValue;
  const size_t with_pre = fixed + sizeof(int) * (size_t)R * P;
  const int pre_smem = with_pre <= MAX_SMEM;
  const size_t smem = pre_smem ? with_pre : fixed;
  FwArgs a{scal, bases, pre_idx, pre_n, out_idx, out_n, remain, qp, mpl0,
           mpr0, rowmask, begsn, endsn, mpl, mpr, misc, steps, rows, H, E1,
           E2, BT, R, Wq, P, O, m, pn, pn_sh, gap_mode, align_mode, zdrop_on,
           banded, LS, pre_smem};
  // the gap mode's instance (a mode neither linear nor convex is affine)
  if (gap_mode == LINEAR_GAP)
    return launch<LINEAR_GAP>(a, B, NT, smem, srows, stream);
  if (gap_mode == CONVEX_GAP)
    return launch<CONVEX_GAP>(a, B, NT, smem, srows, stream);
  return launch<AFFINE_GAP>(a, B, NT, smem, srows, stream);
}
