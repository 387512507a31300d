// Banded POA DP over row-relative [R, WB] tiles + backtrack walk, one CUDA
// block per POA instance.
//
// Replaces the TPU kernel make_dp_kernel behind pallas_poa_dp_batch
// (abpoa_tpu/ops/dp_pallas.py:82, :639, pallas_call at :713). Plain
// PyTorch version: abpoa_tpu_torch/ops/tile_dp.py tile_poa_dp_batch_ref;
// the two are held bit-equal on misc, the steps, the band bounds and the
// band state. The tiles are the kernel's scratch (no caller reads them).
//
// What it computes: rows in topological order; lane l of row t holds query
// column beg_sn[t]*pn + l. A predecessor row is read shifted by
// t_off - pre_beg_sn*pn, inf outside its tile. The band state is pushed
// along out-edges (mpl/mpr start as copies of mpl0/mpr0); a row whose band
// outgrows the tile sets M_OVFL and is clamped to it. Extend mode keeps
// the best row maximum and stops on z-drop; global mode takes the best
// cell over the sink's predecessors. The walk emits int64 step words
// op | row<<2 | col<<32.
//
// What bounds it on an H100: rows are sequential (row t reads its
// predecessors' rows), so one instance is one block and a row is one
// WB-lane vector (WB = 384 at the heter geometry, past 1024 for reads of
// ~40 kb). Bytes and operations are 3-4 orders below the time: it is
// latency-bound on one row's chain of dependent instructions (predecessor
// values, the F prefix max across the block, the row maximum across the
// block, the backtrack word) with a few warps on one SM (the serial
// engine launches it at B = 1), and on the walk, one dependent step at a
// time on one thread. The design, that of fw_dp.cu on row-relative lanes:
// - each thread owns CPT adjacent lanes of a tile (NT * CPT lanes, NT <=
//   512; wider rows take several tiles, the scan carried across) in
//   registers; the merge over the predecessors is a loop bounded by
//   pre_n, and the first predecessor's values stay in registers for the
//   backtrack word;
// - on one-tile rows the row before stays in registers, so a predecessor
//   that is the row before at the same band start (a chain) needs no load;
// - the F (insertion) prefix max is a serial max inside the thread's
//   lanes, a warp-shuffle scan and one warp reduction across warps; the
//   row maximum and its tie-break are one 64-bit key, two warp reductions
//   in each warp and across warps: two block barriers a row (one more per
//   extra tile);
// - a backtrack word per cell (32 bits for linear and affine gaps, 64 for
//   convex: the first predecessor slot of each M/E condition, the open
//   bits, the F bits), written in the sweep, so the walk reads one word
//   per step and the predecessor ids from shared memory; F1/F2 are not
//   stored. A slot field holds up to 253; on a row with more predecessors
//   a field that says "254 or later" sends the walk back to the tiles for
//   that step, and a cell outside its row's tile (where the walk reads
//   zeros, as the reference's lane access does) is derived from the tiles
//   the same way;
// - the band state is pushed to the out-nodes by one thread per out-edge
//   with shared-memory atomics, and the next row adds the push of the row
//   before it itself (a per-row flag says whether it is an out-node of it),
//   so no barrier waits for the push;
// - per-row control (predecessor count, base, the flag), the out count,
//   remain, the band bounds and state live in shared memory while they fit
//   (R up to 8270), in a global scratch past that (a template flag picks
//   the layout), and the predecessor ids in shared memory when R * P fits;
//   each gap mode is its own instance of the kernel, pn a power of two
//   (its divisions shifts).
//
// The TPU kernel's prefix max is a Kogge-Stone scan that shifts in NEG, so
// every lane but the last of a power-of-two tile also takes max(., NEG).
// The scan here starts from NEG: the F recurrences read the prefix of the
// lanes before (always NEG-filled there too), and the one exact lane of
// linear gaps, lane WB - 1, is never in the band (a band holds at most
// WB / pn - 1 segments), so its H is inf either way.
#include <cuda_runtime.h>

#include "fw_tile.cuh"

namespace abpoa {
namespace {

constexpr int EXTEND_MODE = 2;
constexpr int CPT = 2;               // lanes a thread owns in a tile
constexpr int MAX_NT = 512;          // threads of a block
// per-row control word: predecessor count (clamped to [0, P] and to 24
// bits), base, and whether row t+1 is an out-node of row t; the out count
// has a word of its own
constexpr int C_BASE = 24, C_NEXT = 30;
constexpr int CMASK = (1 << 24) - 1;

struct TileArgs {
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
  int* begsn;          // [B, R]
  int* endsn;
  int* mpl;
  int* mpr;
  int* misc;           // [B, M_NMISC] (zeroed)
  long long* steps;    // [B, max(LS, 8)] (zeroed)
  int* rows;           // [B, ROW_WORDS * R] per-row scratch (when the
                       // per-row arrays do not fit shared memory)
  int* H;              // [B, R, WB] tiles (scratch)
  int* E1;
  int* E2;
  void* BT;            // [B, R, WB] backtrack words (scratch)
  int R, WB, Wq, P, O, m, pn, pn_sh, mode, zdrop_on, LS, pre_smem;
};

// what the merge keeps of one predecessor row at the thread's lanes:
// H one column before each lane, H and E at each lane (inf outside the
// predecessor's tile)
struct PredVals {
  int h[CPT + 1];
  int e1[CPT];
  int e2[CPT];
};

// lanes k-1 .. k+CPT-1 of a predecessor's tile row (k = the thread's
// first lane shifted into that row; k is even: shifts are multiples of pn)
__device__ __forceinline__ void load_pred(PredVals& v, const int* H,
                                          const int* E1, const int* E2,
                                          int pred, int k, int WB, int inf,
                                          int gm) {
  const size_t ro = (size_t)pred * WB;
  v.h[0] = (k >= 1 && k <= WB) ? H[ro + k - 1] : inf;
  if (k >= 0 && k + CPT <= WB) {
    ld_run<CPT>(H + ro + k, v.h + 1);
    if (gm != LINEAR_GAP) ld_run<CPT>(E1 + ro + k, v.e1);
    if (gm == CONVEX_GAP) ld_run<CPT>(E2 + ro + k, v.e2);
  } else {
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const bool ok = k + u >= 0 && k + u < WB;
      v.h[u + 1] = ok ? H[ro + k + u] : inf;
      v.e1[u] = (ok && gm != LINEAR_GAP) ? E1[ro + k + u] : inf;
      v.e2[u] = (ok && gm == CONVEX_GAP) ? E2[ro + k + u] : inf;
    }
  }
}

// a predecessor that is the row before at the same band start, from the
// registers that hold it
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
  int beg_sn, end_sn, cap, n_seg, t_off, dpsn, inf, e1;
};

// one predecessor slot's step of the merge at the thread's lanes: H (the
// shifted diagonal; linear gaps also the vertical move) and E1/E2, with
// the fill rules on slot 0
__device__ __forceinline__ void merge_pred(
    const Row& r, const PredVals& v, bool first, bool pv, int pb, int pe,
    const int* asegs, const int* qrow, int gm, int* h, int* e1v, int* e2v) {
  const int bb = max(r.beg_sn, pb);
  const int ee = min(min(pe + 1, r.end_sn), r.dpsn - 1);
  const int ende = min(pe, r.end_sn);
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int aseg = asegs[u];
    int cand = v.h[u];
    if (gm == LINEAR_GAP)
      cand = max(addw(cand, qrow[u]), subw(v.h[u + 1], r.e1));
    const bool mmask = aseg >= bb && aseg <= ee && pv;
    if (first) {
      if ((aseg >= r.beg_sn && aseg < bb) || (aseg > ee && aseg <= r.cap))
        h[u] = r.inf;
      if (mmask) h[u] = cand;
    } else if (mmask) {
      h[u] = max(h[u], cand);
    }
    if (gm != LINEAR_GAP) {
      const bool emask = aseg >= bb && aseg <= ende && pv;
      if (first) {
        if ((aseg >= r.beg_sn && aseg < bb)
            || (aseg > ende && aseg <= r.end_sn)) {
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

// one instance per gap mode (GM) and per-row layout (SROWS: in shared
// memory): the code of a launch holds only the branches it runs
template <int GM, bool SROWS>
__global__ void __launch_bounds__(MAX_NT) tile_dp_kernel(TileArgs a) {
  extern __shared__ int smem[];
  constexpr int gm = GM;
  typedef Bt<GM> BL;
  typedef typename BL::W W;
  const int R = a.R, WB = a.WB, P = a.P, O = a.O, pn = a.pn;
  const int psh = a.pn_sh, SB = WB >> psh;
  const bool extend = a.mode == EXTEND_MODE;
  const int b = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, NW = NT >> 5;
  u64* s_red = reinterpret_cast<u64*>(smem);  // [32]
  int* s_ws1 = smem + 64;                     // [32] warp scan totals
  int* s_ws2 = s_ws1 + 32;
  int* s_edge = s_ws2 + 32;                   // [3 * 32] last lanes
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
  const int* qp = a.qp + (size_t)b * a.m * a.Wq;
  const size_t plane = (size_t)R * WB;
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
  auto clampR = [&](int v) { return min(max(v, 0), R - 1); };
  const int* pre = a.pre_smem ? s_pre : a.pre_idx + ro * P;
  for (int i = tid; i < R; i += NT) {
    s_beg[i] = 0;
    s_end[i] = 0;
    s_mpl[i] = a.mpl0[ro + i];
    s_mpr[i] = a.mpr0[ro + i];
    s_rem[i] = a.remain[ro + i];
    const int npre = max(min(min(a.pre_n[ro + i], P), CMASK), 0);
    const int nout = max(min(a.out_n[ro + i], O), 0);
    const int base = min(max(a.bases[ro + i], 0), a.m - 1);
    bool next = false;
    for (int o = 0; o < nout; ++o)
      next |= clampR(out_idx[(size_t)i * O + o]) == i + 1;
    s_ctrl[i] = npre | (base << C_BASE) | (next << C_NEXT);
    s_nout[i] = nout;
  }
  if (a.pre_smem)
    for (int i = tid; i < R * P; i += NT) s_pre[i] = a.pre_idx[ro * P + i];
  __syncthreads();

  // ---- first row (ref :553-662): mpl/mpr[src] = 0, its successors 1 ----
  if (tid == 0) {
    for (int o = 0; o < s_nout[0]; ++o) {
      const int tgt = clampR(out_idx[o]);
      s_mpl[tgt] = 1;
      s_mpr[tgt] = 1;
    }
    s_mpl[0] = 0;
    s_mpr[0] = 0;
  }
  __syncthreads();
  // the row before's H, E1, E2 at the thread's lanes (and H at the lane
  // before them), kept in registers when a row is one tile
  const int TILE = NT * CPT;
  const bool single = TILE >= WB;
  int ph[CPT], pe1[CPT], pe2[CPT], ph_left;
  int ovfl;
  {
    const int rem0 = s_rem[0] - remend - 1;
    const int end0 = min(qlen, max(s_mpr[0], qlen - rem0) + w);
    const int end_sn0 = end0 >> psh;
    ovfl = end_sn0 + 2 > SB;
    const int de0 = (end_sn0 + 1) * pn - 1;
    if (tid == 0) s_end[0] = end_sn0;
    auto row0 = [&](int l, int& hv, int& ev1, int& ev2) {
      const bool in_de = l <= de0;
      ev1 = ev2 = inf;
      if (gm == LINEAR_GAP) {
        hv = in_de ? mulw(-e1, l) : inf;
      } else {
        const int f1v = subw(-o1, mulw(e1, l));
        const int f2v = subw(-o2, mulw(e2, l));
        const int hf = gm == CONVEX_GAP ? max(f1v, f2v) : f1v;
        hv = l == 0 ? 0 : ((in_de && l >= 1) ? hf : inf);
        ev1 = l == 0 ? -oe1 : inf;
        ev2 = l == 0 ? -oe2 : inf;
      }
    };
    for (int T0 = 0; T0 < WB; T0 += TILE) {
      const int l0 = T0 + tid * CPT;
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int l = l0 + u;
        row0(l, ph[u], pe1[u], pe2[u]);
        if (l >= WB) continue;
        H[l] = ph[u];
        if (gm != LINEAR_GAP) E1[l] = pe1[u];
        if (gm == CONVEX_GAP) E2[l] = pe2[u];
      }
    }
    int x1, x2;
    ph_left = inf;
    if (tid > 0) row0(tid * CPT - 1, ph_left, x1, x2);
  }
  __syncthreads();

  // best cell, z-drop state, cells and the previous row's push: every
  // thread keeps the same copy (all inputs are block-uniform)
  int bs = inf, bi = 0, bj = 0, brem = s_rem[0], cells = 0;
  bool prev_push = false;
  int prev_mi1 = 0;
  DP_PROBE_INIT
  const int limit = min(nrows - 1, R - 1);
  for (int t = 1; t < limit; ++t) {
    // ---- the row's scalars ----
    const int cw = s_ctrl[t];
    const int npre = cw & CMASK, nout = s_nout[t];
    const int base = (cw >> C_BASE) & 31;
    // this thread's out-edge of the row (pushed after the row maximum)
    const int my_tgt =
        tid < nout ? clampR(out_idx[(size_t)t * O + tid]) : 0;
    int mplt = s_mpl[t], mprt = s_mpr[t];
    if (prev_push && ((s_ctrl[t - 1] >> C_NEXT) & 1)) {
      mplt = min(mplt, prev_mi1);
      mprt = max(mprt, prev_mi1);
    }
    const int rem = s_rem[t] - remend - 1;
    const int beg = max(0, min(mplt, qlen - rem) - w);
    const int end = min(qlen, max(mprt, qlen - rem) + w);
    const int* prow = pre + (size_t)t * P;
    int min_pb = 1 << 30;
    for (int p = 0; p < npre; ++p)
      min_pb = min(min_pb, s_beg[clampR(prow[p])]);
    Row r;
    r.beg_sn = max(beg >> psh, min_pb);
    const int end_sn = end >> psh;
    if (end_sn - r.beg_sn + 2 > SB) ovfl = 1;
    r.end_sn = min(end_sn, r.beg_sn + SB - 2);
    r.n_seg = r.end_sn - r.beg_sn + 1;
    r.t_off = mulw(r.beg_sn, pn);
    r.cap = min(r.end_sn + 1, dpsn - 1);
    r.dpsn = dpsn;
    r.inf = inf;
    r.e1 = e1;
    if (tid == 0) {
      s_beg[t] = r.beg_sn;
      s_end[t] = r.end_sn;
    }
    // slot 0's row sets the fill rules even when the row has no
    // predecessor
    const int pred0 = clampR(prow[0]);
    const int pb0 = s_beg[pred0], pe0 = s_end[pred0];
    const int* qrow_p = qp + (size_t)base * a.Wq;
    int* Ht = H + (size_t)t * WB;
    int* E1t = E1 + (size_t)t * WB;
    int* E2t = E2 + (size_t)t * WB;
    W* BTt = BT + (size_t)t * WB;

    DP_PROBE(0)
    // below every candidate's key (a row of inf cells in 32-bit
    // geometry, where inf < NEG, keeps its own maximum)
    u64 kbest = 0;
    int carry1 = NEG, carry2 = NEG;
    // the left neighbour of the tile's first lane (the last lane of the
    // tile before it): H, F1, F2; lane 0 of the row has none (the walk
    // reads zeros outside the tile)
    int eh = 0, ef1 = 0, ef2 = 0;
    for (int T0 = 0; T0 < WB; T0 += TILE) {
      const bool last_tile = T0 + TILE >= WB;
      const int l0 = T0 + tid * CPT;
      const bool live = l0 < WB;  // WB is a multiple of CPT
      int qrow[CPT], h[CPT], e1v[CPT], e2v[CPT], asegs[CPT];
      bool band[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int col = addw(r.t_off, l0 + u);
        qrow[u] = (col >= 1 && col <= qlen) ? qrow_p[col] : 0;
        const int lseg = (l0 + u) >> psh;
        asegs[u] = r.beg_sn + lseg;
        band[u] = lseg < r.n_seg;
        h[u] = e1v[u] = e2v[u] = 0;
      }
      // ---- merges over the predecessors; the first one's values stay
      // for the backtrack words ----
      PredVals first;
      if (single && pred0 == t - 1 && pb0 == r.beg_sn)
        from_regs(first, ph, pe1, pe2, ph_left);
      else
        load_pred(first, H, E1, E2, pred0,
                  l0 + subw(r.t_off, mulw(pb0, pn)), WB, inf, gm);
      merge_pred(r, first, true, npre > 0, pb0, pe0, asegs, qrow, gm, h,
                 e1v, e2v);
      for (int p = 1; p < npre; ++p) {
        const int pred = clampR(prow[p]);
        const int pb = s_beg[pred];
        PredVals v;
        if (single && pred == t - 1 && pb == r.beg_sn)
          from_regs(v, ph, pe1, pe2, ph_left);
        else
          load_pred(v, H, E1, E2, pred, l0 + subw(r.t_off, mulw(pb, pn)),
                    WB, inf, gm);
        merge_pred(r, v, false, true, pb, s_end[pred], asegs, qrow, gm, h,
                   e1v, e2v);
      }

      DP_PROBE(1)
      // ---- scan inputs: the thread's maxima (out-of-band lanes take
      // max(NEG, inf), as the reference's scan does) ----
      int cmax1 = NEG, cmax2 = NEG;
      int h0[CPT], src[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int l = l0 + u;
        h0[u] = addw(h[u], band[u] ? qrow[u] : 0);
        src[u] = gm == CONVEX_GAP ? max(max(h0[u], e1v[u]), e2v[u]) : h0[u];
        if (!live) continue;
        const int g =
            max(band[u] ? (gm == LINEAR_GAP ? h[u] : src[u]) : NEG, inf);
        cmax1 = max(cmax1, addw(g, mulw(l, e1)));
        if (gm == CONVEX_GAP) cmax2 = max(cmax2, addw(g, mulw(l, e2)));
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
        const int l = l0 + u;
        const bool bd = band[u];
        e1row[u] = e2row[u] = f1row[u] = f2row[u] = inf;
        if (gm == LINEAR_GAP) {
          pm1 = max(pm1, addw(max(bd ? h[u] : NEG, inf), mulw(l, e1)));
          hrow[u] = bd ? max(subw(pm1, mulw(l, e1)), inf) : inf;
        } else {
          const int g = max(bd ? src[u] : NEG, inf);
          int f1 = l == 0 ? subw(h0[u], oe1)
                          : subw(subw(pm1, oe1), mulw(l - 1, e1));
          f1 = max(f1, inf);
          pm1 = max(pm1, addw(g, mulw(l, e1)));
          if (gm == CONVEX_GAP) {
            int f2 = l == 0 ? subw(h0[u], oe2)
                            : subw(subw(pm2, oe2), mulw(l - 1, e2));
            f2 = max(f2, inf);
            pm2 = max(pm2, addw(g, mulw(l, e2)));
            const int hh = max(max(bd ? src[u] : NEG, f1), f2);
            hrow[u] = bd ? hh : inf;
            e1row[u] = bd ? max(subw(e1v[u], e1), subw(hh, oe1)) : inf;
            e2row[u] = bd ? max(subw(e2v[u], e2), subw(hh, oe2)) : inf;
            f1row[u] = bd ? f1 : inf;
            f2row[u] = bd ? f2 : inf;
          } else {
            const int h1 = max(h0[u], e1v[u]);
            const int hh = max(h1, f1);
            const int e1n = max(subw(e1v[u], e1), subw(hh, oe1));
            hrow[u] = bd ? hh : inf;
            e1row[u] = (bd && hh == h1) ? e1n : inf;
            f1row[u] = bd ? f1 : inf;
          }
        }
      }
      if (live) {
        st_run<CPT>(Ht + l0, hrow);
        if (gm != LINEAR_GAP) st_run<CPT>(E1t + l0, e1row);
        if (gm == CONVEX_GAP) st_run<CPT>(E2t + l0, e2row);
      }

      DP_PROBE(3)
      // ---- backtrack words: predecessor slots, then the F bits ----
      Fields fl[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u) fields_init(fl[u]);
      // the walk reads a predecessor through its tile (zeros outside):
      // only row 0's band can pass its tile (an overflowing first row)
      auto slot_bits = [&](const PredVals& v, int p, int pb, int pe) {
        const int plo = mulw(pb, pn), phi = mulw(pe + 1, pn) - 1;
        const int k = l0 + subw(r.t_off, plo);
#pragma unroll
        for (int u = 0; u < CPT; ++u) {
          const bool in0 = k + u >= 0 && k + u < WB;
          const bool inm = k + u >= 1 && k + u <= WB;
          bt_slot(fl[u], p, addw(r.t_off, l0 + u), plo, phi,
                  inm ? v.h[u] : 0, in0 ? v.h[u + 1] : 0,
                  in0 ? v.e1[u] : 0, in0 ? v.e2[u] : 0, qrow[u], hrow[u],
                  e1row[u], e2row[u], gm, e1, oe1, e2, oe2);
        }
      };
      if (npre > 0) slot_bits(first, 0, pb0, pe0);
      for (int p = 1; p < npre; ++p) {
        const int pred = clampR(prow[p]);
        const int pb = s_beg[pred];
        PredVals v;
        if (single && pred == t - 1 && pb == r.beg_sn)
          from_regs(v, ph, pe1, pe2, ph_left);
        else
          load_pred(v, H, E1, E2, pred, l0 + subw(r.t_off, mulw(pb, pn)),
                    WB, inf, gm);
        slot_bits(v, p, pb, s_end[pred]);
      }
      u64 bt[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u) bt[u] = field_bits<GM>(fl[u]);
#pragma unroll
      for (int u = 1; u < CPT; ++u)
        bt[u] |= f_bits<GM>(hrow[u], f1row[u], f2row[u], hrow[u - 1],
                            f1row[u - 1], f2row[u - 1], e1, oe1, e2, oe2);
      // the first lane's left neighbour: the lane before, else the warp
      // before (after the barrier), else the tile before
      const int nh = __shfl_up_sync(~0u, hrow[CPT - 1], 1);
      const int nf1 = __shfl_up_sync(~0u, f1row[CPT - 1], 1);
      const int nf2 = __shfl_up_sync(~0u, f2row[CPT - 1], 1);
      if (lane > 0)
        bt[0] |= f_bits<GM>(hrow[0], f1row[0], f2row[0], nh, nf1, nf2, e1,
                            oe1, e2, oe2);
      else if (wid == 0)
        bt[0] |= f_bits<GM>(hrow[0], f1row[0], f2row[0], eh, ef1, ef2, e1,
                            oe1, e2, oe2);
      if (lane == 31) {
        s_edge[wid] = hrow[CPT - 1];
        s_edge[32 + wid] = f1row[CPT - 1];
        s_edge[64 + wid] = f2row[CPT - 1];
      }

      DP_PROBE(4)
      // ---- the row maximum candidates: out-of-band lanes count as inf
      // ----
      if (live) {
#pragma unroll
        for (int u = 0; u < CPT; ++u) {
          const int l = l0 + u;
          const int lseg = l >> psh;
          const int v =
              (band[u] && addw(r.t_off, l) <= qlen) ? hrow[u] : inf;
          const u64 k = best_key(v, l & (pn - 1),
                                 lseg == r.n_seg - 1 ? 0 : lseg + 1);
          kbest = k > kbest ? k : kbest;
        }
      }
      if (last_tile) {
        kbest = warp_max64(kbest);
        if (lane == 0) s_red[wid] = kbest;
      }
      __syncthreads();
      DP_PROBE(5)
      const int left = lane > 0 ? nh : (wid > 0 ? s_edge[wid - 1] : eh);
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
        ph_left = l0 >= 1 ? left : inf;
      }
      eh = s_edge[NW - 1];
      ef1 = s_edge[32 + NW - 1];
      ef2 = s_edge[64 + NW - 1];
      if (live) {
#pragma unroll
        for (int u = 0; u < CPT; ++u) BTt[l0 + u] = (W)bt[u];
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
    const int wseg = aux_pick == 0 ? r.n_seg - 1 : aux_pick - 1;
    const int mi = gmax > inf
                       ? addw(r.t_off, addw(mulw(wseg, pn), lane_pick))
                       : -1;
    bool stop_now = false;
    if (extend) {
      const bool better = gmax > bs;
      if (a.zdrop_on) {
        const int delta = subw(brem, s_rem[t]);
        const int d = subw(delta, subw(mi, bj));
        const int zlim = addw(zdrop, mulw(e1, d < 0 ? -d : d));
        stop_now = !better && subw(bs, gmax) > zlim;
      }
      if (better) {
        bs = gmax;
        bi = t;
        bj = mi;
        brem = s_rem[t];
      }
    }
    prev_push = !stop_now;
    prev_mi1 = addw(mi, 1);
    if (prev_push) {
      if (tid < nout) {
        atomicMin(&s_mpl[my_tgt], prev_mi1);
        atomicMax(&s_mpr[my_tgt], prev_mi1);
      }
      for (int o = tid + NT; o < nout; o += NT) {
        const int tgt = clampR(out_idx[(size_t)t * O + o]);
        atomicMin(&s_mpl[tgt], prev_mi1);
        atomicMax(&s_mpr[tgt], prev_mi1);
      }
    }
    DP_PROBE(6)
    cells = addw(cells, mulw(r.n_seg, pn));
    if (stop_now) break;  // extend mode stopped on z-drop
  }
  __syncthreads();

  for (int i = tid; i < R; i += NT) {
    a.begsn[ro + i] = s_beg[i];
    a.endsn[ro + i] = s_end[i];
    a.mpl[ro + i] = s_mpl[i];
    a.mpr[ro + i] = s_mpr[i];
  }
  if (tid != 0) return;
  // column c of tile row i, 0 outside the tile (ref :448-450)
  auto lane_at = [&](const int* pl, int i, int c) -> int {
    const long long lc = (long long)c - (long long)s_beg[i] * pn;
    return (lc >= 0 && lc < WB) ? pl[(size_t)i * WB + lc] : 0;
  };
  if (a.mode == 0) {
    // ---- best cell over the sink's predecessors (ref :421-435) ----
    const int sink = clampR(nrows - 1);
    const int np = s_ctrl[sink] & CMASK;
    for (int p = 0; p < np; ++p) {
      const int pred = clampR(pre[(size_t)sink * P + p]);
      const int ec = min(qlen, (s_end[pred] + 1) * pn - 1);
      const int val = lane_at(H, pred, ec);
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
  misc[M_OVFL] = ovfl;
  if (a.LS == 0) return;
  DP_PROBE_MARK

  // ---- the walk (ref :447-614): one backtrack word per step ----
  // slot p's part of the word of cell (i, j) from the tiles, as bt_slot
  // derives it in the sweep (hh, e1c, e2c: the cell's own values)
  auto slot_hits = [&](Fields& fw, int p, int i, int j, int s, int hh,
                       int e1c, int e2c) {
    const int pred = clampR(pre[(size_t)i * P + p]);
    const int plo = mulw(s_beg[pred], pn);
    const int phi = mulw(s_end[pred] + 1, pn) - 1;
    bt_slot(fw, p, j, plo, phi, lane_at(H, pred, j - 1),
            lane_at(H, pred, j),
            gm != LINEAR_GAP ? lane_at(E1, pred, j) : 0,
            gm == CONVEX_GAP ? lane_at(E2, pred, j) : 0, s, hh, e1c, e2c,
            gm, e1, oe1, e2, oe2);
  };
  long long* st = a.steps + (size_t)b * max(a.LS, 8);
  int i = bi, j = bj, cur = BT_ALL, nst = 0;
  bool if_ = true, fail = false;
  bool done = bi <= 0 || bj <= 0;
  while (!done && nst < a.LS) {
    i = clampR(i);
    const int cw = s_ctrl[i];
    const int np = cw & CMASK, base = (cw >> C_BASE) & 31;
    const int s = (j >= 0 && j < a.Wq) ? qp[(size_t)base * a.Wq + j] : 0;
    const long long li = (long long)j - (long long)s_beg[i] * pn;
    const bool in_tile = li >= 0 && li < WB;
    u64 wd;
    int hh = 0, e1c = 0, e2c = 0;
    if (in_tile) {
      wd = (u64)BT[(size_t)i * WB + li];
    } else {
      // a cell outside its row's tile: zeros, and inf at the lane before
      // when that lane is in the tile (its last lane, never in the band)
      Fields fw;
      fields_init(fw);
      for (int p = 0; p < np; ++p) slot_hits(fw, p, i, j, s, 0, 0, 0);
      const int fprev = li == WB ? inf : 0;
      wd = field_bits<GM>(fw)
           | f_bits<GM>(0, 0, 0, lane_at(H, i, j - 1), fprev, fprev, e1,
                        oe1, e2, oe2);
    }
    // the first slot from SPILL on that meets field k's condition
    auto spill_slot = [&](int k) {
      if (in_tile) {
        hh = lane_at(H, i, j);
        if (gm != LINEAR_GAP) e1c = lane_at(E1, i, j);
        if (gm == CONVEX_GAP) e2c = lane_at(E2, i, j);
      }
      for (int p = SPILL; p < np; ++p) {
        Fields fw;
        fields_init(fw);
        slot_hits(fw, p, i, j, s, hh, e1c, e2c);
        if (fw.f[k] != NONE) return p;
      }
      return NONE;
    };
    const bool curM = (cur & BT_M) != 0;
    const int mp = (int)(wd >> BL::MP) & NONE;
    const bool m_possible = mp != NONE;
    bool e_possible, f_possible;
    int e_pick = 0, e_op_sel = BT_ALL, f_op_sel = BT_ALL;
    if (gm == LINEAR_GAP) {
      e_pick = (int)(wd >> BL::E1M) & NONE;
      if (e_pick == SPILL) e_pick = spill_slot(1);
      e_possible = e_pick != NONE;
      f_possible = (wd >> BL::F) & 1;
    } else {
      int pe1 = (int)(wd >> (curM ? BL::E1M : BL::E1X)) & NONE;
      if (pe1 == SPILL) pe1 = spill_slot(curM ? 1 : 2);
      const bool op1 = (wd >> (BL::O + (curM ? 0 : 1))) & 1;
      const bool e1hit = (cur & BT_E1) && pe1 != NONE;
      int pe2 = NONE;
      bool op2 = false, e2hit = false;
      if (gm == CONVEX_GAP) {
        pe2 = (int)(wd >> (curM ? BL::E2M : BL::E2X)) & NONE;
        if (pe2 == SPILL) pe2 = spill_slot(curM ? 3 : 4);
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
      const bool hit_f1 =
          (cur & BT_F1) && (curM ? f1g : true) && (f1o || f1x);
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
      new_i = pre[(size_t)i * P + (mp == SPILL ? spill_slot(0) : mp)];
    else if (use_e)
      new_i = clampR(pre[(size_t)i * P + e_pick]);
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
int launch_rows(const TileArgs& a, int B, int NT, size_t smem,
                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tile_dp_kernel<GM, SROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tile_dp_kernel<GM, SROWS><<<B, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int GM>
int launch(const TileArgs& a, int B, int NT, size_t smem, bool srows,
           void* stream) {
  return srows ? launch_rows<GM, true>(a, B, NT, smem, stream)
               : launch_rows<GM, false>(a, B, NT, smem, stream);
}

}  // namespace
}  // namespace abpoa

DP_PROBE_EXPORT

// C entry point (bound with ctypes). Enqueues the kernel on `stream`;
// returns the cudaError_t of the launch.
extern "C" int tile_dp_launch(
    const int* scal, const int* bases, const int* pre_idx, const int* pre_n,
    const int* out_idx, const int* out_n, const int* remain, const int* qp,
    const int* mpl0, const int* mpr0, int* begsn, int* endsn, int* mpl,
    int* mpr, int* misc, long long* steps, int* rows, int* H, int* E1,
    int* E2, void* BT, int B, int R, int WB, int Wq, int P, int O, int m,
    int pn, int gap_mode, int align_mode, int zdrop_on, int LS,
    void* stream) {
  using namespace abpoa;
  if (B <= 0) return 0;
  // pn a power of two (floor divisions by it are shifts) up to 64 (the
  // lane-in-segment field of the row-maximum key); bases fit the control
  // word
  if (R < 2 || R >= (1 << 30) || WB <= 0 || Wq <= 0 || Wq >= (1 << 30)
      || P <= 0 || O <= 0 || m <= 0 || m > 32 || pn <= 0 || pn > 64
      || (pn & (pn - 1)) || WB % pn || (align_mode != 0 && align_mode != 2))
    return (int)cudaErrorInvalidValue;
  const int NT = min(MAX_NT, ((WB + CPT - 1) / CPT + 31) / 32 * 32);
  const size_t fixed = smem_with_rows(R);
  const bool srows = fixed > sizeof(int) * FIXED_WORDS;
  // past shared memory the per-row arrays need the caller's scratch
  if (!srows && rows == nullptr) return (int)cudaErrorInvalidValue;
  const size_t with_pre = fixed + sizeof(int) * (size_t)R * P;
  const int pre_smem = with_pre <= MAX_SMEM;
  const size_t smem = pre_smem ? with_pre : fixed;
  TileArgs a{scal, bases, pre_idx, pre_n, out_idx, out_n, remain, qp, mpl0,
             mpr0, begsn, endsn, mpl, mpr, misc, steps, rows, H, E1, E2, BT,
             R, WB, Wq, P, O, m, pn, __builtin_ctz(pn), align_mode,
             zdrop_on, LS, pre_smem};
  // the gap mode's instance (a mode neither linear nor convex is affine)
  if (gap_mode == LINEAR_GAP)
    return launch<LINEAR_GAP>(a, B, NT, smem, srows, stream);
  if (gap_mode == CONVEX_GAP)
    return launch<CONVEX_GAP>(a, B, NT, smem, srows, stream);
  return launch<AFFINE_GAP>(a, B, NT, smem, srows, stream);
}
