// Banded POA DP over row-relative [R, WB] tiles + backtrack walk, one CUDA
// block per POA instance.
//
// Replaces the TPU kernel make_dp_kernel behind pallas_poa_dp_batch
// (abpoa_tpu/ops/dp_pallas.py:82, :639, pallas_call at :713). Plain
// PyTorch version: abpoa_tpu_torch/ops/tile_dp.py tile_poa_dp_batch_ref;
// the two are held bit-equal on misc, the steps, the band bounds and
// state, and the whole tiles.
//
// What it computes: rows in topological order; lane l of row t holds query
// column beg_sn[t]*pn + l. A predecessor row is read shifted by
// t_off - pre_beg_sn*pn, inf outside its tile. Planes H, E1, E2, F1, F2 are
// outputs (1, 3 or 5 written by gap mode); the band state is pushed along
// out-edges (mpl/mpr start as copies of mpl0/mpr0); a row whose band
// outgrows the tile sets M_OVFL and is clamped to it. Extend mode keeps the
// best row maximum and stops on z-drop; global mode takes the best cell
// over the sink's predecessors. The walk re-derives every backtrack
// condition from the tiles.
//
// What bounds it on an H100: rows are sequential (row t reads its
// predecessors' rows), so one instance is one block and a row is one
// WB-lane vector: latency-bound on block barriers and the L2 round trips
// of the predecessor rows, like the other DP kernels. The serial engine
// launches it with B = 1, so its time is one block's latency. The design:
// up to 1024 threads, each owning a contiguous chunk of ceil(WB / threads)
// lanes (WB passes 1024 for reads of ~40 kb); a row is two passes over the
// chunk. The first merges the predecessor rows (from device memory,
// L2-resident) and parks the merged values in the row's own tile slots;
// between the passes a block-wide Hillis-Steele scan of the chunk maxima
// gives each thread the prefix max of the F (insertion) recurrence up to
// its chunk; the second pass finishes F, H and E and the row maximum (a
// two-key block reduction). Band bounds and band state live in shared
// memory; the walk runs on one thread.
//
// The TPU kernel's prefix max is a Kogge-Stone scan that shifts in NEG, so
// every lane but the last of a power-of-two tile also takes max(., NEG);
// the scan here is exact (INT_MIN identity) and applies that rule per lane.
#include <climits>
#include <cuda_runtime.h>

#include "layout.cuh"

namespace abpoa {
namespace {

constexpr int EXTEND_MODE = 2;

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
  int* H;              // [B, R, WB] tiles (zero-filled by the caller)
  int* E1;
  int* E2;
  int* F1;
  int* F2;
  int* begsn;          // [B, R]
  int* endsn;
  int* mpl;
  int* mpr;
  int* misc;           // [B, M_NMISC] (zeroed)
  int* steps;          // [B, max(LS, 8)] (zeroed)
  int R, WB, Wq, P, O, m, pn, gm, mode, zdrop_on, LS;
};

__device__ __forceinline__ int addw(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int subw(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ int block_max(int v, int* s_red) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(~0u, v, o));
  int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[w] = v;
  __syncthreads();
  int r = s_red[0];
  for (int i = 1; i < nw; ++i) r = max(r, s_red[i]);
  return r;
}

__device__ long long block_min64(long long v, long long* s_red) {
  for (int o = 16; o > 0; o >>= 1) {
    long long u = __shfl_xor_sync(~0u, v, o);
    v = u < v ? u : v;
  }
  int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[w] = v;
  __syncthreads();
  long long r = s_red[0];
  for (int i = 1; i < nw; ++i) r = s_red[i] < r ? s_red[i] : r;
  return r;
}

// inclusive prefix max over s[0..blockDim) in place, two arrays at once,
// with the exact identity INT_MIN
__device__ void scan_max2(int* s1, int* s2) {
  int i = threadIdx.x, n = blockDim.x;
  for (int d = 1; d < n; d <<= 1) {
    int a1 = s1[i], a2 = s2[i];
    int b1 = i >= d ? s1[i - d] : INT_MIN;
    int b2 = i >= d ? s2[i - d] : INT_MIN;
    __syncthreads();
    s1[i] = max(a1, b1);
    s2[i] = max(a2, b2);
    __syncthreads();
  }
}

// tile lane j of row `row`, `fill` outside [0, WB)
__device__ __forceinline__ int tile_at(const int* pl, int WB, int row,
                                       long long j, int fill) {
  return (j >= 0 && j < WB) ? pl[(size_t)row * WB + j] : fill;
}

__global__ void __launch_bounds__(1024) tile_dp_kernel(TileArgs a) {
  extern __shared__ int smem[];
  const int R = a.R, WB = a.WB, P = a.P, O = a.O, pn = a.pn, gm = a.gm;
  const int SB = WB / pn;
  const bool extend = a.mode == EXTEND_MODE;
  const int b = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int CPT = (WB + NT - 1) / NT;
  const int l0 = min(tid * CPT, WB), l1 = min(l0 + CPT, WB);
  // the one lane whose Kogge-Stone prefix never shifts NEG in
  const int ks_exact = (WB & (WB - 1)) == 0 ? WB - 1 : -1;
  long long* s_red64 = reinterpret_cast<long long*>(smem);  // 32
  int* s_red = smem + 64;                                   // 32
  int* s_flag = s_red + 32;                                 // 4
  int* s_beg = s_flag + 4;
  int* s_end = s_beg + R;
  int* s_mpl = s_end + R;
  int* s_mpr = s_mpl + R;
  int* s_scan1 = s_mpr + R;
  int* s_scan2 = s_scan1 + NT;

  const size_t ro = (size_t)b * R;
  const int* bases = a.bases + ro;
  const int* pre_idx = a.pre_idx + ro * P;
  const int* pre_n = a.pre_n + ro;
  const int* out_idx = a.out_idx + ro * O;
  const int* out_n = a.out_n + ro;
  const int* remain = a.remain + ro;
  const int* qp = a.qp + (size_t)b * a.m * a.Wq;
  const size_t plane = (size_t)R * WB;
  int* H = a.H + b * plane;
  int* E1 = a.E1 + b * plane;
  int* E2 = a.E2 + b * plane;
  int* F1 = a.F1 + b * plane;
  int* F2 = a.F2 + b * plane;
  const int* sc = a.scal + (size_t)b * S_NSCAL;
  const int qlen = sc[S_QLEN], nrows = sc[S_NROWS], w = sc[S_W];
  const int inf = sc[S_INF], remend = sc[S_REMEND], dpsn = sc[S_DPSN];
  const int e1 = sc[S_E1], o1 = sc[S_O1], oe1 = sc[S_OE1];
  const int e2 = sc[S_E2], o2 = sc[S_O2], oe2 = sc[S_OE2];
  const int zdrop = sc[S_ZDROP];
  auto clampR = [&](int v) { return min(max(v, 0), R - 1); };
  for (int i = tid; i < R; i += NT) {
    s_beg[i] = 0;
    s_end[i] = 0;
    s_mpl[i] = a.mpl0[ro + i];
    s_mpr[i] = a.mpr0[ro + i];
  }
  if (tid == 0) s_flag[0] = 0;
  __syncthreads();

  // ---- first row (ref :553-662): mpl/mpr[src] = 0, its successors 1 ----
  if (tid == 0) {
    for (int o = 0; o < min(out_n[0], O); ++o) {
      int tgt = clampR(out_idx[o]);
      s_mpl[tgt] = 1;
      s_mpr[tgt] = 1;
    }
    s_mpl[0] = 0;
    s_mpr[0] = 0;
  }
  __syncthreads();
  int ovfl;
  {
    int rem0 = remain[0] - remend - 1;
    int end0 = min(qlen, max(s_mpr[0], qlen - rem0) + w);
    int end_sn0 = floordiv(end0, pn);
    ovfl = end_sn0 + 2 > SB;
    int de0 = (end_sn0 + 1) * pn - 1;
    for (int l = l0; l < l1; ++l) {
      bool in_de = l <= de0;
      if (gm == LINEAR_GAP) {
        H[l] = in_de ? mulw(-e1, l) : inf;
      } else {
        int f1v = -o1 - mulw(e1, l), f2v = -o2 - mulw(e2, l);
        int hv = gm == CONVEX_GAP ? max(f1v, f2v) : f1v;
        H[l] = l == 0 ? 0 : ((in_de && l >= 1) ? hv : inf);
        E1[l] = l == 0 ? -oe1 : inf;
        F1[l] = (in_de && l >= 1) ? f1v : inf;
        if (gm == CONVEX_GAP) {
          E2[l] = l == 0 ? -oe2 : inf;
          F2[l] = (in_de && l >= 1) ? f2v : inf;
        }
      }
    }
    if (tid == 0) s_end[0] = end_sn0;
  }
  __syncthreads();

  // best cell / z-drop / cells: thread 0's copies
  int bs = inf, bi = 0, bj = 0, brem = remain[0], cells = 0;
  const int limit = min(nrows - 1, R - 1);
  for (int t = 1; t < limit; ++t) {
    if (s_flag[0]) break;  // extend mode stopped on z-drop
    // ---- per-row scalars (every thread, from shared) ----
    const int rem = remain[t] - remend - 1;
    const int beg = max(0, min(s_mpl[t], qlen - rem) - w);
    const int end = min(qlen, max(s_mpr[t], qlen - rem) + w);
    const int npre = pre_n[t];
    const int* prow = pre_idx + (size_t)t * P;
    int min_pb = 1 << 30;
    for (int p = 0; p < P; ++p)
      if (p < npre) min_pb = min(min_pb, s_beg[clampR(prow[p])]);
    const int beg_sn = max(floordiv(beg, pn), min_pb);
    int end_sn = floordiv(end, pn);
    if (end_sn - beg_sn + 2 > SB) ovfl = 1;
    end_sn = min(end_sn, beg_sn + SB - 2);
    const int n_seg = end_sn - beg_sn + 1;
    const int t_off = mulw(beg_sn, pn);
    const int cap = min(end_sn + 1, dpsn - 1);
    const int base = min(max(bases[t], 0), a.m - 1);
    const int* qrow_p = qp + (size_t)base * a.Wq;
    int* Ht = H + (size_t)t * WB;
    int* E1t = E1 + (size_t)t * WB;
    int* E2t = E2 + (size_t)t * WB;
    int* F1t = F1 + (size_t)t * WB;
    int* F2t = F2 + (size_t)t * WB;

    // ---- pass 1: predecessor merges (ref :1332-1350), parked in the
    // row's tile slots (H: h, or h0 = h + qrow; E1/E2: the merged E), and
    // the chunk maxima of the scans' inputs ----
    int cmax1 = INT_MIN, cmax2 = INT_MIN;
    for (int l = l0; l < l1; ++l) {
      const int lseg = l / pn;
      const int aseg = beg_sn + lseg;
      const int col = addw(t_off, l);
      const int qrow = (col >= 1 && col <= qlen) ? qrow_p[col] : 0;
      const bool in_band = lseg < n_seg;
      int h = 0, e1v = 0, e2v = 0;
      for (int p = 0; p < P; ++p) {
        const bool pv = p < npre;
        const int pred = clampR(prow[p]);
        const int pb = s_beg[pred], pe = s_end[pred];
        const int s = subw(t_off, mulw(pb, pn));
        const int bb = max(beg_sn, pb);
        const int ee = min(min(pe + 1, end_sn), dpsn - 1);
        int cand = tile_at(H, WB, pred, (long long)l + s - 1, inf);
        if (l == subw(mulw(bb, pn), t_off) && pb >= beg_sn) cand = inf;
        if (gm == LINEAR_GAP)
          cand = max(addw(cand, qrow),
                     subw(tile_at(H, WB, pred, (long long)l + s, inf), e1));
        const bool mmask = aseg >= bb && aseg <= ee && pv;
        if (p == 0) {
          if ((aseg >= beg_sn && aseg < bb) || (aseg > ee && aseg <= cap))
            h = inf;
          if (mmask) h = cand;
        } else if (mmask) {
          h = max(h, cand);
        }
        if (gm != LINEAR_GAP) {
          const int ende = min(pe, end_sn);
          const bool emask = aseg >= bb && aseg <= ende && pv;
          const int pe1 = tile_at(E1, WB, pred, (long long)l + s, inf);
          const int pe2 =
              gm == CONVEX_GAP ? tile_at(E2, WB, pred, (long long)l + s, inf)
                               : 0;
          if (p == 0) {
            if ((aseg >= beg_sn && aseg < bb)
                || (aseg > ende && aseg <= end_sn)) {
              e1v = inf;
              e2v = inf;
            }
            if (emask) {
              e1v = pe1;
              e2v = pe2;
            }
          } else if (emask) {
            e1v = max(e1v, pe1);
            e2v = max(e2v, pe2);
          }
        }
      }
      if (gm == LINEAR_GAP) {
        Ht[l] = h;
        cmax1 = max(cmax1, addw(max(in_band ? h : NEG, inf), mulw(l, e1)));
      } else {
        const int h0 = addw(h, in_band ? qrow : 0);
        Ht[l] = h0;
        E1t[l] = e1v;
        int src = h0;
        if (gm == CONVEX_GAP) {
          E2t[l] = e2v;
          src = max(max(h0, e1v), e2v);
          cmax2 = max(cmax2, addw(max(in_band ? src : NEG, inf), mulw(l, e2)));
        }
        cmax1 = max(cmax1, addw(max(in_band ? src : NEG, inf), mulw(l, e1)));
      }
    }
    s_scan1[tid] = cmax1;
    s_scan2[tid] = cmax2;
    __syncthreads();
    scan_max2(s_scan1, s_scan2);
    int pm1 = tid > 0 ? s_scan1[tid - 1] : INT_MIN;
    int pm2 = tid > 0 ? s_scan2[tid - 1] : INT_MIN;
    const int seed = H[(size_t)t * WB];  // h0 of lane 0 (pass 1)
    __syncthreads();  // every thread has read lane 0 before it changes

    // ---- pass 2: F, H, E (ref :664-699) and the row maximum ----
    int vbest = INT_MIN;
    long long kbest = LLONG_MAX;
    for (int l = l0; l < l1; ++l) {
      const int lseg = l / pn;
      const bool in_band = lseg < n_seg;
      int hrow;
      if (gm == LINEAR_GAP) {
        const int h = Ht[l];
        pm1 = max(pm1, addw(max(in_band ? h : NEG, inf), mulw(l, e1)));
        const int ks = l == ks_exact ? pm1 : max(pm1, NEG);
        hrow = in_band ? max(subw(ks, mulw(l, e1)), inf) : inf;
        Ht[l] = hrow;
      } else {
        const int h0 = Ht[l], e1v = E1t[l];
        const int e2v = gm == CONVEX_GAP ? E2t[l] : 0;
        const int src = gm == CONVEX_GAP ? max(max(h0, e1v), e2v) : h0;
        const int g_in = max(in_band ? src : NEG, inf);
        // F[l] from the prefix max of lanes < l (always NEG-filled)
        int f1 = l == 0 ? subw(seed, oe1)
                        : subw(subw(max(pm1, NEG), oe1), mulw(l - 1, e1));
        f1 = max(f1, inf);
        pm1 = max(pm1, addw(g_in, mulw(l, e1)));
        if (gm == CONVEX_GAP) {
          int f2 = l == 0 ? subw(seed, oe2)
                          : subw(subw(max(pm2, NEG), oe2), mulw(l - 1, e2));
          f2 = max(f2, inf);
          pm2 = max(pm2, addw(g_in, mulw(l, e2)));
          const int hpf = in_band ? src : NEG;
          const int hh = max(max(hpf, f1), f2);
          hrow = in_band ? hh : inf;
          E1t[l] = in_band ? max(subw(e1v, e1), subw(hh, oe1)) : inf;
          E2t[l] = in_band ? max(subw(e2v, e2), subw(hh, oe2)) : inf;
          F1t[l] = in_band ? f1 : inf;
          F2t[l] = in_band ? f2 : inf;
        } else {
          const int h1 = max(h0, e1v);
          const int hh = max(h1, f1);
          const int e1n = max(subw(e1v, e1), subw(hh, oe1));
          hrow = in_band ? hh : inf;
          E1t[l] = (in_band && hh == h1) ? e1n : inf;
          F1t[l] = in_band ? f1 : inf;
        }
        Ht[l] = hrow;
      }
      // row max with the reference tie-breaks (ref :1043-1057): the
      // maximal value, then the lowest lane-in-segment, then the last band
      // segment, then the earliest (prio -1 for the last segment)
      const int v = (in_band && addw(t_off, l) <= qlen) ? hrow : inf;
      const int prio = lseg == n_seg - 1 ? -1 : lseg;
      const long long key = ((long long)(l % pn) << 32)
                            | (unsigned)(prio + 1);
      if (v > vbest || (v == vbest && key < kbest)) {
        vbest = v;
        kbest = key;
      }
    }
    const int gmax = block_max(vbest, s_red);
    const long long kpick =
        block_min64(vbest == gmax ? kbest : LLONG_MAX, s_red64);
    if (tid == 0) {
      s_beg[t] = beg_sn;
      s_end[t] = end_sn;
      const int lane_pick = (int)(kpick >> 32);
      const int prio_pick = (int)(kpick & 0xFFFFFFFFLL) - 1;
      const int wseg = prio_pick < 0 ? n_seg - 1 : prio_pick;
      const int mi = gmax > inf
                         ? addw(t_off, addw(mulw(wseg, pn), lane_pick)) : -1;
      bool stop_now = false;
      if (extend) {
        const bool better = gmax > bs;
        if (a.zdrop_on) {
          const int delta = subw(brem, remain[t]);
          const int d = subw(delta, subw(mi, bj));
          const int zlim = addw(zdrop, mulw(e1, d < 0 ? -d : d));
          stop_now = !better && subw(bs, gmax) > zlim;
        }
        if (better) {
          bs = gmax;
          bi = t;
          bj = mi;
          brem = remain[t];
        }
      }
      if (!stop_now) {
        // push the band state to the out-nodes (ref :399-410)
        for (int o = 0; o < min(out_n[t], O); ++o) {
          const int tgt = clampR(out_idx[(size_t)t * O + o]);
          s_mpr[tgt] = max(s_mpr[tgt], mi + 1);
          s_mpl[tgt] = min(s_mpl[tgt], mi + 1);
        }
      } else {
        s_flag[0] = 1;
      }
      cells += n_seg * pn;
    }
    __syncthreads();
  }

  for (int i = tid; i < R; i += NT) {
    a.begsn[ro + i] = s_beg[i];
    a.endsn[ro + i] = s_end[i];
    a.mpl[ro + i] = s_mpl[i];
    a.mpr[ro + i] = s_mpr[i];
  }
  if (tid != 0) return;
  // column c of tile row i, 0 outside the tile (ref :448-450)
  auto lane_at = [&](const int* pl, int i, int c) -> int {
    long long lc = (long long)c - (long long)s_beg[i] * pn;
    return (lc >= 0 && lc < WB) ? pl[(size_t)i * WB + lc] : 0;
  };
  if (a.mode == 0) {
    // ---- best cell over the sink's predecessors (ref :421-435) ----
    const int sink = clampR(nrows - 1);
    for (int p = 0; p < P; ++p) {
      if (p >= pre_n[sink]) continue;
      const int pred = clampR(pre_idx[(size_t)sink * P + p]);
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

  // ---- the walk (ref :447-614) ----
  auto in_band = [&](int r, int c) -> bool {
    return s_beg[r] * pn <= c && c <= (s_end[r] + 1) * pn - 1;
  };
  int* st = a.steps + (size_t)b * max(a.LS, 8);
  int i = bi, j = bj, cur = BT_ALL, nst = 0;
  bool if_ = true, fail = false;
  bool done = bi <= 0 || bj <= 0;
  while (!done && nst < a.LS) {
    i = clampR(i);
    const bool curM = (cur & BT_M) != 0;
    const int hij = lane_at(H, i, j), h_prev = lane_at(H, i, j - 1);
    const int base = min(max(bases[i], 0), a.m - 1);
    const int s = (j >= 0 && j < a.Wq) ? qp[(size_t)base * a.Wq + j] : 0;
    int e1ij = 0, f1ij = 0, f1prev = 0, e2ij = 0, f2ij = 0, f2prev = 0;
    if (gm != LINEAR_GAP) {
      e1ij = lane_at(E1, i, j);
      f1ij = lane_at(F1, i, j);
      f1prev = lane_at(F1, i, j - 1);
    }
    if (gm == CONVEX_GAP) {
      e2ij = lane_at(E2, i, j);
      f2ij = lane_at(F2, i, j);
      f2prev = lane_at(F2, i, j - 1);
    }
    int m_pick = -1, e_pred = 0, e_op = BT_ALL;
    bool e_possible = false;
    for (int p = 0; p < P; ++p) {
      const int pre = clampR(pre_idx[(size_t)i * P + p]);
      const bool pv = p < pre_n[i];
      const int hpre = lane_at(H, pre, j), hpre1 = lane_at(H, pre, j - 1);
      if (m_pick < 0 && pv && in_band(pre, j - 1) && addw(hpre1, s) == hij)
        m_pick = p;
      const bool okp = pv && in_band(pre, j);
      if (gm == LINEAR_GAP) {
        if (!e_possible && okp && subw(hpre, e1) == hij) {
          e_possible = true;
          e_pred = pre;
          e_op = BT_ALL;
        }
      } else {
        const int e1pre = lane_at(E1, pre, j);
        const bool hm = curM && hij == e1pre;
        const bool hx = !curM && e1ij == subw(e1pre, e1);
        if (!e_possible && okp && (cur & BT_E1) && (hm || hx)) {
          e_possible = true;
          e_pred = pre;
          e_op = subw(hpre, oe1) == e1pre ? (BT_M | BT_F) : BT_E1;
        }
        if (gm == CONVEX_GAP) {
          const int e2pre = lane_at(E2, pre, j);
          const bool hm2 = curM && hij == e2pre;
          const bool hx2 = !curM && e2ij == subw(e2pre, e2);
          if (!e_possible && okp && (cur & BT_E2) && (hm2 || hx2)) {
            e_possible = true;
            e_pred = pre;
            e_op = subw(hpre, oe2) == e2pre ? (BT_M | BT_F) : BT_E2;
          }
        }
      }
    }
    const bool m_possible = m_pick >= 0;
    bool f_possible;
    int f_op = BT_ALL;
    if (gm == LINEAR_GAP) {
      f_possible = subw(h_prev, e1) == hij;
    } else {
      const bool f1_open = subw(h_prev, oe1) == f1ij;
      const bool f1_ext = subw(f1prev, e1) == f1ij;
      const bool f1_gate = curM ? hij == f1ij : true;
      const bool hit_f1 = (cur & BT_F1) && f1_gate && (f1_open || f1_ext);
      const int op_f1 = f1_open ? (BT_M | BT_E) : BT_F1;
      bool hit_f2 = false;
      int op_f2 = BT_ALL;
      if (gm == CONVEX_GAP) {
        const bool f2_open = subw(h_prev, oe2) == f2ij;
        const bool f2_ext = subw(f2prev, e2) == f2ij;
        const bool f2_gate = curM ? hij == f2ij : true;
        hit_f2 = (cur & BT_F2) && f2_gate && (f2_open || f2_ext);
        op_f2 = f2_open ? (BT_M | BT_E) : BT_F2;
      }
      f_possible = hit_f1 || hit_f2;
      f_op = hit_f1 ? op_f1 : op_f2;
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
    const int m_pred =
        m_possible ? pre_idx[(size_t)i * P + m_pick] : 0;
    if (any_hit) {
      const int op_code = use_m ? 0 : (use_e ? 2 : 1);
      st[nst++] = (int)((unsigned)op_code | ((unsigned)i << 2)
                        | ((unsigned)j << 14));
    }
    const int new_i = use_m ? m_pred : (use_e ? e_pred : i);
    const int new_j = (use_m || use_f) ? j - 1 : j;
    cur = use_m ? BT_ALL : (use_e ? e_op : (use_f ? f_op : cur));
    if (use_m) if_ = false;
    i = new_i;
    j = new_j;
    done = fail || new_i <= 0 || new_j <= 0;
  }
  misc[M_NSTEPS] = nst;
  misc[M_FAIL] = fail;
  misc[M_ENDI] = i;
  misc[M_ENDJ] = j;
}

}  // namespace
}  // namespace abpoa

// shared memory of one block: reductions and the stop flag, band bounds
// and band state per row, the two scan arrays (66 KB at R = 4096)
static size_t tile_smem_bytes(int R, int NT) {
  return sizeof(int) * (100 + 4 * (size_t)R + 2 * (size_t)NT);
}

// C entry point (bound with ctypes). Enqueues the kernel on `stream`;
// returns the cudaError_t of the launch.
extern "C" int tile_dp_launch(
    const int* scal, const int* bases, const int* pre_idx, const int* pre_n,
    const int* out_idx, const int* out_n, const int* remain, const int* qp,
    const int* mpl0, const int* mpr0, int* H, int* E1, int* E2, int* F1,
    int* F2, int* begsn, int* endsn, int* mpl, int* mpr, int* misc,
    int* steps, int B, int R, int WB, int Wq, int P, int O, int m, int pn,
    int gap_mode, int align_mode, int zdrop_on, int LS, void* stream) {
  using namespace abpoa;
  if (B <= 0) return 0;
  if (R < 2 || WB <= 0 || Wq <= 0 || P <= 0 || O <= 0 || m <= 0 || pn <= 0
      || WB % pn || (align_mode != 0 && align_mode != 2))
    return (int)cudaErrorInvalidValue;
  int NT = min(1024, (WB + 31) / 32 * 32);
  size_t smem = tile_smem_bytes(R, NT);
  cudaError_t err = cudaFuncSetAttribute(
      tile_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  TileArgs a{scal, bases, pre_idx, pre_n, out_idx, out_n, remain, qp, mpl0,
             mpr0, H, E1, E2, F1, F2, begsn, endsn, mpl, mpr, misc, steps,
             R, WB, Wq, P, O, m, pn, gap_mode, align_mode, zdrop_on, LS};
  tile_dp_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
