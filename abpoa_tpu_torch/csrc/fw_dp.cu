// Full-width POA DP + backtrack walk at absolute query columns, one CUDA
// block per POA instance.
//
// Replaces the TPU kernel make_fw_kernel behind fw_poa_dp_batch
// (abpoa_tpu/ops/dp_pallas_fw.py:80, :685). Plain PyTorch version:
// abpoa_tpu_torch/ops/fw_dp.py fw_poa_dp_batch_ref; the two are held
// bit-equal on misc, the steps, the band bounds and the band state.
//
// What it computes: rows in topological order over planes H, E1, E2, F1,
// F2 [R, Wq] (1, 3 or 5 by gap mode) at absolute columns; banded rows
// take the band kernel's fill/merge masks, unbanded rows (-b -1) span
// [0, qlen]; local mode clamps at 0 and keeps the best cell of every row,
// extend mode the best row maximum with z-drop; the band state is
// scattered to the out-nodes. The walk re-derives every backtrack
// condition from the planes. Full rows cannot overflow: no M_OVFL.
//
// What bounds it on an H100: rows are sequential (row t reads its
// predecessors' rows), so one instance is one block and a row is a
// Wq-wide vector (Wq = 768-896 at the heter geometry, several thousand
// for long reads): latency-bound on block barriers and the L2 round trips
// of the predecessor rows, like the band kernel, with Wq/WB times its
// cells. The design: up to 1024 threads, each owning a contiguous chunk
// of ceil(Wq / threads) columns; a row is two passes over the chunk. The
// first merges the predecessor rows (a shift by one column plus a max,
// read from device memory, L2-resident) and parks the merged values in
// the row's own plane slots; between the passes a block-wide
// Hillis-Steele scan of the chunk maxima gives each thread the prefix max
// of the F (insertion) recurrence up to its chunk (the counterpart of
// kscan_max); the second pass finishes F, H and E and the row maximum.
// Band bounds and band state live in shared memory; the walk runs on one
// thread.
#include <cuda_runtime.h>

#include "layout.cuh"

namespace abpoa {
namespace {

constexpr int LOCAL_MODE = 1, EXTEND_MODE = 2;

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
  int* steps;          // [B, max(LS, 8)] (zeroed)
  int* H;              // [B, R, Wq] planes (scratch)
  int* E1;
  int* E2;
  int* F1;
  int* F2;
  int R, Wq, P, O, m, pn, gm, mode, zdrop_on, banded, LS;
};

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

// inclusive prefix max over s[0..blockDim) in place, two arrays at once
__device__ void scan_max2(int* s1, int* s2) {
  int i = threadIdx.x, n = blockDim.x;
  for (int d = 1; d < n; d <<= 1) {
    int a1 = s1[i], a2 = s2[i];
    int b1 = i >= d ? s1[i - d] : NEG;
    int b2 = i >= d ? s2[i - d] : NEG;
    __syncthreads();
    s1[i] = max(a1, b1);
    s2[i] = max(a2, b2);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(1024) fw_dp_kernel(FwArgs a) {
  extern __shared__ int smem[];
  const int R = a.R, Wq = a.Wq, P = a.P, O = a.O, pn = a.pn, gm = a.gm;
  const bool local = a.mode == LOCAL_MODE, extend = a.mode == EXTEND_MODE;
  const int b = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int CPT = (Wq + NT - 1) / NT;
  const int c0 = tid * CPT, c1 = min(c0 + CPT, Wq);
  long long* s_red64 = reinterpret_cast<long long*>(smem);  // 32
  int* s_red = smem + 64;                                   // 32
  int* s_beg = s_red + 32;
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
  const int* rowmask = a.rowmask + ro;
  const int* qp = a.qp + (size_t)b * a.m * Wq;
  const size_t plane = (size_t)R * Wq;
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
  for (int i = tid; i < R; i += NT) {
    bool live = i < nrows;
    s_beg[i] = 0;
    s_end[i] = 0;
    s_mpl[i] = live ? a.mpl0[ro + i] : 0;
    s_mpr[i] = live ? a.mpr0[ro + i] : 0;
  }
  __syncthreads();

  // ---- first row (ref :553-662) ----
  if (tid == 0) {
    s_mpl[0] = 0;
    s_mpr[0] = 0;
    for (int o = 0; o < min(out_n[0], O); ++o) {
      int tgt = out_idx[o];
      s_mpl[tgt] = 1;
      s_mpr[tgt] = 1;
    }
  }
  __syncthreads();
  {
    int end0 = qlen;
    if (a.banded) {
      int rem = remain[0] - remend - 1;
      end0 = min(qlen, max(s_mpr[0], qlen - rem) + w);
    }
    int end_sn0 = floordiv(end0, pn);
    if (tid == 0) s_end[0] = end_sn0;
    int esn = min(end_sn0 + 1, dpsn - 1);
    for (int c = c0; c < c1; ++c) {
      if (local) {
        H[c] = 0;
        if (gm != LINEAR_GAP) E1[c] = F1[c] = 0;
        if (gm == CONVEX_GAP) E2[c] = F2[c] = 0;
        continue;
      }
      bool hi_mask = floordiv(c, pn) <= esn;
      bool de_mask = c <= (end_sn0 + 1) * pn - 1;
      int fill0 = hi_mask ? inf : 0;
      if (gm == LINEAR_GAP) {
        H[c] = de_mask ? mulw(-e1, c) : fill0;
      } else {
        int f1v = -o1 - mulw(e1, c);
        int f2v = -o2 - mulw(e2, c);
        int hv = gm == CONVEX_GAP ? max(f1v, f2v) : f1v;
        H[c] = c == 0 ? 0 : ((de_mask && c >= 1) ? hv : fill0);
        E1[c] = c == 0 ? -oe1 : fill0;
        F1[c] = (de_mask && c >= 1) ? f1v : (c == 0 ? inf : 0);
        if (gm == CONVEX_GAP) {
          E2[c] = c == 0 ? -oe2 : fill0;
          F2[c] = (de_mask && c >= 1) ? f2v : (c == 0 ? inf : 0);
        }
      }
    }
  }
  __syncthreads();

  // best cell / z-drop / cells: thread 0's copies
  int bs = inf, bi = 0, bj = 0, brem = remain[0], cells = 0;
  bool stop = false;
  const int limit = min(nrows - 1, R - 1);
  for (int t = 1; t < limit; ++t) {
    // ---- per-row scalars (every thread, from shared) ----
    int beg = 0, end = qlen;
    if (a.banded) {
      int rem = remain[t] - remend - 1;
      beg = max(0, min(s_mpl[t], qlen - rem) - w);
      end = min(qlen, max(s_mpr[t], qlen - rem) + w);
    }
    const int npre = min(pre_n[t], P);
    const int* prow_ids = pre_idx + (size_t)t * P;
    int min_pb = 1 << 30;
    for (int p = 0; p < npre; ++p) min_pb = min(min_pb, s_beg[prow_ids[p]]);
    const int beg_sn = max(floordiv(beg, pn), min_pb);
    const int end_sn = floordiv(end, pn);
    const int begc = beg_sn, endc = end_sn;
    const int capc = min(endc + 1, dpsn - 1);
    const int lo = mulw(begc, pn);
    const int base = min(max(bases[t], 0), a.m - 1);
    const int* qrow_p = qp + (size_t)base * Wq;
    int* Ht = H + (size_t)t * Wq;
    int* E1t = E1 + (size_t)t * Wq;
    int* E2t = E2 + (size_t)t * Wq;
    int* F1t = F1 + (size_t)t * Wq;
    int* F2t = F2 + (size_t)t * Wq;

    // ---- pass 1: predecessor merges, parked in the row's plane slots
    // (H: h, or h0 = h + qrow; E1/E2: the merged E), chunk maxima of the
    // F scan's input ----
    int cmax1 = NEG, cmax2 = NEG;
    for (int c = c0; c < c1; ++c) {
      int seg = floordiv(c, pn);
      bool band = seg >= begc && seg <= endc;
      int qrow = (c >= 1 && c <= qlen) ? qrow_p[c] : 0;
      int h = 0, e1v = 0, e2v = 0;
      for (int p = 0; p < P; ++p) {
        int pred = prow_ids[p];
        bool pvc = p < pre_n[t];
        int pbegc = pvc ? s_beg[pred] : (1 << 29);
        int pendc = pvc ? s_end[pred] : -(1 << 29);
        int _begc = local ? begc : max(begc, pbegc);
        int _endc = local ? endc : min(min(pendc + 1, endc), dpsn - 1);
        const int* prH = H + (size_t)pred * Wq;
        int preH = prH[c];
        int cand = c >= 1 ? prH[c - 1] : NEG;
        int boundary = local ? 0 : (pbegc < begc ? cand : inf);
        if (c == mulw(_begc, pn)) cand = boundary;
        if (gm == LINEAR_GAP) cand = max(cand + qrow, preH - e1);
        bool mmask = seg >= _begc && seg <= _endc && pvc;
        if (p == 0) {
          if (!local && ((seg >= begc && seg < _begc)
                         || (seg > _endc && seg <= capc)))
            h = inf;
          if (mmask) h = cand;
        } else if (mmask) {
          h = max(h, cand);
        }
        if (gm != LINEAR_GAP) {
          int _ende = min(pendc, endc);
          bool emask = seg >= _begc && seg <= _ende && pvc;
          int preE1 = E1[(size_t)pred * Wq + c];
          int preE2 = gm == CONVEX_GAP ? E2[(size_t)pred * Wq + c] : 0;
          if (p == 0) {
            if (!local && ((seg >= begc && seg < _begc)
                           || (seg > _ende && seg <= endc))) {
              e1v = inf;
              e2v = inf;
            }
            if (emask) {
              e1v = preE1;
              e2v = preE2;
            }
          } else if (emask) {
            e1v = max(e1v, preE1);
            e2v = max(e2v, preE2);
          }
        }
      }
      int rel = c - lo;
      if (gm == LINEAR_GAP) {
        Ht[c] = h;
        cmax1 = max(cmax1, band ? max(h, inf) + rel * e1 : NEG);
      } else {
        int h0 = h + (band ? qrow : 0);
        Ht[c] = h0;
        E1t[c] = e1v;
        int src = h0;
        if (gm == CONVEX_GAP) {
          E2t[c] = e2v;
          src = max(max(h0, e1v), e2v);
          cmax2 = max(cmax2, band ? max(src, inf) + rel * e2 : NEG);
        }
        cmax1 = max(cmax1, band ? max(src, inf) + rel * e1 : NEG);
      }
    }
    s_scan1[tid] = cmax1;
    s_scan2[tid] = cmax2;
    __syncthreads();
    scan_max2(s_scan1, s_scan2);
    int pm1 = tid > 0 ? s_scan1[tid - 1] : NEG;
    int pm2 = tid > 0 ? s_scan2[tid - 1] : NEG;

    // ---- pass 2: F, H, E and the row maximum ----
    int vbest = NEG;
    long long kbest = 0x7FFFFFFFFFFFFFFFLL;
    for (int c = c0; c < c1; ++c) {
      int seg = floordiv(c, pn);
      bool band = seg >= begc && seg <= endc;
      int rel = c - lo;
      int hrow;
      if (gm == LINEAR_GAP) {
        int h = Ht[c];
        pm1 = max(pm1, band ? max(h, inf) + rel * e1 : NEG);  // inclusive
        int hfin = max(pm1 - rel * e1, inf);
        if (local) hfin = max(hfin, 0);
        hrow = band ? hfin : h;
        Ht[c] = hrow;
      } else {
        int h0 = Ht[c], e1v = E1t[c];
        int e2v = gm == CONVEX_GAP ? E2t[c] : 0;
        int src = gm == CONVEX_GAP ? max(max(h0, e1v), e2v) : h0;
        int f1 = c == lo ? h0 - oe1 : pm1 - oe1 - (rel - 1) * e1;
        f1 = max(f1, inf);
        pm1 = max(pm1, band ? max(src, inf) + rel * e1 : NEG);
        if (gm == CONVEX_GAP) {
          int f2 = c == lo ? h0 - oe2 : pm2 - oe2 - (rel - 1) * e2;
          f2 = max(f2, inf);
          pm2 = max(pm2, band ? max(src, inf) + rel * e2 : NEG);
          int hpf = band ? src : NEG;
          int hh = max(max(hpf, f1), f2);
          if (local) hh = max(hh, 0);
          int e1n = max(e1v - e1, hh - oe1);
          int e2n = max(e2v - e2, hh - oe2);
          if (local) {
            e1n = max(e1n, 0);
            e2n = max(e2n, 0);
          }
          hrow = band ? hh : h0;
          E1t[c] = band ? e1n : e1v;
          E2t[c] = band ? e2n : e2v;
          F1t[c] = band ? f1 : 0;
          F2t[c] = band ? f2 : 0;
        } else {
          int h1 = max(h0, e1v);
          int hh = max(h1, f1);
          if (local) hh = max(hh, 0);
          int e1n = max(e1v - e1, hh - oe1);
          int e1fin = hh == h1 ? e1n : (local ? 0 : inf);
          hrow = band ? hh : h0;
          E1t[c] = band ? e1fin : e1v;
          F1t[c] = band ? f1 : 0;
        }
        Ht[c] = hrow;
      }
      if (c >= lo) {
        // row max with the reference tie-breaks: the maximal value, then
        // the lowest lane-in-segment, then the last segment, then the
        // first (aux = prio*1024 + segment-in-band)
        int v = (band && c <= qlen) ? hrow : inf;
        int lseg = seg - begc;
        int prio = lseg == endc - begc ? -1 : lseg;
        long long key = ((long long)(c % pn) << 32)
                        | (unsigned)(prio * 1024 + lseg + 1024);
        if (v > vbest || (v == vbest && key < kbest)) {
          vbest = v;
          kbest = key;
        }
      }
    }
    int gmax = block_max(vbest, s_red);
    long long kpick = block_min64(vbest == gmax ? kbest
                                                : 0x7FFFFFFFFFFFFFFFLL,
                                  s_red64);
    if (tid == 0) {
      s_beg[t] = beg_sn;
      s_end[t] = end_sn;
      bool active = !stop && rowmask[t] > 0;
      int lane_pick = (int)(kpick >> 32);
      int aux_pick = (int)(kpick & 0xFFFFFFFFLL) - 1024;
      int wseg = aux_pick - floordiv(aux_pick, 1024) * 1024;
      int mi = gmax > inf ? (begc + wseg) * pn + lane_pick : -1;
      bool stop_now = false;
      if (local || extend) {
        bool better = gmax > bs;
        if (extend && a.zdrop_on) {
          int delta = brem - remain[t];
          int zlim = zdrop + mulw(e1, abs(delta - (mi - bj)));
          stop_now = !better && bs - gmax > zlim;
        }
        if (active && better) {
          bs = gmax;
          bi = t;
          bj = mi;
          brem = remain[t];
        }
        stop_now = active && stop_now;
      }
      if (active && !stop_now) {
        // the band state of the out-nodes (ref adaptive band update)
        for (int o = 0; o < min(out_n[t], O); ++o) {
          int tgt = out_idx[(size_t)t * O + o];
          s_mpr[tgt] = max(s_mpr[tgt], mi + 1);
          s_mpl[tgt] = min(s_mpl[tgt], mi + 1);
        }
      }
      stop = stop || stop_now;
      if (active) cells += (end_sn - beg_sn + 1) * pn;
    }
    __syncthreads();
  }

  for (int i = tid; i < min(nrows, R); i += NT) {
    a.begsn[ro + i] = s_beg[i];
    a.endsn[ro + i] = s_end[i];
    a.mpl[ro + i] = s_mpl[i];
    a.mpr[ro + i] = s_mpr[i];
  }
  if (tid != 0) return;
  if (a.mode == 0) {
    // ---- best cell over the sink's predecessors ----
    int sink = min(max(nrows - 1, 0), R - 1);
    for (int p = 0; p < P; ++p) {
      if (p >= pre_n[sink]) continue;
      int pred = pre_idx[(size_t)sink * P + p];
      int ec = min(qlen, (s_end[pred] + 1) * pn - 1);
      int val = (ec >= 0 && ec < Wq) ? H[(size_t)pred * Wq + ec] : 0;
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

  // ---- the walk: every condition the reference backtrack tests, read
  // off the planes (0 outside [0, Wq)) ----
  auto at = [&](const int* pl, int i, int c) -> int {
    return (c >= 0 && c < Wq) ? pl[(size_t)i * Wq + c] : 0;
  };
  auto in_band = [&](int r, int c) -> bool {
    return s_beg[r] * pn <= c && c <= (s_end[r] + 1) * pn - 1;
  };
  int* st = a.steps + (size_t)b * max(a.LS, 8);
  int i = bi, j = bj, cur = BT_ALL, nst = 0;
  bool if_ = true, fail = false;
  bool done = bi <= 0 || bj <= 0;
  while (!done && nst < a.LS) {
    const bool curM = (cur & BT_M) != 0;
    const int hij = at(H, i, j), h_prev = at(H, i, j - 1);
    const bool zero_stop = local && hij == 0;
    const int base = min(max(bases[i], 0), a.m - 1);
    const int s = (j >= 0 && j < Wq) ? qp[(size_t)base * Wq + j] : 0;
    int e1ij = 0, f1ij = 0, f1prev = 0, e2ij = 0, f2ij = 0, f2prev = 0;
    if (gm != LINEAR_GAP) {
      e1ij = at(E1, i, j);
      f1ij = at(F1, i, j);
      f1prev = at(F1, i, j - 1);
    }
    if (gm == CONVEX_GAP) {
      e2ij = at(E2, i, j);
      f2ij = at(F2, i, j);
      f2prev = at(F2, i, j - 1);
    }
    int m_pick = -1, e_pred_sel = 0, e_op_sel = BT_ALL;
    bool e_possible = false;
    for (int p = 0; p < P; ++p) {
      int pre = pre_idx[(size_t)i * P + p];
      bool pv = p < pre_n[i];
      int hpre = at(H, pre, j), hpre1 = at(H, pre, j - 1);
      if (m_pick < 0 && pv && in_band(pre, j - 1) && hpre1 + s == hij)
        m_pick = p;
      bool okp = pv && in_band(pre, j);
      if (gm == LINEAR_GAP) {
        if (!e_possible && okp && hpre - e1 == hij) {
          e_possible = true;
          e_pred_sel = pre;
          e_op_sel = BT_ALL;
        }
      } else {
        int e1pre = at(E1, pre, j);
        bool hm = curM && hij == e1pre;
        bool hx = !curM && e1ij == e1pre - e1;
        if (!e_possible && okp && (cur & BT_E1) && (hm || hx)) {
          e_possible = true;
          e_pred_sel = pre;
          e_op_sel = hpre - oe1 == e1pre ? (BT_M | BT_F) : BT_E1;
        }
        if (gm == CONVEX_GAP) {
          int e2pre = at(E2, pre, j);
          bool hm2 = curM && hij == e2pre;
          bool hx2 = !curM && e2ij == e2pre - e2;
          if (!e_possible && okp && (cur & BT_E2) && (hm2 || hx2)) {
            e_possible = true;
            e_pred_sel = pre;
            e_op_sel = hpre - oe2 == e2pre ? (BT_M | BT_F) : BT_E2;
          }
        }
      }
    }
    bool m_possible = m_pick >= 0;
    bool f_possible;
    int f_op_sel = BT_ALL;
    if (gm == LINEAR_GAP) {
      f_possible = h_prev - e1 == hij;
    } else {
      bool f1_open = h_prev - oe1 == f1ij;
      bool f1_ext = f1prev - e1 == f1ij;
      bool f1_gate = curM ? hij == f1ij : true;
      bool hit_f1 = (cur & BT_F1) && f1_gate && (f1_open || f1_ext);
      int op_f1 = f1_open ? (BT_M | BT_E) : BT_F1;
      bool hit_f2 = false;
      int op_f2 = BT_ALL;
      if (gm == CONVEX_GAP) {
        bool f2_open = h_prev - oe2 == f2ij;
        bool f2_ext = f2prev - e2 == f2ij;
        bool f2_gate = curM ? hij == f2ij : true;
        hit_f2 = (cur & BT_F2) && f2_gate && (f2_open || f2_ext);
        op_f2 = f2_open ? (BT_M | BT_E) : BT_F2;
      }
      f_possible = hit_f1 || hit_f2;
      f_op_sel = hit_f1 ? op_f1 : op_f2;
    }
    bool use_m1 = curM && !if_ && m_possible;
    bool use_e = !use_m1 && e_possible;
    if (gm != LINEAR_GAP) use_e = use_e && (cur & BT_E);
    bool use_f = !use_m1 && !use_e && f_possible;
    if (gm != LINEAR_GAP) use_f = use_f && (cur & BT_F);
    bool use_m2 = !use_m1 && !use_e && !use_f && if_ && m_possible;
    if (gm != LINEAR_GAP) use_m2 = use_m2 && curM;
    bool any_hit = (use_m1 || use_e || use_f || use_m2) && !zero_stop;
    fail = fail || !(any_hit || zero_stop);
    bool use_m = use_m1 || use_m2;
    int m_pred = m_possible ? pre_idx[(size_t)i * P + m_pick] : 0;
    if (any_hit) {
      int op_code = use_m ? 0 : (use_e ? 2 : 1);
      st[nst++] = (int)((unsigned)op_code | ((unsigned)i << 2)
                        | ((unsigned)j << 14));
    }
    int new_i = use_m ? m_pred : (use_e ? e_pred_sel : i);
    int new_j = (use_m || use_f) ? j - 1 : j;
    cur = use_m ? BT_ALL : (use_e ? e_op_sel : (use_f ? f_op_sel : cur));
    if (use_m) if_ = false;
    i = new_i;
    j = new_j;
    done = fail || zero_stop || new_i <= 0 || new_j <= 0;
  }
  misc[M_NSTEPS] = nst;
  misc[M_FAIL] = fail;
  misc[M_ENDI] = i;
  misc[M_ENDJ] = j;
}

}  // namespace
}  // namespace abpoa

// shared memory of one block: reductions, band bounds and band state per
// row, the two scan arrays (66 KB at R = 4096)
static size_t fw_smem_bytes(int R, int NT) {
  return sizeof(int) * (96 + 4 * (size_t)R + 2 * (size_t)NT);
}

// C entry point (bound with ctypes). Enqueues the kernel on `stream`;
// returns the cudaError_t of the launch.
extern "C" int fw_dp_launch(
    const int* scal, const int* bases, const int* pre_idx, const int* pre_n,
    const int* out_idx, const int* out_n, const int* remain, const int* qp,
    const int* mpl0, const int* mpr0, const int* rowmask, int* begsn,
    int* endsn, int* mpl, int* mpr, int* misc, int* steps, int* H, int* E1,
    int* E2, int* F1, int* F2, int B, int R, int Wq, int P, int O, int m,
    int pn, int gap_mode, int align_mode, int zdrop_on, int banded, int LS,
    void* stream) {
  using namespace abpoa;
  if (B <= 0) return 0;
  if (R <= 0 || Wq <= 0 || P <= 0 || O <= 0 || m <= 0 || pn <= 0
      || align_mode < 0 || align_mode > 2)
    return (int)cudaErrorInvalidValue;
  int NT = min(1024, (Wq + 31) / 32 * 32);
  size_t smem = fw_smem_bytes(R, NT);
  cudaError_t err = cudaFuncSetAttribute(
      fw_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  FwArgs a{scal, bases, pre_idx, pre_n, out_idx, out_n, remain, qp, mpl0,
           mpr0, rowmask, begsn, endsn, mpl, mpr, misc, steps, H, E1, E2,
           F1, F2, R, Wq, P, O, m, pn, gap_mode, align_mode, zdrop_on,
           banded, LS};
  fw_dp_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
