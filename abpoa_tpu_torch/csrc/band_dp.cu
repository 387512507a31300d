// Banded POA DP + backtrack walk, one CUDA block per POA instance, in
// two modes over one row body:
//   node-id mode (NID = true): planes and control words indexed by node
//     id, the sweep order from the packed i2n|n2i map, steps16 out; the
//     device loop's kernel.
//   topo mode (NID = false): planes and control words indexed by
//     topological row, band-state init (mplr0) and rowmask as inputs when
//     not fresh, extend mode with z-drop, int32 steps and the band
//     bounds/state out; the round-based path's kernel.
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
// per row is one WB-lane vector (WB = 384 at the heter geometry):
// latency-bound on block barriers and the L2 round trips of the
// predecessor rows, not on bandwidth or arithmetic. The design keeps the
// per-instance control words (ctrl, i2n|n2i, predecessor halves) and the
// band bounds (bsn, rms) in shared memory, one band lane per thread,
// the planes (H, E1, E2, backtrack bits: 6.3 MB per instance at
// R=1024) in device memory where they stay L2-resident between the
// write of a row and the reads of its successors. The prefix-max
// recurrences of the F (insertion) scores are block-wide Hillis-Steele
// scans in shared memory; the row max is two warp-shuffle reductions.
// Instances run in parallel as independent blocks; nothing carries from
// one block to another. The walk reads one backtrack word per step on one
// thread.
#include <cuda_runtime.h>

#include "layout.cuh"

namespace abpoa {
namespace {

struct BandArgs {
  const int* scal;   // [B, S_NSCAL]
  const int* ctrl;   // [B, R]
  const int* inp;    // [B, R*P/2] predecessor halves
  const int* i2nn;   // [B, R] (node-id mode)
  const int* mplr0;  // [B, R] mpl|mpr<<16 (topo mode, not fresh) or null
  const int* qpf;    // [B, m*KW1, WB]
  int* misc;         // [B, M_NMISC]
  int* s16w;         // [B, LS/2] (node-id mode; zeroed by the caller)
  int* steps;        // [B, max(LS, 8)] (topo mode; zeroed by the caller)
  int* bsn_out;      // [B, R] beg_sn|end_sn<<16 (topo mode; zeroed)
  int* mplr_out;     // [B, R] mpl|mpr<<16 (topo mode; zeroed)
  int* H;            // [B, R, WB] planes (scratch)
  int* E1;
  int* E2;
  int* BT;
  int R, WB, Wq, P, pn, gm, LS, m, extend, zdrop_on;
};

__device__ __forceinline__ int pre_at(const int* s_pre, int P2, int R,
                                      int node, int p) {
  unsigned w = (unsigned)s_pre[node * P2 + (p >> 1)];
  int v = (int)((w >> (16 * (p & 1))) & 0xFFFFu);
  return v < R - 1 ? v : R - 1;
}

// block-wide max / min of one int per thread; every thread gets the result
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

__device__ int block_min(int v, int* s_red) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(~0u, v, o));
  int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[w] = v;
  __syncthreads();
  int r = s_red[0];
  for (int i = 1; i < nw; ++i) r = min(r, s_red[i]);
  return r;
}

// inclusive prefix max over s[0..n) (one element per thread), in place;
// two arrays at once (convex gaps scan F1 and F2 together)
__device__ void scan_max2(int* s1, int* s2, int n) {
  int i = threadIdx.x;
  for (int d = 1; d < n; d <<= 1) {
    int a1 = s1[i], a2 = s2 ? s2[i] : 0;
    int b1 = i >= d ? s1[i - d] : NEG;
    int b2 = (s2 && i >= d) ? s2[i - d] : NEG;
    __syncthreads();
    s1[i] = max(a1, b1);
    if (s2) s2[i] = max(a2, b2);
    __syncthreads();
  }
}

// band state of a row pulled from its predecessors' row maxima (the
// reference scatters each row's max position to its out-nodes; every
// predecessor completes first, so the pull is the same value)
__device__ __forceinline__ void pull_band(const int* s_pre, const int* s_rms,
                                          int P2, int R, int row, int npre,
                                          int iw, int& mpl, int& mpr) {
  mpl = 1 << 29;
  mpr = -(1 << 29);
  bool has_src = false;
  for (int p = 0; p < npre; ++p) {
    int pred = pre_at(s_pre, P2, R, row, p);
    int wr = s_rms[pred];
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

// up to 1024 band lanes: cap registers at 64 a thread
template <bool NID>
__global__ void __launch_bounds__(1024) band_dp_kernel(BandArgs a) {
  extern __shared__ int smem[];
  const int R = a.R, WB = a.WB, P = a.P, pn = a.pn, gm = a.gm;
  const int P2 = P / 2, NSEG = WB / pn, KW1 = a.Wq / WB + 1;
  const int b = blockIdx.x, l = threadIdx.x;
  int* s_ctrl = smem;
  int* s_i2nn = s_ctrl + R;                    // node-id mode only
  int* s_pre = s_i2nn + (NID ? R : 0);
  int* s_bsn = s_pre + R * P2;
  int* s_rms = s_bsn + R;
  int* s_scan1 = s_rms + R;
  int* s_scan2 = s_scan1 + WB;
  int* s_h = s_scan2 + WB;
  int* s_f1 = s_h + WB;
  int* s_f2 = s_f1 + WB;
  int* s_red = s_f2 + WB;      // 32 ints
  int* s_bcast = s_red + 32;   // 4 ints

  const int* ctrl = a.ctrl + (size_t)b * R;
  const int* inp = a.inp + (size_t)b * R * P2;
  for (int i = l; i < R; i += blockDim.x) {
    s_ctrl[i] = ctrl[i];
    if (NID) s_i2nn[i] = a.i2nn[(size_t)b * R + i];
  }
  for (int i = l; i < R * P2; i += blockDim.x) s_pre[i] = inp[i];
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
  __syncthreads();

  // ---- first row: its window is [0, WB), lane l holds col l ----
  int ovfl, cells = 0;
  {
    int rem0 = (s_ctrl[0] >> 16) - remend - 1;
    int end0 = min(qlen, max(0, qlen - rem0) + w);
    int end_sn0 = floordiv(end0, pn);
    int cap0 = min(end_sn0 + 1, dpsn - 1);
    ovfl = cap0 + 2 > NSEG;
    bool hi_mask = (l / pn) <= cap0;
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
    if (l == 0) {
      s_rms[0] = RM_OK | 1;
      s_bsn[0] = shlw(end_sn0, 16);
      if (!NID) mplr_out[0] = 0;
    }
  }
  __syncthreads();

  // extend-mode best cell and z-drop state: every thread keeps the same
  // copy (all inputs are block-uniform)
  int bs = inf, bi = 0, bj = 0, brem = s_ctrl[0] >> 16;
  bool stop = false;
  const int limit = min(nrows - 1, R - 1);
  for (int t = 1; t < limit; ++t) {
    // ---- per-row scalars (every thread computes them from shared) ----
    int rid = NID ? min(max(s_i2nn[t] & H16, 0), R - 1) : t;
    int cw = s_ctrl[rid];
    int npre = min(NID ? (cw >> 10) & 15 : (cw >> 5) & 31, P);
    bool active = NID || (((cw >> 10) & 1) && !stop);
    int iw = (NID || !mplr0) ? nrows : mplr0[t];
    int mpl, mpr, min_pb = 1 << 30;
    for (int p = 0; p < npre; ++p)
      min_pb = min(min_pb, s_bsn[pre_at(s_pre, P2, R, rid, p)] & H16);
    pull_band(s_pre, s_rms, P2, R, rid, npre, iw, mpl, mpr);
    if (!NID && l == 0) mplr_out[t] = (int)((unsigned)mpl | shlw(mpr, 16));
    int rem = (cw >> 16) - remend - 1;
    int beg = max(0, min(mpl, qlen - rem) - w);
    int end = min(qlen, max(mpr, qlen - rem) + w);
    int beg_sn = max(floordiv(beg, pn), min_pb);
    int end_sn = floordiv(end, pn);
    if (l == 0 && active) {
      cells += (end_sn - beg_sn + 1) * pn;
      int capg = min(end_sn + 1, dpsn - 1);
      ovfl |= capg - beg_sn + 2 > NSEG;
    }
    int lo_g = mulw(beg_sn, pn);
    int k0 = floordiv(lo_g, WB);
    // the packed staging word of the JAX kernel: beg|end<<10|lomod<<20
    int bel = (int)((unsigned)beg_sn | ((unsigned)end_sn << 10)
                    | ((unsigned)(lo_g - k0 * WB) << 20));
    int begc = bel & 1023, endc = (bel >> 10) & 1023, lomodc = bel >> 20;
    int capc = min(endc + 1, dpsn - 1);
    int base = cw & (NID ? 7 : 31);
    int fold = min(max(base * KW1 + k0, 0), a.m * KW1 - 2);
    int qwin = 0;
    if (base < a.m)
      qwin = qpf[(size_t)(l >= lomodc ? fold : fold + 1) * WB + l];
    int dlo = l - lomodc;
    int rel = dlo >= 0 ? dlo : dlo + WB;
    // rel is in [0, WB) on every swept row; a row with no valid
    // predecessor (padding, unreachable) has a garbage band whose rel is
    // only wrapped back into range to index the scan arrays
    const int ri = floormod(rel, WB);
    int c = begc * pn + rel;
    int seg = floordiv(c, pn);
    bool band = seg >= begc && seg <= endc;
    int qrow = (c >= 1 && c <= qlen) ? qwin : 0;
    int lm1 = l == 0 ? WB - 1 : l - 1;

    // ---- predecessor merges ----
    int hacc = 0, e1acc = 0, e2acc = 0;
    const int np = max(npre, 1);
    for (int p = 0; p < np; ++p) {
      int pred = pre_at(s_pre, P2, R, rid, p);
      int pv = p < npre;
      int pw = s_bsn[pred];
      int pbel = (int)(((unsigned)pw & 0xFFFFu) | (((unsigned)(pw >> 16)) << 10)
                       | ((unsigned)pv << 20));
      bool pvc = (pbel >> 20) > 0;
      int pbegc = pvc ? (pbel & 1023) : (1 << 29);
      int pendc = pvc ? ((pbel >> 10) & 1023) : -(1 << 29);
      int _begc = max(begc, pbegc);
      int _endc = min(min(pendc + 1, endc), dpsn - 1);
      const int* prow = H + (size_t)pred * WB;
      int preH = prow[l];
      int rollH = prow[lm1];
      int cand = c == 0 ? NEG : rollH;
      int boundary = pbegc < begc ? cand : inf;
      if (c == mulw(_begc, pn)) cand = boundary;
      if (gm == LINEAR_GAP) cand = max(cand + qrow, preH - e1);
      bool mmask = seg >= _begc && seg <= _endc && pvc;
      if (p == 0) {
        bool fill = (seg >= begc && seg < _begc)
                    || (seg > _endc && seg <= capc);
        hacc = mmask ? cand : (fill ? inf : 0);
      } else if (mmask) {
        hacc = max(hacc, cand);
      }
      if (gm != LINEAR_GAP) {
        int preE1 = E1[(size_t)pred * WB + l];
        int preE2 = gm == CONVEX_GAP ? E2[(size_t)pred * WB + l] : 0;
        int _ende = min(pendc, endc);
        bool emask = seg >= _begc && seg <= _ende && pvc;
        if (p == 0) {
          bool efill = (seg >= begc && seg < _begc)
                       || (seg > _ende && seg <= endc);
          int ef = efill ? inf : 0;
          e1acc = emask ? preE1 : ef;
          e2acc = emask ? preE2 : ef;
        } else if (emask) {
          e1acc = max(e1acc, preE1);
          e2acc = max(e2acc, preE2);
        }
      }
    }
    int h = hacc;
    int e1v = gm != LINEAR_GAP ? e1acc : h;
    int e2v = gm == CONVEX_GAP ? e2acc : h;

    // ---- F (insertion) recurrences as prefix maxes in band order ----
    int hrow, e1row = 0, e2row = 0, f1row = 0, f2row = 0;
    if (gm == LINEAR_GAP) {
      s_scan1[ri] = band ? max(h, inf) + rel * e1 : NEG;
      __syncthreads();
      scan_max2(s_scan1, nullptr, WB);
      int hfin = max(s_scan1[ri] - rel * e1, inf);
      hrow = band ? hfin : h;
    } else {
      int h0 = h + (band ? qrow : 0);
      if (rel == 0) s_bcast[0] = h0;
      int src;
      if (gm == CONVEX_GAP) {
        src = band ? max(max(h0, e1v), e2v) : NEG;
        s_scan1[ri] = band ? max(src, inf) + rel * e1 : NEG;
        s_scan2[ri] = band ? max(src, inf) + rel * e2 : NEG;
      } else {
        src = band ? h0 : NEG;
        s_scan1[ri] = band ? max(src, inf) + rel * e1 : NEG;
      }
      __syncthreads();
      scan_max2(s_scan1, gm == CONVEX_GAP ? s_scan2 : nullptr, WB);
      int seed = s_bcast[0];
      int pm1 = ri >= 1 ? s_scan1[ri - 1] : NEG;
      int f1 = rel == 0 ? seed - oe1 : pm1 - oe1 - (rel - 1) * e1;
      f1 = max(f1, inf);
      if (gm == CONVEX_GAP) {
        int pm2 = ri >= 1 ? s_scan2[ri - 1] : NEG;
        int f2 = rel == 0 ? seed - oe2 : pm2 - oe2 - (rel - 1) * e2;
        f2 = max(f2, inf);
        int hh = max(max(src, f1), f2);
        hrow = band ? hh : h0;
        e1row = band ? max(e1v - e1, hh - oe1) : e1v;
        e2row = band ? max(e2v - e2, hh - oe2) : e2v;
        f2row = band ? f2 : 0;
      } else {
        int h1 = max(h0, e1v);
        int hh = max(h1, f1);
        int e1n = max(e1v - e1, hh - oe1);
        hrow = band ? hh : h0;
        e1row = band ? (hh == h1 ? e1n : inf) : e1v;
      }
      f1row = band ? f1 : 0;
    }
    H[(size_t)rid * WB + l] = hrow;
    if (gm != LINEAR_GAP) E1[(size_t)rid * WB + l] = e1row;
    if (gm == CONVEX_GAP) E2[(size_t)rid * WB + l] = e2row;

    // ---- backtrack bits: every comparison the walk makes, per cell ----
    int acc[9];
    for (int p = 0; p < np; ++p) {
      int pred = pre_at(s_pre, P2, R, rid, p);
      int pv = p < npre;
      int pw = s_bsn[pred];
      int pbel = (int)(((unsigned)pw & 0xFFFFu) | (((unsigned)(pw >> 16)) << 10)
                       | ((unsigned)pv << 20));
      bool pvc = (pbel >> 20) > 0;
      int pbegc = pvc ? (pbel & 1023) : (1 << 29);
      int pendc = pvc ? ((pbel >> 10) & 1023) : -(1 << 29);
      int plo = mulw(pbegc, pn);
      int phi = mulw(pendc + 1, pn) - 1;
      bool m_in = pvc && c - 1 >= plo && c - 1 <= phi;
      bool okp = pvc && c >= plo && c <= phi;
      const int* prow = H + (size_t)pred * WB;
      int bm = m_in ? prow[lm1] : NEG;
      int bh = okp ? prow[l] : NEG;
      bool mh = bm + qrow == hrow;
      bool e1m, e1x, e1o, e2m = false, e2x = false, e2o = false;
      if (gm == LINEAR_GAP) {
        e1m = e1x = (bh - e1) == hrow;
        e1o = false;
      } else {
        int be1 = okp ? E1[(size_t)pred * WB + l] : NEG;
        e1m = hrow == be1;
        e1x = e1row == be1 - e1;
        e1o = (bh - oe1) == be1;
        if (gm == CONVEX_GAP) {
          int be2 = okp ? E2[(size_t)pred * WB + l] : NEG;
          e2m = hrow == be2;
          e2x = e2row == be2 - e2;
          e2o = (bh - oe2) == be2;
        }
      }
      if (p == 0) {
        acc[0] = mh ? 0 : 15;
        acc[1] = e1m ? 0 : 15;
        acc[2] = e1x ? 0 : 15;
        acc[3] = e1m && e1o;
        acc[4] = e1x && e1o;
        acc[5] = e2m ? 0 : 15;
        acc[6] = e2x ? 0 : 15;
        acc[7] = e2m && e2o;
        acc[8] = e2x && e2o;
      } else {
        if (mh && acc[0] == 15) acc[0] = p;
        if (e1m && acc[1] == 15) { acc[3] = e1o; acc[1] = p; }
        if (e1x && acc[2] == 15) { acc[4] = e1o; acc[2] = p; }
        if (gm == CONVEX_GAP) {
          if (e2m && acc[5] == 15) { acc[7] = e2o; acc[5] = p; }
          if (e2x && acc[6] == 15) { acc[8] = e2o; acc[6] = p; }
        }
      }
    }
    s_h[l] = hrow;
    s_f1[l] = f1row;
    s_f2[l] = f2row;
    __syncthreads();
    int hprev = rel == 0 ? 0 : s_h[lm1];
    int fb;
    if (gm == LINEAR_GAP) {
      fb = ((hprev - e1) == hrow) << 24;
    } else {
      int f1prev = rel == 0 ? 0 : s_f1[lm1];
      fb = (((hprev - oe1) == f1row) << 24) | (((f1prev - e1) == f1row) << 25)
           | ((hrow == f1row) << 26);
      if (gm == CONVEX_GAP) {
        int f2prev = rel == 0 ? 0 : s_f2[lm1];
        fb |= (((hprev - oe2) == f2row) << 27)
              | (((f2prev - e2) == f2row) << 28) | ((hrow == f2row) << 29);
      }
    }
    BT[(size_t)rid * WB + l] = acc[0] | (acc[1] << 4) | (acc[2] << 8)
                               | (acc[3] << 12) | (acc[4] << 13)
                               | (acc[5] << 14) | (acc[6] << 18)
                               | (acc[7] << 22) | (acc[8] << 23) | fb;

    // ---- row max with the reference tie-breaks: among maximal in-band
    // cells the lowest lane-in-segment, then the last segment, then the
    // first ----
    int lseg = seg - begc;
    int nseg = endc - begc + 1;
    int vv = (band && c <= qlen) ? hrow : inf;
    int prio = lseg == nseg - 1 ? -1 : lseg;
    int key = (rel % pn) * (1 << 15) + (prio * 1024 + lseg + 1024);
    int gmax = block_max(vv, s_red);
    int kpick = block_min(vv == gmax ? key : (1 << 30), s_red);
    int aux_pick = (kpick & 0x7FFF) - 1024;
    int wseg = aux_pick - floordiv(aux_pick, 1024) * 1024;
    int maxi = gmax > inf ? (begc + wseg) * pn + (kpick >> 15) : -1;
    bool stop_now = false;
    if (!NID && a.extend) {
      bool better = gmax > bs;
      if (a.zdrop_on) {
        int delta = brem - (cw >> 16);
        int zlim = zdrop + mulw(e1, abs(delta - (maxi - bj)));
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
    if (l == 0) {
      s_rms[rid] = (active && !stop_now) ? (RM_OK | (maxi + 1)) : 0;
      s_bsn[rid] = (int)((unsigned)beg_sn | ((unsigned)end_sn << 16));
    }
    __syncthreads();
  }

  if (!NID) {
    // band bounds out; the sink row is never swept: pin its bsn and pull
    // its band state
    for (int i = l; i < limit; i += blockDim.x)
      a.bsn_out[(size_t)b * R + i] = s_bsn[i];
    if (l == 0 && limit >= 0) {
      int npre_l = min((s_ctrl[limit] >> 5) & 31, P);
      int iw = mplr0 ? mplr0[limit] : nrows;
      int mpl, mpr;
      pull_band(s_pre, s_rms, P2, R, limit, npre_l, iw, mpl, mpr);
      mplr_out[limit] = (int)((unsigned)mpl | shlw(mpr, 16));
      s_bsn[limit] = 0;
    }
  }
  if (l != 0) return;
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

  // ---- the walk: one backtrack word per step; node-id mode emits the
  // steps16 deltas (op | dj<<2 | di<<3 in topo space), two halves per
  // word, topo mode the int32 words op | row<<2 | col<<14 ----
  int* s16 = NID ? a.s16w + (size_t)b * (a.LS / 2) : nullptr;
  int* st = NID ? nullptr : a.steps + (size_t)b * max(a.LS, 8);
  int I = bi, J = bj, lane = floormod(bj, WB), cur = BT_ALL, nst = 0;
  bool if_ = true, fail = false;
  int PI = NID ? s_i2nn[bi] >> 16 : 0, PJ = bj;
  unsigned half = 0;
  bool done = bi <= 0 || bj <= 0 || ovfl;
  while (!done) {
    int wv = s_bsn[I];
    int lo_i = (wv & H16) * pn;
    int bb = (J >= lo_i && J < lo_i + WB) ? BT[(size_t)I * WB + lane]
                                          : INVALID_BITS;
    bool curM = (cur & BT_M) != 0;
    int mp = bb & 15;
    bool m_possible = mp < 15;
    bool e_possible, f_possible;
    int e_pick_p, e_op_sel, f_op_sel;
    if (gm == LINEAR_GAP) {
      int pe = (bb >> 4) & 15;
      e_possible = pe < 15;
      e_pick_p = pe;
      e_op_sel = BT_ALL;
      f_possible = (bb >> 24) & 1;
      f_op_sel = BT_ALL;
    } else {
      int pe1 = curM ? (bb >> 4) & 15 : (bb >> 8) & 15;
      int e1open = curM ? (bb >> 12) & 1 : (bb >> 13) & 1;
      bool e1hit = (cur & BT_E1) && pe1 < 15;
      int pe2 = 15, e2open = 0;
      bool e2hit = false;
      if (gm == CONVEX_GAP) {
        pe2 = curM ? (bb >> 14) & 15 : (bb >> 18) & 15;
        e2open = curM ? (bb >> 22) & 1 : (bb >> 23) & 1;
        e2hit = (cur & BT_E2) && pe2 < 15;
      }
      // candidate order interleaves (p0.e1, p0.e2, p1.e1, ...)
      int k1 = e1hit ? 2 * pe1 : 99;
      int k2 = e2hit ? 2 * pe2 + 1 : 99;
      bool use_e1 = k1 <= k2;
      e_possible = min(k1, k2) < 99;
      e_pick_p = use_e1 ? pe1 : pe2;
      e_op_sel = use_e1 ? (e1open ? (BT_M | BT_F) : BT_E1)
                        : (e2open ? (BT_M | BT_F) : BT_E2);
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
    bool use_m1 = curM && !if_ && m_possible;
    bool use_e = !use_m1 && e_possible;
    if (gm != LINEAR_GAP) use_e = use_e && (cur & BT_E);
    bool use_f = !use_m1 && !use_e && f_possible;
    if (gm != LINEAR_GAP) use_f = use_f && (cur & BT_F);
    bool use_m2 = !use_m1 && !use_e && !use_f && if_ && m_possible;
    if (gm != LINEAR_GAP) use_m2 = use_m2 && curM;
    bool any_hit = use_m1 || use_e || use_f || use_m2;
    bool use_m = use_m1 || use_m2;
    int new_i = I;
    if (use_m) new_i = pre_at(s_pre, P2, R, I, min(mp, P - 1));
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
        st[nst] = (int)((unsigned)op_code | ((unsigned)I << 2)
                        | ((unsigned)J << 14));
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
  misc[M_NSTEPS] = nst;
  misc[M_FAIL] = fail;
  misc[M_ENDI] = NID ? s_i2nn[I] >> 16 : I;
  misc[M_ENDJ] = J;
  misc[M_LASTI] = PI;
}

// the same number as ops/band_dp.py band_smem_bytes
size_t band_smem_bytes(bool nid, int R, int P, int WB) {
  return sizeof(int) * ((size_t)(3 + (nid ? 1 : 0) + P / 2) * R + 5 * WB + 36);
}

template <bool NID>
int launch(const BandArgs& a, int B, void* stream) {
  size_t smem = band_smem_bytes(NID, a.R, a.P, a.WB);
  cudaError_t err = cudaFuncSetAttribute(
      band_dp_kernel<NID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  band_dp_kernel<NID><<<B, a.WB, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace abpoa

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
  if (WB % 32 || WB > 1024 || WB % pn || P % 2 || P > 15)
    return (int)cudaErrorInvalidValue;
  BandArgs a{scal, ctrl, inp, i2nn, nullptr, qpf, misc, s16w, nullptr,
             nullptr, nullptr, H, E1, E2, BT,
             R, WB, Wq, P, pn, gap_mode, LS, 5, 0, 0};
  return launch<true>(a, B, stream);
}

// topo mode: global or extend, fresh (mplr0 == null) or not
extern "C" int band_dp_topo_launch(const int* scal, const int* ctrl,
                                   const int* pre, const int* mplr0,
                                   const int* qpf, int* bsn_out,
                                   int* mplr_out, int* misc, int* steps,
                                   int* H, int* E1, int* E2, int* BT, int B,
                                   int R, int WB, int Wq, int P, int pn,
                                   int gap_mode, int LS, int m,
                                   int align_mode, int zdrop_on,
                                   void* stream) {
  using namespace abpoa;
  if (B <= 0) return 0;
  if (WB % 32 || WB > 1024 || WB % pn || P % 2 || P > 16 || m > 31
      || (align_mode != 0 && align_mode != 2))
    return (int)cudaErrorInvalidValue;
  BandArgs a{scal, ctrl, pre, nullptr, mplr0, qpf, misc, nullptr, steps,
             bsn_out, mplr_out, H, E1, E2, BT,
             R, WB, Wq, P, pn, gap_mode, LS, m, align_mode == 2, zdrop_on};
  return launch<false>(a, B, stream);
}
