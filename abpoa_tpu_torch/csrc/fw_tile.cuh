// What the full-width DP (fw_dp.cu, B4) and the banded-tile DP
// (tile_dp.cu, B5) share: the per-row arrays' place, the row-maximum key
// and the backtrack word (one word per cell, written in the sweep, read
// by the walk one step at a time). Both kernels build them from here, so
// their layout is known here alone.
#pragma once

#include "layout.cuh"

namespace abpoa {

// words of the per-row arrays (band bounds, band state, control, out
// count, remain) and of the fixed part of shared memory before them
// (reductions, scan totals, last columns)
constexpr int ROW_WORDS = 7, FIXED_WORDS = 224;
// shared memory a block may use on Hopper
constexpr size_t MAX_SMEM = 232448;

// the shared memory of one block before the predecessor ids: the fixed
// part, then the per-row arrays when they fit (114 KB at R = 4096; past
// about 8,270 rows they live in a global scratch)
inline size_t smem_with_rows(int R) {
  const size_t with_rows =
      sizeof(int) * (FIXED_WORDS + ROW_WORDS * (size_t)R);
  return with_rows <= MAX_SMEM ? with_rows : sizeof(int) * FIXED_WORDS;
}

constexpr int FB = 8;                // bits of a predecessor field
constexpr int NONE = (1 << FB) - 1;  // no slot meets the condition
// the first slot that meets it is SPILL or past it (a row with more
// predecessors than a field holds): the walk finds it from the planes
constexpr int SPILL = NONE - 1;

// The word: 32 bits (linear and affine gaps) or 64 (convex). Fields of
// FB bits: the first predecessor slot that meets M (H[pre][j-1] + s ==
// H), E1 from M (H == E1[pre]), E1 extended (E1 == E1[pre] - e1), E2
// from M, E2 extended (convex); linear gaps: the E1-from-M field holds
// H[pre][j] - e1 == H. Then the open bits of the slots picked (H[pre][j]
// - oe == E[pre]; O1M, O1X, O2M, O2X from bit O); the F bits (H[j-1] - oe
// == F, F[j-1] - e == F, H == F for F1, then F2, from bit F; linear gaps:
// H[j-1] - e1 == H at bit F); H == 0 (local mode's stop, B4) at bit HZ.
template <int GM> struct Bt {
  typedef unsigned W;
  static constexpr int MP = 0, E1M = FB, E1X = 2 * FB, E2M = 3 * FB,
                       E2X = 4 * FB, O = 3 * FB, F = O + 2, HZ = F + 3;
};
template <> struct Bt<CONVEX_GAP> {
  typedef u64 W;
  static constexpr int MP = 0, E1M = FB, E1X = 2 * FB, E2M = 3 * FB,
                       E2X = 4 * FB, O = 5 * FB, F = O + 4, HZ = F + 6;
};

// int32 arithmetic with two's-complement wraparound
__device__ __forceinline__ int addw(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int subw(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// the row maximum and its tie-break as one key: the larger value, then
// the lower (lane-in-segment, aux), aux = 0 for the band's last segment,
// else the segment in the band + 1 (< 2^26 on rows below 2^29 columns):
// the reference's order, the lowest lane, then the last band segment,
// then the earliest
__device__ __forceinline__ u64 best_key(int v, int lane, int aux) {
  unsigned lo = ~(((unsigned)lane << 26) | ((unsigned)aux & 0x3FFFFFFu));
  return ((u64)((unsigned)v ^ 0x80000000u) << 32) | lo;
}

// a cell's predecessor fields while the slots are visited: the first
// slot that meets M, E1 from M, E1 extended, E2 from M, E2 extended
// (NONE: none yet; SPILL for any slot from SPILL on), and the open bits
// of the slots picked (bit k of o for field k + 1)
struct Fields {
  int f[5];
  int o;
};

__device__ __forceinline__ void fields_init(Fields& w) {
  w.f[0] = w.f[1] = w.f[2] = w.f[3] = w.f[4] = NONE;
  w.o = 0;
}

// predecessor slot p's part of one cell's word at column col: the
// predecessor's H at col - 1 (hm1) and at col (h0), its E1/E2 at col,
// its band [plo, phi] in columns; the cell's own H, E1, E2 and s
__device__ __forceinline__ void bt_slot(Fields& w, int p, int col, int plo,
                                        int phi, int hm1, int h0, int be1,
                                        int be2, int s, int hh, int e1c,
                                        int e2c, int gm, int e1, int oe1,
                                        int e2, int oe2) {
  const bool m_in = col - 1 >= plo && col - 1 <= phi;
  if (m_in && addw(hm1, s) == hh && w.f[0] == NONE) w.f[0] = min(p, SPILL);
  if (col < plo || col > phi) return;
  if (gm == LINEAR_GAP) {
    if (subw(h0, e1) == hh && w.f[1] == NONE) w.f[1] = min(p, SPILL);
    return;
  }
  const int o1 = subw(h0, oe1) == be1;
  if (hh == be1 && w.f[1] == NONE) {
    w.f[1] = min(p, SPILL);
    w.o |= o1;
  }
  if (e1c == subw(be1, e1) && w.f[2] == NONE) {
    w.f[2] = min(p, SPILL);
    w.o |= o1 << 1;
  }
  if (gm == CONVEX_GAP) {
    const int o2 = subw(h0, oe2) == be2;
    if (hh == be2 && w.f[3] == NONE) {
      w.f[3] = min(p, SPILL);
      w.o |= o2 << 2;
    }
    if (e2c == subw(be2, e2) && w.f[4] == NONE) {
      w.f[4] = min(p, SPILL);
      w.o |= o2 << 3;
    }
  }
}

// the fields' bits of the word
template <int GM>
__device__ __forceinline__ u64 field_bits(const Fields& w) {
  typedef Bt<GM> BL;
  u64 x = ((u64)w.f[0] << BL::MP) | ((u64)w.f[1] << BL::E1M)
          | ((u64)w.f[2] << BL::E1X) | ((u64)w.o << BL::O);
  if (GM == CONVEX_GAP)
    x |= ((u64)w.f[3] << BL::E2M) | ((u64)w.f[4] << BL::E2X);
  return x;
}

// the F bits of one cell from its own and its left neighbour's values
template <int GM>
__device__ __forceinline__ u64 f_bits(int hh, int f1, int f2, int hprev,
                                      int f1prev, int f2prev, int e1,
                                      int oe1, int e2, int oe2) {
  constexpr int F = Bt<GM>::F;
  if (GM == LINEAR_GAP) return (u64)(subw(hprev, e1) == hh) << F;
  u64 w = ((u64)(subw(hprev, oe1) == f1) << F)
          | ((u64)(subw(f1prev, e1) == f1) << (F + 1))
          | ((u64)(hh == f1) << (F + 2));
  if (GM == CONVEX_GAP)
    w |= ((u64)(subw(hprev, oe2) == f2) << (F + 3))
         | ((u64)(subw(f2prev, e2) == f2) << (F + 4))
         | ((u64)(hh == f2) << (F + 5));
  return w;
}

}  // namespace abpoa
