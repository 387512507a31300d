// Layout constants shared by the CUDA kernels. Same numbers as
// abpoa_tpu_torch/ops/layout.py (scal/misc slots, backtrack op bits) and
// abpoa_tpu/params.py (gap modes, node ids); tests pin the Python copies
// to the JAX package's.
#pragma once

namespace abpoa {

constexpr int S_QLEN = 0, S_NROWS = 1, S_W = 2, S_INF = 3, S_REMEND = 4,
              S_E1 = 5, S_O1 = 6, S_OE1 = 7, S_E2 = 8, S_O2 = 9,
              S_OE2 = 10, S_ZDROP = 11, S_DPSN = 12, S_NSCAL = 13;

constexpr int M_BEST = 0, M_BI = 1, M_BJ = 2, M_CELLS = 3, M_OVFL = 4,
              M_NSTEPS = 5, M_FAIL = 6, M_ENDI = 7, M_ENDJ = 8,
              M_LASTI = 9, M_NMISC = 10;

constexpr int BT_M = 0x1, BT_E1 = 0x2, BT_E2 = 0x4, BT_F1 = 0x8,
              BT_F2 = 0x10, BT_E = 0x6, BT_F = 0x18, BT_ALL = 0x1F;

constexpr int LINEAR_GAP = 0, AFFINE_GAP = 1, CONVEX_GAP = 2;
constexpr int SRC_NODE_ID = 0, SINK_NODE_ID = 1;

constexpr int NEG = -(1 << 29);
constexpr int H16 = 0xFFFF;
constexpr int RM_OK = 1 << 30;
constexpr int INVALID_BITS =
    15 | (15 << 4) | (15 << 8) | (15 << 14) | (15 << 18);

// int32 arithmetic with two's-complement wraparound, as the JAX package
// computes it (signed overflow is undefined in C++)
__device__ __forceinline__ int mulw(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int shlw(int a, int s) {
  return (int)((unsigned)a << s);
}
// floor division / modulo for a positive divisor
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  return a - floordiv(a, b) * b;
}

}  // namespace abpoa
