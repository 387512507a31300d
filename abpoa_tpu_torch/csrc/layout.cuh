// Layout constants shared by the CUDA kernels. Same numbers as
// abpoa_tpu_torch/ops/layout.py (scal/misc slots, backtrack op bits) and
// abpoa_tpu/params.py (gap modes, node ids); tests pin the Python copies
// to the JAX package's. Below them, the register helpers of the DP
// kernels (runs of adjacent ints, a warp's largest 64-bit key).
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

// ---- register helpers of the DP kernels ----

typedef unsigned long long u64;

// N adjacent ints at an address aligned to N ints, as one access
template <int N> struct Run;
template <> struct Run<1> { typedef int T; };
template <> struct Run<2> { typedef int2 T; };
template <> struct Run<4> { typedef int4 T; };

template <int N>
__device__ __forceinline__ void ld_run(const int* p, int* v) {
  const typename Run<N>::T x = *reinterpret_cast<const typename Run<N>::T*>(p);
  memcpy(v, &x, sizeof(x));
}

template <int N>
__device__ __forceinline__ void st_run(int* p, const int* v) {
  typename Run<N>::T x;
  memcpy(&x, v, sizeof(x));
  *reinterpret_cast<typename Run<N>::T*>(p) = x;
}

// the largest 64-bit key across a warp: the largest high word, then the
// largest low word among the lanes that hold it (two warp reductions)
__device__ __forceinline__ u64 warp_max64(u64 k) {
  const unsigned hi = (unsigned)(k >> 32), lo = (unsigned)k;
  const unsigned mhi = __reduce_max_sync(~0u, hi);
  const unsigned mlo = __reduce_max_sync(~0u, hi == mhi ? lo : 0u);
  return ((u64)mhi << 32) | mlo;
}

// ---- phase probes of the DP kernels ----
// Compiled to nothing unless DP_PROFILE is defined (dp_profile.py builds
// the kernels so): block 0's thread 0 adds the SM cycles since the last
// probe to phase k's total; DP_PROBE_SAVE keeps the totals, the rows and
// the walk steps in g_prof, which dp_profile_read (DP_PROBE_EXPORT, at
// file scope) copies to the host.
#ifdef DP_PROFILE
__device__ long long g_prof[16];
#define DP_PROBE_INIT                    \
  long long pacc_[8] = {0};              \
  long long plast_ = clock64();
#define DP_PROBE(k)                                      \
  if (blockIdx.x == 0 && threadIdx.x == 0) {             \
    const long long now_ = clock64();                    \
    pacc_[k] += now_ - plast_;                           \
    plast_ = now_;                                       \
  }
#define DP_PROBE_MARK plast_ = clock64();
#define DP_PROBE_SAVE(rows, steps)                                   \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                         \
    for (int k_ = 0; k_ < 8; ++k_) abpoa::g_prof[k_] = pacc_[k_];    \
    abpoa::g_prof[8] = (rows);                                       \
    abpoa::g_prof[9] = (steps);                                      \
  }
#define DP_PROBE_EXPORT                                              \
  extern "C" int dp_profile_read(long long* out) {                   \
    return (int)cudaMemcpyFromSymbol(out, abpoa::g_prof,             \
                                     sizeof(long long) * 16);        \
  }
#else
#define DP_PROBE_INIT
#define DP_PROBE(k)
#define DP_PROBE_MARK
#define DP_PROBE_SAVE(rows, steps)
#define DP_PROBE_EXPORT
#endif

}  // namespace abpoa
