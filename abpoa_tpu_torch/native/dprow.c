/* Oracle DP row kernels: C implementation of engine_np.py's per-row
 * hot path (band snap, predecessor merges, masked F scan, row max).
 *
 * The numpy oracle spends its time in numpy-call overhead on tiny
 * pn-lane segments; these kernels run the same semantics (bit-exact,
 * including int16/int32 wraparound — compiled with -fwrapv) as plain
 * scalar loops. engine_np dispatches here when the native library
 * loads (ABPOA_NO_NATIVE=1 forces the numpy path).
 *
 * prm (int64[16 + 2*log_n]):
 *   0 pn     1 log_n  2 dp_sn   3 qlen   4 width  5 row_stride(elems)
 *   6 local  7 wb<0   8 gap_mode(0 lg, 1 ag, 2 cg)
 *   9 inf_min  10 oe1  11 oe2  12 e1  13 e2  14 o1  15 o2
 *   16..16+log_n-1 e1S, then e2S  (dtype-wrapped gap-ext doubling)
 *
 * Plane pointers are the BASE of the [n_rows, width] dtype view; rows
 * sit row_stride elements apart (the arena interleaves planes).
 * Reference row semantics: abPOA src/simd_abpoa_align.c
 * :701-1010 (rows), :664-699 (SIMD_SET_F), :1043-1057 (row max).
 */
#include <stdint.h>

#define DPROW_MAXPN 64

#define T int16_t
#define FN(name) dprow_##name##_16
#include "dprow_impl.inc"
#undef T
#undef FN

#define T int32_t
#define FN(name) dprow_##name##_32
#include "dprow_impl.inc"
#undef T
#undef FN

/* Whole-alignment row sweep (see FN(run) in dprow_impl.inc).
 * Returns 1 when extend-mode z-drop broke the sweep, else 0. */
long long np_dp_run(const long long *prm, void *H, void *E1, void *E2,
                    void *F1, void *F2, const void *qp,
                    long long *dp_beg, long long *dp_end,
                    long long *dp_beg_sn, long long *dp_end_sn,
                    const int *pre_flat, const long long *pre_off,
                    const unsigned char *index_map, const long long *i2n,
                    const int *bases, const long long *max_remain,
                    long long *max_pos_l, long long *max_pos_r,
                    const int *out_flat, const int *out_off,
                    const long long *ctl, long long *best, int bits) {
    if (bits == 16)
        return dprow_run_16(prm, (char *)H, (char *)E1, (char *)E2,
                            (char *)F1, (char *)F2, (const char *)qp,
                            dp_beg, dp_end, dp_beg_sn, dp_end_sn,
                            pre_flat, pre_off, index_map, i2n, bases,
                            max_remain, max_pos_l, max_pos_r, out_flat,
                            out_off, ctl, best);
    return dprow_run_32(prm, (char *)H, (char *)E1, (char *)E2,
                        (char *)F1, (char *)F2, (const char *)qp,
                        dp_beg, dp_end, dp_beg_sn, dp_end_sn,
                        pre_flat, pre_off, index_map, i2n, bases,
                        max_remain, max_pos_l, max_pos_r, out_flat,
                        out_off, ctl, best);
}



