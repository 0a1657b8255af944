/* The Mueller & Muller loop of dmr_4fsk48k.py::clock_recovery, compiled:
 * the same operations in the same order, in double (the reference) or in
 * float (the control), so that it gives the Python loop's levels bit for
 * bit.  Build it without contraction or fast-math (-ffp-contract=off):
 * a fused multiply-add would round differently from the Python loop.
 *
 * mm_f64 / mm_f32(x, n, base, state, bank, g_mu, g_om, lo, hi, out, cap)
 *   x      the loop's input samples, x[0..n);
 *   base   in: the first sample of the next interpolator window;
 *          out: where the loop stopped;
 *   state  [mu, omega, last], read and written back;
 *   bank   the 129 x 8 interpolator bank, row-major;
 *   out    the levels of the symbols completed, at most cap of them.
 * Returns the number of levels written, or -1 where a step would go
 * backwards.  It stops without committing the symbol whose step would leave
 * its window past x[n): at a stream's end that is the Python loop's break,
 * and a caller that appends more samples and calls again continues the
 * stream exactly.  It also stops once cap levels are written. */

#include <math.h>

#define MM_LOOP(NAME, T, ROUND)                                              \
long NAME(const T *x, long n, long *base_io, T *state, const T *bank,        \
          T g_mu, T g_om, T lo, T hi, T *out, long cap)                      \
{                                                                            \
    long base = *base_io, count = 0;                                         \
    T mu = state[0], omega = state[1], last = state[2];                      \
    while (base + 8 <= n && count < cap) {                                   \
        const T *w = bank + 8 * (long)ROUND(mu * (T)128);                    \
        T samp = 0;                                                          \
        for (int k = 0; k < 8; k++)                                          \
            samp = samp + x[base + k] * w[k];                                \
        T err = (last > 0 ? (T)1 : (T)-1) * samp                             \
                - (samp > 0 ? (T)1 : (T)-1) * last;                          \
        T om = omega + g_om * err;                                           \
        if (lo > om) om = lo;              /* Python's max(om, lo) */        \
        if (hi < om) om = hi;              /* then min(., hi) */             \
        T step = (mu + om) + g_mu * err;                                     \
        double fl = floor((double)step);                                     \
        if (fl < 0) return -1;                                               \
        if (base + (long)fl + 8 > n) break;                                  \
        base += (long)fl;                                                    \
        mu = step - (T)fl;                                                   \
        omega = om;                                                          \
        last = samp;                                                         \
        out[count++] = samp;                                                 \
    }                                                                        \
    *base_io = base;                                                         \
    state[0] = mu;                                                           \
    state[1] = omega;                                                        \
    state[2] = last;                                                         \
    return count;                                                            \
}

MM_LOOP(mm_f64, double, nearbyint)
MM_LOOP(mm_f32, float, nearbyintf)
