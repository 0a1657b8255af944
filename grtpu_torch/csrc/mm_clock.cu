// mm_fwd: the exact Mueller & Muller clock recovery over one stream of
// float32 or complex64 samples, on Hopper, one launch a call.
//
// Replaces no Pallas kernel: grtpu runs this recurrence as a lax.scan
// (grtpu/digital/loops.py, _mm_exact under clock_recovery_mm_ff/cc), and
// the port ran it as a Python loop of ~61 small device operations a symbol
// (grtpu_torch/digital/loops.py, _mm_exact), replayed from a CUDA graph
// under device_loop: 26,000 operations for a DMR chunk of 432 symbols.
//
// What it computes, slot by slot for i < max_out (mu, omega, base and last
// the carried state, x[0..n_in) the samples with their lookahead):
//   s      = clamp(floor(base), 0, n_in - 8)        (int64, as torch clamps)
//   samp   = sum_k x[s + k] * bank[rint(128 mu)][k]  (scan_dot's order)
//   err    = slc(last) * samp - slc(samp) * last     (real; the complex
//            error Re(conj(slc(last)) samp - conj(slc(samp)) last), then
//            clipped to [-1, 1]: digital_clock_recovery_mm_cc)
//   omega2 = clamp(omega + g_omega err, lo, hi)
//   step   = (mu + omega2) + g_mu err,  fl = floor(step),  nb = base + fl
//   valid  = nb + 8 <= n_in; if valid: mu = step - fl, omega = omega2,
//            base = nb, last = samp
//   ys[i]  = samp;  n_valid = the valid slots.
// Every operation is the float32 operation that PyTorch performs for the
// plain loop's tensors and Python scalars, in the same order and with
// nothing contracted, so the outputs and the state are the plain loop's
// bit for bit.  The 8-term dot is summed as mmse_interp.scan_dot sums it:
// each product exact in float64 and the running sum rounded to float64,
// then to float32, once a term (the real part of a complex window rounds
// its products first and sums in float32).  An invalid slot leaves the
// state as it was, so every later slot makes the same sample: the walk
// stops at the first invalid slot and the remaining slots take its sample.
//
// Bound on this card: the recurrence.  Each symbol's window and phase come
// from the state that the previous symbol's dot decides, so a stream is one
// dependent chain of ~n_in / omega steps; its work (a few dozen flops a
// symbol) and bytes (each sample read once, each symbol written once) are
// nothing beside one step's latency.  So one thread walks the stream with
// mu, omega, base and last in registers, and nothing on the chain waits on
// device memory: the block first stages the 129 x 8 bank and the samples in
// shared memory (every thread, eight loads in flight each), then thread 0
// walks while the others wait at a barrier.
//
// The dot's float64 roundings would set the step's latency: each term is a
// conversion to double, the add and a conversion back, on the card's slow
// conversion path (a first version of this kernel took 366 ns a symbol,
// ~725 cycles, most of it there).  So the walker speculates, and the block
// checks.  The walker sums with float32 fused multiply-adds, which round
// the exact a + x t once: that equals rounding the float64 sum unless the
// float64 sum lands exactly on a float32 midpoint that the exact value
// misses, rare but possible.  Its step is shortened the same way: omega's
// product and sum fused, no NaN handling in the clamps, the error's sign
// terms from sign bits, and the window's offset in the tile carried as a
// float (floor(base + fl) = floor(base) + fl) and clamped by one unsigned
// min, the bank row by one fused multiply-add; one branch a symbol tests
// every way the walk can stop, and the next symbol's row and window are
// read before it is taken.  It records each symbol's state and sample in
// shared memory.  Every kSeg symbols, and where the walk stops, the whole
// block makes each recorded symbol again in parallel with the plain loop's
// operations, from its recorded state, and compares the sample and the
// state after it bit for bit; at the first symbol that differs the walker
// goes back to its recorded state, makes it exactly, and goes on.  So the
// outputs are the exact loop's whatever the speculation gets wrong (a
// window pointer below 0 or between samples, a float64 midpoint, a NaN).
// The window's first sample and the row are made in float32 with exact
// conversions (magic constants) where the stream is shorter than 2^22
// samples, and in int64 past that.  The step's chain is then ~200 cycles:
// the shared-memory reads of the row and window (33 cycles), the dot's
// eight fused multiply-adds, the update's dozen float32 operations and
// floorf (19).
//
// Where the samples outgrow shared memory they are staged a tile at a time:
// when a window leaves the tile, the walk stops, the block checks what it
// walked and stages the tile that starts kBack samples before the window,
// and the walk goes on from the state in thread 0's registers.  A tile of
// the largest size holds ~5,300 symbols of a 10-sample symbol stream.
//
// Arithmetic for the tests: grtpu_torch/digital/loops.py::_mm_exact is the
// plain form; tests/test_torch_mm_model.py repeats this walk (tiles,
// restages, the speculation and its checks included) in NumPy scalars and
// holds it to that form bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 8;
constexpr int kPhases = 129;                   // NSTEPS + 1 rows of the bank
constexpr int kBankFloats = kPhases * kTaps;   // 1,032 floats, 4,128 bytes
constexpr int kSeg = 512;          // symbols walked between two checks
constexpr int kHist = 8;           // floats kept a symbol for its check
constexpr int kHistFloats = (kSeg + 1) * kHist;
constexpr int kThreads = 512;
constexpr int kLoads = 8;                      // loads in flight a thread
constexpr int kBack = 64;          // samples a restaged tile keeps behind
constexpr int kMinTile = 256;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemOptin = 232448;
constexpr int kStaticReserve = 256;            // the kernel's __shared__ ints
constexpr long long kSmallN = 1LL << 22;  // positions exact in float below
constexpr float kMagic = 12582912.0f;      // 1.5 * 2^23: v + kMagic = rint(v)
constexpr int kMagicBits = 0x4B400000;     //   in the low bits, |v| < 2^22

enum { kRestage = 0, kDone = 1, kFrozen = 2, kCheck = 3 };  // why a walk stops
enum { kTiny = 0, kSmall = 1, kBig = 2 };  // n_in < 8, < 2^22, larger

__device__ __forceinline__ float slc(float v) { return v > 0.0f ? 1.0f : -1.0f; }

// torch.clamp with scalar bounds: NaN passes, else min(max(v, lo), hi)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// sum_k w[k * S] t[k]: each product exact in double, one rounding of the
// running sum to float32 a term (mmse_interp._fused_dot)
template <int S>
__device__ __forceinline__ float fused_dot(const float* w, const float* t) {
  float acc = __double2float_rn(__dmul_rn(static_cast<double>(w[0]),
                                          static_cast<double>(t[0])));
#pragma unroll
  for (int k = 1; k < kTaps; ++k)
    acc = __double2float_rn(__dadd_rn(
        static_cast<double>(acc),
        __dmul_rn(static_cast<double>(w[k * S]), static_cast<double>(t[k]))));
  return acc;
}

// the same sum with fused multiply-adds: one rounding of the exact sum a
// term, which differs from fused_dot only where its double sum lands on a
// float32 midpoint that the exact sum misses
template <int S>
__device__ __forceinline__ float fma_dot(const float* w, const float* t) {
  float acc = __fmul_rn(w[0], t[0]);
#pragma unroll
  for (int k = 1; k < kTaps; ++k) acc = __fmaf_rn(w[k * S], t[k], acc);
  return acc;
}

// sum_k w[k * S] t[k] with each product rounded first
// (mmse_interp._ordered_dot, the real part of a complex window)
template <int S>
__device__ __forceinline__ float ordered_dot(const float* w, const float* t) {
  float acc = __fmul_rn(w[0], t[0]);
#pragma unroll
  for (int k = 1; k < kTaps; ++k) acc = __fadd_rn(acc, __fmul_rn(w[k * S], t[k]));
  return acc;
}

// the interpolated sample (sr, si): exact (the plain loop's sums) or
// speculated (fused multiply-adds where the plain loop sums in float64)
template <int C, bool kExact>
__device__ __forceinline__ void interpolate(const float* w, const float* t,
                                            float& sr, float& si) {
  if (C == 1) {
    sr = kExact ? fused_dot<1>(w, t) : fma_dot<1>(w, t);
    si = 0.0f;
  } else {
    sr = ordered_dot<2>(w, t);
    si = kExact ? fused_dot<2>(w + 1, t) : fma_dot<2>(w + 1, t);
  }
}

struct State {
  float mu, omega, base, lr, li;
};

struct Params {
  long long n_in, t0, t1;
  int max_out;
  float nf, nf8, g_om, g_mu, lo, hi;
  float t0f, t1f8, jmaxf;  // the tile's bounds in float (below 2^22 samples)
  unsigned jmax;           // the last window offset in the tile
};

// A symbol's inputs, read as soon as its mu and base are known: the bank
// row, the window and where it starts (s), and whether it leaves the tile.
template <int C>
struct Ahead {
  float t[kTaps];
  float w[kTaps * C];
  long long s;
  bool out;
};

__device__ __forceinline__ int rint_small(float v) {  // |v| < 2^22
  return __float_as_int(__fadd_rn(v, kMagic)) - kMagicBits;
}

// rint(128 mu) as a bank row: 128 mu is exact, so one fused multiply-add
// with the magic constant rounds as the plain loop's two operations do
__device__ __forceinline__ unsigned row_of(float mu) {
  return min(static_cast<unsigned>(
                 __float_as_int(__fmaf_rn(mu, 128.0f, kMagic)) - kMagicBits),
             static_cast<unsigned>(kPhases - 1));
}

// clamp(floor(base), 0, n_in - 8) in int64, as torch computes it
__device__ __forceinline__ long long start_of(float base, long long n_in) {
  long long s = static_cast<long long>(floorf(base));
  s = s < 0 ? 0 : s;
  return s > n_in - kTaps ? n_in - kTaps : s;
}

// The row is rint(128 mu) (exact while |128 mu| < 2^22; beyond, or NaN,
// the plain loop's index leaves the bank, and the row is clamped here).
// The window starts at s = clamp(floor(base), 0, n_in - 8), as torch
// clamps the int64: in float below 2^22 samples (exact there, whatever base
// is), its offset in the tile clamped into the tile, so that the window
// is read before it is known to lie there; in int64 past that.  Below 8
// samples its indices wrap as torch's negative gather indices do.
template <int C, int kMode>
__device__ __forceinline__ void prepare(Ahead<C>& a, float mu, float base,
                                        const Params& q,
                                        const float* __restrict__ xs,
                                        const float* __restrict__ bank) {
  const unsigned p = row_of(mu);
  const float4 ta = *reinterpret_cast<const float4*>(bank + p * kTaps);
  const float4 tb = *reinterpret_cast<const float4*>(bank + p * kTaps + 4);
  a.t[0] = ta.x; a.t[1] = ta.y; a.t[2] = ta.z; a.t[3] = ta.w;
  a.t[4] = tb.x; a.t[5] = tb.y; a.t[6] = tb.z; a.t[7] = tb.w;
  int j = 0;
  if (kMode == kBig) {
    a.s = start_of(base, q.n_in);
    a.out = a.s < q.t0 || a.s + kTaps > q.t1;
    j = a.out ? 0 : static_cast<int>(a.s - q.t0);
  } else {
    const float fb = floorf(base);
    const float sf = fminf(fmaxf(fb, 0.0f), q.nf8);
    a.s = rint_small(sf);
    a.out = kMode != kTiny && (sf < q.t0f || sf > q.t1f8);
    if (kMode == kSmall)
      j = rint_small(fminf(fmaxf(__fsub_rn(fb, q.t0f), 0.0f), q.jmaxf));
  }
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    int g = j + k;
    if (kMode == kTiny) {    // the whole stream is staged: t0 is 0
      g = static_cast<int>(a.s) + k;
      if (g < 0) g += static_cast<int>(q.n_in);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) a.w[k * C + c] = xs[g * C + c];
  }
}

// The walker's prepare below 2^22 samples: the bank row from mu and the
// window from jraw = floor(base) - t0, the window's offset in the tile as
// the walker carries it (floor(base + fl) = floor(base) + fl for the whole
// fl of a step), clamped into the tile by one unsigned min.  Where base < 0
// the plain loop's window starts at 0 and this one does not: the check
// finds that symbol.  Whether the window leaves the tile is worked out as
// prepare does, off the chain.
template <int C>
__device__ __forceinline__ void prepare_small(Ahead<C>& a, float mu,
                                              float jraw, const Params& q,
                                              const float* __restrict__ xs,
                                              const float* __restrict__ bank) {
  const unsigned p = row_of(mu);
  const float4 ta = *reinterpret_cast<const float4*>(bank + p * kTaps);
  const float4 tb = *reinterpret_cast<const float4*>(bank + p * kTaps + 4);
  a.t[0] = ta.x; a.t[1] = ta.y; a.t[2] = ta.z; a.t[3] = ta.w;
  a.t[4] = tb.x; a.t[5] = tb.y; a.t[6] = tb.z; a.t[7] = tb.w;
  const unsigned j = min(static_cast<unsigned>(rint_small(jraw)), q.jmax);
  const float sf = fminf(fmaxf(__fadd_rn(jraw, q.t0f), 0.0f), q.nf8);
  a.out = sf < q.t0f || sf > q.t1f8;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
#pragma unroll
    for (int c = 0; c < C; ++c) a.w[k * C + c] = xs[(j + k) * C + c];
  }
}

// One symbol's update from r and its sample (sr, si): err, omega's clamp,
// the step and its floor, then the next state in n; returns whether the
// slot is valid; fl: the step's floor.  kExact: the plain loop's
// operations (its clamps pass NaN); else the walker's speculation (no NaN
// handling, omega's product and sum in one fused multiply-add, the error's
// sign terms by the sign bits), which the check holds to the exact form.
template <int C, bool kExact>
__device__ __forceinline__ bool update(const State& r, float sr, float si,
                                      const Params& q, State& n, float& fl) {
  float err;
  if (C == 1) {
    const float b = kExact ? (sr > 0.0f ? r.lr : -r.lr)
                           : __int_as_float(__float_as_int(r.lr)
                                            ^ (__float_as_int(sr) & 0x80000000));
    err = __fsub_rn(__fmul_rn(slc(r.lr), sr), b);
  } else {
    const float a1 = __fadd_rn(__fmul_rn(slc(r.lr), sr), __fmul_rn(slc(r.li), si));
    const float b1 = __fadd_rn(sr > 0.0f ? r.lr : -r.lr, si > 0.0f ? r.li : -r.li);
    err = __fsub_rn(a1, b1);
    err = kExact ? clampf(err, -1.0f, 1.0f) : fminf(fmaxf(err, -1.0f), 1.0f);
  }
  const float v = kExact ? __fadd_rn(r.omega, __fmul_rn(q.g_om, err))
                         : __fmaf_rn(q.g_om, err, r.omega);
  const float om2 = kExact ? clampf(v, q.lo, q.hi) : fminf(fmaxf(v, q.lo), q.hi);
  const float stp = __fadd_rn(__fadd_rn(r.mu, om2), __fmul_rn(q.g_mu, err));
  fl = floorf(stp);
  n.base = __fadd_rn(r.base, fl);
  n.mu = __fsub_rn(stp, fl);
  n.omega = om2;
  n.lr = sr;
  n.li = si;
  return __fadd_rn(n.base, 8.0f) <= q.nf;
}

__device__ __forceinline__ void record(float* __restrict__ h, const State& r,
                                       float sr, float si) {
  reinterpret_cast<float4*>(h)[0] = make_float4(r.mu, r.omega, r.base, r.lr);
  reinterpret_cast<float4*>(h)[1] = make_float4(r.li, sr, si, 0.0f);
}

__device__ __forceinline__ State recorded(const float* __restrict__ h) {
  const float4 a = reinterpret_cast<const float4*>(h)[0];
  const float4 b = reinterpret_cast<const float4*>(h)[1];
  return State{a.x, a.y, a.z, a.w, b.x};
}

// Walks from *st at slot *slot (its first symbol exact where exact_first),
// at most kSeg symbols, recording each in hist (its state and sample) and
// the state it ends in after them; *count: the symbols recorded.  Returns
// kCheck after kSeg symbols, kRestage where a window leaves the tile (that
// symbol not recorded), kDone after max_out slots, kFrozen at the first
// invalid slot (recorded, not counted in *slot).
template <int C, int kMode>
__device__ __forceinline__ int walk(State* st, int* slot,
                                    const float* __restrict__ xs,
                                    const float* __restrict__ bank,
                                    float* __restrict__ hist, const Params& q,
                                    float* __restrict__ ys, bool exact_first,
                                    int* count) {
  State r = *st;   // in registers
  int i = *slot, j = 0, why;
  Ahead<C> a;
  if (exact_first) {
    prepare<C, kMode>(a, r.mu, r.base, q, xs, bank);
    if (a.out) {
      why = kRestage;
    } else {
      float sr, si;
      interpolate<C, true>(a.w, a.t, sr, si);
      record(hist, r, sr, si);
      ys[i * C] = sr;
      if (C == 2) ys[i * C + 1] = si;
      State n;
      float fl;
      j = 1;
      if (!update<C, true>(r, sr, si, q, n, fl)) {
        why = kFrozen;
      } else {
        r = n;
        ++i;
        why = i == q.max_out ? kDone : kCheck;
      }
    }
  }
  if (!exact_first || (why == kCheck && j < kSeg)) {
    float jraw = __fsub_rn(floorf(r.base), q.t0f);   // kSmall's offset
    if (kMode == kSmall)
      prepare_small<C>(a, r.mu, jraw, q, xs, bank);
    else
      prepare<C, kMode>(a, r.mu, r.base, q, xs, bank);
    why = a.out ? kRestage : kCheck;
    // one branch a symbol: every way the walk can stop is tested at once
    bool go = !a.out;
    while (go) {
      float sr, si;
      interpolate<C, false>(a.w, a.t, sr, si);
      record(hist + j * kHist, r, sr, si);
      ys[i * C] = sr;
      if (C == 2) ys[i * C + 1] = si;
      State n;
      float fl;
      const bool valid = update<C, false>(r, sr, si, q, n, fl);
      if (kMode == kSmall) {
        jraw = __fadd_rn(jraw, fl);
        prepare_small<C>(a, n.mu, jraw, q, xs, bank);
      } else {
        prepare<C, kMode>(a, n.mu, n.base, q, xs, bank);
      }
      ++j;
      if (valid) {
        r = n;
        ++i;
      }
      go = valid && i < q.max_out && j < kSeg && !a.out;
      why = !valid ? kFrozen : i == q.max_out ? kDone
            : j == kSeg ? kCheck : kRestage;
    }
  }
  record(hist + j * kHist, r, 0.0f, 0.0f);  // where the walk ends
  *st = r;
  *slot = i;
  *count = j;
  return why;
}

// The check of recorded symbol j (of count, the walk having stopped for
// why): the exact sample from its recorded state, in the tile, equal to
// the one recorded, and the exact update from it valid and equal to the
// next recorded state, or, for the last symbol, not valid where the walk
// froze there and equal to the state the walk ended in otherwise.
template <int C, int kMode>
__device__ __forceinline__ bool check_one(const float* __restrict__ xs,
                                          const float* __restrict__ bank,
                                          const float* __restrict__ hist,
                                          int j, int count, int why,
                                          const Params& q) {
  const float* h = hist + j * kHist;
  const State r = recorded(h);
  Ahead<C> a;
  prepare<C, kMode>(a, r.mu, r.base, q, xs, bank);
  if (a.out) return false;
  float sr, si;
  interpolate<C, true>(a.w, a.t, sr, si);
  if (__float_as_uint(sr) != __float_as_uint(h[5])
      || (C == 2 && __float_as_uint(si) != __float_as_uint(h[6])))
    return false;
  State n;
  float fl;
  const bool valid = update<C, true>(r, sr, si, q, n, fl);
  if (j == count - 1 && why == kFrozen) return !valid;
  const State e = recorded(h + kHist);
  return valid && __float_as_uint(n.mu) == __float_as_uint(e.mu)
         && __float_as_uint(n.omega) == __float_as_uint(e.omega)
         && __float_as_uint(n.base) == __float_as_uint(e.base)
         && __float_as_uint(n.lr) == __float_as_uint(e.lr)
         && __float_as_uint(n.li) == __float_as_uint(e.li);
}

template <int C, int kMode>
__device__ void run(const float* __restrict__ x, float* __restrict__ smem,
                    Params q, int tile, State& st, int& slot,
                    float* __restrict__ ys) {
  __shared__ long long s_t0, s_next;
  __shared__ int s_why, s_count, s_bad, s_stage, s_slot, s_seg0;
  float* bank = smem;
  float* hist = smem + kBankFloats;
  float* xs = hist + kHistFloats;
  const int tid = threadIdx.x;
  const long long max_t0 = q.n_in > tile ? q.n_in - tile : 0;
  bool exact_first = false;  // thread 0's
  if (tid == 0) {
    const long long s = start_of(st.base, q.n_in) - kBack;
    s_t0 = s < 0 ? 0 : (s > max_t0 ? max_t0 : s);
    s_stage = 1;
  }
  for (;;) {
    __syncthreads();  // s_t0 and s_stage set; the last check's reads done
    q.t0 = s_t0;
    q.t1 = q.t0 + (q.n_in - q.t0 < tile ? q.n_in - q.t0 : tile);
    q.t0f = static_cast<float>(q.t0);
    q.t1f8 = static_cast<float>(q.t1 - kTaps);
    q.jmaxf = static_cast<float>(q.t1 - q.t0 - kTaps);
    q.jmax = static_cast<unsigned>(q.t1 - q.t0 - kTaps);
    if (s_stage) {
      const long long m = (q.t1 - q.t0) * C;
      const float* src = x + q.t0 * C;
      for (long long i0 = tid; i0 < m; i0 += kThreads * kLoads) {
        float v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const long long i = i0 + static_cast<long long>(u) * kThreads;
          v[u] = i < m ? __ldg(src + i) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const long long i = i0 + static_cast<long long>(u) * kThreads;
          if (i < m) xs[i] = v[u];
        }
      }
      __syncthreads();
    }
    if (tid == 0) {
      int count;
      s_seg0 = slot;
      s_why = walk<C, kMode>(&st, &slot, xs, bank, hist, q, ys, exact_first,
                             &count);
      s_count = count;
      s_bad = count;
      if (s_why == kRestage) {
        Ahead<C> a;   // where the window that left the tile starts
        prepare<C, kMode>(a, st.mu, st.base, q, xs, bank);
        s_next = a.s;
      }
    }
    __syncthreads();
    // the check: each recorded symbol made again exactly from its state
    for (int j = tid; j < s_count; j += kThreads)
      if (!check_one<C, kMode>(xs, bank, hist, j, s_count, s_why, q))
        atomicMin(&s_bad, j);
    __syncthreads();
    if (tid == 0) {
      const int bad = s_bad;
      exact_first = bad < s_count;
      s_stage = 0;
      if (exact_first) {  // back to the first symbol speculated wrong
        st = recorded(hist + bad * kHist);
        slot = s_seg0 + bad;
        s_why = kCheck;
      } else if (s_why == kRestage) {
        const long long s = s_next - kBack;
        s_t0 = s < 0 ? 0 : (s > max_t0 ? max_t0 : s);
        s_stage = 1;
      }
      s_slot = slot;
    }
    __syncthreads();
    if (s_why == kDone || s_why == kFrozen) break;
  }
  // the slots after the first invalid one repeat its sample
  if (s_why == kFrozen) {
    const float* h = hist + (s_count - 1) * kHist;
    const long long m = static_cast<long long>(q.max_out) * C;
    for (long long i = (static_cast<long long>(s_slot) + 1) * C + tid; i < m;
         i += kThreads)
      ys[i] = h[5 + i % C];
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    mm_kernel(const float* __restrict__ x, long long n_in,
              const float* __restrict__ mu0, const float* __restrict__ omega0,
              const float* __restrict__ base0, const float* __restrict__ last0,
              const float* __restrict__ bank, float g_om, float g_mu, float lo,
              float hi, long long max_out, int tile, float* __restrict__ ys,
              int* __restrict__ n_valid, float* __restrict__ mu_out,
              float* __restrict__ omega_out, float* __restrict__ base_out,
              float* __restrict__ last_out) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  for (int i = tid; i < kBankFloats; i += kThreads) smem[i] = bank[i];
  State st;  // thread 0's
  st.mu = *mu0;
  st.omega = *omega0;
  st.base = *base0;
  st.lr = last0[0];
  st.li = C == 2 ? last0[1] : 0.0f;
  int slot = 0;
  Params q;
  q.n_in = n_in;
  q.max_out = static_cast<int>(max_out);
  q.nf = static_cast<float>(n_in);
  q.nf8 = static_cast<float>(n_in - kTaps);
  q.g_om = g_om;
  q.g_mu = g_mu;
  q.lo = lo;
  q.hi = hi;
  if (n_in < kTaps)
    run<C, kTiny>(x, smem, q, tile, st, slot, ys);
  else if (n_in < kSmallN)
    run<C, kSmall>(x, smem, q, tile, st, slot, ys);
  else
    run<C, kBig>(x, smem, q, tile, st, slot, ys);
  if (tid == 0) {
    *n_valid = slot;
    *mu_out = st.mu;
    *omega_out = st.omega;
    *base_out = st.base;
    last_out[0] = st.lr;
    if (C == 2) last_out[1] = st.li;
  }
}

template <int C>
int launch(const float* x, long long n_in, const float* mu, const float* omega,
           const float* base, const float* last, const float* bank, float g_om,
           float g_mu, float lo, float hi, long long max_out, int tile,
           float* ys, int* n_valid, float* mu_out, float* omega_out,
           float* base_out, float* last_out, cudaStream_t stream) {
  auto kernel = mm_kernel<C>;
  const int smem = (kBankFloats + kHistFloats + tile * C) * 4;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<1, kThreads, smem, stream>>>(x, n_in, mu, omega, base, last, bank,
                                        g_om, g_mu, lo, hi, max_out, tile, ys,
                                        n_valid, mu_out, omega_out, base_out,
                                        last_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: n_in >= 4 samples (float32, or complex64 as float pairs, cplx 1; below
// 4 the plain loop's window indices leave the stream); mu, omega, base: one
// float each; last: one sample; bank: the 129 x 8 float32 interpolator
// bank; ys: max_out samples; n_valid: one int32; *_out: the state after
// the call, as mu..last.  tile: samples staged at once, n_in or at least
// 256, with (1,032 + 512 * 8 + tile * (1 + cplx)) * 4 bytes within shared
// memory less 256 bytes.  The complex mode clips the error to [-1, 1]
// (digital_clock_recovery_mm_cc).
int mm_fwd(const float* x, long long n_in, const float* mu, const float* omega,
           const float* base, const float* last, const float* bank, float g_om,
           float g_mu, float lo, float hi, long long max_out, int cplx,
           int tile, float* ys, int* n_valid, float* mu_out, float* omega_out,
           float* base_out, float* last_out, cudaStream_t stream) {
  const int C = cplx ? 2 : 1;
  if (x == nullptr || n_in < kTaps / 2 || max_out < 1 || max_out > 0x7fffffffLL
      || (cplx != 0 && cplx != 1) || tile < 1
      || (tile < n_in && tile < kMinTile) || tile > n_in
      || static_cast<long long>(kBankFloats + kHistFloats + tile * C) * 4
             > kSmemOptin - kStaticReserve
      || mu == nullptr || omega == nullptr || base == nullptr
      || last == nullptr || bank == nullptr || ys == nullptr
      || n_valid == nullptr || mu_out == nullptr || omega_out == nullptr
      || base_out == nullptr || last_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cplx)
    return launch<2>(x, n_in, mu, omega, base, last, bank, g_om, g_mu, lo, hi,
                     max_out, tile, ys, n_valid, mu_out, omega_out, base_out,
                     last_out, stream);
  return launch<1>(x, n_in, mu, omega, base, last, bank, g_om, g_mu, lo, hi,
                   max_out, tile, ys, n_valid, mu_out, omega_out, base_out,
                   last_out, stream);
}

const char* mm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
