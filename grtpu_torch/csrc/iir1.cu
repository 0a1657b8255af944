// iir1_fwd: a constant, stable first-order IIR with its feed-forward taps,
// over rows of float32 or complex64 samples, on Hopper, one launch a call.
//
// Replaces no Pallas kernel: grtpu solves this recurrence with XLA ops
// (grtpu/ops/dsp.py, linear_recurrence_const's truncated FIR and
// iir_filter's first-order branch, a Toeplitz product on the MXU).  On the
// card those ops are ~20 launches a call (the history cat, the feed-forward
// and the truncated response as Toeplitz products with their gathers, the
// power series, the state correction), and the call is bound by them, not
// by its work.
//
// What it computes, for each row (leading axes flattened), with xs the H =
// nff - 1 history samples followed by the chunk's n samples, a^k = apow[k]
// and a^(k+1) = apow1[k] for k < K (K = ntaps):
//   v[j] = sum_m ff[m] * xs[j + H - m]                      (0 <= j < n)
//   y[i] = sum_{k <= min(i, K-1)} a^k v[i-k] + [i < K] a^(i+1) y0
// with v zero before the chunk: the truncated impulse response of
// y[i] = a y[i-1] + v[i], exact to the tolerance that chose K.  With ff
// null, v = x (nff 1).  A complex64 row is read as interleaved float
// pairs: the real pole acts on both planes alike.  The last H samples of xs
// are written to hist_out, the next call's history.
//
// Bound on this card: each sample is read and written once, 8 bytes a real
// sample, and the work is (nff + K) multiply-adds a sample: at the WBFM
// chunk (65,536 samples, nff 2, K 49) 0.52 MB, 0.16 us, and 6.7 MFLOP,
// 0.1 us, so one launch runs at the launch floor; at a bank of 64 x 2^18
// 134 MB, 40 us, against 29 us of FMAs: bytes.
//
// Design: a parallel stencil.  A block takes a tile of T outputs of one
// row (T = threads * 8 / planes) and stages its input with the halo
// (K - 1 + H samples before it, K padded up to a multiple of 8 with zero
// taps) in shared memory, 16-byte loads where the row is aligned; the
// history and the zeros before it come in through the same loop.  It then
// forms v over the tile and the halo into shared memory, and each thread
// runs the K-tap sum for 8 consecutive outputs of one plane from a register
// window: per 8 taps it loads 8 new v values and makes 64 multiply-adds.
// v is stored skewed (one pad float every 8 outputs' worth), so that the 32
// threads of a warp, 8 outputs apart, read 32 distinct banks.  The outputs
// go back through shared memory and leave in 16-byte stores.  The taps a^k
// sit in shared memory and are read as broadcasts.  The wrapper shrinks
// the tile until the grid fills the card twice (256 blocks of 256 outputs
// at the WBFM chunk).  The staged window must fit in shared memory: a
// feed-forward filter of tens of thousands of taps does not, and the entry
// refuses it (the wrapper says so first, by the same layout).
//
// Summation order: v sums m = 0 up, y sums k = 0 up, each a fused
// multiply-add, then adds a^(i+1) y0 (a rounded product); not the Toeplitz
// products' order, so the plain form (grtpu_torch.ops.dsp on a CPU tensor)
// is held to a tolerance, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 8;          // consecutive outputs of one plane a thread
constexpr int kMaxThreads = 128;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemOptin = 232448;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// floats of shared memory a block takes; the layout is the kernel's
// (grtpu_torch/ops/cuda_iir.py's layout repeats it)
struct Layout {
  int taps, ff, xs, v, total;
};

__host__ __device__ inline Layout layout(int threads, int C, int Kp, int nff) {
  const int T = threads * kR / C;
  const int H = nff - 1;
  const int Vn = T + Kp - 1;
  Layout l;
  l.taps = 0;
  l.ff = Kp;  // Kp is a multiple of 8
  l.xs = l.ff + round4(nff);
  // the staged window (3 floats of alignment slack before it), which the
  // outputs (T * C floats) reuse on their way out
  l.v = l.xs + round4(3 + (Vn + H) * C + 3);
  const int f = Vn * C;
  l.total = l.v + f + f / (kR * C) + 1;
  return l;
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
    iir1_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                const float* __restrict__ ff, int nff,
                const float* __restrict__ apow,
                const float* __restrict__ apow1, int K, int Kp,
                const float* __restrict__ y0, int y0_stride, int n, int tiles,
                float* __restrict__ y,
                float* __restrict__ hist_out) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RC = kR * C;
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int T = threads * kR / C;
  const int H = nff - 1;
  const int Vn = T + Kp - 1;
  const Layout l = layout(threads, C, Kp, nff);
  float* taps = smem + l.taps;
  float* ffs = smem + l.ff;
  float* xs = smem + l.xs;
  float* vs = smem + l.v;

  const int tile = blockIdx.x % tiles;
  const long long row = blockIdx.x / tiles;
  const int t0 = tile * T;
  const long long nC = static_cast<long long>(n) * C;
  const long long HC = static_cast<long long>(H) * C;
  const float* xr = x + row * nC;
  const float* hr = hist == nullptr ? nullptr : hist + row * HC;
  float* yr = y + row * nC;

  // float g of the row's xs, counted from the chunk's first sample
  auto fetch = [&](long long g) -> float {
    if (g >= 0) return g < nC ? xr[g] : 0.0f;
    return g >= -HC ? hr[HC + g] : 0.0f;
  };

  for (int k = tid; k < Kp; k += threads) taps[k] = k < K ? apow[k] : 0.0f;
  const long long j0 = static_cast<long long>(t0) - (Kp - 1);  // v[0]'s sample
  for (int m = tid; m < nff; m += threads)
    ffs[m] = ff == nullptr ? 1.0f : ff[m];
  const long long f0 = (j0 - H) * C;
  const int shift = static_cast<int>(f0 & 3);
  const long long f0a = f0 - shift;
  const bool aligned = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
  const int nvec = (shift + (Vn + H) * C + 3) / 4;
  for (int w = tid; w < nvec; w += threads) {
    const long long g = f0a + 4LL * w;
    float4 val;
    if (aligned && g >= 0 && g + 4 <= nC) {
      val = __ldg(reinterpret_cast<const float4*>(xr + g));
    } else {
      val = make_float4(fetch(g), fetch(g + 1), fetch(g + 2), fetch(g + 3));
    }
    reinterpret_cast<float4*>(xs)[w] = val;
  }
  if (H > 0 && tile == 0) {
    for (int e = tid; e < HC; e += threads)
      hist_out[row * HC + e] = fetch(nC - HC + e);
  }
  __syncthreads();

  // v over the tile and its halo, skewed: float f at f + f / RC
  for (int f = tid; f < Vn * C; f += threads) {
    const int q = f / C;
    const int p = f - q * C;
    float v = 0.0f;
    if (j0 + q >= 0) {
      const float* src = xs + shift + (q + H) * C + p;
      for (int m = 0; m < nff; ++m) v = fmaf(ffs[m], src[-m * C], v);
    }
    vs[f + f / RC] = v;
  }
  __syncthreads();

  // the K-tap sum: thread (g, p) makes outputs t0 + g*8 + r of plane p.
  // Taps kb..kb+7 need v at q = g*8 + r - k + Kp - 1, i.e. u[r - j + 7]
  // with u[s] = v[qb + s], qb = g*8 + Kp - 8 - kb.
  const int p = tid % C;
  const int g = tid / C;
  float acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = 0.0f;
  float u[2 * kR - 1];
  int qb = g * kR + Kp - kR;
#pragma unroll
  for (int s = 0; s < 2 * kR - 1; ++s) {
    const int f = (qb + s) * C + p;
    u[s] = vs[f + f / RC];
  }
  for (int kb = 0; kb < Kp; kb += kR) {
    const float4 ta = *reinterpret_cast<const float4*>(taps + kb);
    const float4 tb = *reinterpret_cast<const float4*>(taps + kb + 4);
    const float tk[kR] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
#pragma unroll
    for (int j = 0; j < kR; ++j) {
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = fmaf(tk[j], u[r - j + kR - 1], acc[r]);
    }
    if (kb + kR < Kp) {
#pragma unroll
      for (int s = 2 * kR - 2; s >= kR; --s) u[s] = u[s - kR];
      qb -= kR;
#pragma unroll
      for (int s = 0; s < kR; ++s) {
        const int f = (qb + s) * C + p;
        u[s] = vs[f + f / RC];
      }
    }
  }

  // the carried state's response, then out through shared memory
  const int i0 = t0 + g * kR;
  if (i0 < K) {
    const float y0v = y0[row * y0_stride * C + p];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (i0 + r < K) acc[r] = __fadd_rn(acc[r], __fmul_rn(apow1[i0 + r], y0v));
    }
  }
  // xs was last read before the barrier above
#pragma unroll
  for (int r = 0; r < kR; ++r) xs[(g * kR + r) * C + p] = acc[r];
  __syncthreads();
  const int count = (n - t0 < T ? n - t0 : T) * C;
  float* yt = yr + static_cast<long long>(t0) * C;
  const bool y_aligned = (reinterpret_cast<uintptr_t>(yt) & 15) == 0;
  for (int w = tid; 4 * w < count; w += threads) {
    if (y_aligned && 4 * w + 4 <= count) {
      reinterpret_cast<float4*>(yt)[w] = reinterpret_cast<const float4*>(xs)[w];
    } else {
      for (int e = 4 * w; e < 4 * w + 4 && e < count; ++e) yt[e] = xs[e];
    }
  }
}

template <int C>
int launch(const float* x, const float* hist, const float* ff, int nff,
           const float* apow, const float* apow1, int K, int Kp,
           const float* y0, int y0_stride, int rows, int n, int threads,
           int smem, float* y, float* hist_out, cudaStream_t stream) {
  auto kernel = iir1_kernel<C>;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int T = threads * kR / C;
  const int tiles = (n + T - 1) / T;
  const long long blocks = static_cast<long long>(tiles) * rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      x, hist, ff, nff, apow, apow1, K, Kp, y0, y0_stride, n, tiles, y,
      hist_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: rows x n samples (float32, or complex64 as float pairs, cplx 1);
// hist, hist_out: rows x (nff - 1) samples, null when nff is 1; ff: nff
// float32 taps, or null for v = x (nff 1); apow, apow1: K float32 each;
// y0: one sample a row (y0_stride 1) or one for all (0); threads 32, 64 or
// 128.  The staged window must fit in shared memory (layout).
int iir1_fwd(const float* x, const float* hist, const float* ff, int nff,
             const float* apow, const float* apow1, int K, const float* y0,
             int y0_stride, int rows, int n, int cplx, int threads, float* y,
             float* hist_out, cudaStream_t stream) {
  const int C = cplx ? 2 : 1;
  if (rows < 1 || n < 1 || K < 1 || nff < 1 || (ff == nullptr && nff != 1)
      || (nff > 1 && (hist == nullptr || hist_out == nullptr))
      || y0 == nullptr || (y0_stride != 0 && y0_stride != 1)
      || (threads != 32 && threads != 64 && threads != 128)
      || (cplx != 0 && cplx != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Kp = (K + kR - 1) / kR * kR;
  const int smem = layout(threads, C, Kp, nff).total * 4;
  if (smem > kSmemOptin) return static_cast<int>(cudaErrorInvalidValue);
  if (cplx)
    return launch<2>(x, hist, ff, nff, apow, apow1, K, Kp, y0, y0_stride,
                     rows, n, threads, smem, y, hist_out, stream);
  return launch<1>(x, hist, ff, nff, apow, apow1, K, Kp, y0, y0_stride, rows,
                   n, threads, smem, y, hist_out, stream);
}

const char* iir1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
