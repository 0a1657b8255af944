// Hopper FIR kernels for grtpu_torch (built for sm_90a by ops/_build.py).
//
// Replaces the TPU kernel grtpu/ops/pallas_fir.py::_cascade_kernel
// (pallas_fir.py:70-191) and its two pallas_call sites:
//   * fir_tile_fwd    — the single-stage paths: f32 input at bf16/bf16x3
//                       (:133-153) and f32 (:155-191 with nstages=1), and the
//                       bf16-resident input at bf16 (:114-131).  Launched for
//                       _single_stage (:449-493) and for fir_cascade (:194-262)
//                       with one stage.
//   * fir_cascade_fwd — the multi-stage cascade (:155-191), S chained FIRs
//                       with the same taps from zero history.
//
// What bounds it: a K-tap FIR does 2K FLOP per output against 4*decim bytes
// of input, K/(2*decim) FLOP per byte.  At decimation 1 that is 128 for a
// 256-tap cascade stage and 2048 for the composed 4097-tap filter, far above
// the H100's ~20 FLOP/byte float32 ridge (67 TFLOP/s over 3.35 TB/s): those
// paths are compute-bound, so every operand sits in shared memory and every
// sum in registers.  The WBFM 155-tap decimate-by-8 filter is at ~10
// FLOP/byte, below the ridge: there the kernel reads each input sample from
// device memory once and computes only the outputs it keeps.
//
// The tap matrix no longer exists.  The TPU kernel fed the MXU a
// (nh+1)*128 x 128 Toeplitz tile of the taps (about 2.1 MB at the 4097-tap
// composed filter); here each block stages the K-tap vector itself (16 KB of
// float32 at 4097 taps) and the input window in shared memory, and each
// thread accumulates NG groups of R consecutive outputs with float32 FMA on
// the CUDA cores.  A group slides a register window along the taps: per 4
// taps it reads one float4 of window and one float4 of taps (broadcast) from
// shared memory for 16 FMAs, and consecutive lanes read consecutive float4s,
// so the loads are free of bank conflicts.  Decimation keeps that shape by
// storing the window phase-major (offset w at row w % decim, column
// w / decim) and walking the taps phase by phase.
//
// Contract (both kernels, all precisions):
//   y[row, i] = sum_k taps[row % G, k] * x[row, i*decim + K-1-k - lead]
// with x read as zero outside [0, total).  The cascade applies that S times
// with decim = 1 and lead = K-1 (zero history), full rate.
//
// Precision modes mirror the TPU kernel's:
//   F32    — plain float32 FMA.
//   BF16   — operands rounded to bf16 (round-to-nearest-even), products
//            summed in float32.
//   BF16X3 — split-word: v = hi + lo with hi = bf16(v), lo = bf16(v - hi),
//            sum hi*hi + hi*lo + lo*hi in float32 (pallas_fir.py:137-142 and
//            _tap_group :288-299).
// bf16 products are exact in float32, so each mode matches its plain
// PyTorch twin up to the order of the float32 sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Precision { F32 = 0, BF16 = 1, BF16X3 = 2 };

constexpr int R = 4;   // consecutive outputs per group (one float4)
constexpr int NG = 2;  // groups per thread, blockDim.x * R apart
constexpr int LOADS = 4;  // device-memory loads a thread keeps in flight

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// How a float32 operand is held in shared memory: NPL planes of floats
// (F32: the value; BF16: its bf16 rounding; BF16X3: hi and lo words).
template <int P> struct Mode {
  static constexpr int NPL = P == BF16X3 ? 2 : 1;
  static __device__ __forceinline__ void split(float v, float (&o)[2]) {
    if (P == F32) {
      o[0] = v;
    } else {
      o[0] = round_bf16(v);
      o[1] = round_bf16(v - o[0]);
    }
  }
  // acc[r] += sum_s t[s] * w[r + s], s < 4, for the R outputs of a group;
  // w holds 8 consecutive window values (cur then next).
  static __device__ __forceinline__ void mac(float (&acc)[R],
                                             const float4 (&t)[NPL],
                                             const float4 (&cur)[NPL],
                                             const float4 (&nxt)[NPL]) {
    const float th[4] = {t[0].x, t[0].y, t[0].z, t[0].w};
    const float xh[8] = {cur[0].x, cur[0].y, cur[0].z, cur[0].w,
                         nxt[0].x, nxt[0].y, nxt[0].z, nxt[0].w};
    if (P == BF16X3) {
      const float tl[4] = {t[NPL - 1].x, t[NPL - 1].y, t[NPL - 1].z,
                           t[NPL - 1].w};
      const float xl[8] = {cur[NPL - 1].x, cur[NPL - 1].y, cur[NPL - 1].z,
                           cur[NPL - 1].w, nxt[NPL - 1].x, nxt[NPL - 1].y,
                           nxt[NPL - 1].z, nxt[NPL - 1].w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r] = fmaf(th[q], xh[r + q], acc[r]);
          acc[r] = fmaf(th[q], xl[r + q], acc[r]);
          acc[r] = fmaf(tl[q], xh[r + q], acc[r]);
        }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(th[q], xh[r + q], acc[r]);
    }
  }
};

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[g] += taps (row of n4 values, a multiple of 4) slid along the window
// row, for the NG groups of R outputs starting at columns col[g].
template <int P>
__device__ __forceinline__ void slide(float (&acc)[NG][R],
                                      float* const (&tap)[Mode<P>::NPL],
                                      float* const (&win)[Mode<P>::NPL],
                                      const int (&col)[NG], int n4) {
  constexpr int NPL = Mode<P>::NPL;
  float4 cur[NG][NPL];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int l = 0; l < NPL; ++l) cur[g][l] = ld4(win[l] + col[g]);
  for (int q0 = 0; q0 < n4; q0 += 4) {
    float4 t[NPL];
#pragma unroll
    for (int l = 0; l < NPL; ++l) t[l] = ld4(tap[l] + q0);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float4 nxt[NPL];
#pragma unroll
      for (int l = 0; l < NPL; ++l) nxt[l] = ld4(win[l] + col[g] + q0 + 4);
      Mode<P>::mac(acc[g], t, cur[g], nxt);
#pragma unroll
      for (int l = 0; l < NPL; ++l) cur[g][l] = nxt[l];
    }
  }
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Shared-memory layout of fir_tile_kernel, in floats per plane: taps
// (decim rows of q4) then the window (decim rows of E = tile + q4).
__host__ __device__ __forceinline__ int tile_q4(int decim, int kblk) {
  return round4((kblk + decim - 1) / decim);
}

// One block = one (row, tile of blockDim.x * R * NG outputs).  Thread t owns
// groups of R consecutive outputs at tile offsets (g * blockDim.x + t) * R.
// Taps stream through shared memory in blocks of kblk.  For a tap block,
// window offset m (tap k = k0 + kb-1 - m) of output i sits at sample
// s0 + (i - i0)*decim + m; with m = q*decim + p it is row p, column
// (i - i0) + q of the phase-major window, and tap row p, column q.
template <int P, typename XT>
__global__ void fir_tile_kernel(const XT* __restrict__ x,
                                const float* __restrict__ taps,
                                float* __restrict__ y, int total, int G, int K,
                                int decim, int lead, int nout, int kblk) {
  constexpr int NPL = Mode<P>::NPL;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int tile = nt * R * NG;
  const int i0 = blockIdx.x * tile;
  const int q4 = tile_q4(decim, kblk);
  const int E = tile + q4;
  float* tap[NPL];
  float* win[NPL];
#pragma unroll
  for (int l = 0; l < NPL; ++l) {
    tap[l] = smem + l * decim * q4;
    win[l] = smem + NPL * decim * q4 + l * decim * E;
  }
  const XT* xr = x + (int64_t)row * total;
  const float* tr = taps + (int64_t)(row % G) * K;

  float acc[NG][R];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[g][r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kblk) {
    const int kb = min(kblk, K - k0);
    const int64_t s0 = (int64_t)i0 * decim + (K - k0 - kb) - lead;
    const int wl = (tile - 1) * decim + kb;  // window offsets any output uses
    __syncthreads();  // the previous tap block is no longer being read
    for (int idx = tid; idx < decim * q4; idx += nt) {
      const int p = idx / q4, q = idx - p * q4;
      const int m = q * decim + p;
      float v[2];
      Mode<P>::split(m < kb ? tr[k0 + kb - 1 - m] : 0.f, v);
#pragma unroll
      for (int l = 0; l < NPL; ++l) tap[l][idx] = v[l];
    }
    // LOADS samples in flight per thread: the fill is latency-bound at
    // large decimation, where a block reads decim samples per output
    const int wtot = decim * E;
    for (int w0 = tid; w0 < wtot; w0 += LOADS * nt) {
      float xv[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int w = w0 + u * nt;
        const int64_t s = s0 + w;
        xv[u] = (w < wl && s >= 0 && s < total) ? load(xr, s) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int w = w0 + u * nt;
        if (w >= wtot) break;
        float v[2];
        Mode<P>::split(xv[u], v);
        const int at = (w % decim) * E + w / decim;
#pragma unroll
        for (int l = 0; l < NPL; ++l) win[l][at] = v[l];
      }
    }
    __syncthreads();
    for (int p = 0; p < decim; ++p) {
      float* tp[NPL];
      float* wp[NPL];
#pragma unroll
      for (int l = 0; l < NPL; ++l) {
        tp[l] = tap[l] + p * q4;
        wp[l] = win[l] + p * E;
      }
      int col[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) col[g] = (g * nt + tid) * R;
      slide<P>(acc, tp, wp, col, q4);
    }
  }

  float* yr = y + (int64_t)row * nout;
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + (g * nt + tid) * R + r;
      if (i < nout) yr[i] = acc[g][r];
    }
}

// Floats per plane of one cascade buffer: the tile, its S*(K-1) lookback,
// and slack for reads up to 10 past the valid region (a group's columns are
// clamped to round4(lout), and round4(K) - K <= 3).
__host__ __device__ __forceinline__ int cascade_cap(int K, int S, int tile) {
  return round4(tile + S * (K - 1) + 16);
}

// One block = one (row, tile of `tile` outputs).  The block loads its tile
// plus S*(K-1) samples of lookback (zeros before sample 0) and runs the S
// stages in shared memory, ping-ponging between two buffers; each stage's
// valid region shrinks by K-1, and the last stage writes the tile.  Groups
// past a stage's last output read from a clamped column and write nothing;
// reads past the valid region meet finite values that only feed discarded
// outputs.
template <int P>
__global__ void fir_cascade_kernel(const float* __restrict__ x,
                                   const float* __restrict__ taps,
                                   float* __restrict__ y, int n, int K, int S,
                                   int tile) {
  constexpr int NPL = Mode<P>::NPL;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int k4 = round4(K);
  const int halo = S * (K - 1);
  const int len0 = tile + halo;
  const int cap = cascade_cap(K, S, tile);
  float* tap[NPL];
  float* in[NPL];
  float* out[NPL];
#pragma unroll
  for (int l = 0; l < NPL; ++l) {
    tap[l] = smem + l * k4;
    in[l] = smem + NPL * k4 + l * cap;
    out[l] = smem + NPL * k4 + (NPL + l) * cap;
  }

  const int row = blockIdx.y;
  const int64_t t0 = (int64_t)blockIdx.x * tile;
  const float* xr = x + (int64_t)row * n;
  // reversed taps: stage output j = sum_m tap[m] * in[j + m]
  for (int m = tid; m < k4; m += nt) {
    float v[2];
    Mode<P>::split(m < K ? taps[K - 1 - m] : 0.f, v);
#pragma unroll
    for (int l = 0; l < NPL; ++l) tap[l][m] = v[l];
  }
  for (int j0 = tid; j0 < cap; j0 += LOADS * nt) {
    float xv[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int j = j0 + u * nt;
      const int64_t s = t0 - halo + j;
      xv[u] = (j < len0 && s >= 0 && s < n) ? xr[s] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int j = j0 + u * nt;
      if (j >= cap) break;
      float v[2];
      Mode<P>::split(xv[u], v);
#pragma unroll
      for (int l = 0; l < NPL; ++l) {
        in[l][j] = v[l];
        out[l][j] = 0.f;
      }
    }
  }
  __syncthreads();

  int len = len0;
  const int chunk = nt * R * NG;
  for (int st = 0; st < S; ++st) {
    const int lout = len - (K - 1);
    const bool last = st == S - 1;
    for (int base = 0; base < lout; base += chunk) {
      float acc[NG][R];
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[g][r] = 0.f;
      int col[NG], colr[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        col[g] = base + (g * nt + tid) * R;
        colr[g] = min(col[g], round4(lout));
      }
      slide<P>(acc, tap, in, colr, k4);
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = col[g] + r;
          if (j >= lout) continue;
          if (last) {
            if (t0 + j < n) y[(int64_t)row * n + t0 + j] = acc[g][r];
          } else {
            float v[2];
            Mode<P>::split(acc[g][r], v);
#pragma unroll
            for (int l = 0; l < NPL; ++l) out[l][j] = v[l];
          }
        }
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < NPL; ++l) {
      float* tmp = in[l];
      in[l] = out[l];
      out[l] = tmp;
    }
    len = lout;
  }
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

size_t tile_smem(int precision, int threads, int decim, int kblk) {
  const size_t npl = precision == BF16X3 ? 2 : 1;
  const size_t q4 = tile_q4(decim, kblk);
  const size_t tile = (size_t)threads * R * NG;
  return sizeof(float) * npl * decim * (2 * q4 + tile);
}

size_t cascade_smem(int precision, int K, int S, int tile) {
  const size_t npl = precision == BF16X3 ? 2 : 1;
  return sizeof(float) * npl *
         ((size_t)round4(K) + 2 * (size_t)cascade_cap(K, S, tile));
}

template <int P, typename XT>
cudaError_t launch_tile(const void* x, const float* taps, float* y, int B,
                        int total, int G, int K, int decim, int lead, int nout,
                        int threads, int kblk, cudaStream_t stream) {
  const size_t smem = tile_smem(P, threads, decim, kblk);
  auto kern = fir_tile_kernel<P, XT>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int tile = threads * R * NG;
  dim3 grid((nout + tile - 1) / tile, B);
  kern<<<grid, threads, smem, stream>>>(static_cast<const XT*>(x), taps, y,
                                        total, G, K, decim, lead, nout, kblk);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_cascade(const float* x, const float* taps, float* y, int B,
                           int n, int K, int S, int tile, int threads,
                           cudaStream_t stream) {
  const size_t smem = cascade_smem(P, K, S, tile);
  auto kern = fir_cascade_kernel<P>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + tile - 1) / tile, B);
  kern<<<grid, threads, smem, stream>>>(x, taps, y, n, K, S, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of each kernel uses (the wrapper sizes its
// launches with these).
size_t fir_tile_smem(int precision, int threads, int decim, int kblk) {
  return tile_smem(precision, threads, decim, kblk);
}

size_t fir_cascade_smem(int precision, int K, int S, int tile) {
  return cascade_smem(precision, K, S, tile);
}

int fir_tile_outputs_per_thread() { return R * NG; }

// x: (B, total) float32 (x_bf16 == 0) or bfloat16 (x_bf16 == 1), row-major
// contiguous; taps: (G, K) float32; y: (B, nout) float32.
int fir_tile_fwd(const void* x, int x_bf16, const void* taps, void* y, int B,
                 int total, int G, int K, int decim, int lead, int nout,
                 int precision, int threads, int kblk, void* stream) {
  const float* t = static_cast<const float*>(taps);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (x_bf16) {
    if (precision == BF16)
      err = launch_tile<BF16, __nv_bfloat16>(x, t, out, B, total, G, K, decim,
                                             lead, nout, threads, kblk, s);
  } else if (precision == F32) {
    err = launch_tile<F32, float>(x, t, out, B, total, G, K, decim, lead, nout,
                                  threads, kblk, s);
  } else if (precision == BF16) {
    err = launch_tile<BF16, float>(x, t, out, B, total, G, K, decim, lead,
                                   nout, threads, kblk, s);
  } else if (precision == BF16X3) {
    err = launch_tile<BF16X3, float>(x, t, out, B, total, G, K, decim, lead,
                                     nout, threads, kblk, s);
  }
  return (int)err;
}

// x, y: (B, n) float32 contiguous; taps: (K,) float32.
int fir_cascade_fwd(const void* x, const void* taps, void* y, int B, int n,
                    int K, int S, int tile, int precision, int threads,
                    void* stream) {
  const float* in = static_cast<const float*>(x);
  const float* t = static_cast<const float*>(taps);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (precision == F32)
    err = launch_cascade<F32>(in, t, out, B, n, K, S, tile, threads, s);
  else if (precision == BF16)
    err = launch_cascade<BF16>(in, t, out, B, n, K, S, tile, threads, s);
  else if (precision == BF16X3)
    err = launch_cascade<BF16X3>(in, t, out, B, n, K, S, tile, threads, s);
  return (int)err;
}

const char* fir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
