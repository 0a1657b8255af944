// What the Hopper FIR kernels of grtpu_torch share (fir_tile.cu,
// fir_decim.cuh): the precision modes, the FMA route's inner loop, the
// complex modes' planes, cp.async, the bf16 split and the shared-memory
// opt-in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

enum Precision { F32 = 0, BF16 = 1, BF16X3 = 2 };

constexpr int LOADS = 4;  // device-memory loads a thread keeps in flight
constexpr int SMEM_OPTIN = 232448;  // bytes a Hopper block may opt into

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// How a float32 operand is held in shared memory on the FMA route: NPL planes
// of floats (F32: the value; BF16: its bf16 rounding; BF16X3: hi and lo
// words).
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
};

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ __forceinline__ int round8(int v) { return (v + 7) & ~7; }

// ------------------------------------------- the FMA route's inner loop
//
// A thread owns R8 = 8 consecutive outputs and slides a register window
// along the taps, 8 taps a step: two float4 of window and two float4 of taps
// (one address for every lane: a broadcast) feed 64 FMAs, and unrolled by two
// the window registers rotate by name.  Lanes are 8 floats apart, so a window
// row is held skewed: 4 floats of padding after every 32, which puts the 8
// lanes of a quarter warp on 8 different 16-byte bank groups (unskewed, lanes
// l and l+4 would collide on every load).  A float4 at a column that is a
// multiple of 4 never straddles the padding.
constexpr int R8 = 8;

__host__ __device__ __forceinline__ int skew(int col) {
  return col + ((col >> 5) << 2);
}

// acc[r] += sum_q tap[q] * win[col + r + q], q < n8 (a multiple of 8): tap a
// plain row of n8 floats per plane, win a skewed row per plane, col a
// multiple of 8.  Reads the window up to column col + n8 + 15.
template <int P>
__device__ __forceinline__ void slide8(float (&acc)[R8],
                                       const float* (&tap)[Mode<P>::NPL],
                                       const float* (&win)[Mode<P>::NPL],
                                       int col, int n8) {
  constexpr int NPL = Mode<P>::NPL;
  float4 cur[NPL][2];
  {
    const int a = skew(col);
#pragma unroll
    for (int l = 0; l < NPL; ++l) {
      cur[l][0] = ld4(win[l] + a);
      cur[l][1] = ld4(win[l] + a + 4);
    }
  }
#pragma unroll 2
  for (int q0 = 0; q0 < n8; q0 += 8) {
    const int a = skew(col + q0 + 8);
    float4 nxt[NPL][2], t[NPL][2];
#pragma unroll
    for (int l = 0; l < NPL; ++l) {
      nxt[l][0] = ld4(win[l] + a);
      nxt[l][1] = ld4(win[l] + a + 4);
      t[l][0] = ld4(tap[l] + q0);
      t[l][1] = ld4(tap[l] + q0 + 4);
    }
    const float th[8] = {t[0][0].x, t[0][0].y, t[0][0].z, t[0][0].w,
                         t[0][1].x, t[0][1].y, t[0][1].z, t[0][1].w};
    const float xh[16] = {cur[0][0].x, cur[0][0].y, cur[0][0].z, cur[0][0].w,
                          cur[0][1].x, cur[0][1].y, cur[0][1].z, cur[0][1].w,
                          nxt[0][0].x, nxt[0][0].y, nxt[0][0].z, nxt[0][0].w,
                          nxt[0][1].x, nxt[0][1].y, nxt[0][1].z, nxt[0][1].w};
    if (P == BF16X3) {
      constexpr int L = NPL - 1;
      const float tl[8] = {t[L][0].x, t[L][0].y, t[L][0].z, t[L][0].w,
                           t[L][1].x, t[L][1].y, t[L][1].z, t[L][1].w};
      const float xl[16] = {cur[L][0].x, cur[L][0].y, cur[L][0].z, cur[L][0].w,
                            cur[L][1].x, cur[L][1].y, cur[L][1].z, cur[L][1].w,
                            nxt[L][0].x, nxt[L][0].y, nxt[L][0].z, nxt[L][0].w,
                            nxt[L][1].x, nxt[L][1].y, nxt[L][1].z, nxt[L][1].w};
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int r = 0; r < R8; ++r) {
          acc[r] = fmaf(th[q], xh[r + q], acc[r]);
          acc[r] = fmaf(th[q], xl[r + q], acc[r]);
          acc[r] = fmaf(tl[q], xh[r + q], acc[r]);
        }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int r = 0; r < R8; ++r) acc[r] = fmaf(th[q], xh[r + q], acc[r]);
    }
#pragma unroll
    for (int l = 0; l < NPL; ++l) {
      cur[l][0] = nxt[l][0];
      cur[l][1] = nxt[l][1];
    }
  }
}

// ------------------------------------------------------ the complex modes
// The complex modes: stream planes (re, im), tap planes (tr, ti) and real
// sums a mode keeps apart.  Sum s = a * NT + b is stream plane a against tap
// plane b.
enum Cplx { REAL = 0, CCF = 1, CCC = 2 };
template <int C> struct Cx {
  static constexpr int NC = C == REAL ? 1 : 2;
  static constexpr int NT = C == CCC ? 2 : 1;
  static constexpr int NS = NC * NT;
};
__host__ __device__ __forceinline__ int cx_nc(int c) { return c ? 2 : 1; }
__host__ __device__ __forceinline__ int cx_nt(int c) {
  return c == CCC ? 2 : 1;
}

// A complex output from its sums v[s]: ccf (re.t, im.t); ccc
// (re.tr - im.ti, re.ti + im.tr).
template <int C>
__device__ __forceinline__ float2 cx_out(const float (&v)[Cx<C>::NS]) {
  if constexpr (C == CCC)
    return make_float2(v[0] - v[3], v[1] + v[2]);
  else
    return make_float2(v[0], v[1]);
}

// Output i of one row from its sums v[s].
template <int C>
__device__ __forceinline__ void store_out(float* y, int64_t i,
                                          const float (&v)[Cx<C>::NS]) {
  if constexpr (C == REAL)
    y[i] = v[0];
  else
    reinterpret_cast<float2*>(y)[i] = cx_out<C>(v);
}

// Tap m of tap set g as its NT planes (taps: (G, K) float32, or complex64
// as float pairs).
template <int C>
__device__ __forceinline__ void tap_planes(const float* taps, int g, int K,
                                           int m, float (&t)[2]) {
  constexpr int NT = Cx<C>::NT;
  const bool in = m >= 0 && m < K;
  const int64_t at = ((int64_t)g * K + (in ? K - 1 - m : 0)) * NT;
#pragma unroll
  for (int b = 0; b < NT; ++b) t[b] = in ? taps[at + b] : 0.f;
}

// Sample w of a stream as its planes' values (a complex sample: re, im).
__device__ __forceinline__ void sample(const float* src, int64_t w,
                                       float (&v)[2]) {
  v[0] = src[w];
}
__device__ __forceinline__ void sample(const __nv_bfloat16* src, int64_t w,
                                       float (&v)[2]) {
  v[0] = __bfloat162float(src[w]);
}
__device__ __forceinline__ void sample(const float2* src, int64_t w,
                                       float (&v)[2]) {
  const float2 p = src[w];
  v[0] = p.x;
  v[1] = p.y;
}

// The element type of the stream in mode C: XT for the real mode, float2
// (a complex64 sample) for ccf and ccc.
template <typename XT, int C> struct Elem { using T = XT; };
template <typename XT> struct Elem<XT, CCF> { using T = float2; };
template <typename XT> struct Elem<XT, CCC> { using T = float2; };

// ------------------------------------------------------------- cp.async
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo16,
                                              __nv_bfloat16 hi16) {
  return (uint32_t)__bfloat16_as_ushort(lo16) |
         ((uint32_t)__bfloat16_as_ushort(hi16) << 16);
}

// v -> (hi, lo) bf16 words; lo is unused in the one-plane mode
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16& hi,
                                           __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// Opt a kernel into `smem` bytes of dynamic shared memory.  The attribute is
// set once per kernel instance and device (to the most a block may have), not
// on every launch.
inline cudaError_t set_smem_once(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  if (smem > SMEM_OPTIN) return cudaErrorInvalidValue;
  constexpr int CAP = 1024;
  static const void* seen_kern[CAP];
  static int seen_dev[CAP];
  static int nseen = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < nseen; ++i)
    if (seen_kern[i] == kern && seen_dev[i] == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_OPTIN);
  if (err == cudaSuccess && nseen < CAP) {
    seen_kern[nseen] = kern;
    seen_dev[nseen++] = dev;
  }
  return err;
}
template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return set_smem_once(reinterpret_cast<const void*>(kern), smem);
}

}  // namespace
