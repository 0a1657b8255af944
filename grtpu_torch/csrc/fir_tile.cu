// Hopper FIR kernels for grtpu_torch (built for sm_90a by ops/_build.py,
// beside fir_decim.cu and fir_decim_mma.cu, which hold the decimating
// routes).
//
// Replaces the TPU kernel grtpu/ops/pallas_fir.py::_cascade_kernel
// (pallas_fir.py:70-191) and its two pallas_call sites:
//   * fir_tile_fwd     — the single-stage paths on the CUDA cores: f32 input
//                        at bf16/bf16x3 (:133-153) and f32 (:155-191 with
//                        nstages=1), and the bf16-resident input at bf16
//                        (:114-131).  Launched for _single_stage (:449-493)
//                        and for fir_cascade (:194-262) with one stage, at
//                        decimation 1 in f32 and for filters outside the
//                        tensor-core route's range; decimating calls take
//                        fir_decim.cuh's kernels unless their window is too
//                        large for those.  Its complex modes (ccf, ccc: the
//                        interleaved complex64 stream read once, the
//                        complex64 output written once) serve fir_decim_c /
//                        fir_decim_cc at decimation 1 in f32 from 1,024
//                        taps (cuda_fir._D1_TILE_TAPS) and complex windows
//                        too large for the decimating kernels.
//   * fir_toeplitz_fwd — the same single-stage paths in bf16 and bf16x3 at
//                        decimation 1, on the tensor cores.
//   * fir_cascade_fwd  — the multi-stage cascade (:155-191), S chained FIRs
//                        with the same taps from zero history.  The FMA route
//                        (f32).
//   * fir_cascade_mma_fwd — the same cascade in bf16 and bf16x3, its stages on
//                        the tensor cores.
//
// What bounds it: a K-tap FIR does 2K FLOP per output against 4*decim bytes
// of input, K/(2*decim) FLOP per byte (a complex stream: twice the FLOP on
// twice the bytes in ccf, four times the FLOP in ccc).  At decimation 1
// that is 128 for a 256-tap cascade stage and 2048 for the composed
// 4097-tap filter, far above the H100's ridges (~20 FLOP/byte for float32
// on the CUDA cores, 67 TFLOP/s over 3.35 TB/s; ~295 for bf16 on the tensor
// cores, 989 TFLOP/s): those paths are bound by operations.
//
// The FMA route (f32 everywhere, filters outside the tensor cores' range):
// each block stages the taps (blocks of 2048 for the single stage, 8 KB of
// float32 a plane) and the input window in shared memory, and each thread
// accumulates 8 consecutive outputs with float32 FMA on the CUDA cores,
// sliding a register window along the taps (slide8 in fir_common.cuh): per 8
// taps it reads two float4 of window and two float4 of taps (broadcast) for
// 64 FMAs, 128 FMAs among 150 instructions in the unrolled loop, and the
// window rows are skewed so that lanes 8 floats apart load without bank
// conflicts.  The single-stage kernel keeps that shape under decimation by
// storing the window phase-major (offset w at row w % decim, column
// w / decim) and walking the taps phase by phase.  The cascade deals a
// stage's groups of 8 outputs round-robin to 1024 threads over two skewed
// buffers of up to 21,504 outputs plus the lookback, which every tile
// recomputes; the wrapper picks the tile by the recompute and by how full
// the grid's last wave is.
//
// The tensor-core route (bf16 and bf16x3, decimation 1, single stage and
// cascade): the FMA route tops out at the CUDA cores' 67 TFLOP/s (a third of
// it in bf16x3), so these modes take the product the TPU kernel took on its
// matrix unit, rows of the stream against the Toeplitz matrix of the taps,
// to wgmma.mma_async.  The Toeplitz matrix is never built, neither in device
// memory (1 MB a plane at 4097 taps, streamed by every block) nor in shared
// memory: it is wgmma's register operand, whose fragments are pairs of
// consecutive taps read straight from the tap vector, two words a k-step;
// the shared-memory operand is the stream itself, whose rows already are a
// swizzled K-major tile.  The stream is split to bf16 words once, by a
// prepass into device memory (bytes are cheap here, operations are not), and
// a block walks a long segment of one row through a two-stage ring fed by
// cp.async, so the next pass's rows arrive behind this pass's MMAs.  Details
// stand with the kernels below.
//
// Contract (every kernel, all precisions):
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
// PyTorch twin up to the order of the float32 sums (and, on the tensor
// cores, the adder's alignment of the 16 products of a k-step).

#include "fir_common.cuh"

namespace {

// Shared-memory layout of fir_tile_kernel, in floats per precision plane:
// the taps (decim rows of q8 a tap plane) then the window (decim skewed rows
// of tile + q8 + 8 columns a stream plane).
__host__ __device__ __forceinline__ int tile_q8(int decim, int kblk) {
  return round8((kblk + decim - 1) / decim);
}
__host__ __device__ __forceinline__ int tile_row(int tile, int q8) {
  return round4(skew(tile + q8 + 8));
}

// One block = one (row, tile of blockDim.x * 8 outputs).  Thread t owns the 8
// consecutive outputs at tile offset 8 t.  Taps stream through shared memory
// in blocks of kblk.  For a tap block, window offset m (tap k = k0 + kb-1 - m)
// of output i sits at sample s0 + (i - i0)*decim + m; with m = q*decim + p it
// is row p, column (i - i0) + q of the phase-major window, and tap row p,
// column q.  In the complex modes (C, as fir_common.cuh has them) the stream
// is read as float2 and split into a re and an im window as it is staged,
// ccc's complex64 taps into a tr and a ti row; slide8 runs once for each
// (stream plane, tap plane) pair and ccc's four sums meet in registers.
template <int P, typename XT, int C>
__global__ void fir_tile_kernel(const XT* __restrict__ x,
                                const float* __restrict__ taps,
                                float* __restrict__ y, int total, int G, int K,
                                int decim, int lead, int nout, int kblk) {
  constexpr int NPL = Mode<P>::NPL;
  constexpr int NC = Cx<C>::NC, NT = Cx<C>::NT, NS = Cx<C>::NS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int tile = nt * R8;
  const int i0 = blockIdx.x * tile;
  const int q8 = tile_q8(decim, kblk);
  const int E = tile + q8 + 8;
  const int ER = tile_row(tile, q8);
  // tap plane b, precision plane l at tapb + (b*NPL + l)*decim*q8; stream
  // plane a, precision plane l at winb + (a*NPL + l)*decim*ER
  float* tapb = smem;
  float* winb = smem + NT * NPL * decim * q8;
  const XT* xr = x + (int64_t)row * total;

  float acc[NS][R8];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int r = 0; r < R8; ++r) acc[s][r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kblk) {
    const int kb = min(kblk, K - k0);
    const int64_t s0 = (int64_t)i0 * decim + (K - k0 - kb) - lead;
    const int wl = (tile - 1) * decim + kb;  // window offsets any output uses
    __syncthreads();  // the previous tap block is no longer being read
    for (int idx = tid; idx < decim * q8; idx += nt) {
      const int p = idx / q8, q = idx - p * q8;
      const int m = q * decim + p;
      // window offset m takes tap k0 + kb-1 - m, which tap_planes counts
      // from the end of the taps
      float t[2];
      tap_planes<C>(taps, row % G, K, m < kb ? K - k0 - kb + m : K, t);
#pragma unroll
      for (int b = 0; b < NT; ++b) {
        float v[2];
        Mode<P>::split(t[b], v);
#pragma unroll
        for (int l = 0; l < NPL; ++l)
          tapb[(b * NPL + l) * decim * q8 + idx] = v[l];
      }
    }
    // LOADS samples in flight per thread
    const int wtot = decim * E;
    for (int w0 = tid; w0 < wtot; w0 += LOADS * nt) {
      float xv[LOADS][2];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int w = w0 + u * nt;
        const int64_t s = s0 + w;
        xv[u][0] = xv[u][1] = 0.f;
        if (w < wl && s >= 0 && s < total) sample(xr, s, xv[u]);
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int w = w0 + u * nt;
        if (w >= wtot) break;
        const int at = (w % decim) * ER + skew(w / decim);
#pragma unroll
        for (int a = 0; a < NC; ++a) {
          float v[2];
          Mode<P>::split(xv[u][a], v);
#pragma unroll
          for (int l = 0; l < NPL; ++l)
            winb[(a * NPL + l) * decim * ER + at] = v[l];
        }
      }
    }
    __syncthreads();
    for (int p = 0; p < decim; ++p) {
#pragma unroll
      for (int a = 0; a < NC; ++a)
#pragma unroll
        for (int b = 0; b < NT; ++b) {
          const float* tp[NPL];
          const float* wp[NPL];
#pragma unroll
          for (int l = 0; l < NPL; ++l) {
            tp[l] = tapb + (b * NPL + l) * decim * q8 + p * q8;
            wp[l] = winb + (a * NPL + l) * decim * ER + p * ER;
          }
          slide8<P>(acc[a * NT + b], tp, wp, tid * R8, q8);
        }
    }
  }

  const int i = i0 + tid * R8;
  if constexpr (C == REAL) {
    float* yr = y + (int64_t)row * nout;
    if (i + R8 <= nout && (reinterpret_cast<uintptr_t>(yr + i) & 15) == 0) {
      st4(yr + i, acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      st4(yr + i + 4, acc[0][4], acc[0][5], acc[0][6], acc[0][7]);
    } else {
#pragma unroll
      for (int r = 0; r < R8; ++r)
        if (i + r < nout) yr[i + r] = acc[0][r];
    }
  } else {
    float2 o[R8];
#pragma unroll
    for (int r = 0; r < R8; ++r) {
      float v[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) v[s] = acc[s][r];
      o[r] = cx_out<C>(v);
    }
    float* yr = y + 2 * ((int64_t)row * nout + i);
    if (i + R8 <= nout && (reinterpret_cast<uintptr_t>(yr) & 15) == 0) {
#pragma unroll
      for (int r = 0; r < R8; r += 2)
        st4(yr + 2 * r, o[r].x, o[r].y, o[r + 1].x, o[r + 1].y);
    } else {
#pragma unroll
      for (int r = 0; r < R8; ++r)
        if (i + r < nout) reinterpret_cast<float2*>(yr)[r] = o[r];
    }
  }
}

// Floats per plane of one cascade buffer: the tile, its S*(K-1) lookback and
// 24 columns of slack (a group starts below the stage's valid length and
// slide8 reads 15 columns past the last padded tap), skewed.
__host__ __device__ __forceinline__ int cascade_cols(int K, int S, int tile) {
  return round8(tile + S * (K - 1) + 24);
}
__host__ __device__ __forceinline__ int cascade_cap(int K, int S, int tile) {
  return round4(skew(cascade_cols(K, S, tile))) + 4;
}

// One block = one (row, tile of `tile` outputs, a multiple of 8).  The block
// loads its tile plus S*(K-1) samples of lookback (zeros before sample 0) and
// runs the S stages in shared memory, ping-ponging between two skewed
// buffers; each stage's valid region shrinks by K-1, and the last stage
// writes the tile.  A stage's groups of 8 outputs are dealt round-robin to
// the threads, so every thread has work until the last round.  Reads past the
// valid region meet finite values (both buffers start finite everywhere) that
// only feed discarded outputs or zero taps.
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
  const int k8 = round8(K);
  const int halo = S * (K - 1);
  const int len0 = tile + halo;
  const int cols = cascade_cols(K, S, tile);
  const int cap = cascade_cap(K, S, tile);
  float* tap[NPL];
  float* in[NPL];
  float* out[NPL];
#pragma unroll
  for (int l = 0; l < NPL; ++l) {
    tap[l] = smem + l * k8;
    in[l] = smem + NPL * k8 + l * cap;
    out[l] = smem + NPL * k8 + (NPL + l) * cap;
  }

  const int row = blockIdx.y;
  const int64_t t0 = (int64_t)blockIdx.x * tile;
  const float* xr = x + (int64_t)row * n;
  float* yr = y + (int64_t)row * n + t0;
  // reversed taps: stage output j = sum_m tap[m] * in[j + m]
  for (int m = tid; m < k8; m += nt) {
    float v[2];
    Mode<P>::split(m < K ? taps[K - 1 - m] : 0.f, v);
#pragma unroll
    for (int l = 0; l < NPL; ++l) tap[l][m] = v[l];
  }
  for (int j0 = tid; j0 < cols; j0 += LOADS * nt) {
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
      if (j >= cols) break;
      float v[2];
      Mode<P>::split(xv[u], v);
      const int at = skew(j);
#pragma unroll
      for (int l = 0; l < NPL; ++l) {
        in[l][at] = v[l];
        out[l][at] = 0.f;
      }
    }
  }
  __syncthreads();

  int len = len0;
  for (int st = 0; st < S; ++st) {
    const int lout = len - (K - 1);
    const bool last = st == S - 1;
    const int ngrp = (lout + R8 - 1) / R8;
    for (int grp = tid; grp < ngrp; grp += nt) {
      const int col = grp * R8;
      float acc[R8];
#pragma unroll
      for (int r = 0; r < R8; ++r) acc[r] = 0.f;
      const float* tp[NPL];
      const float* ip[NPL];
#pragma unroll
      for (int l = 0; l < NPL; ++l) {
        tp[l] = tap[l];
        ip[l] = in[l];
      }
      slide8<P>(acc, tp, ip, col, k8);
      if (last) {
        // lout == tile: whole groups, 32-byte aligned (n % 128 == 0)
        if (t0 + col < n) {
          st4(yr + col, acc[0], acc[1], acc[2], acc[3]);
          st4(yr + col + 4, acc[4], acc[5], acc[6], acc[7]);
        }
      } else {
        float v[R8][2];
#pragma unroll
        for (int r = 0; r < R8; ++r) Mode<P>::split(acc[r], v[r]);
        const int at = skew(col);
#pragma unroll
        for (int l = 0; l < NPL; ++l) {
          st4(out[l] + at, v[0][l], v[1][l], v[2][l], v[3][l]);
          st4(out[l] + at + 4, v[4][l], v[5][l], v[6][l], v[7][l]);
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

// ------------------------------------------------ the tensor-core route
//
// bf16 and bf16x3 at decimation 1.  With reversed taps h[m] = taps[K-1-m] and
// xp = x behind `lead` zeros, y[i] = sum_m h[m] * xp[i + m].  Read xp as rows
// of TZ_N = 128 samples, XP[r, j] = xp[128*r + j] for j < nh*128 (a row runs
// on into the rows below it), nh = ceil((K + 127) / 128).  Then
//   Y[r, c] = sum_j XP[r, j] * T[j, c],   T[j, c] = h[j - c] (0 off the taps),
// the stream's own rows against the Toeplitz matrix of the taps.  It is taken
// transposed on wgmma.mma_async (m64n128k16, bf16 operands, float32 sums), so
// that the operand wgmma must read from shared memory is the stream and the
// Toeplitz matrix stays in registers:
//   Y^T[c, r] = sum_j T^T[c, j] * XP[r, j].
//
// A (64 output columns x 16, from registers) is T^T, which is never built.  A
// fragment register holds two horizontally adjacent entries of T^T, which are
// two consecutive reversed taps, so each lane reads its registers straight
// from the tap vector in shared memory: hs[i] = h[i - 128] (zero outside the
// taps) is kept as 32-bit words at both parities, E[w] = (hs[2w], hs[2w+1])
// and O[w] = (hs[2w+1], hs[2w+2]).  With P(t) the pair 8t taps past the
// lane's base, k-step kk takes a0 = a3 = P(2kk), a1 = P(2kk-1), a2 = P(2kk+1):
// two new words a k-step and plane.
//
// B (16 x 128 stream rows, K-major) is 128 consecutive rows of xp's bf16
// planes (hi, and lo in bf16x3).  They lie in shared memory as wgmma's
// 128-byte-swizzled K-major layout wants them: two arrays of 128-byte rows
// (columns 0-63 and 64-127), each row's 16-byte chunks XORed with the row's
// low 3 bits.  The swizzle is a function of the shared address, so sliding
// down one stream row (the next block of 128 contraction indices) is 128
// bytes more in the descriptor, and a k-step is 32 bytes more.
//
// One block is two warpgroups (output columns 0-63 and 64-127 of the same
// 128 rows) over the same B tiles.  Sum order: one float32 accumulator per
// output takes the k-steps (16 products each) in ascending j; in bf16x3 each
// k-step adds hi*hi, then hi*lo, then lo*hi.

constexpr int TZ_N = 128;        // samples per row of xp, outputs per row of Y
constexpr int TZ_RG = 128;       // output rows a block computes per pass
constexpr int TZ_THREADS = 256;  // two warpgroups

__host__ __device__ __forceinline__ int tz_nh(int K) {
  return (K + 2 * TZ_N - 2) / TZ_N;
}
// 32-bit words of one parity copy of hs (nh*128 + 128 entries), plus 16 so
// the E and O copies, read together by a warp, sit in different banks
__host__ __device__ __forceinline__ int tz_tap_words(int nh) {
  return (TZ_N / 2) * (nh + 1) + 16;
}

// Stage the reversed taps of one tap set as the E and O word copies of hs,
// plane l at tapw + l * 2 * tz_tap_words(nh) (E then O).
template <int NPL>
__device__ __forceinline__ void tz_stage_taps(uint32_t* tapw,
                                              const float* __restrict__ tr,
                                              int K, int nh) {
  const int nwp = tz_tap_words(nh);
  const int nw = nwp - 16;
  for (int w = threadIdx.x; w < nwp; w += blockDim.x) {
    __nv_bfloat16 hi[3], lo[3];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int m = 2 * w + u - TZ_N;
      split_bf16((w < nw && m >= 0 && m < K) ? tr[K - 1 - m] : 0.f, hi[u],
                 lo[u]);
    }
    tapw[w] = pack_bf16(hi[0], hi[1]);
    tapw[nwp + w] = pack_bf16(hi[1], hi[2]);
    if (NPL == 2) {
      tapw[2 * nwp + w] = pack_bf16(lo[0], lo[1]);
      tapw[3 * nwp + w] = pack_bf16(lo[1], lo[2]);
    }
  }
}

// xp planes for fir_toeplitz_kernel: plane l of row b at
// xp + l*plane_stride + b*lcols, xp[p] = bf16 word l of x[p - lead], zero
// outside x.  A thread writes 8 consecutive entries (16 bytes) per plane.
template <int NPL, typename XT>
__global__ void fir_split_kernel(const XT* __restrict__ x,
                                 __nv_bfloat16* __restrict__ xp,
                                 int64_t plane_stride, int total, int lead,
                                 int lcols) {
  const int p0 = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (p0 >= lcols) return;
  const int row = blockIdx.y;
  const XT* xr = x + (int64_t)row * total;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    __nv_bfloat16 h[2], l[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = p0 + 2 * u + e - lead;
      split_bf16((s >= 0 && s < total) ? load(xr, s) : 0.f, h[e], l[e]);
    }
    hi[u] = pack_bf16(h[0], h[1]);
    lo[u] = pack_bf16(l[0], l[1]);
  }
  __nv_bfloat16* dst = xp + (int64_t)row * lcols + p0;
  *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  if (NPL == 2)
    *reinterpret_cast<uint4*>(dst + plane_stride) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128 float32, 64 registers a thread) += A (registers) * B (shared
// memory descriptor, K-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}

// Descriptor of a K-major bf16 tile in 128-byte-swizzled rows of 128 bytes:
// 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;            // leading byte offset: unused here
  d |= (uint64_t)(1024 >> 4) << 32;  // stride byte offset
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

// acc (this warpgroup's 64 output columns x 128 stream rows) = the Toeplitz
// product over the rows of a swizzled buffer at shared address sb (plane 0,
// columns 0-63; columns 64-127 half_bytes on, planes plane_bytes apart): row
// r of the result reads buffer rows r .. r+nh-1.  tw: the lane's tap words.
// The 128 contraction indices of block jb are 8 k-steps (24 in bf16x3:
// hi*hi, hi*lo, lo*hi) committed as one group; two register sets of tap
// words alternate so that one group is always in flight behind the loads of
// the next.  All groups have retired on return.
template <int NPL>
__device__ __forceinline__ void wg_toeplitz(float (&acc)[64], uint32_t sb,
                                            uint32_t half_bytes,
                                            uint32_t plane_bytes,
                                            const uint32_t* tw, int tap_plane,
                                            int nh) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t PA[NPL][18], PB[NPL][18];
  // P holds P(16*jb - 1 .. 16*jb + 16)
  auto block = [&](uint32_t (&P)[NPL][18], int jb) {
    wgmma_wait<1>();  // the block that last read this P has retired
#pragma unroll
    for (int l = 0; l < NPL; ++l)
#pragma unroll
      for (int u = 0; u < 18; ++u)
        P[l][u] = tw[l * tap_plane + 4 * (16 * jb - 1 + u)];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const uint32_t b = sb + (ks >> 2) * half_bytes + jb * 128 + (ks & 3) * 32;
      const uint64_t dh = wg_desc(b);
      // P(2kk) is P[.][2*ks + 1]
      wgmma_m64n128k16(acc, P[0][2 * ks + 1], P[0][2 * ks], P[0][2 * ks + 2],
                       P[0][2 * ks + 1], dh);
      if (NPL == 2) {
        wgmma_m64n128k16(acc, P[0][2 * ks + 1], P[0][2 * ks], P[0][2 * ks + 2],
                         P[0][2 * ks + 1], wg_desc(b + plane_bytes));
        wgmma_m64n128k16(acc, P[NPL - 1][2 * ks + 1], P[NPL - 1][2 * ks],
                         P[NPL - 1][2 * ks + 2], P[NPL - 1][2 * ks + 1], dh);
      }
    }
    wgmma_commit();
  };
  for (int jb = 0; jb < nh; jb += 2) {
    block(PA, jb);
    if (jb + 1 < nh) block(PB, jb + 1);
  }
  wgmma_wait<0>();
}

// This lane's base into the tap words of plane 0 for wg_toeplitz: P(t), the
// pair (hs[e], hs[e+1]) at e = 128 - cb + 2*(lane%4) - lane/4 + 8t, is
// tw[4*t]; cb is the first output column of the lane's warp.
__device__ __forceinline__ const uint32_t* wg_lane_taps(const uint32_t* tapw,
                                                        int nh, int cb) {
  const int lane = threadIdx.x & 31;
  const int g0 = lane >> 2;
  return tapw + (g0 & 1) * tz_tap_words(nh) + TZ_N / 2 - cb / 2 + (lane & 3) -
         ((g0 + 1) >> 1);
}

// Shared address of the 16-byte chunk holding columns 8*ch .. 8*ch+7 (ch <
// 16) of row q in a swizzled buffer at sb.
__device__ __forceinline__ uint32_t wg_chunk(uint32_t sb, uint32_t half_bytes,
                                             int q, int ch) {
  return sb + (ch >> 3) * half_bytes + q * 128 + (((ch & 7) ^ (q & 7)) << 4);
}

// Rows of a swizzled buffer: a pass's TZ_RG + nh - 1 stream rows, in whole
// 8-row swizzle groups.
__host__ __device__ __forceinline__ int wg_rows(int nh) {
  return (TZ_RG + nh - 1 + 7) / 8 * 8;
}
// Bytes of the tap words ahead of the buffers, which start 1024-aligned.
__host__ __device__ __forceinline__ int wg_tap_bytes(int npl, int nh) {
  return (npl * 2 * 4 * tz_tap_words(nh) + 1023) / 1024 * 1024;
}

// One block = one (row, segment of seg_rows output rows of 128), walked in
// passes of TZ_RG rows.  Shared memory: the tap words, then a ring of two
// stages, each the TZ_RG + nh - 1 stream rows one pass reads.  The rows of
// pass g+1 were requested (cp.async) before pass g began, and the rows of pass
// g+2 are requested as soon as pass g has ended, into the stage it has just
// freed: the loads run behind the MMAs.
template <int NPL>
__global__ void __launch_bounds__(TZ_THREADS, NPL == 1 ? 2 : 1)
fir_toeplitz_kernel(const __nv_bfloat16* __restrict__ xp,
                    const float* __restrict__ taps, float* __restrict__ y,
                    int64_t plane_stride, int lrows, int G, int K, int nout,
                    int seg_rows) {
  extern __shared__ __align__(1024) float4 smem4[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y;
  const int nh = tz_nh(K);
  const int tap_plane = 2 * tz_tap_words(nh);
  uint32_t* tapw = reinterpret_cast<uint32_t*>(smem4);
  const int RB = wg_rows(nh);
  const uint32_t half_bytes = (uint32_t)RB * 128;
  const uint32_t plane_bytes = 2 * half_bytes;
  const uint32_t stage_bytes = NPL * plane_bytes;
  const uint32_t buf0 = smem_addr(smem4) + wg_tap_bytes(NPL, nh);

  const int rows_out = (nout + TZ_N - 1) / TZ_N;
  const int ra = blockIdx.x * seg_rows;
  const int npass = (min(seg_rows, rows_out - ra) + TZ_RG - 1) / TZ_RG;
  const __nv_bfloat16* xrow = xp + ((int64_t)row * lrows + ra) * TZ_N;
  const int nq = TZ_RG + nh - 1;  // stream rows a pass reads

  auto request = [&](int g) {
    const uint32_t sb = buf0 + (g & 1) * stage_bytes;
    const __nv_bfloat16* src = xrow + (int64_t)g * TZ_RG * TZ_N;
    for (int idx = tid; idx < NPL * nq * 16; idx += TZ_THREADS) {
      const int l = idx / (nq * 16), c = idx - l * (nq * 16);
      const int q = c >> 4, ch = c & 15;
      cp_async16(wg_chunk(sb + l * plane_bytes, half_bytes, q, ch),
                 src + l * plane_stride + q * TZ_N + ch * 8);
    }
  };
  request(0);
  cp_async_commit();
  if (npass > 1) request(1);
  cp_async_commit();
  tz_stage_taps<NPL>(tapw, taps + (int64_t)(row % G) * K, K, nh);

  const int g0 = lane >> 2;
  const int cb = (warp >> 2) * 64 + (warp & 3) * 16;
  const uint32_t* tw = wg_lane_taps(tapw, nh, cb);
  float* yr = y + (int64_t)row * nout;

  for (int g = 0; g < npass; ++g) {
    cp_async_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t sb = buf0 + (g & 1) * stage_bytes;
    float acc[64];
    wg_toeplitz<NPL>(acc, sb, half_bytes, plane_bytes, tw, tap_plane, nh);
    // acc[4*i + e]: column c = cb + g0 + 8*(e >> 1), stream row 8*i +
    // 2*(lane & 3) + (e & 1)
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = ra + g * TZ_RG + 8 * i + 2 * (lane & 3) + (e & 1);
        const int64_t o = (int64_t)r * TZ_N + cb + g0 + 8 * (e >> 1);
        if (o < nout) yr[o] = acc[4 * i + e];
      }
    __syncthreads();  // every warp is done with this stage
    if (g + 2 < npass) request(g + 2);
    cp_async_commit();
  }
}

// The cascade on the tensor cores, bf16 and bf16x3: the plan of
// fir_cascade_kernel (a block loads its tile plus S*(K-1) samples of lookback
// and runs the S stages between two shared-memory buffers), each stage one
// wg_toeplitz over the 128 rows of the input buffer.  Stage output
// j = sum_m h[m] * in[j + m] lands at position j of the other buffer,
// re-split to bf16 words (a thread holds one column of 16 rows, so these are
// 2-byte stores); the valid length shrinks by K-1 a stage and the last
// stage's first `tile` positions are the block's outputs.  Both buffers
// start finite everywhere (zeros past the loaded samples): positions past
// the valid length meet the zero entries of the Toeplitz matrix, or feed
// outputs past the valid length.  tile + S*(K-1) <= 128*128.
template <int NPL>
__global__ void __launch_bounds__(TZ_THREADS, NPL == 1 ? 2 : 1)
fir_cascade_mma_kernel(const float* __restrict__ x,
                       const float* __restrict__ taps, float* __restrict__ y,
                       int n, int K, int S, int tile) {
  extern __shared__ __align__(1024) float4 smem4[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nh = tz_nh(K);
  const int halo = S * (K - 1);
  const int len0 = tile + halo;
  const int tap_plane = 2 * tz_tap_words(nh);
  uint32_t* tapw = reinterpret_cast<uint32_t*>(smem4);
  const int RB = wg_rows(nh);
  const uint32_t half_bytes = (uint32_t)RB * 128;
  const uint32_t plane_bytes = 2 * half_bytes;
  char* in = reinterpret_cast<char*>(smem4) + wg_tap_bytes(NPL, nh);
  char* out = in + NPL * plane_bytes;
  const int row = blockIdx.y;
  const int64_t t0 = (int64_t)blockIdx.x * tile;
  const float* xr = x + (int64_t)row * n;
  float* yr = y + (int64_t)row * n;

  tz_stage_taps<NPL>(tapw, taps, K, nh);
  for (int q2 = tid; q2 < RB * (TZ_N / 2); q2 += TZ_THREADS) {
    const int q = q2 / (TZ_N / 2), c = (q2 % (TZ_N / 2)) * 2;
    __nv_bfloat16 hi[2], lo[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int pos = q * TZ_N + c + e;
      const int64_t sidx = t0 - halo + pos;
      split_bf16((pos < len0 && sidx >= 0 && sidx < n) ? xr[sidx] : 0.f, hi[e],
                 lo[e]);
    }
    const uint32_t off = wg_chunk(0, half_bytes, q, c >> 3) + (c & 7) * 2;
    *reinterpret_cast<uint32_t*>(in + off) = pack_bf16(hi[0], hi[1]);
    *reinterpret_cast<uint32_t*>(out + off) = 0u;
    if (NPL == 2) {
      *reinterpret_cast<uint32_t*>(in + plane_bytes + off) =
          pack_bf16(lo[0], lo[1]);
      *reinterpret_cast<uint32_t*>(out + plane_bytes + off) = 0u;
    }
  }
  const int g0 = lane >> 2;
  const int cb = (warp >> 2) * 64 + (warp & 3) * 16;
  const uint32_t* tw = wg_lane_taps(tapw, nh, cb);

  for (int st = 0; st < S; ++st) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const bool last = st == S - 1;
    float acc[64];
    wg_toeplitz<NPL>(acc, smem_addr(in), half_bytes, plane_bytes, tw, tap_plane,
                     nh);
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * i + 2 * (lane & 3) + (e & 1);
        const int c = cb + g0 + 8 * (e >> 1);
        const float v = acc[4 * i + e];
        if (last) {
          const int j = r * TZ_N + c;
          if (j < tile && t0 + j < n) yr[t0 + j] = v;
        } else {
          __nv_bfloat16 hi, lo;
          split_bf16(v, hi, lo);
          const uint32_t off = wg_chunk(0, half_bytes, r, c >> 3) + (c & 7) * 2;
          *reinterpret_cast<__nv_bfloat16*>(out + off) = hi;
          if (NPL == 2)
            *reinterpret_cast<__nv_bfloat16*>(out + plane_bytes + off) = lo;
        }
      }
    char* tmp = in;
    in = out;
    out = tmp;
  }
}

size_t tile_smem(int precision, int threads, int decim, int kblk, int cplx) {
  const size_t npl = precision == BF16X3 ? 2 : 1;
  const int q8 = tile_q8(decim, kblk);
  return sizeof(float) * npl * decim *
         ((size_t)cx_nt(cplx) * q8 +
          (size_t)cx_nc(cplx) * tile_row(threads * R8, q8));
}

size_t cascade_smem(int precision, int K, int S, int tile) {
  const size_t npl = precision == BF16X3 ? 2 : 1;
  return sizeof(float) * npl *
         ((size_t)round8(K) + 2 * (size_t)cascade_cap(K, S, tile));
}

template <int P, typename XT, int C>
cudaError_t launch_tile(const void* x, const float* taps, float* y, int B,
                        int total, int G, int K, int decim, int lead, int nout,
                        int threads, int kblk, cudaStream_t stream) {
  using T = typename Elem<XT, C>::T;
  const size_t smem = tile_smem(P, threads, decim, kblk, C);
  auto kern = fir_tile_kernel<P, T, C>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int tile = threads * R8;
  dim3 grid((nout + tile - 1) / tile, B);
  kern<<<grid, threads, smem, stream>>>(static_cast<const T*>(x), taps, y,
                                        total, G, K, decim, lead, nout, kblk);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_tile_c(const void* x, const float* taps, float* y, int B,
                          int total, int G, int K, int decim, int lead,
                          int nout, int threads, int kblk, int cplx,
                          cudaStream_t s) {
  switch (cplx) {
    case REAL:
      return launch_tile<P, float, REAL>(x, taps, y, B, total, G, K, decim,
                                         lead, nout, threads, kblk, s);
    case CCF:
      return launch_tile<P, float, CCF>(x, taps, y, B, total, G, K, decim,
                                        lead, nout, threads, kblk, s);
    case CCC:
      return launch_tile<P, float, CCC>(x, taps, y, B, total, G, K, decim,
                                        lead, nout, threads, kblk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int P>
cudaError_t launch_cascade(const float* x, const float* taps, float* y, int B,
                           int n, int K, int S, int tile, int threads,
                           cudaStream_t stream) {
  if (tile < R8 || tile % R8) return cudaErrorInvalidValue;
  const size_t smem = cascade_smem(P, K, S, tile);
  auto kern = fir_cascade_kernel<P>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + tile - 1) / tile, B);
  kern<<<grid, threads, smem, stream>>>(x, taps, y, n, K, S, tile);
  return cudaGetLastError();
}

size_t toeplitz_smem(int precision, int K) {
  const size_t npl = precision == BF16X3 ? 2 : 1;
  const int nh = tz_nh(K);
  return wg_tap_bytes((int)npl, nh) + 2 * npl * 2 * (size_t)wg_rows(nh) * 128;
}

template <int P, typename XT>
cudaError_t launch_toeplitz(const void* x, const float* taps, void* scratch,
                            float* y, int B, int total, int G, int K, int lead,
                            int nout, int seg_rows, int nseg, int lrows,
                            cudaStream_t stream) {
  constexpr int NPL = Mode<P>::NPL;
  __nv_bfloat16* xp = static_cast<__nv_bfloat16*>(scratch);
  const int lcols = lrows * TZ_N;
  const int64_t plane_stride = (int64_t)B * lcols;
  dim3 sgrid((lcols / 8 + 255) / 256, B);
  fir_split_kernel<NPL, XT><<<sgrid, 256, 0, stream>>>(
      static_cast<const XT*>(x), xp, plane_stride, total, lead, lcols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = toeplitz_smem(P, K);
  auto kern = fir_toeplitz_kernel<NPL>;
  err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(nseg, B), TZ_THREADS, smem, stream>>>(xp, taps, y, plane_stride,
                                                    lrows, G, K, nout, seg_rows);
  return cudaGetLastError();
}

size_t cascade_mma_smem(int precision, int K) {
  return toeplitz_smem(precision, K);  // taps and two buffers, as the tile route
}

template <int P>
cudaError_t launch_cascade_mma(const float* x, const float* taps, float* y,
                               int B, int n, int K, int S, int tile,
                               cudaStream_t stream) {
  if (tile + S * (K - 1) > TZ_RG * TZ_N) return cudaErrorInvalidValue;
  const size_t smem = cascade_mma_smem(P, K);
  auto kern = fir_cascade_mma_kernel<Mode<P>::NPL>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + tile - 1) / tile, B);
  kern<<<grid, TZ_THREADS, smem, stream>>>(x, taps, y, n, K, S, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of each kernel uses (the wrapper sizes its
// launches with these).
size_t fir_tile_smem(int precision, int threads, int decim, int kblk,
                     int cplx) {
  return tile_smem(precision, threads, decim, kblk, cplx);
}

size_t fir_cascade_smem(int precision, int K, int S, int tile) {
  return cascade_smem(precision, K, S, tile);
}

// Real mode (cplx 0): x (B, total) float32 (x_bf16 == 0) or bfloat16
// (x_bf16 == 1, precision bf16 only), row-major contiguous; taps (G, K)
// float32; y (B, nout) float32.  ccf (cplx 1): x and y complex64, taps
// float32; ccc (cplx 2): x, taps and y complex64; the complex modes take no
// bf16 stream.
int fir_tile_fwd(const void* x, int x_bf16, const void* taps, void* y, int B,
                 int total, int G, int K, int decim, int lead, int nout,
                 int precision, int threads, int kblk, int cplx,
                 void* stream) {
  const float* t = static_cast<const float*>(taps);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (cplx < 0 || cplx > CCC || (x_bf16 && cplx)) return (int)err;
  if (x_bf16) {
    if (precision == BF16)
      err = launch_tile<BF16, __nv_bfloat16, REAL>(
          x, t, out, B, total, G, K, decim, lead, nout, threads, kblk, s);
  } else if (precision == F32) {
    err = launch_tile_c<F32>(x, t, out, B, total, G, K, decim, lead, nout,
                             threads, kblk, cplx, s);
  } else if (precision == BF16) {
    err = launch_tile_c<BF16>(x, t, out, B, total, G, K, decim, lead, nout,
                              threads, kblk, cplx, s);
  } else if (precision == BF16X3) {
    err = launch_tile_c<BF16X3>(x, t, out, B, total, G, K, decim, lead, nout,
                                threads, kblk, cplx, s);
  }
  return (int)err;
}

// The cascade's FMA route.  x, y: (B, n) float32 contiguous; taps: (K,)
// float32.
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

// The cascade's tensor-core route, bf16 or bf16x3.  x, y, taps as above; tile
// a multiple of 128 with tile + S*(K-1) <= 128*128.
int fir_cascade_mma_fwd(const void* x, const void* taps, void* y, int B, int n,
                        int K, int S, int tile, int precision, void* stream) {
  const float* in = static_cast<const float*>(x);
  const float* t = static_cast<const float*>(taps);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (precision == BF16)
    err = launch_cascade_mma<BF16>(in, t, out, B, n, K, S, tile, s);
  else if (precision == BF16X3)
    err = launch_cascade_mma<BF16X3>(in, t, out, B, n, K, S, tile, s);
  return (int)err;
}

// Shared-memory bytes one block of the tensor-core route uses.
size_t fir_toeplitz_smem(int precision, int K) {
  return toeplitz_smem(precision, K);
}

int fir_toeplitz_rows_per_pass() { return TZ_RG; }

// The tensor-core route of the single-stage FIR at decimation 1, bf16 or
// bf16x3.  x: (B, total) float32 or bfloat16; taps: (G, K) float32; scratch:
// planes * B * lrows * 128 bfloat16 (planes = 2 in bf16x3, else 1); y:
// (B, nout) float32.  Output rows of 128 are cut into nseg segments of
// seg_rows (a multiple of fir_toeplitz_rows_per_pass()) and
// lrows >= nseg * seg_rows + ceil((K + 127) / 128) - 1.
int fir_toeplitz_fwd(const void* x, int x_bf16, const void* taps,
                     void* scratch, void* y, int B, int total, int G, int K,
                     int lead, int nout, int precision, int seg_rows, int nseg,
                     int lrows, void* stream) {
  const float* t = static_cast<const float*>(taps);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (x_bf16) {
    if (precision == BF16)
      err = launch_toeplitz<BF16, __nv_bfloat16>(x, t, scratch, out, B, total,
                                                 G, K, lead, nout, seg_rows,
                                                 nseg, lrows, s);
  } else if (precision == BF16) {
    err = launch_toeplitz<BF16, float>(x, t, scratch, out, B, total, G, K,
                                       lead, nout, seg_rows, nseg, lrows, s);
  } else if (precision == BF16X3) {
    err = launch_toeplitz<BF16X3, float>(x, t, scratch, out, B, total, G, K,
                                         lead, nout, seg_rows, nseg, lrows, s);
  }
  return (int)err;
}

const char* fir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
