// The decimating single-stage FIR on Hopper: the two kernels and their
// launches.  fir_decim.cu instantiates the FMA route and fir_decim_mma.cu
// the tensor-core route, each built for sm_90a into a library of its own by
// ops/_build.py, so that their nvcc runs go side by side.
//
// Replaces the decimating paths of the TPU kernel
// grtpu/ops/pallas_fir.py::_cascade_kernel (pallas_fir.py:70-191) as
// _single_stage launches it through _phase_batched (:449-493): fir_decim,
// fir_decim_c, fir_decim_cc at decimation > 1, and fir_decim_c /
// fir_decim_cc at decimation 1 on the tensor cores.
//   * fir_decim_fwd     — the FMA route: f32 always, bf16 and bf16x3 for
//                         filters too short for the tensor cores.
//   * fir_decim_mma_fwd — bf16 and bf16x3 on the tensor cores.
// Both have an instance for decimation 1, where a tile of the tensor-core
// route is 128 consecutive outputs, 16 windows 8 samples apart.
//
// Contract (as fir_tile_fwd):
//   y[row, i] = sum_k taps[row % G, k] * x[row, i*decim + K-1-k - lead]
// with x read as zero outside [0, total).
//
// Complex modes (`cplx`, both kernels): 0 real; 1 ccf, a complex64 stream
// (x and y read and written as float2) against real taps; 2 ccc, complex64
// taps too.  The stream is read from device memory once, interleaved, and
// split into a re and an im plane between the load and shared memory; ccc
// keeps the taps' two planes apart as well.  Each (stream plane, tap plane)
// pair is one real sum computed as the real mode computes it, and ccc
// combines the four in registers before the store:
//   y = (re.tr - im.ti) + j (re.ti + im.tr),
// grtpu's yr[:c] - yi[c:], yi[:c] + yr[c:] over its stacked planes.
//
// What bounds it: 2K FLOP an output against 4*decim bytes of input (real;
// ccf twice the FLOP on 8*decim bytes, ccc four times).  The WBFM audio
// filter (155 taps, decimate by 8) is at ~10 FLOP/byte, below the card's
// ridges (~20 for float32 FMA, ~295 for bf16 MMA): bound by bytes; its ccc
// form sits near the float32 ridge.  One chunk of one station (65,536
// samples) is bound by latency: a launch, a load and a short serial chain.
//
// The load ring (both kernels).  A block walks `tpb` consecutive tiles of one
// row.  Each tile's input window lands, raw and in time order, in one of
// three stages of shared memory through 16-byte cp.async (four real samples,
// two complex ones), requested two tiles ahead, so the next windows are in
// flight while this one is computed.  A window starts at any sample (the
// lead, an odd row length), so a stage starts at the 16-byte boundary at or
// below the window and the kernel keeps the shift; chunks that straddle the
// ends of the tensor are read by element (a complex sample is half a
// chunk), and chunks outside the row are not read at all: the zeros outside
// [0, total) are made when the stage is taken out, not in device memory.
// Windows of neighbouring tiles overlap by K-1 samples, which the second
// reader finds in L2.  Where the three stages and the rest of a block do not
// fit shared memory (long filters at high decimations, complex streams
// first), the block has no ring and takes each window out of device memory
// directly, four loads a thread in flight: chosen by shape at launch
// (decim_fits), as the Python planner mirrors it.
//
// The FMA route takes a stage out into a phase-major window (offset w at row
// w % decim, column w / decim, rows skewed as slide8 wants them), split into
// the mode's planes on the way, and walks the taps phase by phase with the
// inner loop of the other FMA kernels, once for each (stream plane, tap
// plane) pair.  The phases are dealt to `kp` groups of 128 / kp threads, 8
// outputs a thread, and the groups' sums meet in shared memory, in the
// window's space once it is read: a tile is 256 outputs at kp = 4, which
// keeps a block's three stages small enough for six blocks an SM in f32
// (three for a complex stream).
//
// The tensor-core route.  For 8 consecutive outputs, the window of 8*decim +
// K-1 samples against the strided Toeplitz matrix
//   T[c, o] = h[c - o*decim],  h[m] = taps[K-1-m] (0 off the taps),
// is a (1 x window) by (window x 8) product; 16 such segments, 8*decim
// samples apart, are the rows of A in mma.sync.m16n8k16 (bf16 operands,
// float32 sums), and a k-step is 16 window positions.  Work done over useful
// work is (8*decim + K-1) / K: 1.33 at decimation 8 and 193 taps.  (wgmma
// as the decimation-1 route arranges it, the Toeplitz matrix as its 64-row
// register operand, would do 64*decim + K-1 over K, 3.6x, in tiles of 64 x N
// outputs that one chunk cannot fill.)  Neither matrix is built:
//   * A is the stream itself.  Row s of a tile is the window at sample
//     s*8*decim, so a fragment register is two consecutive bf16 samples.  A
//     stage is taken out once into bf16 planes (hi, and lo in bf16x3; re and
//     im of a complex stream: the split happens here, between the load and
//     shared memory, and the stream is read from device memory once), with 8
//     entries of padding after every 8*decim at decimations 2, 4 and 8, so
//     that the 8 row addresses of an ldmatrix fall on 8 different 16-byte
//     bank groups (at decimation 1 they do without).
//   * B's fragment register is two consecutive reversed taps, read straight
//     from the tap vector in shared memory (kept at both parities for odd
//     decimations): output column o moves the tap index by decim.
// A complex stream's re and im tiles share every B register (ccf: two
// accumulators a tile, twice the mma a k-step; ccc: four).
// One warp computes one 16 x 8 tile of 128 outputs over its share of the
// k-steps; `mtb` tiles a block and 4 / mtb warps a tile, whose sums meet in
// shared memory, in the planes' space once they are read.  A lone chunk runs
// as blocks of fewer than 128 outputs (`to`), so that one row of 8,192
// outputs fills the card.
//
// Precision modes as in fir_tile.cu.  Sum order on the tensor cores: one
// float32 accumulator per output and sum takes the k-steps in ascending
// window position; in bf16x3 each k-step adds hi*hi, then hi*lo, then lo*hi.

#pragma once

#include "fir_common.cuh"

namespace {

constexpr int DC_THREADS = 128;
constexpr int DC_STAGES = 3;

// ------------------------------------------------------------ the load ring
// Bytes of one stage for a window of wl samples of es bytes: the window, the
// shift to its 16-byte boundary and the last chunk's tail.
__host__ __device__ __forceinline__ int ring_stage_bytes(int wl, int es) {
  const int per = 16 / es;
  return (wl + 2 * per + per - 1) / per * 16;
}

// Elements between the 16-byte boundary at or below x + e0 and x + e0.
template <typename XT>
__device__ __forceinline__ int ring_shift(const XT* x, int64_t e0) {
  return (int)((reinterpret_cast<uintptr_t>(x) +
                (uint64_t)e0 * sizeof(XT)) & 15) / (int)sizeof(XT);
}

// Request the wl samples from element e0 of x (nelem elements in all) into a
// stage; r0 is the row's first element, total its length.  Stage entry
// ring_shift(x, e0) + w is sample w of the window where that sample lies in
// the row; other entries are not written.
template <typename XT>
__device__ __forceinline__ void ring_issue(XT* stage, const XT* x,
                                           int64_t nelem, int64_t e0, int wl,
                                           int64_t r0, int total) {
  constexpr int PER = 16 / sizeof(XT);
  const int sh = ring_shift(x, e0);
  const int64_t a0 = e0 - sh;
  const int nch = (sh + wl + PER - 1) / PER;
  if (a0 >= r0 && a0 + (int64_t)nch * PER <= r0 + total) {
    // the whole stage lies inside the row: nothing to test chunk by chunk
    const XT* src = x + a0;
    const uint32_t dst = smem_addr(stage);
    for (int c = threadIdx.x; c < nch; c += DC_THREADS)
      cp_async16(dst + 16 * c, src + c * PER);
    return;
  }
  for (int c = threadIdx.x; c < nch; c += DC_THREADS) {
    const int64_t ge = a0 + (int64_t)c * PER;
    if (ge + PER <= r0 || ge >= r0 + total) continue;
    if (ge >= 0 && ge + PER <= nelem) {
      cp_async16(smem_addr(stage + c * PER), x + ge);
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e)
        if (ge + e >= 0 && ge + e < nelem) stage[c * PER + e] = x[ge + e];
    }
  }
}

template <int D> struct Log2 {
  static constexpr int value = D == 8 ? 3 : D == 4 ? 2 : D == 2 ? 1 : 0;
};

// Samples w and w + 1 (w even) of a window whose first sample is src[0], as
// v[plane][0..1]; `even`: src + w is 8-byte (float), 4-byte (bf16) or
// 16-byte (complex) aligned.
__device__ __forceinline__ void load_pair(const float* src, int w, bool even,
                                          float (&v)[2][2]) {
  if (even) {
    const float2 p = *reinterpret_cast<const float2*>(src + w);
    v[0][0] = p.x;
    v[0][1] = p.y;
  } else {
    v[0][0] = src[w];
    v[0][1] = src[w + 1];
  }
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* src, int w,
                                          bool even, float (&v)[2][2]) {
  if (even) {
    const float2 p = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src + w));
    v[0][0] = p.x;
    v[0][1] = p.y;
  } else {
    v[0][0] = __bfloat162float(src[w]);
    v[0][1] = __bfloat162float(src[w + 1]);
  }
}
__device__ __forceinline__ void load_pair(const float2* src, int w, bool even,
                                          float (&v)[2][2]) {
  float4 p;
  if (even) {
    p = *reinterpret_cast<const float4*>(src + w);
  } else {
    const float2 a = src[w], b = src[w + 1];
    p = make_float4(a.x, a.y, b.x, b.y);
  }
  v[0][0] = p.x;
  v[1][0] = p.y;
  v[0][1] = p.z;
  v[1][1] = p.w;
}

// ------------------------------------------------------------ the FMA route
// Taps per phase, padded to slide8's step.
__host__ __device__ __forceinline__ int dc_q8(int K, int d) {
  return round8((K + d - 1) / d);
}
// Floats of one phase row of the window for `to` outputs: to + q8 + 8 columns
// (slide8 reads 15 past the last output's last tap), skewed.  For
// decimations 2, 4, 8 the row length is also chosen so that 32 consecutive
// samples, which go to `decim` rows, are stored to 32 different banks.
__host__ __device__ __forceinline__ int dc_row(int to, int q8, int D) {
  int ep = round4(skew(to + q8 + 8));
  if (D == 2 || D == 4 || D == 8)
    while (ep % (64 / D) != 32 / D) ep += 4;
  return ep;
}

size_t decim_smem(int precision, int es, int K, int d, int kp, int cplx,
                  bool ring) {
  const size_t npl = precision == BF16X3 ? 2 : 1;
  const int to = DC_THREADS / kp * R8;
  const int q8 = dc_q8(K, d);
  const int D = (d == 2 || d == 4 || d == 8) ? d : 0;
  const size_t ns = (size_t)cx_nc(cplx) * cx_nt(cplx);
  const size_t win = npl * d * (size_t)cx_nc(cplx) * dc_row(to, q8, D);
  const size_t sums = ns * DC_THREADS * R8;  // in the window's space
  return (ring ? (size_t)DC_STAGES * ring_stage_bytes((to - 1) * d + K, es)
               : 0) +
         sizeof(float) *
             (npl * d * (size_t)cx_nt(cplx) * q8 + (win > sums ? win : sums));
}

// Take a stage (src[w] = sample w of the window; samples of the row are
// those with 0 <= s0 + w < total, all of them if INSIDE) out into the
// phase-major window: sample w to row w % d, skewed column w / d, every plane
// of the mode (stream plane a, precision plane l at plane a * NPL + l),
// zeros from the window's end to the rows' ends.  Four samples a thread are
// read before any is stored.
template <int P, int NC, typename XT, int D, bool INSIDE>
__device__ __forceinline__ void dc_take(float* winb, const XT* src, int wl,
                                        int64_t s0, int total, int d, int E,
                                        int EP) {
  constexpr int NPL = Mode<P>::NPL;
  const int tid = threadIdx.x;
  const int wtot = d * E;
  int p = D ? 0 : tid % d, q = D ? 0 : tid / d;
  const int dp = D ? 0 : DC_THREADS % d, dq = D ? 0 : DC_THREADS / d;
  for (int w0 = tid; w0 < wtot; w0 += LOADS * DC_THREADS) {
    float xv[LOADS][2];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int w = w0 + u * DC_THREADS;
      const int64_t s = s0 + w;
      xv[u][0] = xv[u][1] = 0.f;
      if (w < wl && (INSIDE || (s >= 0 && s < total))) sample(src, w, xv[u]);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int w = w0 + u * DC_THREADS;
      if (w >= wtot) break;
      if (D) {
        p = w & (D - 1);
        q = w >> Log2<D>::value;
      }
      const int at = p * EP + skew(q);
#pragma unroll
      for (int a = 0; a < NC; ++a) {
        float v[2];
        Mode<P>::split(xv[u][a], v);
#pragma unroll
        for (int l = 0; l < NPL; ++l) winb[(a * NPL + l) * d * EP + at] = v[l];
      }
      if (!D) {
        p += dp;
        q += dq;
        if (p >= d) {
          p -= d;
          ++q;
        }
      }
    }
  }
}

template <int P, typename XT, int D, int C>
__global__ void __launch_bounds__(DC_THREADS)
fir_decim_kernel(const XT* __restrict__ x, const float* __restrict__ taps,
                 float* __restrict__ y, int64_t nelem, int total, int G, int K,
                 int decim, int lead, int nout, int kp, int tpb, bool ring) {
  constexpr int NPL = Mode<P>::NPL;
  constexpr int NC = Cx<C>::NC, NT = Cx<C>::NT, NS = Cx<C>::NS;
  extern __shared__ float4 smem4[];
  const int d = D ? D : decim;
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int nth = DC_THREADS / kp;  // threads a phase group
  const int to = nth * R8;
  const int q8 = dc_q8(K, d);
  const int E = to + q8 + 8;
  const int EP = dc_row(to, q8, D);
  const int wl = (to - 1) * d + K;  // samples a tile's window spans
  const int sbytes = ring ? ring_stage_bytes(wl, sizeof(XT)) : 0;
  char* stages = reinterpret_cast<char*>(smem4);
  float* tapb = reinterpret_cast<float*>(stages + DC_STAGES * sbytes);
  float* winb = tapb + NT * NPL * d * q8;
  float* red = winb;  // the groups' sums take the window's space once read
  const int tile0 = blockIdx.x * tpb;
  const int ntile = min(tpb, (nout + to - 1) / to - tile0);
  const int64_t r0 = (int64_t)row * total;

  auto issue = [&](int t) {
    if (ring && t < ntile)
      ring_issue(reinterpret_cast<XT*>(stages + (t % DC_STAGES) * sbytes), x,
                 nelem, r0 + (int64_t)(tile0 + t) * to * d - lead, wl, r0,
                 total);
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < DC_STAGES; ++t) issue(t);

  // tap m = q*d + p of the reversed filter at row p, column q; tap plane b,
  // precision plane l at plane b * NPL + l
  for (int idx = tid; idx < d * q8; idx += DC_THREADS) {
    const int p = idx / q8, q = idx - p * q8;
    float t[2];
    tap_planes<C>(taps, row % G, K, q * d + p, t);
#pragma unroll
    for (int b = 0; b < NT; ++b) {
      float v[2];
      Mode<P>::split(t[b], v);
#pragma unroll
      for (int l = 0; l < NPL; ++l) tapb[(b * NPL + l) * d * q8 + idx] = v[l];
    }
  }

  const int ot = tid % nth, pg = tid / nth;
  float* yr = y + (int64_t)row * nout * NC;
  for (int t = 0; t < ntile; ++t) {
    cp_async_wait<DC_STAGES - 1>();
    // stage t has landed; the last tile's window and sums are read no more
    __syncthreads();
    const int i0 = (tile0 + t) * to;
    const int64_t s0 = (int64_t)i0 * d - lead;
    // sample 0 of the window: in its stage, or in device memory
    const XT* src =
        ring ? reinterpret_cast<const XT*>(stages + (t % DC_STAGES) * sbytes) +
                   ring_shift(x, r0 + s0)
             : x + r0 + s0;
    // take the window out into the phase-major window
    if (s0 >= 0 && s0 + wl <= total)
      dc_take<P, NC, XT, D, true>(winb, src, wl, s0, total, d, E, EP);
    else
      dc_take<P, NC, XT, D, false>(winb, src, wl, s0, total, d, E, EP);
    __syncthreads();
    issue(t + DC_STAGES);  // into the stage just taken out

    float acc[NS][R8];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int r = 0; r < R8; ++r) acc[s][r] = 0.f;
    for (int ph = pg; ph < d; ph += kp) {
#pragma unroll
      for (int a = 0; a < NC; ++a)
#pragma unroll
        for (int b = 0; b < NT; ++b) {
          const float* tp[NPL];
          const float* wp[NPL];
#pragma unroll
          for (int l = 0; l < NPL; ++l) {
            tp[l] = tapb + (b * NPL + l) * d * q8 + ph * q8;
            wp[l] = winb + (a * NPL + l) * d * EP + ph * EP;
          }
          slide8<P>(acc[a * NT + b], tp, wp, ot * R8, q8);
        }
    }
    __syncthreads();  // the window is read no more
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float* rp = red + (s * kp + pg) * to + ot * R8;
      st4(rp, acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
      st4(rp + 4, acc[s][4], acc[s][5], acc[s][6], acc[s][7]);
    }
    __syncthreads();
    for (int j = tid; j < to; j += DC_THREADS) {
      if (i0 + j >= nout) break;
      float v[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        v[s] = red[s * kp * to + j];
        for (int g = 1; g < kp; ++g) v[s] += red[(s * kp + g) * to + j];
      }
      store_out<C>(yr, i0 + j, v);
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------- the tensor-core route
// k-steps of 16 window positions that 8 outputs' window spans.
__host__ __device__ __forceinline__ int dm_ksteps(int K, int d) {
  return (8 * d + K - 1 + 15) / 16;
}
// Samples a block's mtb tiles of 16 segments read: the last segment's start
// and its k-steps.
__host__ __device__ __forceinline__ int dm_window(int K, int d, int mtb) {
  return (16 * mtb - 1) * 8 * d + 16 * dm_ksteps(K, d);
}
// bf16 entries of one plane of the stream: the window and its padding (at
// decimations 2, 4 and 8; at decimation 1 the segments are 16 bytes apart,
// which puts an ldmatrix's 8 rows on 8 bank groups without it).
__host__ __device__ __forceinline__ int dm_plane(int K, int d, int mtb, int D) {
  const int wb = dm_window(K, d, mtb);
  return round8(wb + (D > 1 ? (wb / (8 * d) + 1) * 8 : 0));
}
// hs[i] = h[i - dm_off(d)]: the lowest tap index a fragment reads is -7*d.
__host__ __device__ __forceinline__ int dm_off(int d) { return (7 * d + 1) & ~1; }
// 32-bit words of one parity copy of hs, a whole number of 32 banks plus 16 so
// that the two copies, read together by a warp at odd decimations, differ.
__host__ __device__ __forceinline__ int dm_tap_words(int K, int d) {
  const int nw = (dm_off(d) + 16 * dm_ksteps(K, d) + 2) / 2 + 1;
  return (nw + 31) / 32 * 32 + 16;
}

size_t decim_mma_smem(int precision, int es, int K, int d, int mtb, int cplx,
                      bool ring) {
  const size_t npl = precision == BF16X3 ? 2 : 1;
  const int D = (d == 2 || d == 4 || d == 8) ? d : 0;
  const size_t ns = (size_t)cx_nc(cplx) * cx_nt(cplx);
  const size_t planes = npl * 2 * (size_t)cx_nc(cplx) * dm_plane(K, d, mtb, D);
  const size_t sums = sizeof(float) * ns * DC_THREADS * 4;  // in the planes'
  return (ring ? (size_t)DC_STAGES *
                     ring_stage_bytes(dm_window(K, d, mtb), es)
               : 0) +
         (planes > sums ? planes : sums) +
         npl * 2 * 4 * (size_t)cx_nt(cplx) * dm_tap_words(K, d);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8 float32) += a (16 x 16 bf16, row-major) * b (16 x 8 bf16, column)
__device__ __forceinline__ void mma_m16n8k16(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Take a stage (src[w] = sample w of the window; samples of the row are
// those with 0 <= s0 + w < total, all of them if INSIDE) out into the padded
// bf16 planes at wk (stream plane a, precision plane l at plane a * NPL + l),
// two samples a word, four words a thread read before any is stored.
template <int NPL, int NC, typename XT, int D, bool INSIDE>
__device__ __forceinline__ void dm_take(uint32_t* wk, int plane, const XT* src,
                                        bool even, int wb, int64_t s0,
                                        int total) {
  constexpr int LOG = Log2<D>::value;
  for (int w0 = 2 * threadIdx.x; w0 < wb; w0 += 2 * LOADS * DC_THREADS) {
    float v[LOADS][2][2];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int w = w0 + u * 2 * DC_THREADS;
      v[u][0][0] = v[u][0][1] = v[u][1][0] = v[u][1][1] = 0.f;
      if (w < wb) {
        if (INSIDE) {
          load_pair(src, w, even, v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int64_t s = s0 + w + e;
            if (s >= 0 && s < total) {
              float one[2];
              sample(src, w + e, one);
#pragma unroll
              for (int a = 0; a < NC; ++a) v[u][a][e] = one[a];
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int w = w0 + u * 2 * DC_THREADS;
      if (w >= wb) break;
      const int at = (w + (D > 1 ? (w >> (3 + LOG)) * 8 : 0)) >> 1;
#pragma unroll
      for (int a = 0; a < NC; ++a) {
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(v[u][a][0], v[u][a][1]);
        wk[a * NPL * (plane / 2) + at] =
            *reinterpret_cast<const uint32_t*>(&hi);
        if (NPL == 2) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(
              v[u][a][0] - __low2float(hi), v[u][a][1] - __high2float(hi));
          wk[(a * NPL + 1) * (plane / 2) + at] =
              *reinterpret_cast<const uint32_t*>(&lo);
        }
      }
    }
  }
}

// One block = one row and tpb consecutive tiles of `to` outputs (at most
// 128 * mtb; a tile of fewer computes whole 16 x 8 products and keeps the
// first `to`).
template <int P, typename XT, int D, int C>
__global__ void __launch_bounds__(DC_THREADS)
fir_decim_mma_kernel(const XT* __restrict__ x, const float* __restrict__ taps,
                     float* __restrict__ y, int64_t nelem, int total, int G,
                     int K, int decim, int lead, int nout, int mtb, int to,
                     int tpb, bool ring) {
  constexpr int NPL = P == BF16X3 ? 2 : 1;
  constexpr int NC = Cx<C>::NC, NT = Cx<C>::NT, NS = Cx<C>::NS;
  constexpr int LOG = Log2<D>::value;
  extern __shared__ float4 smem4[];
  const int d = D ? D : decim;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y;
  const int ks = dm_ksteps(K, d);
  const int wb = dm_window(K, d, mtb);
  const int sbytes = ring ? ring_stage_bytes(wb, sizeof(XT)) : 0;
  const int plane = dm_plane(K, d, mtb, D);
  const int nwp = dm_tap_words(K, d);
  char* stages = reinterpret_cast<char*>(smem4);
  uint32_t* wk = reinterpret_cast<uint32_t*>(stages + DC_STAGES * sbytes);
  // the warps' sums take the planes' space once the planes are read
  float* red = reinterpret_cast<float*>(wk);
  uint32_t* tapw = wk + max(NC * NPL * (plane / 2), NS * DC_THREADS * 4);
  const int tile0 = blockIdx.x * tpb;
  const int ntile = min(tpb, (nout + to - 1) / to - tile0);
  const int64_t r0 = (int64_t)row * total;

  auto issue = [&](int t) {
    if (ring && t < ntile)
      ring_issue(reinterpret_cast<XT*>(stages + (t % DC_STAGES) * sbytes), x,
                 nelem, r0 + (int64_t)(tile0 + t) * to * d - lead, wb, r0,
                 total);
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < DC_STAGES; ++t) issue(t);

  // the tap words: E[w] = (hs[2w], hs[2w+1]), O[w] = (hs[2w+1], hs[2w+2]),
  // tap plane b, precision plane l at tapw + (b*NPL + l)*2*nwp (E then O)
  {
    const int off = dm_off(d);
    for (int w = tid; w < nwp; w += DC_THREADS) {
      __nv_bfloat16 hi[2][3], lo[2][3];
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        float t[2];
        tap_planes<C>(taps, row % G, K, 2 * w + u - off, t);
#pragma unroll
        for (int b = 0; b < NT; ++b) split_bf16(t[b], hi[b][u], lo[b][u]);
      }
#pragma unroll
      for (int b = 0; b < NT; ++b) {
        uint32_t* tb = tapw + b * NPL * 2 * nwp;
        tb[w] = pack_bf16(hi[b][0], hi[b][1]);
        tb[nwp + w] = pack_bf16(hi[b][1], hi[b][2]);
        if (NPL == 2) {
          tb[2 * nwp + w] = pack_bf16(lo[b][0], lo[b][1]);
          tb[3 * nwp + w] = pack_bf16(lo[b][1], lo[b][2]);
        }
      }
    }
  }

  // this warp's tile and its share of the k-steps
  const int kp = (DC_THREADS / 32) / mtb;
  const int mt = warp % mtb, kq = warp / mtb;
  const int kper = (ks + kp - 1) / kp;
  const int kk0 = kq * kper, kk1 = min(ks, kk0 + kper);
  const int g = lane >> 2, t4 = lane & 3;
  // B: the pair (hs[e], hs[e+1]) at e = 16*kk + 2*t4 - g*d + off is twl[8*kk]
  const int e0 = 2 * t4 - g * d + dm_off(d);
  const uint32_t* twl = tapw + (e0 & 1) * nwp + (e0 >> 1);
  // A: ldmatrix row address of this lane, in bf16 entries of a plane
  const int seg = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int abase = seg * (8 * d + (D > 1 ? 8 : 0)) + (lane >> 4) * 8;
  const uint32_t wk_addr = smem_addr(wk);
  float* yr = y + (int64_t)row * nout * NC;

  for (int t = 0; t < ntile; ++t) {
    cp_async_wait<DC_STAGES - 1>();
    // stage t has landed; the last tile's planes and sums are read no more
    __syncthreads();
    const int i0 = (tile0 + t) * to;
    const int64_t s0 = (int64_t)i0 * d - lead;
    // sample 0 of the window: in its stage, or in device memory (which has
    // the same address modulo 16)
    const int sh = ring_shift(x, r0 + s0);
    const XT* src =
        ring ? reinterpret_cast<const XT*>(stages + (t % DC_STAGES) * sbytes) +
                   sh
             : x + r0 + s0;
    // take the window out into the bf16 planes
    if (s0 >= 0 && s0 + wb <= total)
      dm_take<NPL, NC, XT, D, true>(wk, plane, src, (sh & 1) == 0, wb, s0,
                                    total);
    else
      dm_take<NPL, NC, XT, D, false>(wk, plane, src, (sh & 1) == 0, wb, s0,
                                     total);
    __syncthreads();
    issue(t + DC_STAGES);  // into the stage just taken out

    float acc[NS][4];
#pragma unroll
    for (int s = 0; s < NS; ++s)
      acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;
#pragma unroll 2
    for (int kk = kk0; kk < kk1; ++kk) {
      const int at = abase + 16 * kk + (D > 1 ? ((2 * kk) >> LOG) * 8 : 0);
      uint32_t ah[NC][4], al[NC][4];
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int a = 0; a < NC; ++a)
        ldmatrix_x4(ah[a], wk_addr + 2 * (a * NPL * plane + at));
#pragma unroll
      for (int b = 0; b < NT; ++b) {
        const uint32_t* tb = twl + b * NPL * 2 * nwp;
        bh[b][0] = tb[8 * kk];
        bh[b][1] = tb[8 * kk + 4];
        if (NPL == 2) {
          bl[b][0] = tb[2 * nwp + 8 * kk];
          bl[b][1] = tb[2 * nwp + 8 * kk + 4];
        }
      }
#pragma unroll
      for (int a = 0; a < NC; ++a) {
#pragma unroll
        for (int b = 0; b < NT; ++b)
          mma_m16n8k16(acc[a * NT + b], ah[a], bh[b][0], bh[b][1]);
        if (NPL == 2) {
          ldmatrix_x4(al[a], wk_addr + 2 * ((a * NPL + 1) * plane + at));
#pragma unroll
          for (int b = 0; b < NT; ++b) {
            mma_m16n8k16(acc[a * NT + b], ah[a], bl[b][0], bl[b][1]);
            mma_m16n8k16(acc[a * NT + b], al[a], bh[b][0], bh[b][1]);
          }
        }
      }
    }
    __syncthreads();  // the planes are read no more
    // acc[s]: outputs 8*g + 2*t4 (+1) and 8*(g + 8) + 2*t4 (+1) of the tile
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float* rp = red + s * DC_THREADS * 4 + (kq * mtb + mt) * 128 + 8 * g +
                  2 * t4;
      *reinterpret_cast<float2*>(rp) = make_float2(acc[s][0], acc[s][1]);
      *reinterpret_cast<float2*>(rp + 64) = make_float2(acc[s][2], acc[s][3]);
    }
    __syncthreads();
    for (int j = tid; j < to; j += DC_THREADS) {
      if (i0 + j >= nout) break;
      float v[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float* rs = red + s * DC_THREADS * 4;
        v[s] = rs[j];
        for (int q = 1; q < kp; ++q) v[s] += rs[q * mtb * 128 + j];
      }
      store_out<C>(yr, i0 + j, v);
    }
  }
  cp_async_wait<0>();
}

// --------------------------------------------------------------- launches
// A block's ring and its shared memory: the ring where the block fits with
// it, else none (and the bytes without it).
template <typename F>
bool decim_fits(F smem_of, size_t& smem) {
  smem = smem_of(true);
  if (smem <= SMEM_OPTIN) return true;
  smem = smem_of(false);
  return false;
}

template <int P, typename XT, int D, int C>
cudaError_t launch_decim(const void* x, const float* taps, float* y, int B,
                         int total, int G, int K, int decim, int lead, int nout,
                         int kp, int tpb, cudaStream_t stream) {
  using T = typename Elem<XT, C>::T;
  size_t smem;
  const bool ring = decim_fits(
      [&](bool r) { return decim_smem(P, sizeof(T), K, decim, kp, C, r); },
      smem);
  auto kern = fir_decim_kernel<P, T, D, C>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int to = DC_THREADS / kp * R8;
  const int tiles = (nout + to - 1) / to;
  dim3 grid((tiles + tpb - 1) / tpb, B);
  kern<<<grid, DC_THREADS, smem, stream>>>(
      static_cast<const T*>(x), taps, y, (int64_t)B * total, total, G, K,
      decim, lead, nout, kp, tpb, ring);
  return cudaGetLastError();
}

template <int P, typename XT, int C>
cudaError_t launch_decim_d(const void* x, const float* taps, float* y, int B,
                           int total, int G, int K, int decim, int lead,
                           int nout, int kp, int tpb, cudaStream_t s) {
  switch (decim) {
    case 1:
      return launch_decim<P, XT, 1, C>(x, taps, y, B, total, G, K, decim,
                                       lead, nout, kp, tpb, s);
    case 2:
      return launch_decim<P, XT, 2, C>(x, taps, y, B, total, G, K, decim,
                                       lead, nout, kp, tpb, s);
    case 4:
      return launch_decim<P, XT, 4, C>(x, taps, y, B, total, G, K, decim,
                                       lead, nout, kp, tpb, s);
    case 8:
      return launch_decim<P, XT, 8, C>(x, taps, y, B, total, G, K, decim,
                                       lead, nout, kp, tpb, s);
    default:
      return launch_decim<P, XT, 0, C>(x, taps, y, B, total, G, K, decim,
                                       lead, nout, kp, tpb, s);
  }
}

template <int P>
cudaError_t launch_decim_c(const void* x, const float* taps, float* y, int B,
                           int total, int G, int K, int decim, int lead,
                           int nout, int kp, int tpb, int cplx,
                           cudaStream_t s) {
  switch (cplx) {
    case REAL:
      return launch_decim_d<P, float, REAL>(x, taps, y, B, total, G, K, decim,
                                            lead, nout, kp, tpb, s);
    case CCF:
      return launch_decim_d<P, float, CCF>(x, taps, y, B, total, G, K, decim,
                                           lead, nout, kp, tpb, s);
    case CCC:
      return launch_decim_d<P, float, CCC>(x, taps, y, B, total, G, K, decim,
                                           lead, nout, kp, tpb, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int P, typename XT, int D, int C>
cudaError_t launch_decim_mma(const void* x, const float* taps, float* y, int B,
                             int total, int G, int K, int decim, int lead,
                             int nout, int mtb, int to, int tpb,
                             cudaStream_t stream) {
  using T = typename Elem<XT, C>::T;
  size_t smem;
  const bool ring = decim_fits(
      [&](bool r) {
        return decim_mma_smem(P, sizeof(T), K, decim, mtb, C, r);
      },
      smem);
  auto kern = fir_decim_mma_kernel<P, T, D, C>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (nout + to - 1) / to;
  dim3 grid((tiles + tpb - 1) / tpb, B);
  kern<<<grid, DC_THREADS, smem, stream>>>(
      static_cast<const T*>(x), taps, y, (int64_t)B * total, total, G, K,
      decim, lead, nout, mtb, to, tpb, ring);
  return cudaGetLastError();
}

template <int P, typename XT, int C>
cudaError_t launch_decim_mma_d(const void* x, const float* taps, float* y,
                               int B, int total, int G, int K, int decim,
                               int lead, int nout, int mtb, int to, int tpb,
                               cudaStream_t s) {
  switch (decim) {
    case 1:
      return launch_decim_mma<P, XT, 1, C>(x, taps, y, B, total, G, K, decim,
                                           lead, nout, mtb, to, tpb, s);
    case 2:
      return launch_decim_mma<P, XT, 2, C>(x, taps, y, B, total, G, K, decim,
                                           lead, nout, mtb, to, tpb, s);
    case 4:
      return launch_decim_mma<P, XT, 4, C>(x, taps, y, B, total, G, K, decim,
                                           lead, nout, mtb, to, tpb, s);
    case 8:
      return launch_decim_mma<P, XT, 8, C>(x, taps, y, B, total, G, K, decim,
                                           lead, nout, mtb, to, tpb, s);
    default:
      return launch_decim_mma<P, XT, 0, C>(x, taps, y, B, total, G, K, decim,
                                           lead, nout, mtb, to, tpb, s);
  }
}

template <int P>
cudaError_t launch_decim_mma_c(const void* x, const float* taps, float* y,
                               int B, int total, int G, int K, int decim,
                               int lead, int nout, int mtb, int to, int tpb,
                               int cplx, cudaStream_t s) {
  switch (cplx) {
    case REAL:
      return launch_decim_mma_d<P, float, REAL>(x, taps, y, B, total, G, K,
                                                decim, lead, nout, mtb, to,
                                                tpb, s);
    case CCF:
      return launch_decim_mma_d<P, float, CCF>(x, taps, y, B, total, G, K,
                                               decim, lead, nout, mtb, to,
                                               tpb, s);
    case CCC:
      return launch_decim_mma_d<P, float, CCC>(x, taps, y, B, total, G, K,
                                               decim, lead, nout, mtb, to,
                                               tpb, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Bytes of one stream element: complex64 in the complex modes, else bf16 or
// float32.
int elem_bytes(int x_bf16, int cplx) { return cplx ? 8 : x_bf16 ? 2 : 4; }

}  // namespace
