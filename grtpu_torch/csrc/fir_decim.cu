// The decimating single-stage FIR on Hopper (built for sm_90a by
// ops/_build.py, beside fir_tile.cu).
//
// Replaces the decimating paths of the TPU kernel
// grtpu/ops/pallas_fir.py::_cascade_kernel (pallas_fir.py:70-191) as
// _single_stage launches it through _phase_batched (:449-493): fir_decim,
// fir_decim_c, fir_decim_cc at decimation > 1.
//   * fir_decim_fwd     — the FMA route: f32 always, bf16 and bf16x3 for
//                         filters too short for the tensor cores.
//   * fir_decim_mma_fwd — bf16 and bf16x3 on the tensor cores.
//
// Contract (as fir_tile_fwd):
//   y[row, i] = sum_k taps[row % G, k] * x[row, i*decim + K-1-k - lead]
// with x read as zero outside [0, total).
//
// What bounds it: 2K FLOP an output against 4*decim bytes of input.  The
// WBFM audio filter (155 taps, decimate by 8) is at ~10 FLOP/byte, below the
// card's ridges (~20 for float32 FMA, ~295 for bf16 MMA): bound by bytes.
// One chunk of one station (65,536 samples) is bound by latency: a launch, a
// load and a short serial chain.
//
// The load ring (both kernels).  A block walks `tpb` consecutive tiles of one
// row.  Each tile's input window lands, raw and in time order, in one of
// three stages of shared memory through 16-byte cp.async, requested two tiles
// ahead, so the next windows are in flight while this one is computed.  A
// window starts at any sample (the lead, an odd row length), so a stage
// starts at the 16-byte boundary at or below the window and the kernel keeps
// the shift; chunks that straddle the ends of the tensor are read by element,
// and chunks outside the row are not read at all: the zeros outside
// [0, total) are made when the stage is taken out, not in device memory.
// Windows of neighbouring tiles overlap by K-1 samples, which the second
// reader finds in L2.
//
// The FMA route takes a stage out into a phase-major window (offset w at row
// w % decim, column w / decim, rows skewed as slide8 wants them), split into
// the mode's planes on the way, and walks the taps phase by phase with the
// inner loop of the other FMA kernels.  The phases are dealt to `kp` groups
// of 128 / kp threads, 8 outputs a thread, and the groups' sums meet in
// shared memory: a tile is 256 outputs at kp = 4, which keeps a block's three
// stages small enough for five blocks an SM.
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
//     stage is taken out once into bf16 planes (hi, and lo in bf16x3: the
//     split happens here, between the load and shared memory, and the stream
//     is read from device memory once), with 8 entries of padding after every
//     8*decim, so that the 8 row addresses of an ldmatrix fall on 8 different
//     16-byte bank groups.
//   * B's fragment register is two consecutive reversed taps, read straight
//     from the tap vector in shared memory (kept at both parities for odd
//     decimations): output column o moves the tap index by decim.
// One warp computes one 16 x 8 tile of 128 outputs over its share of the
// k-steps; `mtb` tiles a block and 4 / mtb warps a tile, whose sums meet in
// shared memory.  A lone chunk runs as blocks of fewer than 128 outputs
// (`to`), so that one row of 8,192 outputs fills the card.
//
// Precision modes as in fir_tile.cu.  Sum order on the tensor cores: one
// float32 accumulator per output takes the k-steps in ascending window
// position; in bf16x3 each k-step adds hi*hi, then hi*lo, then lo*hi.

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

// Samples w and w + 1 (w even) of a window whose first sample is src[0];
// `even`: src is 8-byte (float) or 4-byte (bf16) aligned.
__device__ __forceinline__ void load_pair(const float* src, int w, bool even,
                                          float (&v)[2]) {
  if (even) {
    const float2 p = *reinterpret_cast<const float2*>(src + w);
    v[0] = p.x;
    v[1] = p.y;
  } else {
    v[0] = src[w];
    v[1] = src[w + 1];
  }
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* src, int w,
                                          bool even, float (&v)[2]) {
  if (even) {
    const float2 p = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src + w));
    v[0] = p.x;
    v[1] = p.y;
  } else {
    v[0] = __bfloat162float(src[w]);
    v[1] = __bfloat162float(src[w + 1]);
  }
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

size_t decim_smem(int precision, int es, int K, int d, int kp) {
  const size_t npl = precision == BF16X3 ? 2 : 1;
  const int to = DC_THREADS / kp * R8;
  const int q8 = dc_q8(K, d);
  const int D = (d == 2 || d == 4 || d == 8) ? d : 0;
  return (size_t)DC_STAGES * ring_stage_bytes((to - 1) * d + K, es) +
         sizeof(float) * (npl * d * ((size_t)q8 + dc_row(to, q8, D)) +
                          DC_THREADS * R8);
}

// Take a stage (src[w] = sample w of the window; samples of the row are
// those with 0 <= s0 + w < total, all of them if INSIDE) out into the
// phase-major window: sample w to row w % d, skewed column w / d, every plane
// of the mode, zeros from the window's end to the rows' ends.  Four samples a
// thread are read before any is stored.
template <int P, typename XT, int D, bool INSIDE>
__device__ __forceinline__ void dc_take(float* winb, const XT* src, int wl,
                                        int64_t s0, int total, int d, int E,
                                        int EP) {
  constexpr int NPL = Mode<P>::NPL;
  const int tid = threadIdx.x;
  const int wtot = d * E;
  int p = D ? 0 : tid % d, q = D ? 0 : tid / d;
  const int dp = D ? 0 : DC_THREADS % d, dq = D ? 0 : DC_THREADS / d;
  for (int w0 = tid; w0 < wtot; w0 += LOADS * DC_THREADS) {
    float xv[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int w = w0 + u * DC_THREADS;
      const int64_t s = s0 + w;
      xv[u] = (w < wl && (INSIDE || (s >= 0 && s < total))) ? load(src, w)
                                                            : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int w = w0 + u * DC_THREADS;
      if (w >= wtot) break;
      if (D) {
        p = w & (D - 1);
        q = w >> Log2<D>::value;
      }
      float v[2];
      Mode<P>::split(xv[u], v);
      const int at = p * EP + skew(q);
#pragma unroll
      for (int l = 0; l < NPL; ++l) winb[l * d * EP + at] = v[l];
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

template <int P, typename XT, int D>
__global__ void __launch_bounds__(DC_THREADS)
fir_decim_kernel(const XT* __restrict__ x, const float* __restrict__ taps,
                 float* __restrict__ y, int64_t nelem, int total, int G, int K,
                 int decim, int lead, int nout, int kp, int tpb) {
  constexpr int NPL = Mode<P>::NPL;
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
  const int sbytes = ring_stage_bytes(wl, sizeof(XT));
  char* ring = reinterpret_cast<char*>(smem4);
  float* tapb = reinterpret_cast<float*>(ring + DC_STAGES * sbytes);
  float* winb = tapb + NPL * d * q8;
  float* red = winb + NPL * d * EP;
  const int tile0 = blockIdx.x * tpb;
  const int ntile = min(tpb, (nout + to - 1) / to - tile0);
  const int64_t r0 = (int64_t)row * total;

  auto issue = [&](int t) {
    if (t < ntile)
      ring_issue(reinterpret_cast<XT*>(ring + (t % DC_STAGES) * sbytes), x,
                 nelem, r0 + (int64_t)(tile0 + t) * to * d - lead, wl, r0,
                 total);
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < DC_STAGES; ++t) issue(t);

  // tap m = q*d + p of the reversed filter at row p, column q
  const float* tr = taps + (int64_t)(row % G) * K;
  for (int idx = tid; idx < d * q8; idx += DC_THREADS) {
    const int p = idx / q8, q = idx - p * q8;
    const int m = q * d + p;
    float v[2];
    Mode<P>::split(m < K ? tr[K - 1 - m] : 0.f, v);
#pragma unroll
    for (int l = 0; l < NPL; ++l) tapb[l * d * q8 + idx] = v[l];
  }

  const int ot = tid % nth, pg = tid / nth;
  float* yr = y + (int64_t)row * nout;
  for (int t = 0; t < ntile; ++t) {
    cp_async_wait<DC_STAGES - 1>();
    // stage t has landed; the last tile's window and sums are read no more
    __syncthreads();
    const int i0 = (tile0 + t) * to;
    const int64_t s0 = (int64_t)i0 * d - lead;
    const XT* stage =
        reinterpret_cast<const XT*>(ring + (t % DC_STAGES) * sbytes);
    const int sh = ring_shift(x, r0 + s0);
    // take the stage out into the phase-major window
    if (s0 >= 0 && s0 + wl <= total)
      dc_take<P, XT, D, true>(winb, stage + sh, wl, s0, total, d, E, EP);
    else
      dc_take<P, XT, D, false>(winb, stage + sh, wl, s0, total, d, E, EP);
    __syncthreads();
    issue(t + DC_STAGES);  // into the stage just taken out

    float acc[R8];
#pragma unroll
    for (int r = 0; r < R8; ++r) acc[r] = 0.f;
    for (int ph = pg; ph < d; ph += kp) {
      const float* tp[NPL];
      const float* wp[NPL];
#pragma unroll
      for (int l = 0; l < NPL; ++l) {
        tp[l] = tapb + l * d * q8 + ph * q8;
        wp[l] = winb + l * d * EP + ph * EP;
      }
      slide8<P>(acc, tp, wp, ot * R8, q8);
    }
    st4(red + pg * to + ot * R8, acc[0], acc[1], acc[2], acc[3]);
    st4(red + pg * to + ot * R8 + 4, acc[4], acc[5], acc[6], acc[7]);
    __syncthreads();
    for (int j = tid; j < to; j += DC_THREADS) {
      if (i0 + j >= nout) break;
      float v = red[j];
      for (int g = 1; g < kp; ++g) v += red[g * to + j];
      yr[i0 + j] = v;
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
// bf16 entries of one plane of the stream: the window and its padding.
__host__ __device__ __forceinline__ int dm_plane(int K, int d, int mtb, int D) {
  const int wb = dm_window(K, d, mtb);
  return round8(wb + (D ? (wb / (8 * d) + 1) * 8 : 0));
}
// hs[i] = h[i - dm_off(d)]: the lowest tap index a fragment reads is -7*d.
__host__ __device__ __forceinline__ int dm_off(int d) { return (7 * d + 1) & ~1; }
// 32-bit words of one parity copy of hs, a whole number of 32 banks plus 16 so
// that the two copies, read together by a warp at odd decimations, differ.
__host__ __device__ __forceinline__ int dm_tap_words(int K, int d) {
  const int nw = (dm_off(d) + 16 * dm_ksteps(K, d) + 2) / 2 + 1;
  return (nw + 31) / 32 * 32 + 16;
}

size_t decim_mma_smem(int precision, int es, int K, int d, int mtb) {
  const size_t npl = precision == BF16X3 ? 2 : 1;
  const int D = (d == 2 || d == 4 || d == 8) ? d : 0;
  return (size_t)DC_STAGES * ring_stage_bytes(dm_window(K, d, mtb), es) +
         npl * (2 * (size_t)dm_plane(K, d, mtb, D) +
                2 * 4 * (size_t)dm_tap_words(K, d)) +
         sizeof(float) * DC_THREADS * 4;
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
// bf16 planes at wk, two samples a word, four words a thread read before any
// is stored.
template <int NPL, typename XT, int D, bool INSIDE>
__device__ __forceinline__ void dm_take(uint32_t* wk, int plane, const XT* src,
                                        bool even, int wb, int64_t s0,
                                        int total) {
  constexpr int LOG = Log2<D>::value;
  for (int w0 = 2 * threadIdx.x; w0 < wb; w0 += 2 * LOADS * DC_THREADS) {
    float v[LOADS][2];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int w = w0 + u * 2 * DC_THREADS;
      v[u][0] = v[u][1] = 0.f;
      if (w < wb) {
        if (INSIDE) {
          load_pair(src, w, even, v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int64_t s = s0 + w + e;
            if (s >= 0 && s < total) v[u][e] = load(src, w + e);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int w = w0 + u * 2 * DC_THREADS;
      if (w >= wb) break;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[u][0], v[u][1]);
      const int at = (w + (D ? (w >> (3 + LOG)) * 8 : 0)) >> 1;
      wk[at] = *reinterpret_cast<const uint32_t*>(&hi);
      if (NPL == 2) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            v[u][0] - __low2float(hi), v[u][1] - __high2float(hi));
        wk[plane / 2 + at] = *reinterpret_cast<const uint32_t*>(&lo);
      }
    }
  }
}

// One block = one row and tpb consecutive tiles of `to` outputs (at most
// 128 * mtb; a tile of fewer computes whole 16 x 8 products and keeps the
// first `to`).
template <int P, typename XT, int D>
__global__ void __launch_bounds__(DC_THREADS)
fir_decim_mma_kernel(const XT* __restrict__ x, const float* __restrict__ taps,
                     float* __restrict__ y, int64_t nelem, int total, int G,
                     int K, int decim, int lead, int nout, int mtb, int to,
                     int tpb) {
  constexpr int NPL = P == BF16X3 ? 2 : 1;
  constexpr int LOG = Log2<D>::value;
  extern __shared__ float4 smem4[];
  const int d = D ? D : decim;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y;
  const int ks = dm_ksteps(K, d);
  const int wb = dm_window(K, d, mtb);
  const int sbytes = ring_stage_bytes(wb, sizeof(XT));
  const int plane = dm_plane(K, d, mtb, D);
  const int nwp = dm_tap_words(K, d);
  char* ring = reinterpret_cast<char*>(smem4);
  uint32_t* wk = reinterpret_cast<uint32_t*>(ring + DC_STAGES * sbytes);
  uint32_t* tapw = wk + NPL * (plane / 2);
  float* red = reinterpret_cast<float*>(tapw + NPL * 2 * nwp);
  const int tile0 = blockIdx.x * tpb;
  const int ntile = min(tpb, (nout + to - 1) / to - tile0);
  const int64_t r0 = (int64_t)row * total;

  auto issue = [&](int t) {
    if (t < ntile)
      ring_issue(reinterpret_cast<XT*>(ring + (t % DC_STAGES) * sbytes), x,
                 nelem, r0 + (int64_t)(tile0 + t) * to * d - lead, wb, r0,
                 total);
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < DC_STAGES; ++t) issue(t);

  // the tap words: E[w] = (hs[2w], hs[2w+1]), O[w] = (hs[2w+1], hs[2w+2]),
  // plane l at tapw + l*2*nwp (E then O)
  {
    const float* tr = taps + (int64_t)(row % G) * K;
    const int off = dm_off(d);
    for (int w = tid; w < nwp; w += DC_THREADS) {
      __nv_bfloat16 hi[3], lo[3];
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int m = 2 * w + u - off;
        split_bf16((m >= 0 && m < K) ? tr[K - 1 - m] : 0.f, hi[u], lo[u]);
      }
      tapw[w] = pack_bf16(hi[0], hi[1]);
      tapw[nwp + w] = pack_bf16(hi[1], hi[2]);
      if (NPL == 2) {
        tapw[2 * nwp + w] = pack_bf16(lo[0], lo[1]);
        tapw[3 * nwp + w] = pack_bf16(lo[1], lo[2]);
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
  const int abase = seg * (8 * d + (D ? 8 : 0)) + (lane >> 4) * 8;
  const uint32_t wk_addr = smem_addr(wk);
  float* yr = y + (int64_t)row * nout;

  for (int t = 0; t < ntile; ++t) {
    cp_async_wait<DC_STAGES - 1>();
    // stage t has landed; the last tile's planes and sums are read no more
    __syncthreads();
    const int i0 = (tile0 + t) * to;
    const int64_t s0 = (int64_t)i0 * d - lead;
    const XT* stage =
        reinterpret_cast<const XT*>(ring + (t % DC_STAGES) * sbytes);
    const int sh = ring_shift(x, r0 + s0);
    // take the stage out into the bf16 planes
    if (s0 >= 0 && s0 + wb <= total)
      dm_take<NPL, XT, D, true>(wk, plane, stage + sh, (sh & 1) == 0, wb, s0,
                                total);
    else
      dm_take<NPL, XT, D, false>(wk, plane, stage + sh, (sh & 1) == 0, wb, s0,
                                 total);
    __syncthreads();
    issue(t + DC_STAGES);  // into the stage just taken out

    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int kk = kk0; kk < kk1; ++kk) {
      const int at = abase + 16 * kk + (D ? ((2 * kk) >> LOG) * 8 : 0);
      uint32_t ah[4];
      ldmatrix_x4(ah, wk_addr + 2 * at);
      const uint32_t bh0 = twl[8 * kk], bh1 = twl[8 * kk + 4];
      mma_m16n8k16(acc, ah, bh0, bh1);
      if (NPL == 2) {
        uint32_t al[4];
        ldmatrix_x4(al, wk_addr + 2 * (plane + at));
        mma_m16n8k16(acc, ah, twl[2 * nwp + 8 * kk], twl[2 * nwp + 8 * kk + 4]);
        mma_m16n8k16(acc, al, bh0, bh1);
      }
    }
    // acc: outputs 8*g + 2*t4 (+1) and 8*(g + 8) + 2*t4 (+1) of the tile
    float* rp = red + (kq * mtb + mt) * 128 + 8 * g + 2 * t4;
    *reinterpret_cast<float2*>(rp) = make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(rp + 64) = make_float2(acc[2], acc[3]);
    __syncthreads();
    for (int j = tid; j < to; j += DC_THREADS) {
      if (i0 + j >= nout) break;
      float v = red[j];
      for (int q = 1; q < kp; ++q) v += red[q * mtb * 128 + j];
      yr[i0 + j] = v;
    }
  }
  cp_async_wait<0>();
}

// --------------------------------------------------------------- launches
template <int P, typename XT, int D>
cudaError_t launch_decim(const void* x, const float* taps, float* y, int B,
                         int total, int G, int K, int decim, int lead, int nout,
                         int kp, int tpb, cudaStream_t stream) {
  const size_t smem = decim_smem(P, sizeof(XT), K, decim, kp);
  auto kern = fir_decim_kernel<P, XT, D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int to = DC_THREADS / kp * R8;
  const int tiles = (nout + to - 1) / to;
  dim3 grid((tiles + tpb - 1) / tpb, B);
  kern<<<grid, DC_THREADS, smem, stream>>>(
      static_cast<const XT*>(x), taps, y, (int64_t)B * total, total, G, K,
      decim, lead, nout, kp, tpb);
  return cudaGetLastError();
}

template <int P, typename XT>
cudaError_t launch_decim_d(const void* x, const float* taps, float* y, int B,
                           int total, int G, int K, int decim, int lead,
                           int nout, int kp, int tpb, cudaStream_t s) {
  switch (decim) {
    case 2:
      return launch_decim<P, XT, 2>(x, taps, y, B, total, G, K, decim, lead,
                                    nout, kp, tpb, s);
    case 4:
      return launch_decim<P, XT, 4>(x, taps, y, B, total, G, K, decim, lead,
                                    nout, kp, tpb, s);
    case 8:
      return launch_decim<P, XT, 8>(x, taps, y, B, total, G, K, decim, lead,
                                    nout, kp, tpb, s);
    default:
      return launch_decim<P, XT, 0>(x, taps, y, B, total, G, K, decim, lead,
                                    nout, kp, tpb, s);
  }
}

template <int P, typename XT, int D>
cudaError_t launch_decim_mma(const void* x, const float* taps, float* y, int B,
                             int total, int G, int K, int decim, int lead,
                             int nout, int mtb, int to, int tpb,
                             cudaStream_t stream) {
  const size_t smem = decim_mma_smem(P, sizeof(XT), K, decim, mtb);
  auto kern = fir_decim_mma_kernel<P, XT, D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (nout + to - 1) / to;
  dim3 grid((tiles + tpb - 1) / tpb, B);
  kern<<<grid, DC_THREADS, smem, stream>>>(
      static_cast<const XT*>(x), taps, y, (int64_t)B * total, total, G, K,
      decim, lead, nout, mtb, to, tpb);
  return cudaGetLastError();
}

template <int P, typename XT>
cudaError_t launch_decim_mma_d(const void* x, const float* taps, float* y,
                               int B, int total, int G, int K, int decim,
                               int lead, int nout, int mtb, int to, int tpb,
                               cudaStream_t s) {
  switch (decim) {
    case 2:
      return launch_decim_mma<P, XT, 2>(x, taps, y, B, total, G, K, decim,
                                        lead, nout, mtb, to, tpb, s);
    case 4:
      return launch_decim_mma<P, XT, 4>(x, taps, y, B, total, G, K, decim,
                                        lead, nout, mtb, to, tpb, s);
    case 8:
      return launch_decim_mma<P, XT, 8>(x, taps, y, B, total, G, K, decim,
                                        lead, nout, mtb, to, tpb, s);
    default:
      return launch_decim_mma<P, XT, 0>(x, taps, y, B, total, G, K, decim,
                                        lead, nout, mtb, to, tpb, s);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of each kernel uses (x_bf16: the stream's
// elements are 2 bytes, else 4).
size_t fir_decim_smem(int precision, int x_bf16, int K, int decim, int kp) {
  return decim_smem(precision, x_bf16 ? 2 : 4, K, decim, kp);
}

size_t fir_decim_mma_smem(int precision, int x_bf16, int K, int decim,
                          int mtb) {
  return decim_mma_smem(precision, x_bf16 ? 2 : 4, K, decim, mtb);
}

// The decimating FIR's FMA route.  x: (B, total) float32 (x_bf16 == 0) or
// bfloat16 (x_bf16 == 1, precision bf16 only), row-major contiguous; taps:
// (G, K) float32; y: (B, nout) float32.  kp in {1, 2, 4} phase groups a
// block, tpb >= 1 tiles of 1024 / kp outputs a block.
int fir_decim_fwd(const void* x, int x_bf16, const void* taps, void* y, int B,
                  int total, int G, int K, int decim, int lead, int nout,
                  int precision, int kp, int tpb, void* stream) {
  const float* t = static_cast<const float*>(taps);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (decim < 1 || tpb < 1 || (kp != 1 && kp != 2 && kp != 4)) return (int)err;
  if (x_bf16) {
    if (precision == BF16)
      err = launch_decim_d<BF16, __nv_bfloat16>(x, t, out, B, total, G, K,
                                                decim, lead, nout, kp, tpb, s);
  } else if (precision == F32) {
    err = launch_decim_d<F32, float>(x, t, out, B, total, G, K, decim, lead,
                                     nout, kp, tpb, s);
  } else if (precision == BF16) {
    err = launch_decim_d<BF16, float>(x, t, out, B, total, G, K, decim, lead,
                                      nout, kp, tpb, s);
  } else if (precision == BF16X3) {
    err = launch_decim_d<BF16X3, float>(x, t, out, B, total, G, K, decim, lead,
                                        nout, kp, tpb, s);
  }
  return (int)err;
}

// The decimating FIR's tensor-core route, bf16 or bf16x3; tensors as above.
// mtb in {1, 2, 4} tiles of 128 outputs a block, `to` outputs a block kept
// (128 * mtb, or fewer where mtb == 1), tpb >= 1 such tiles a block.
int fir_decim_mma_fwd(const void* x, int x_bf16, const void* taps, void* y,
                      int B, int total, int G, int K, int decim, int lead,
                      int nout, int precision, int mtb, int to, int tpb,
                      void* stream) {
  const float* t = static_cast<const float*>(taps);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (decim < 1 || tpb < 1 || (mtb != 1 && mtb != 2 && mtb != 4) || to < 1 ||
      to > 128 * mtb || (mtb > 1 && to != 128 * mtb))
    return (int)err;
  if (x_bf16) {
    if (precision == BF16)
      err = launch_decim_mma_d<BF16, __nv_bfloat16>(
          x, t, out, B, total, G, K, decim, lead, nout, mtb, to, tpb, s);
  } else if (precision == BF16) {
    err = launch_decim_mma_d<BF16, float>(x, t, out, B, total, G, K, decim,
                                          lead, nout, mtb, to, tpb, s);
  } else if (precision == BF16X3) {
    err = launch_decim_mma_d<BF16X3, float>(x, t, out, B, total, G, K, decim,
                                            lead, nout, mtb, to, tpb, s);
  }
  return (int)err;
}

}  // extern "C"
