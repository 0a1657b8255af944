// dfe_feedback_fwd: the decision-feedback recursion of the ATSC 8-VSB
// equalizer on Hopper, one warp per call.
//
// Replaces no Pallas kernel: grtpu runs this recursion as lax.scan
// (grtpu/models/atsc_rf.py:596, the body at :591-594 of _dfe_filter).
//
// What it computes, for the feedforward output ff (n,) float32, the feedback
// taps wfb (nfb,) and the ring of the nfb latest decisions, newest first:
//   y[k]  = ff[k] - sum_i wfb[i] * ring[i]
//   d     = 2 * clip(rint((y[k] + 7) / 2), 0, 7) - 7    (round half to even)
//   ring <- [d, ring[:-1]]
// and the ring after the last step.  The feedforward product is one dense
// FIR outside this kernel (torch, the port's matmul FIR).
//
// Bound on this card: ff is read and y written once (8n bytes) and the work
// is 2*nfb*n float32 operations: about 0.6 us and 1.5 us a field of 260,416
// symbols.  What sets the time is the chain of n dependent steps: output k
// needs decision k - 1.  So the sum is transposed: instead of a 192-term dot
// over the ring every step, the warp keeps the partial sums of the next nfb
// outputs, one slot an output, nfb / 32 slots a lane in registers, and
// adds each new decision d into every slot with the slot's weight,
// wfb[m - k - 1] for output m (from a shared copy of wfb stored twice, so
// the rotating index needs no modulo, and with offsets fixed at compile
// time).  The slot of output k then restarts for output k + nfb.  Every
// lane forms y[k] and d[k] itself from the same numbers: the sum of output
// k is A_k + wfb[0] * d[k-1], where A_k, its slot before that last term,
// was shuffled to every lane by its owner two steps before.  So the chain
// of a step is one multiply-add, one subtract and the slicer, with no
// shuffle, reduction or store on it.  The slots of outputs 0..nfb-1 are
// seeded from the carried ring before the loop.  Steps go 32 at a time,
// unrolled whole (the slots rotate between registers after each 32); ff is
// read and y written 32 at a time, coalesced, and the decisions are kept in
// a shared copy, off the chain, for the final ring.
//
// Summation order: every output sums its terms in time order, the ring's
// first, i.e. i = nfb-1 down to 0, each a fused multiply-add.  It is not
// torch.dot's: the twin is held to equal decisions and y within 1e-4.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <int NJ>
__global__ void __launch_bounds__(32)
    dfe_kernel(const float* __restrict__ ff, const float* __restrict__ wfb,
               const float* __restrict__ ring0, int n, float* __restrict__ y,
               float* __restrict__ ring_out) {
  constexpr int kNfb = 32 * NJ;
  // w2[i] = wfb[i mod nfb] for i < 2 nfb
  __shared__ float w2[2 * kNfb];
  __shared__ float r0[kNfb];
  __shared__ float dec[kNfb];  // decision k at k mod nfb
  const int lane = threadIdx.x;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float w = wfb[lane + 32 * j];
    w2[lane + 32 * j] = w;
    w2[kNfb + lane + 32 * j] = w;
    r0[lane + 32 * j] = ring0[lane + 32 * j];
  }
  __syncwarp();

  // slot m = lane + 32 j: sum_{i = nfb-1 down to m} wfb[i] * ring0[i - m]
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.0f;
  for (int i = kNfb - 1; i >= 0; --i) {
    const float wi = w2[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int m = lane + 32 * j;
      if (i >= m) acc[j] = fmaf(wi, r0[i - m], acc[j]);
    }
  }

  // The steps go 32 at a time; acc[j] holds the slots of the outputs
  // 32 j + lane ahead of the tile's first, and rotates after each tile.
  // Every lane forms y[k] and d[k] itself, from the same numbers: output
  // k's sum is A_k + wfb[0] * d[k-1], where A_k, its slot before that last
  // term, was handed round by its owner two steps earlier, so no shuffle
  // is on the chain.  Slot q's weight for the decision of step kk of the
  // tile is wfb[(32 j + lane - kk - 1) mod nfb] = wp[32 j - kk].
  const float w0 = w2[0];
  const float* wp = w2 + kNfb - 1 + lane;
  float ffv = lane < n ? ff[lane] : 0.0f;
  float a_cur = __shfl_sync(kFull, acc[0], 0);  // A_0 (complete)
  float a_nxt = __shfl_sync(kFull, acc[0], 1);  // A_1
  float d_prev = 0.0f;
  float yv = 0.0f;
  int qb = 0;  // the tile's first slot
  auto step = [&](int kk) {
    const float ffk = __shfl_sync(kFull, ffv, kk);
    const float yk = ffk - fmaf(w0, d_prev, a_cur);
    const float lvl = fminf(fmaxf(rintf(fmaf(yk, 0.5f, 3.5f)), 0.0f), 7.0f);
    const float d = fmaf(2.0f, lvl, -7.0f);
    if (lane == kk) {
      yv = yk;
      acc[0] = 0.0f;  // the slot starts output k + nfb
      dec[qb + kk] = d;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] = fmaf(wp[32 * j - kk], d, acc[j]);
    // A_{k+2}: output k+2's slot, now holding every term up to d[k]
    const float a2 = __shfl_sync(kFull, kk < 30 ? acc[0] : acc[NJ > 1],
                                 (kk + 2) & 31);
    d_prev = d;
    a_cur = a_nxt;
    a_nxt = a2;
  };
  for (int kb = 0; kb < n; kb += 32) {
    const int cnt = min(32, n - kb);
    const float ffn = kb + 32 + lane < n ? ff[kb + 32 + lane] : 0.0f;
    if (cnt == 32) {
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) step(kk);
    } else {
      for (int kk = 0; kk < cnt; ++kk) step(kk);
    }
    if (lane < cnt) y[kb + lane] = yv;
    ffv = ffn;
    const float first = acc[0];
#pragma unroll
    for (int j = 0; j + 1 < NJ; ++j) acc[j] = acc[j + 1];
    acc[NJ - 1] = first;
    qb = qb + 32 == kNfb ? 0 : qb + 32;
  }

  // ring_out[i] = decision n-1-i, or ring0[i - n] past the decisions made
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int i = lane + 32 * j;
    ring_out[i] = i < n ? dec[(n - 1 - i) % kNfb] : r0[i - n];
  }
}

template <int NJ>
void launch(const float* ff, const float* wfb, const float* ring0, int n,
            float* y, float* ring_out, cudaStream_t stream) {
  dfe_kernel<NJ><<<1, 32, 0, stream>>>(ff, wfb, ring0, n, y, ring_out);
}

}  // namespace

extern "C" {

// nfb must be a multiple of 32, at most 256 (the wrapper checks).
int dfe_feedback_fwd(const float* ff, const float* wfb, const float* ring0,
                     int n, int nfb, float* y, float* ring_out,
                     cudaStream_t stream) {
  switch (nfb / 32) {
    case 1: launch<1>(ff, wfb, ring0, n, y, ring_out, stream); break;
    case 2: launch<2>(ff, wfb, ring0, n, y, ring_out, stream); break;
    case 3: launch<3>(ff, wfb, ring0, n, y, ring_out, stream); break;
    case 4: launch<4>(ff, wfb, ring0, n, y, ring_out, stream); break;
    case 5: launch<5>(ff, wfb, ring0, n, y, ring_out, stream); break;
    case 6: launch<6>(ff, wfb, ring0, n, y, ring_out, stream); break;
    case 7: launch<7>(ff, wfb, ring0, n, y, ring_out, stream); break;
    case 8: launch<8>(ff, wfb, ring0, n, y, ring_out, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dfe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
