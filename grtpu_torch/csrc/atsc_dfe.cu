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
// symbols.  What sets the time is the chain of n dependent steps, each a
// 192-term dot whose newest term is the previous step's decision.  The
// design keeps the taps in registers (nfb / 32 a lane), the ring in a
// shared-memory circular buffer, sums each lane's terms with fmaf and the
// warp's with five shuffles, and moves ff and y 32 steps at a time with
// coalesced loads and stores.  The sum's order is not torch.dot's: the
// twin is held to equal decisions and y within 1e-4.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <int NJ>
__global__ void dfe_kernel(const float* __restrict__ ff,
                           const float* __restrict__ wfb,
                           const float* __restrict__ ring0, int n,
                           float* __restrict__ y,
                           float* __restrict__ ring_out) {
  constexpr int kNfb = 32 * NJ;
  __shared__ float buf[kNfb];
  const int lane = threadIdx.x;
  float w[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    w[j] = wfb[lane + 32 * j];
    buf[lane + 32 * j] = ring0[lane + 32 * j];
  }
  int head = 0;  // ring[i] = buf[(head + i) % kNfb]
  __syncwarp();
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int cnt = min(32, n - k0);
    const float ffv = lane < cnt ? ff[k0 + lane] : 0.0f;
    float yv = 0.0f;
    for (int i = 0; i < cnt; ++i) {
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        int idx = head + lane + 32 * j;
        if (idx >= kNfb) idx -= kNfb;
        part = fmaf(w[j], buf[idx], part);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
      const float yk = __shfl_sync(kFull, ffv, i) - part;
      const float lvl = fminf(fmaxf(rintf((yk + 7.0f) / 2.0f), 0.0f), 7.0f);
      const float d = 2.0f * lvl - 7.0f;
      head = head == 0 ? kNfb - 1 : head - 1;
      __syncwarp();
      if (lane == 0) buf[head] = d;
      __syncwarp();
      if (lane == i) yv = yk;
    }
    if (lane < cnt) y[k0 + lane] = yv;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    int idx = head + lane + 32 * j;
    if (idx >= kNfb) idx -= kNfb;
    ring_out[lane + 32 * j] = buf[idx];
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
