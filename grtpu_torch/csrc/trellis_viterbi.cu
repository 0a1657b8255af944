// viterbi_fwd: table-driven Viterbi decoding on Hopper, one CUDA block per
// row of a batch.
//
// Replaces no Pallas kernel: grtpu runs this recursion as lax.scan
// (grtpu/trellis/algorithms.py:89 forward, :113 traceback), vmapped over
// rows at grtpu/models/atsc.py:245 (the 12 ATSC trellis phases) and
// grtpu/trellis/blocks.py:206 (K-blocks of a stream).
//
// What it computes, for each row b of metrics (B, T, O) float32 and the
// FSM's predecessor tables PS, PI and edge outputs EO = OS[PS, PI], all
// (S, deg) int32 (PS < 0 marks a missing edge):
//   pm_0[s]   = 0 at start_state and NEG elsewhere (0 everywhere if < 0)
//   cand[s,j] = pm[PS[s,j]] + m[t, EO[s,j]], or NEG where PS[s,j] < 0
//   choice[t,s] = the first j of the largest cand[s,j]
//   pm'[s]    = max_j cand[s,j] - max_s max_j cand[s,j]
// then the traceback from end_state (or the first arg max of the final
// metrics): input[t] = PI[s, choice[t,s]], s <- PS[s, choice[t,s]].
// Every step is one float32 add, compare or subtract, in the order of the
// plain twin (grtpu_torch/ops/cuda_trellis.py::viterbi_ref), so the two
// agree exactly.
//
// Bound on this card: the metrics are read once and the decisions written
// once (B*T*(O + 1)*4 bytes) and the work is B*T*S*(2*deg + 1) float32
// operations, both far below a millisecond at the shapes of this repo; what
// sets the time is the chain of T dependent steps, each a shared-memory
// exchange of the S path metrics and a block-wide max.  The design keeps the
// path metrics and the FSM tables in shared memory (one thread per state,
// double-buffered metrics so one barrier a step suffices), runs as many
// rows at once as the card holds blocks, writes the int8 decisions to
// global memory and stages them back through shared memory a tile at a time
// for the one-thread traceback.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;

__device__ __forceinline__ float block_max(float v, float* red, int nwarps) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (nwarps == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int i = 1; i < nwarps; ++i) m = fmaxf(m, red[i]);
  return m;
}

__global__ void viterbi_kernel(const float* __restrict__ metrics,
                               const int* __restrict__ ps,
                               const int* __restrict__ pi,
                               const int* __restrict__ eo, int T, int O,
                               int S, int deg, int start_state,
                               int end_state, int tile_steps,
                               int8_t* __restrict__ choices,
                               int* __restrict__ out) {
  extern __shared__ float smem[];
  float* pm = smem;                                   // 2 * S
  float* red = pm + 2 * S;                            // 32
  int* ps_s = reinterpret_cast<int*>(red + 32);       // S * deg
  int* pi_s = ps_s + S * deg;                         // S * deg
  int* eo_s = pi_s + S * deg;                         // S * deg
  int* state = eo_s + S * deg;                        // 1
  int8_t* tile = reinterpret_cast<int8_t*>(state + 1);  // tile_steps * S

  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int nwarps = blockDim.x >> 5;
  const bool active = s < S;
  const float* m = metrics + static_cast<size_t>(b) * T * O;
  int8_t* ch = choices + static_cast<size_t>(b) * T * S;
  int* row_out = out + static_cast<size_t>(b) * T;

  for (int i = threadIdx.x; i < S * deg; i += blockDim.x) {
    ps_s[i] = ps[i];
    pi_s[i] = pi[i];
    eo_s[i] = eo[i];
  }
  if (active)
    pm[s] = (start_state < 0 || s == start_state) ? 0.0f : kNeg;
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float* mt = m + static_cast<size_t>(t) * O;
    float best = -INFINITY;
    int bj = 0;
    if (active) {
      for (int j = 0; j < deg; ++j) {
        const int p = ps_s[s * deg + j];
        const float c = p >= 0 ? pm[cur * S + p] + __ldg(mt + eo_s[s * deg + j])
                               : kNeg;
        if (j == 0 || c > best) {
          best = c;
          bj = j;
        }
      }
    }
    const float mx = block_max(active ? best : -INFINITY, red, nwarps);
    if (active) {
      pm[(cur ^ 1) * S + s] = best - mx;
      ch[static_cast<size_t>(t) * S + s] = static_cast<int8_t>(bj);
    }
    cur ^= 1;
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    int se = end_state;
    if (se < 0) {
      se = 0;
      for (int i = 1; i < S; ++i)
        if (pm[cur * S + i] > pm[cur * S + se]) se = i;
    }
    *state = se;
  }
  for (int t1 = T; t1 > 0; t1 -= tile_steps) {
    const int t0 = t1 > tile_steps ? t1 - tile_steps : 0;
    const int nbytes = (t1 - t0) * S;
    __syncthreads();
    for (int i = threadIdx.x; i < nbytes; i += blockDim.x)
      tile[i] = ch[static_cast<size_t>(t0) * S + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      int st = *state;
      for (int t = t1 - 1; t >= t0; --t) {
        const int e = st * deg + tile[(t - t0) * S + st];
        row_out[t] = max(pi_s[e], 0);
        st = max(ps_s[e], 0);
      }
      *state = st;
    }
  }
}

}  // namespace

extern "C" {

// Shared memory bytes of one block for S states, in-degree deg and a
// traceback tile of tile_steps steps.
size_t viterbi_smem(int S, int deg, int tile_steps) {
  return (2 * S + 32 + 3 * S * deg + 1) * sizeof(float) +
         static_cast<size_t>(tile_steps) * S;
}

int viterbi_fwd(const float* metrics, const int* ps, const int* pi,
                const int* eo, int B, int T, int O, int S, int deg,
                int start_state, int end_state, int tile_steps,
                int8_t* choices, int* out, cudaStream_t stream) {
  // the wrapper sizes tile_steps so that smem stays within the 48 KB a
  // block takes without an opt-in (nothing to set up before a capture)
  const int threads = ((S + 31) / 32) * 32;
  const size_t smem = viterbi_smem(S, deg, tile_steps);
  viterbi_kernel<<<B, threads, smem, stream>>>(metrics, ps, pi, eo, T, O, S,
                                               deg, start_state, end_state,
                                               tile_steps, choices, out);
  return static_cast<int>(cudaGetLastError());
}

const char* trellis_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
