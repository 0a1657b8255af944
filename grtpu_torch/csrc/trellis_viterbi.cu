// viterbi_fwd: table-driven Viterbi decoding on Hopper, over a batch of rows.
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
// operations, both far below a millisecond at the shapes of this repo.  What
// sets the time is the chain of T dependent steps, so the design is about
// the latency of one step.
//
// Warp route (S <= 32, deg <= 8, no missing edge; viterbi_warp_kernel).
// Lane r*S' + s of a warp owns state s of row r (S' the power of two >= S),
// so a warp decodes 32 / S' rows at once: 8 of FSM4's, 4 of ATSC's.  A lane
// keeps its predecessors' lanes, inputs and metric offsets in registers.  A
// step fetches the predecessors' last maxima by shuffle, takes the row's
// max (up to 8 lanes a row: every lane gathers the row's values with S'-1
// shuffles in flight together and takes a tree of maxes, one shuffle's
// latency on the chain; wider rows: a butterfly of log2(S') shuffles), then
// one subtract, one add and a max tree of deg candidates.  No step touches
// a barrier or device memory.  The metrics arrive 32 steps at a time, by
// coalesced cp.async into a double-buffered shared tile requested a tile
// ahead and laid out [row][symbol][step], so that a step's loads take
// immediate offsets and fall in distinct banks; each step's loads are
// issued during the step before.  The decisions leave as ballots:
// ceil(log2 deg) 32-bit words a step hold the whole warp's choices,
// gathered in registers and written once every 32 steps in one coalesced
// store.  The tiles are unrolled whole, so the compiler sees 32 steps of
// straight-line code.  The traceback walks the words back, prefetched two
// tiles ahead: every lane resolves its own state's predecessor and input
// from its registers, and a step's chain is one shuffle from the lane of
// the current state.
//
// Block route (any S up to 1024, or missing edges; viterbi_block_kernel).
// One thread a state in one block a row, the path metrics in shared memory
// (double-buffered, one barrier a step) and a block-wide max; the metrics
// are staged by cp.async into a double-buffered shared tile, so no step
// waits on device memory; int8 decisions, read back a tile at a time by
// the one-thread traceback.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;     // steps of a warp-route tile
constexpr int kMaxWarps = 4;  // warps of a warp-route block

enum Route { kBlock = 0, kWarp = 1 };

// ------------------------------------------------------------- cp.async
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Request count floats from src to dst by nthr threads (this one tid); vec:
// count, src and dst are 16-byte multiples and aligned.
__device__ __forceinline__ void stage(float* dst, const float* src, int count,
                                      int tid, int nthr, bool vec) {
  if (vec) {
    for (int e = 4 * tid; e < count; e += 4 * nthr)
      cp_async16(dst + e, src + e);
  } else {
    for (int e = tid; e < count; e += nthr) cp_async4(dst + e, src + e);
  }
}

__host__ __device__ constexpr int log2_ceil(int v) {
  return v <= 1 ? 0 : 1 + log2_ceil((v + 1) / 2);
}

// Bits a warp-route decision takes for in-degree bucket DEG (>= 1).
__host__ __device__ constexpr int dec_words(int deg_bucket) {
  return deg_bucket <= 2 ? 1 : log2_ceil(deg_bucket);
}

// ------------------------------------------------------------ warp route
// The max over the S' lanes of this lane's row.  Up to 8 lanes a row, every
// lane gathers the others' values at once (S' - 1 shuffles in flight
// together) and takes a tree of maxes: one shuffle's latency on the chain.
// Wider rows take a butterfly of log2(S') shuffles.  Either stays inside
// the row, and a max is the same in any order.
template <int LOG_SP>
__device__ __forceinline__ float row_max(float v) {
  constexpr int SP = 1 << LOG_SP;
  if constexpr (LOG_SP <= 3) {
    float g[SP];
    g[0] = v;
#pragma unroll
    for (int o = 1; o < SP; ++o) g[o] = __shfl_xor_sync(kFull, v, o);
#pragma unroll
    for (int h = 1; h < SP; h <<= 1)
#pragma unroll
      for (int j = 0; j + h < SP; j += 2 * h) g[j] = fmaxf(g[j], g[j + h]);
    return g[0];
  } else {
#pragma unroll
    for (int o = SP >> 1; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    return v;
  }
}

template <int LOG_SP, int DEG>
__global__ void __launch_bounds__(32 * kMaxWarps)
    viterbi_warp_kernel(const float* __restrict__ metrics,
                        const int* __restrict__ ps, const int* __restrict__ pi,
                        const int* __restrict__ eo, int B, int T, int O, int S,
                        int deg, int start_state, int end_state,
                        uint32_t* __restrict__ dec, int* __restrict__ out) {
  constexpr int SP = 1 << LOG_SP;  // lanes a row
  constexpr int R = 32 / SP;       // rows a warp
  constexpr int NB = dec_words(DEG);
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int gw = blockIdx.x * (blockDim.x >> 5) + w;
  const int row0 = gw * R;
  if (row0 >= B) return;  // the whole warp: no shuffle is left waiting
  const int r = lane >> LOG_SP;
  const int s = lane & (SP - 1);
  const int base = r << LOG_SP;  // the row's first lane
  // A row's tile is [o][step], each output symbol's run of steps padded to
  // 33 floats: a step's loads take immediate offsets, and the lanes of a
  // step read distinct banks (r*O + o + step mod 32) while R*O <= 32.
  constexpr int kRun = kTile + 1;
  const int rs = kRun * O;  // floats a row's tile
  float* buf = smem + static_cast<size_t>(w) * 2 * R * rs;

  // This lane's edges (the wrapper sends an FSM with a missing edge to the
  // block route).  An edge past deg repeats edge 0, which it never beats
  // (the first j wins a tie).  A lane past S is its own predecessor with a
  // best of -inf: its candidates stay -inf and never win its row's max.
  int src[DEG], moff[DEG], pk[DEG];
  const bool real = s < S;
#pragma unroll
  for (int j = 0; j < DEG; ++j) {
    const int e = s * deg + (j < deg ? j : 0);
    const int p = real ? ps[e] : s;
    src[j] = base + p;
    moff[j] = r * rs + (real ? eo[e] : 0) * kRun;
    // traceback: the predecessor's lane, and the input above bit 8
    pk[j] = (base + p) | ((real ? pi[e] : 0) << 8);
  }
  // best holds the last step's max_j cand (pm_0 before the first step,
  // whose row max is 0, so best - mx is pm_0 exactly)
  float best = real ? ((start_state < 0 || s == start_state) ? 0.0f : kNeg)
                    : -INFINITY;
  float mx = 0.0f;

  const int ntile = (T + kTile - 1) / kTile;
  const float* mrow = metrics + static_cast<size_t>(row0) * T * O;
  const int nrows = min(R, B - row0);
  // The copy reads each row's run of cnt*O floats with consecutive lanes on
  // consecutive floats and writes float e = t*O + o of the run to [o][t]:
  // lane l starts at (l / O, l % O) and moves 32 floats on a pass.
  const int t_lane = lane / O, o_lane = lane % O;
  const int t_pass = 32 / O, o_pass = 32 % O;
  auto request = [&](int k) {
    const int t0 = k * kTile;
    const int count = min(kTile, T - t0) * O;
    float* dst = buf + (k & 1) * R * rs;
    for (int q = 0; q < nrows; ++q) {
      const float* src = mrow + (static_cast<size_t>(q) * T + t0) * O;
      int t = t_lane, o = o_lane;
      for (int e = lane; e < count; e += 32) {
        cp_async4(dst + q * rs + o * kRun + t, src + e);
        t += t_pass;
        o += o_pass;
        if (o >= O) {
          o -= O;
          ++t;
        }
      }
    }
    cp_async_commit();
  };

  uint32_t word[NB];
  const float* mt = buf;
  float mnext[DEG];  // the metrics of the next step, loaded during this one
  auto load = [&](int tt) {
#pragma unroll
    for (int j = 0; j < DEG; ++j) mnext[j] = mt[moff[j] + tt];
  };
  // one step: candidates, their max, the row's max for the next step (in
  // flight while the arg max and the ballots of this one are formed)
  auto step = [&](int tt, bool more) {
    float m[DEG], pb[DEG], c[DEG];
#pragma unroll
    for (int j = 0; j < DEG; ++j) m[j] = mnext[j];
    if (more) load(tt + 1);
#pragma unroll
    for (int j = 0; j < DEG; ++j) pb[j] = __shfl_sync(kFull, best, src[j]);
#pragma unroll
    for (int j = 0; j < DEG; ++j) c[j] = (pb[j] - mx) + m[j];
    float t[DEG];
#pragma unroll
    for (int j = 0; j < DEG; ++j) t[j] = c[j];
#pragma unroll
    for (int h = 1; h < DEG; h <<= 1)  // a tree: log2 DEG levels
#pragma unroll
      for (int j = 0; j + h < DEG; j += 2 * h) t[j] = fmaxf(t[j], t[j + h]);
    const float nb = t[0];
    const float mx_next = row_max<LOG_SP>(nb);
    // bit i of the choice (the first j with c[j] == nb; the last if none
    // before it) straight from the comparisons
    bool bit[NB], before = false;
#pragma unroll
    for (int i = 0; i < NB; ++i) bit[i] = false;
#pragma unroll
    for (int j = 0; j < DEG; ++j) {
      const bool first = !before && (j == DEG - 1 || c[j] == nb);
#pragma unroll
      for (int i = 0; i < NB; ++i)
        if ((j >> i) & 1) bit[i] = bit[i] || first;
      before = before || c[j] == nb;
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const uint32_t b = __ballot_sync(kFull, bit[i]);
      if (lane == tt) word[i] = b;
    }
    best = nb;
    mx = mx_next;
  };

  uint32_t* wdec = dec + static_cast<size_t>(gw) * T * NB;
  request(0);
  for (int k = 0; k < ntile; ++k) {
    const int t0 = k * kTile;
    const int cnt = min(kTile, T - t0);
    cp_async_wait_all();
    __syncwarp();
    if (k + 1 < ntile) request(k + 1);
    mt = buf + (k & 1) * R * rs;
#pragma unroll
    for (int i = 0; i < NB; ++i) word[i] = 0;
    load(0);
    if (cnt == kTile) {
#pragma unroll
      for (int tt = 0; tt < kTile; ++tt) step(tt, tt + 1 < kTile);
    } else {
      for (int tt = 0; tt < cnt; ++tt) step(tt, tt + 1 < cnt);
    }
    if (lane < cnt) {
#pragma unroll
      for (int i = 0; i < NB; ++i)
        wdec[static_cast<size_t>(t0 + lane) * NB + i] = word[i];
    }
  }

  // end state: end_state, or the first arg max of pm = best - mx
  int st = end_state;
  if (st < 0) {
    float v = real ? best - mx : -INFINITY;
    int idx = s;
#pragma unroll
    for (int o = SP >> 1; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, o);
      const int oi = __shfl_xor_sync(kFull, idx, o);
      if (ov > v || (ov == v && oi < idx)) {
        v = ov;
        idx = oi;
      }
    }
    st = idx;
  }

  // traceback: words prefetched two tiles ahead; a tile's outputs gathered
  // in shared memory and stored a row at a time.  A step's chain is the
  // shuffle from the current state's lane, whose own choice picks its
  // predecessor's lane and its input.
  __syncwarp();
  int* obuf = reinterpret_cast<int*>(buf);  // R * 32 ints
  auto words_of = [&](int k, uint32_t (&wv)[NB]) {
    const int t = k * kTile + lane;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wv[i] = k >= 0 && t < T ? wdec[static_cast<size_t>(t) * NB + i] : 0u;
  };
  uint32_t wc[NB], wn[NB], wnn[NB];
  words_of(ntile - 1, wc);
  words_of(ntile - 2, wn);
  int from = base + st;
  auto back = [&](int tt) {
    int c = 0;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      c |= ((__shfl_sync(kFull, wc[i], tt) >> lane) & 1) << i;
    int v = pk[0];
#pragma unroll
    for (int j = 1; j < DEG; ++j)
      if (c == j) v = pk[j];
    const int got = __shfl_sync(kFull, v, from);
    from = got & 31;
    if (s == 0) obuf[r * kTile + tt] = got >> 8;
  };
  for (int k = ntile - 1; k >= 0; --k) {
    const int t0 = k * kTile;
    const int cnt = min(kTile, T - t0);
    words_of(k - 2, wnn);
    if (cnt == kTile) {
#pragma unroll
      for (int tt = kTile - 1; tt >= 0; --tt) back(tt);
    } else {
      for (int tt = cnt - 1; tt >= 0; --tt) back(tt);
    }
    __syncwarp();
    if (lane < cnt) {
      for (int q = 0; q < nrows; ++q)
        out[static_cast<size_t>(row0 + q) * T + t0 + lane] =
            obuf[q * kTile + lane];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      wc[i] = wn[i];
      wn[i] = wnn[i];
    }
  }
}

// ----------------------------------------------------------- block route
__device__ __forceinline__ float block_max(float v, float* red, int nwarps) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if (nwarps == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int i = 1; i < nwarps; ++i) m = fmaxf(m, red[i]);
  return m;
}

__host__ __device__ inline size_t block_region(int S, int O, int steps,
                                               int tb_steps) {
  size_t a = static_cast<size_t>(2) * steps * O * sizeof(float);
  size_t b = static_cast<size_t>(tb_steps) * S;
  return ((a > b ? a : b) + 15) / 16 * 16;
}

__global__ void viterbi_block_kernel(const float* __restrict__ metrics,
                                     const int* __restrict__ ps,
                                     const int* __restrict__ pi,
                                     const int* __restrict__ eo, int T, int O,
                                     int S, int deg, int start_state,
                                     int end_state, int steps, int tb_steps,
                                     int vec, int8_t* __restrict__ choices,
                                     int* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const size_t region = block_region(S, O, steps, tb_steps);
  float* mbuf = smem;                                   // 2 * steps * O
  int8_t* tile = reinterpret_cast<int8_t*>(smem);       // tb_steps * S
  float* pm = smem + region / sizeof(float);            // 2 * S
  float* red = pm + 2 * S;                              // 32
  int* ps_s = reinterpret_cast<int*>(red + 32);         // S * deg
  int* pi_s = ps_s + S * deg;                           // S * deg
  int* eo_s = pi_s + S * deg;                           // S * deg
  int* state = eo_s + S * deg;                          // 1

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

  const int ntile = (T + steps - 1) / steps;
  auto request = [&](int k) {
    const int t0 = k * steps;
    stage(mbuf + (k & 1) * steps * O, m + static_cast<size_t>(t0) * O,
          min(steps, T - t0) * O, threadIdx.x, blockDim.x, vec);
    cp_async_commit();
  };
  request(0);
  int cur = 0;
  for (int k = 0; k < ntile; ++k) {
    const int t0 = k * steps;
    const int cnt = min(steps, T - t0);
    cp_async_wait_all();
    __syncthreads();
    if (k + 1 < ntile) request(k + 1);
    const float* mk = mbuf + (k & 1) * steps * O;
    for (int tt = 0; tt < cnt; ++tt) {
      const float* mt = mk + tt * O;
      float best = -INFINITY;
      int bj = 0;
      if (active) {
        for (int j = 0; j < deg; ++j) {
          const int p = ps_s[s * deg + j];
          const float c = p >= 0 ? pm[cur * S + p] + mt[eo_s[s * deg + j]]
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
        ch[static_cast<size_t>(t0 + tt) * S + s] = static_cast<int8_t>(bj);
      }
      cur ^= 1;
      __syncthreads();
    }
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
  for (int t1 = T; t1 > 0; t1 -= tb_steps) {
    const int t0 = t1 > tb_steps ? t1 - tb_steps : 0;
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

// --------------------------------------------------------------- launch
int deg_bucket(int deg) { return deg <= 1 ? 1 : deg <= 2 ? 2 : deg <= 4 ? 4 : 8; }
int log_sp(int S) { return log2_ceil(S); }

template <int LOG_SP, int DEG>
void launch_warp(int blocks, int warps, size_t smem, cudaStream_t stream,
                 const float* metrics, const int* ps, const int* pi,
                 const int* eo, int B, int T, int O, int S, int deg,
                 int start_state, int end_state, void* scratch, int* out) {
  viterbi_warp_kernel<LOG_SP, DEG><<<blocks, 32 * warps, smem, stream>>>(
      metrics, ps, pi, eo, B, T, O, S, deg, start_state, end_state,
      static_cast<uint32_t*>(scratch), out);
}

template <int LOG_SP>
bool launch_warp_deg(int blocks, int warps, size_t smem, cudaStream_t stream,
                     const float* metrics, const int* ps, const int* pi,
                     const int* eo, int B, int T, int O, int S, int deg,
                     int start_state, int end_state, void* scratch,
                     int* out) {
#define GRTPU_VITERBI_DEG(D)                                                 \
  case D:                                                                    \
    launch_warp<LOG_SP, D>(blocks, warps, smem, stream, metrics, ps, pi, eo, \
                           B, T, O, S, deg, start_state, end_state, scratch, \
                           out);                                             \
    return true;
  switch (deg_bucket(deg)) {
    GRTPU_VITERBI_DEG(1)
    GRTPU_VITERBI_DEG(2)
    GRTPU_VITERBI_DEG(4)
    GRTPU_VITERBI_DEG(8)
  }
#undef GRTPU_VITERBI_DEG
  return false;
}

}  // namespace

extern "C" {

// Shared memory bytes of one block.  Warp route: `warps` warps, each a
// double-buffered tile of 32 steps for its rows.  Block route: the metric
// tile of `steps` steps (double-buffered) or the traceback tile of
// `tb_steps` steps, whichever is larger, then the path metrics and tables.
size_t viterbi_smem(int route, int S, int deg, int O, int steps, int tb_steps,
                    int warps) {
  if (route == kWarp) {
    const int rows = 32 >> log_sp(S);
    return static_cast<size_t>(warps) * 2 * rows * (kTile + 1) * O *
           sizeof(float);
  }
  return block_region(S, O, steps, tb_steps) +
         (2 * S + 32 + 3 * S * deg + 1) * sizeof(float);
}

// route: 1 warp (S <= 32, deg <= 8; `warps` warps a block), 0 block (one
// block a row; `steps` metric steps and `tb_steps` traceback steps a
// tile).  scratch holds the decisions: per warp, dec_words 32-bit words a
// step (warp route); one int8 a state and step (block route).  The
// wrapper sizes both routes within the 48 KB a block takes without an
// opt-in, so nothing is set up before a CUDA-graph capture.
int viterbi_fwd(const float* metrics, const int* ps, const int* pi,
                const int* eo, int B, int T, int O, int S, int deg,
                int start_state, int end_state, int route, int steps,
                int tb_steps, int warps, void* scratch, int* out,
                cudaStream_t stream) {
  const size_t smem = viterbi_smem(route, S, deg, O, steps, tb_steps, warps);
  const bool aligned = O % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(metrics) % 16 == 0;
  if (route == kWarp) {
    if (S > 32 || deg > 8 || warps < 1 || warps > kMaxWarps)
      return static_cast<int>(cudaErrorInvalidValue);
    const int rows = 32 >> log_sp(S);
    const int nwarps = (B + rows - 1) / rows;
    const int blocks = (nwarps + warps - 1) / warps;
    bool ok = false;
#define GRTPU_VITERBI_SP(L)                                                   \
  case L:                                                                     \
    ok = launch_warp_deg<L>(blocks, warps, smem, stream, metrics, ps, pi, eo, \
                            B, T, O, S, deg, start_state, end_state, scratch, \
                            out);                                             \
    break;
    switch (log_sp(S)) {
      GRTPU_VITERBI_SP(0)
      GRTPU_VITERBI_SP(1)
      GRTPU_VITERBI_SP(2)
      GRTPU_VITERBI_SP(3)
      GRTPU_VITERBI_SP(4)
      GRTPU_VITERBI_SP(5)
    }
#undef GRTPU_VITERBI_SP
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const int threads = ((S + 31) / 32) * 32;
    viterbi_block_kernel<<<B, threads, smem, stream>>>(
        metrics, ps, pi, eo, T, O, S, deg, start_state, end_state, steps,
        tb_steps, aligned ? 1 : 0, static_cast<int8_t*>(scratch), out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* trellis_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
