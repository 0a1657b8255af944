// The decimating FIR's FMA route (fir_decim_fwd), every stream mode and
// decimation, built for sm_90a by ops/_build.py into a library of its own.
// The kernel, its design and what bounds it are in fir_decim.cuh; the
// tensor-core route's instances are in fir_decim_mma.cu, compiled beside
// this file.

#include "fir_decim.cuh"

extern "C" {

// Shared-memory bytes one block uses (x_bf16: the stream's
// elements are 2 bytes; cplx: the complex mode, 8-byte elements): with the
// ring where that fits, else without it.
size_t fir_decim_smem(int precision, int x_bf16, int K, int decim, int kp,
                      int cplx) {
  size_t smem;
  decim_fits(
      [&](bool r) {
        return decim_smem(precision, elem_bytes(x_bf16, cplx), K, decim, kp,
                          cplx, r);
      },
      smem);
  return smem;
}

// The decimating FIR's FMA route.  Real mode (cplx 0): x (B, total) float32
// (x_bf16 == 0) or bfloat16 (x_bf16 == 1, precision bf16 only), taps (G, K)
// float32, y (B, nout) float32.  ccf (cplx 1): x and y complex64, taps
// float32; ccc (cplx 2): x, taps and y complex64; the complex modes take no
// bf16 stream.  All row-major contiguous.  kp in {1, 2, 4} phase groups a
// block, tpb >= 1 tiles of 1024 / kp outputs a block.
int fir_decim_fwd(const void* x, int x_bf16, const void* taps, void* y, int B,
                  int total, int G, int K, int decim, int lead, int nout,
                  int precision, int kp, int tpb, int cplx, void* stream) {
  const float* t = static_cast<const float*>(taps);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (decim < 1 || tpb < 1 || (kp != 1 && kp != 2 && kp != 4) || cplx < 0 ||
      cplx > CCC || (x_bf16 && cplx))
    return (int)err;
  if (x_bf16) {
    if (precision == BF16)
      err = launch_decim_d<BF16, __nv_bfloat16, REAL>(
          x, t, out, B, total, G, K, decim, lead, nout, kp, tpb, s);
  } else if (precision == F32) {
    err = launch_decim_c<F32>(x, t, out, B, total, G, K, decim, lead, nout,
                              kp, tpb, cplx, s);
  } else if (precision == BF16) {
    err = launch_decim_c<BF16>(x, t, out, B, total, G, K, decim, lead, nout,
                               kp, tpb, cplx, s);
  } else if (precision == BF16X3) {
    err = launch_decim_c<BF16X3>(x, t, out, B, total, G, K, decim, lead,
                                 nout, kp, tpb, cplx, s);
  }
  return (int)err;
}

}  // extern "C"
