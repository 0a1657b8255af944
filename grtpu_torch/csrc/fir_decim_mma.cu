// The decimating FIR's tensor-core route (fir_decim_mma_fwd), every
// stream mode and decimation, built for sm_90a by ops/_build.py into a
// library of its own.  The kernel, its design and what bounds it are in
// fir_decim.cuh; the FMA route's instances are in fir_decim.cu, compiled
// beside this file.

#include "fir_decim.cuh"

extern "C" {

// Shared-memory bytes one block uses (x_bf16: the stream's elements are 2
// bytes; cplx: the complex mode, 8-byte elements): with the ring where that
// fits, else without it.
size_t fir_decim_mma_smem(int precision, int x_bf16, int K, int decim,
                          int mtb, int cplx) {
  size_t smem;
  decim_fits(
      [&](bool r) {
        return decim_mma_smem(precision, elem_bytes(x_bf16, cplx), K, decim,
                              mtb, cplx, r);
      },
      smem);
  return smem;
}

// The decimating FIR's tensor-core route, bf16 or bf16x3; tensors and modes
// as fir_decim_fwd's (fir_decim.cu).  mtb in {1, 2, 4} tiles of 128
// outputs a block, `to` outputs a block kept (128 * mtb, or fewer where
// mtb == 1), tpb >= 1 such tiles a block.
int fir_decim_mma_fwd(const void* x, int x_bf16, const void* taps, void* y,
                      int B, int total, int G, int K, int decim, int lead,
                      int nout, int precision, int mtb, int to, int tpb,
                      int cplx, void* stream) {
  const float* t = static_cast<const float*>(taps);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (decim < 1 || tpb < 1 || (mtb != 1 && mtb != 2 && mtb != 4) || to < 1 ||
      to > 128 * mtb || (mtb > 1 && to != 128 * mtb) || cplx < 0 ||
      cplx > CCC || (x_bf16 && cplx))
    return (int)err;
  if (x_bf16) {
    if (precision == BF16)
      err = launch_decim_mma_d<BF16, __nv_bfloat16, REAL>(
          x, t, out, B, total, G, K, decim, lead, nout, mtb, to, tpb, s);
  } else if (precision == BF16) {
    err = launch_decim_mma_c<BF16>(x, t, out, B, total, G, K, decim, lead,
                                   nout, mtb, to, tpb, cplx, s);
  } else if (precision == BF16X3) {
    err = launch_decim_mma_c<BF16X3>(x, t, out, B, total, G, K, decim, lead,
                                     nout, mtb, to, tpb, cplx, s);
  }
  return (int)err;
}

}  // extern "C"
