// Shared-memory radix-2 FFT used by the DFT kernels of this directory.
//
// Twiddle tables are built on the host in f64 from the INTEGER phase k
// (tw_re[k] = cos(2*pi*k/N), tw_im[k] = -sin(2*pi*k/N), k in [0, N/2]) and
// rounded once to f32, so no large float angle is ever formed on the card.
#pragma once

#include <cuda_runtime.h>

namespace bliss {

__device__ __forceinline__ int bit_reverse(int v, int bits) {
  return static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - bits));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// In-place radix-2 decimation-in-time FFT of n = 2^log2n complex points held
// in shared memory (re, im). On entry the input sits in bit-reversed order,
// on exit X[k] sits in natural order. The table holds W_N^k for
// N = n * tw_scale; every thread of the block must call this, after a
// __syncthreads() that publishes the input. Ends with a __syncthreads().
__device__ __forceinline__ void fft_radix2_dit(float* re, float* im, int log2n,
                                               const float* __restrict__ tw_re,
                                               const float* __restrict__ tw_im,
                                               int tw_scale) {
  const int half_n = 1 << (log2n - 1);
  for (int s = 1; s <= log2n; ++s) {
    const int half = 1 << (s - 1);
    // W_{2*half}^pos == W_N^(pos * N / (2*half))
    const int stride = (half_n >> (s - 1)) * tw_scale;
    for (int t = threadIdx.x; t < half_n; t += blockDim.x) {
      const int pos = t & (half - 1);
      const int i = ((t >> (s - 1)) << s) | pos;
      const int j = i + half;
      const float wr = tw_re[pos * stride];
      const float wi = tw_im[pos * stride];
      const float jr = re[j], ji = im[j];
      const float xr = jr * wr - ji * wi;
      const float xi = jr * wi + ji * wr;
      const float ir = re[i], ii = im[i];
      re[j] = ir - xr;
      im[j] = ii - xi;
      re[i] = ir + xr;
      im[i] = ii + xi;
    }
    __syncthreads();
  }
}

}  // namespace bliss
