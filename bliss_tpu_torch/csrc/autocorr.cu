// The beat tracker's per-block autocorrelation (ops/tempo_kernels.py:autocorr),
// aubio's vec_autocorr (src/aubio.rs:819-828) over every block row of
// `dfframes [B, NB, 512]`:
//   acf[r, i] = (sum over j = i..511 of df[r, j - i] * df[r, j]) / (512 - i).
//
// Replaces bliss_tpu/models/tempo.py:236 _autocorr, the JAX package's
// Toeplitz gather and `jnp.matmul(..., precision=HIGHEST)`, vmapped over the
// blocks at :358. It is plain XLA, no Pallas kernel; on the TPU the package
// takes `_autocorr_batch_dft` (:255-287) instead, a DFT route that rounds
// otherwise. The port's earlier route, a gathered `[256, 512, 512]` Toeplitz
// chunk and `torch.matmul`, moved 1.88 GB for the 1,792 rows of a
// 8 x 5-min batch and summed in cuBLAS's order.
//
// Summation order: the one XLA's CPU backend compiles that matmul into, so
// the port's block inputs equal the JAX package's bit for bit:
//   - 8 partial sums a lag (256-bit vectors of f32), partial w taking the
//     terms j = w (mod 8) in increasing j, each step one fused multiply-add
//     rounded once (__fmaf_rn);
//   - the partials added in adjacent pairs,
//     ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)), with __fadd_rn;
//   - one division by 512 - i (__fdiv_rn).
// The terms j < i, which the Toeplitz product adds as zero products, are
// skipped: they come first in each partial, while it is still +0, and
// +0 + +-0 is +0. (With an inf or NaN at j < i the zero product would be
// NaN; aubio's loop skips those terms, and so does the plain version.)
//
// Design: a block a row, 256 threads. The row's 2 KB sit in shared memory.
// Thread t takes lag t (512 - t terms) and lag 511 - t (t + 1 terms), 513
// terms a thread, so the triangle is even across threads. A lag's 8
// partials live in registers under compile-time indices: the loop walks
// chunks of 8 from j = i & ~7, unrolled by 8, the first chunk predicated on
// j >= i. Within a warp the lags are consecutive, so a shared-memory read of
// df[j] touches four words and a read of df[j - i] eight consecutive ones,
// each word a broadcast: no bank conflicts.
//
// Bound on the card: operations. 131,328 fused multiply-adds a row, 235 M
// for 1,792 rows, 0.47 GFLOP at 67 TFLOP/s of f32: 7 us. The bytes, each row
// read once and written once (4 KB a row, 7.3 MB), take 2.2 us at 3.35 TB/s.
// Two shared-memory reads feed each FMA, so the design is bound by
// shared-memory bandwidth before the FMA rate.
#include <cuda_runtime.h>

namespace {

constexpr int kN = 512;
constexpr int kLanes = 8;
constexpr int kThreads = kN / 2;

__device__ __forceinline__ float lag_sum(const float* s, int i) {
  float p[kLanes];
#pragma unroll
  for (int w = 0; w < kLanes; ++w) p[w] = 0.0f;
  const int j0 = i & ~(kLanes - 1);
#pragma unroll
  for (int w = 0; w < kLanes; ++w) {
    const int j = j0 + w;
    if (j >= i) p[w] = __fmaf_rn(s[j - i], s[j], p[w]);
  }
  for (int c = j0 + kLanes; c < kN; c += kLanes) {
#pragma unroll
    for (int w = 0; w < kLanes; ++w) p[w] = __fmaf_rn(s[c + w - i], s[c + w], p[w]);
  }
  const float sum = __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3])),
                              __fadd_rn(__fadd_rn(p[4], p[5]), __fadd_rn(p[6], p[7])));
  return __fdiv_rn(sum, static_cast<float>(kN - i));
}

__global__ void __launch_bounds__(kThreads)
autocorr_kernel(const float* __restrict__ df, float* __restrict__ acf) {
  __shared__ float s[kN];
  const long long base = static_cast<long long>(blockIdx.x) * kN;
  const int t = threadIdx.x;
  s[t] = df[base + t];
  s[t + kThreads] = df[base + t + kThreads];
  __syncthreads();
  acf[base + t] = lag_sum(s, t);
  acf[base + kN - 1 - t] = lag_sum(s, kN - 1 - t);
}

}  // namespace

extern "C" int autocorr_launch(const float* df, float* acf, long long rows,
                               cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  autocorr_kernel<<<static_cast<unsigned int>(rows), kThreads, 0, stream>>>(df, acf);
  return static_cast<int>(cudaGetLastError());
}
