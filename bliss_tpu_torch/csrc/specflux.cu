// SpecFlux onset rows from 512/256 phase-vocoder frames.
//
// Replaces the TPU kernel bliss_tpu/ops/pallas_dft.py:_make_specflux_kernel
// (via pallas_frame_dft_specflux). For every frame h of every song it emits
// (flux, total) where flux = sum_k max(|X_h[k]| - |X_{h-1}[k]|, 0) over the
// 257 bins 0..256 (SpecFlux, src/aubio.rs:432-468) and total = sum_k |X_h[k]|.
// The caller sets onset[0] = total[0] (aubio diffs the first frame against
// zeros).
//
// Frame h of song b covers x[b, h*hop - offset + n], n in [0, 512), zero
// outside [0, T), times the periodic Hann window.
//
// Bound on the card: like the timbral kernel, ~4 bytes of signal per sample
// in and 8 bytes per frame out, with ~14k f32 operations per frame on top.
// Design: one 256-thread block walks a run of 32 consecutive frames, starting
// one frame early, and keeps the previous frame's 257 magnitudes in shared
// memory, so the lookback costs one extra transform per 32 frames and no
// magnitude ever reaches device memory. The transform is a full-f32 radix-2
// FFT with integer-phase twiddles (the TPU kernel's bf16x3 products were a
// matrix-unit device, not needed here).
#include "fft_common.cuh"

namespace {

constexpr int kWin = 512;
constexpr int kLog2Win = 9;
constexpr int kBins = kWin / 2 + 1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFramesPerBlock = 32;

__global__ void __launch_bounds__(kThreads)
specflux_kernel(const float* __restrict__ x, long long t_len, int n_frames,
                int hop, int offset, const float* __restrict__ win,
                const float* __restrict__ tw_re,
                const float* __restrict__ tw_im, float* __restrict__ out) {
  __shared__ float re[kWin];
  __shared__ float im[kWin];
  __shared__ float prev[kBins];
  __shared__ float part[2][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xs = x + static_cast<long long>(blockIdx.y) * t_len;
  float* os = out + static_cast<long long>(blockIdx.y) * n_frames * 2;
  const int f0 = blockIdx.x * kFramesPerBlock;
  const int f1 = min(f0 + kFramesPerBlock, n_frames);

  for (int f = f0 - 1; f < f1; ++f) {
    const long long start = static_cast<long long>(f) * hop - offset;
    for (int n = tid; n < kWin; n += kThreads) {
      const long long s = start + n;
      const float v = (s >= 0 && s < t_len) ? xs[s] : 0.0f;
      const int r = bliss::bit_reverse(n, kLog2Win);
      re[r] = v * win[n];
      im[r] = 0.0f;
    }
    __syncthreads();
    bliss::fft_radix2_dit(re, im, kLog2Win, tw_re, tw_im, 1);

    // thread t owns bin t; thread 0 also owns the Nyquist bin 256
    const float m0 = sqrtf(re[tid] * re[tid] + im[tid] * im[tid]);
    const float m1 = tid == 0 ? sqrtf(re[kBins - 1] * re[kBins - 1] +
                                      im[kBins - 1] * im[kBins - 1])
                              : 0.0f;
    if (f >= f0) {
      float flux = fmaxf(m0 - prev[tid], 0.0f);
      if (tid == 0) flux += fmaxf(m1 - prev[kBins - 1], 0.0f);
      const float s_flux = bliss::warp_sum(flux);
      const float s_total = bliss::warp_sum(m0 + m1);
      if (lane == 0) {
        part[0][warp] = s_flux;
        part[1][warp] = s_total;
      }
    }
    __syncthreads();  // every read of prev and of the spectrum is done
    prev[tid] = m0;
    if (tid == 0) prev[kBins - 1] = m1;
    if (f >= f0 && tid == 0) {
      float flux = 0.0f, total = 0.0f;
      for (int w = 0; w < kWarps; ++w) {
        flux += part[0][w];
        total += part[1][w];
      }
      os[2 * static_cast<long long>(f)] = flux;
      os[2 * static_cast<long long>(f) + 1] = total;
    }
  }
}

}  // namespace

extern "C" int specflux_launch(const float* x, int batch, long long t_len,
                               int n_frames, int hop, int offset,
                               const float* win, const float* tw_re,
                               const float* tw_im, float* out,
                               cudaStream_t stream) {
  if (n_frames <= 0 || batch <= 0) return 0;
  const dim3 grid((n_frames + kFramesPerBlock - 1) / kFramesPerBlock, batch);
  specflux_kernel<<<grid, kThreads, 0, stream>>>(x, t_len, n_frames, hop,
                                                  offset, win, tw_re, tw_im,
                                                  out);
  return static_cast<int>(cudaGetLastError());
}
