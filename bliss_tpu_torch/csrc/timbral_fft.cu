// Timbral descriptor rows from an FFT-structured spectrum.
//
// Replaces the TPU kernel bliss_tpu/ops/pallas_dft.py:_make_timbral_fft_kernel
// (via pallas_frame_dft_timbral). For every 512/128 frame of every song it
// emits the raw per-frame reductions over aubio's buggy 256-bin layout
// (bins 0..254, then the Nyquist bin in slot 255, src/aubio.rs:237-261):
//   [total, weighted-by-slot, below (rolloff count), log2 sum, energy].
//
// Frame f of song b covers x[b, f*hop - offset + n], n in [0, 512), zero
// outside [0, T), times the periodic Hann window.
//
// Accuracy: the spectrum must come from an f32 radix-2 FFT. The reference's
// f32 FFT roundings bias the flatness of quiet frames; a near-exact DFT sits
// ~1.1e-4 from the reference value, over the 1e-4 contract, while an f32
// radix-2 FFT lands ~2e-5 from it. So this kernel runs a plain 9-stage
// radix-2 FFT in shared memory, never a matmul DFT.
//
// Bound on the card: the signal is read once (~4 bytes per sample, shared by
// four overlapping frames through L1/L2) and 20 bytes go out per frame; the
// ~14k f32 operations per frame put the operation bound slightly above the
// byte bound. Design: one 256-thread block per tile of 16 frames (one thread
// per kept bin), the whole frame and its transform live in 4 KB of shared
// memory, and the rolloff prefix sum is a warp-shuffle scan
// (timbral_rows.cuh), so nothing but the 5 output floats per frame touches
// device memory.
#include "timbral_rows.cuh"

namespace {

constexpr int kWin = 512;
constexpr int kLog2Win = 9;
constexpr int kThreads = bliss::kRowThreads;
constexpr int kFramesPerBlock = 16;

__global__ void __launch_bounds__(kThreads)
timbral_fft_kernel(const float* __restrict__ x, long long t_len, int n_frames,
                   int hop, int offset, const float* __restrict__ win,
                   const float* __restrict__ tw_re,
                   const float* __restrict__ tw_im, float* __restrict__ out) {
  __shared__ float re[kWin];
  __shared__ float im[kWin];
  __shared__ bliss::RowScratch rows;

  const int tid = threadIdx.x;
  const float* xs = x + static_cast<long long>(blockIdx.y) * t_len;
  float* os = out + static_cast<long long>(blockIdx.y) * n_frames * 5;
  const int f0 = blockIdx.x * kFramesPerBlock;
  const int f1 = min(f0 + kFramesPerBlock, n_frames);

  for (int f = f0; f < f1; ++f) {
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

    // slot tid of the buggy layout: bin tid, except the last slot which
    // carries the Nyquist bin
    const int k = tid == kThreads - 1 ? kWin / 2 : tid;
    const float mr = re[k];
    const float mi = im[k];
    const float mag = sqrtf(mr * mr + mi * mi);
    // the next frame's loads end in a __syncthreads() before `rows` is
    // written again
    bliss::timbral_row_store(mag, rows,
                             os + static_cast<long long>(f) * 5);
  }
}

}  // namespace

extern "C" int timbral_fft_launch(const float* x, int batch, long long t_len,
                                  int n_frames, int hop, int offset,
                                  const float* win, const float* tw_re,
                                  const float* tw_im, float* out,
                                  cudaStream_t stream) {
  if (n_frames <= 0 || batch <= 0) return 0;
  const dim3 grid((n_frames + kFramesPerBlock - 1) / kFramesPerBlock, batch);
  timbral_fft_kernel<<<grid, kThreads, 0, stream>>>(
      x, t_len, n_frames, hop, offset, win, tw_re, tw_im, out);
  return static_cast<int>(cudaGetLastError());
}
