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
// Accuracy: the spectrum must come from an f32 FFT. The reference's f32 FFT
// roundings bias the flatness of quiet frames; a near-exact DFT sits ~1.1e-4
// from the reference value, over the 1e-4 contract, while an f32 FFT lands
// ~2e-5 from it. Each frame's geometric mean (the log2 sum) is held within
// 1e-4 of the plain version's (torch.fft.rfft, cuFFT on the card), and on a
// frame with one bin near zero under a loud peak that sum follows the
// rounding of that one bin. The 8 x 8 x 4 body of warp_rfft512_mags, nearer
// exact arithmetic there than cuFFT, crossed that limit on one frame of a
// 60-minute synthetic song on an H100 (1.02e-4; it sat 2.2e-5 from an f64
// FFT of the same f32 windowed frame, cuFFT 1.24e-4), while fft_radix2_dit's
// arithmetic stays within it on every frame measured. So the spectrum is
// that arithmetic on a warp's schedule (warp_radix2_512_mags: the same
// butterflies, integer-phase twiddles and stage order, the windowed samples
// rounded to f32 first, no matmul DFT).
//
// Bound on the card: operations, with bytes close behind. The signal is read
// once (4 bytes a sample, each shared by four overlapping frames) and 20
// bytes go out a frame, against ~14k f32 operations of a real FFT (the
// radix-2 complex body does about twice that) and ~3k of the reductions a
// frame. Design: the staged tile loop of frame_tiles.cuh, a frame a warp,
// never a block-wide barrier inside a transform; the epilogue
// reduces the magnitudes where the transform leaves them, lane q holding
// slots q + 32 r in register r: total, weighted and log2 sum are warp sums,
// and the rolloff prefix sum is eight 32-slot warp scans taken left to right
// with a carry (the chunks and the order of the block-wide scan of
// timbral_rows.cuh, so the count keeps its rounding), counted by ballot. No
// magnitude reaches device memory: 5 floats a frame go out.
#include "frame_tiles.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct TimbralEpilogue {
  using Body = bliss::Radix2Body;
  static constexpr int kLookback = 0;
  float* out;  // [n_frames, 5] of this song

  __device__ __forceinline__ int lookback_frames(bool, int) const { return 0; }

  __device__ __forceinline__ void frame(int f, int, float (&mag)[8], float nyq, int lane) {
    // slot 255 carries the Nyquist bin, which lane 0 holds
    const float nyquist = __shfl_sync(kFull, nyq, 0);
    if (lane == 31) mag[7] = nyquist;
    float total = 0.0f, weighted = 0.0f, logsum = 0.0f;
    float cum[8];
    float energy = 0.0f;  // the sum of the chunks before this one, then of all
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float m = mag[r];
      total += m;
      weighted += m * static_cast<float>(lane + 32 * r);
      logsum += log2f(m);
      float c = m * m;  // inclusive scan of chunk r (slots 32 r .. 32 r + 31)
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const float y = __shfl_up_sync(kFull, c, s);
        if (lane >= s) c += y;
      }
      cum[r] = c + energy;
      energy += __shfl_sync(kFull, c, 31);
    }
    const float target = energy * 0.95f;
    int below = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) below += __popc(__ballot_sync(kFull, cum[r] < target));
    total = bliss::warp_sum(total);
    weighted = bliss::warp_sum(weighted);
    logsum = bliss::warp_sum(logsum);
    if (lane == 0) {
      float* o = out + static_cast<long long>(f) * 5;
      o[0] = total;
      o[1] = weighted;
      o[2] = static_cast<float>(below);
      o[3] = logsum;
      o[4] = energy;
    }
  }

  __device__ __forceinline__ void tile_done(int, int) {}
};

__global__ void __launch_bounds__(bliss::kTileThreads, 2)
timbral_fft_kernel(const float* __restrict__ x, long long t_len, int n_frames,
                   int hop, int offset, int tiles_per_block,
                   const float* __restrict__ win, const float* __restrict__ tw_re,
                   const float* __restrict__ tw_im, float* __restrict__ out) {
  TimbralEpilogue ep{out + static_cast<long long>(blockIdx.y) * n_frames * 5};
  bliss::frame_tiles(x, t_len, n_frames, hop, offset, tiles_per_block, win, tw_re,
                     tw_im, ep);
}

}  // namespace

extern "C" int timbral_fft_launch(const float* x, int batch, long long t_len,
                                  int n_frames, int hop, int offset,
                                  const float* win, const float* tw_re,
                                  const float* tw_im, float* out,
                                  cudaStream_t stream) {
  if (n_frames <= 0 || batch <= 0) return 0;
  if (bliss::frame_tiles_bad_hop(hop)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmemBytes =
      bliss::tile_smem_floats<TimbralEpilogue::kLookback, TimbralEpilogue::Body>() *
      static_cast<int>(sizeof(float));
  dim3 grid;
  int tiles_per_block = 0;
  const cudaError_t err = bliss::frame_tiles_launch_shape(
      timbral_fft_kernel, kSmemBytes, batch, n_frames, &grid, &tiles_per_block);
  if (err != cudaSuccess) return static_cast<int>(err);
  timbral_fft_kernel<<<grid, bliss::kTileThreads, kSmemBytes, stream>>>(
      x, t_len, n_frames, hop, offset, tiles_per_block, win, tw_re, tw_im, out);
  return static_cast<int>(cudaGetLastError());
}
