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
// FFT of the same f32 windowed frame, cuFFT 1.24e-4), while a block-wide
// radix-2 FFT's arithmetic stays within it on every frame measured. So the
// spectrum is that arithmetic on a warp's schedule (warp_radix2_512_mags:
// the same butterflies, integer-phase twiddles and stage order, the windowed
// samples rounded to f32 first, no matmul DFT).
//
// Bound on the card: operations, with bytes close behind. The signal is read
// once (4 bytes a sample, each shared by four overlapping frames) and 20
// bytes go out a frame, against ~14k f32 operations of a real FFT (the
// radix-2 complex body does about twice that) and ~3k of the reductions a
// frame. Design: the staged tile loop of frame_tiles.cuh, a frame a warp,
// never a block-wide barrier inside a transform; the epilogue
// reduces the magnitudes where the transform leaves them, lane q holding
// slots q + 32 r in register r (timbral_rows.cuh's warp_timbral_row, which
// timbral_flat.cu shares). No magnitude reaches device memory: 5 floats a
// frame go out.
#include "frame_tiles.cuh"
#include "timbral_rows.cuh"

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
    bliss::warp_timbral_row(mag, lane, out + static_cast<long long>(f) * 5);
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
