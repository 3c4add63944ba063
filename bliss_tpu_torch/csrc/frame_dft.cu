// The Hann-windowed 512-sample strided frames of a signal: their DFT
// magnitudes by a warp-level FFT.
//
// frame_dft_mags_launch replaces the TPU kernel
// bliss_tpu/ops/pallas_dft.py:53 _make_kernel (via pallas_frame_dft_mags):
// out[b, f, k] = |sum_n x[b, f*hop - offset + n] * win[n] * W_512^(n*k)|,
// k in [0, 256], zeros outside [0, T). The TPU kernel forms that sum as a
// matrix product with a [512, 257] twiddle matrix, the shape its matrix unit
// wants; here the same magnitudes come from an FFT, bliss::warp_rfft512_mags
// (fft_common.cuh), in f32 at full precision with integer-exact twiddle phases.
//
// Bound on the card, frame_dft_mags: bytes. Per frame 1,028 bytes of
// magnitudes go out and 0.5-1 KB of signal comes in, against ~14k f32
// operations of an FFT. Design: a frame per warp, never a block-wide barrier
// inside a transform: the staged tile loop of frame_tiles.cuh (32-frame tiles
// staged once by cp.async, double buffered, twiddles in registers per block
// run), whose epilogue here stores a frame's 257 magnitudes as 8 runs of 32
// consecutive floats with streaming stores: the output is written once and
// never read back here.
//
// The timbral rows of the direct DFT of the same frames (pallas_dft.py:80
// _make_timbral_kernel) are timbral_flat.cu's.
#include "frame_tiles.cuh"

namespace {

constexpr int kWin = 512;
constexpr int kBins = kWin / 2 + 1;

// frame_dft_mags' epilogue: the 257 magnitudes of frame f to out[f].
struct MagsEpilogue {
  using Body = bliss::Rfft512Body;
  static constexpr int kLookback = 0;
  float* out;  // [n_frames, 257] of this song

  __device__ __forceinline__ int lookback_frames(bool, int) const { return 0; }

  __device__ __forceinline__ void frame(int f, int, float (&mag)[8], float nyq, int lane) {
    float* o = out + static_cast<long long>(f) * kBins;
#pragma unroll
    for (int r = 0; r < 8; ++r) __stcs(o + lane + 32 * r, mag[r]);
    if (lane == 0) __stcs(o + kWin / 2, nyq);
  }

  __device__ __forceinline__ void tile_done(int, int) {}
};

__global__ void __launch_bounds__(bliss::kTileThreads, 2)
frame_dft_mags_kernel(const float* __restrict__ x, long long t_len,
                      int n_frames, int hop, int offset, int tiles_per_block,
                      const float* __restrict__ win,
                      const float* __restrict__ tw_re,
                      const float* __restrict__ tw_im,
                      float* __restrict__ out) {
  MagsEpilogue ep{out + static_cast<long long>(blockIdx.y) * n_frames * kBins};
  bliss::frame_tiles(x, t_len, n_frames, hop, offset, tiles_per_block, win, tw_re,
                     tw_im, ep);
}

}  // namespace

extern "C" int frame_dft_mags_launch(const float* x, int batch, long long t_len,
                                     int n_frames, int hop, int offset,
                                     const float* win, const float* tw_re,
                                     const float* tw_im, float* out,
                                     cudaStream_t stream) {
  if (n_frames <= 0 || batch <= 0) return 0;
  if (bliss::frame_tiles_bad_hop(hop)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmemBytes =
      bliss::tile_smem_floats<MagsEpilogue::kLookback, MagsEpilogue::Body>() *
      static_cast<int>(sizeof(float));
  dim3 grid;
  int tiles_per_block = 0;
  const cudaError_t err = bliss::frame_tiles_launch_shape(
      frame_dft_mags_kernel, kSmemBytes, batch, n_frames, &grid, &tiles_per_block);
  if (err != cudaSuccess) return static_cast<int>(err);
  frame_dft_mags_kernel<<<grid, bliss::kTileThreads, kSmemBytes, stream>>>(
      x, t_len, n_frames, hop, offset, tiles_per_block, win, tw_re, tw_im, out);
  return static_cast<int>(cudaGetLastError());
}
