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
// outside [0, T), times the periodic Hann window; frame -1, the first
// frame's lookback, is such a frame too.
//
// Bound on the card: bytes. ~4 bytes of signal per sample in and 8 bytes per
// frame out, with ~14k f32 operations per frame on top. Design: the staged
// tile loop of frame_tiles.cuh, a frame a warp, never a block-wide barrier
// inside a transform, in f32 with integer-phase twiddles (the TPU kernel's
// bf16x3 products were a matrix-unit device, not needed here). Warp w walks
// frames 4w .. 4w+3 of a 32-frame tile and keeps the previous frame's
// magnitudes in registers, so no magnitude reaches device memory. The
// lookback of a warp's first frame is the last frame of warp w - 1: each
// warp publishes its last frame's 257 magnitudes to a shared edge buffer and
// finishes its first frame after the tile's closing barrier; warp 0 keeps
// warp 7's edge in registers for the next tile, and transforms the frame
// before the block's first tile itself, one extra transform a block run.
// (Every warp transforming its own lookback frame instead, 5 transforms for
// 4 frames and no edge buffer, measured 7% slower on an H100.)
#include "frame_tiles.cuh"

namespace {

constexpr int kBins = bliss::kTileBins;
constexpr int kEdgeStride = 264;  // floats of one warp's edge: 257, padded

struct FluxEpilogue {
  using Body = bliss::Rfft512Body;
  static constexpr int kLookback = 1;
  float* out;    // [n_frames, 2] of this song
  float* edges;  // shared [kTileWarps][kEdgeStride]: each warp's last frame
  float prev[8], prev_nyq;    // the frame before the next one this warp takes
  float first[8], first_nyq;  // this warp's first frame of the tile, waiting
  int first_f;                // for its lookback; -1: none waits

  __device__ __forceinline__ int lookback_frames(bool first_tile, int warp) const {
    return first_tile && warp == 0 ? 1 : 0;
  }

  // flux and total of frame f against its lookback, written by lane 0
  __device__ __forceinline__ void emit(int f, const float (&m)[8], float nyq,
                                       const float (&lb)[8], float lb_nyq,
                                       int lane) const {
    float flux = 0.0f, total = 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      flux += fmaxf(m[r] - lb[r], 0.0f);
      total += m[r];
    }
    if (lane == 0) {  // bin 256
      flux += fmaxf(nyq - lb_nyq, 0.0f);
      total += nyq;
    }
    flux = bliss::warp_sum(flux);
    total = bliss::warp_sum(total);
    if (lane == 0) {
      *reinterpret_cast<float2*>(out + 2 * static_cast<long long>(f)) =
          make_float2(flux, total);
    }
  }

  __device__ __forceinline__ void frame(int f, int i, float (&mag)[8], float nyq, int lane) {
    const int warp = threadIdx.x >> 5;
    if (i > 0 || (i == 0 && warp == 0)) {
      emit(f, mag, nyq, prev, prev_nyq, lane);
    } else if (i == 0) {
      first_f = f;
#pragma unroll
      for (int r = 0; r < 8; ++r) first[r] = mag[r];
      first_nyq = nyq;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) prev[r] = mag[r];
    prev_nyq = nyq;
    if (i == bliss::kWarpFrames - 1) {
      float* e = edges + warp * kEdgeStride;
#pragma unroll
      for (int r = 0; r < 8; ++r) e[lane + 32 * r] = mag[r];
      if (lane == 0) e[kBins - 1] = nyq;
    }
  }

  // after the tile's closing barrier: the waiting first frames take warp
  // w - 1's edge, and warp 0 carries warp 7's into the next tile
  __device__ __forceinline__ void tile_done(int warp, int lane) {
    const float* e = edges + ((warp + bliss::kTileWarps - 1) % bliss::kTileWarps) * kEdgeStride;
    float lb[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) lb[r] = e[lane + 32 * r];
    const float lb_nyq = e[kBins - 1];
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r) prev[r] = lb[r];
      prev_nyq = lb_nyq;
    } else if (first_f >= 0) {
      emit(first_f, first, first_nyq, lb, lb_nyq, lane);
    }
    first_f = -1;
  }
};

__global__ void __launch_bounds__(bliss::kTileThreads, 2)
specflux_kernel(const float* __restrict__ x, long long t_len, int n_frames,
                int hop, int offset, int tiles_per_block,
                const float* __restrict__ win, const float* __restrict__ tw_re,
                const float* __restrict__ tw_im, float* __restrict__ out) {
  __shared__ __align__(16) float edges[bliss::kTileWarps * kEdgeStride];
  FluxEpilogue ep;
  ep.out = out + static_cast<long long>(blockIdx.y) * n_frames * 2;
  ep.edges = edges;
  ep.first_f = -1;
  bliss::frame_tiles(x, t_len, n_frames, hop, offset, tiles_per_block, win, tw_re,
                     tw_im, ep);
}

}  // namespace

extern "C" int specflux_launch(const float* x, int batch, long long t_len,
                               int n_frames, int hop, int offset,
                               const float* win, const float* tw_re,
                               const float* tw_im, float* out,
                               cudaStream_t stream) {
  if (n_frames <= 0 || batch <= 0) return 0;
  if (bliss::frame_tiles_bad_hop(hop)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmemBytes =
      bliss::tile_smem_floats<FluxEpilogue::kLookback, FluxEpilogue::Body>() *
      static_cast<int>(sizeof(float));
  dim3 grid;
  int tiles_per_block = 0;
  const cudaError_t err = bliss::frame_tiles_launch_shape(
      specflux_kernel, kSmemBytes, batch, n_frames, &grid, &tiles_per_block);
  if (err != cudaSuccess) return static_cast<int>(err);
  specflux_kernel<<<grid, bliss::kTileThreads, kSmemBytes, stream>>>(
      x, t_len, n_frames, hop, offset, tiles_per_block, win, tw_re, tw_im, out);
  return static_cast<int>(cudaGetLastError());
}
