// The staged frame loop of the three kernels over the 512-sample strided
// frames of a signal (frame_dft.cu's frame_dft_mags_kernel, timbral_fft.cu,
// specflux.cu): one 512-point FFT a warp, never a block-wide barrier inside
// a transform, and a per-frame epilogue that takes the magnitudes in
// registers.
//
// A 256-thread block walks a run of 32-frame tiles of one song (blockIdx.y).
// A tile's contiguous sample span (frames overlap 2-4x) is staged once into
// shared memory by 4-byte cp.async, double buffered, so the next tile loads
// while the 8 warps transform this one; zeros outside [0, T) and a negative
// offset are handled while staging, at the span's edges only. Warp w takes
// the run of frames 4w .. 4w+3 of a tile. The twiddles are loaded once per
// block run.
//
// The transform is a body: Rfft512Body (warp_rfft512_mags, 8 x 8 x 4 over 256
// complex points and the real-input untangling) or Radix2Body
// (warp_radix2_512_mags, fft_radix2_dit's arithmetic on a warp's schedule).
//
// An epilogue is a struct with
//   using Body = ...;                // the transform
//   static constexpr int kLookback;  // frames staged before a tile's first (0, 1)
//   int lookback_frames(bool first_tile, int warp);  // 0 .. kLookback: frames
//       4w - n .. 4w - 1 this warp transforms before its own, passed as i < 0
//   void frame(int f, int i, float (&mag)[8], float nyq, int lane);
//       frame f, the i-th of this warp's tile; lane q holds |X[q + 32 r]| in
//       mag[r], lane 0's nyq is |X[256]|; every lane of the warp calls it
//   void tile_done(int warp, int lane);  // after the tile's closing barrier
//
// Compile-time switches, for measuring where the time goes
// (benches/frame_fft_variants.py builds one library per setting; the
// package builds the defaults): BLISS_FRAME_FFT_PROBE 0 the kernel, 1 the
// transform without the epilogue, 2 staging and the epilogue without the
// transform (wrong output), 3 frame_dft_mags with ordinary stores instead of
// streaming ones, 4 staging alone; BLISS_FRAME_FFT_TILE frames a tile (a
// multiple of 8); BLISS_FRAME_FFT_WAVES the waves of resident blocks the
// launch aims at.
#pragma once

#include "fft_common.cuh"

#ifndef BLISS_FRAME_FFT_TILE
#define BLISS_FRAME_FFT_TILE 32
#endif
#ifndef BLISS_FRAME_FFT_WAVES
#define BLISS_FRAME_FFT_WAVES 4
#endif
#ifndef BLISS_FRAME_FFT_PROBE
#define BLISS_FRAME_FFT_PROBE 0
#endif

namespace bliss {

constexpr int kTileWin = 512;
constexpr int kTileBins = kTileWin / 2 + 1;
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileFrames = BLISS_FRAME_FFT_TILE;
constexpr int kWarpFrames = kTileFrames / kTileWarps;
constexpr int kTileMaxHop = 256;
static_assert(kTileFrames % kTileWarps == 0, "a tile is a whole run a warp");

// floats of one staging buffer: the span of a tile's frames and of the
// kLookback frames before them
template <int kLookback>
__host__ __device__ constexpr int tile_span_floats() {
  return (kTileFrames + kLookback - 1) * kTileMaxHop + kTileWin;
}

// The 8 x 8 x 4 warp FFT: twiddles in registers, loaded once a block run.
struct Rfft512Body {
  static constexpr int kTableFloats = 0;
  static constexpr int kScratchFloats = kWarpFftScratch;
  WarpFftTwiddles tw;

  __device__ __forceinline__ void load(const float*, const float* __restrict__ tw_re,
                                       const float* __restrict__ tw_im, float*, int lane) {
    tw.load(tw_re, tw_im, lane);
  }
  __device__ __forceinline__ void mags(const float* sig, const float* win, float* scratch,
                                       int lane, float (&mag)[8], float& nyq) const {
    warp_rfft512_mags(sig, win, scratch, tw, lane, mag, nyq);
  }
};

// fft_radix2_dit's arithmetic on a warp: the window at a lane's samples and
// the twiddles of stages 1-4 in registers, those of stages 5-9 in a shared
// table, stage by stage, that the block fills once a run (published by the
// first tile's barrier).
struct Radix2Body {
  static constexpr int kTableFloats = 2 * kRadix2StageTwiddles;
  static constexpr int kScratchFloats = kWarpRadix2Scratch;
  WarpRadix2Constants c;
  const float2* tw;

  __device__ __forceinline__ void load(const float* __restrict__ win,
                                       const float* __restrict__ tw_re,
                                       const float* __restrict__ tw_im, float* table, int lane) {
    float2* t = reinterpret_cast<float2*>(table);
    for (int i = threadIdx.x; i < kRadix2StageTwiddles; i += blockDim.x) {
      t[i] = radix2_stage_twiddle(tw_re, tw_im, i);
    }
    tw = t;
    c.load(win, tw_re, tw_im, lane);
  }
  __device__ __forceinline__ void mags(const float* sig, const float*, float* scratch,
                                       int lane, float (&mag)[8], float& nyq) const {
    warp_radix2_512_mags(sig, c, scratch, tw, lane, mag, nyq);
  }
};

// floats of dynamic shared memory: two staging buffers, the window, the
// body's table, the body's scratch of every warp
template <int kLookback, class Body>
__host__ __device__ constexpr int tile_smem_floats() {
  return 2 * tile_span_floats<kLookback>() + kTileWin + Body::kTableFloats +
         kTileWarps * Body::kScratchFloats;
}

// Start the copy of the samples of tile `tile` of one song, and of the
// kLookback frames before it, into `dst`; zeros where the span leaves
// [0, t_len). One commit group per call and thread.
template <int kLookback>
__device__ __forceinline__ void stage_tile_async(float* dst, const float* __restrict__ xs,
                                                 long long t_len, int tile, int hop,
                                                 int offset) {
  const int span = (kTileFrames + kLookback - 1) * hop + kTileWin;
  const long long start =
      (static_cast<long long>(tile) * kTileFrames - kLookback) * hop - offset;
  for (int i = threadIdx.x; i < span; i += kTileThreads) {
    const long long s = start + i;
    if (s >= 0 && s < t_len) {
      cp_async<4>(dst + i, xs + s);
    } else {
      dst[i] = 0.0f;
    }
  }
  cp_async_commit();
}

// The tile loop of one block: frame f of song blockIdx.y covers
// x[b, f*hop - offset + n], n in [0, 512), times the window; every frame
// f < n_frames of the block's tiles reaches ep.frame once (and a lookback
// frame once more where the epilogue asks for it). Needs
// tile_smem_floats<Epilogue::kLookback, Epilogue::Body>() floats of dynamic
// shared memory.
template <class Epilogue>
__device__ __forceinline__ void frame_tiles(const float* __restrict__ x, long long t_len,
                                            int n_frames, int hop, int offset,
                                            int tiles_per_block,
                                            const float* __restrict__ win,
                                            const float* __restrict__ tw_re,
                                            const float* __restrict__ tw_im,
                                            Epilogue& ep) {
  using Body = typename Epilogue::Body;
  constexpr int kLookback = Epilogue::kLookback;
  constexpr int kSpan = tile_span_floats<kLookback>();
  extern __shared__ __align__(16) float smem[];
  float* wins = smem + 2 * kSpan;
  float* table = wins + kTileWin;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* scratch = table + Body::kTableFloats + warp * Body::kScratchFloats;

  const int n_tiles = (n_frames + kTileFrames - 1) / kTileFrames;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, n_tiles);
  if (t_begin >= t_end) return;
  const float* xs = x + static_cast<long long>(blockIdx.y) * t_len;

  stage_tile_async<kLookback>(smem, xs, t_len, t_begin, hop, offset);
  for (int i = tid; i < kTileWin; i += kTileThreads) wins[i] = win[i];
  Body body;
  body.load(win, tw_re, tw_im, table, lane);

  for (int t = t_begin; t < t_end; ++t) {
    const float* cur = smem + ((t - t_begin) & 1) * kSpan;
    if (t + 1 < t_end) {
      // the other buffer was last read before the barrier that ended tile t - 1
      stage_tile_async<kLookback>(smem + ((t + 1 - t_begin) & 1) * kSpan, xs, t_len, t + 1,
                                  hop, offset);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and the window) is visible to every warp
    for (int i = -ep.lookback_frames(t == t_begin, warp); i < kWarpFrames; ++i) {
      const int j = warp * kWarpFrames + i;  // frame of the tile, -kLookback .. 31
      const int f = t * kTileFrames + j;
      if (f >= n_frames) break;
      const float* sig = cur + (j + kLookback) * hop;
      float mag[8], nyq;
#if BLISS_FRAME_FFT_PROBE == 2 || BLISS_FRAME_FFT_PROBE == 4
#pragma unroll
      for (int r = 0; r < 8; ++r) mag[r] = sig[lane + 32 * r] * wins[lane + 32 * r];
      nyq = mag[0];
#else
      body.mags(sig, wins, scratch, lane, mag, nyq);
#endif
#if BLISS_FRAME_FFT_PROBE == 1 || BLISS_FRAME_FFT_PROBE == 4
      bool never = nyq == -1.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r) never |= mag[r] == -1.0f;
      if (never) ep.frame(f, i, mag, nyq, lane);
#else
      ep.frame(f, i, mag, nyq, lane);
#endif
    }
    __syncthreads();  // every warp is done with tile t's buffer
    ep.tile_done(warp, lane);
  }
}

// The launch of a frame_tiles kernel for `batch` songs of n_frames frames:
// a block walks a run of tiles, long enough to amortise its twiddle loads
// and to overlap staging with transforms, short enough for ~4 waves of the
// 2 blocks an SM holds.
template <class Kernel>
cudaError_t frame_tiles_launch_shape(Kernel* kernel, int smem_bytes, int batch,
                                     int n_frames, dim3* grid, int* tiles_per_block) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_frames + kTileFrames - 1) / kTileFrames;
  const long long want_blocks = static_cast<long long>(sms) * 2 * BLISS_FRAME_FFT_WAVES;
  const long long all_tiles = static_cast<long long>(n_tiles) * batch;
  int run = static_cast<int>((all_tiles + want_blocks - 1) / want_blocks);
  if (run < 1) run = 1;
  *tiles_per_block = run;
  *grid = dim3((n_tiles + run - 1) / run, batch);
  return cudaSuccess;
}

// The hops the staging takes: a multiple of 4 (16-byte aligned frames in
// shared memory are not needed, 8-byte ones are) up to kTileMaxHop.
inline bool frame_tiles_bad_hop(int hop) {
  return hop <= 0 || hop > kTileMaxHop || hop % 4 != 0;
}

}  // namespace bliss
