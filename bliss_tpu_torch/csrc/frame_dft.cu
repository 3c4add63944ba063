// The Hann-windowed 512-sample strided frames of a signal: their DFT
// magnitudes by a warp-level FFT, and the timbral rows of a direct
// (matrix-product) DFT.
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
// timbral_flat_launch replaces the TPU kernel
// bliss_tpu/ops/pallas_dft.py:80 _make_timbral_kernel (via
// pallas_frame_dft_timbral with the flat kernel selected): the direct DFT
// over aubio's buggy 256-slot layout (slot 255 carries the Nyquist bin,
// src/aubio.rs:237-261), the partial sums of the four 128-sample chunks of a
// frame combined with the reference's Neumaier step,
// then the five per-frame reductions of timbral_rows.cuh, so the [F, 256]
// magnitudes never reach device memory. A near-exact DFT sits farther from
// the reference's f32 FFT than another f32 FFT does on quiet frames; the
// default timbral route is timbral_fft.cu, this one exists to be measured.
// It is the product the TPU kernel forms in its own body, in f32 FMAs at
// full precision (never TF32), with an integer-exact phase: the twiddle of
// (n, k) is entry (n*k) & 511 of a 512-entry cos/-sin table in shared memory,
// unfolded from the host's f64-rounded [2, 257] table. No [512, 257] twiddle
// matrix exists in device memory.
//
// Bound on the card, timbral_flat: operations. Per frame 512 window products
// and 512 x 256 x 2 FMAs (~0.52 MFLOP) against 0.5 KB of signal in and 20
// bytes out. Design: one 256-thread block per tile of 8 frames; the tile's
// sample span is staged in shared memory once; thread k owns slot k of every
// frame of the tile, so one twiddle lookup feeds 8 frames' FMAs, and the
// samples are read as broadcast float4.
#include "frame_tiles.cuh"
#include "timbral_rows.cuh"

namespace {

constexpr int kWin = 512;
constexpr int kThreads = bliss::kRowThreads;
constexpr int kMaxHop = bliss::kTileMaxHop;
constexpr int kChunk = 128;      // the reference's partial-sum width
constexpr int kRowFrames = 8;    // frames per block, timbral rows
constexpr int kBins = kWin / 2 + 1;

template <int FT>
struct Tile {
  float sig[(FT - 1) * kMaxHop + kWin];
  float tw[2 * kWin];  // cos(2*pi*p/512), then -sin(2*pi*p/512)
  float win[kWin];
};

// Stage the samples of frames [f0, f0 + FT) of one song, the unfolded twiddle
// table and the window. Ends with a __syncthreads().
template <int FT>
__device__ __forceinline__ void stage(Tile<FT>& t, const float* __restrict__ xs,
                                      long long t_len, long long start, int hop,
                                      const float* __restrict__ win,
                                      const float* __restrict__ tw_re,
                                      const float* __restrict__ tw_im) {
  const int span = (FT - 1) * hop + kWin;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long s = start + i;
    t.sig[i] = (s >= 0 && s < t_len) ? xs[s] : 0.0f;
  }
  for (int p = threadIdx.x; p < kWin; p += kThreads) {
    // the table holds phases [0, 256]; cos is even and sin odd about 256
    const int q = p <= kWin / 2 ? p : kWin - p;
    t.tw[p] = tw_re[q];
    t.tw[kWin + p] = p <= kWin / 2 ? tw_im[q] : -tw_im[q];
    t.win[p] = win[p];
  }
  __syncthreads();
}

// re[f] += sum_n xw[f, n] * cos[(n*k_re) & 511] and
// im[f] += sum_n xw[f, n] * tw[im_tab + ((n*k_im) & 511)] over n in
// [n_lo, n_hi), xw[f, n] = sig[f*hop + n] * win[n], n ascending; im_tab is
// kWin for the -sin half of the table, 0 for the cos half. hop and n_lo are
// multiples of 4, so every float4 read is aligned.
template <int FT>
__device__ __forceinline__ void accumulate(const Tile<FT>& t, int hop, int k_re,
                                           int k_im, int im_tab,
                                           int n_lo, int n_hi, float (&re)[FT],
                                           float (&im)[FT]) {
  for (int n = n_lo; n < n_hi; n += 4) {
    float c[4], s[4], w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = t.tw[((n + j) * k_re) & (kWin - 1)];
      s[j] = t.tw[im_tab + (((n + j) * k_im) & (kWin - 1))];
      w[j] = t.win[n + j];
    }
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      const float4 v = *reinterpret_cast<const float4*>(&t.sig[f * hop + n]);
      const float x[4] = {v.x * w[0], v.y * w[1], v.z * w[2], v.w * w[3]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        re[f] = fmaf(x[j], c[j], re[f]);
        im[f] = fmaf(x[j], s[j], im[f]);
      }
    }
  }
}

// frame_dft_mags' epilogue: the 257 magnitudes of frame f to out[f].
struct MagsEpilogue {
  using Body = bliss::Rfft512Body;
  static constexpr int kLookback = 0;
  float* out;  // [n_frames, 257] of this song

  __device__ __forceinline__ int lookback_frames(bool, int) const { return 0; }

  __device__ __forceinline__ void frame(int f, int, float (&mag)[8], float nyq, int lane) {
    float* o = out + static_cast<long long>(f) * kBins;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#if BLISS_FRAME_FFT_PROBE == 3
      o[lane + 32 * r] = mag[r];
#else
      __stcs(o + lane + 32 * r, mag[r]);
#endif
    }
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

// Neumaier-compensated s += p, the compensation kept in c.
__device__ __forceinline__ void comp_add(float& s, float& c, float p) {
  const float t = s + p;
  c += fabsf(s) >= fabsf(p) ? (s - t) + p : (p - t) + s;
  s = t;
}

__global__ void __launch_bounds__(kThreads)
timbral_flat_kernel(const float* __restrict__ x, long long t_len, int n_frames,
                    int hop, int offset, const float* __restrict__ win,
                    const float* __restrict__ tw_re,
                    const float* __restrict__ tw_im, float* __restrict__ out) {
  __shared__ __align__(16) Tile<kRowFrames> t;
  __shared__ bliss::RowScratch rows;
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kRowFrames;
  stage(t, x + static_cast<long long>(blockIdx.y) * t_len, t_len,
        static_cast<long long>(f0) * hop - offset, hop, win, tw_re, tw_im);

  // slot tid of the buggy layout: bin tid, the last slot the Nyquist bin
  const int k = tid == kThreads - 1 ? kWin / 2 : tid;
  float re[kRowFrames], im[kRowFrames], re_c[kRowFrames], im_c[kRowFrames];
#pragma unroll
  for (int f = 0; f < kRowFrames; ++f) re[f] = im[f] = re_c[f] = im_c[f] = 0.0f;
  for (int c = 0; c < kWin / kChunk; ++c) {
    float pre[kRowFrames], pim[kRowFrames];
#pragma unroll
    for (int f = 0; f < kRowFrames; ++f) pre[f] = pim[f] = 0.0f;
    accumulate(t, hop, k, k, kWin, c * kChunk, (c + 1) * kChunk, pre, pim);
#pragma unroll
    for (int f = 0; f < kRowFrames; ++f) {
      comp_add(re[f], re_c[f], pre[f]);
      comp_add(im[f], im_c[f], pim[f]);
    }
  }

  float* os = out + static_cast<long long>(blockIdx.y) * n_frames * 5;
#pragma unroll
  for (int f = 0; f < kRowFrames; ++f) {
    const float r = re[f] + re_c[f];
    const float i = im[f] + im_c[f];
    const bool live = f0 + f < n_frames;
    bliss::timbral_row_store(
        sqrtf(r * r + i * i), rows,
        live ? os + static_cast<long long>(f0 + f) * 5 : nullptr);
    __syncthreads();
  }
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

extern "C" int timbral_flat_launch(const float* x, int batch, long long t_len,
                                   int n_frames, int hop, int offset,
                                   const float* win, const float* tw_re,
                                   const float* tw_im, float* out,
                                   cudaStream_t stream) {
  if (n_frames <= 0 || batch <= 0) return 0;
  if (bliss::frame_tiles_bad_hop(hop)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_frames + kRowFrames - 1) / kRowFrames, batch);
  timbral_flat_kernel<<<grid, kThreads, 0, stream>>>(
      x, t_len, n_frames, hop, offset, win, tw_re, tw_im, out);
  return static_cast<int>(cudaGetLastError());
}
