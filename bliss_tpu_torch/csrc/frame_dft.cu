// Direct (matrix-product) DFT of the Hann-windowed 512-sample strided frames
// of a signal: the magnitudes, or the timbral rows of the magnitudes.
//
// frame_dft_mags_launch replaces the TPU kernel
// bliss_tpu/ops/pallas_dft.py:53 _make_kernel (via pallas_frame_dft_mags):
// out[b, f, k] = |sum_n x[b, f*hop - offset + n] * win[n] * W_512^(n*k)|,
// k in [0, 256], zeros outside [0, T).
//
// timbral_flat_launch replaces the TPU kernel
// bliss_tpu/ops/pallas_dft.py:80 _make_timbral_kernel (via
// pallas_frame_dft_timbral with the flat kernel selected): the same transform
// over aubio's buggy 256-slot layout (slot 255 carries the Nyquist bin,
// src/aubio.rs:237-261), the partial sums of the four 128-sample chunks of a
// frame combined with the reference's Neumaier step,
// then the five per-frame reductions of timbral_rows.cuh, so the [F, 256]
// magnitudes never reach device memory. A near-exact DFT sits farther from
// the reference's f32 FFT than another f32 FFT does on quiet frames; the
// default timbral route is timbral_fft.cu, this one exists to be measured.
//
// Both are the product the TPU kernel forms in its own body, in f32 FMAs at
// full precision (never TF32), with an integer-exact phase: the twiddle of
// (n, k) is entry (n*k) & 511 of a 512-entry cos/-sin table in shared memory,
// unfolded from the host's f64-rounded [2, 257] table. No [512, 257] twiddle
// matrix exists in device memory.
//
// Bound on the card: operations. Per frame 512 window products and
// 512 x 257 x 2 FMAs (~0.53 MFLOP) against 0.5-1 KB of signal in and 1 KB
// (magnitudes) or 20 bytes (rows) out. Design: one 256-thread block per tile
// of frames; the tile's sample span is staged in shared memory once (frames
// overlap 2-4x); thread k owns bin k of every frame of the tile, so one
// twiddle lookup feeds 16 (magnitudes) or 8 (rows) frames' FMAs, and the
// samples are read as broadcast float4. Bins 0 and 256 have no imaginary
// part, so thread 0 carries the Nyquist bin in its imaginary accumulator and
// 256 threads cover 257 bins.
#include "timbral_rows.cuh"

namespace {

constexpr int kWin = 512;
constexpr int kThreads = bliss::kRowThreads;
constexpr int kMaxHop = 256;
constexpr int kChunk = 128;      // the reference's partial-sum width
constexpr int kMagFrames = 16;   // frames per block, magnitudes
constexpr int kRowFrames = 8;    // frames per block, timbral rows

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

__global__ void __launch_bounds__(kThreads)
frame_dft_mags_kernel(const float* __restrict__ x, long long t_len,
                      int n_frames, int hop, int offset,
                      const float* __restrict__ win,
                      const float* __restrict__ tw_re,
                      const float* __restrict__ tw_im,
                      float* __restrict__ out) {
  __shared__ __align__(16) Tile<kMagFrames> t;
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kMagFrames;
  stage(t, x + static_cast<long long>(blockIdx.y) * t_len, t_len,
        static_cast<long long>(f0) * hop - offset, hop, win, tw_re, tw_im);

  float re[kMagFrames], im[kMagFrames];
#pragma unroll
  for (int f = 0; f < kMagFrames; ++f) re[f] = im[f] = 0.0f;
  // thread 0: bin 0 in `re`, the Nyquist bin (phase n*256, real) in `im`
  const bool edge = tid == 0;
  accumulate(t, hop, tid, edge ? kWin / 2 : tid, edge ? 0 : kWin, 0, kWin, re,
             im);

  constexpr int kBins = kWin / 2 + 1;
  float* o = out + (static_cast<long long>(blockIdx.y) * n_frames + f0) * kBins;
#pragma unroll
  for (int f = 0; f < kMagFrames; ++f) {
    if (f0 + f >= n_frames) break;
    if (edge) {
      o[f * kBins] = fabsf(re[f]);
      o[f * kBins + kWin / 2] = fabsf(im[f]);
    } else {
      o[f * kBins + tid] = sqrtf(re[f] * re[f] + im[f] * im[f]);
    }
  }
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

bool bad_hop(int hop) { return hop <= 0 || hop > kMaxHop || hop % 4 != 0; }

}  // namespace

extern "C" int frame_dft_mags_launch(const float* x, int batch, long long t_len,
                                     int n_frames, int hop, int offset,
                                     const float* win, const float* tw_re,
                                     const float* tw_im, float* out,
                                     cudaStream_t stream) {
  if (n_frames <= 0 || batch <= 0) return 0;
  if (bad_hop(hop)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_frames + kMagFrames - 1) / kMagFrames, batch);
  frame_dft_mags_kernel<<<grid, kThreads, 0, stream>>>(
      x, t_len, n_frames, hop, offset, win, tw_re, tw_im, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int timbral_flat_launch(const float* x, int batch, long long t_len,
                                   int n_frames, int hop, int offset,
                                   const float* win, const float* tw_re,
                                   const float* tw_im, float* out,
                                   cudaStream_t stream) {
  if (n_frames <= 0 || batch <= 0) return 0;
  if (bad_hop(hop)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_frames + kRowFrames - 1) / kRowFrames, batch);
  timbral_flat_kernel<<<grid, kThreads, 0, stream>>>(
      x, t_len, n_frames, hop, offset, win, tw_re, tw_im, out);
  return static_cast<int>(cudaGetLastError());
}
