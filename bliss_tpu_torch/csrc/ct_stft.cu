// STFT magnitudes straight from the reflect-padded signal (chroma 8192/2205),
// and the same transform over frames that already lie in device memory.
//
// ct_stft_launch replaces the TPU kernel
// bliss_tpu/ops/pallas_dft.py:_make_ct_fused_kernel (via
// pallas_stft_mags_ct_fused): frame f of song b is
// padded[b, f*hop : f*hop + W] times the periodic Hann window, and the output
// holds |X[k]| for k in [0, W/2]. Framing happens inside the kernel, so no
// framed copy of the signal (W/hop ~ 3.7x the signal) is ever written to
// device memory, which was the point of the TPU kernel.
//
// ct_frames_launch replaces bliss_tpu/ops/pallas_dft.py:_make_ct_kernel (via
// pallas_stft_mags_ct): the input is a pre-framed [N, W] array (the
// time-sharded long-song analyzer gathers its reflect frames across the shard
// halo), row f is the frame. The two entries share one kernel body; only the
// address of a frame's first sample differs.
//
// Transform: a real FFT of W points as a complex FFT of W/2 points
// (z[m] = x[2m] + i*x[2m+1], radix-2 in shared memory) plus the standard
// even/odd split, in f32 throughout with integer-phase twiddles. W is any
// power of two up to 8192; at 8192 the complex buffer is 32 KB of shared
// memory.
//
// Layout chosen: frame-major [B, F, W/2+1], so the block's 4097 magnitudes
// go out as one contiguous, fully coalesced run. The Python wrapper returns
// its transposed view [B, W/2+1, F], the bin-major layout `stft` promises;
// the consumers (the tuning stencil and the chroma matmul) take the strided
// view without a transpose pass.
//
// Bound on the card: bytes. Per frame ~8.8 KB of signal in (shared by ~3.7
// overlapping frames; 32 KB when pre-framed) and 16 KB of magnitudes out,
// against ~270k f32 operations; the memory traffic dominates. Design: one
// 512-thread block per frame, frames on grid.x only when pre-framed (N passes
// 65,535 at an hour of audio); loads are coalesced sample runs, and the only
// device-memory write is the contiguous magnitude row.
#include "fft_common.cuh"

namespace {

constexpr int kMaxHalf = 4096;  // complex points: windows up to 8192
constexpr int kThreads = 512;

// kPreFramed: `src` is [n_frames, W] and blockIdx.y is 0; else `src` is the
// padded signal [batch, t_len] and frame f starts at f*hop.
template <bool kPreFramed>
__global__ void __launch_bounds__(kThreads)
ct_mags_kernel(const float* __restrict__ src, long long t_len, int n_frames,
               int hop, int log2w, const float* __restrict__ win,
               const float* __restrict__ tw_re, const float* __restrict__ tw_im,
               float* __restrict__ out) {
  __shared__ float re[kMaxHalf];
  __shared__ float im[kMaxHalf];

  const int w = 1 << log2w;
  const int m = w >> 1;
  const int log2m = log2w - 1;
  const int f = blockIdx.x;
  const long long first =
      static_cast<long long>(f) * (kPreFramed ? w : hop);
  const float* xs = src + static_cast<long long>(blockIdx.y) * t_len + first;
  const long long avail = kPreFramed ? w : t_len - first;

  for (int n = threadIdx.x; n < w; n += kThreads) {
    const float v = n < avail ? xs[n] * win[n] : 0.0f;
    const int r = bliss::bit_reverse(n >> 1, log2m);
    if (n & 1) {
      im[r] = v;
    } else {
      re[r] = v;
    }
  }
  __syncthreads();
  // complex FFT of m points: W_m^j == W_w^(2j), hence the table scale of 2
  bliss::fft_radix2_dit(re, im, log2m, tw_re, tw_im, 2);

  float* o = out + (static_cast<long long>(blockIdx.y) * n_frames + f) *
                       static_cast<long long>(m + 1);
  for (int k = threadIdx.x; k <= m; k += kThreads) {
    const int a = k & (m - 1);        // k == m wraps to Z[0]
    const int b = (m - k) & (m - 1);  // conj partner Z[m - k]
    const float ar = re[a], ai = im[a], br = re[b], bi = im[b];
    // even and odd half-spectra: E = (Z[k] + conj Z[m-k]) / 2,
    // O = (Z[k] - conj Z[m-k]) / 2i; X[k] = E + W_w^k O
    const float er = 0.5f * (ar + br);
    const float ei = 0.5f * (ai - bi);
    const float or_ = 0.5f * (ai + bi);
    const float oi = -0.5f * (ar - br);
    const float wr = tw_re[k];
    const float wi = tw_im[k];
    const float xr = er + (wr * or_ - wi * oi);
    const float xi = ei + (wr * oi + wi * or_);
    o[k] = sqrtf(xr * xr + xi * xi);
  }
}

}  // namespace

extern "C" int ct_stft_launch(const float* padded, int batch, long long t_len,
                              int n_frames, int hop, int log2w,
                              const float* win, const float* tw_re,
                              const float* tw_im, float* out,
                              cudaStream_t stream) {
  if (n_frames <= 0 || batch <= 0) return 0;
  if (log2w < 2 || (1 << (log2w - 1)) > kMaxHalf) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_frames, batch);
  ct_mags_kernel<false><<<grid, kThreads, 0, stream>>>(
      padded, t_len, n_frames, hop, log2w, win, tw_re, tw_im, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ct_frames_launch(const float* frames, int n_frames, int log2w,
                                const float* win, const float* tw_re,
                                const float* tw_im, float* out,
                                cudaStream_t stream) {
  if (n_frames <= 0) return 0;
  if (log2w < 2 || (1 << (log2w - 1)) > kMaxHalf) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ct_mags_kernel<true><<<n_frames, kThreads, 0, stream>>>(
      frames, 0, n_frames, 0, log2w, win, tw_re, tw_im, out);
  return static_cast<int>(cudaGetLastError());
}
