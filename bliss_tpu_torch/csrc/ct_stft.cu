// STFT magnitudes straight from the reflect-padded signal (chroma 8192/2205),
// and the same transform over frames that already lie in device memory.
//
// ct_stft_launch replaces the TPU kernel
// bliss_tpu/ops/pallas_dft.py:_make_ct_fused_kernel (line 778, via
// pallas_stft_mags_ct_fused): frame f of song b is
// padded[b, f*hop : f*hop + W] times the periodic Hann window, and the output
// holds |X[k]| for k in [0, W/2], zeros past t_len. Framing happens inside the
// kernel, so no framed copy of the signal (W/hop ~ 3.7x the signal) is ever
// written to device memory, which was the point of the TPU kernel.
//
// ct_frames_launch replaces bliss_tpu/ops/pallas_dft.py:_make_ct_kernel (line
// 862, via pallas_stft_mags_ct): the input is a pre-framed [N, W] array (the
// time-sharded long-song analyzer gathers its reflect frames across the shard
// halo), row f is the frame. The two entries share one kernel body; only the
// address of a frame's first sample differs.
//
// The TPU kernels form the DFT of 8192 = n2 x 128 points as matrix products
// on the MXU (bf16x3). Here it is an FFT in f32 on the CUDA cores: the real
// input is read as 4096 complex points z[m] = x[2m] + i*x[2m+1], transformed,
// and untangled, X[k] = E[k] + W_8192^k O[k] with E, O from Z[k] and the
// mirror bin Z[4096 - k]. Every twiddle is looked up by its INTEGER phase in
// the host's f64-rounded table of W_8192; no float angle is formed here.
//
// Layout chosen: frame-major [B, F, W/2+1]. The Python wrapper returns its
// transposed view [B, W/2+1, F], the bin-major layout `stft` promises; the
// consumers (the tuning stencil and the chroma matmul) take the strided view
// without a transpose pass.
//
// Bound on the card: bytes. At 8 x 5-min (26,632 frames) the signal in and
// the magnitudes out are 671 MB against ~7.7 GFLOP, so 0.20 ms of memory time
// against 0.12 ms at the f32 peak; pre-framed input (32 KB a frame) is the
// same balance. The first design (one frame a 512-thread block, twelve
// radix-2 stages of the whole 32 KB buffer in shared memory, each ending in a
// block barrier, every twiddle reloaded from device memory) sat 20x over that.
// Design at W = 8192 (ct8192_kernel): a 256-thread block takes one frame at a
// time, persistent over a strided run of frames, so each thread keeps its
// twiddles (39 complex values) in registers for every frame it takes. The
// 4096-point complex FFT is 16 x 16 x 16 over m = 256*n1 + 16*n2 + n3,
// k = k1 + 16*k2 + 256*k3: each thread holds 16 points and does a radix-16
// butterfly (dft16, fft_common.cuh) in registers, three times, with two
// exchanges through shared memory between them, the second in rows padded to
// 17 so that every 8-byte access of a half-warp hits 16 bank pairs. The last
// pass gives thread q the bins q + 256*k3; the threads are laid out so that q
// and 256 - q sit in lanes l and l ^ 16 of one warp, and the untangling finds
// its mirror bin by one shuffle. The samples come in by cp.async, two frames
// ahead, into two frame buffers taken in turns (16-byte copies where the
// frame start allows, 8- or 4-byte ones else; #3's frames start at any
// 4-byte address), so the loads of later frames run under the transform of
// this one; pass 1 runs in place in its frame's buffer (thread tid reads and
// writes only the slots 256*i + tid). Three block barriers a frame, 98 KB of
// shared memory, 2 blocks an SM. The only device-memory write is the frame's
// 4097 magnitudes. Widths below 8192 (on no path) keep the block-wide radix-2
// FFT of the first design (ct_mags_kernel).
#include <cstdint>

#include "fft_common.cuh"

// Compile-time switches of ct8192_kernel, for measuring where its time goes
// (benches/ct_fft_variants.py builds one library per setting; the package
// builds the defaults). BLISS_CT_FFT_DESIGN: 0 the 16 x 16 x 16 block FFT,
// 1 the 256 x 16 design (warp_fft256 on each stride-16 subsequence, then
// radix 16 across warps; loads not overlapped), 2 the radix-2 kernel at 8192
// too. BLISS_CT_FFT_PROBE (design 0): 0 the kernel, 1 the transform without its
// output stores, 2 staging and stores without the transform, 3 the transform
// and stores without loads (2 and 3 give wrong output).
#ifndef BLISS_CT_FFT_DESIGN
#define BLISS_CT_FFT_DESIGN 0
#endif
#ifndef BLISS_CT_FFT_PROBE
#define BLISS_CT_FFT_PROBE 0
#endif

namespace {

// ---------------------------------------------------------------------------
// Any power-of-two width up to 8192: a block-wide radix-2 FFT in shared memory
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// W = 8192: 4096 complex points, 16 per thread
// ---------------------------------------------------------------------------

constexpr int kW = 8192;
constexpr int kBins = kW / 2 + 1;
constexpr int kFftThreads = 256;
constexpr int kRow = 17;  // float2 stride of a row of the last exchange
constexpr int kLastSlots = 256 * kRow;
#if BLISS_CT_FFT_DESIGN == 1
constexpr int kStageSlots = 4096 + 256;  // m + (m >> 4): a pad every 16 points
constexpr int kSmemSlots =
    kStageSlots + kLastSlots + (kFftThreads / 32) * bliss::kWarpFftScratch / 2;
#else
// two frames' samples (pass 1 runs in place in its frame's), the last exchange
constexpr int kSmemSlots = kW + kLastSlots;
#endif
constexpr int kSmemBytes = kSmemSlots * static_cast<int>(sizeof(float2));

// Where a frame lies: `xs` its first sample, `avail` how many samples of it
// exist (zeros past that).
struct Frame {
  const float* xs;
  long long avail;
};

template <bool kPreFramed>
__device__ __forceinline__ Frame frame_at(const float* __restrict__ src,
                                          long long t_len, int n_frames,
                                          int hop, long long g) {
  Frame fr;
  if (kPreFramed) {
    fr.xs = src + g * kW;
    fr.avail = kW;
  } else {
    const long long b = g / n_frames;
    const long long first = (g - b * n_frames) * hop;
    fr.xs = src + b * t_len + first;
    fr.avail = t_len - first;
  }
  return fr;
}

// Start copying frame `fr` into `stage` (kW floats, 16-byte aligned) by
// cp.async: 16-byte copies where the frame's first sample is 16-byte aligned,
// 8-byte where it is 8-byte aligned, else 4-byte; zeros past fr.avail.
__device__ __forceinline__ void stage_frame(float* stage, const Frame& fr,
                                            int tid) {
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(fr.xs));
  if (fr.avail >= kW && (a & 15) == 0) {
#pragma unroll
    for (int i = 0; i < kW / 4 / kFftThreads; ++i) {
      const int n = 4 * (tid + kFftThreads * i);
      bliss::cp_async<16>(stage + n, fr.xs + n);
    }
  } else if (fr.avail >= kW && (a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < kW / 2 / kFftThreads; ++i) {
      const int n = 2 * (tid + kFftThreads * i);
      bliss::cp_async<8>(stage + n, fr.xs + n);
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < kW / kFftThreads; ++i) {
      const int n = tid + kFftThreads * i;
      if (n < fr.avail) {
        bliss::cp_async<4>(stage + n, fr.xs + n);
      } else {
        stage[n] = 0.0f;
      }
    }
  }
}

// The window at samples 2m and 2m + 1.
__device__ __forceinline__ float2 window_pair(const float* __restrict__ win,
                                              int m, bool win_vec) {
  if (win_vec) return __ldg(reinterpret_cast<const float2*>(win) + m);
  return make_float2(__ldg(win + 2 * m), __ldg(win + 2 * m + 1));
}

// Windowed complex point z[m] = x[2m] w[2m] + i x[2m+1] w[2m+1] of a frame,
// by 8-byte loads where `vec` (frame and window 8-byte aligned, no sample
// past the end); design 1 loads its frames so.
__device__ __forceinline__ void load_point(const Frame& fr,
                                           const float* __restrict__ win,
                                           int m, bool vec, float& re,
                                           float& im) {
  if (vec) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(fr.xs) + m);
    const float2 w = __ldg(reinterpret_cast<const float2*>(win) + m);
    re = v.x * w.x;
    im = v.y * w.y;
  } else {
    const int n = 2 * m;
    re = n < fr.avail ? __ldg(fr.xs + n) * __ldg(win + n) : 0.0f;
    im = n + 1 < fr.avail ? __ldg(fr.xs + n + 1) * __ldg(win + n + 1) : 0.0f;
  }
}

// The bin row q (of the 256 of the last pass) that thread `tid` takes: warp w
// holds q = 16w + l in lanes l < 16 and its mirror 256 - q in lane l + 16;
// warp 0 pairs q = 0 with q = 128, each its own mirror.
__device__ __forceinline__ int last_row(int tid) {
  const int w = tid >> 5, lane = tid & 31, lo = lane & 15;
  if (lane < 16) return 16 * w + lo;
  return (w == 0 && lo == 0) ? 128 : 256 - 16 * w - lo;
}

// Untangling twiddles W_8192^(q + 256*k3), k3 < 8, of row q; for k3 >= 8 the
// twiddle is -i times that of k3 - 8 (W_8192^2048 == -i), exactly.
struct UntangleTwiddles {
  float re[8], im[8];

  __device__ __forceinline__ void load(const float* __restrict__ tw_re,
                                       const float* __restrict__ tw_im,
                                       int q) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bliss::twiddle<kW>(tw_re, tw_im, q + 256 * j, re[j], im[j]);
    }
  }
};

// The last pass, shared by both designs: row q reads its 16 values over the
// last index from `last` (row stride kRow), transforms them into
// Z[q + 256*k3], untangles against the mirror bins and writes |X[q + 256*k3]|
// (and |X[4096]| from row 0) to the frame's output row `o`.
__device__ __forceinline__ void last_pass(const float2* last, int q,
                                          const UntangleTwiddles& tw,
                                          float* __restrict__ o) {
  constexpr unsigned kFull = 0xffffffffu;
  float re[16], im[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 v = last[q * kRow + j];
    re[j] = v.x;
    im[j] = v.y;
  }
  bliss::dft16(re, im);
  // Z[4096 - q - 256*k3] is register 15 - k3 of row 256 - q (lane ^ 16);
  // row 0 finds it in its own register (16 - k3) & 15, row 128 in 15 - k3
#pragma unroll
  for (int k3 = 0; k3 < 16; ++k3) {
    float c = __shfl_xor_sync(kFull, re[15 - k3], 16);
    float d = __shfl_xor_sync(kFull, im[15 - k3], 16);
    if (q == 0) {
      c = re[(16 - k3) & 15];
      d = im[(16 - k3) & 15];
    } else if (q == 128) {
      c = re[15 - k3];
      d = im[15 - k3];
    }
    const float a = re[k3], b = im[k3];
    const float er = 0.5f * (a + c), ei = 0.5f * (b - d);
    const float pr = 0.5f * (b + d), pi = 0.5f * (c - a);
    const float wr = k3 < 8 ? tw.re[k3] : tw.im[k3 - 8];
    const float wi = k3 < 8 ? tw.im[k3] : -tw.re[k3 - 8];
    const float yr = er + (wr * pr - wi * pi);
    const float yi = ei + (wr * pi + wi * pr);
    const float mag = sqrtf(yr * yr + yi * yi);
#if BLISS_CT_FFT_PROBE == 1
    if (mag == -1.0f) o[q + 256 * k3] = mag;  // never true
#else
    o[q + 256 * k3] = mag;
#endif
  }
  if (q == 0) {
#if BLISS_CT_FFT_PROBE == 1
    if (re[0] == im[0] + 1e30f) o[kW / 2] = 0.0f;  // never true
#else
    o[kW / 2] = fabsf(re[0] - im[0]);
#endif
  }
}

#if BLISS_CT_FFT_DESIGN != 1
// Per-thread twiddles of the first two passes.
struct BlockFftTwiddles {
  float a_re[16], a_im[16];  // pass 1: W_256^(n2*k1), tid = 16*n2 + n3
  float b_re[16], b_im[16];  // pass 2: W_4096^(n3*(k1 + 16*k2)), tid = 16*k1 + n3

  __device__ __forceinline__ void load(const float* __restrict__ tw_re,
                                       const float* __restrict__ tw_im,
                                       int tid) {
    const int hi = tid >> 4, lo = tid & 15;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      bliss::twiddle<kW>(tw_re, tw_im, 32 * hi * j, a_re[j], a_im[j]);
      bliss::twiddle<kW>(tw_re, tw_im, 2 * lo * (hi + 16 * j), b_re[j], b_im[j]);
    }
  }
};
#else
// Per-thread twiddles of the 256 x 16 design: the warp core's, and the turns
// W_4096^(n2*k1) of the two subsequences n2 = warp, warp + 8 at the bins
// k1 = lane + 32*r the core leaves in the lane.
struct SplitFftTwiddles {
  bliss::WarpFft256Twiddles core;
  float x_re[2][8], x_im[2][8];

  __device__ __forceinline__ void load(const float* __restrict__ tw_re,
                                       const float* __restrict__ tw_im,
                                       int tid) {
    const int warp = tid >> 5, lane = tid & 31;
    core.load<kW>(tw_re, tw_im, lane);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        bliss::twiddle<kW>(tw_re, tw_im, 2 * (warp + 8 * s) * (lane + 32 * r),
                           x_re[s][r], x_im[s][r]);
      }
    }
  }
};
#endif

// |rDFT| of 8192-point frames, one frame a block at a time: frame g of
// batch * n_frames (g = b * n_frames + f) for g = blockIdx.x, + gridDim.x, ...
template <bool kPreFramed>
__global__ void __launch_bounds__(kFftThreads, 2)
ct8192_kernel(const float* __restrict__ src, long long t_len, int n_frames,
              int hop, long long total, const float* __restrict__ win,
              const float* __restrict__ tw_re, const float* __restrict__ tw_im,
              float* __restrict__ out) {
  extern __shared__ __align__(16) float2 smem[];
  const int tid = threadIdx.x;
  const int q = last_row(tid);
  const bool win_vec = (reinterpret_cast<uintptr_t>(win) & 7) == 0;
  UntangleTwiddles utw;
  utw.load(tw_re, tw_im, q);
#if BLISS_CT_FFT_DESIGN != 1
  // two frames' buffers of samples, taken in turns: frame g is staged two
  // frames ahead into the buffer frame g - 2*gridDim.x has left, and pass 1
  // runs in place in it (thread tid reads and writes the slots 256*i + tid)
  float2* last = smem + kW;  // [q][n3], rows of kRow
  BlockFftTwiddles tw;
  tw.load(tw_re, tw_im, tid);
  // copy frame h into buffer b (one commit group a call, empty past the end)
  auto stage_next = [&](long long h, int b) {
#if BLISS_CT_FFT_PROBE != 3
    if (h < total) {
      stage_frame(reinterpret_cast<float*>(smem + b * (kW / 2)),
                  frame_at<kPreFramed>(src, t_len, n_frames, hop, h), tid);
    }
#endif
    bliss::cp_async_commit();
  };
  stage_next(blockIdx.x, 0);
  stage_next(blockIdx.x + static_cast<long long>(gridDim.x), 1);

  int b = 0;
  for (long long g = blockIdx.x; g < total; g += gridDim.x, b ^= 1) {
    float2* x = smem + b * (kW / 2);  // [n1][n2][n3], then [k1][n2][n3]
    float* o = out + g * kBins;
    const long long after_next = g + 2 * static_cast<long long>(gridDim.x);
    // thread (n2, n3) = tid takes the points z[256*n1 + tid]
    float re[16], im[16];
#if BLISS_CT_FFT_PROBE == 3
    // the transform and stores alone: points made up from g and tid
#pragma unroll
    for (int n1 = 0; n1 < 16; ++n1) {
      re[n1] = static_cast<float>((g & 7) + n1) + 1e-3f * tid;
      im[n1] = 1e-3f * n1 - static_cast<float>(g & 3);
    }
#else
    bliss::cp_async_wait<1>();  // frame g's group; the next frame's may pend
    __syncthreads();            // frame g is staged
#pragma unroll
    for (int n1 = 0; n1 < 16; ++n1) {
      const int m = 256 * n1 + tid;
      const float2 v = x[m];
      const float2 w = window_pair(win, m, win_vec);
      re[n1] = v.x * w.x;
      im[n1] = v.y * w.y;
    }
#endif
#if BLISS_CT_FFT_PROBE == 2
    // staging and stores alone: |z[tid + 256*i]| to bins tid + 256*i
    __syncthreads();  // every thread has read the buffer
    stage_next(after_next, b);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[tid + 256 * i] = sqrtf(re[i] * re[i] + im[i] * im[i]);
    if (tid == 0) o[kW / 2] = 0.0f;
#else
    // pass 1: transform over n1, turn by W_256^(n2*k1), in place
    bliss::dft16(re, im);
#pragma unroll
    for (int k1 = 0; k1 < 16; ++k1) {
      if (k1 > 0) bliss::turn(re[k1], im[k1], tw.a_re[k1], tw.a_im[k1]);
      x[256 * k1 + tid] = make_float2(re[k1], im[k1]);
    }
    __syncthreads();  // pass 1 is in place; the last frame's pass 3 is done
    // pass 2: thread (k1, n3) transforms over n2, turns by
    // W_4096^(n3*(k1 + 16*k2))
    {
      const int k1 = tid >> 4, n3 = tid & 15;
#pragma unroll
      for (int n2 = 0; n2 < 16; ++n2) {
        const float2 v = x[256 * k1 + 16 * n2 + n3];
        re[n2] = v.x;
        im[n2] = v.y;
      }
      bliss::dft16(re, im);
#pragma unroll
      for (int k2 = 0; k2 < 16; ++k2) {
        bliss::turn(re[k2], im[k2], tw.b_re[k2], tw.b_im[k2]);
        last[(k1 + 16 * k2) * kRow + n3] = make_float2(re[k2], im[k2]);
      }
    }
    __syncthreads();  // pass 2 is in place; frame g's buffer is read
    stage_next(after_next, b);
    // pass 3: row q = k1 + 16*k2 transforms over n3
    last_pass(last, q, utw, o);
#endif
  }
#else
  const int lane = tid & 31;
  float2* stage = smem;                       // z[m] at m + (m >> 4)
  float2* last = smem + kStageSlots;          // [q][n2], rows of kRow
  float* scratch = reinterpret_cast<float*>(last + kLastSlots) +
                   (tid >> 5) * bliss::kWarpFftScratch;
  SplitFftTwiddles tw;
  tw.load(tw_re, tw_im, tid);

  for (long long g = blockIdx.x; g < total; g += gridDim.x) {
    const Frame fr = frame_at<kPreFramed>(src, t_len, n_frames, hop, g);
    const bool vec = win_vec && fr.avail >= kW &&
                     (reinterpret_cast<uintptr_t>(fr.xs) & 7) == 0;
    float* o = out + g * kBins;
    // stage the windowed frame, then warp w transforms the subsequences
    // z[16*n1 + n2], n2 = w and w + 8, by the warp core and turns them
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int m = tid + 256 * i;
      float re, im;
      load_point(fr, win, m, vec, re, im);
      stage[m + (m >> 4)] = make_float2(re, im);
    }
    __syncthreads();  // the frame is staged; the last frame's last pass is done
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int n2 = (tid >> 5) + 8 * s;
      float re[8], im[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = 16 * (lane + 32 * j) + n2;
        const float2 v = stage[m + (m >> 4)];
        re[j] = v.x;
        im[j] = v.y;
      }
      bliss::warp_fft256(re, im, scratch, tw.core, lane);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        bliss::turn(re[r], im[r], tw.x_re[s][r], tw.x_im[s][r]);
        last[(lane + 32 * r) * kRow + n2] = make_float2(re[r], im[r]);
      }
    }
    __syncthreads();  // every subsequence is in place; the stage is read
    // radix 16 across the subsequences: row q = k1 transforms over n2
    last_pass(last, q, utw, o);
  }
#endif
}

// The launch of either entry: the radix-2 kernel below 8192 (and at 8192 in
// design 2), else the 8192-point body with as many blocks as the card holds
// at once, each walking a strided run of the batch * n_frames frames.
template <bool kPreFramed>
int launch(const float* src, int batch, long long t_len, int n_frames, int hop,
           int log2w, const float* win, const float* tw_re,
           const float* tw_im, float* out, cudaStream_t stream) {
  if (n_frames <= 0 || batch <= 0) return 0;
  if (log2w < 2 || (1 << (log2w - 1)) > kMaxHalf) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (log2w < 13 || BLISS_CT_FFT_DESIGN == 2) {
    const dim3 grid(n_frames, batch);
    ct_mags_kernel<kPreFramed><<<grid, kThreads, 0, stream>>>(
        src, t_len, n_frames, hop, log2w, win, tw_re, tw_im, out);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = ct8192_kernel<kPreFramed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kFftThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * n_frames;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(total < resident ? total : resident);
  kernel<<<blocks, kFftThreads, kSmemBytes, stream>>>(
      src, t_len, n_frames, hop, total, win, tw_re, tw_im, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ct_stft_launch(const float* padded, int batch, long long t_len,
                              int n_frames, int hop, int log2w,
                              const float* win, const float* tw_re,
                              const float* tw_im, float* out,
                              cudaStream_t stream) {
  return launch<false>(padded, batch, t_len, n_frames, hop, log2w, win, tw_re,
                       tw_im, out, stream);
}

extern "C" int ct_frames_launch(const float* frames, int n_frames, int log2w,
                                const float* win, const float* tw_re,
                                const float* tw_im, float* out,
                                cudaStream_t stream) {
  return launch<true>(frames, 1, 0, n_frames, 0, log2w, win, tw_re, tw_im, out,
                      stream);
}
