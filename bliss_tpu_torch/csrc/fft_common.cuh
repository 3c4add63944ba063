// The FFT bodies of the DFT kernels of this directory: a block-wide
// shared-memory radix-2 FFT of any power-of-two length (fft_radix2_dit), and
// the same arithmetic at 512 points on one warp (warp_radix2_512_mags); a
// 256-point complex FFT carried by one warp in registers (warp_fft256), and
// the 512-point real FFT built on it (warp_rfft512_mags); the register
// butterflies dft4, dft8, dft16, which ct_stft.cu's 8192-point body uses too.
//
// Twiddle tables are built on the host in f64 from the INTEGER phase k
// (tw_re[k] = cos(2*pi*k/N), tw_im[k] = -sin(2*pi*k/N), k in [0, N/2]) and
// rounded once to f32, so no large float angle is ever formed on the card.
#pragma once

#include <cuda_runtime.h>

namespace bliss {

__device__ __forceinline__ int bit_reverse(int v, int bits) {
  return static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - bits));
}

// Asynchronous copy of kBytes (4, 8 or 16; both addresses aligned to it)
// from device memory to shared memory; 16-byte copies bypass L1.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                 "n"(kBytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// In-place radix-2 decimation-in-time FFT of n = 2^log2n complex points held
// in shared memory (re, im). On entry the input sits in bit-reversed order,
// on exit X[k] sits in natural order. The table holds W_N^k for
// N = n * tw_scale; every thread of the block must call this, after a
// __syncthreads() that publishes the input. Ends with a __syncthreads().
__device__ __forceinline__ void fft_radix2_dit(float* re, float* im, int log2n,
                                               const float* __restrict__ tw_re,
                                               const float* __restrict__ tw_im,
                                               int tw_scale) {
  const int half_n = 1 << (log2n - 1);
  for (int s = 1; s <= log2n; ++s) {
    const int half = 1 << (s - 1);
    // W_{2*half}^pos == W_N^(pos * N / (2*half))
    const int stride = (half_n >> (s - 1)) * tw_scale;
    for (int t = threadIdx.x; t < half_n; t += blockDim.x) {
      const int pos = t & (half - 1);
      const int i = ((t >> (s - 1)) << s) | pos;
      const int j = i + half;
      const float wr = tw_re[pos * stride];
      const float wi = tw_im[pos * stride];
      const float jr = re[j], ji = im[j];
      const float xr = jr * wr - ji * wi;
      const float xi = jr * wi + ji * wr;
      const float ir = re[i], ii = im[i];
      re[j] = ir - xr;
      im[j] = ii - xi;
      re[i] = ir + xr;
      im[i] = ii + xi;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// One warp, one 512-point real FFT, magnitudes of bins 0..256.
//
// The 512 windowed samples are read as 256 complex points z[m] = xw[2m] +
// i*xw[2m+1] (half the arithmetic of a complex transform of real input); the
// 256-point complex FFT is 8 x 8 x 4 over the index split n = 32*n1 + 4*n2 +
// n3, k = k1 + 8*k2 + 64*k3: each lane holds 8 points and does a radix-8
// butterfly in registers, twice, then two radix-4 butterflies. Between the
// stages the warp transposes through 288 complex slots of shared memory in
// padded layouts (row strides 36 and 68) in which every 8-byte store and
// load of a half-warp hits 16 different bank pairs; __syncwarp() orders
// them, no block-wide barrier is taken. The last stage leaves lane q with Z[q + 32*r]
// in register r, so the mirror bin Z[256 - k] that the real-input untangling
// X[k] = E[k] + W_512^k * O[k] needs is register 7 - r of lane 32 - q: two
// shuffles a bin, no third transpose. All twiddles sit in registers, looked up
// once per warp by INTEGER phase in the host's f64-rounded table.
// ---------------------------------------------------------------------------

// floats of shared memory per warp, 8-byte aligned
constexpr int kWarpFftScratch = 2 * 288;

// Forward 4-point DFT in place, natural order in and out.
__device__ __forceinline__ void dft4(float& r0, float& i0, float& r1, float& i1,
                                     float& r2, float& i2, float& r3,
                                     float& i3) {
  const float s0r = r0 + r2, s0i = i0 + i2;
  const float s1r = r0 - r2, s1i = i0 - i2;
  const float s2r = r1 + r3, s2i = i1 + i3;
  const float s3r = i1 - i3, s3i = r3 - r1;  // -i * (x1 - x3)
  r0 = s0r + s2r; i0 = s0i + s2i;
  r1 = s1r + s3r; i1 = s1i + s3i;
  r2 = s0r - s2r; i2 = s0i - s2i;
  r3 = s1r - s3r; i3 = s1i - s3i;
}

// Forward 8-point DFT in place, natural order in and out: one radix-2
// decimation-in-frequency step, then a 4-point DFT of each half.
__device__ __forceinline__ void dft8(float (&re)[8], float (&im)[8]) {
  constexpr float c = 0.70710678118654752440f;
  float ar[4], ai[4], br[4], bi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ar[j] = re[j] + re[j + 4];
    ai[j] = im[j] + im[j + 4];
    br[j] = re[j] - re[j + 4];
    bi[j] = im[j] - im[j + 4];
  }
  // b[j] *= W_8^j
  const float b1r = c * (br[1] + bi[1]), b1i = c * (bi[1] - br[1]);
  const float b2r = bi[2], b2i = -br[2];
  const float b3r = c * (bi[3] - br[3]), b3i = -c * (br[3] + bi[3]);
  br[1] = b1r; bi[1] = b1i;
  br[2] = b2r; bi[2] = b2i;
  br[3] = b3r; bi[3] = b3i;
  dft4(ar[0], ai[0], ar[1], ai[1], ar[2], ai[2], ar[3], ai[3]);
  dft4(br[0], bi[0], br[1], bi[1], br[2], bi[2], br[3], bi[3]);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    re[2 * m] = ar[m];
    im[2 * m] = ai[m];
    re[2 * m + 1] = br[m];
    im[2 * m + 1] = bi[m];
  }
}

// (re, im) *= (wr, wi)
__device__ __forceinline__ void turn(float& re, float& im, float wr, float wi) {
  const float r = re * wr - im * wi;
  im = re * wi + im * wr;
  re = r;
}

// 16-point DFT in place, natural order in and out: x[4a + b] -> X[c + 4d],
// a 4-point DFT over a for each b, the turn W_16^(b*c), a 4-point DFT over b
// for each c.
__device__ __forceinline__ void dft16(float (&re)[16], float (&im)[16]) {
  constexpr float c1 = 0.92387953251128675613f;  // cos(pi/8)
  constexpr float s1 = 0.38268343236508977173f;  // sin(pi/8)
  constexpr float c2 = 0.70710678118654752440f;
  // W_16^j, j = 0..9 (the turns use b*c in {1, 2, 3, 4, 6, 9})
  constexpr float wr[10] = {1.0f, c1, c2, s1, 0.0f, -s1, -c2, -c1, -1.0f, -c1};
  constexpr float wi[10] = {0.0f, -s1, -c2, -c1, -1.0f, -c1, -c2, -s1, 0.0f, s1};
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    dft4(re[b], im[b], re[4 + b], im[4 + b], re[8 + b], im[8 + b], re[12 + b],
         im[12 + b]);
  }
  // re[b + 4c] now holds the b-th transform's bin c
#pragma unroll
  for (int b = 1; b < 4; ++b) {
#pragma unroll
    for (int c = 1; c < 4; ++c) {
      turn(re[b + 4 * c], im[b + 4 * c], wr[b * c], wi[b * c]);
    }
  }
  float tr[16], ti[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    dft4(re[4 * c], im[4 * c], re[4 * c + 1], im[4 * c + 1], re[4 * c + 2],
         im[4 * c + 2], re[4 * c + 3], im[4 * c + 3]);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      tr[c + 4 * d] = re[4 * c + d];
      ti[c + 4 * d] = im[4 * c + d];
    }
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    re[k] = tr[k];
    im[k] = ti[k];
  }
}

// W_N^p for any integer p, from the table of phases [0, N/2]
// (tw_re[k] = cos(2*pi*k/N), tw_im[k] = -sin(2*pi*k/N)): cos is even and sin
// odd about phase N/2.
template <int N>
__device__ __forceinline__ void twiddle(const float* __restrict__ tw_re,
                                        const float* __restrict__ tw_im, int p,
                                        float& re, float& im) {
  p &= N - 1;
  const int q = p <= N / 2 ? p : N - p;
  re = __ldg(tw_re + q);
  const float s = __ldg(tw_im + q);
  im = p <= N / 2 ? s : -s;
}

// The twiddles of warp_fft256 for one lane, from the table of W_N (N a
// multiple of 512: W_256^p == W_N^(p * N/256)).
struct WarpFft256Twiddles {
  float a_re[8], a_im[8];  // after stage 1: W_256^(4*n2*k1), lane = 4*n2 + n3
  float b_re[8], b_im[8];  // after stage 2: W_256^(n3*(k1 + 8*k2)), lane = 4*k1 + n3

  template <int N>
  __device__ __forceinline__ void load(const float* __restrict__ tw_re,
                                       const float* __restrict__ tw_im,
                                       int lane) {
    constexpr int s = N / 512;
    const int hi = lane >> 2, lo = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      twiddle<N>(tw_re, tw_im, 8 * s * hi * j, a_re[j], a_im[j]);
      twiddle<N>(tw_re, tw_im, 2 * s * lo * (hi + 8 * j), b_re[j], b_im[j]);
    }
  }
};

// The twiddles one lane of warp_rfft512_mags needs, held in registers for
// every frame it takes.
struct WarpFftTwiddles {
  WarpFft256Twiddles core;
  float c_re[8], c_im[8];  // untangling: W_512^(lane + 32*r)

  __device__ __forceinline__ void load(const float* __restrict__ tw_re,
                                       const float* __restrict__ tw_im,
                                       int lane) {
    core.load<512>(tw_re, tw_im, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      twiddle<512>(tw_re, tw_im, lane + 32 * j, c_re[j], c_im[j]);
    }
  }
};

// The 256-point complex FFT Z[k] = sum_m z[m] W_256^(m*k) by the 32 lanes of
// one warp: on entry lane q holds z[q + 32*j] in register j, on return
// Z[q + 32*r] in register r. `scratch` is kWarpFftScratch floats of shared
// memory owned by this warp, 8-byte aligned. Every lane must call this.
__device__ __forceinline__ void warp_fft256(float (&re)[8], float (&im)[8],
                                            float* scratch,
                                            const WarpFft256Twiddles& tw,
                                            int lane) {
  // stage 1: lane (n2, n3) transforms over n1, then turns by W_64^(n2*k1)
  dft8(re, im);
#pragma unroll
  for (int k1 = 1; k1 < 8; ++k1) turn(re[k1], im[k1], tw.a_re[k1], tw.a_im[k1]);
  float2* xs = reinterpret_cast<float2*>(scratch);
  __syncwarp();  // the previous transform's last loads are done
#pragma unroll
  for (int k1 = 0; k1 < 8; ++k1) {
    xs[k1 * 36 + lane] = make_float2(re[k1], im[k1]);
  }
  __syncwarp();
  // stage 2: lane (k1, n3) transforms over n2, then turns by W_256^(n3*(k1+8*k2))
  const int g = (lane >> 2) * 36 + (lane & 3);
#pragma unroll
  for (int n2 = 0; n2 < 8; ++n2) {
    const float2 v = xs[g + 4 * n2];
    re[n2] = v.x;
    im[n2] = v.y;
  }
  dft8(re, im);
#pragma unroll
  for (int k2 = 0; k2 < 8; ++k2) turn(re[k2], im[k2], tw.b_re[k2], tw.b_im[k2]);
  __syncwarp();  // every lane has read stage 1's layout
  const int t = (lane & 3) * 68 + (lane >> 2);
#pragma unroll
  for (int k2 = 0; k2 < 8; ++k2) {
    xs[t + 8 * k2] = make_float2(re[k2], im[k2]);
  }
  __syncwarp();
  // stage 3: lane q transforms over n3 for k1 + 8*k2 = q and q + 32, which
  // leaves Z[q + 32*r] in register r = h + 2*k3
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int at = lane + 32 * h;
    const float2 v0 = xs[at], v1 = xs[68 + at], v2 = xs[136 + at], v3 = xs[204 + at];
    float r0 = v0.x, r1 = v1.x, r2 = v2.x, r3 = v3.x;
    float i0 = v0.y, i1 = v1.y, i2 = v2.y, i3 = v3.y;
    dft4(r0, i0, r1, i1, r2, i2, r3, i3);
    re[h] = r0; re[h + 2] = r1; re[h + 4] = r2; re[h + 6] = r3;
    im[h] = i0; im[h + 2] = i1; im[h + 4] = i2; im[h + 6] = i3;
  }
}

// |X[k]| of the 512-point DFT of sig[n] * win[n] (both in shared memory, 8-byte
// aligned), by the 32 lanes of one warp. On return lane q holds |X[q + 32*r]|
// in mag[r] and every lane holds |X[256]| of its own view in nyq (lane 0's is
// the bin). `scratch` is kWarpFftScratch floats of shared memory owned by this
// warp, 8-byte aligned. Every lane of the warp must call this.
// The windowed samples are rounded to f32 before the first butterfly
// (__fmul_rn), as a transform of the f32 windowed frame (the plain versions'
// input) rounds them; a product the compiler fused into the first
// butterfly's addition moved a bin near zero (a DC of 4e-7 under a peak of
// 6.6) by 15%.
__device__ __forceinline__ void warp_rfft512_mags(
    const float* sig, const float* win, float* scratch,
    const WarpFftTwiddles& tw, int lane, float (&mag)[8], float& nyq) {
  constexpr unsigned kFull = 0xffffffffu;
  float re[8], im[8];
  const float2* s2 = reinterpret_cast<const float2*>(sig) + lane;
  const float2* w2 = reinterpret_cast<const float2*>(win) + lane;
#pragma unroll
  for (int n1 = 0; n1 < 8; ++n1) {
    const float2 v = s2[32 * n1];
    const float2 w = w2[32 * n1];
    re[n1] = __fmul_rn(v.x, w.x);
    im[n1] = __fmul_rn(v.y, w.y);
  }
  warp_fft256(re, im, scratch, tw.core, lane);
  // real-input untangling with the mirror bin Z[256 - k] = c + i*d
  const int partner = (32 - lane) & 31;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float c = __shfl_sync(kFull, re[7 - r], partner);
    float d = __shfl_sync(kFull, im[7 - r], partner);
    if (lane == 0) {  // 256 - 32*r lies in lane 0 itself (Z[256] is Z[0])
      c = re[(8 - r) & 7];
      d = im[(8 - r) & 7];
    }
    const float a = re[r], b = im[r];
    const float er = 0.5f * (a + c), ei = 0.5f * (b - d);
    const float pr = 0.5f * (b + d), pi = 0.5f * (c - a);
    const float yr = er + (tw.c_re[r] * pr - tw.c_im[r] * pi);
    const float yi = ei + (tw.c_re[r] * pi + tw.c_im[r] * pr);
    mag[r] = sqrtf(yr * yr + yi * yi);
  }
  nyq = fabsf(re[0] - im[0]);
}

// ---------------------------------------------------------------------------
// One warp, one 512-point FFT of real input by fft_radix2_dit's arithmetic.
//
// The same butterflies, twiddles and stage order as fft_radix2_dit at n = 512
// (a complex transform of the windowed frame with zero imaginary part, input
// in bit-reversed order, nine decimation-in-time stages), so a frame's
// magnitudes round as that body's do; only the schedule is a warp's: lane q
// holds points 16 q + r of stages 1-4 in register r, a transpose through
// padded shared memory (a slot of padding every 16 points) gives lane
// (a, h) = a + 16 h the points a + 16 r + 256 h of stages 5-8, and stage 9
// pairs lane a with lane a + 16 by shuffles, each lane forming 8 of the 256
// bins below the Nyquist bin. __syncwarp() orders the shared memory, no
// block-wide barrier is taken.
// ---------------------------------------------------------------------------

// floats of shared memory per warp, 8-byte aligned: 512 complex points and
// their padding
constexpr int kWarpRadix2Scratch = 2 * (512 + 32);

// The twiddles of stages 5-9 of warp_radix2_512_mags, stage by stage: stage
// s = 5 + b holds W_512^(p * (16 >> b)) for its positions p < 16 << b at
// entries 16 ((1 << b) - 1) + p, so the lanes of a half-warp read
// consecutive entries (no bank conflict); 496 complex values.
constexpr int kRadix2StageTwiddles = 496;

__host__ __device__ constexpr int radix2_stage_base(int b) { return 16 * ((1 << b) - 1); }

// Entry i of that table from the [0, N/2] tables of W_512
__device__ __forceinline__ float2 radix2_stage_twiddle(const float* __restrict__ tw_re,
                                                       const float* __restrict__ tw_im,
                                                       int i) {
  int b = 0;
  while (i >= radix2_stage_base(b + 1)) ++b;
  const int phase = (i - radix2_stage_base(b)) * (16 >> b);
  return make_float2(tw_re[phase], tw_im[phase]);
}

__host__ __device__ constexpr int rev4(int r) {
  return ((r & 1) << 3) | ((r & 2) << 1) | ((r & 4) >> 1) | ((r & 8) >> 3);
}

// fft_radix2_dit's butterfly on (i, j) with the twiddle w
__device__ __forceinline__ void radix2_butterfly(float& ir, float& ii, float& jr, float& ji,
                                                 float2 w) {
  const float xr = jr * w.x - ji * w.y;
  const float xi = jr * w.y + ji * w.x;
  jr = ir - xr;
  ji = ii - xi;
  ir = ir + xr;
  ii = ii + xi;
}

// Point 16 q + r of the bit-reversed input is sample 32 rev4(r) + rev5(q):
// the sample of lane q's register r.
__device__ __forceinline__ int radix2_sample(int lane, int r) {
  return 32 * rev4(r) + static_cast<int>(__brev(static_cast<unsigned>(lane)) >> 27);
}

// What one lane of warp_radix2_512_mags holds in registers for every frame:
// the window at its 16 samples, and W_512^(32 m), m < 8, the twiddles of
// stages 1-4.
struct WarpRadix2Constants {
  float win[16];
  float2 w16[8];

  __device__ __forceinline__ void load(const float* __restrict__ window,
                                       const float* __restrict__ tw_re,
                                       const float* __restrict__ tw_im, int lane) {
#pragma unroll
    for (int r = 0; r < 16; ++r) win[r] = window[radix2_sample(lane, r)];
#pragma unroll
    for (int m = 0; m < 8; ++m) w16[m] = make_float2(tw_re[32 * m], tw_im[32 * m]);
  }
};

// |X[k]| of the 512-point DFT of sig[n] * win[n] (sig in shared memory, the
// window in `c`), by the 32 lanes of one warp; tw is the stage table of
// kRadix2StageTwiddles entries (radix2_stage_twiddle), in shared memory. On
// return lane q holds
// |X[q + 32*r]| in mag[r] and lane 0 holds |X[256]| in nyq. `scratch` is
// kWarpRadix2Scratch floats of shared memory owned by this warp, 8-byte
// aligned. Every lane must call this.
__device__ __forceinline__ void warp_radix2_512_mags(const float* sig,
                                                     const WarpRadix2Constants& c,
                                                     float* scratch, const float2* tw,
                                                     int lane, float (&mag)[8], float& nyq) {
  constexpr unsigned kFull = 0xffffffffu;
  float re[16], im[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    // rounded, as fft_radix2_dit's input is stored
    re[r] = __fmul_rn(sig[radix2_sample(lane, r)], c.win[r]);
    im[r] = 0.0f;
  }
  // stages 1-4: the pairs lie in one lane's registers
#pragma unroll
  for (int s = 1; s <= 4; ++s) {
    const int half = 1 << (s - 1);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (r & half) continue;
      radix2_butterfly(re[r], im[r], re[r + half], im[r + half],
                       c.w16[(r & (half - 1)) * (8 >> (s - 1))]);
    }
  }
  float2* xs = reinterpret_cast<float2*>(scratch);
  __syncwarp();  // the previous transform's last loads are done
#pragma unroll
  for (int r = 0; r < 16; ++r) xs[17 * lane + r] = make_float2(re[r], im[r]);
  __syncwarp();
  const int a = lane & 15, h = lane >> 4;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float2 v = xs[a + 17 * r + 272 * h];
    re[r] = v.x;
    im[r] = v.y;
  }
  // stages 5-8: bit s - 1 of the point is bit s - 5 of the register
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (r & (1 << b)) continue;
      radix2_butterfly(re[r], im[r], re[r + (1 << b)], im[r + (1 << b)],
                       tw[radix2_stage_base(b) + a + 16 * (r & ((1 << b) - 1))]);
    }
  }
  // stage 9: point i = a + 16 r (lane a) pairs with i + 256 (lane a + 16);
  // lane a forms bins a + 16 r for r < 8, lane a + 16 those for r >= 8
  float m[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float sr = h ? re[r] : re[r + 8];
    const float si = h ? im[r] : im[r + 8];
    const float gr = __shfl_xor_sync(kFull, sr, 16);
    const float gi = __shfl_xor_sync(kFull, si, 16);
    float ir = h ? gr : re[r], ii = h ? gi : im[r];
    float jr = h ? re[r + 8] : gr, ji = h ? im[r + 8] : gi;
    radix2_butterfly(ir, ii, jr, ji, tw[radix2_stage_base(4) + a + 16 * (r + 8 * h)]);
    m[r] = sqrtf(ir * ir + ii * ii);
    if (r == 0) nyq = sqrtf(jr * jr + ji * ji);  // lane 0: X[256]
  }
  // bin k of lane (a, h) to lane k & 31, register k >> 5, through shared
  // memory (16 slots of padding between the halves: no bank conflict)
  float* ms = scratch;
  __syncwarp();  // every lane has read stage 4's layout
#pragma unroll
  for (int r = 0; r < 8; ++r) ms[a + 16 * r + 144 * h] = m[r];
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int k = lane + 32 * r;
    mag[r] = ms[k + 16 * (k >> 7)];
  }
}

}  // namespace bliss
