// The beat tracker's block inputs (ops/tempo_kernels.py:block_inputs): every
// per-block quantity that does not depend on the hypothesis state, for every
// block row of a batch of thresholded novelty series, in one launch.
//
// Replaces bliss_tpu/models/tempo.py:341-416 _precompute_blocks (the
// BlockInputs of :318) with its autocorrelation,
// bliss_tpu/models/tempo.py:236 _autocorr (a Toeplitz gather and
// `jnp.matmul(..., precision=HIGHEST)` vmapped over the blocks), its time
// signature _get_timesig (:289) and the vmapped _vec_max_elem and
// _quad_peak_pos (:215, :223). It is plain XLA, no Pallas kernel. In the
// port it was ~297 small eager device ops on [8, 223, 128] tensors after
// the autocorrelation, and the host's launches set their pace.
//
// A block a row, 64 threads. Row k of song b:
//   1. slot s holds thresh[b, s + 128 k - 385], 0 outside [0, min(h_valid, H))
//      (frame_signal(..., offset=385) of the series masked past h_valid);
//   2. the autocorrelation into shared memory (below);
//   3. dfrev = (row * dfwv) reversed;
//   4. the comb contributions c1..c4 of the 128 lags: for harmonic a, the
//      2a - 1 values acf[a i + t], 0 past 511, added left to right from 0,
//      times `interior` (a multiply: total * 0 is -0 for a negative total and
//      NaN for an inf or NaN one); comb_w3 = (c1 w0 + c2 w1) + c3 w2,
//      comb_w4 = comb_w3 + c4 w3, comb_u3 = (c1 + c2) + c3, comb_u4 = comb_u3 + c4;
//   5. both period candidates: rayacf = comb_w * rwv, its last maximum (0 if
//      any value is NaN, as torch.amax gives NaN and `NaN >= 0` fails; 0 if
//      the maximum is negative), the quadratic peak there, `rayparam_trunc`
//      unless 0 < index < 127; warp 0 takes comb_w3, warp 1 comb_w4;
//   6. both time signatures (_get_timesig), each sum of four left to right
//      from 0, gp the card's float-to-int conversion (cvt.rzi: NaN to 0);
//   7. both Gaussian weight vectors exp(((-0.5 diff) diff) / g_var2), one
//      division and `expf`, PyTorch's exp on the card.
// Every step is __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn (nvcc contracts
// a * b + c), so the kernel equals its plain version (block_inputs_plain),
// which rounds each eager op on its own, bit for bit.
//
// The autocorrelation, acf[i] = (sum over j = i..511 of df[j - i] df[j]) /
// (512 - i), in the order XLA's CPU backend compiles the JAX package's
// Toeplitz matmul into, so the port's block inputs equal the JAX package's:
//   - 8 partial sums a lag (256-bit vectors of f32), partial w taking the
//     terms j = w (mod 8) in increasing j, each one fused multiply-add rounded
//     once (__fmaf_rn);
//   - the partials added in adjacent pairs,
//     ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)), with __fadd_rn;
//   - one division by 512 - i (__fdiv_rn).
// The Toeplitz matrix holds zeros at j < i. Their products come first in each
// partial, while it is still +0, and +0 + +-0 is +0: they are skipped. But
// 0 * inf and 0 * NaN are NaN, so XLA's lag i is NaN where any df[j], j < i,
// is not finite: the kernel finds the row's first such j and writes NaN past
// it.
//
// Bound on the card: operations. The autocorrelation is 131,328 fused
// multiply-adds a row, 235 M for the 1,784 rows of 8 x 5-minute songs: 0.47
// GFLOP at 67 TFLOP/s of f32, 7 us. The rest is ~5,000 operations a row. The
// bytes take about 2.2 us at 3.35 TB/s: the series read once, 5 KB a row
// written.
//
// Design against that bound. The autocorrelation kernel that came before it
// (7.3x its bound) fed each FMA from two shared-memory loads, so shared
// bandwidth bound it. Here a thread walks 4 consecutive lags
// i0..i0+3 at once, over chunks of 8 consecutive j: df[c..c+7] and the window
// df[c - i0 .. c - i0 + 7] are four 16-byte loads, and the window's last three
// values stay in registers for the next chunk, so 32 FMAs take 4 shared loads.
// A lag's own partial sequence is as before, so its rounding is too. Thread t
// takes lags 4t..4t+3 and 508-4t..511-4t: 65 chunks of 8 for every thread,
// the triangle split evenly. Past it the block runs ~80 operations a thread,
// and the two candidates, their time signatures and their weights run on the
// two warps side by side.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kN = 512;                  // winlen: a block row
constexpr int kHop = 128;                // step: hops between two rows
constexpr int kLag = 128;                // laglen
constexpr int kOffset = kN - kHop + 1;   // 385
constexpr int kThreads = 64;
constexpr int kPartials = 8;             // XLA's f32 lanes
constexpr int kGroup = 4;                // lags a thread walks at once
constexpr int kPad = 4;                  // zeros before the row: a first chunk reads s[-4..-1]
constexpr int kAcfPad = 8;               // zeros past acf: the comb reads up to acf[514]
constexpr unsigned int kFull = 0xffffffffu;

// f32(1 / (2a - 1)), a = 2..4: the comb's weights (1 for a = 1)
constexpr float kW1 = 0x1.555556p-2f;
constexpr float kW2 = 0x1.99999ap-3f;
constexpr float kW3 = 0x1.24924ap-3f;

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ void load8(const float* p, float (&v)[8], int at) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[at + 0] = a.x; v[at + 1] = a.y; v[at + 2] = a.z; v[at + 3] = a.w;
  v[at + 4] = b.x; v[at + 5] = b.y; v[at + 6] = b.z; v[at + 7] = b.w;
}

// Lags i0..i0+3 (i0 a multiple of 4) of the row `s` (s[-4..-1] readable),
// before the NaN rule: XLA's 8 partials a lag, paired, divided.
__device__ __forceinline__ void lag_group(const float* s, int i0, float (&out)[kGroup]) {
  float p[kGroup][kPartials];
#pragma unroll
  for (int l = 0; l < kGroup; ++l)
#pragma unroll
    for (int u = 0; u < kPartials; ++u) p[l][u] = 0.0f;
  // w[q] = s[c - i0 - 3 + q]: for j = c + u, lag i0 + l reads w[3 + u - l]
  float d[kPartials];
  float w[kGroup - 1 + kPartials] = {};
  const int c0 = i0 & ~(kPartials - 1);
  const int o0 = c0 - i0;  // 0 or -4
  {  // the first chunk: only the terms j >= i
    load8(s + c0, d, 0);
    float cur[kPartials];
    load8(s + o0, cur, 0);
#pragma unroll
    for (int q = 0; q < kPartials; ++q) w[kGroup - 1 + q] = cur[q];
#pragma unroll
    for (int u = 0; u < kPartials; ++u)
#pragma unroll
      for (int l = 0; l < kGroup; ++l)
        if (u >= l && o0 + u - l >= 0) p[l][u] = __fmaf_rn(w[kGroup - 1 + u - l], d[u], p[l][u]);
  }
  for (int c = c0 + kPartials; c < kN; c += kPartials) {
#pragma unroll
    for (int q = 0; q < kGroup - 1; ++q) w[q] = w[kPartials + q];
    load8(s + c, d, 0);
    float cur[kPartials];
    load8(s + c - i0, cur, 0);
#pragma unroll
    for (int q = 0; q < kPartials; ++q) w[kGroup - 1 + q] = cur[q];
#pragma unroll
    for (int u = 0; u < kPartials; ++u)
#pragma unroll
      for (int l = 0; l < kGroup; ++l)
        p[l][u] = __fmaf_rn(w[kGroup - 1 + u - l], d[u], p[l][u]);
  }
#pragma unroll
  for (int l = 0; l < kGroup; ++l) {
    const float sum = __fadd_rn(__fadd_rn(__fadd_rn(p[l][0], p[l][1]), __fadd_rn(p[l][2], p[l][3])),
                                __fadd_rn(__fadd_rn(p[l][4], p[l][5]), __fadd_rn(p[l][6], p[l][7])));
    out[l] = __fdiv_rn(sum, static_cast<float>(kN - (i0 + l)));
  }
}

// The first index of the row holding an inf or NaN (kN if none), given this
// thread's own first one; `scratch` holds a value a warp.
__device__ __forceinline__ int first_nonfinite(int mine, int* scratch) {
  const unsigned int warp_min = __reduce_min_sync(kFull, static_cast<unsigned int>(mine));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = static_cast<int>(warp_min);
  __syncthreads();
  return min(scratch[0], scratch[1]);
}

// The autocorrelation of the row in s[0..511] into acf[0..511], 64 threads,
// `bad` the row's first non-finite index.
__device__ __forceinline__ void row_autocorr(const float* s, int bad, float* acf) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int g = 0; g < 2; ++g) {
    const int i0 = g == 0 ? kGroup * t : kN - kGroup - kGroup * t;
    float out[kGroup];
    lag_group(s, i0, out);
#pragma unroll
    for (int l = 0; l < kGroup; ++l) acf[i0 + l] = i0 + l > bad ? quiet_nan() : out[l];
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// vec_quadratic_peak_pos (src/aubio.rs:576-604) at 0 < pos < n - 1, each step
// rounded as ops/tempo_kernels.py:_quad_peak_pos rounds it.
__device__ __forceinline__ float quad_peak_pos(const float* x, int pos) {
  const float s0 = x[pos - 1], s1 = x[pos], s2 = x[pos + 1];
  const float num = __fmul_rn(0.5f, __fsub_rn(s0, s2));
  const float den = __fadd_rn(__fsub_rn(s0, __fmul_rn(2.0f, s1)), s2);
  return __fadd_rn(static_cast<float>(pos), __fdiv_rn(num, den));
}

// One warp: the period candidate of rayacf `ray` [128] (rp_of in
// ops/tempo_kernels.py), the same value in every lane.
__device__ __forceinline__ float period_candidate(const float* ray, float rayparam_trunc) {
  const int lane = threadIdx.x & 31;
  float v[kLag / 32];
  bool nan = false;
#pragma unroll
  for (int q = 0; q < kLag / 32; ++q) {
    v[q] = ray[lane + 32 * q];
    nan |= isnan(v[q]);
  }
  int idx = 0;
  if (!__any_sync(kFull, nan)) {
    float lane_max = v[0];
#pragma unroll
    for (int q = 1; q < kLag / 32; ++q) lane_max = fmaxf(lane_max, v[q]);
    const float m = warp_max(lane_max);
    if (m >= 0.0f) {  // the last index holding m, -0 and +0 alike
#pragma unroll
      for (int q = 0; q < kLag / 32; ++q) {
        const unsigned int held = __ballot_sync(kFull, v[q] == m);
        if (held != 0u) idx = 32 * q + 31 - __clz(held);
      }
    }
  }
  return idx > 0 && idx < kLag - 1 ? quad_peak_pos(ray, idx) : rayparam_trunc;
}

// acf[mult * gp + k], 0 where that index is outside [0, 512); int32 products
// wrap as the plain version's do.
__device__ __forceinline__ float acf_at(const float* acf, int mult, int gp, int k, bool& ok) {
  const unsigned int wrapped = static_cast<unsigned int>(mult) * static_cast<unsigned int>(gp);
  const long long idx = static_cast<long long>(static_cast<int>(wrapped)) + k;
  ok = idx >= 0 && idx < kN;
  const float v = acf[ok ? idx : 0];
  return ok ? v : 0.0f;
}

// _get_timesig (src/aubio.rs:864-907) at gp = (int) rp, each sum of four
// left to right from 0.
__device__ __forceinline__ int time_signature(const float* acf, float rp) {
  const int gp = __float2int_rz(rp);
  float three_small = 0.0f, four_small = 0.0f, three_big = 0.0f, four_big = 0.0f;
#pragma unroll
  for (int k = -2; k < 2; ++k) {
    bool ok3, ok6, ok4, ok2;
    const float a3 = acf_at(acf, 3, gp, k, ok3);
    const float a6 = acf_at(acf, 6, gp, k, ok6);
    const float a4 = acf_at(acf, 4, gp, k, ok4);
    const float a2 = acf_at(acf, 2, gp, k, ok2);
    three_small = __fadd_rn(three_small, a3);
    four_small = __fadd_rn(four_small, a4);
    three_big = __fadd_rn(three_big, __fadd_rn(ok3 ? a3 : 0.0f, ok3 && ok6 ? a6 : 0.0f));
    four_big = __fadd_rn(four_big, __fadd_rn(ok4 ? a4 : 0.0f, ok4 && ok2 ? a2 : 0.0f));
  }
  const int six = static_cast<int>(6u * static_cast<unsigned int>(gp) + 2u);
  const bool in_range = kN > six;
  const float three = in_range ? three_small : three_big;
  const float four = in_range ? four_small : four_big;
  return gp < 2 ? 4 : (three > four ? 3 : 4);
}

struct Outputs {
  float* dfrev;    // [rows, 512]
  float* comb_u3;  // [rows, 128]
  float* comb_u4;
  float* gwv_if3;
  float* gwv_if4;
  float* rp_if3;   // [rows]
  float* rp_if4;
  int* ts_if3;
  int* ts_if4;
};

__global__ void __launch_bounds__(kThreads)
block_inputs_kernel(const float* __restrict__ thresh, const long long* __restrict__ h_valid,
                    int h, int n_blocks, const float* __restrict__ rwv,
                    const float* __restrict__ dfwv, float rayparam_trunc, float g_var2,
                    Outputs out) {
  __shared__ __align__(16) float s_row[kPad + kN];
  __shared__ __align__(16) float s_acf[kN + kAcfPad];
  __shared__ float s_ray[2][kLag];
  __shared__ float s_rp[2];
  __shared__ int s_bad[2];
  const int t = threadIdx.x;
  const long long row = blockIdx.x;
  const int b = static_cast<int>(row / n_blocks);
  const int k = static_cast<int>(row % n_blocks);
  float* s = s_row + kPad;

  // 1. the row, masked past h_valid; its first non-finite slot
  const long long hv = min(h_valid[b], static_cast<long long>(h));
  const float* series = thresh + static_cast<long long>(b) * h;
  int mine = kN;
#pragma unroll
  for (int m = kN / kThreads - 1; m >= 0; --m) {
    const int slot = t + kThreads * m;
    const long long pos = static_cast<long long>(slot) + static_cast<long long>(kHop) * k - kOffset;
    const float v = pos >= 0 && pos < hv ? series[pos] : 0.0f;
    s[slot] = v;
    if (!isfinite(v)) mine = slot;
  }
  if (t < kPad) s_row[t] = 0.0f;
  if (t < kAcfPad) s_acf[kN + t] = 0.0f;
  const int bad = first_nonfinite(mine, s_bad);  // its barrier publishes the row

  // 2. the autocorrelation
  row_autocorr(s, bad, s_acf);

  // 3. dfrev, coalesced
  float* dfrev = out.dfrev + row * kN;
#pragma unroll
  for (int m = 0; m < kN / kThreads; ++m) {
    const int slot = t + kThreads * m;
    dfrev[slot] = __fmul_rn(s[kN - 1 - slot], dfwv[kN - 1 - slot]);
  }
  __syncthreads();

  // 4. the comb of lags t and t + 64
#pragma unroll
  for (int m = 0; m < kLag / kThreads; ++m) {
    const int i = t + kThreads * m;
    const float interior = i >= 1 && i < kLag - 1 ? 1.0f : 0.0f;
    float c[4];
#pragma unroll
    for (int a = 1; a <= 4; ++a) {
      float total = 0.0f;
#pragma unroll
      for (int u = 0; u < 2 * a - 1; ++u) total = __fadd_rn(total, s_acf[a * i + u]);
      c[a - 1] = __fmul_rn(total, interior);
    }
    const float w3 = __fadd_rn(__fadd_rn(__fmul_rn(c[0], 1.0f), __fmul_rn(c[1], kW1)), __fmul_rn(c[2], kW2));
    const float w4 = __fadd_rn(w3, __fmul_rn(c[3], kW3));
    const float u3 = __fadd_rn(__fadd_rn(c[0], c[1]), c[2]);
    out.comb_u3[row * kLag + i] = u3;
    out.comb_u4[row * kLag + i] = __fadd_rn(u3, c[3]);
    const float r = rwv[i];
    s_ray[0][i] = __fmul_rn(w3, r);
    s_ray[1][i] = __fmul_rn(w4, r);
  }
  __syncthreads();

  // 5, 6. warp 0 the candidate for 3, warp 1 for 4, and its time signature
  const int warp = t >> 5;
  const float rp = period_candidate(s_ray[warp], rayparam_trunc);
  if ((t & 31) == 0) {
    s_rp[warp] = rp;
    (warp == 0 ? out.rp_if3 : out.rp_if4)[row] = rp;
    (warp == 0 ? out.ts_if3 : out.ts_if4)[row] = time_signature(s_acf, rp);
  }
  __syncthreads();

  // 7. both Gaussian weight vectors at lags t and t + 64
#pragma unroll
  for (int m = 0; m < kLag / kThreads; ++m) {
    const int j = t + kThreads * m;
    const float j1 = __fadd_rn(static_cast<float>(j), 1.0f);
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const float diff = __fsub_rn(j1, s_rp[w]);
      const float num = __fmul_rn(__fmul_rn(-0.5f, diff), diff);
      (w == 0 ? out.gwv_if3 : out.gwv_if4)[row * kLag + j] = expf(__fdiv_rn(num, g_var2));
    }
  }
}

}  // namespace

extern "C" int block_inputs_launch(const float* thresh, const long long* h_valid, int batch, int h,
                                   int n_blocks, const float* rwv, const float* dfwv,
                                   float rayparam_trunc, float g_var2, float* dfrev,
                                   float* comb_u3, float* comb_u4, float* gwv_if3,
                                   float* gwv_if4, float* rp_if3, float* rp_if4, int* ts_if3,
                                   int* ts_if4, cudaStream_t stream) {
  if (batch <= 0 || n_blocks <= 0) return 0;
  const long long rows = static_cast<long long>(batch) * n_blocks;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Outputs out{dfrev, comb_u3, comb_u4, gwv_if3, gwv_if4, rp_if3, rp_if4, ts_if3, ts_if4};
  block_inputs_kernel<<<static_cast<unsigned int>(rows), kThreads, 0, stream>>>(
      thresh, h_valid, h, n_blocks, rwv, dfwv, rayparam_trunc, g_var2, out);
  return static_cast<int>(cudaGetLastError());
}
