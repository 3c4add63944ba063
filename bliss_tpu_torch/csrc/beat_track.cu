// The beat tracker's hypothesis machine (ops/tempo_kernels.py:beat_track),
// aubio's BeatTracking::do_ and ::checkstate (src/aubio.rs:966-1227).
//
// Replaces bliss_tpu/models/tempo.py:760 lax.scan (_bt_do/_checkstate), the
// one sequential stage of the tempo descriptor. It has no Pallas kernel: on
// the TPU the scan body is XLA, and its phase sum is a selection-matrix
// product `C @ dfrev` (tempo.py:566-587) because the TPU gathers slowly. Here
// the sum is a direct in-order gather from shared memory.
//
// One warp a song walks that song's valid blocks in order. The state lives
// in registers: the scalars (time signature, counter, flag, gp, bp, the two
// last rp, the last beat) in every lane alike, the 128 comb weights `gwv` and
// the 256 phase weights `phwv` as 4 and 8 values a lane (index lane + 32 r).
// A block step:
//   - checkstate: acfout = comb_u * gwv over 128 lanes, its last maximum
//     (warp shuffles) and the quadratic peak around it (neighbours from
//     shared memory); the counter and flag updates; the three-way choice of
//     bp, gwv and phwv (the context model's Gaussian over 256 lanes); the
//     doubling of slow tempi, capped at 32;
//   - if bp != 0, the beat phase: phout[i] = sum over k < 21 of
//     dfrev[i + round(bp k)] for i < min(bp, 160), weighted by phwv, its
//     last maximum and peak, the skip test, at most 24 catch-up additions,
//     up to 8 beats, the last beat.
// There is no block barrier: a step is one warp's (__syncwarp between the
// shared-memory writes and the reads). The next block's inputs do not depend
// on the state, so each step loads them into registers before it computes.
// Blocks past a song's `n_valid` leave its state as it is: bp stays, no beat
// fires.
//
// Bit for bit with the plain version (ops/tempo_kernels.py:_bt_do), which
// rounds every eager op on its own:
//   - no FMA contraction: every product, sum and quotient that the plain
//     version rounds is written __fmul_rn / __fadd_rn / __fsub_rn /
//     __fdiv_rn (nvcc would contract a * b + c; the build's flags stay those
//     of every other source). At risk: the quadratic peak
//     pos + 0.5 (s0 - s2) / (s0 - 2 s1 + s2), round(bp k + 0.5),
//     d2 = 1 + j - step + lastbeat, -0.5 d2 d2 / (gp / 8), and the BPM of
//     the firing stage, which stays in PyTorch;
//   - `expf`, never `__expf`, and no fast math: PyTorch's exp on the card;
//   - `512 / bp` is PyTorch's `__rtruediv__`: reciprocal(bp) * 512;
//   - phout's sum over k runs left to right, terms that do not apply added
//     as 0, as the plain version adds them;
//   - the last maximum of the 512-wide phout, of which only 160 entries can
//     be nonzero: the 256 weighted entries are reduced here and the 256
//     unweighted zeros stand in by rule: any NaN gives index 0 (as torch.amax
//     and argmax do); else a weighted entry above 0 gives its last index;
//     else the maximum is 0 and its last index is 511, where the phase is
//     step - lastbeat. A weighted entry of 0 ties with the zeros and loses to
//     index 511; the peak at index 255 reads phout[256] = 0. The weighted
//     entries 160..255 are 0 * phwv, NaN where phwv is inf or NaN;
//   - NaN and inf propagate as IEEE arithmetic does under torch.where; float
//     to int conversions are the card's (cvt.rzi: NaN to 0, saturating);
//   - 32 conditional doublings equal the plain version's closed form
//     (_double_slow_tempi) bit for bit: doubling is exact.
//
// Bound on the card: bytes. Each block's inputs are read once, 1,028 words
// (4,112 B: dfrev 512, comb_u3/u4 128 each, gwv_if3/if4 128 each, rp and the
// time signature for 3 and 4), and 44 B a block are written; 8 songs x 224
// blocks of 5 minutes are 7.4 MB, 2.2 us at 3.35 TB/s. The chain of block
// steps is sequential, so the kernel stays far above that bound: its time is
// the latency of one step (a few reductions over a warp, 21 shared-memory
// gathers a lane, 24 dependent additions at most) times the number of
// blocks of the longest song.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWin = 512;       // winlen
constexpr int kStep = 128;      // step
constexpr int kLag = 128;       // laglen
constexpr int kPhwv = 2 * kLag; // phase weights
constexpr int kPhaseI = 160;    // beat-phase rows: i < bp <= ~130
constexpr int kMaxK = 21;       // kmax = floor(512 / bp) <= 20
constexpr int kMaxBeats = 8;
constexpr int kCatchUp = 24;
constexpr int kDoublings = 32;
constexpr float kGVar = 3.901f;
constexpr unsigned int kFull = 0xffffffffu;

constexpr int kDfLane = kWin / 32;      // 16
constexpr int kLagLane = kLag / 32;     // 4
constexpr int kPhLane = kPhwv / 32;     // 8
constexpr int kHeadLane = kPhaseI / 32; // 5

struct Inputs {
  const float* dfrev;    // [B, NB, 512]
  const float* comb_u3;  // [B, NB, 128]
  const float* comb_u4;
  const float* gwv_if3;
  const float* gwv_if4;
  const float* rp_if3;   // [B, NB]
  const float* rp_if4;
  const int* ts_if3;
  const int* ts_if4;
};

// One block's inputs, a lane's share (index lane + 32 r).
struct Block {
  float df[kDfLane];
  float cu3[kLagLane], cu4[kLagLane], g3[kLagLane], g4[kLagLane];
  float rp3, rp4;
  int ts3, ts4;
};

__device__ __forceinline__ void load_block(const Inputs& in, long long row, int lane,
                                           Block& b) {
  const float* df = in.dfrev + row * kWin;
#pragma unroll
  for (int q = 0; q < kDfLane; ++q) b.df[q] = __ldg(df + lane + 32 * q);
  const long long lag = row * kLag + lane;
#pragma unroll
  for (int r = 0; r < kLagLane; ++r) {
    b.cu3[r] = __ldg(in.comb_u3 + lag + 32 * r);
    b.cu4[r] = __ldg(in.comb_u4 + lag + 32 * r);
    b.g3[r] = __ldg(in.gwv_if3 + lag + 32 * r);
    b.g4[r] = __ldg(in.gwv_if4 + lag + 32 * r);
  }
  b.rp3 = __ldg(in.rp_if3 + row);
  b.rp4 = __ldg(in.rp_if4 + row);
  b.ts3 = __ldg(in.ts_if3 + row);
  b.ts4 = __ldg(in.ts_if4 + row);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Over the warp's 32 R values (index lane + 32 r): whether one is NaN, their
// maximum (NaN-free then), and the last index holding `m`.
template <int R>
__device__ __forceinline__ bool any_nan(const float (&v)[R]) {
  bool nan = false;
#pragma unroll
  for (int r = 0; r < R; ++r) nan |= isnan(v[r]);
  return __any_sync(kFull, nan);
}

template <int R>
__device__ __forceinline__ float max_of(const float (&v)[R]) {
  float m = -INFINITY;
#pragma unroll
  for (int r = 0; r < R; ++r) m = fmaxf(m, v[r]);
  return warp_max(m);
}

template <int R>
__device__ __forceinline__ int last_index_of(const float (&v)[R], float m, int lane) {
  int idx = -1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (v[r] == m) idx = lane + 32 * r;
  }
  return warp_max(idx);
}

// vec_quadratic_peak_pos (src/aubio.rs:576-604) over x[0, n) at pos, each
// step rounded as ops/tempo_kernels.py:_quad_peak_pos rounds it.
__device__ __forceinline__ float quad_peak_pos(const float* x, int pos, int n) {
  if (pos == 0 || pos >= n - 1) return static_cast<float>(pos);
  const float s0 = x[pos - 1], s1 = x[pos], s2 = x[pos + 1];
  const float num = __fmul_rn(0.5f, __fsub_rn(s0, s2));
  const float den = __fadd_rn(__fsub_rn(s0, __fmul_rn(2.0f, s1)), s2);
  return __fadd_rn(static_cast<float>(pos), __fdiv_rn(num, den));
}

__global__ void __launch_bounds__(32)
beat_track_kernel(Inputs in, const int* __restrict__ n_valid, int n_blocks,
                  float* __restrict__ bp_out, float* __restrict__ beats_out,
                  unsigned char* __restrict__ fired_out) {
  __shared__ float s_df[kWin];
  __shared__ float s_acf[kLag];
  __shared__ float s_ph[kPhwv + 1];  // the weighted phout head and phout[256] = 0

  const int lane = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * n_blocks;
  const int nv = min(max(n_valid[blockIdx.x], 0), n_blocks);
  if (lane == 0) s_ph[kPhwv] = 0.0f;

  // initial_beat_state
  float gwv[kLagLane], phwv[kPhLane];
#pragma unroll
  for (int r = 0; r < kLagLane; ++r) gwv[r] = 0.0f;
#pragma unroll
  for (int r = 0; r < kPhLane; ++r) phwv[r] = 1.0f;
  int timesig = 0, counter = 0, flagstep = 0;
  float gp = 0.0f, bp = 0.0f, rp1 = 0.0f, rp2 = 0.0f, lastbeat = 0.0f;

  Block cur, nxt;
  if (nv > 0) load_block(in, row0, lane, cur);
  for (int k = 0; k < nv; ++k) {
#pragma unroll
    for (int q = 0; q < kDfLane; ++q) s_df[lane + 32 * q] = cur.df[q];
    if (k + 1 < nv) load_block(in, row0 + k + 1, lane, nxt);

    // ---- checkstate (src/aubio.rs:1096-1227)
    const bool sel3 = timesig == 3;
    const float rp = sel3 ? cur.rp3 : cur.rp4;
    float acf[kLagLane];
#pragma unroll
    for (int r = 0; r < kLagLane; ++r) {
      acf[r] = __fmul_rn(timesig == 4 ? cur.cu4[r] : cur.cu3[r], gwv[r]);
      s_acf[lane + 32 * r] = acf[r];
    }
    __syncwarp();
    int acf_max = 0;  // _vec_max_elem: 0 on a NaN or when every value is < 0
    if (!any_nan(acf)) {
      const float m = max_of(acf);
      if (m >= 0.0f) acf_max = last_index_of(acf, m, lane);
    }
    const float gp_cand = quad_peak_pos(s_acf, acf_max, kLag);
    const float gp_new = gp > 0.0f ? gp_cand : 0.0f;

    const bool at_zero = counter == 0;
    const bool step_change = fabsf(__fsub_rn(gp_new, rp)) > 2.0f * kGVar;
    if (at_zero) flagstep = step_change ? 1 : 0;
    if (at_zero && step_change) counter = 3;
    const bool check = counter == 1 && flagstep == 1;
    const bool consistent =
        fabsf(__fsub_rn(__fsub_rn(__fmul_rn(2.0f, rp), rp1), rp2)) < kGVar;
    const bool flagconst = check && consistent;
    counter = check ? (consistent ? 0 : 2) : (counter > 0 ? counter - 1 : counter);

    const bool use_ctx = !flagconst && timesig > 0;
    const bool ctx_weights = use_ctx && static_cast<float>(kStep) > lastbeat;
#pragma unroll
    for (int r = 0; r < kPhLane; ++r) {
      float w = 1.0f;
      if (ctx_weights) {
        // d2 = 1 + j - step + lastbeat; exp(-0.5 d2 d2 / (gp / 8))
        const float d2 = __fadd_rn(static_cast<float>(lane + 32 * r + 1 - kStep), lastbeat);
        const float num = __fmul_rn(__fmul_rn(-0.5f, d2), d2);
        w = expf(__fdiv_rn(num, __fmul_rn(gp_new, 0.125f)));
      }
      phwv[r] = w;
    }
    float bp_new = flagconst ? rp : (use_ctx ? gp_new : rp);
    if (flagconst) {
#pragma unroll
      for (int r = 0; r < kLagLane; ++r) gwv[r] = sel3 ? cur.g3[r] : cur.g4[r];
      timesig = sel3 ? cur.ts3 : cur.ts4;
    }
    gp = flagconst ? rp : gp_new;
    rp2 = rp1;
    rp1 = rp;
    // while 0 < bp < 25: bp *= 2 (src/aubio.rs:1216-1218), 32 at most
    for (int n = 0; n < kDoublings && bp_new > 0.0f && bp_new < 25.0f; ++n) {
      bp_new = __fmul_rn(bp_new, 2.0f);
    }
    bp = bp_new;

    // ---- beat phase (src/aubio.rs:1017-1091)
    float vals[kMaxBeats];
    bool fires[kMaxBeats];
#pragma unroll
    for (int n = 0; n < kMaxBeats; ++n) {
      vals[n] = 0.0f;
      fires[n] = false;
    }
    if (bp != 0.0f) {
      const int kmax = static_cast<int>(floorf(__fmul_rn(__frcp_rn(bp), static_cast<float>(kWin))));
      float ph[kPhLane];
#pragma unroll
      for (int r = 0; r < kHeadLane; ++r) {
        const int i = lane + 32 * r;
        const bool i_ok = static_cast<float>(i) < bp;
        float acc = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kMaxK; ++kk) {
          float term = 0.0f;
          if (i_ok && kk < kmax) {
            // ROUND(x) = floor(x + 0.5); here 0 < bp k <= 512
            const int off = static_cast<int>(
                floorf(__fadd_rn(__fmul_rn(bp, static_cast<float>(kk)), 0.5f)));
            const int idx = i + off;
            if (idx < kWin) term = s_df[max(idx, 0)];
          }
          acc = kk == 0 ? term : __fadd_rn(acc, term);
        }
        ph[r] = __fmul_rn(acc, phwv[r]);
      }
#pragma unroll
      for (int r = kHeadLane; r < kPhLane; ++r) ph[r] = __fmul_rn(0.0f, phwv[r]);
#pragma unroll
      for (int r = 0; r < kPhLane; ++r) s_ph[lane + 32 * r] = ph[r];
      __syncwarp();
      int ph_max = kWin - 1;  // the maximum is one of the unweighted zeros
      if (any_nan(ph)) {
        ph_max = 0;
      } else {
        const float m = max_of(ph);
        if (m > 0.0f) ph_max = last_index_of(ph, m, lane);
      }
      float phase = ph_max >= kWin - 1 ? __fsub_rn(static_cast<float>(kStep), lastbeat)
                                       : quad_peak_pos(s_ph, ph_max, kWin);
      phase = __fadd_rn(phase, 1.0f);

      float beat = __fsub_rn(bp, phase);
      const bool skip = __fsub_rn(__fsub_rn(static_cast<float>(kStep), lastbeat), phase) <
                        __fmul_rn(-0.4f, bp);
      if (skip) beat = __fadd_rn(beat, bp);
      // while beat + bp < 0: beat += bp, 24 times at most
      for (int n = 0; n < kCatchUp && __fadd_rn(beat, bp) < 0.0f; ++n) {
        beat = __fadd_rn(beat, bp);
      }
      // emit: the first beat if beat >= 0, then while beat + bp <= step
      vals[0] = beat;
      fires[0] = beat >= 0.0f;
#pragma unroll
      for (int n = 1; n < kMaxBeats; ++n) {
        const float next = __fadd_rn(beat, bp);
        const bool more = next <= static_cast<float>(kStep);
        if (more) beat = next;
        vals[n] = beat;
        fires[n] = more;
      }
      lastbeat = beat;
    }

    const long long row = row0 + k;
    float my_val = 0.0f;
    bool my_fire = false;
#pragma unroll
    for (int n = 0; n < kMaxBeats; ++n) {
      if (lane == n) {
        my_val = vals[n];
        my_fire = fires[n];
      }
    }
    if (lane < kMaxBeats) {
      beats_out[row * kMaxBeats + lane] = my_val;
      fired_out[row * kMaxBeats + lane] = my_fire ? 1 : 0;
    }
    if (lane == 0) bp_out[row] = bp;
    __syncwarp();  // this step's shared-memory reads before the next one's writes
    if (k + 1 < nv) cur = nxt;
  }

  // past the valid blocks the state stays: bp as it is, no beat
  for (long long i = static_cast<long long>(nv) * kMaxBeats + lane;
       i < static_cast<long long>(n_blocks) * kMaxBeats; i += 32) {
    beats_out[row0 * kMaxBeats + i] = 0.0f;
    fired_out[row0 * kMaxBeats + i] = 0;
  }
  for (int k = nv + lane; k < n_blocks; k += 32) bp_out[row0 + k] = bp;
}

}  // namespace

extern "C" int beat_track_launch(const float* dfrev, const float* comb_u3,
                                 const float* comb_u4, const float* gwv_if3,
                                 const float* gwv_if4, const float* rp_if3,
                                 const float* rp_if4, const int* ts_if3,
                                 const int* ts_if4, const int* n_valid, int batch,
                                 int n_blocks, float* bp, float* beats,
                                 unsigned char* fired, cudaStream_t stream) {
  if (batch <= 0 || n_blocks <= 0) return 0;
  const Inputs in{dfrev, comb_u3, comb_u4, gwv_if3, gwv_if4,
                  rp_if3, rp_if4, ts_if3, ts_if4};
  beat_track_kernel<<<batch, 32, 0, stream>>>(in, n_valid, n_blocks, bp, beats, fired);
  return static_cast<int>(cudaGetLastError());
}
