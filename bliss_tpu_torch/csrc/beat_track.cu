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
// last rp, the last beat) in every lane alike, the 128 comb weights `gwv` as
// 4 values a lane (index lane + 32 r). A block step:
//   - checkstate: acfout = comb_u * gwv over 128 lanes, its last maximum
//     and the quadratic peak around it (neighbours from shared memory); the
//     counter and flag updates; the three-way choice of bp, gwv and the 256
//     phase weights `phwv` (the context model's Gaussian, 8 a lane); the
//     doubling of slow tempi, capped at 32;
//   - if bp != 0, the beat phase: phout[i] = sum over k < 21 of
//     dfrev[i + round(bp k)] for i < min(bp, 160), weighted by phwv, its
//     last maximum and peak, the skip test, at most 24 catch-up additions,
//     up to 8 beats, the last beat.
// There is no block barrier: a step is one warp's (__syncwarp between the
// shared-memory writes and the reads). Blocks past a song's `n_valid` leave
// its state as it is: bp stays, no beat fires.
//
// The design of a step:
//   - the inputs travel through a ring of kStages block slots in shared
//     memory, filled kStages - 1 blocks ahead by cp.async (16 bytes a lane
//     and copy, 8 copies a lane a block): no registers hold the next block
//     and no step copies it, and a lane reads only the comb and weights that
//     its time signature selects;
//   - the phase sum's offsets round(bp k) are the same for every row i: lane
//     k < 21 computes off_k once a step (512 where k >= kmax), and a lane
//     reads its rows' terms at s_df + lane + off_k + 32 r. Each slot holds
//     zeros past dfrev, so a term past the buffer, of a k >= kmax, reads 0
//     with no test; the rows i >= bp are set to 0 after the sum;
//   - the last maximum of 128 or 160 values: one shuffle chain for the
//     maximum, a ballot a register row for where it sits, the NaN test a
//     vote beside them (the earlier design ran three chains in a row);
//   - the context weights' 8 quotients a lane share one denominator: its
//     reciprocal is rounded once and each quotient corrected by FMA
//     (div_rn_by), branch-free, so they and their exponentials run beside
//     the phase sum's loads; `__fdiv_rn`, whose slow-path branch kept them
//     one after another, serves where a number falls outside the range
//     where div_rn_by rounds once.
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
//     as +0, as the plain version adds them (a valid k has
//     0 <= round(bp k) <= 512, so the zeros past dfrev serve every term
//     that does not apply);
//   - the last maximum: a NaN gives index 0 (torch.amax is NaN, and
//     `amax >= 0` fails); else the last index of the maximum m, if m >= 0
//     (acfout), else 0. Of the 512-wide phout only 160 entries can be
//     nonzero: any NaN among the 256 weighted entries gives index 0; else a
//     weighted entry above 0 gives its last index; else the maximum is 0 and
//     its last index is 511, where the phase is step - lastbeat. A weighted
//     entry of 0 ties with the zeros and loses to index 511. The weighted
//     entries 160..255 are 0 * phwv, NaN where phwv is inf or NaN; -0 and +0
//     are equal to the ballot, as to torch's comparisons;
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
// the latency of one step times the number of blocks of the longest song.
#include <cuda_runtime.h>
#include <math.h>

#include "fft_common.cuh"

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

constexpr int kLagLane = kLag / 32;     // 4
constexpr int kPhLane = kPhwv / 32;     // 8
constexpr int kHeadLane = kPhaseI / 32; // 5

// A ring slot (floats): dfrev and the zeros past it that the phase sum's
// rows read (i + off_k <= 159 + 512), the comb and weight rows, then rp for
// 3 and 4 and the two time signatures (their int bits).
constexpr int kStages = 4;
constexpr int kDfSlot = kWin + kPhaseI + 32;  // 704
constexpr int kCombU3 = kDfSlot;
constexpr int kCombU4 = kCombU3 + kLag;
constexpr int kGwv3 = kCombU4 + kLag;
constexpr int kGwv4 = kGwv3 + kLag;
constexpr int kScalars = kGwv4 + kLag;  // rp3, rp4, ts3, ts4
constexpr int kSlot = kScalars + 4;     // 1,220 floats, a multiple of 4
static_assert(kSlot % 4 == 0 && kDfSlot % 4 == 0, "16-byte copies need 16-byte slots");

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

// Block `row`'s inputs into a ring slot: dfrev's 128 16-byte pieces and the
// comb and weight rows' 4 x 32, four and four a lane; lanes 0-3 the scalars.
__device__ __forceinline__ void issue_block(const Inputs& in, long long row, float* slot,
                                            int lane) {
  const float* df = in.dfrev + row * kWin;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int at = 4 * (lane + 32 * q);
    bliss::cp_async<16>(slot + at, df + at);
  }
  const float* rows[4] = {in.comb_u3, in.comb_u4, in.gwv_if3, in.gwv_if4};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bliss::cp_async<16>(slot + kCombU3 + kLag * q + 4 * lane, rows[q] + row * kLag + 4 * lane);
  }
  if (lane < 4) {
    const float* scalar = lane == 0   ? in.rp_if3 + row
                          : lane == 1 ? in.rp_if4 + row
                          : lane == 2 ? reinterpret_cast<const float*>(in.ts_if3 + row)
                                      : reinterpret_cast<const float*>(in.ts_if4 + row);
    bliss::cp_async<4>(slot + kScalars + lane, scalar);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Over the warp's 32 R values (index lane + 32 r), NaN-free: their maximum
// `m` and the last index holding it (-0 and +0 alike): one shuffle chain,
// then a ballot a register row, the last row with a holder and its last
// lane.
template <int R>
__device__ __forceinline__ int last_max(const float (&v)[R], float& m) {
  float lane_max = v[0];
#pragma unroll
  for (int r = 1; r < R; ++r) lane_max = fmaxf(lane_max, v[r]);
  m = warp_max(lane_max);
  unsigned int held[R];
#pragma unroll
  for (int r = 0; r < R; ++r) held[r] = __ballot_sync(kFull, v[r] == m);
  int idx = -1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (held[r] != 0u) idx = 32 * r + 31 - __clz(held[r]);
  }
  return idx;
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

// a / b rounded once, without a branch, given y = RN(1/b) (__frcp_rn): a y
// is within two ulps of a / b; a correction q + (a - b q) y by FMA brings it
// within one, and a second, its remainder now exact, rounds to RN(a / b)
// (Markstein's theorem on division by a correctly rounded reciprocal). It
// holds while a, b, a / b and the remainder stay in the normal range: the
// caller checks `fast_quotient_range` first. tests/test_torch_beat_track.py
// holds the same arithmetic against f32 division on 10^6 pairs.
__device__ __forceinline__ float div_rn_by(float a, float b, float y) {
  float q = __fmul_rn(a, y);
#pragma unroll
  for (int n = 0; n < 2; ++n) q = __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
  return q;
}

// Whether div_rn_by serves a / b: b in [2^-20, 2^20], a zero or |a| in
// [2^-90, 2^90] (so |a / b| and the remainder stay normal); NaN fails.
__device__ __forceinline__ bool fast_quotient_range(float a, float b) {
  const float m = fabsf(a);
  return b >= 0x1p-20f && b <= 0x1p20f && (a == 0.0f || (m >= 0x1p-90f && m <= 0x1p90f));
}

__global__ void __launch_bounds__(32)
beat_track_kernel(Inputs in, const int* __restrict__ n_valid, int n_blocks,
                  float* __restrict__ bp_out, float* __restrict__ beats_out,
                  unsigned char* __restrict__ fired_out) {
  __shared__ __align__(16) float s_ring[kStages * kSlot];
  __shared__ float s_acf[kLag];
  __shared__ float s_ph[kPhaseI + 1];  // the weighted phout head and phout[160] = 0

  const int lane = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * n_blocks;
  const int nv = min(max(n_valid[blockIdx.x], 0), n_blocks);
  if (lane == 0) s_ph[kPhaseI] = 0.0f;
  for (int st = 0; st < kStages; ++st) {
    for (int j = kWin + lane; j < kDfSlot; j += 32) s_ring[st * kSlot + j] = 0.0f;
  }
  // the first kStages - 1 blocks in flight, a commit group each
#pragma unroll
  for (int b = 0; b < kStages - 1; ++b) {
    if (b < nv) issue_block(in, row0 + b, s_ring + b * kSlot, lane);
    bliss::cp_async_commit();
  }

  // initial_beat_state
  float gwv[kLagLane];
#pragma unroll
  for (int r = 0; r < kLagLane; ++r) gwv[r] = 0.0f;
  int timesig = 0, counter = 0, flagstep = 0;
  float gp = 0.0f, bp = 0.0f, rp1 = 0.0f, rp2 = 0.0f, lastbeat = 0.0f;

  for (int k = 0; k < nv; ++k) {
    // ---- the ring: block k + kStages - 1 into the slot block k - 1 left
    // (every lane read it before the last step's closing __syncwarp), then
    // block k, landed
    const int ahead = k + kStages - 1;
    if (ahead < nv) issue_block(in, row0 + ahead, s_ring + (ahead % kStages) * kSlot, lane);
    bliss::cp_async_commit();
    bliss::cp_async_wait<kStages - 1>();
    __syncwarp();
    const float* blk = s_ring + (k % kStages) * kSlot;

    // ---- checkstate (src/aubio.rs:1096-1227)
    const bool sel3 = timesig == 3;
    const float rp = blk[kScalars + (sel3 ? 0 : 1)];
    const float* comb = blk + (timesig == 4 ? kCombU4 : kCombU3);
    float acf[kLagLane];
    bool nan = false;
#pragma unroll
    for (int r = 0; r < kLagLane; ++r) {
      acf[r] = __fmul_rn(comb[lane + 32 * r], gwv[r]);
      s_acf[lane + 32 * r] = acf[r];
      nan |= isnan(acf[r]);
    }
    __syncwarp();
    float m;
    const int at_max = last_max(acf, m);
    // _vec_max_elem: 0 on a NaN or when every value is < 0
    const int acf_max = (__any_sync(kFull, nan) || !(m >= 0.0f)) ? 0 : at_max;
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

    // the phase weights' numerators and the reciprocal of their common
    // denominator; the quotients and exponentials run beside the phase sum
    const bool use_ctx = !flagconst && timesig > 0;
    const bool ctx_weights = use_ctx && static_cast<float>(kStep) > lastbeat;
    const float den = __fmul_rn(gp_new, 0.125f);
    float num[kPhLane];
    bool fast = true;
#pragma unroll
    for (int r = 0; r < kPhLane; ++r) {
      // d2 = 1 + j - step + lastbeat; exp(-0.5 d2 d2 / (gp / 8))
      const float d2 = __fadd_rn(static_cast<float>(lane + 32 * r + 1 - kStep), lastbeat);
      num[r] = __fmul_rn(__fmul_rn(-0.5f, d2), d2);
      fast &= fast_quotient_range(num[r], den);
    }
    fast = __all_sync(kFull, fast);
    const float den_rcp = __frcp_rn(den);

    float bp_new = flagconst ? rp : (use_ctx ? gp_new : rp);
    if (flagconst) {
      const float* g = blk + (sel3 ? kGwv3 : kGwv4);
#pragma unroll
      for (int r = 0; r < kLagLane; ++r) gwv[r] = g[lane + 32 * r];
      timesig = __float_as_int(blk[kScalars + (sel3 ? 2 : 3)]);
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
      // ROUND(x) = floor(x + 0.5) (src/aubio.rs:1038-1039), on lane k; a k that
      // does not apply reads the zeros at 512. A k < kmax has 0 < bp k <= 512.
      int my_off = kWin;
      if (lane < kMaxK && lane < kmax) {
        my_off = static_cast<int>(
            floorf(__fadd_rn(__fmul_rn(bp, static_cast<float>(lane)), 0.5f)));
        my_off = min(max(my_off, 0), kWin);
      }
      const float* row = blk + lane;
      float acc[kHeadLane];
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        const float* p = row + __shfl_sync(kFull, my_off, kk);
#pragma unroll
        for (int r = 0; r < kHeadLane; ++r) {
          const float term = p[32 * r];
          acc[r] = kk == 0 ? term : __fadd_rn(acc[r], term);
        }
      }
      // the weights, branch-free in the fast division's range, else as the
      // plain version divides
      float phwv[kPhLane];
#pragma unroll
      for (int r = 0; r < kPhLane; ++r) phwv[r] = expf(div_rn_by(num[r], den, den_rcp));
      if (!fast) {
#pragma unroll
        for (int r = 0; r < kPhLane; ++r) phwv[r] = expf(__fdiv_rn(num[r], den));
      }
      if (!ctx_weights) {
#pragma unroll
        for (int r = 0; r < kPhLane; ++r) phwv[r] = 1.0f;
      }
      float ph[kPhLane];
      bool ph_nan = false;
#pragma unroll
      for (int r = 0; r < kPhLane; ++r) {
        const bool i_ok = r < kHeadLane && static_cast<float>(lane + 32 * r) < bp;
        ph[r] = __fmul_rn(i_ok ? acc[r < kHeadLane ? r : 0] : 0.0f, phwv[r]);
        ph_nan |= isnan(ph[r]);
      }
#pragma unroll
      for (int r = 0; r < kHeadLane; ++r) s_ph[lane + 32 * r] = ph[r];
      __syncwarp();
      // the head's maximum; entries 160..255 are 0 unless NaN, the other 256 are 0
      float head[kHeadLane];
#pragma unroll
      for (int r = 0; r < kHeadLane; ++r) head[r] = ph[r];
      float mh;
      const int at_head = last_max(head, mh);
      const int ph_max = __any_sync(kFull, ph_nan) ? 0 : (mh > 0.0f ? at_head : kWin - 1);
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

    const long long out_row = row0 + k;
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
      beats_out[out_row * kMaxBeats + lane] = my_val;
      fired_out[out_row * kMaxBeats + lane] = my_fire ? 1 : 0;
    }
    if (lane == 0) bp_out[out_row] = bp;
    __syncwarp();  // this step's shared-memory reads before the next one's writes
  }
  bliss::cp_async_wait<0>();

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
