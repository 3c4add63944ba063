// Exact integer passes of the tuning estimator (models/chroma.py,
// src/chroma.rs:334-391): the fused route (1, 2) for buckets whose tuning
// plane fits the reference's budget, the unfused route (3, 4) above it.
//
// 1. tuning_peaks and 2. tuning_select together replace
//    bliss_tpu/ops/pallas_select.py:129 _make_bisect16_pair_kernel (via
//    bisect16_pair, run twice) and
//    bliss_tpu/ops/pallas_hist.py:93 _make_threshold_kernel (via
//    histogram_threshold_plane). The TPU route
//    builds three [B, F, rows] planes in one stencil sweep (the i32 sort
//    keys of the peak magnitudes, the i8 tuning bins, the keys' top 16 bits),
//    because its kernels need a plane resident in VMEM; then two paired
//    16-bit bisections select the midpoint median's floor and ceil ranks
//    (the second over a low-16-bit plane of the floor rank's bucket), and a
//    threshold histogram counts the tuning bins of the keys >= the median's
//    key. About 0.5% of the band are peaks, and the card has no VMEM to fill:
//    1. tuning_peaks reads the frame-major spectrum [B, F, bins] once, a
//       frame a warp in 16-byte loads: the row's max (NaN-propagating, as
//       torch.amax), the band staged in shared memory, then pip_stencil's
//       stencil, tuning bin and sort key at every band row, each step
//       rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, no
//       FMA contraction) as the plain composition rounds on the card; the
//       division by the resolution is a product with its f32 reciprocal, as
//       PyTorch's CUDA division by a Python scalar computes it. Each peak
//       with a positive pitch in a valid frame appends (key i32, bin u8) to
//       its song's list: the warp counts the frame's peaks, takes its place
//       with one atomicAdd on the song's counter and writes them at ballot
//       offsets. No two adjacent rows are both peaks (row i needs
//       after <= elem, row i + 1 elem < after), so a frame holds at most
//       ceil(rows / 2) and a list of F ceil(rows / 2) entries cannot
//       overflow.
//    2. tuning_select, one 1024-thread block a song over its list (~25,000
//       entries, in L2): the two ranks k_f = (n - 1) / 2, k_c = n / 2 as
//       exact order statistics by byte-radix levels with 256-bucket
//       shared-memory histograms, both ranks in each pass: the high 16 bits
//       (u16 0xFFFF excluded), then the low 16 bits among the keys of the
//       floor rank's bucket (0xFFFF excluded) and, in the same pass, the
//       least low half of the ceil rank's bucket. It writes the TPU
//       contract's intermediates bit for bit as the plane composition gives
//       them (o1 = bisect16_pair over the top halves, o2 = the second
//       bisect16_pair, min_c, the threshold key tk, sentinels included),
//       then the 100-bin histogram of the entries with key >= tk. Skewed
//       buckets (a song's keys share a few exponent bytes) are counted
//       warp-aggregated: the lanes of one bucket add once (__match_any_sync).
//
// 3. bisect8 and bisect8_keys replace
//    bliss_tpu/ops/pallas_select.py:39 _make_bisect8_kernel
//    (via _bisect8 and masked_quantile_midpoint_radix): one level of a
//    4-level byte radix select over the u32 sort keys of f32 values. Over
//    one key byte per element (byte 0xFF also marks an excluded
//    element) a level finds the bucket b = the smallest v <= 0xFE with
//    count(<= v) >= k + 1, else 0xFF, and below = count(<= b - 1). A valid
//    byte 0xFF shares its value with the sentinel; like the TPU kernel, the
//    count never includes v = 0xFF, so such an element is reached as the 0xFF
//    fallback and never counted in `below`. The TPU's eight bisection passes
//    over a VMEM plane become one counting pass: a 256-bucket per-song
//    histogram in shared memory, then a one-block scan.
//    The counting pass is a template on its loader. The int8-plane loader
//    (bisect8) reads the plane the TPU kernel reads: the key byte offset by
//    -128, sentinel 127, formed by the caller. That plane exists to fit the
//    TPU's VMEM; the card has no such limit, so the key loader (bisect8_keys)
//    forms its own: it reads the bool mask and, only where it holds, the f32
//    value, makes the sort key, tests the key's higher bytes against the
//    prefix found so far and counts this level's byte, for the floor and the
//    ceil rank of the midpoint quantile in one pass (two histograms, two
//    prefixes, one read of the mask). Its scan takes both ranks in one
//    launch and advances the select's state on the device (prefixes,
//    remaining ranks, valid count), so a whole select is 4 launches with no
//    [B, N] intermediate and no host synchronisation.
// 4. hist_int replaces bliss_tpu/ops/pallas_hist.py:45 _make_kernel (via
//    histogram_int_plane): counts of idx == v for v in [0, n_bins) over an
//    int32 plane; other values (the caller's sentinel n_bins) are ignored.
//    Per-block shared-memory counters, one global atomic per nonzero counter.
//
// All of them count exact integers, so the order of the atomics does not
// matter.
//
// Bound on the card: bytes. tuning_peaks reads the spectrum once (the valid
// frames, 4 bytes a bin; 436 MB for 8 songs of 5 minutes, 0.130 ms) and
// writes 5 bytes a peak; tuning_select reads the list (5 bytes a peak)
// and writes ~450 bytes a song; the old planes' 9 bytes for each of the
// band's elements, and their eager temporaries, are gone. The other
// planes are read once (1 byte per element for bisect8, 1 of mask plus 4
// per valid element for bisect8_keys, 4 for hist_int); the value reads are
// skipped for excluded elements. The byte streams of bisect8 and
// bisect8_keys are read as aligned 16-byte vectors, and a vector that holds
// only excluded elements costs one compare. The 256-bucket and 128-counter
// histograms stay in shared memory. Excluded elements (most of every plane:
// ~0.5% of the tuning band are peaks) skip every atomic.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kHistThreads = 256;
constexpr unsigned int kFull = 0xffffffffu;

// ---- the fused route: the peak list, then one block a song ----------------

constexpr int kPeakWarps = 8;  // frames a block, one a warp
constexpr int kSelectThreads = 1024;
constexpr int kMaxTuningBins = 128;

// The band and the tuning bin's constants (models/chroma.py:peak_band,
// ops/tuning_kernels.py:tuning_bins): band row i is spectrum bin first + 1 + i, read with its
// two neighbours.
struct PeakParams {
  int bins;             // n_fft / 2 + 1, the row length
  int first;            // the band's first neighbour bin (`beginning`)
  int rows;             // band rows
  int n_bins;           // tuning bins, 1 / resolution
  float hz_per_bin;     // sample rate / n_fft
  float per_octave;     // bins per octave
  float inv_resolution; // f32(1 / f32(resolution))
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// The order-isomorphic signed key of an f32 (ops/reductions.py:
// _float_sort_key): non-negative floats keep their bits, negative ones flip
// every bit but the sign.
__device__ __forceinline__ int sort_key(float x) {
  const int i = __float_as_int(x);
  return i < 0 ? i ^ 0x7FFFFFFF : i;
}

// The float of an unsigned key (the signed key with its top bit flipped).
__device__ __forceinline__ float key_float(unsigned int u) {
  const int s = static_cast<int>(u ^ 0x80000000u);
  return __int_as_float(s < 0 ? s ^ 0x7FFFFFFF : s);
}

// Band row i (ops/tuning_kernels.py:pip_stencil): whether it is a peak with a
// positive pitch, and then its magnitude and pitch. `band` holds spectrum
// bins first .. first + rows + 1.
__device__ __forceinline__ bool band_peak(const float* band, int i, float ref,
                                          const PeakParams& p, float& mag,
                                          float& pitch) {
  const float before = band[i];
  const float elem = band[i + 1];
  const float after = band[i + 2];
  if (!(elem > ref && after <= elem && before < elem)) return false;
  const float avg = __fmul_rn(0.5f, __fsub_rn(after, before));
  float den = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, elem), after), before);
  if (fabsf(den) < 1.17549435e-38f) den = __fadd_rn(den, 1.0f);
  const float shift = __fdiv_rn(avg, den);
  const float row = static_cast<float>(p.first + 1 + i);
  pitch = __fmul_rn(__fadd_rn(row, shift), p.hz_per_bin);
  mag = __fadd_rn(elem, __fmul_rn(__fmul_rn(0.5f, avg), shift));
  return pitch > 0.0f;
}

// The tuning bin of a pitch (ops/tuning_kernels.py:tuning_bins): its deviation
// from the equal-tempered grid, in [0, n_bins).
__device__ __forceinline__ int tuning_bin(float pitch, const PeakParams& p) {
  const float f = pitch < 1.17549435e-38f ? 1.17549435e-38f : pitch;
  const float octs = log2f(__fdiv_rn(f, 27.5f));  // A440 / 16
  float v = fmodf(__fmul_rn(p.per_octave, octs), 1.0f);
  if (v != 0.0f && v < 0.0f) v = __fadd_rn(v, 1.0f);
  if (v >= 0.5f) v = __fsub_rn(v, 1.0f);
  const int idx = static_cast<int>(__fmul_rn(__fadd_rn(v, 0.5f), p.inv_resolution));
  return min(max(idx, 0), p.n_bins - 1);
}

// One frame a warp. spec: [B, F, bins] f32; frame_mask: [B, F] bool;
// keys/bins: [B, cap]; count: [B], zeroed by the caller.
__global__ void __launch_bounds__(kPeakWarps * 32)
tuning_peaks_kernel(const float* __restrict__ spec,
                    const unsigned char* __restrict__ frame_mask,
                    long long n_frames, int frames, PeakParams p, long long cap,
                    int* __restrict__ keys, unsigned char* __restrict__ bins,
                    int* __restrict__ count) {
  extern __shared__ float staged[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long g = static_cast<long long>(blockIdx.x) * kPeakWarps + warp;
  if (g >= n_frames || !frame_mask[g]) return;  // warp-uniform
  const int width = p.rows + 2;
  float* band = staged + warp * width;
  const float* row = spec + g * p.bins;

  // the row's max over every bin, staging the band on the way
  float m = -INFINITY;
  const int lo = p.first;
  auto take = [&](int j, float v) {
    m = nan_max(m, v);
    if (j >= lo && j < lo + width) band[j - lo] = v;
  };
  int lead = static_cast<int>(
      ((16 - (reinterpret_cast<unsigned long long>(row) & 15)) & 15) >> 2);
  if (lead > p.bins) lead = p.bins;
  const int n_vec = (p.bins - lead) >> 2;
  if (lane < lead) take(lane, __ldg(row + lane));
  for (int j = lead + 4 * n_vec + lane; j < p.bins; j += 32) take(j, __ldg(row + j));
  const float4* vec = reinterpret_cast<const float4*>(row + lead);
#pragma unroll 4
  for (int c = lane; c < n_vec; c += 32) {
    const float4 q = __ldg(vec + c);
    const int j = lead + 4 * c;
    take(j, q.x);
    take(j + 1, q.y);
    take(j + 2, q.z);
    take(j + 3, q.w);
  }
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(kFull, m, o));
  __syncwarp();
  const float ref = __fmul_rn(m, 0.1f);

  // count the frame's peaks, then take their place in the song's list
  int found = 0;
  for (int i = lane; i < p.rows; i += 32) {
    float mag, pitch;
    found += band_peak(band, i, ref, p, mag, pitch) ? 1 : 0;
  }
  for (int o = 16; o > 0; o >>= 1) found += __shfl_xor_sync(kFull, found, o);
  if (found == 0) return;
  const int song = static_cast<int>(g / frames);
  int base = 0;
  if (lane == 0) base = atomicAdd(count + song, found);
  base = __shfl_sync(kFull, base, 0);
  int* key_out = keys + static_cast<long long>(song) * cap;
  unsigned char* bin_out = bins + static_cast<long long>(song) * cap;
  const unsigned int below_me = (1u << lane) - 1u;
  for (int i0 = 0; i0 < p.rows; i0 += 32) {
    const int i = i0 + lane;
    float mag = 0.0f, pitch = 0.0f;
    const bool hit = i < p.rows && band_peak(band, i, ref, p, mag, pitch);
    const unsigned int ballot = __ballot_sync(kFull, hit);
    if (hit) {
      const long long at = base + __popc(ballot & below_me);
      key_out[at] = sort_key(mag);
      bin_out[at] = static_cast<unsigned char>(tuning_bin(pitch, p));
    }
    base += __popc(ballot);
  }
}

struct SelectShared {
  unsigned int hist[2][256];
  unsigned int counts[kMaxTuningBins];
  unsigned int warp_tot[16];
  unsigned int digit[2];
  unsigned int below[2];
  unsigned int min_c;
  int tk;
};

// Counts `bucket` into h where `on` holds, the lanes of one bucket adding
// once. Called by every lane of the warp.
__device__ __forceinline__ void count_in(unsigned int* h, unsigned int bucket,
                                         bool on) {
  const unsigned int active = __ballot_sync(kFull, on);
  if (!on) return;
  const unsigned int peers = __match_any_sync(active, bucket);
  if ((threadIdx.x & 31) == static_cast<unsigned int>(__ffs(peers) - 1)) {
    atomicAdd(&h[bucket], static_cast<unsigned int>(__popc(peers)));
  }
}

// Visits every entry of a song's list, kWalkBatch loads in flight a thread:
// visit(in, u, bin) with the unsigned key u (the signed key with its top bit
// flipped) and, with kBins, the entry's bin. The trip count is the block's,
// so every lane reaches count_in.
constexpr int kWalkBatch = 4;

template <bool kBins, class Visit>
__device__ __forceinline__ void walk(const int* key, const unsigned char* bin,
                                     long long n, Visit visit) {
  for (long long base = 0; base < n; base += kWalkBatch * blockDim.x) {
    unsigned int u[kWalkBatch], b[kWalkBatch];
#pragma unroll
    for (int j = 0; j < kWalkBatch; ++j) {
      const long long i = base + j * blockDim.x + threadIdx.x;
      u[j] = i < n ? static_cast<unsigned int>(__ldg(key + i)) ^ 0x80000000u : 0u;
      b[j] = (kBins && i < n) ? bin[i] : 0u;
    }
#pragma unroll
    for (int j = 0; j < kWalkBatch; ++j) {
      visit(base + j * blockDim.x + threadIdx.x < n, u[j], b[j]);
    }
  }
}

// For each rank r, the digit d of histogram hist[shared ? 0 : r] with
// count(< d) <= k[r] < count(<= d), into s.digit[r] and count(< d) into
// s.below[r]; d = 256 and below = the total when k[r] >= the total. Threads
// 256 r .. 256 r + 255 scan rank r. Called by the whole block.
__device__ void pick_digits(SelectShared& s, bool shared, const unsigned int k[2]) {
  const int t = threadIdx.x;
  const int r = t >> 8;
  const int v = t & 255;
  unsigned int c = 0, incl = 0;
  if (t < 512) {
    c = s.hist[shared ? 0 : r][v];
    incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned int y = __shfl_up_sync(kFull, incl, o);
      if ((t & 31) >= o) incl += y;
    }
    if ((t & 31) == 31) s.warp_tot[t >> 5] = incl;
  }
  if (t < 2) s.digit[t] = 256;
  __syncthreads();
  if (t < 512) {
    for (int w = 8 * r; w < (t >> 5); ++w) incl += s.warp_tot[w];
    const unsigned int kr = k[r];
    if (incl - c <= kr && kr < incl) {
      s.digit[r] = v;
      s.below[r] = incl - c;
    }
    if (v == 255 && incl <= kr) s.below[r] = incl;
  }
  __syncthreads();
}

// The 16-bit half `level` of an unsigned key (0: high, 1: low) and whether
// it is counted: level 0 every key whose high half is not 0xFFFF, level 1
// the keys of high half b_f whose low half is not 0xFFFF (the sentinels of
// the i16 planes of the TPU contract).
__device__ __forceinline__ bool half_of(unsigned int u, int level,
                                        unsigned int b_f, unsigned int& v) {
  const unsigned int hi = u >> 16;
  if (level == 0) {
    v = hi;
    return hi != 0xFFFFu;
  }
  v = u & 0xFFFFu;
  return hi == b_f && v != 0xFFFFu;
}

// bisect16_pair's contract over the list for ranks k: per rank the bucket
// (the k-th smallest counted half, 0xFFFF when k >= the count) and the count
// below it. Level 1 also takes min_c, the least low half of the keys of
// high half b_c (0xFFFF when none). Two passes over the list.
__device__ void select16(SelectShared& s, const int* key, long long n, int level,
                         unsigned int b_f, unsigned int b_c,
                         const unsigned int k[2], unsigned int bucket[2],
                         unsigned int below[2]) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  for (int i = t; i < 512; i += blockDim.x) (&s.hist[0][0])[i] = 0;
  if (t == 0) s.min_c = 0xFFFFu;
  __syncthreads();
  // the half's high byte: one histogram for both ranks
  walk<false>(key, nullptr, n, [&](bool in, unsigned int u, unsigned int) {
    unsigned int v = 0;
    const bool on = in && half_of(u, level, b_f, v);
    count_in(s.hist[0], v >> 8, on);
    if (level == 1) {
      const unsigned int lo_c = (in && (u >> 16) == b_c) ? (u & 0xFFFFu) : 0xFFFFu;
      const unsigned int least = __reduce_min_sync(kFull, lo_c);
      if (lane == 0 && least != 0xFFFFu) atomicMin(&s.min_c, least);
    }
  });
  __syncthreads();
  pick_digits(s, true, k);
  unsigned int hi_digit[2], hi_below[2], rest[2];
  for (int r = 0; r < 2; ++r) {
    hi_digit[r] = s.digit[r];
    hi_below[r] = s.below[r];
    rest[r] = hi_digit[r] < 256 ? k[r] - hi_below[r] : 0u;
  }
  for (int i = t; i < 512; i += blockDim.x) (&s.hist[0][0])[i] = 0;
  __syncthreads();
  // the half's low byte, per rank among the halves of its high byte
  walk<false>(key, nullptr, n, [&](bool in, unsigned int u, unsigned int) {
    unsigned int v = 0;
    const bool on = in && half_of(u, level, b_f, v);
    count_in(s.hist[0], v & 0xFFu, on && (v >> 8) == hi_digit[0]);
    count_in(s.hist[1], v & 0xFFu, on && (v >> 8) == hi_digit[1]);
  });
  __syncthreads();
  pick_digits(s, false, rest);
  for (int r = 0; r < 2; ++r) {
    if (hi_digit[r] == 256) {
      bucket[r] = 0xFFFFu;
      below[r] = hi_below[r];
    } else {
      bucket[r] = (hi_digit[r] << 8) | s.digit[r];
      below[r] = hi_below[r] + s.below[r];
    }
  }
  __syncthreads();
}

// One block a song over its list. keys/bins: [B, cap]; count: [B];
// counts: [B, n_bins]; o1, o2: [B, 4]; min_c, tk: [B]; all i32.
__global__ void __launch_bounds__(kSelectThreads)
tuning_select_kernel(const int* __restrict__ keys,
                     const unsigned char* __restrict__ bins,
                     const int* __restrict__ count, long long cap, int n_bins,
                     int* __restrict__ counts, int* __restrict__ o1,
                     int* __restrict__ o2, int* __restrict__ min_c,
                     int* __restrict__ tk) {
  __shared__ SelectShared s;
  const int song = blockIdx.x;
  const int t = threadIdx.x;
  const int* key = keys + static_cast<long long>(song) * cap;
  const unsigned char* bin = bins + static_cast<long long>(song) * cap;
  const long long n = count[song];
  // the midpoint median's ranks (exact: n < 2^24)
  const unsigned int k[2] = {n > 0 ? static_cast<unsigned int>((n - 1) / 2) : 0u,
                             static_cast<unsigned int>(n / 2)};
  unsigned int b1[2], below1[2];
  select16(s, key, n, 0, 0u, 0u, k, b1, below1);
  const unsigned int rem[2] = {k[0] > below1[0] ? k[0] - below1[0] : 0u,
                               k[1] > below1[1] ? k[1] - below1[1] : 0u};
  unsigned int b2[2], below2[2];
  select16(s, key, n, 1, b1[0], b1[1], rem, b2, below2);
  const unsigned int least_c = s.min_c;

  if (t == 0) {
    const unsigned int lo_c = b1[0] == b1[1] ? b2[1] : least_c;
    const float x = __fmul_rn(__fadd_rn(key_float((b1[0] << 16) | b2[0]),
                                        key_float((b1[1] << 16) | lo_c)),
                              0.5f);
    s.tk = x == 0.0f ? -1 : sort_key(x);
    o1[4 * song] = static_cast<int>(b1[0]);
    o1[4 * song + 1] = static_cast<int>(b1[1]);
    o1[4 * song + 2] = static_cast<int>(below1[0]);
    o1[4 * song + 3] = static_cast<int>(below1[1]);
    o2[4 * song] = static_cast<int>(b2[0]);
    o2[4 * song + 1] = static_cast<int>(b2[1]);
    o2[4 * song + 2] = static_cast<int>(below2[0]);
    o2[4 * song + 3] = static_cast<int>(below2[1]);
    min_c[song] = static_cast<int>(least_c);
  }
  for (int i = t; i < kMaxTuningBins; i += blockDim.x) s.counts[i] = 0;
  __syncthreads();
  const int thr = s.tk;
  if (t == 0) tk[song] = thr;
  // the tuning bins of the keys at or above the median's key
  walk<true>(key, bin, n, [&](bool in, unsigned int u, unsigned int b) {
    const int signed_key = static_cast<int>(u ^ 0x80000000u);
    count_in(s.counts, b, in && signed_key >= thr && b < static_cast<unsigned int>(n_bins));
  });
  __syncthreads();
  for (int i = t; i < n_bins; i += blockDim.x) {
    counts[static_cast<long long>(song) * n_bins + i] = static_cast<int>(s.counts[i]);
  }
}

// ---- the byte-radix counting pass, a template on its loader ---------------
//
// A loader names the byte stream [B, n] the pass walks (`stream`), says
// whether a 4-byte word of it holds only excluded elements (`empty`), and
// counts one element (`visit`) into `kRanks` 256-bucket histograms; with
// `kCountsValid` the pass also counts the valid elements into one more slot.

// The int8 plane of one key byte per element, offset by -128; 127 is excluded.
struct PlaneLoader {
  static constexpr int kRanks = 1;
  static constexpr bool kCountsValid = false;
  const unsigned char* stream;

  __device__ void bind(int, long long) {}
  __device__ static bool empty(unsigned int w) { return w == 0x7F7F7F7Fu; }
  __device__ void visit(unsigned int byte, long long, unsigned int* counts,
                        unsigned int&) const {
    const unsigned int u = byte ^ 0x80u;  // the int8 value + 128
    if (u != 255u) atomicAdd(&counts[u], 1u);
  }
};

// The bool mask and, where it holds, the f32 value: the sort key's byte at
// `level`, counted for each rank whose prefix equals the key's higher bytes.
// state: [B, 5] i64 = [prefix_floor, prefix_ceil, rank_floor, rank_ceil, n].
struct KeyLoader {
  static constexpr int kRanks = 2;
  static constexpr bool kCountsValid = true;
  const unsigned char* stream;  // the mask
  const float* values;
  const long long* state;
  int level;
  // bound to one song
  const float* v;
  unsigned int prefix[2];

  __device__ void bind(int song, long long n) {
    v = values + static_cast<long long>(song) * n;
    for (int r = 0; r < 2; ++r) {
      prefix[r] = level ? static_cast<unsigned int>(state[5 * song + r]) : 0u;
    }
  }
  __device__ static bool empty(unsigned int w) { return w == 0u; }
  __device__ void visit(unsigned int byte, long long i, unsigned int* counts,
                        unsigned int& valid) const {
    if (byte == 0u) return;
    ++valid;
    const int bits = __float_as_int(v[i]);
    // order-isomorphic u32 key: negative floats flip every bit, the others
    // the sign bit
    const unsigned int u = bits < 0 ? ~static_cast<unsigned int>(bits)
                                    : static_cast<unsigned int>(bits) ^ 0x80000000u;
    const int shift = 24 - 8 * level;
    const unsigned int b = (u >> shift) & 0xFFu;
    if (b == 0xFFu) return;
    if (level == 0) {  // no prefix yet: one histogram serves both ranks
      atomicAdd(&counts[b], 1u);
      return;
    }
    const unsigned int hi = u >> (shift + 8);
    if (hi == prefix[0]) atomicAdd(&counts[b], 1u);
    if (hi == prefix[1]) atomicAdd(&counts[256 + b], 1u);
  }
};

// hist: [B, hist_stride] u32, zeroed by the caller: kRanks x 256 buckets,
// then (kCountsValid) the count of valid elements.
template <class Loader>
__global__ void __launch_bounds__(kHistThreads)
count8_kernel(Loader loader, long long n, unsigned int* __restrict__ hist,
              int hist_stride) {
  constexpr int kSlots = Loader::kRanks * 256 + (Loader::kCountsValid ? 1 : 0);
  __shared__ unsigned int counts[kSlots];
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x) counts[i] = 0;
  __syncthreads();

  const int song = blockIdx.y;
  Loader ld = loader;
  ld.bind(song, n);
  const unsigned char* bytes = ld.stream + static_cast<long long>(song) * n;
  // bytes before the first 16-byte boundary, whole vectors, bytes after
  long long lead = (16 - (reinterpret_cast<unsigned long long>(bytes) & 15)) & 15;
  if (lead > n) lead = n;
  const long long n_vec = (n - lead) >> 4;
  const uint4* vec = reinterpret_cast<const uint4*>(bytes + lead);
  unsigned int valid = 0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < n_vec; c += step) {
    const uint4 q = __ldg(vec + c);
    const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (Loader::empty(w[j])) continue;
      const long long at = lead + (c << 4) + 4 * j;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ld.visit((w[j] >> (8 * k)) & 0xFFu, at + k, counts, valid);
      }
    }
  }
  if (blockIdx.x == 0) {
    for (long long i = threadIdx.x; i < lead; i += blockDim.x) {
      ld.visit(bytes[i], i, counts, valid);
    }
    for (long long i = lead + (n_vec << 4) + threadIdx.x; i < n;
         i += blockDim.x) {
      ld.visit(bytes[i], i, counts, valid);
    }
  }
  if (Loader::kCountsValid) {
    for (int o = 16; o > 0; o >>= 1) {
      valid += __shfl_xor_sync(0xffffffffu, valid, o);
    }
    if ((threadIdx.x & 31) == 0 && valid != 0) {
      atomicAdd(&counts[kSlots - 1], valid);
    }
  }
  __syncthreads();
  unsigned int* h = hist + static_cast<long long>(song) * hist_stride;
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x) {
    if (counts[i] != 0) atomicAdd(&h[i], counts[i]);
  }
}

// One 256-thread block per song: thread v holds count(v); an inclusive scan
// gives count(<= v); the bucket is the first v <= 0xFE reaching k + 1.
__global__ void __launch_bounds__(256)
select8_kernel(const unsigned int* __restrict__ hist,
               const int* __restrict__ ks, int* __restrict__ out) {
  __shared__ unsigned long long warp_tot[8];
  __shared__ int bucket;
  const int v = threadIdx.x;
  const int lane = v & 31;
  const int warp = v >> 5;
  const unsigned long long c = hist[static_cast<long long>(blockIdx.x) * 256 + v];
  unsigned long long incl = c;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  if (v == 0) bucket = 255;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += warp_tot[w];
  const unsigned long long target =
      static_cast<unsigned long long>(ks[blockIdx.x]) + 1ull;
  // count(<= v) grows with v, so the first v reaching the target is unique
  if (v < 255 && incl >= target && incl - c < target) bucket = v;
  __syncthreads();
  // below = count(<= bucket - 1), held by thread bucket - 1
  if (bucket == 0 && v == 0) out[2 * blockIdx.x + 1] = 0;
  if (v == bucket - 1) out[2 * blockIdx.x + 1] = static_cast<int>(incl);
  if (v == 0) out[2 * blockIdx.x] = bucket;
}

constexpr int kKeyHistStride = 513;  // 2 x 256 buckets, then the valid count

// The scan of bisect8_keys: one block per song, 256 threads per rank (floor,
// then ceil). At level 0 the ranks come from the valid count n the pass just
// made, k = floor / ceil((n - 1) * q) in f32, and both read the one histogram;
// deeper levels read their own histogram and the rank the state carries.
// Writes out[song] = [[bucket_f, below_f], [bucket_c, below_c]] and advances
// the state: prefix = prefix << 8 | bucket, rank -= below, n. After level 3
// the prefixes are the two keys: `median` (when given) receives the midpoint
// of their floats, (lo + hi) * 0.5 in f32, +inf for a song with no valid
// element.
__global__ void __launch_bounds__(512)
select8_pair_kernel(const unsigned int* __restrict__ hist, int level, float q,
                    long long* __restrict__ state, int* __restrict__ out,
                    float* __restrict__ median) {
  __shared__ unsigned long long warp_tot[16];
  __shared__ int bucket[2];
  __shared__ int below[2];
  __shared__ unsigned int key[2];
  const int song = blockIdx.x;
  const int r = threadIdx.x >> 8;
  const int v = threadIdx.x & 255;
  const int lane = v & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned int* h = hist + static_cast<long long>(song) * kKeyHistStride;
  const long long n_valid = h[512];
  long long k;
  if (level == 0) {
    const float pos = static_cast<float>(static_cast<int>(n_valid) - 1) * q;
    const int ki = static_cast<int>(r == 0 ? floorf(pos) : ceilf(pos));
    k = ki < 0 ? 0 : ki;
  } else {
    k = state[5 * song + 2 + r];
  }
  const unsigned long long c = h[(level == 0 ? 0 : r) * 256 + v];
  unsigned long long incl = c;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  if (v == 0) {
    bucket[r] = 255;
    below[r] = 0;
  }
  __syncthreads();
  for (int w = 8 * r; w < warp; ++w) incl += warp_tot[w];
  const unsigned long long target = static_cast<unsigned long long>(k) + 1ull;
  if (v < 255 && incl >= target && incl - c < target) bucket[r] = v;
  __syncthreads();
  if (v == bucket[r] - 1) below[r] = static_cast<int>(incl);
  __syncthreads();
  if (v == 0) {
    out[4 * song + 2 * r] = bucket[r];
    out[4 * song + 2 * r + 1] = below[r];
    const long long prefix = level ? state[5 * song + r] : 0ll;
    state[5 * song + r] = (prefix << 8) | bucket[r];
    state[5 * song + 2 + r] = k - below[r];
    if (r == 0) state[5 * song + 4] = n_valid;
    key[r] = static_cast<unsigned int>((prefix << 8) | bucket[r]);
  }
  if (level != 3 || median == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    float f[2];
    for (int i = 0; i < 2; ++i) {
      // the inverse of the key transform
      const unsigned int u = key[i];
      f[i] = __uint_as_float((u & 0x80000000u) ? u ^ 0x80000000u : ~u);
    }
    median[song] = n_valid > 0 ? (f[0] + f[1]) * 0.5f : __int_as_float(0x7f800000);
  }
}

__global__ void __launch_bounds__(kHistThreads)
hist_int_kernel(const int* __restrict__ idx, long long n, int n_bins,
                int* __restrict__ out) {
  __shared__ int counts[128];
  for (int i = threadIdx.x; i < 128; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  const int* p = idx + static_cast<long long>(blockIdx.y) * n;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const int v = p[i];
    if (v >= 0 && v < n_bins) atomicAdd(&counts[v], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    if (counts[i] != 0) {
      atomicAdd(&out[static_cast<long long>(blockIdx.y) * n_bins + i],
                counts[i]);
    }
  }
}

int grid_for(long long n) {
  const long long per_block = static_cast<long long>(kHistThreads) * 16;
  long long g = (n + per_block - 1) / per_block;
  if (g < 1) g = 1;
  if (g > 1024) g = 1024;
  return static_cast<int>(g);
}

// Blocks per song of the byte-radix counting pass: 16 bytes a thread, four
// rounds a block.
int count_grid(long long n) {
  const long long per_block = static_cast<long long>(kHistThreads) * 16 * 4;
  long long g = (n + per_block - 1) / per_block;
  if (g < 1) g = 1;
  if (g > 1024) g = 1024;
  return static_cast<int>(g);
}

}  // namespace

// spec: [batch, frames, bins] f32 (the frame-major spectrum); frame_mask:
// [batch, frames] bool; keys: [batch, cap] i32 and bin_out: [batch, cap] u8,
// each song's peaks first; count: [batch] i32, the peaks of each song.
// cap >= frames * ceil(rows / 2) (see tuning_peaks_kernel).
extern "C" int tuning_peaks_launch(const float* spec,
                                   const unsigned char* frame_mask, int batch,
                                   int frames, int bins, int first, int rows,
                                   int n_bins, float hz_per_bin,
                                   float per_octave, float inv_resolution,
                                   long long cap, int* keys,
                                   unsigned char* bin_out, int* count,
                                   cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (first < 0 || rows < 1 || first + rows + 2 > bins || n_bins < 1 ||
      n_bins > kMaxTuningBins ||
      cap < static_cast<long long>(frames) * ((rows + 1) / 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * batch, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_frames = static_cast<long long>(batch) * frames;
  if (n_frames == 0) return 0;
  const size_t smem = sizeof(float) * kPeakWarps * (rows + 2);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(tuning_peaks_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const PeakParams p{bins, first, rows, n_bins, hz_per_bin, per_octave,
                     inv_resolution};
  const long long grid = (n_frames + kPeakWarps - 1) / kPeakWarps;
  tuning_peaks_kernel<<<static_cast<unsigned int>(grid), kPeakWarps * 32, smem,
                        stream>>>(spec, frame_mask, n_frames, frames, p, cap,
                                  keys, bin_out, count);
  return static_cast<int>(cudaGetLastError());
}

// keys, bins, count: tuning_peaks' list; counts: [batch, n_bins] i32;
// o1, o2: [batch, 4] i32; min_c, tk: [batch] i32.
extern "C" int tuning_select_launch(const int* keys, const unsigned char* bins,
                                    const int* count, int batch, long long cap,
                                    int n_bins, int* counts, int* o1, int* o2,
                                    int* min_c, int* tk, cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (n_bins < 1 || n_bins > kMaxTuningBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tuning_select_kernel<<<batch, kSelectThreads, 0, stream>>>(
      keys, bins, count, cap, n_bins, counts, o1, o2, min_c, tk);
  return static_cast<int>(cudaGetLastError());
}

// hist: [batch, 256] u32, zeroed by the caller; ks: [batch];
// out: [batch, 2] = [bucket, below].
extern "C" int bisect8_launch(const signed char* plane, int batch, long long n,
                              const int* ks, unsigned int* hist, int* out,
                              cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (n > 0) {
    const PlaneLoader loader{reinterpret_cast<const unsigned char*>(plane)};
    count8_kernel<PlaneLoader>
        <<<dim3(count_grid(n), batch), kHistThreads, 0, stream>>>(loader, n,
                                                                  hist, 256);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  select8_kernel<<<batch, 256, 0, stream>>>(hist, ks, out);
  return static_cast<int>(cudaGetLastError());
}

// One level (0-3) of the radix select over values [batch, n] f32 where
// mask [batch, n] (bool bytes) holds, for both ranks of the midpoint quantile
// q. state: [batch, 5] i64 (see KeyLoader), read above level 0 and advanced;
// hist: [batch, 513] u32, zeroed by the caller; out: [batch, 2, 2] i32 =
// per rank [bucket, below]; median: [batch] f32 or null, written at level 3.
extern "C" int bisect8_keys_launch(const float* values,
                                   const unsigned char* mask, int batch,
                                   long long n, int level, float q,
                                   long long* state, unsigned int* hist,
                                   int* out, float* median,
                                   cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (level < 0 || level > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    KeyLoader loader{mask, values, state, level, nullptr, {0u, 0u}};
    count8_kernel<KeyLoader>
        <<<dim3(count_grid(n), batch), kHistThreads, 0, stream>>>(
            loader, n, hist, kKeyHistStride);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  select8_pair_kernel<<<batch, 512, 0, stream>>>(hist, level, q, state, out,
                                                 median);
  return static_cast<int>(cudaGetLastError());
}

// out: [batch, n_bins] i32, zeroed by the caller.
extern "C" int hist_int_launch(const int* idx, int batch, long long n,
                               int n_bins, int* out, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n_bins > 128) return static_cast<int>(cudaErrorInvalidValue);
  hist_int_kernel<<<dim3(grid_for(n), batch), kHistThreads, 0, stream>>>(
      idx, n, n_bins, out);
  return static_cast<int>(cudaGetLastError());
}
