// Exact integer passes of the tuning estimator (models/chroma.py,
// src/chroma.rs:334-391): the fused route (1, 2) for buckets whose tuning
// plane fits the reference's budget, the unfused route (3, 4) above it.
//
// 1. bisect16_pair replaces bliss_tpu/ops/pallas_select.py:
//    _make_bisect16_pair_kernel (via bisect16_pair). Over an i16 plane
//    (u16 key halves offset by -32768; u16 0xFFFF marks an excluded element)
//    it finds, for the floor and ceil ranks k of the midpoint median, the
//    bucket b = the smallest u16 value v <= 0xFFFE with count(<= v) >= k + 1
//    (0xFFFF when none), and below = count(<= b - 1). That is exactly what
//    the TPU kernel's 16-step bisection converges to, computed here as an
//    exact counting select: a 65,536-bucket per-song histogram built with
//    integer atomics, then a one-block prefix scan that finds each rank's
//    bucket and the count below it.
// 2. hist_threshold replaces bliss_tpu/ops/pallas_hist.py:
//    _make_threshold_kernel (via histogram_threshold_plane): 100-bin counts
//    of an i8 tuning-bin plane where the i32 magnitude key is >= tk.
//    Per-block shared-memory counters, then integer atomics into the output.
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
// Bound on the card: bytes. Each plane is read once (2 bytes per element for
// bisect16_pair, 1 + 4 for the threshold histogram, 1 for bisect8, 1 of mask
// plus 4 per valid element for bisect8_keys, 4 for hist_int); the skey and
// value reads are skipped for excluded elements. The byte streams of bisect8
// and bisect8_keys are read as aligned 16-byte vectors, and a vector that
// holds only excluded elements costs one compare. The 65,536-bucket
// histogram (256 KB per song) stays in L2; the 256-bucket and 128-counter
// histograms stay in shared memory. Excluded elements (most of every plane:
// ~0.5% of the tuning band are peaks) skip every atomic.
#include <cuda_runtime.h>

namespace {

constexpr int kBuckets = 65536;
constexpr int kScanThreads = 1024;
constexpr int kPerThread = kBuckets / kScanThreads;  // 64
constexpr int kHistThreads = 256;

__global__ void __launch_bounds__(kHistThreads)
hist16_kernel(const short* __restrict__ plane, long long n,
              unsigned int* __restrict__ hist) {
  const short* p = plane + static_cast<long long>(blockIdx.y) * n;
  unsigned int* h = hist + static_cast<long long>(blockIdx.y) * kBuckets;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const int u = static_cast<int>(p[i]) + 32768;
    if (u != kBuckets - 1) atomicAdd(&h[u], 1u);
  }
}

__global__ void __launch_bounds__(kScanThreads)
select16_pair_kernel(const unsigned int* __restrict__ hist,
                     const int* __restrict__ ks, int* __restrict__ out) {
  __shared__ unsigned long long warp_tot[kScanThreads / 32];
  __shared__ int bucket[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned int* h = hist + static_cast<long long>(blockIdx.x) * kBuckets;
  const int base = tid * kPerThread;

  unsigned long long local = 0;
  for (int i = 0; i < kPerThread; ++i) local += h[base + i];

  // exclusive block scan of the per-thread sums
  unsigned long long incl = local;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  if (tid < 2) bucket[tid] = kBuckets - 1;
  __syncthreads();
  unsigned long long before = 0;
  for (int w = 0; w < warp; ++w) before += warp_tot[w];
  const unsigned long long prefix = before + incl - local;

  for (int r = 0; r < 2; ++r) {
    const unsigned long long target =
        static_cast<unsigned long long>(ks[2 * blockIdx.x + r]) + 1ull;
    if (prefix < target && prefix + local >= target) {
      unsigned long long cum = prefix;
      for (int i = 0; i < kPerThread; ++i) {
        cum += h[base + i];
        if (cum >= target) {
          atomicMin(&bucket[r], base + i);
          break;
        }
      }
    }
  }
  __syncthreads();

  for (int r = 0; r < 2; ++r) {
    const int b = bucket[r];
    // below = count(<= b - 1), summed by the thread that owns bucket b - 1
    if (b == 0) {
      if (tid == 0) out[4 * blockIdx.x + 2 + r] = 0;
    } else if ((b - 1) / kPerThread == tid) {
      unsigned long long below = prefix;
      for (int i = base; i < b; ++i) below += h[i];
      out[4 * blockIdx.x + 2 + r] = static_cast<int>(below);
    }
    if (tid == 0) out[4 * blockIdx.x + r] = b;
  }
}

__global__ void __launch_bounds__(kHistThreads)
hist_threshold_kernel(const signed char* __restrict__ idx8,
                      const int* __restrict__ skey, const int* __restrict__ tk,
                      long long n, int n_bins, int* __restrict__ out) {
  __shared__ int counts[128];
  for (int i = threadIdx.x; i < 128; i += blockDim.x) counts[i] = 0;
  __syncthreads();

  const long long off = static_cast<long long>(blockIdx.y) * n;
  const int thr = tk[blockIdx.y];
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const int v = idx8[off + i];
    if (v >= 0 && v < n_bins && skey[off + i] >= thr) {
      atomicAdd(&counts[v], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    if (counts[i] != 0) {
      atomicAdd(&out[static_cast<long long>(blockIdx.y) * n_bins + i],
                counts[i]);
    }
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

// hist: [batch, 65536] u32, zeroed by the caller; ks: [batch, 2];
// out: [batch, 4] = [b_f, b_c, below_f, below_c].
extern "C" int bisect16_pair_launch(const short* plane, int batch, long long n,
                                    const int* ks, unsigned int* hist,
                                    int* out, cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (n > 0) {
    hist16_kernel<<<dim3(grid_for(n), batch), kHistThreads, 0, stream>>>(
        plane, n, hist);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  select16_pair_kernel<<<batch, kScanThreads, 0, stream>>>(hist, ks, out);
  return static_cast<int>(cudaGetLastError());
}

// out: [batch, n_bins] i32, zeroed by the caller; tk: [batch].
extern "C" int hist_threshold_launch(const signed char* idx8, const int* skey,
                                     const int* tk, int batch, long long n,
                                     int n_bins, int* out,
                                     cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n_bins > 128) return static_cast<int>(cudaErrorInvalidValue);
  hist_threshold_kernel<<<dim3(grid_for(n), batch), kHistThreads, 0, stream>>>(
      idx8, skey, tk, n, n_bins, out);
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
