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
// 3. bisect8 replaces bliss_tpu/ops/pallas_select.py:39 _make_bisect8_kernel
//    (via _bisect8 and masked_quantile_midpoint_radix). Over an int8 plane of
//    one key byte per element (u8 offset by -128; sentinel 127 = byte 0xFF
//    for excluded elements) it finds the bucket b = the smallest v <= 0xFE
//    with count(<= v) >= k + 1, else 0xFF, and below = count(<= b - 1). A
//    valid byte 0xFF shares its value with the sentinel; like the TPU
//    kernel, the count never includes v = 0xFF, so such an element is
//    reached as the 0xFF fallback and never counted in `below`. The TPU's
//    eight bisection passes over a VMEM plane become one counting pass: a
//    256-bucket per-song histogram in shared memory, then a one-block scan.
// 4. hist_int replaces bliss_tpu/ops/pallas_hist.py:45 _make_kernel (via
//    histogram_int_plane): counts of idx == v for v in [0, n_bins) over an
//    int32 plane; other values (the caller's sentinel n_bins) are ignored.
//    Per-block shared-memory counters, one global atomic per nonzero counter.
//
// All four count exact integers, so the order of the atomics does not matter.
//
// Bound on the card: bytes. Each plane is read once (2 bytes per element for
// bisect16_pair, 1 + 4 for the threshold histogram, 1 for bisect8, 4 for
// hist_int); the skey read is skipped for excluded elements. The 65,536-bucket
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

__global__ void __launch_bounds__(kHistThreads)
hist8_kernel(const signed char* __restrict__ plane, long long n,
             unsigned int* __restrict__ hist) {
  __shared__ unsigned int counts[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  const signed char* p = plane + static_cast<long long>(blockIdx.y) * n;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const int u = static_cast<int>(p[i]) + 128;
    if (u != 255) atomicAdd(&counts[u], 1u);
  }
  __syncthreads();
  unsigned int* h = hist + static_cast<long long>(blockIdx.y) * 256;
  for (int i = threadIdx.x; i < 255; i += blockDim.x) {
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
    hist8_kernel<<<dim3(grid_for(n), batch), kHistThreads, 0, stream>>>(
        plane, n, hist);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  select8_kernel<<<batch, 256, 0, stream>>>(hist, ks, out);
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
