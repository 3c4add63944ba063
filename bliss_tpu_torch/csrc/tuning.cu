// Exact integer passes of the fused tuning estimator (models/chroma.py
// `_estimate_tuning_fused`, src/chroma.rs:334-391).
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
// Both are exact integers, so the order of the atomics does not matter.
//
// Bound on the card: bytes. Each plane is read once (2 bytes per element for
// the select, 1 + 4 for the threshold histogram); the skey read is skipped
// for excluded elements. The 65,536-bucket histogram (256 KB per song) stays
// in L2; excluded elements (most of the plane) never touch it.
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
