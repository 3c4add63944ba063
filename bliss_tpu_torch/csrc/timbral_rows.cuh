// The five per-frame timbral reductions of frame_dft.cu's direct-DFT
// kernel (timbral_flat_kernel). One 256-thread block holds one frame: thread
// `tid` owns the magnitude of slot `tid` of aubio's buggy 256-bin layout
// (bins 0..254, then the Nyquist bin in slot 255, src/aubio.rs:237-261).
// timbral_fft.cu forms the same rows from a warp's registers, with the same
// 32-slot chunks scanned in the same order.
#pragma once

#include "fft_common.cuh"

namespace bliss {

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;

struct RowScratch {
  float part[3][kRowWarps];
  float warp_energy[kRowWarps];
};

// Writes [total, weighted-by-slot, below (rolloff count), log2 sum, energy]
// of the block's frame to `o` (skipped when `o` is null). Every thread of
// the 256-thread block must call this with its slot's magnitude; the rolloff
// prefix sum is a warp-shuffle scan, so nothing but the 5 floats touches
// device memory. The caller puts a __syncthreads() between two calls that
// share `sc` (thread 0 reads `sc` last).
__device__ __forceinline__ void timbral_row_store(float mag, RowScratch& sc,
                                                  float* o) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float sq = mag * mag;

  float cum = sq;  // inclusive scan within the warp
  for (int s = 1; s < 32; s <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, cum, s);
    if (lane >= s) cum += y;
  }
  const float s_total = warp_sum(mag);
  const float s_weighted = warp_sum(mag * static_cast<float>(tid));
  const float s_log = warp_sum(log2f(mag));
  if (lane == 31) sc.warp_energy[warp] = cum;
  if (lane == 0) {
    sc.part[0][warp] = s_total;
    sc.part[1][warp] = s_weighted;
    sc.part[2][warp] = s_log;
  }
  __syncthreads();

  // the same left-to-right order for the prefix and the total, so the
  // last slot's running sum equals `energy` exactly, as a cumsum's would
  float before = 0.0f;
  float energy = 0.0f;
  for (int w = 0; w < kRowWarps; ++w) {
    if (w == warp) before = energy;
    energy += sc.warp_energy[w];
  }
  cum += before;
  const float target = energy * 0.95f;
  const int below = __syncthreads_count(cum < target);

  if (tid == 0 && o != nullptr) {
    float total = 0.0f, weighted = 0.0f, logsum = 0.0f;
    for (int w = 0; w < kRowWarps; ++w) {
      total += sc.part[0][w];
      weighted += sc.part[1][w];
      logsum += sc.part[2][w];
    }
    o[0] = total;
    o[1] = weighted;
    o[2] = static_cast<float>(below);
    o[3] = logsum;
    o[4] = energy;
  }
}

}  // namespace bliss
