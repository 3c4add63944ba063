// The five per-frame timbral reductions over aubio's buggy 256-slot layout
// (bins 0..254, then the Nyquist bin in slot 255, src/aubio.rs:237-261),
// formed by one warp from a frame's magnitudes in registers: lane q holds
// slot q + 32 r in register r. Both timbral kernels end in it:
// timbral_fft.cu where its warp FFT leaves the magnitudes, timbral_flat.cu
// after reading a frame's row of magnitudes from shared memory.
#pragma once

#include "fft_common.cuh"

namespace bliss {

// Writes [total, weighted-by-slot, below (rolloff count), log2 sum, energy]
// of the warp's frame to `o` (from lane 0). Every lane of the warp calls it.
// Total, weighted and log2 sum are warp sums; the rolloff prefix sum is
// eight 32-slot warp scans taken left to right with a carry, so the last
// slot's running sum equals `energy` exactly, as a cumsum's would, and the
// slots under 95% of it are counted by ballot.
__device__ __forceinline__ void warp_timbral_row(const float (&mag)[8], int lane,
                                                 float* o) {
  constexpr unsigned kFull = 0xffffffffu;
  float total = 0.0f, weighted = 0.0f, logsum = 0.0f;
  float cum[8];
  float energy = 0.0f;  // the sum of the chunks before this one, then of all
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float m = mag[r];
    total += m;
    weighted += m * static_cast<float>(lane + 32 * r);
    logsum += log2f(m);
    float c = m * m;  // inclusive scan of chunk r (slots 32 r .. 32 r + 31)
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float y = __shfl_up_sync(kFull, c, s);
      if (lane >= s) c += y;
    }
    cum[r] = c + energy;
    energy += __shfl_sync(kFull, c, 31);
  }
  const float target = energy * 0.95f;
  int below = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) below += __popc(__ballot_sync(kFull, cum[r] < target));
  total = warp_sum(total);
  weighted = warp_sum(weighted);
  logsum = warp_sum(logsum);
  if (lane == 0) {
    o[0] = total;
    o[1] = weighted;
    o[2] = static_cast<float>(below);
    o[3] = logsum;
    o[4] = energy;
  }
}

}  // namespace bliss
