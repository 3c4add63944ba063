// Timbral rows of a direct (matrix-product) DFT, on the tensor cores.
//
// Replaces the TPU kernel bliss_tpu/ops/pallas_dft.py:80 _make_timbral_kernel
// (via pallas_frame_dft_timbral with the flat kernel selected). Frame f of
// song b is x[b, 128 f - 384 + n], n in [0, 512), zero outside [0, T), times
// the periodic Hann window (the product rounded in f32 first). Each
// 128-sample chunk c of a frame takes one K = 128 dot with [cos | -sin] at the
// integer phase (n*k) mod 512 over aubio's buggy 256-slot layout (slot 255
// carries the Nyquist bin, src/aubio.rs:237-261); the four chunk sums are
// combined with the reference's Neumaier step in chunk order 0, 1, 2, 3
// (pallas_dft.py:107-146), then come the magnitudes and the five per-frame
// rows [total, weighted-by-slot, below (rolloff count), log2 sum, energy].
//
// Bound on the card, timbral_flat: operations. As a direct DFT it does
// 512 x 512 x 2 operations a frame (240.5 GFLOP for 8 x 5-min songs) against
// 0.5 KB of signal in and 20 bytes out; in f32 on the CUDA cores that alone is
// 3.6 ms. The TPU kernel put the product on its matrix unit at
// Precision.HIGHEST; here it goes to the tensor cores with the same split:
// each operand as three bf16 pieces (hi, mid, lo, each rounded to nearest
// from the f32 residual of the ones before), six of the nine products kept
// (hh, hm, mh, hl, lh, mm; the dropped ones are ~2^-23 relative) and summed in
// f32 by wgmma. Six bf16 passes take 1.46 ms at the card's 989 TFLOP/s: the
// floor of this design.
//
// Accuracy: wgmma's f32 sum does not round to nearest. With the 48 wgmma
// of a chunk chained in one accumulator the totals sat ~2e-6 from the plain
// version's and the rows of 8 x 5-min noise songs 6.6e-7 from an f64 DFT
// (per-frame geometric mean, averaged over the frames, where the plain f32
// product reads 2.9e-8; H100). So each 32-deep k-stage starts a fresh
// accumulator, and the stage sums are added in f32 with rounding to
// nearest: 1.3e-7. That costs the N-tile of 64 columns (four accumulators
// and four running sums fit only at 32): one accumulator a chunk at
// m64n64 ran in 3.24 ms where this runs in 4.4. The limit that decides it
// is ops/dft_kernels.py's FLAT_GEO_EXCESS, 2e-7 over the plain version's
// mean distance. Three products (hh, hm, mh only: bf16x3) break it, so a
// k step takes all six (tests/test_torch_flat_dft.py holds a numpy copy of
// both against that limit).
//
// Design:
// - One twiddle block for the four chunks. W^((128c + n) k) = (-i)^(ck)
//   W^(nk), so chunk c's partial sum is chunk 0's product with its own rows
//   turned by a quarter turn ck times: an exchange and a sign flip of re and
//   im, exact. B is the [128, 512] block of phases (n*k) mod 512, n < 128,
//   the cos and -sin columns of a slot side by side, built by the wrapper
//   once per device, pre-split into its three pieces and laid out for
//   wgmma's no-swizzle K-major operand (8 x 16-byte core matrices).
// - A block takes 128 frames of one song: two consumer warpgroups of 64
//   frames and a producer warpgroup, one thread of which issues the loads
//   (its registers go to the consumers by setmaxnreg). The frames' signal
//   is a slab of 131 rows of 128 samples, staged in shared memory once
//   (frame f's chunk c is slab row f + c, the TPU kernel's slab trick);
//   every warpgroup forms its A pieces in registers from it (A from
//   registers, B from shared memory).
// - The producer keeps a four-stage ring of B tiles (32 columns x 32 k x 3
//   pieces, 6 KB, contiguous in device memory) filled by cp.async.bulk with
//   mbarrier completion; both warpgroups read each tile, so B's traffic from
//   L2 is 384 KB a block.
// - For each 32-column N-tile (16 slots) the four chunks accumulate in four
//   m64n32 accumulators, fresh each k-stage, and four running sums (128
//   registers a thread), chunk by chunk (issuing the four chunks' products
//   in turn read 5% slower); a thread's register pair holds re and im of
//   one slot, so the quarter turns, the Neumaier step and the magnitude stay
//   in registers, and the magnitudes of the tile go to shared memory.
// - Rows: one frame a warp, each warp over the 16 frames whose rows its
//   accumulators held, by timbral_rows.cuh's warp routine (the order of
//   timbral_fft.cu's rows).
#include <cuda_bf16.h>
#include <cstdint>

#include "timbral_rows.cuh"

namespace {

constexpr int kHop = 128;          // slab row width = chunk width = K of a chunk
constexpr int kOffset = 384;       // frame f starts at 128 f - 384
constexpr int kChunks = 4;
constexpr int kFrames = 128;       // frames a block
constexpr int kSlabRows = kFrames + kChunks - 1;
constexpr int kSlabStride = kHop + 8;     // floats; conflict-free float2 reads
constexpr int kSlots = 256;
constexpr int kMagStride = kSlots + 4;    // floats; conflict-free stores
constexpr int kTileCols = 32;             // N-tile: 16 slots, re and im
constexpr int kNTiles = 2 * kSlots / kTileCols;
constexpr int kStageK = 32;
constexpr int kKStages = kHop / kStageK;
constexpr int kStages = kNTiles * kKStages;
constexpr int kPieces = 3;
constexpr int kPieceBytes = kTileCols * kStageK * 2;
constexpr int kStageBytes = kPieces * kPieceBytes;
constexpr int kRing = 4;
constexpr int kConsumerWarps = 8;
// Two consumer warpgroups and a producer warpgroup, of which one thread
// issues the loads: 384 threads start at 168 registers; the producers give
// theirs up (setmaxnreg), so the consumers can take 240.
constexpr int kThreads = (kConsumerWarps + 4) * 32;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// shared memory, in bytes from the (dynamic) base
constexpr int kRingOff = 0;
constexpr int kBarOff = kRingOff + kRing * kStageBytes;
constexpr int kWinOff = kBarOff + 64;
constexpr int kSlabOff = kWinOff + 4 * kChunks * kHop;
constexpr int kMagOff = kSlabOff + 4 * kSlabRows * kSlabStride;
constexpr int kSmemBytes = kMagOff + 4 * kFrames * kMagStride;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block can use");
static_assert(kSlabOff % 16 == 0 && kMagOff % 16 == 0, "16-byte alignment");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` of barrier `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One contiguous copy from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma's shared-memory operand: no swizzle, K-major; core matrices of 8
// columns x 8 k (16 bytes a column), 512 bytes apart along k (leading byte
// offset), 128 bytes apart along n (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(512 >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous product.
__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 32] += a[64 x 16] (bf16, registers) * b[16 x 32] (bf16, shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The three bf16 pieces of two f32 values (lower column in the low half).
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = __fsub_rn(a, hf.x), rb = __fsub_rn(b, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(ra, mf.x), __fsub_rn(rb, mf.y));
  hi = bits(h);
  mid = bits(m);
  lo = bits(l);
}

struct APieces {
  uint32_t hi[4], mid[4], lo[4];
};

// This thread's A fragment (m64 x k16) of chunk c at k columns [k0, k0 + 16):
// rows r and r + 8 (slab rows r + c and r + 8 + c), columns k0 + 2t, +1 and
// k0 + 2t + 8, +9; each value the f32 window product.
__device__ __forceinline__ void form_a(APieces& a, const float* slab, const float* win,
                                       int r, int c, int k0, int t) {
  const int col = k0 + 2 * t;
  const float* w = win + c * kHop + col;
  const float2 w0 = *reinterpret_cast<const float2*>(w);
  const float2 w1 = *reinterpret_cast<const float2*>(w + 8);
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // register q: row r + 8 (q & 1), columns + 8 (q >> 1)
    const float* s = slab + (r + 8 * (q & 1) + c) * kSlabStride + col + 8 * (q >> 1);
    const float2 x = *reinterpret_cast<const float2*>(s);
    const float2 wq = (q >> 1) ? w1 : w0;
    split3(__fmul_rn(x.x, wq.x), __fmul_rn(x.y, wq.y), a.hi[q], a.mid[q], a.lo[q]);
  }
}

// The six products of one k16 step of chunk c, smallest first.
__device__ __forceinline__ void six_products(float (&d)[16], const APieces& a,
                                             uint32_t stage, int ks) {
  const uint32_t b = stage + ks * 1024;  // two 8-k core columns a step
  const uint64_t bh = b_desc(b), bm = b_desc(b + kPieceBytes),
                 bl = b_desc(b + 2 * kPieceBytes);
  wgmma_rs(d, a.mid, bm);
  wgmma_rs(d, a.lo, bh);
  wgmma_rs(d, a.hi, bl);
  wgmma_rs(d, a.mid, bh);
  wgmma_rs(d, a.hi, bm);
  wgmma_rs(d, a.hi, bh);
}

// Neumaier-compensated s += p, the compensation kept in c.
__device__ __forceinline__ void comp_add(float& s, float& c, float p) {
  const float t = __fadd_rn(s, p);
  c = __fadd_rn(c, fabsf(s) >= fabsf(p) ? __fadd_rn(__fsub_rn(s, t), p)
                                        : __fadd_rn(__fsub_rn(p, t), s));
  s = t;
}

__global__ void __launch_bounds__(kThreads, 1)
timbral_flat_kernel(const float* __restrict__ x, long long t_len, int n_frames,
                    const float* __restrict__ win,
                    const unsigned char* __restrict__ bmat, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* swin = reinterpret_cast<float*>(smem + kWinOff);
  float* slab = reinterpret_cast<float*>(smem + kSlabOff);
  float* mags = reinterpret_cast<float*>(smem + kMagOff);
  const uint32_t ring = smem_addr(smem + kRingOff);
  const uint32_t bars = smem_addr(smem + kBarOff);  // full[kRing], then empty[kRing]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f0 = blockIdx.x * kFrames;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kRing + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: the B tiles in order, N-tile by N-tile, k-stage by k-stage;
    // it gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumerWarps * 32) {
      for (int i = 0; i < kStages; ++i) {
        const int s = i % kRing;
        const int use = i / kRing;
        if (use > 0) mbar_wait(bars + 8 * (kRing + s), (use - 1) & 1);
        mbar_expect_tx(bars + 8 * s, kStageBytes);
        bulk_load(ring + s * kStageBytes, bmat + static_cast<long long>(i) * kStageBytes,
                  kStageBytes, bars + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  // consumers: stage the window and the slab (rows f0 - 3 .. f0 + 127 of the
  // song seen as [T/128, 128], zeros outside [0, T))
  constexpr int kConsumers = kConsumerWarps * 32;
  constexpr int kSlabFloats = kSlabRows * kHop;
  const float* xs = x + static_cast<long long>(blockIdx.y) * t_len;
  for (int i = threadIdx.x; i < kChunks * kHop; i += kConsumers) swin[i] = win[i];
  const long long base = static_cast<long long>(f0) * kHop - kOffset;
  for (int i = threadIdx.x; i < kSlabFloats; i += kConsumers) {
    const long long s = base + i;
    slab[(i / kHop) * kSlabStride + i % kHop] = (s >= 0 && s < t_len) ? xs[s] : 0.0f;
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");

  const int wg = warp >> 2;        // consumer warpgroup: frames 64 wg ..
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 64 * wg + 16 * (warp & 3) + g;  // this thread's rows: row0, row0 + 8
  float acc[kChunks][16], run[kChunks][16];

  for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 16; ++i) run[c][i] = 0.0f;
    for (int kst = 0; kst < kKStages; ++kst) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[c][i] = 0.0f;
        fence_acc(acc[c]);
      }
      const int i = nt * kKStages + kst;
      const int s = i % kRing;
      mbar_wait(bars + 8 * s, (i / kRing) & 1);
      const uint32_t stage = ring + s * kStageBytes;
      // chunk by chunk, k16 step by k16 step; a set's A registers are formed
      // again only once its products are done (wait_group 1)
      APieces a[2];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int ks = 0; ks < kStageK / 16; ++ks) {
          APieces& cur = a[(c * 2 + ks) & 1];
          form_a(cur, slab, swin, row0, c, kst * kStageK + ks * 16, t);
          wgmma_fence();
          six_products(acc[c], cur, stage, ks);
          wgmma_commit();
          wgmma_wait<1>();
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        fence_acc(acc[c]);
#pragma unroll
        for (int i = 0; i < 16; ++i) run[c][i] = __fadd_rn(run[c][i], acc[c][i]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kRing + s));
    }

    // the quarter turns, Neumaier in chunk order, the magnitudes
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int slot = nt * 16 + 4 * j + t;
      const bool nyquist = slot == kSlots - 1;  // bin 256: (-i)^(256 c) = 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s_re = 0.0f, c_re = 0.0f, s_im = 0.0f, c_im = 0.0f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float re = run[c][4 * j + 2 * h], im = run[c][4 * j + 2 * h + 1];
          // (re, im) * (-i)^m, m = c k mod 4 = c t mod 4 (k = 4 (8 nt + j) + t)
          const int m = nyquist ? 0 : (c * t) & 3;
          const float x0 = (m & 1) ? im : re;
          const float y0 = (m & 1) ? re : im;
          comp_add(s_re, c_re, m >= 2 ? -x0 : x0);
          comp_add(s_im, c_im, (m == 1 || m == 2) ? -y0 : y0);
        }
        const float r = __fadd_rn(s_re, c_re), q = __fadd_rn(s_im, c_im);
        mags[(row0 + 8 * h) * kMagStride + slot] =
            __fsqrt_rn(__fadd_rn(__fmul_rn(r, r), __fmul_rn(q, q)));
      }
    }
  }
  __syncwarp();

  // rows: this warp's 16 frames, one at a time
  float* os = out + static_cast<long long>(blockIdx.y) * n_frames * 5;
  const int first = 64 * wg + 16 * (warp & 3);
  for (int q = 0; q < 16; ++q) {
    const int f = f0 + first + q;
    if (f >= n_frames) break;
    float mag[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) mag[r] = mags[(first + q) * kMagStride + lane + 32 * r];
    bliss::warp_timbral_row(mag, lane, os + static_cast<long long>(f) * 5);
  }
}

}  // namespace

// x [batch, t_len] f32, win [512] f32, bmat the wrapper's [128, 512] twiddle
// block in its three bf16 pieces and tile layout (384 KB, 16-byte aligned),
// out [batch, n_frames, 5] f32. Frames are 512/128 with offset 384 only.
extern "C" int timbral_flat_launch(const float* x, int batch, long long t_len,
                                   int n_frames, int hop, int offset,
                                   const float* win, const void* bmat, float* out,
                                   cudaStream_t stream) {
  if (n_frames <= 0 || batch <= 0) return 0;
  if (hop != kHop || offset != kOffset || batch > 65535 ||
      (reinterpret_cast<uintptr_t>(bmat) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      timbral_flat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  timbral_flat_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      x, t_len, n_frames, win, static_cast<const unsigned char*>(bmat), out);
  return static_cast<int>(cudaGetLastError());
}
