// Kernel 6: the SIFT descriptor histograms of one or two orientations a slot,
// normalised, written straight into their rows of the descriptor tensor.
//
// Replaces no Pallas kernel: in the JAX package the histograms are jnp
// (models/descriptor.py _descriptors_from_samples, _normalize_desc), which
// XLA fuses into a few TPU kernels. PyTorch runs the same chain eagerly, op
// by op (~68 launches an orientation), with every intermediate in device
// memory: hat weights of (slots, 576, 4 | 4 | 8) and their product, a
// (slots, 576, 16) tensor read back by an fp32 batched product. Here:
//
//   per slot, from its (26, 26) f32 sample grid s, its (26,) grid offsets
//   off, sigma and, per orientation, theta and a validity flag:
//   gy = (s[i+2][j+1] - s[i][j+1]) / 2, gx = (s[i+1][j+2] - s[i+1][j]) / 2,
//   mag = sqrt(gx^2 + gy^2), ang = atan2(gy, gx) for the 24 x 24 gradients;
//   u, v = the offsets (off[i+1], off[j+1]) rotated by -theta, in bins of
//   3 sigma; w = mag * exp(-(u^2 + v^2) / 8); Lowe's trilinear vote of w
//   into 4 x 4 spatial bins (row u + 1.5, column v + 1.5, hats clipped to
//   bins 0..3) and 8 orientation bins (ang - theta, circular); then
//   L2-normalise, clip at 0.2, L2-normalise again. An invalid orientation
//   writes a zero row.
//
// Dual orientation writes orientation 1 to rows [0, K) and orientation 2 to
// rows [K, 2K) of each frame's (2K, 128) block, the layout the frontend
// returns; one orientation writes (K, 128).
//
// The arithmetic is the plain version's, op for op, with the _rn intrinsics
// so that nothing contracts into an FMA it does not have (the votes'
// accumulation is an FMA, as the plain version's fp32 product is): the
// standard sqrtf, atan2f, expf and sincosf, no fast-math intrinsics. What
// differs is the order of the sums over a bin's votes and over a row's
// squares.
//
// What bounds it on the H100: little. A slot reads ~2.8 KB (grid, offsets,
// scalars) and writes 0.5 KB a row: ~7.8 MB a 2000-keypoint frame, ~2 us at
// 3.35 TB/s; its ~140 fp32 operations a sample (an atan2 and a sqrt shared
// by both orientations, an exp and the hats and votes of each) are about as
// many microseconds at 67 TFLOP/s. What costs is the transcendental work a
// sample and the scatter of ~8 votes a sample into 128 bins. Design:
//
//   * One warp a slot, 4 slots a block. The grid lands in shared memory by
//     16-byte loads; each lane takes 18 of the 576 samples (p = lane + 32 t)
//     and keeps their mag and atan2 in registers, computed once for both
//     orientations; sincos(theta) once per orientation.
//   * Votes go to lane-private histograms in shared memory, bin-major with
//     the lane minor (bin * 32 + lane): every lane's scatter hits its own
//     bank, whatever bins its samples touch, and no atomics are needed. The
//     grid's 2.7 KB is read before the histograms are zeroed over it.
//   * Lane l owns bins 4l..4l+3 and sums their 32 private copies in a fixed
//     order, starting at copy l (conflict-free). The L2 norms are warp
//     butterfly sums (the same bits in every lane) and each row leaves as
//     one 16-byte store a lane. Every sum runs in an order fixed by the
//     inputs alone, so a repeat call gives the same bits.
//   * A sample whose hats touch no bin (about 40% of the grid) skips its
//     exp and votes. A voting sample's eight votes go to eight distinct
//     bins (a vote off the 4 x 4 cells to a spare bin), so its eight loads
//     are issued together, then its sums and stores: the read-modify-writes
//     of one sample do not wait on each other. An invalid orientation skips
//     its histogram, a slot with no valid one its grid.
//   * Measured against variants on the card (PERF.md): a sample loop with
//     no branch (every sample's exp, spare votes) is 13% slower at 8 x 2,000
//     slots and 5% faster at 1,000 unbatched; votes one at a time are 4%
//     faster batched and 8% slower at 2,000 unbatched. Summing the copies
//     four at a 16-byte load is ~5% faster, but rounds the sums in another
//     order, which moved the 120-frame odometry run of chip_smoke.py across
//     its coverage ATE gate; this order keeps the bits that run passed on.
//   * 16.3 KB of shared memory a warp, 65 KB a block: 3 blocks (12 warps)
//     an SM.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;                   // slots a block, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kGrid = 26;                   // samples a side
constexpr int kInner = kGrid - 2;           // gradients a side
constexpr int kPerLane = kInner * kInner / 32;
constexpr int kWidth = 4;                   // spatial bins a side
constexpr int kOriBins = 8;
constexpr int kBins = kWidth * kWidth * kOriBins;
constexpr int kHistFloats = (kBins + 1) * 32;   // a copy a lane, + a spare bin
constexpr int kWarpFloats = kHistFloats + 32;       // + the grid's offsets
constexpr int kSmemBytes = kWarps * kWarpFloats * 4;
constexpr float kTwoPi = 6.283185307179586f;    // f32(2 pi)
// x / f32(2 pi) as PyTorch computes it on the card: x * (1 / f32(2 pi)).
constexpr float kInvTwoPi = 1.0f / kTwoPi;
constexpr float kClip = 0.2f;

static_assert(kInner * kInner == 32 * kPerLane, "samples split evenly over the lanes");
static_assert(kGrid * kGrid <= kHistFloats, "the grid fits where the histograms go");

// max(0, 1 - |x - b|): the spatial hat.
__device__ __forceinline__ float hat(float x, float b) {
  return fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(x, b))), 0.0f);
}

// The orientation hat, circular over kOriBins.
__device__ __forceinline__ float circular_hat(float x, float b) {
  float d = fabsf(__fsub_rn(x, b));
  d = fminf(d, __fsub_rn(static_cast<float>(kOriBins), d));
  return fmaxf(__fsub_rn(1.0f, d), 0.0f);
}

// torch.remainder(x, f32(2 pi)) as PyTorch computes it (fmod, then + 2 pi
// where negative). Here x = atan2 - theta, so |x| <= f32(2 pi), where fmod is
// x itself or x -/+ 2 pi, both exact; fmodf's loop only past 4 pi.
__device__ __forceinline__ float remainder_2pi(float x) {
  float m = x;
  if (fabsf(x) >= kTwoPi)
    m = fabsf(x) < 2.0f * kTwoPi ? __fsub_rn(x, copysignf(kTwoPi, x)) : fmodf(x, kTwoPi);
  return m < 0.0f ? __fadd_rn(m, kTwoPi) : m;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

__global__ void __launch_bounds__(kThreads)
descriptor_hist_kernel(const float* __restrict__ samples, const float* __restrict__ offsets,
                       const float* __restrict__ sig_o, const float* __restrict__ theta1,
                       const uint8_t* __restrict__ valid1, const float* __restrict__ theta2,
                       const uint8_t* __restrict__ valid2, long long n_slots, int per_frame,
                       int n_ori, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (slot >= n_slots) return;
  float* hist = reinterpret_cast<float*>(smem) + warp * kWarpFloats;
  float* off = hist + kHistFloats;

  const long long frame = slot / per_frame;
  const long long row0 = frame * n_ori * per_frame + (slot - frame * per_frame);
  const bool ok1 = __ldg(valid1 + slot) != 0;
  const bool ok2 = n_ori > 1 && __ldg(valid2 + slot) != 0;
  if (!ok1 && !ok2) {
    for (int o = 0; o < n_ori; ++o)
      reinterpret_cast<float4*>(out + (row0 + o * per_frame) * kBins)[lane] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }

  // The grid and its offsets into shared memory; the grid sits where the
  // histograms go.
  const float* src = samples + slot * (kGrid * kGrid);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = lane; i < kGrid * kGrid / 4; i += 32)
      reinterpret_cast<float4*>(hist)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
  } else {
    for (int i = lane; i < kGrid * kGrid; i += 32) hist[i] = __ldg(src + i);
  }
  if (lane < kGrid) off[lane] = __ldg(offsets + slot * kGrid + lane);
  __syncwarp();

  // Gradient magnitude and direction of the lane's samples, shared by both
  // orientations.
  float mag[kPerLane], ang[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int p = lane + 32 * t;
    const int i = p / kInner, j = p - (p / kInner) * kInner;
    const float* g = hist + i * kGrid + j;
    const float gy = __fmul_rn(__fsub_rn(g[2 * kGrid + 1], g[1]), 0.5f);
    const float gx = __fmul_rn(__fsub_rn(g[kGrid + 2], g[kGrid]), 0.5f);
    mag[t] = sqrtf(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
    ang[t] = atan2f(gy, gx);
  }
  __syncwarp();   // the grid is read: the histograms may overwrite it

  const float inv_bw = __frcp_rn(fmaxf(__fmul_rn(3.0f, __ldg(sig_o + slot)), 1e-6f));
  float* mine = hist + lane;
  for (int o = 0; o < n_ori; ++o) {
    float4* row = reinterpret_cast<float4*>(out + (row0 + o * per_frame) * kBins);
    if (!(o == 0 ? ok1 : ok2)) {
      row[lane] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    for (int i = lane; i < kBins * 32 / 4; i += 32)
      reinterpret_cast<float4*>(hist)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncwarp();
    const float theta = __ldg((o == 0 ? theta1 : theta2) + slot);
    float sin_t, cos_t;
    sincosf(theta, &sin_t, &cos_t);
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int p = lane + 32 * t;
      const int i = p / kInner, j = p - (p / kInner) * kInner;
      const float dy = off[i + 1], dx = off[j + 1];
      const float u = __fmul_rn(__fsub_rn(__fmul_rn(cos_t, dy), __fmul_rn(sin_t, dx)), inv_bw);
      const float v = __fmul_rn(__fadd_rn(__fmul_rn(sin_t, dy), __fmul_rn(cos_t, dx)), inv_bw);
      const float rbin = __fsub_rn(__fadd_rn(u, 0.5f * kWidth), 0.5f);
      const float cbin = __fsub_rn(__fadd_rn(v, 0.5f * kWidth), 0.5f);
      // A hat touches a bin only inside (-1, kWidth); NaN fails here too.
      if (!(rbin > -1.0f && rbin < kWidth && cbin > -1.0f && cbin < kWidth)) continue;
      const float e = expf(__fmul_rn(-__fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v)),
                                     1.0f / (0.5f * kWidth * kWidth)));
      const float w = __fmul_rn(mag[t], e);
      const float obin = __fmul_rn(__fmul_rn(remainder_2pi(__fsub_rn(ang[t], theta)), kInvTwoPi),
                                   static_cast<float>(kOriBins));
      const float ofl = floorf(obin);
      if (!(ofl >= 0.0f && ofl <= kOriBins)) continue;
      const int o0 = static_cast<int>(ofl) & (kOriBins - 1);
      const int o1 = (o0 + 1) & (kOriBins - 1);
      const float wo0 = circular_hat(obin, static_cast<float>(o0));
      const float wo1 = circular_hat(obin, static_cast<float>(o1));
      const int r0 = static_cast<int>(floorf(rbin)), c0 = static_cast<int>(floorf(cbin));
      // The sample's eight votes, to eight distinct bins (a vote off the
      // cells goes to the spare bin): every load, then every sum and store.
      int at[8];
      float old[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int r = r0 + (q >> 2), c = c0 + ((q >> 1) & 1);
        const bool on = r >= 0 && r < kWidth && c >= 0 && c < kWidth;
        at[q] = (on ? (r * kWidth + c) * kOriBins + ((q & 1) ? o1 : o0) : kBins) * 32;
        old[q] = mine[at[q]];
      }
#pragma unroll
      for (int q = 0; q < 8; q += 2) {
        const int r = r0 + (q >> 2), c = c0 + ((q >> 1) & 1);
        const float b = __fmul_rn(__fmul_rn(w, hat(rbin, static_cast<float>(r))),
                                  hat(cbin, static_cast<float>(c)));
        mine[at[q]] = __fmaf_rn(b, wo0, old[q]);
        mine[at[q + 1]] = __fmaf_rn(b, wo1, old[q + 1]);
      }
    }
    __syncwarp();

    // Lane l sums bins 4l..4l+3 over the 32 copies, from copy l on.
    float h[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* col = hist + (4 * lane + q) * 32;
      float acc = 0.0f;
#pragma unroll 8
      for (int s = 0; s < 32; ++s) acc = __fadd_rn(acc, col[(lane + s) & 31]);
      h[q] = acc;
    }
    __syncwarp();   // read: the next orientation may zero the copies

    // Normalise, clip, normalise: the plain version's divisions and clamps.
    float sq = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) sq = __fmaf_rn(h[q], h[q], sq);
    const float n1 = fmaxf(sqrtf(warp_sum(sq)), 1e-7f);
    sq = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      h[q] = fminf(__fdiv_rn(h[q], n1), kClip);
      sq = __fmaf_rn(h[q], h[q], sq);
    }
    const float n2 = fmaxf(sqrtf(warp_sum(sq)), 1e-7f);
    row[lane] = make_float4(__fdiv_rn(h[0], n2), __fdiv_rn(h[1], n2), __fdiv_rn(h[2], n2),
                                __fdiv_rn(h[3], n2));
  }
}

}  // namespace

// samples: (N, 26, 26) f32; offsets: (N, 26) f32; sig_o, theta1, theta2:
// (N,) f32; valid1, valid2: (N,) bool as bytes (theta2 and valid2 read only
// when n_ori is 2); the N = B * per_frame slots of B frames. out: (B,
// n_ori * per_frame, 128) f32, 16-byte aligned, every row written. Requires
// N >= 1 and per_frame >= 1 (the wrapper checks). Returns the cudaError_t of
// the launch (0 on success).
extern "C" int sift_descriptor_hist(const float* samples, const float* offsets,
                                    const float* sig_o, const float* theta1,
                                    const uint8_t* valid1, const float* theta2,
                                    const uint8_t* valid2, long long n_slots, int per_frame,
                                    int n_ori, float* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(descriptor_hist_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(descriptor_hist_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n_slots + kWarps - 1) / kWarps);
  descriptor_hist_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      samples, offsets, sig_o, theta1, valid1, theta2, valid2, n_slots, per_frame, n_ori, out);
  return static_cast<int>(cudaGetLastError());
}
