// Fused patch gather + separable bilinear resample of the descriptor stage.
//
// Replaces the TPU kernel ops/descriptor_fused.gather_resample_pallas (body
// _kernel, _resample_block) of the JAX package. Per keypoint k, the patch is
// the (128, 256) window of the (R, C) f32 atlas at (grow[k], x0[k]); with
// (py, px, rad) from params[k] and, for a grid of g samples per axis,
//   c_i = center + (i * (2 / (g - 1)) - 1) * rad        (the Pallas iota form)
//   w(c, p) = max(0, 1 - |c - p|)                      over the whole patch
//   out[i][j] = sum_q w(cx_j, q) * sum_p w(cy_i, p) * patch[p][q]
// for g = 18 (orientation grid, rad_o) and g = 26 (descriptor grid, rad_d).
// A sample whose taps fall off the patch gets no weight from them, so a grid
// point off the patch is exactly 0. Origins are normalised as
// lax.dynamic_slice normalises them (negative counts from the end, then
// clamp), so no input reads out of bounds.
//
// What bounds it on the H100: little. A hat weight is non-zero at at most two
// taps per axis (floor(c) and floor(c) + 1), so each output needs 4 atlas
// reads and 6 products: ~1000 outputs and ~16 KB of scattered L2 reads per
// keypoint, and 4 KB written. The TPU kernel staged the 128 KB patch and ran
// two small matmuls; here the patch never exists: one block per keypoint, one
// thread per output, the two taps read through L2 (neighbouring outputs share
// rows). Sums follow the matmuls' order (rows first, then columns) with the
// _rn intrinsics, so the result differs from the plain batched matmuls only
// where those round differently inside their sums.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPatchRows = 128;
constexpr int kPatchCols = 256;
constexpr int kOriGrid = 18;
constexpr int kDescGrid = 26;

__device__ __forceinline__ float hat(float c, int p) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(c, static_cast<float>(p)))));
}

__device__ __forceinline__ float grid_coord(float center, float rad, int i, float step) {
  const float lin = __fsub_rn(__fmul_rn(static_cast<float>(i), step), 1.0f);
  return __fadd_rn(center, __fmul_rn(lin, rad));
}

__global__ void gather_resample_kernel(const float* __restrict__ atlas, int R, int C,
                                       const int* __restrict__ grow,
                                       const int* __restrict__ xs,
                                       const float* __restrict__ params, int pstride,
                                       float* __restrict__ out_o, float* __restrict__ out_d) {
  const int k = blockIdx.x;
  int y0 = __ldg(grow + k);
  int x0 = __ldg(xs + k);
  y0 = min(max(y0 < 0 ? y0 + R : y0, 0), R - kPatchRows);
  x0 = min(max(x0 < 0 ? x0 + C : x0, 0), C - kPatchCols);
  const float* prm = params + static_cast<long long>(k) * pstride;
  const float py = __ldg(prm), px = __ldg(prm + 1);
  const float rad_o = __ldg(prm + 2), rad_d = __ldg(prm + 3);
  const float* patch = atlas + static_cast<long long>(y0) * C + x0;
  // The constants the Pallas body multiplies its iota by: f32(2 / (g - 1)).
  const float step_o = static_cast<float>(2.0 / (kOriGrid - 1));
  const float step_d = static_cast<float>(2.0 / (kDescGrid - 1));
  constexpr int n_o = kOriGrid * kOriGrid;
  constexpr int n_all = n_o + kDescGrid * kDescGrid;

  for (int t = threadIdx.x; t < n_all; t += blockDim.x) {
    const bool ori = t < n_o;
    const int g = ori ? kOriGrid : kDescGrid;
    const int u = ori ? t : t - n_o;
    const int i = u / g, j = u - (u / g) * g;
    const float rad = ori ? rad_o : rad_d;
    const float step = ori ? step_o : step_d;
    const float cy = grid_coord(py, rad, i, step);
    const float cx = grid_coord(px, rad, j, step);
    // First tap of each axis, clamped so a far-off (or non-finite)
    // coordinate converts to an int safely and finds no tap on the patch.
    const int p0 = static_cast<int>(fminf(fmaxf(floorf(cy), -2.0f), kPatchRows));
    const int q0 = static_cast<int>(fminf(fmaxf(floorf(cx), -2.0f), kPatchCols));
    float acc = 0.0f;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int q = q0 + b;
      if (q < 0 || q >= kPatchCols) continue;
      float col = 0.0f;   // sum_p w(cy, p) * patch[p][q]
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int p = p0 + a;
        if (p < 0 || p >= kPatchRows) continue;
        col = __fadd_rn(col, __fmul_rn(hat(cy, p), __ldg(patch + static_cast<long long>(p) * C + q)));
      }
      acc = __fadd_rn(acc, __fmul_rn(col, hat(cx, q)));
    }
    float* dst = ori ? out_o + static_cast<long long>(k) * n_o
                     : out_d + static_cast<long long>(k) * (n_all - n_o);
    dst[u] = acc;
  }
}

}  // namespace

// atlas: (R, C) f32 with R >= 128, C >= 256; grow, x0: (K,) int32 patch
// origins; params: (K, pstride) f32, columns [py, px, rad_o, rad_d, ...];
// out_o: (K, 18, 18) f32; out_d: (K, 26, 26) f32. Requires K >= 1 (the
// wrapper checks). Returns the cudaError_t of the launch (0 on success).
extern "C" int sift_gather_resample(const float* atlas, int R, int C, const int* grow,
                                    const int* x0, const float* params, int pstride, int K,
                                    float* out_o, float* out_d, void* stream) {
  gather_resample_kernel<<<static_cast<unsigned>(K), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(atlas, R, C, grow, x0, params,
                                                                pstride, out_o, out_d);
  return static_cast<int>(cudaGetLastError());
}
