// Per-keypoint patch gather from the plane atlas, one frame or a batch.
//
// Replaces the TPU kernels ops/patch_gather.extract_atlas_patches_pallas
// (body _kernel2d) and extract_atlas_patches_batched_pallas (with its
// custom_vmap rule) of the JAX package: out[b, k] = atlas[b, ys[b, k] :
// ys[b, k] + rows, xs[b, k] : xs[b, k] + cols] for (B, R, C) f32 atlases and
// (B, K) int32 origins. One launch copies all B * K patches; a single frame
// is the B = 1 case and an atlas shared by every frame is a zero batch
// stride. Origins are normalised PER FRAME as lax.dynamic_slice normalises
// them (a negative origin counts from the end, then clamps into the frame's
// own atlas), so no input can make the kernel read out of bounds or into a
// neighbouring frame. (The TPU kernel folds the batch into the row axis of
// one (B*R, C) atlas; here the frame is an index, not a row offset.)
//
// What bounds it on the H100: it is a pure copy, B * K * rows * cols floats
// read and written (about 200 MB each way per frame at 1024^2 with K = 2048,
// 96 x 256; 1.6 GB each way at B = 8).
//
// Design: one block per (patch, chunk of kRowsPerBlock rows); the patch
// count B * K lies in grid.x (limit 2^31 - 1), the few row chunks in grid.y.
// Each thread moves 16-byte float4 words; neighbouring threads take
// neighbouring words of a row, so loads and stores are coalesced. The vector
// path needs 16-byte aligned rows: the wrapper says whether the atlas, its
// batch stride and the output allow it and each block checks its own column
// origin, falling back to a scalar copy where it does not. Offsets are 64-bit:
// b * R * C passes 2^31 elements at 1024^2 from B of about 60.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 16;

__global__ void patch_gather_kernel(const float* __restrict__ atlas,
                                    const int* __restrict__ ys,
                                    const int* __restrict__ xs,
                                    float* __restrict__ out, int R, int C,
                                    int per_frame, long long atlas_stride,
                                    int rows, int cols, int vec_ok) {
  const long long k = blockIdx.x;          // flat patch index, b * K + k
  const long long b = k / per_frame;
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int nr = min(kRowsPerBlock, rows - r0);
  int y0 = __ldg(ys + k);
  int x0 = __ldg(xs + k);
  y0 = min(max(y0 < 0 ? y0 + R : y0, 0), R - rows);
  x0 = min(max(x0 < 0 ? x0 + C : x0, 0), C - cols);
  const float* src =
      atlas + b * atlas_stride + (static_cast<long long>(y0) + r0) * C + x0;
  float* dst = out + (k * rows + r0) * cols;

  if (vec_ok && (x0 & 3) == 0) {
    const int c4 = cols >> 2;
    for (int i = threadIdx.x; i < nr * c4; i += blockDim.x) {
      const int r = i / c4;
      const int c = i - r * c4;
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          src + static_cast<long long>(r) * C) + c);
      reinterpret_cast<float4*>(dst + static_cast<long long>(r) * cols)[c] = v;
    }
  } else {
    for (int i = threadIdx.x; i < nr * cols; i += blockDim.x) {
      const int r = i / cols;
      const int c = i - r * cols;
      dst[static_cast<long long>(r) * cols + c] =
          __ldg(src + static_cast<long long>(r) * C + c);
    }
  }
}

}  // namespace

// atlas: n / per_frame frames of (R, C) f32, atlas_stride floats apart (0: one
// atlas shared by every frame); ys, xs: (n,) int32, frame-major; out:
// (n, rows, cols) f32. Requires n >= 1, per_frame >= 1, 1 <= rows <= R,
// 1 <= cols <= C (the wrapper checks). vec_ok: atlas and out are 16-byte
// aligned and C, cols and atlas_stride are multiples of 4.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sift_patch_gather(const float* atlas, const int* ys,
                                 const int* xs, float* out, int R, int C,
                                 long long n, int per_frame,
                                 long long atlas_stride, int rows, int cols,
                                 int vec_ok, void* stream) {
  if (n < 1 || n > 2147483647LL || per_frame < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n),
                  static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock));
  patch_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      atlas, ys, xs, out, R, C, per_frame, atlas_stride, rows, cols, vec_ok);
  return static_cast<int>(cudaGetLastError());
}
