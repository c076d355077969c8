// Kernel 5: the 3-pass bf16 matrix product of the SIFT blurs at
// blur_precision="high".
//
// Replaces no Pallas kernel: in the JAX package the blur products at
// Precision.HIGH are XLA dots (core/pyramid_ref.py blur_bank and
// blur_bank_banded, the tail's _sift_tail_octaves, parallel/scale_space.py
// sharded_blur_bank), which the TPU computes as three bf16 passes. No
// PyTorch call computes that function on the H100 (a bf16 matmul rounds its
// output to bf16; TF32 keeps 10 mantissa bits, not 16), so it is a kernel:
//
//   C[i] = A[i] @ B[i],  every f32 operand x split as x = hi + lo with
//   hi = bf16(x), lo = bf16(x - hi);  C = hi.hi + (hi.lo + lo.hi),
//
// products exact in f32, sums in fp32 (lo.lo and the bits below lo are
// dropped: ~3 * 2^-16 of |A| |B| an entry). A batch index is a pair (i1, i2)
// with a stride each, and A and B have a row and a column stride each, so
// every operand the blur gives the product is read in place: the broadcasts
// of the dense blur (a batch stride of 0), its transposed row banks (a row
// stride of 1), the overlapping windows of the banded blur (a batch stride
// below the row stride) and an octave's base, the stride-2 subsample of the
// previous octave (a column stride of 2). C's column stride is 1 (the
// wrapper, ops/blur_product.py, checks it).
//
// What bounds it on the H100: at the blur's shapes (K = 94 banded, up to 256
// dense) the work is 3 * 2mnk bf16 flops against f32 operands read once and
// C written once; at 989 TFLOP/s bf16 and 3.35 TB/s the bytes set the floor
// for K below ~150 and the operations above it.
//
// Design (simple first): one CTA per (batch, 64 x 64 output tile); 4 warps,
// each 32 x 32 of it as 2 x 4 tiles of mma.sync m16n8k16 (bf16 in, f32
// accumulate). Each 32-deep k step stages the f32 A and B tiles in shared
// memory (coalesced scalar loads, zero past the ragged edges), and each warp
// splits its fragments into hi / lo bf16 pairs in registers as it reads them
// and issues three MMAs a tile: hi.hi into one accumulator, hi.lo and lo.hi
// into a second, added at the end (as the plain version sums them). A rows
// are 40 floats apart in shared memory so the warp's 8-byte fragment reads
// meet no bank conflict; B rows 68 apart so its scalar ones meet none.
// wgmma, TMA, a pipeline of stages and constant matrices split once are left
// to a later design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr int kLdA = kBK + 8;   // floats between A rows in shared memory
constexpr int kLdB = kBN + 4;   // floats between B rows in shared memory

// (x, y) -> (hi, lo) bf16 pairs, x in the low half of each word.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(x, hf.x), __fsub_rn(y, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
bf16x3_bmm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int batch2, int M, int N, int K,
                  long long sa1, long long sa2, long long lda, long long ska,
                  long long sb1, long long sb2, long long ldb, long long skb,
                  long long sc1, long long sc2, long long ldc) {
  __shared__ __align__(16) float As[kBM * kLdA];
  __shared__ __align__(16) float Bs[kBK * kLdB];

  const long long i1 = blockIdx.z / batch2;
  const long long i2 = blockIdx.z - i1 * batch2;
  A += i1 * sa1 + i2 * sa2;
  B += i1 * sb1 + i2 * sb2;
  C += i1 * sc1 + i2 * sc2;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int g = lane >> 2;   // the fragment's row (A, C) or column (B) in its group
  const int t = lane & 3;    // its pair of k (A, B) or n (C) indices

  float acc[2][4][4] = {};   // hi.hi
  float cor[2][4][4] = {};   // hi.lo + lo.hi

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int idx = i * kThreads + threadIdx.x;
      const int r = idx / kBK, c = idx % kBK;
      const int gm = m0 + r, gk = k0 + c;
      As[r * kLdA + c] =
          (gm < M && gk < K) ? __ldg(A + gm * lda + gk * ska) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int idx = i * kThreads + threadIdx.x;
      const int r = idx / kBN, c = idx % kBN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r * kLdB + c] =
          (gk < K && gn < N) ? __ldg(B + gk * ldb + gn * skb) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* a = As + (wm + mi * 16 + g) * kLdA + kk + 2 * t;
        // Registers 0..3: (row g, k 2t..2t+1), (row g+8, same k),
        // (row g, k 2t+8..2t+9), (row g+8, same k).
        const float2 v0 = *reinterpret_cast<const float2*>(a);
        const float2 v1 = *reinterpret_cast<const float2*>(a + 8 * kLdA);
        const float2 v2 = *reinterpret_cast<const float2*>(a + 8);
        const float2 v3 = *reinterpret_cast<const float2*>(a + 8 * kLdA + 8);
        split2(v0.x, v0.y, ah[mi][0], al[mi][0]);
        split2(v1.x, v1.y, ah[mi][1], al[mi][1]);
        split2(v2.x, v2.y, ah[mi][2], al[mi][2]);
        split2(v3.x, v3.y, ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // Registers 0, 1: (k 2t..2t+1, column g), (k 2t+8..2t+9, column g).
        const float* b = Bs + (kk + 2 * t) * kLdB + wn + ni * 8 + g;
        split2(b[0], b[kLdB], bh[ni][0], bl[ni][0]);
        split2(b[8 * kLdB], b[9 * kLdB], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_bf16(acc[mi][ni], ah[mi], bh[ni]);
          mma_bf16(cor[mi][ni], ah[mi], bl[ni]);
          mma_bf16(cor[mi][ni], al[mi], bh[ni]);
        }
      }
    }
    __syncthreads();
  }

  // Accumulator registers 0..3: (row g, n 2t), (row g, n 2t+1), (row g+8,
  // n 2t), (row g+8, n 2t+1).
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + wn + ni * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + mi * 16 + g + 8 * h;
        if (r >= M) continue;
        float* out = C + static_cast<long long>(r) * ldc + c;
        if (c < N) out[0] = __fadd_rn(acc[mi][ni][2 * h], cor[mi][ni][2 * h]);
        if (c + 1 < N) out[1] = __fadd_rn(acc[mi][ni][2 * h + 1], cor[mi][ni][2 * h + 1]);
      }
    }
  }
}

}  // namespace

// C[i1, i2] = A[i1, i2] @ B[i1, i2] for i1 < batch1, i2 < batch2: A (M, K),
// B (K, N), C (M, N), all f32; rows lda / ldb / ldc floats apart, columns
// ska / skb / 1, batches sa1, sa2 / sb1, sb2 / sc1, sc2 floats apart (0: one
// matrix for every index). C must not overlap A or B. Requires M, N >= 1,
// batch1 * batch2 <= 65535 and ceil(M / 64) <= 65535 (the wrapper checks).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sift_bf16x3_bmm(const float* a, const float* b, float* c, int batch1,
                               int batch2, int m, int n, int k, long long sa1,
                               long long sa2, long long lda, long long ska, long long sb1,
                               long long sb2, long long ldb, long long skb, long long sc1,
                               long long sc2, long long ldc, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, batch1 * batch2);
  bf16x3_bmm_kernel<<<grid, kThreads, 0, stream>>>(a, b, c, batch2, m, n, k, sa1, sa2, lda,
                                                   ska, sb1, sb2, ldb, skb, sc1, sc2, ldc);
  return static_cast<int>(cudaGetLastError());
}
