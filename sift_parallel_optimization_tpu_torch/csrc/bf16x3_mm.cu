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
// dropped: ~3 * 2^-16 of |A| |B| an entry). hi.hi sums into one accumulator,
// the two cross terms into a second, and the two are added once at the end.
// A batch index is a pair (i1, i2) with a stride each, and A and B have a
// row and a column stride each, so every operand the blur gives the product
// is read in place: the broadcasts of the dense blur (a batch stride of 0),
// the overlapping windows of the banded blur (a batch stride below the row
// stride) and an octave's base, the stride-2 subsample of the previous
// octave (a column stride of 2). C's column stride is 1.
//
// Either operand comes as f32 or already split: a bf16 hi and lo pair at the
// same offsets (ops/blur_product.py SplitPair). One operand of every blur
// product is a constant blur matrix (band blocks, Toeplitz banks, the tail's
// operator stacks), which the pyramid's modules split once when they are
// built and store in the layout read here: rows along the contiguous axis
// padded to 16 bytes, the row banks stored transposed. The other operand is
// the image or the row pass's result, in f32.
//
// What bounds it on the H100: at the blur's shapes (K = 94 banded, 256 and
// 128 dense, 64 in the tail) the work is 3 * 2mnk bf16 flops against f32
// operands read once and C written once; at 989 TFLOP/s and 3.35 TB/s the
// bytes set the floor for K below ~150. So the design keeps loads in flight
// and the work a byte small:
//
//   * One CTA a (batch, 64 x 64 output tile), 4 warps of 32 x 32, each a
//     2 x 4 grid of mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by
//     ldmatrix from bf16 tiles in shared memory; __launch_bounds__ caps the
//     registers at 128 so that 4 CTAs share an SM.
//   * The k loop runs over 32-deep tiles through a ring of kStages stages
//     filled by cp.async: the next tile's copies are in flight while this
//     one computes. 16-byte copies where a row is contiguous and 16-byte
//     aligned, 4-byte copies (f32) or plain loads (bf16 pairs) otherwise;
//     zero-filled past M, N and K. An octave's stride-2 base (an f32 A whose
//     columns are 2 apart) has an instance of its own that copies each row's
//     span 16 bytes at a time and keeps the even floats.
//   * An f32 operand's tile is split once as it lands, by the whole CTA,
//     into hi / lo bf16 tiles in shared memory; a split pair's tile is
//     copied as it is and needs no arithmetic at all.
//   * A tiles are [m][k] (rows 40 bf16 = 80 bytes apart), B tiles [k][n]
//     (rows 72 bf16 = 144 bytes apart, read with ldmatrix.trans): the eight
//     16-byte rows of every ldmatrix fall in distinct banks.
//
// Measured on the card (tools/kernel5_variants.py, PERF.md): a ring of 3 or
// 4 stages (3 or 2 CTAs an SM) and 128 x 64 or 64 x 128 tiles of 8 warps (2
// CTAs an SM) were each slower over the pyramid's launches than this shape:
// at K = 94 the occupancy that hides the first tile's wait counts for more
// than a deeper ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kStages = 2;
constexpr int kWarpsN = kBN / 32;   // warps of 32 x 32 along a tile's columns
constexpr int kThreads = 32 * (kBM / 32) * kWarpsN;
constexpr int kMinBlocks = 512 / kThreads;   // CTAs an SM at 128 registers a thread
constexpr int kLdA = kBK + 8;   // bf16 between the rows of an A tile
constexpr int kLdB = kBN + 8;   // bf16 between the rows of a B tile
constexpr int kAPart = kBM * kLdA;   // bf16 in one part (hi or lo) of an A tile
constexpr int kBPart = kBK * kLdB;

// One operand: element (r, c) of batch (i1, i2) at i1 * s1 + i2 * s2 + r * sr
// + c * sc elements from hi; lo is null for an f32 operand, else the bf16
// lo part at the same offsets. For A, r is the row (m) and c the depth (k);
// for B, r is the depth and c the column (n).
struct Operand {
  const void* hi;
  const uint16_t* lo;
  long long s1, s2, sr, sc;
  int vec;   // rows contiguous and 16-byte aligned: 16-byte copies
};

struct Params {
  Operand a, b;
  float* c;
  long long c1, c2, ldc;
  int batch2, m, n, k;
  int c_pairs;   // C's rows 8-byte aligned: two floats a store
};

// Shared-memory bytes of one operand: a stage of the ring (an f32 operand
// whose columns are kStep apart stages the kStep * kCols floats its rows
// span), and the split tile an f32 operand is split into.
template <int kRows, int kCols, int kLd, bool kPair, int kStep = 1>
struct Side {
  static constexpr int kStage = kPair ? 2 * 2 * kRows * kLd : 4 * kRows * kCols * kStep;
  static constexpr int kSplit = kPair ? 0 : 2 * 2 * kRows * kLd;
};

template <bool kAPair, bool kBPair, int kAStep>
struct Layout {
  using A = Side<kBM, kBK, kLdA, kAPair, kAStep>;
  using B = Side<kBK, kBN, kLdB, kBPair>;
  static constexpr int kBRing = kStages * A::kStage;
  static constexpr int kASplit = kBRing + kStages * B::kStage;
  static constexpr int kBSplit = kASplit + A::kSplit;
  static constexpr int kBytes = kBSplit + B::kSplit;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> (hi, lo) bf16 pairs, x in the low half of each word, rounded to
// nearest even as torch's .to(torch.bfloat16) rounds.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(x, hf.x), __fsub_rn(y, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Starts the copies of an f32 operand's (kRows, kCols) tile at (r0, c0) into
// raw (kStep * kCols floats a row); zero past (rows, cols). kStep 2: columns
// 2 apart (an octave's stride-2 base), each row's span of 2 * kCols floats
// copied 16 bytes at a time, the odd floats unused; the span stops at the
// last element of a row.
template <int kRows, int kCols, int kStep>
__device__ __forceinline__ void load_f32(float* raw, const float* src, const Operand& op,
                                         int r0, int c0, int rows, int cols) {
  if constexpr (kStep == 2) {
    constexpr int kSpan = 2 * kCols;
#pragma unroll
    for (int i = 0; i < kRows * kSpan / 4 / kThreads; ++i) {
      const int idx = i * kThreads + threadIdx.x;
      const int r = idx / (kSpan / 4), j = idx % (kSpan / 4) * 4;
      const int gr = r0 + r;
      const int n = gr < rows ? max(0, min(4, 2 * (cols - c0) - 1 - j)) : 0;
      cp_async16(raw + r * kSpan + j, n ? src + gr * op.sr + 2 * c0 + j : src, 4 * n);
    }
  } else if (op.vec) {
#pragma unroll
    for (int i = 0; i < kRows * kCols / 4 / kThreads; ++i) {
      const int idx = i * kThreads + threadIdx.x;
      const int r = idx / (kCols / 4), c = idx % (kCols / 4) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const int n = gr < rows ? max(0, min(4, cols - gc)) : 0;
      cp_async16(raw + r * kCols + c, n ? src + gr * op.sr + gc : src, 4 * n);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kRows * kCols / kThreads; ++i) {
      const int idx = i * kThreads + threadIdx.x;
      const int r = idx / kCols, c = idx % kCols;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < rows && gc < cols;
      cp_async4(raw + r * kCols + c, in ? src + gr * op.sr + gc * op.sc : src, in ? 4 : 0);
    }
  }
}

// The same for a split pair, into its hi and lo tiles (kLd bf16 a row).
template <int kRows, int kCols, int kLd>
__device__ __forceinline__ void load_pair(uint16_t* hi, uint16_t* lo, const uint16_t* src_hi,
                                          const uint16_t* src_lo, const Operand& op, int r0,
                                          int c0, int rows, int cols) {
  if (op.vec) {
#pragma unroll
    for (int i = 0; i < kRows * kCols / 8 / kThreads; ++i) {
      const int idx = i * kThreads + threadIdx.x;
      const int r = idx / (kCols / 8), c = idx % (kCols / 8) * 8;
      const int gr = r0 + r, gc = c0 + c;
      const int n = gr < rows ? max(0, min(8, cols - gc)) : 0;
      const long long off = n ? gr * op.sr + gc : 0;
      cp_async16(hi + r * kLd + c, src_hi + off, 2 * n);
      cp_async16(lo + r * kLd + c, src_lo + off, 2 * n);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kRows * kCols / kThreads; ++i) {
      const int idx = i * kThreads + threadIdx.x;
      const int r = idx / kCols, c = idx % kCols;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < rows && gc < cols;
      const long long off = gr * op.sr + gc * op.sc;
      hi[r * kLd + c] = in ? src_hi[off] : uint16_t{0};
      lo[r * kLd + c] = in ? src_lo[off] : uint16_t{0};
    }
  }
}

// An f32 tile (as load_f32 stages it) -> its hi and lo bf16 tiles. kStep 2:
// a thread takes one 16-byte chunk of the span, whose even floats are two
// adjacent elements.
template <int kRows, int kCols, int kLd, int kStep>
__device__ __forceinline__ void split_tile(const float* raw, uint16_t* hi, uint16_t* lo) {
  if constexpr (kStep == 2) {
#pragma unroll
    for (int i = 0; i < kRows * kCols / 2 / kThreads; ++i) {
      const int idx = i * kThreads + threadIdx.x;
      const int r = idx / (kCols / 2), c = idx % (kCols / 2) * 2;
      const float4 v = *reinterpret_cast<const float4*>(raw + r * 2 * kCols + 2 * c);
      uint32_t h, l;
      split2(v.x, v.z, h, l);
      *reinterpret_cast<uint32_t*>(hi + r * kLd + c) = h;
      *reinterpret_cast<uint32_t*>(lo + r * kLd + c) = l;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRows * kCols / 4 / kThreads; ++i) {
      const int idx = i * kThreads + threadIdx.x;
      const int r = idx / (kCols / 4), c = idx % (kCols / 4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(raw + r * kCols + c);
      uint32_t h0, l0, h1, l1;
      split2(v.x, v.y, h0, l0);
      split2(v.z, v.w, h1, l1);
      *reinterpret_cast<uint2*>(hi + r * kLd + c) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(lo + r * kLd + c) = make_uint2(l0, l1);
    }
  }
}

// One 32-deep tile of the warp's 32 x 32 block: three MMAs an (m16, n8, k16)
// step, hi.hi into acc, hi.lo and lo.hi into cor.
__device__ __forceinline__ void mma_tile(const uint16_t* a_hi, const uint16_t* a_lo,
                                         const uint16_t* b_hi, const uint16_t* b_lo,
                                         float (&acc)[2][4][4], float (&cor)[2][4][4], int wm,
                                         int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    // A fragments, registers 0..3: rows 0-7 / 8-15 at k 0-7, then at k 8-15.
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int off = (wm + mi * 16 + (lane & 15)) * kLdA + kk + (lane >> 4) * 8;
      ldmatrix_x4(ah[mi], a_hi + off);
      ldmatrix_x4(al[mi], a_lo + off);
    }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      // B fragments of two n8 blocks: registers 0, 1 the first (k 0-7, 8-15),
      // 2, 3 the second.
      uint32_t bh[4], bl[4];
      const int off = (kk + (lane & 15)) * kLdB + wn + nj * 16 + (lane >> 4) * 8;
      ldmatrix_x4_trans(bh, b_hi + off);
      ldmatrix_x4_trans(bl, b_lo + off);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float (&d)[4] = acc[mi][2 * nj + h];
          float (&e)[4] = cor[mi][2 * nj + h];
          mma_bf16(d, ah[mi], bh[2 * h], bh[2 * h + 1]);
          mma_bf16(e, ah[mi], bl[2 * h], bl[2 * h + 1]);
          mma_bf16(e, al[mi], bh[2 * h], bh[2 * h + 1]);
        }
      }
    }
  }
}

// kAStep: 1, or 2 for an f32 A whose columns are 2 apart (load_f32).
template <bool kAPair, bool kBPair, int kAStep>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bf16x3_bmm_kernel(const Params p) {
  using L = Layout<kAPair, kBPair, kAStep>;
  extern __shared__ __align__(16) unsigned char smem[];

  const long long i1 = blockIdx.z / p.batch2;
  const long long i2 = blockIdx.z - i1 * p.batch2;
  const long long a_off = i1 * p.a.s1 + i2 * p.a.s2;
  const long long b_off = i1 * p.b.s1 + i2 * p.b.s2;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int nk = (p.k + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN * 32;
  const int wn = warp % kWarpsN * 32;
  uint16_t* a_split = reinterpret_cast<uint16_t*>(smem + L::kASplit);
  uint16_t* b_split = reinterpret_cast<uint16_t*>(smem + L::kBSplit);

  // Starts the copies of k tile kt into its stage (a group a call, empty
  // past the last tile, so that the wait counts stay uniform).
  auto issue = [&](int kt) {
    if (kt < nk) {
      const int k0 = kt * kBK;
      unsigned char* sa = smem + (kt % kStages) * L::A::kStage;
      unsigned char* sb = smem + L::kBRing + (kt % kStages) * L::B::kStage;
      if constexpr (kAPair) {
        uint16_t* t = reinterpret_cast<uint16_t*>(sa);
        load_pair<kBM, kBK, kLdA>(t, t + kAPart, static_cast<const uint16_t*>(p.a.hi) + a_off,
                                  p.a.lo + a_off, p.a, m0, k0, p.m, p.k);
      } else {
        load_f32<kBM, kBK, kAStep>(reinterpret_cast<float*>(sa),
                                   static_cast<const float*>(p.a.hi) + a_off, p.a, m0, k0,
                                   p.m, p.k);
      }
      if constexpr (kBPair) {
        uint16_t* t = reinterpret_cast<uint16_t*>(sb);
        load_pair<kBK, kBN, kLdB>(t, t + kBPart, static_cast<const uint16_t*>(p.b.hi) + b_off,
                                  p.b.lo + b_off, p.b, k0, n0, p.k, p.n);
      } else {
        load_f32<kBK, kBN, 1>(reinterpret_cast<float*>(sb),
                              static_cast<const float*>(p.b.hi) + b_off, p.b, k0, n0, p.k,
                              p.n);
      }
    }
    cp_async_commit();
  };

  float acc[2][4][4] = {};   // hi.hi
  float cor[2][4][4] = {};   // hi.lo + lo.hi

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int kt = 0; kt < nk; ++kt) {
    // Tile kt has landed, and every warp is done with tile kt - 1: its stage
    // and the split tiles may be written again.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(kt + kStages - 1);
    unsigned char* sa = smem + (kt % kStages) * L::A::kStage;
    unsigned char* sb = smem + L::kBRing + (kt % kStages) * L::B::kStage;
    const uint16_t* ah = kAPair ? reinterpret_cast<const uint16_t*>(sa) : a_split;
    const uint16_t* bh = kBPair ? reinterpret_cast<const uint16_t*>(sb) : b_split;
    if constexpr (!kAPair) {
      split_tile<kBM, kBK, kLdA, kAStep>(reinterpret_cast<const float*>(sa), a_split,
                                         a_split + kAPart);
    }
    if constexpr (!kBPair) {
      split_tile<kBK, kBN, kLdB, 1>(reinterpret_cast<const float*>(sb), b_split,
                                    b_split + kBPart);
    }
    if constexpr (!kAPair || !kBPair) __syncthreads();
    mma_tile(ah, ah + kAPart, bh, bh + kBPart, acc, cor, wm, wn, lane);
  }

  // Accumulator registers 0..3: (row g, n 2t), (row g, n 2t+1), (row g+8,
  // n 2t), (row g+8, n 2t+1), g = lane / 4, t = lane % 4.
  float* C = p.c + i1 * p.c1 + i2 * p.c2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + wn + ni * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + mi * 16 + (lane >> 2) + 8 * h;
        if (r >= p.m || c >= p.n) continue;
        float* out = C + r * p.ldc + c;
        const float v0 = __fadd_rn(acc[mi][ni][2 * h], cor[mi][ni][2 * h]);
        const float v1 = __fadd_rn(acc[mi][ni][2 * h + 1], cor[mi][ni][2 * h + 1]);
        if (c + 1 < p.n && p.c_pairs) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          out[0] = v0;
          if (c + 1 < p.n) out[1] = v1;
        }
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

Operand operand(const void* hi, const void* lo, long long s1, long long s2, long long sr,
                long long sc) {
  // Rows of 16-byte chunks: 4 floats, or 8 bf16 of each part.
  const long long w = lo ? 8 : 4;
  const bool vec = sc == 1 && sr % w == 0 && s1 % w == 0 && s2 % w == 0 && aligned16(hi) &&
                   (!lo || aligned16(lo));
  return {hi, static_cast<const uint16_t*>(lo), s1, s2, sr, sc, vec ? 1 : 0};
}

// Whether an f32 operand's columns are 2 apart with its rows' spans 16-byte
// aligned: an octave's stride-2 base, staged by the kAStep = 2 instance.
bool step2(const void* hi, long long s1, long long s2, long long sr, long long sc) {
  return sc == 2 && sr % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0 && aligned16(hi);
}

template <bool kAPair, bool kBPair, int kAStep = 1>
const void* kernel_of(int* bytes) {
  *bytes = Layout<kAPair, kBPair, kAStep>::kBytes;
  return reinterpret_cast<const void*>(&bf16x3_bmm_kernel<kAPair, kBPair, kAStep>);
}

// The instance for the operands' kinds and its dynamic shared bytes: A split
// or f32 (columns 2 apart: a_step2, where B is split, as the pyramid's
// products of a base with a bank), B split or f32.
const void* kernel_for(bool a_pair, bool b_pair, bool a_step2, int* bytes) {
  if (a_pair) return b_pair ? kernel_of<true, true>(bytes) : kernel_of<true, false>(bytes);
  if (b_pair) return a_step2 ? kernel_of<false, true, 2>(bytes) : kernel_of<false, true>(bytes);
  return kernel_of<false, false>(bytes);
}

}  // namespace

// C[i1, i2] = A[i1, i2] @ B[i1, i2] for i1 < batch1, i2 < batch2: A (M, K),
// B (K, N), C (M, N) f32. A is f32 at a when a_lo is null, else a split pair
// (bf16 hi at a, lo at a_lo, the same offsets); the same for B. Strides in
// elements of the operand's type: rows lda / ldb / ldc apart, columns ska /
// skb / 1, batches sa1, sa2 / sb1, sb2 / sc1, sc2 apart (0: one matrix for
// every index). C must not overlap A or B. Requires M, N >= 1, batch1 *
// batch2 <= 65535 and ceil(M / 64) <= 65535 (the wrapper checks). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sift_bf16x3_bmm(const void* a, const void* a_lo, const void* b, const void* b_lo,
                               float* c, int batch1, int batch2, int m, int n, int k,
                               long long sa1, long long sa2, long long lda, long long ska,
                               long long sb1, long long sb2, long long ldb, long long skb,
                               long long sc1, long long sc2, long long ldc,
                               cudaStream_t stream) {
  Params p;
  p.a = operand(a, a_lo, sa1, sa2, lda, ska);
  p.b = operand(b, b_lo, sb1, sb2, ldb, skb);
  p.c = c;
  p.c1 = sc1;
  p.c2 = sc2;
  p.ldc = ldc;
  p.batch2 = batch2;
  p.m = m;
  p.n = n;
  p.k = k;
  p.c_pairs = ldc % 2 == 0 && sc1 % 2 == 0 && sc2 % 2 == 0 &&
              reinterpret_cast<uintptr_t>(c) % 8 == 0;
  int bytes = 0;
  const void* fn = kernel_for(a_lo != nullptr, b_lo != nullptr,
                              !a_lo && step2(a, sa1, sa2, lda, ska), &bytes);
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, batch1 * batch2);
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, bytes, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// What the build gave the instance for (A split?, B split?, A's columns 2
// apart?): out[0..4] = registers a thread, static shared bytes, dynamic
// shared bytes a launch, local (spill) bytes a thread, CTAs an SM can hold.
// Returns the cudaError_t.
extern "C" int sift_bf16x3_bmm_attributes(int a_pair, int b_pair, int a_step2, int* out) {
  int bytes = 0;
  const void* fn = kernel_for(a_pair != 0, b_pair != 0, a_step2 != 0, &bytes);
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = bytes;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = ctas;
  return 0;
}
