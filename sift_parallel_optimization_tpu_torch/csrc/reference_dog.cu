// REFERENCE-mode Gaussian-window + DoG pyramid: every octave in one launch.
//
// Replaces the TPU kernel ops/scale_space_pallas.reference_dog_octave_pallas
// (body _octave_kernel, driver reference_dog_pyramid_pallas) of the JAX
// package, together with its per-octave subsample and tail batching.
//
// For octave o of side n_o = n >> o with base_o[y, x] = img[y << o, x << o]
// and the per-octave window bank f (n_scales rows of n_o taps):
//   out_o[s]         = base_o * (f_s(y) f_s(x) - f_{s+1}(y) f_{s+1}(x)),  s < n_scales - 1
//   out_o[n_scales-1] = base_o * f_top(y) f_top(x)
//
// What bounds it on the H100: output bandwidth. It reads about (4/3) n^2
// floats (strided above octave 0, left to the cache) and writes n_scales *
// (4/3) n^2 floats with ~4 flops per output, far below the card's
// flop-per-byte balance. At 512^2 the whole pyramid is 7 MB and a launch's
// fixed few microseconds are most of its time; from 4096^2 on the stores are.
//
// Design: CTAs map to rows, threads to four consecutive x. A CTA of 256
// threads is folded per octave into (256 >> lg) rows of (1 << lg) threads,
// lg chosen on the host so that one thread row spans the octave's row (at
// most 1024 pixels a segment); octave, row block, segment and the octave's
// offsets come once per CTA from blockIdx and a table in the parameter
// struct: no per-thread octave walk and no division by the side. A thread
// reads its four source pixels once (one 16-byte load at octave 0), the
// n_scales column factors as float4 and the row factors as broadcast
// scalars, and writes n_scales 16-byte streaming stores (__stcs: the output
// is never read again by the kernel); consecutive threads write consecutive
// 16 bytes. On large images a CTA walks several row blocks, so the card
// holds fewer, longer CTAs.
//
// Alignment: an octave takes the 16-byte path when its side is a multiple of
// 4 and its offsets in the flat output and in the banks are too. Both
// offsets sum n_scales * side^2 and n_scales * side of the octaves before
// it, so for a power-of-two n every octave down to side 4 is aligned, and
// for any n every octave down to the first side that is no multiple of 4
// (500: only octave 0; 768: down to side 12). The rest (sides 2 and 1, odd
// sides) are small and take the same mapping with scalar loads and stores,
// each x guarded. No shared memory. Products and differences use the _rn
// intrinsics so nvcc cannot contract them into FMAs: the result equals the
// plain PyTorch version, op for op.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOct = 32;
constexpr int kMaxRowBlocks = 4;    // row blocks one CTA walks, at most
constexpr int kCtasPerSm = 16;      // CTAs per SM wanted before a CTA walks more rows
constexpr int kSms = 132;

struct Pyramid {
  int n_oct, n_scales, n;
  int walk;                      // row blocks per CTA
  int size[kMaxOct];             // side of the octave
  int lg[kMaxOct];               // log2 of the threads that span a row segment
  int vec[kMaxOct];              // 1: 16-byte loads and stores
  int segs[kMaxOct];             // row segments of (4 << lg) pixels
  int cta_start[kMaxOct + 1];    // first CTA of the octave
  int bank_off[kMaxOct];         // first float of the octave's window bank
  long long out_off[kMaxOct];    // first float of the octave in the flat output
};

__global__ void __launch_bounds__(kThreads)
reference_dog_pyramid_kernel(const float* __restrict__ img, const float* __restrict__ banks,
                             float* __restrict__ out, Pyramid pyr) {
  int cta = blockIdx.x;
  int o = 0;
  while (o + 1 < pyr.n_oct && cta >= pyr.cta_start[o + 1]) ++o;
  cta -= pyr.cta_start[o];
  const int size = pyr.size[o], lg = pyr.lg[o], segs = pyr.segs[o];
  const int row_block = cta / segs;
  const int seg = cta - row_block * segs;
  const int rows = kThreads >> lg;                       // rows of one row block
  const int tx = threadIdx.x & ((1 << lg) - 1), ty = threadIdx.x >> lg;
  const int x = ((seg << lg) + tx) << 2;
  if (x >= size) return;
  const float* f = banks + pyr.bank_off[o];
  const size_t plane = static_cast<size_t>(size) * size;
  float* dst_o = out + pyr.out_off[o];
  const int n_scales = pyr.n_scales;

  for (int w = 0; w < pyr.walk; ++w) {
    const int y = (row_block * pyr.walk + w) * rows + ty;
    if (y >= size) return;
    const float* src = img + static_cast<size_t>(y << o) * pyr.n + (static_cast<size_t>(x) << o);
    float* dst = dst_o + static_cast<size_t>(y) * size + x;
    if (pyr.vec[o]) {
      float4 base;
      if (o == 0) {
        base = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        const size_t step = static_cast<size_t>(1) << o;
        base = make_float4(__ldg(src), __ldg(src + step), __ldg(src + 2 * step),
                           __ldg(src + 3 * step));
      }
      float fy = __ldg(f + y);
      float4 fx = __ldg(reinterpret_cast<const float4*>(f + x));
      float4 prev = make_float4(__fmul_rn(fy, fx.x), __fmul_rn(fy, fx.y), __fmul_rn(fy, fx.z),
                                __fmul_rn(fy, fx.w));
      for (int s = 1; s < n_scales; ++s) {
        const float* fs = f + s * size;
        fy = __ldg(fs + y);
        fx = __ldg(reinterpret_cast<const float4*>(fs + x));
        const float4 cur = make_float4(__fmul_rn(fy, fx.x), __fmul_rn(fy, fx.y),
                                       __fmul_rn(fy, fx.z), __fmul_rn(fy, fx.w));
        __stcs(reinterpret_cast<float4*>(dst + (s - 1) * plane),
               make_float4(__fmul_rn(base.x, __fsub_rn(prev.x, cur.x)),
                           __fmul_rn(base.y, __fsub_rn(prev.y, cur.y)),
                           __fmul_rn(base.z, __fsub_rn(prev.z, cur.z)),
                           __fmul_rn(base.w, __fsub_rn(prev.w, cur.w))));
        prev = cur;
      }
      __stcs(reinterpret_cast<float4*>(dst + (n_scales - 1) * plane),
             make_float4(__fmul_rn(base.x, prev.x), __fmul_rn(base.y, prev.y),
                         __fmul_rn(base.z, prev.z), __fmul_rn(base.w, prev.w)));
    } else {
      const int nx = min(4, size - x);
      for (int j = 0; j < nx; ++j) {
        const float base = __ldg(src + (static_cast<size_t>(j) << o));
        float prev = __fmul_rn(__ldg(f + y), __ldg(f + x + j));
        for (int s = 1; s < n_scales; ++s) {
          const float* fs = f + s * size;
          const float cur = __fmul_rn(__ldg(fs + y), __ldg(fs + x + j));
          __stcs(dst + (s - 1) * plane + j, __fmul_rn(base, __fsub_rn(prev, cur)));
          prev = cur;
        }
        __stcs(dst + (n_scales - 1) * plane + j, __fmul_rn(base, prev));
      }
    }
  }
}

}  // namespace

// img: (n, n) f32; banks: concatenated (n_scales, n >> o) window banks of the
// n_oct octaves; out: concatenated (n_scales, n >> o, n >> o) planes.
// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for more than 32 octaves or a side of 2^15 or more.
extern "C" int sift_reference_dog_pyramid(const float* img, const float* banks,
                                          float* out, int n, int n_oct,
                                          int n_scales, void* stream) {
  if (n_oct > kMaxOct || n >= (1 << 15) || n_scales < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = ((reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(banks) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  Pyramid pyr;
  pyr.n_oct = n_oct;
  pyr.n_scales = n_scales;
  pyr.n = n;
  long long quads = 0;
  for (int o = 0, size = n; o < n_oct; ++o, size >>= 1)
    quads += static_cast<long long>(size) * ((size + 3) / 4);
  if (quads == 0) return static_cast<int>(cudaSuccess);
  // Small pyramids: one row block a CTA, so that the card fills at all.
  long long walk = quads / (static_cast<long long>(kThreads) * kSms * kCtasPerSm);
  pyr.walk = static_cast<int>(walk < 1 ? 1 : (walk > kMaxRowBlocks ? kMaxRowBlocks : walk));
  long long ctas = 0, out_off = 0;
  int bank_off = 0;
  for (int o = 0, size = n; o < n_oct; ++o, size >>= 1) {
    const int quads_row = (size + 3) / 4;
    int lg = 0;
    while ((1 << lg) < quads_row && (1 << lg) < kThreads) ++lg;
    const int rows = (kThreads >> lg) * pyr.walk;
    pyr.size[o] = size;
    pyr.lg[o] = lg;
    pyr.segs[o] = (quads_row + (1 << lg) - 1) >> lg;
    pyr.vec[o] = aligned && size % 4 == 0 && out_off % 4 == 0 && bank_off % 4 == 0;
    pyr.cta_start[o] = static_cast<int>(ctas);
    pyr.bank_off[o] = bank_off;
    pyr.out_off[o] = out_off;
    ctas += static_cast<long long>((size + rows - 1) / rows) * pyr.segs[o];
    out_off += static_cast<long long>(n_scales) * size * size;
    bank_off += n_scales * size;
  }
  pyr.cta_start[n_oct] = static_cast<int>(ctas);
  if (ctas == 0) return static_cast<int>(cudaSuccess);
  reference_dog_pyramid_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(img, banks, out, pyr);
  return static_cast<int>(cudaGetLastError());
}
