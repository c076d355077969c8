// DoG ranking score fused into candidate tables: only the tables reach memory.
//
// Replaces the TPU kernel ops/detect_fused.fused_score_tables (body _kernel)
// of the JAX package, and the XLA fusion that carries the same idea on the
// JAX package's accelerator branch (models/detect._dense_score(want_hops=True)
// feeding _block_top2 inside detect_octave_groups_batched).
//
// Per interior voxel (s, y, x) of an (S+2, H, W) DoG octave, read from its
// 3x3x3 cube, the score function computes what models/detect._dense_score
// does, with the same expressions in the same order: the strict 26-neighbour
// extremum test, central-difference gradient and Hessian, the 3x3 adjugate
// solve for the subpixel offset, Lowe's edge test and the ranking contrast.
// Products, sums and differences use the _rn intrinsics so nvcc cannot
// contract them into FMAs, 1/det is IEEE division and rounding is rintf
// (half to even, like torch.round): the score equals the plain PyTorch
// version bit for bit.
//
// Two entry points over that one score function:
//   sift_score_tables_rows   the TPU kernel's own contract: per score plane,
//                            interior row and 64-column span, (max, first
//                            argmax) of the f32 ranking score, with the flat
//                            index into the unpadded (S, H-2, W-2) volume.
//   sift_score_block_top2    what the detection path uses: every octave of a
//                            pyramid, of every frame of a batch, in one
//                            launch. For an octave of at least
//                            4096 score voxels, the top-2 (ties to the lower
//                            index) of each flat 64-voxel block of the
//                            hop-packed int32 scores, laid out [firsts,
//                            seconds]; for a smaller octave, every voxel's
//                            packed score, its f32 score and its index (the
//                            caller selects those exactly).
//
// What bounds it on the H100: neither bytes nor flops at first sight. It
// reads the DoG once (5 planes of f32 per octave, 21 MB at 1024^2) and writes
// 2/64 of the score voxels as tables, while each voxel costs ~130 flops and 27
// loads that hit L1/L2 (neighbouring lanes share cubes). Design: one warp per
// table entry (64 voxels, two per lane), reduced with shuffles, so no dense
// score volume and no extra pass exists. A shared-memory slab with a halo
// would cut the cached loads; that is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlk = 64;          // voxels per table entry
constexpr int kMaxOct = 32;
constexpr float kMaxOff = 0.6f;   // models/detect.MAX_REFINE_OFFSET

struct Score {
  float score;   // ranking score, 0 off-candidate
  int hop;       // first refinement hop code (13 = none)
};

// Score of interior voxel (s, y, x): the cube's corner is dog[s, y, x].
// refine != 0: the ranking score of the refine branch and the hop code;
// refine == 0: the refined-contrast score of the no-refine branch.
__device__ __forceinline__ Score voxel_score(const float* __restrict__ dog, int H, int W,
                                             int s, int y, int x, float thr,
                                             float edge_ratio, float er2, int refine) {
  const long long plane = static_cast<long long>(H) * W;
  const float* p = dog + s * plane + static_cast<long long>(y) * W + x;
  float v[3][3][3];
#pragma unroll
  for (int ds = 0; ds < 3; ++ds)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        v[ds][dy][dx] = __ldg(p + ds * plane + dy * W + dx);

  const float c = v[1][1][1];
  float mx = v[0][0][0], mn = v[0][0][0];
#pragma unroll
  for (int ds = 0; ds < 3; ++ds)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        mx = fmaxf(mx, v[ds][dy][dx]);
        mn = fminf(mn, v[ds][dy][dx]);
      }
  const bool is_ext = (c >= mx) || (c <= mn);

  // _grad_hess
  const float ds_p = v[2][1][1], ds_m = v[0][1][1];
  const float dy_p = v[1][2][1], dy_m = v[1][0][1];
  const float dx_p = v[1][1][2], dx_m = v[1][1][0];
  const float gs = __fmul_rn(__fsub_rn(ds_p, ds_m), 0.5f);
  const float gy = __fmul_rn(__fsub_rn(dy_p, dy_m), 0.5f);
  const float gx = __fmul_rn(__fsub_rn(dx_p, dx_m), 0.5f);
  const float c2 = __fmul_rn(2.0f, c);
  const float hss = __fsub_rn(__fadd_rn(ds_p, ds_m), c2);
  const float hyy = __fsub_rn(__fadd_rn(dy_p, dy_m), c2);
  const float hxx = __fsub_rn(__fadd_rn(dx_p, dx_m), c2);
  const float hsy = __fmul_rn(
      __fadd_rn(__fsub_rn(__fsub_rn(v[2][2][1], v[2][0][1]), v[0][2][1]), v[0][0][1]), 0.25f);
  const float hsx = __fmul_rn(
      __fadd_rn(__fsub_rn(__fsub_rn(v[2][1][2], v[2][1][0]), v[0][1][2]), v[0][1][0]), 0.25f);
  const float hyx = __fmul_rn(
      __fadd_rn(__fsub_rn(__fsub_rn(v[1][2][2], v[1][2][0]), v[1][0][2]), v[1][0][0]), 0.25f);

  // _solve3: H = [[a,b,c],[b,d,e],[c,e,f]]
  const float a = hss, d = hyy, f = hxx, b = hsy, cc = hsx, e = hyx;
  const float A = __fsub_rn(__fmul_rn(d, f), __fmul_rn(e, e));
  const float B = __fsub_rn(__fmul_rn(cc, e), __fmul_rn(b, f));
  const float C = __fsub_rn(__fmul_rn(b, e), __fmul_rn(cc, d));
  const float D = __fsub_rn(__fmul_rn(a, f), __fmul_rn(cc, cc));
  const float E = __fsub_rn(__fmul_rn(b, cc), __fmul_rn(a, e));
  const float F = __fsub_rn(__fmul_rn(a, d), __fmul_rn(b, b));
  const float det = __fadd_rn(__fadd_rn(__fmul_rn(a, A), __fmul_rn(b, B)), __fmul_rn(cc, C));
  const float inv_det = fabsf(det) > 1e-12f ? __fdiv_rn(1.0f, det) : 0.0f;
  const float off_s = __fmul_rn(
      -__fadd_rn(__fadd_rn(__fmul_rn(A, gs), __fmul_rn(B, gy)), __fmul_rn(C, gx)), inv_det);
  const float off_y = __fmul_rn(
      -__fadd_rn(__fadd_rn(__fmul_rn(B, gs), __fmul_rn(D, gy)), __fmul_rn(E, gx)), inv_det);
  const float off_x = __fmul_rn(
      -__fadd_rn(__fadd_rn(__fmul_rn(C, gs), __fmul_rn(E, gy)), __fmul_rn(F, gx)), inv_det);

  // _edge_test
  const float tr = __fadd_rn(hxx, hyy);
  const float det2 = __fsub_rn(__fmul_rn(hxx, hyy), __fmul_rn(hyx, hyx));
  const bool edge_ok =
      (det2 > 0.0f) && (__fmul_rn(__fmul_rn(tr, tr), edge_ratio) < __fmul_rn(er2, det2));

  Score out;
  if (refine) {
    const float cs = fminf(fmaxf(off_s, -kMaxOff), kMaxOff);
    const float cy = fminf(fmaxf(off_y, -kMaxOff), kMaxOff);
    const float cx = fminf(fmaxf(off_x, -kMaxOff), kMaxOff);
    const float d_rank = __fadd_rn(
        c, __fmul_rn(0.5f, __fadd_rn(__fadd_rn(__fmul_rn(gs, cs), __fmul_rn(gy, cy)),
                                     __fmul_rn(gx, cx))));
    const bool good = is_ext && (fabsf(d_rank) > thr) && edge_ok;
    out.score = good ? fabsf(d_rank) : 0.0f;
    const bool conv =
        fabsf(off_s) <= kMaxOff && fabsf(off_y) <= kMaxOff && fabsf(off_x) <= kMaxOff;
    const int st_s = static_cast<int>(fminf(fmaxf(rintf(off_s), -1.0f), 1.0f)) + 1;
    const int st_y = static_cast<int>(fminf(fmaxf(rintf(off_y), -1.0f), 1.0f)) + 1;
    const int st_x = static_cast<int>(fminf(fmaxf(rintf(off_x), -1.0f), 1.0f)) + 1;
    out.hop = conv ? 13 : st_s * 9 + st_y * 3 + st_x;
  } else {
    const float d_hat = __fadd_rn(
        c, __fmul_rn(0.5f, __fadd_rn(__fadd_rn(__fmul_rn(gs, off_s), __fmul_rn(gy, off_y)),
                                     __fmul_rn(gx, off_x))));
    const bool off_ok =
        fabsf(off_s) < kMaxOff && fabsf(off_y) < kMaxOff && fabsf(off_x) < kMaxOff;
    const bool good = is_ext && (fabsf(d_hat) > thr) && edge_ok && off_ok;
    out.score = good ? fabsf(d_hat) : 0.0f;
    out.hop = 13;
  }
  return out;
}

// The int32 key a table ranks by. refine: the hop packed into the low 5 bits
// of the score's bit pattern (order-preserving for non-negative f32), 0 stays
// 0. No refine: the score's bit pattern itself.
__device__ __forceinline__ int packed_key(Score sc, int refine) {
  const int bits = __float_as_int(sc.score);
  if (!refine) return bits;
  return sc.score > 0.0f ? ((bits & ~31) | sc.hop) : 0;
}

// (value, index) beats (value', index') under value descending, index ascending.
template <typename T>
__device__ __forceinline__ bool beats(T v, long long i, T v2, long long i2) {
  return v > v2 || (v == v2 && i < i2);
}

__global__ void score_tables_rows_kernel(const float* __restrict__ dog, int S, int H, int W,
                                         float thr, float edge_ratio, float er2,
                                         float* __restrict__ tv, int* __restrict__ ti) {
  const int hs = H - 2, ws = W - 2;
  const int nsp = (ws + kBlk - 1) / kBlk;
  const long long item = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= static_cast<long long>(S) * hs * nsp) return;   // whole warps exit together
  const int g = static_cast<int>(item % nsp);
  const long long row = item / nsp;
  const int y = static_cast<int>(row % hs);
  const int s = static_cast<int>(row / hs);

  float best = 0.0f;
  int col = g * kBlk + lane;   // first argmax: masked columns lose every tie
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = g * kBlk + h * 32 + lane;
    const float val = x < ws ? voxel_score(dog, H, W, s, y, x, thr, edge_ratio, er2, 1).score
                             : 0.0f;
    if (h == 0) {
      best = val;
      col = x;
    } else if (beats(val, x, best, col)) {
      best = val;
      col = x;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oc = __shfl_xor_sync(0xffffffffu, col, off);
    if (beats(ov, oc, best, col)) {
      best = ov;
      col = oc;
    }
  }
  if (lane == 0) {
    tv[item] = best;
    ti[item] = static_cast<int>((static_cast<long long>(s) * hs + y) * ws + col);
  }
}

struct Octaves {
  int n;
  int planes;                      // S + 2, shared by every octave
  long long dog_off[kMaxOct];      // first float of the octave in the flat DoG
  int h[kMaxOct], w[kMaxOct];
  int dense[kMaxOct];              // 1: every voxel; 0: 64-voxel top-2 tables
  long long out_off[kMaxOct];      // first output entry of the octave
  long long g_base[kMaxOct];       // flat score index of the octave's voxel 0
  long long score_off[kMaxOct];    // dense octaves: first entry in `score`
  long long warp_start[kMaxOct + 1];
  // A batch of frames with one octave layout, frame-major in every buffer.
  int frames;
  long long dog_stride;            // floats of one frame's flat DoG
  long long out_stride;            // vals / idx entries of one frame
  long long score_stride;          // dense-octave scores of one frame
};

__global__ void score_block_top2_kernel(const float* __restrict__ dog, Octaves oct, float thr,
                                        float edge_ratio, float er2, int refine,
                                        int* __restrict__ vals, long long* __restrict__ idx,
                                        float* __restrict__ score) {
  const long long gwarp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long per_frame = oct.warp_start[oct.n];
  if (gwarp >= per_frame * oct.frames) return;   // whole warps exit together
  const long long frame = gwarp / per_frame;
  const long long warp = gwarp - frame * per_frame;
  vals += frame * oct.out_stride;
  idx += frame * oct.out_stride;
  score += frame * oct.score_stride;
  int o = 0;
  while (o + 1 < oct.n && warp >= oct.warp_start[o + 1]) ++o;
  const long long local = warp - oct.warp_start[o];
  const int H = oct.h[o], W = oct.w[o];
  const int hs = H - 2, ws = W - 2;
  const long long plane = static_cast<long long>(hs) * ws;
  const long long vg = static_cast<long long>(oct.planes - 2) * plane;
  const float* src = dog + frame * oct.dog_stride + oct.dog_off[o];

  if (oct.dense[o]) {
    const long long f = local * 32 + lane;
    if (f >= vg) return;
    const int s = static_cast<int>(f / plane);
    const long long r = f - s * plane;
    const int y = static_cast<int>(r / ws);
    const int x = static_cast<int>(r - static_cast<long long>(y) * ws);
    const Score sc = voxel_score(src, H, W, s, y, x, thr, edge_ratio, er2, refine);
    const long long out = oct.out_off[o] + f;
    vals[out] = packed_key(sc, refine);
    idx[out] = oct.g_base[o] + f;
    score[oct.score_off[o] + f] = sc.score;
    return;
  }

  // Top-2 of the 64-voxel block `local`; voxels past the volume are zero
  // padding with their own (clamped later) indices.
  int v1 = 0, v2 = 0;
  long long i1 = 0, i2 = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long f = local * kBlk + h * 32 + lane;
    int key = 0;
    if (f < vg) {
      const int s = static_cast<int>(f / plane);
      const long long r = f - s * plane;
      const int y = static_cast<int>(r / ws);
      const int x = static_cast<int>(r - static_cast<long long>(y) * ws);
      key = packed_key(voxel_score(src, H, W, s, y, x, thr, edge_ratio, er2, refine), refine);
    }
    if (h == 0) {
      v1 = key;
      i1 = f;
    } else if (beats(key, f, v1, i1)) {
      v2 = v1;
      i2 = i1;
      v1 = key;
      i1 = f;
    } else {
      v2 = key;
      i2 = f;
    }
  }
  // Tournament merge (models/detect._block_top2's combiner): associative and
  // commutative, so the butterfly yields the exact top-2 of the block.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov1 = __shfl_xor_sync(0xffffffffu, v1, off);
    const long long oi1 = __shfl_xor_sync(0xffffffffu, i1, off);
    const int ov2 = __shfl_xor_sync(0xffffffffu, v2, off);
    const long long oi2 = __shfl_xor_sync(0xffffffffu, i2, off);
    const bool swap = beats(ov1, oi1, v1, i1);
    const int first = swap ? ov1 : v1;
    const long long fidx = swap ? oi1 : i1;
    const int lose_v = swap ? v1 : ov1;
    const long long lose_i = swap ? i1 : oi1;
    const int win2_v = swap ? ov2 : v2;
    const long long win2_i = swap ? oi2 : i2;
    const bool s_swap = beats(lose_v, lose_i, win2_v, win2_i);
    v1 = first;
    i1 = fidx;
    v2 = s_swap ? lose_v : win2_v;
    i2 = s_swap ? lose_i : win2_i;
  }
  if (lane == 0) {
    const long long nblk = (vg + kBlk - 1) / kBlk;
    const long long out = oct.out_off[o] + local;
    vals[out] = v1;
    vals[out + nblk] = v2;
    idx[out] = oct.g_base[o] + (i1 < vg - 1 ? i1 : vg - 1);
    idx[out + nblk] = oct.g_base[o] + (i2 < vg - 1 ? i2 : vg - 1);
  }
}

unsigned blocks_for_warps(long long warps) {
  return static_cast<unsigned>((warps + kWarps - 1) / kWarps);
}

}  // namespace

// dog: (S+2, H, W) f32; tv: (S, H-2, ceil((W-2)/64)) f32; ti: same shape,
// int32 flat indices into the (S, H-2, W-2) score volume. Requires H, W >= 3.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sift_score_tables_rows(const float* dog, int planes, int H, int W, float thr,
                                      float edge_ratio, float er2, float* tv, int* ti,
                                      void* stream) {
  const int S = planes - 2;
  const long long items =
      static_cast<long long>(S) * (H - 2) * ((W - 2 + kBlk - 1) / kBlk);
  if (items <= 0) return static_cast<int>(cudaSuccess);
  score_tables_rows_kernel<<<blocks_for_warps(items), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(dog, S, H, W, thr, edge_ratio,
                                                                  er2, tv, ti);
  return static_cast<int>(cudaGetLastError());
}

// dog: n_frames frames, dog_stride floats apart, each the octaves' (planes,
// H_o, W_o) f32 stacks concatenated flat. meta: host array of n_oct rows
// (dog_off, H, W, dense, out_off, g_base, score_off), one frame's layout.
// Per frame, out_stride entries apart, writes vals (int32 keys) and idx (int64
// flat score indices WITHIN the frame) from each octave's out_off and, for
// dense octaves, score_stride apart, the f32 scores from its score_off.
// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for no frame, or no or more than 32 octaves.
extern "C" int sift_score_block_top2(const float* dog, const long long* meta, int n_oct,
                                     int planes, int n_frames, long long dog_stride,
                                     long long out_stride, long long score_stride, float thr,
                                     float edge_ratio, float er2, int refine, int* vals,
                                     long long* idx, float* score, void* stream) {
  if (n_oct < 1 || n_oct > kMaxOct || n_frames < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Octaves oct;
  oct.n = n_oct;
  oct.planes = planes;
  oct.frames = n_frames;
  oct.dog_stride = dog_stride;
  oct.out_stride = out_stride;
  oct.score_stride = score_stride;
  long long warps = 0;
  for (int o = 0; o < n_oct; ++o) {
    const long long* m = meta + 7 * o;
    oct.dog_off[o] = m[0];
    oct.h[o] = static_cast<int>(m[1]);
    oct.w[o] = static_cast<int>(m[2]);
    oct.dense[o] = static_cast<int>(m[3]);
    oct.out_off[o] = m[4];
    oct.g_base[o] = m[5];
    oct.score_off[o] = m[6];
    const long long vg = static_cast<long long>(planes - 2) * (m[1] - 2) * (m[2] - 2);
    oct.warp_start[o] = warps;
    warps += oct.dense[o] ? (vg + 31) / 32 : (vg + kBlk - 1) / kBlk;
  }
  oct.warp_start[n_oct] = warps;
  if (warps == 0) return static_cast<int>(cudaSuccess);
  score_block_top2_kernel<<<blocks_for_warps(warps * n_frames), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(dog, oct, thr, edge_ratio, er2,
                                                                 refine, vals, idx, score);
  return static_cast<int>(cudaGetLastError());
}
