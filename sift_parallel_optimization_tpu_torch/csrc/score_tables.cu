// DoG ranking score fused into candidate tables: only the tables reach memory.
//
// Replaces the TPU kernel ops/detect_fused.fused_score_tables (body _kernel)
// of the JAX package, and the XLA fusion that carries the same idea on the
// JAX package's accelerator branch (models/detect._dense_score(want_hops=True)
// feeding _block_top2 inside detect_octave_groups_batched).
//
// Per interior voxel (s, y, x) of an (S+2, H, W) DoG octave, read from its
// 3x3x3 cube, the score is what models/detect.dense_score computes, with the
// same expressions in the same order: the 26-neighbour extremum test (not
// strict: c >= max or c <= min), central-difference gradient and Hessian, the
// 3x3 adjugate solve for the subpixel offset, Lowe's edge test and the ranking
// contrast. Products, sums and differences use the _rn intrinsics so nvcc
// cannot contract them into FMAs, 1/det is IEEE division and rounding is
// rintf (half to even, like torch.round): the score equals the plain PyTorch
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
// What bounds it on the H100: instruction throughput first, then the latency of
// the copies into shared memory and the L2 bandwidth behind them, bytes last.
// The DoG is read once (5 planes of f32 per octave, 21 MB a frame at 1024^2,
// which stays in the 50 MB L2 for the re-reads between score planes) and 2/64
// of the score voxels are written as tables, while a voxel's full score is
// ~130 dependent flops on 27 values. Spent per voxel, that is an order of
// magnitude above the time its bytes take.
//
// What the design does about it:
//   * A CTA owns tiles: runs of kTile consecutive score voxels (64 flat
//     64-voxel blocks) of one octave of one frame (rows x spans for the rows
//     entry point). Octave, frame, score plane, row and column are worked
//     out once per CTA, from blockIdx and a per-octave table in the
//     parameter struct (two 32-bit divisions); from there the position moves
//     by compare and subtract, and threads address voxels by row and column
//     inside the tile. No division and no octave search per voxel. In a
//     large launch a CTA walks up to 8 consecutive tiles.
//   * A tile is cut into rectangles of whole score rows of one plane (where
//     three DoG rows are too wide for the slab: one row, a window of
//     columns). A rectangle's DoG rows y..y+k+1 of planes s..s+2 are staged
//     in a shared-memory slab with cp.async: 16 bytes a copy where a row
//     starts 16-byte aligned, 4 bytes where it does not (octaves with odd
//     sides, or whose offset in the flat DoG is odd). The slab is a ring of
//     rows: consecutive rectangles and consecutive tiles follow each other
//     down a plane, so the rows two of them share stay where they are and
//     only the new rows are copied.
//   * The extremum test comes first and is separable. A thread owns four
//     columns and walks down its rows: per DoG row it reads six values of
//     each plane (one 16-byte and one 8-byte shared-memory load), takes the
//     max/min across planes, then the 3-wide row max/min, and keeps the last
//     three rows' results in registers (three slots written in turn: max and
//     min do not care for their order): their max/min against the centre is
//     the 26-neighbour test, 56 max/min instructions for four voxels instead
//     of 27 loads and 52 compares for one. fmaxf/fminf are exact and
//     order-free on finite values, so the test is the plain version's bit
//     for bit.
//   * Only extrema take the full score. Each rectangle's extrema go to a
//     shared-memory list (one atomic counter) and the CTA's threads take the
//     list densely, reading the cube from the slab. A voxel whose whole cube
//     is one value (max == min: the flat regions of a frame, where the
//     non-strict test holds everywhere) is left out: its Hessian is exactly
//     0 (v + v - 2v), so det2 > 0 fails and its score is 0 (with infinite
//     values the Hessian is NaN and the test fails as well).
//   * NaN: the plain version's torch.maximum / torch.minimum propagate a NaN,
//     so a voxel with a NaN anywhere in its cube is no extremum and scores 0.
//     fmaxf / fminf drop a NaN, so the score pass tests the 27 values of a
//     listed voxel and scores 0 if one is NaN: equal to plain on any input.
//   * Keys land in a shared-memory array addressed by the voxel's offset in
//     the tile (zero elsewhere); the per-block reduction is the exact
//     tournament over that array, one warp a block, and a block of zeros
//     takes its answer (indices 0 and 1 of the block) without the shuffles.
//     The answers leave through shared memory as coalesced runs.
//
// Shared memory per CTA, all dynamic: the slab, 3 planes x (k+2) rows, at
// most kSlabFloats floats (84 KB); keys, kTile x 4 B (16 KB); the list, kTile
// x 2 B (8 KB); the dense octaves' f32 scores (2 KB): 110 KB, two CTAs of 256
// threads an SM, and one 512^2 frame (about 260 tiles) still fills the 132
// SMs. At W = 512 the slab holds 14 DoG rows (a tile of 4096 voxels touches
// at most 10 score rows); at W = 1024, 7 rows (5 score rows a rectangle);
// from W = 2389 on a rectangle is one row of at most 2384 columns.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlk = 64;            // voxels per table entry
constexpr int kTile = 4096;         // voxels per CTA (block top-2 octaves; rows tiles at most)
constexpr int kDenseTile = 512;     // voxels per CTA of an octave that keeps every voxel
constexpr int kSlabFloats = 21504;  // DoG slab: 3 planes x (k + 2) rows x pitch
constexpr int kSlabSlack = 8;       // the last column group reads up to 2 floats past a row
constexpr int kColMax = (kSlabFloats / 9 - 4) & ~3;   // widest one-row rectangle (a window)
constexpr int kRowsSpans = 16;      // spans per tile of the rows entry point, at most
constexpr int kMaxOct = 32;
constexpr int kMaxWalk = 8;         // tiles one CTA walks, at most
constexpr int kMinCtas = 2;         // CTAs an SM holds (by shared memory)
constexpr int kSms = 132;
constexpr int kWaves = 4;           // waves of CTAs wanted before a CTA walks more tiles
constexpr float kMaxOff = 0.6f;     // models/detect.MAX_REFINE_OFFSET
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemBytes =
    sizeof(float) * (kSlabFloats + kSlabSlack) + (sizeof(int) + sizeof(short)) * kTile +
    sizeof(float) * kDenseTile + 16;

struct Smem {
  float* slab;      // [3][R][pitch]: a ring of R DoG rows per plane
  int* keys;        // [kTile] key of the voxel at each tile offset, 0 off-candidate
  unsigned short* list;   // [kTile] extrema of the rectangle at hand, row * c + column;
                          // after the last rectangle, the tile's answers
  float* score;     // [kDenseTile] f32 scores (dense octaves)
  int* count;       // entries of list
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  Smem sm;
  sm.slab = reinterpret_cast<float*>(raw);
  sm.keys = reinterpret_cast<int*>(sm.slab + kSlabFloats + kSlabSlack);
  sm.score = reinterpret_cast<float*>(sm.keys + kTile);
  sm.list = reinterpret_cast<unsigned short*>(sm.score + kDenseTile);
  sm.count = reinterpret_cast<int*>(sm.list + kTile);
  return sm;
}

// Rows [y0, y0 + k) x columns [x0, x0 + c) of score plane s. The voxel at
// (row ly, column lx) of it has tile offset base + ly * stride + lx and
// belongs to the tile iff that lies in [0, n). Its DoG rows live in a ring
// of R rows per plane: DoG row y0 + rr in ring row ring0 + rr (mod R).
struct Rect {
  int s, y0, k, x0, c;
  int base, stride, n;
  int ring0, R;
  int stage_lo, stage_hi;   // DoG rows rr in [stage_lo, stage_hi) are not in the slab yet
};

// How the threads share a rectangle's columns in the extremum pass: groups
// of 4 columns; with fewer groups than threads, several threads share a
// group and split its rows. Worked out once per octave (per rectangle where
// the rectangles are windows of columns).
struct Split {
  int ncg;      // groups of 4 columns
  int nsplit;   // threads per group
  int sp;       // this thread's share of the rows (>= nsplit: none)
  int cg0;      // this thread's first group
};

__device__ __forceinline__ Split split_columns(int c) {
  Split sp;
  sp.ncg = (c + 3) >> 2;
  sp.nsplit = 1;
  sp.sp = 0;
  if (sp.ncg < kThreads) {
    sp.nsplit = kThreads / sp.ncg;
    sp.sp = threadIdx.x / sp.ncg;
  }
  sp.cg0 = threadIdx.x - sp.sp * sp.ncg;
  return sp;
}

struct Params {
  float thr, edge_ratio, er2;
  int refine;   // 1: ranking score of the refine branch; 0: refined contrast
  int pack;     // 1: the hop code packed into the key's low 5 bits
};

__device__ __forceinline__ int round_up4(int v) { return (v + 3) & ~3; }

// Ring row of DoG row rr of the rectangle.
__device__ __forceinline__ int ring_row(const Rect& r, int rr) {
  const int row = r.ring0 + rr;
  return row >= r.R ? row - r.R : row;
}

// The rectangle's DoG rows that the slab lacks, columns x0 .. x0+c+1 of
// planes s .. s+2 -> slab. One warp a row; waits for its own copies (the
// caller synchronizes).
__device__ __forceinline__ void stage_rect(const float* __restrict__ src, int H, int W,
                                           const Rect& r, int pitch, float* slab) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = r.stage_hi - r.stage_lo, width = r.c + 2;
  for (int row = warp; row < 3 * rows; row += kWarps) {
    const int p = (row >= rows) + (row >= 2 * rows);
    const int rr = r.stage_lo + row - p * rows;
    const float* g = src + (static_cast<long long>(r.s + p) * H + (r.y0 + rr)) * W + r.x0;
    float* d = slab + (p * r.R + ring_row(r, rr)) * pitch;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      const int nv = width >> 2;
      for (int v = lane; v < nv; v += 32) __pipeline_memcpy_async(d + 4 * v, g + 4 * v, 16);
      done = nv << 2;
    }
    for (int e = done + lane; e < width; e += 32) __pipeline_memcpy_async(d + e, g + e, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// One DoG row of the extremum pass for a group of four columns. Reads six
// values of each plane at `row`, keeps their 3-wide max/min across the planes
// in slot PH of hx / hn (the three slots hold the last three rows, in any
// order: max and min do not care) and the middle plane's centres in cm[PH].
// With `test`, this row closes the cubes of the voxels one row up: their
// centres are the row before's, cm[(PH + 2) % 3]. Returns the four voxels'
// extremum bits; a cube of one value (max == min) is no candidate.
template <int PH>
__device__ __forceinline__ unsigned extrema_row(const float* row, int ps, float (&hx)[3][4],
                                                float (&hn)[3][4], float (&cm)[3][4],
                                                bool test) {
  float mx[6], mn[6];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float4 q = *reinterpret_cast<const float4*>(row + p * ps);
    const float2 t = *reinterpret_cast<const float2*>(row + p * ps + 4);
    const float v[6] = {q.x, q.y, q.z, q.w, t.x, t.y};
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      mx[j] = p == 0 ? v[j] : fmaxf(mx[j], v[j]);
      mn[j] = p == 0 ? v[j] : fminf(mn[j], v[j]);
    }
    if (p == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) cm[PH][j] = v[j + 1];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    hx[PH][j] = fmaxf(fmaxf(mx[j], mx[j + 1]), mx[j + 2]);
    hn[PH][j] = fminf(fminf(mn[j], mn[j + 1]), mn[j + 2]);
  }
  unsigned bits = 0;
  if (test) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float hi = fmaxf(fmaxf(hx[0][j], hx[1][j]), hx[2][j]);
      const float lo = fminf(fminf(hn[0][j], hn[1][j]), hn[2][j]);
      const float c = cm[(PH + 2) % 3][j];
      if ((c >= hi || c <= lo) && hi > lo) bits |= 1u << j;
    }
  }
  return bits;
}

// The 26-neighbour test on every voxel of the rectangle that belongs to the
// tile; extrema whose cube is not one value go to the list.
__device__ __forceinline__ void find_extrema(const Rect& r, const Split& sp, int pitch,
                                             const Smem& sm) {
  if (sp.sp >= sp.nsplit) return;
  const int rps = sp.nsplit == 1 ? r.k : (r.k + sp.nsplit - 1) / sp.nsplit;
  const int split_lo = sp.sp * rps;
  const int split_hi = min(r.k, split_lo + rps) - 1;
  const int ps = r.R * pitch;
  for (int cg = sp.cg0; cg < sp.ncg; cg += kThreads) {
    const int lx0 = cg << 2;
    // Only the first and the last row of a rectangle can lie partly outside
    // the tile: skip them where this group's four columns are all outside.
    int ra = split_lo, rb = split_hi;
    if (r.base + lx0 + 3 < 0) ra = max(ra, 1);
    if (r.base + (r.k - 1) * r.stride + lx0 >= r.n) rb = min(rb, r.k - 2);
    if (ra > rb) continue;

    float hx[3][4], hn[3][4], cm[3][4];
    int ring = ring_row(r, ra);
    int rr = ra;
    // Voxel row rr - 2 is closed by DoG row rr; `bits` are its extrema.
    auto emit = [&](unsigned bits) {
      if (bits == 0) return;
      const int ly = rr - 2;
      const int slot0 = r.base + ly * r.stride + lx0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((bits >> j & 1u) && lx0 + j < r.c &&
            static_cast<unsigned>(slot0 + j) < static_cast<unsigned>(r.n)) {
          const int pos = atomicAdd(sm.count, 1);
          sm.list[pos] = static_cast<unsigned short>(ly * r.c + lx0 + j);
        }
      }
    };
    auto next_row = [&]() {
      const float* row = sm.slab + ring * pitch + lx0;
      ring = ring + 1 == r.R ? 0 : ring + 1;
      return row;
    };
    while (true) {
      emit(extrema_row<0>(next_row(), ps, hx, hn, cm, rr >= ra + 2));
      if (++rr > rb + 2) break;
      emit(extrema_row<1>(next_row(), ps, hx, hn, cm, rr >= ra + 2));
      if (++rr > rb + 2) break;
      emit(extrema_row<2>(next_row(), ps, hx, hn, cm, rr >= ra + 2));
      if (++rr > rb + 2) break;
    }
  }
}

struct Score {
  float score;   // ranking score, 0 off-candidate
  int hop;       // first refinement hop code (13 = none)
};

// Score of an EXTREMUM voxel whose cube's first plane has its three rows at
// p + row[0..2] (planes ps floats apart). refine != 0: the ranking score of the
// refine branch and the hop code; refine == 0: the refined-contrast score of
// the no-refine branch.
__device__ __forceinline__ Score extremum_score(const float* p, int ps, const int (&row)[3],
                                                const Params& prm) {
  float v[3][3][3];
  bool no_nan = true;
#pragma unroll
  for (int ds = 0; ds < 3; ++ds)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        v[ds][dy][dx] = p[ds * ps + row[dy] + dx];
        no_nan = no_nan && (v[ds][dy][dx] == v[ds][dy][dx]);
      }
  const float c = v[1][1][1];

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
  const bool edge_ok = (det2 > 0.0f) &&
                       (__fmul_rn(__fmul_rn(tr, tr), prm.edge_ratio) < __fmul_rn(prm.er2, det2));

  Score out;
  if (prm.refine) {
    const float cs = fminf(fmaxf(off_s, -kMaxOff), kMaxOff);
    const float cy = fminf(fmaxf(off_y, -kMaxOff), kMaxOff);
    const float cx = fminf(fmaxf(off_x, -kMaxOff), kMaxOff);
    const float d_rank = __fadd_rn(
        c, __fmul_rn(0.5f, __fadd_rn(__fadd_rn(__fmul_rn(gs, cs), __fmul_rn(gy, cy)),
                                     __fmul_rn(gx, cx))));
    const bool good = no_nan && (fabsf(d_rank) > prm.thr) && edge_ok;
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
    const bool good = no_nan && (fabsf(d_hat) > prm.thr) && edge_ok && off_ok;
    out.score = good ? fabsf(d_hat) : 0.0f;
    out.hop = 13;
  }
  return out;
}

// The int32 key a table ranks by. pack: the hop in the low 5 bits of the
// score's bit pattern (order-preserving for non-negative f32), 0 stays 0.
// No pack: the score's bit pattern itself.
__device__ __forceinline__ int packed_key(Score sc, int pack) {
  const int bits = __float_as_int(sc.score);
  if (!pack) return bits;
  return sc.score > 0.0f ? ((bits & ~31) | sc.hop) : 0;
}

// The listed extrema, taken densely by the CTA's threads: key (and, for a
// dense octave, f32 score) to the voxel's tile offset.
__device__ __forceinline__ void score_list(const Rect& r, int pitch, const Smem& sm, int count,
                                           const Params& prm, bool keep_score) {
  const int ps = r.R * pitch;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int e = sm.list[i];
    const int ly = e / r.c, lx = e - ly * r.c;
    const int row[3] = {ring_row(r, ly) * pitch, ring_row(r, ly + 1) * pitch,
                        ring_row(r, ly + 2) * pitch};
    const Score sc = extremum_score(sm.slab + lx, ps, row, prm);
    const int slot = r.base + ly * r.stride + lx;
    sm.keys[slot] = packed_key(sc, prm.pack);
    if (keep_score) sm.score[slot] = sc.score;
  }
}

// One rectangle, start to end: stage, test, score. Every thread of the CTA
// calls it with the same rectangle; on return the list is free and the slab
// holds the rectangle's DoG rows.
__device__ __forceinline__ void score_rect(const float* __restrict__ src, int H, int W,
                                           const Rect& r, const Split& sp, const Smem& sm,
                                           const Params& prm, bool keep_score) {
  const int pitch = round_up4(r.c + 2);
  stage_rect(src, H, W, r, pitch, sm.slab);
  __syncthreads();   // the slab, and the caller's zeroed keys and count
  find_extrema(r, sp, pitch, sm);
  __syncthreads();
  const int count = *sm.count;
  score_list(r, pitch, sm, count, prm, keep_score);
  __syncthreads();
  if (threadIdx.x == 0) *sm.count = 0;
}

// (value, index) beats (value', index') under value descending, index ascending.
__device__ __forceinline__ bool beats(int v, int i, int v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

// Score rows [y0, y0 + k) x spans [g0, g0 + ng) of one score plane per CTA.
__global__ void __launch_bounds__(kThreads, kMinCtas)
score_tables_rows_kernel(const float* __restrict__ dog, int H, int W, int k_tile, int ng_tile,
                         Params prm, float* __restrict__ tv, int* __restrict__ ti) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int hs = H - 2, ws = W - 2;
  const int nsp = (ws + kBlk - 1) / kBlk;
  const int g0 = blockIdx.x * ng_tile;
  const int ng = min(ng_tile, nsp - g0);
  Rect r;
  r.s = blockIdx.z;
  r.y0 = blockIdx.y * k_tile;
  r.k = min(k_tile, hs - r.y0);
  r.x0 = g0 * kBlk;
  r.c = min(ws - r.x0, ng * kBlk);
  r.base = 0;
  r.stride = ng * kBlk;
  r.n = r.k * r.stride;
  r.ring0 = 0;
  r.R = r.k + 2;
  r.stage_lo = 0;
  r.stage_hi = r.k + 2;
  for (int i = threadIdx.x; i < r.n; i += kThreads) sm.keys[i] = 0;
  if (threadIdx.x == 0) *sm.count = 0;
  score_rect(dog, H, W, r, split_columns(r.c), sm, prm, false);

  // Per (row, span): max and first argmax of the score (its bit pattern
  // orders like the non-negative f32); columns past the row are 0 and, lying
  // behind, lose every tie.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int item = warp; item < r.k * ng; item += kWarps) {
    const int ly = item / ng, g = item - ly * ng;
    const int* keys = sm.keys + ly * r.stride + g * kBlk;
    const int k0 = keys[lane], k1 = keys[lane + 32];
    int best = 0, col = 0;
    if (__any_sync(kFull, (k0 | k1) != 0)) {
      best = k1 > k0 ? k1 : k0;
      col = k1 > k0 ? lane + 32 : lane;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int ov = __shfl_xor_sync(kFull, best, off);
        const int oc = __shfl_xor_sync(kFull, col, off);
        if (beats(ov, oc, best, col)) {
          best = ov;
          col = oc;
        }
      }
    }
    if (lane == 0) {
      const int row = r.s * hs + r.y0 + ly;
      const long long out = static_cast<long long>(row) * nsp + g0 + g;
      tv[out] = __int_as_float(best);
      ti[out] = row * ws + r.x0 + g * kBlk + col;
    }
  }
}

struct Octaves {
  int n;
  int planes;                      // S + 2, shared by every octave
  int walk;                        // consecutive tiles of an octave one CTA takes
  long long dog_off[kMaxOct];      // first float of the octave in the flat DoG
  int h[kMaxOct], w[kMaxOct];
  int dense[kMaxOct];              // 1: every voxel; 0: 64-voxel top-2 tables
  long long out_off[kMaxOct];      // first output entry of the octave
  long long g_base[kMaxOct];       // flat score index of the octave's voxel 0
  long long score_off[kMaxOct];    // dense octaves: first entry in `score`
  int cta_start[kMaxOct + 1];      // first CTA (blockIdx.x) of the octave
  int kmax[kMaxOct];               // score rows a full-width rectangle may hold; 0: one
                                   // row, windows of columns
  // A batch of frames with one octave layout, frame-major in every buffer.
  long long dog_stride;            // floats of one frame's flat DoG
  long long out_stride;            // vals / idx entries of one frame
  long long score_stride;          // dense-octave scores of one frame
};

// `walk` consecutive tiles of one octave of one frame (blockIdx.y) per CTA.
// The tiles follow each other down the rows of a score plane, so the slab
// keeps the DoG rows two tiles share and stages only the new ones.
__global__ void __launch_bounds__(kThreads, kMinCtas)
score_block_top2_kernel(const float* __restrict__ dog, Octaves oct, Params prm,
                        int* __restrict__ vals, long long* __restrict__ idx,
                        float* __restrict__ score) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  const long long frame = blockIdx.y;
  int cta = blockIdx.x;
  int o = 0;
  while (o + 1 < oct.n && cta >= oct.cta_start[o + 1]) ++o;
  cta -= oct.cta_start[o];
  const int H = oct.h[o], W = oct.w[o];
  const int hs = H - 2, ws = W - 2;
  const int plane = hs * ws;
  const int vg = (oct.planes - 2) * plane;
  const bool dense = oct.dense[o] != 0;
  const int tile_len = dense ? kDenseTile : kTile;
  const int n_tiles = (vg + tile_len - 1) / tile_len;
  const int tile_end = min((cta + 1) * oct.walk, n_tiles);
  const float* src = dog + frame * oct.dog_stride + oct.dog_off[o];
  vals += frame * oct.out_stride + oct.out_off[o];
  idx += frame * oct.out_stride + oct.out_off[o];
  score += frame * oct.score_stride + oct.score_off[o];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nblk = (vg + kBlk - 1) / kBlk;
  const long long g_base = oct.g_base[o];

  // Where the CTA stands in the score volume: f = s * plane + y * ws + x.
  // Two divisions here; from then on the position moves by compare and
  // subtract, the same in every thread.
  const int kmax = oct.kmax[o];
  int f = cta * oct.walk * tile_len;
  int s = f / plane;
  int y = (f - s * plane) / ws;
  int x = f - s * plane - y * ws;
  const Split full = split_columns(ws);
  // DoG rows [have_lo, have_hi] of planes have_s .. have_s + 2 are in the
  // slab, row have_lo in ring row have_ring (full-width rectangles only).
  int have_s = -1, have_lo = 0, have_hi = -1, have_ring = 0;
  if (threadIdx.x == 0) *sm.count = 0;

  for (int tile = cta * oct.walk; tile < tile_end; ++tile) {
    const int f_begin = tile * tile_len;
    const int f_end = min(f_begin + tile_len, vg);
    const int n = f_end - f_begin;
    const int n_pad = (n + kBlk - 1) & ~(kBlk - 1);   // voxels past the volume: key 0
    for (int i = threadIdx.x; i < n_pad / 4; i += kThreads)
      reinterpret_cast<int4*>(sm.keys)[i] = make_int4(0, 0, 0, 0);
    if (dense)
      for (int i = threadIdx.x; i < n; i += kThreads) sm.score[i] = 0.0f;

    // The tile as rectangles, in flat order.
    while (f < f_end) {
      const int left = min(f_end, (s + 1) * plane) - f;   // voxels of the tile in this plane
      Rect r;
      r.s = s;
      r.y0 = y;
      r.stride = ws;
      r.n = n;
      int step;   // voxels the rectangle covers from f on
      if (kmax >= 1) {
        int k = 1, cover = ws - x;
        while (k < kmax && cover < left) {
          cover += ws;
          ++k;
        }
        r.k = k;
        r.x0 = 0;
        r.c = ws;
        r.base = f - x - f_begin;
        r.R = kmax + 2;
        step = min(cover, left);
        // Rows of this plane that the slab already holds stay where they are.
        if (s == have_s && y >= have_lo && y <= have_hi + 1) {
          int ring = have_ring + (y - have_lo);
          r.ring0 = ring >= r.R ? ring - r.R : ring;
          r.stage_lo = have_hi + 1 - y;
        } else {
          r.ring0 = 0;
          r.stage_lo = 0;
        }
        r.stage_hi = k + 2;
        if (r.stage_lo > r.stage_hi) r.stage_lo = r.stage_hi;
        have_s = s;
        have_lo = y;
        have_hi = max(y + k + 1, y + r.stage_lo - 1);
        have_ring = r.ring0;
        score_rect(src, H, W, r, full, sm, prm, dense);
      } else {
        r.k = 1;
        r.x0 = x;
        r.c = min(min(ws - x, kColMax), left);
        r.base = f - f_begin;
        r.R = 3;
        r.ring0 = 0;
        r.stage_lo = 0;
        r.stage_hi = 3;
        step = r.c;
        score_rect(src, H, W, r, split_columns(r.c), sm, prm, dense);
      }
      f += step;
      x += step;
      while (x >= ws) {
        x -= ws;
        ++y;
      }
      if (y >= hs) {
        y = 0;
        ++s;
      }
    }

    if (dense) {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int fi = f_begin + i;
        vals[fi] = sm.keys[i];
        idx[fi] = g_base + fi;
        score[fi] = sm.score[i];
      }
    } else {
      // Top-2 of each 64-voxel block of the tile. Tournament merge
      // (models/detect._block_top2's combiner): associative and commutative,
      // so a warp's butterfly yields the exact top-2 of a block.
      // The answers wait in shared memory (the list is free by now) and leave
      // as four coalesced runs: one lane's 4-byte stores, 128 a tile, cost
      // more than the tournament.
      const int nb = n_pad / kBlk;
      int* out_v = reinterpret_cast<int*>(sm.list);   // [2][nb] keys
      int* out_i = out_v + 2 * (kTile / kBlk);         // [2][nb] tile offsets
      // Four threads scan a block's 64 keys (16 bytes a load); a block of
      // zeros is answered at once, the others go through the tournament.
      static_assert(kTile / kBlk * 4 == kThreads, "four threads a block of the tile");
      const int blk = threadIdx.x >> 2;
      int any = 0;
      if (blk < nb) {
        const int4* k4 = reinterpret_cast<const int4*>(sm.keys) + threadIdx.x * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) any |= k4[q].x | k4[q].y | k4[q].z | k4[q].w;
      }
      any |= __shfl_xor_sync(kFull, any, 1);
      any |= __shfl_xor_sync(kFull, any, 2);
      if (blk < nb && any == 0 && (threadIdx.x & 3) == 0) {
        out_v[blk] = 0;
        out_v[nb + blk] = 0;
        out_i[blk] = blk * kBlk;
        out_i[nb + blk] = blk * kBlk + 1;
      }
      unsigned todo = __ballot_sync(kFull, any != 0 && (threadIdx.x & 3) == 0);
      while (todo) {
        const int b = (warp << 3) + ((__ffs(todo) - 1) >> 2);   // a block of this warp's eight
        todo &= todo - 1;
        const int k0 = sm.keys[b * kBlk + lane], k1 = sm.keys[b * kBlk + 32 + lane];
        const bool hi = k1 > k0;   // the upper voxel wins only with the larger key
        int v1 = hi ? k1 : k0;
        int i1 = b * kBlk + lane + (hi ? 32 : 0);
        int v2 = hi ? k0 : k1;
        int i2 = b * kBlk + lane + (hi ? 0 : 32);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const int ov1 = __shfl_xor_sync(kFull, v1, off);
          const int oi1 = __shfl_xor_sync(kFull, i1, off);
          const int ov2 = __shfl_xor_sync(kFull, v2, off);
          const int oi2 = __shfl_xor_sync(kFull, i2, off);
          const bool swap = beats(ov1, oi1, v1, i1);
          const int first = swap ? ov1 : v1;
          const int fidx = swap ? oi1 : i1;
          const int lose_v = swap ? v1 : ov1;
          const int lose_i = swap ? i1 : oi1;
          const int win2_v = swap ? ov2 : v2;
          const int win2_i = swap ? oi2 : i2;
          const bool s_swap = beats(lose_v, lose_i, win2_v, win2_i);
          v1 = first;
          i1 = fidx;
          v2 = s_swap ? lose_v : win2_v;
          i2 = s_swap ? lose_i : win2_i;
        }
        if (lane == 0) {
          out_v[b] = v1;
          out_v[nb + b] = v2;
          out_i[b] = i1;
          out_i[nb + b] = i2;
        }
      }
      __syncthreads();   // the answers are in; the keys are read: the next tile may zero them
      const int out = f_begin / kBlk;
      for (int t = threadIdx.x; t < 4 * nb; t += kThreads) {
        const int e = t < 2 * nb ? t : t - 2 * nb;          // entry of out_v / out_i
        const int at = out + (e < nb ? e : e - nb + nblk);   // firsts, then seconds
        if (t < 2 * nb)
          vals[at] = out_v[e];
        else
          idx[at] = g_base + min(f_begin + out_i[e], vg - 1);
      }
      continue;
    }
    __syncthreads();   // the keys are read: the next tile may zero them
  }
}

// Both kernels take kSmemBytes of dynamic shared memory, above the 48 KB a
// kernel gets unasked.
template <typename K>
cudaError_t allow_smem(K kernel) {
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(kSmemBytes));
  if (rc != cudaSuccess) return rc;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Score rows a slab holds for rectangles `width` DoG columns wide (0: none).
int slab_rows(int width) {
  const int rows = kSlabFloats / (3 * ((width + 3) & ~3)) - 2;
  return rows > 0 ? rows : 0;
}

}  // namespace

// dog: (S+2, H, W) f32; tv: (S, H-2, ceil((W-2)/64)) f32; ti: same shape,
// int32 flat indices into the (S, H-2, W-2) score volume. Requires H, W >= 3
// and fewer than 2^31 score voxels.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sift_score_tables_rows(const float* dog, int planes, int H, int W, float thr,
                                      float edge_ratio, float er2, float* tv, int* ti,
                                      void* stream) {
  const int S = planes - 2, hs = H - 2, ws = W - 2;
  if (S <= 0 || hs <= 0 || ws <= 0) return static_cast<int>(cudaSuccess);
  if (static_cast<long long>(S) * hs * ws > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nsp = (ws + kBlk - 1) / kBlk;
  const int ng = nsp < kRowsSpans ? nsp : kRowsSpans;
  const int cols = ws < ng * kBlk ? ws : ng * kBlk;
  int k = kTile / (ng * kBlk);
  if (k > slab_rows(cols + 2)) k = slab_rows(cols + 2);
  if (k > hs) k = hs;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nsp + ng - 1) / ng, (hs + k - 1) / k, S);
  if (grid.y > 65535u || grid.z > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = allow_smem(score_tables_rows_kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const Params prm = {thr, edge_ratio, er2, 1, 0};
  score_tables_rows_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      dog, H, W, k, ng, prm, tv, ti);
  return static_cast<int>(cudaGetLastError());
}

// dog: n_frames frames, dog_stride floats apart, each the octaves' (planes,
// H_o, W_o) f32 stacks concatenated flat. meta: host array of n_oct rows
// (dog_off, H, W, dense, out_off, g_base, score_off), one frame's layout.
// Per frame, out_stride entries apart, writes vals (int32 keys) and idx (int64
// flat score indices WITHIN the frame) from each octave's out_off and, for
// dense octaves, score_stride apart, the f32 scores from its score_off.
// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for no frame or more than 65535, no or more than 32
// octaves, or an octave of 2^31 score voxels or more.
extern "C" int sift_score_block_top2(const float* dog, const long long* meta, int n_oct,
                                     int planes, int n_frames, long long dog_stride,
                                     long long out_stride, long long score_stride, float thr,
                                     float edge_ratio, float er2, int refine, int* vals,
                                     long long* idx, float* score, void* stream) {
  if (n_oct < 1 || n_oct > kMaxOct || n_frames < 1 || n_frames > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Octaves oct;
  oct.n = n_oct;
  oct.planes = planes;
  oct.dog_stride = dog_stride;
  oct.out_stride = out_stride;
  oct.score_stride = score_stride;
  long long tiles = 0;
  for (int o = 0; o < n_oct; ++o) {
    const long long* m = meta + 7 * o;
    const long long vg = static_cast<long long>(planes - 2) * (m[1] - 2) * (m[2] - 2);
    if (vg > 0x7fffffffLL - kTile) return static_cast<int>(cudaErrorInvalidValue);
    tiles += (vg + (m[3] ? kDenseTile : kTile) - 1) / (m[3] ? kDenseTile : kTile);
  }
  // A small launch keeps one tile a CTA, so that the card fills at all; a
  // large one lets a CTA walk several tiles down the rows.
  const long long walk = tiles * n_frames / (static_cast<long long>(kSms) * kMinCtas * kWaves);
  oct.walk = static_cast<int>(walk < 1 ? 1 : (walk > kMaxWalk ? kMaxWalk : walk));
  long long ctas = 0;
  for (int o = 0; o < n_oct; ++o) {
    const long long* m = meta + 7 * o;
    oct.dog_off[o] = m[0];
    oct.h[o] = static_cast<int>(m[1]);
    oct.w[o] = static_cast<int>(m[2]);
    oct.dense[o] = static_cast<int>(m[3]);
    oct.out_off[o] = m[4];
    oct.g_base[o] = m[5];
    oct.score_off[o] = m[6];
    oct.kmax[o] = slab_rows(oct.w[o]);
    const long long vg = static_cast<long long>(planes - 2) * (m[1] - 2) * (m[2] - 2);
    const int tile = oct.dense[o] ? kDenseTile : kTile;
    oct.cta_start[o] = static_cast<int>(ctas);
    ctas += ((vg + tile - 1) / tile + oct.walk - 1) / oct.walk;
    if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  oct.cta_start[n_oct] = static_cast<int>(ctas);
  if (ctas == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t rc = allow_smem(score_block_top2_kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const Params prm = {thr, edge_ratio, er2, refine, refine};
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(n_frames));
  score_block_top2_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      dog, oct, prm, vals, idx, score);
  return static_cast<int>(cudaGetLastError());
}
